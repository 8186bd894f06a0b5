"""Local runtime of the operator: the kubelet stand-in and its pod
executors (the port's copy of ``k8s_tpu/runtime``, with the kubelet
playing the GPU device plugin). The chaos monkey is a later slice
(ROADMAP A12.6).
"""

from k8s_tpu_torch.runtime.kubelet import (  # noqa: F401
    LocalKubelet,
    SimulatedExecutor,
    SubprocessExecutor,
)
