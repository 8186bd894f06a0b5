"""Per-job reconcile layer of the operator (the port's copy of
``k8s_tpu/trainer``): the replica materializer, the TrainingJob state
machine and the TensorBoard replica set.

Analogue of reference ``pkg/trainer/``.
"""

from k8s_tpu_torch.trainer.labels import KubernetesLabels  # noqa: F401
from k8s_tpu_torch.trainer.replicas import TpuReplicaSet, RendezvousSpec  # noqa: F401
from k8s_tpu_torch.trainer.training import TrainingJob, is_retryable_termination_state  # noqa: F401
from k8s_tpu_torch.trainer.tensorboard import TensorBoardReplicaSet  # noqa: F401
