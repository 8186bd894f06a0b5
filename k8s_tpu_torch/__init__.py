"""PyTorch/CUDA port of the k8s_tpu data plane, slice by slice.

The JAX package ``k8s_tpu`` is the reference; this package mirrors its
module names and holds each ported part to it. It imports ``torch``
and nothing of JAX or of ``k8s_tpu``. Every Pallas kernel on a ported
path is a hand-written CUDA kernel for Hopper (``csrc/``, built at
first use by :mod:`k8s_tpu_torch.ops._kernels`).

Entry points take a ``device`` argument that defaults to ``"cuda"``;
without a card they raise unless the caller asks for ``"cpu"``
(:func:`resolve_device`).
"""

from __future__ import annotations

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> "torch.device":  # noqa: F821
    """The device an entry point runs on. A CUDA device without a card
    raises here, up front, instead of deep inside the first launch —
    there is no silent CPU fallback anywhere in the port."""
    # imported here, so that the control plane (operator, apiserver,
    # kubectl_local) starts without loading torch
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available "
            "(pass device='cpu' to run the plain PyTorch paths)")
    return dev
