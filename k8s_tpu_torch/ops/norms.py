"""Normalization ops (port of ``k8s_tpu/ops/norms.py``).

RMSNorm with f32 math regardless of input dtype, cast back to the
input dtype. It is a plain elementwise/reduction pass; the JAX package
left it to XLA, so it stays plain PyTorch here.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)
