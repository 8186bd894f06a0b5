"""Normalization ops (port of ``k8s_tpu/ops/norms.py`` and of flax's
``nn.LayerNorm`` as the JAX models use it).

RMSNorm with f32 math regardless of input dtype, cast back to the
input dtype; LayerNorm with flax's numerics. Both are plain
elementwise/reduction passes; the JAX package left them to XLA, so they
stay plain PyTorch here.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """flax ``nn.LayerNorm(epsilon=eps, dtype=dtype)`` over the last axis
    with f32 parameters: the statistics in f32 with flax's
    ``use_fast_variance`` (``var = max(E[x^2] - E[x]^2, 0)``), then
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32, cast to
    ``dtype`` at the end (f32 by default; flax's ``dtype=bf16``, the JAX
    BERT's ``bf16_norms``, casts the same f32 result to bf16)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf.square().mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0.0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * scale.float()) + bias.float()
    return y.to(dtype)
