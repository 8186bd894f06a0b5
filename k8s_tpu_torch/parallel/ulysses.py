"""Ulysses attention: all-to-all sequence parallelism over the mesh's
``seq`` axis (port of ``k8s_tpu/parallel/ulysses.py``).

Where ring attention keeps the queries local and rotates K and V around
the ``seq`` ranks, Ulysses re-shards: activations arrive sequence-split
``[B, S/n, H, D]``, one all-to-all over ``seq`` makes them head-split
``[B, S, H/n, D]``, every rank runs ordinary flash attention
(``ops.attention.flash_attention``: K1-K3 on the card) over the whole
sequence for its heads, and a second all-to-all restores the sequence
split. Each activation moves twice whatever S is; the degree must divide
both head counts. ``LlamaConfig(attention="ulysses")`` selects it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from k8s_tpu_torch.ops.attention import flash_attention


def _all_to_all(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` [n, ...]: block j sent to rank j of ``axis``, block j of the
    result received from rank j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=axis.group)
    return out


class _AllToAll(torch.autograd.Function):
    """The block all-to-all under autograd: its own adjoint (the gradient
    of the block received from rank j goes back to rank j)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_to_all(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.axis), None


def _seq_to_heads(x: torch.Tensor, axis) -> torch.Tensor:
    """[B, S/n, H, D] sequence-split -> [B, S, H/n, D] head-split: this
    rank's heads block ``[rank H/n, (rank + 1) H/n)`` of every chunk."""
    b, c, h, d = x.shape
    n = axis.size
    blocks = x.reshape(b, c, n, h // n, d).permute(2, 0, 1, 3, 4)
    got = _AllToAll.apply(blocks, axis)  # [n (the chunk's rank), B, c, H/n, D]
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * c, h // n, d)


def _heads_to_seq(x: torch.Tensor, axis) -> torch.Tensor:
    """[B, S, H/n, D] head-split -> [B, S/n, H, D] sequence-split."""
    b, s, hl, d = x.shape
    n = axis.size
    blocks = x.reshape(b, n, s // n, hl, d).permute(1, 0, 2, 3, 4)
    got = _AllToAll.apply(blocks, axis)  # [n (the heads' rank), B, S/n, H/n, D]
    return got.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * hl, d)


def ulysses_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              segment_ids: Optional[torch.Tensor] = None,
                              axis=None, causal: bool = True,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Ulysses attention on this rank's chunks: q [B, S/n, Hq, D], k/v
    [B, S/n, Hkv, D] and ``segment_ids`` [B, S/n] of the ``seq`` axis
    ``axis`` (``.group``, ``.size``, ``.rank``: a
    :class:`~k8s_tpu_torch.parallel.mesh.MeshAxis` or a
    :class:`~k8s_tpu_torch.parallel.ring_attention.ProcessGroupRing`);
    the whole segment row is all-gathered for the full-sequence
    attention. Raises the JAX error when the degree does not divide the
    head counts."""
    n = axis.size
    hq, hkv = q.shape[2], k.shape[2]
    if hq % n or hkv % n:
        raise ValueError(
            f"ulysses degree {n} must divide q heads {hq} and kv heads {hkv}")
    qh, kh, vh = (_seq_to_heads(x, axis) for x in (q, k, v))
    seg_full = None
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32).contiguous()
        b, c = seg.shape
        parts = seg.new_empty((n * b, c))  # gloo wants [n B, ...], not [n, B, ...]
        dist.all_gather_into_tensor(parts, seg, group=axis.group)
        seg_full = parts.view(n, b, c).permute(1, 0, 2).reshape(b, n * c)
    out = flash_attention(qh, kh, vh, causal=causal, scale=scale,
                          segment_ids=seg_full)
    return _heads_to_seq(out, axis)
