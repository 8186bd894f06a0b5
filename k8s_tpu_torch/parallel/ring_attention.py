"""Ring attention: sequence parallelism over the mesh's ``seq`` axis (port
of ``k8s_tpu/parallel/ring_attention.py``).

Each rank of the ``seq`` axis holds one chunk of every sequence — rank
``r`` of ``n`` the positions ``[r S / n, (r + 1) S / n)`` — of q, k and v
and of the segment ids. It attends its queries to the KV chunk it
currently holds while the chunks rotate around the ring, one step to
rank ``r + 1`` per step, so after ``n`` steps every query has seen every
key with no rank holding more than its chunk and one other.

Two per-rank bodies, as in the JAX package:

- :func:`ring_attention_sharded` — blockwise attention in plain torch
  (the JAX "xla" einsum body), differentiable under autograd: online
  softmax over the chunks in f32, causal masking on global positions,
  the rotation an autograd op whose backward rotates the other way.
- the flash body (:func:`ring_flash_attention_sharded`, a
  ``torch.autograd.Function`` over :func:`ring_flash_forward` and
  :func:`ring_flash_backward`) — every ring step runs the flash kernels
  on the resident KV chunk: K1 with ``out_f32`` and the resident
  chunk's segment row (``segment_ids_kv``), its f32 partials merged
  exactly in log space (:func:`_merge_partial`); the backward K2/K3 per
  step with ``grads_f32``, from the merged output's lse and D (exact
  global gradients), dQ summed locally while the dK/dV partials ride the
  ring with their chunk and take one last rotation home. Step 0 is the
  diagonal chunk, causal; later steps take past chunks whole and skip
  future ones. On CPU tensors the same body runs the kernels' plain
  versions.

:func:`ring_attention` takes this rank's chunks and picks a body by the
JAX gate, re-derived for CUDA as ``flash_attention``'s was: the einsum
body only where the kernels cannot take the chunks — unequal q and kv
chunks, or CUDA tensors whose head dim is not a multiple of 64 (the
kernels mask ragged chunk tails, so the TPU's 128-alignment of the chunk
is gone) — else the flash body, CPU tensors included, so that a model
on the CPU runs the body the card runs.

The ring is a transport with ``.size``, ``.rank`` and ``.rotate(*tensors,
shift=1)`` (each tensor sent to rank ``rank + shift`` of the ring, the
one from ``rank - shift`` returned). :class:`ProcessGroupRing` is the
``torch.distributed`` one over the ``seq`` group (NCCL on the card, gloo
on the CPU); ``chip_smoke.py`` drives the same functions over threads of
one process. The rotation is synchronous: posting the next step's
transfer before the current block's compute would hide it behind the
kernels on a machine with several cards (unmeasured: one card holds
one rank).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from k8s_tpu_torch.ops.attention import flash_bwd, flash_fwd

NEG_INF = -1e30


class ProcessGroupRing:
    """The ring transport over a process group (the mesh's ``seq`` axis):
    :meth:`rotate` shifts tensors to the next rank with one
    ``batch_isend_irecv``."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    @classmethod
    def of(cls, mesh, axis: str = "seq") -> "ProcessGroupRing":
        from k8s_tpu_torch.parallel.mesh import mesh_axis

        return cls(*mesh_axis(mesh, axis))

    def rotate(self, *tensors: torch.Tensor, shift: int = 1) -> Tuple[torch.Tensor, ...]:
        """Every tensor sent to rank ``rank + shift`` of the ring; returns
        the ones received from rank ``rank - shift`` (fresh tensors of
        the same shapes; the inputs themselves on a one-rank ring)."""
        import torch.distributed as dist

        if self.size == 1:
            return tuple(tensors)
        ranks = dist.get_process_group_ranks(self.group)
        dst = ranks[(self.rank + shift) % self.size]
        src = ranks[(self.rank - shift) % self.size]
        tensors = [t.contiguous() for t in tensors]
        out = tuple(torch.empty_like(t) for t in tensors)
        ops = []
        for t, o in zip(tensors, out):
            ops.append(dist.P2POp(dist.isend, t, dst, self.group))
            ops.append(dist.P2POp(dist.irecv, o, src, self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out


class _Rotate(torch.autograd.Function):
    """The ring rotation as an autograd op: its adjoint sends each
    gradient back to the rank the tensor came from."""

    @staticmethod
    def forward(ctx, ring, *tensors):
        ctx.ring = ring
        return ring.rotate(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.ring.rotate(*grads, shift=-1))


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           segment_ids: Optional[torch.Tensor] = None,
                           ring=None, causal: bool = True,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The einsum body on this rank's chunks: q [B, Sq, Hq, D], k/v [B,
    Sk, Hkv, D], ``segment_ids`` [B, Sq] (the chunk's rows, rotating with
    their KV chunk). Online softmax in f32 over the ring's KV chunks,
    causal on global positions (chunk ``r`` holds ``[r Sq, (r + 1) Sq)``
    of the queries and ``[r Sk, (r + 1) Sk)`` of the keys). Returns [B,
    Sq, Hq, D] in q's dtype, differentiable in q, k and v."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    groups = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    n, my = ring.size, ring.rank
    qf = (q.float() * scale).reshape(b, sq, hkv, groups, d)
    q_pos = my * sq + torch.arange(sq, device=q.device)
    seg_q = segment_ids
    m = torch.full((b, hkv, groups, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, groups, sq, d), dtype=torch.float32, device=q.device)
    k_cur, v_cur, seg_cur = k, v, segment_ids
    for step in range(n):
        if step:
            # the next chunk (and its ids) from rank my - 1
            k_cur, v_cur = _Rotate.apply(ring, k_cur, v_cur)
            if seg_cur is not None:
                (seg_cur,) = ring.rotate(seg_cur)
        src = (my - step) % n  # the rank whose chunk is resident
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k_cur.float())
        if causal:
            k_pos = src * sk + torch.arange(sk, device=q.device)
            s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), NEG_INF)
        if seg_cur is not None:
            visible = seg_q[:, :, None] == seg_cur[:, None, :]  # [B, Sq, Sk]
            s = s.masked_fill(~visible[:, None, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p, v_cur.float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]  # [B, Hkv, G, Sq, D]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


def _merge_partial(out_acc, lse_acc, out_i, lse_i):
    """Exact log-space merge of two self-normalised attention partials:
    ``out_*`` [B, Sq, Hq, D] f32 normalised by their own ``lse_*`` [B,
    Hq, Sq] f32. An empty partial (0, NEG_INF) — or the kernel's -inf lse
    of a row that saw no key — drops out, its weight exp(lse_i - lse_new)
    being 0."""
    m = torch.maximum(lse_acc, lse_i)
    lse_new = m + torch.log(torch.exp(lse_acc - m) + torch.exp(lse_i - m))
    w_acc = torch.exp(lse_acc - lse_new).transpose(1, 2)[..., None]
    w_i = torch.exp(lse_i - lse_new).transpose(1, 2)[..., None]
    return out_acc * w_acc + out_i * w_i, lse_new


def _rotated(ring, tensors: Sequence[Optional[torch.Tensor]]):
    """``tensors`` rotated one step, a None passing through as None."""
    live = [t for t in tensors if t is not None]
    moved = iter(ring.rotate(*live)) if live else iter(())
    return [None if t is None else next(moved) for t in tensors]


def ring_flash_forward(q, k, v, seg, ring, causal: bool, scale: float):
    """The flash body's forward on this rank's chunks (the JAX
    ``_ring_flash_fwd``): ``(out [B, Sq, Hq, D] in q's dtype, lse [B, Hq,
    Sq] f32)``. Step 0 is the diagonal chunk (causal when ``causal``,
    its kv row the local row); each later step rotates the KV chunk and
    its ids one rank on and, unless the chunk lies in the future of a
    causal ring, runs K1 non-causal with ``out_f32`` and the resident
    chunk's ids and merges the partial."""
    n, my = ring.size, ring.rank

    def block(k_blk, v_blk, seg_blk, blk_causal):
        return flash_fwd(q, k_blk, v_blk, blk_causal, scale, with_lse=True,
                         segment_ids=seg, segment_ids_kv=seg_blk, out_f32=True)

    out_acc, lse_acc = block(k, v, seg, causal)
    k_cur, v_cur, seg_cur = k, v, seg
    for step in range(1, n):
        k_cur, v_cur, seg_cur = _rotated(ring, (k_cur, v_cur, seg_cur))
        if causal and (my - step) % n > my:
            continue  # a future chunk: no query of this rank sees it
        out_i, lse_i = block(k_cur, v_cur, seg_cur, False)
        out_acc, lse_acc = _merge_partial(out_acc, lse_acc, out_i, lse_i)
    return out_acc.to(q.dtype), lse_acc


def ring_flash_backward(q, k, v, seg, out, lse, dout, ring, causal: bool,
                        scale: float):
    """The flash body's backward (the JAX ``_ring_flash_bwd``): ``(dq, dk,
    dv)`` in q's, k's and v's dtypes. Every block's K2/K3 recompute P
    from the merged ``lse`` and take D from the merged ``out`` and
    ``dout``, so each block's gradients are its exact share of the
    global ones, in f32 (``grads_f32``). dQ sums on this rank; dK/dV
    partials rotate with the KV chunk they belong to, collecting each
    rank's share, and after the ``n - 1`` steps one more rotation brings
    them to the chunk's owner."""
    n, my = ring.size, ring.rank

    def block(k_blk, v_blk, seg_blk, blk_causal):
        return flash_bwd(q, k_blk, v_blk, out, lse, dout, blk_causal, scale,
                         segment_ids=seg, segment_ids_kv=seg_blk, grads_f32=True)

    dq_acc, dk_cur, dv_cur = block(k, v, seg, causal)
    k_cur, v_cur, seg_cur = k, v, seg
    for step in range(1, n):
        k_cur, v_cur, seg_cur, dk_cur, dv_cur = _rotated(
            ring, (k_cur, v_cur, seg_cur, dk_cur, dv_cur))
        if causal and (my - step) % n > my:
            continue
        dq_i, dk_i, dv_i = block(k_cur, v_cur, seg_cur, False)
        dq_acc, dk_cur, dv_cur = dq_acc + dq_i, dk_cur + dk_i, dv_cur + dv_i
    if n > 1:
        dk_cur, dv_cur = ring.rotate(dk_cur, dv_cur)
    return dq_acc.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg, ring, causal, scale):
        out, lse = ring_flash_forward(q, k, v, seg, ring, causal, scale)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        ctx.ring, ctx.causal, ctx.scale = ring, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, out, lse = ctx.saved_tensors
        dq, dk, dv = ring_flash_backward(q, k, v, seg, out, lse, dout.contiguous(),
                                         ctx.ring, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def ring_flash_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 segment_ids: Optional[torch.Tensor] = None,
                                 ring=None, causal: bool = True,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """The flash body on this rank's chunks, differentiable: q [B, S, Hq,
    D], k/v [B, S, Hkv, D] (equal q and kv chunks, laid out contiguously
    over the ring, so the diagonal chunk is local causal self-attention),
    ``segment_ids`` [B, S] rotating with their KV chunk. Raises the JAX
    error for unequal chunks."""
    if q.shape[1] != k.shape[1]:
        raise ValueError(
            f"ring flash needs equal q/kv chunk sizes, got {q.shape[1]} "
            f"vs {k.shape[1]}")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    seg = None if segment_ids is None else segment_ids.to(torch.int32).contiguous()
    return _RingFlash.apply(q, k, v, seg, ring, bool(causal), float(scale))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ring,
                   causal: bool = True, scale: Optional[float] = None,
                   segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ring attention on this rank's chunks (the body of the JAX
    ``ring_attention``'s ``shard_map``, which every SPMD rank runs on what
    it holds), through the body the module docstring's gate picks."""
    einsum = q.shape[1] != k.shape[1] or (q.is_cuda and q.shape[-1] % 64)
    body = ring_attention_sharded if einsum else ring_flash_attention_sharded
    return body(q, k, v, segment_ids, ring, causal, scale)
