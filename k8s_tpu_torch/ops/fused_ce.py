"""Fused LM-head cross-entropy (port of ``k8s_tpu/ops/fused_ce.py``):
the head matmul and the softmax cross-entropy without the ``[B, S, V]``
logits tensor.

At Llama-3-8B's vocab (128 256) the f32 logits of one 8 x 2048 batch
are 8.4 GB, and an unfused backward writes and reads as much again. The
vocab is cut into chunks of at most ``target_chunk`` columns; each
chunk's logsumexp and label logit combine exactly into the full ones
(a logsumexp over the chunks). The backward recomputes each chunk's
logits instead of saving them — one more head matmul buys O(V / C)
instead of O(V) loss memory — so at most one ``[B*S, V/C]`` f32 block
is live.

The chunk products run in ``compute_dtype`` (default ``hidden.dtype``:
bf16 in training) with f32 results — the JAX ``preferred_element_type``
— and all softmax math is f32. They are plain ``torch`` matmuls, as
the JAX package leaves them to XLA.

With a ``mesh`` the head is vocab-parallel over the mesh's ``tensor``
axis (the JAX ``mesh=`` path, where GSPMD splits the chunks' vocab over
``tensor``): each rank holds ``kernel``'s ``[E, V/t]`` columns and chunks
them as above; one all-gather over ``tensor`` of each rank's logsumexp
and label logit per token gives the global logsumexp (a logsumexp over
the ranks, the same on every rank) and the label logit (the rank that
owns the label contributes it, the others zero), and the z-loss applies
to the global logsumexp. The backward forms each rank's softmax minus
its one-hot on its own columns: the kernel's gradient stays local, and
the ``hidden`` gradient, a partial sum over the vocab, is all-reduced
over ``tensor`` in f32 before its one cast to ``hidden``'s dtype.

Where the JAX version pads the kernel to a whole number of chunks and
masks the padded columns to -inf, the port's last chunk is just the
remaining columns: the same function (a -inf column adds exp(-inf) = 0
to the sum and is never a label) without copying the [E, V] kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from k8s_tpu_torch.parallel import tensor_parallel as tp


def _pick_num_chunks(vocab: int, target_chunk: int) -> int:
    """Chunk count so each chunk is <= target entries."""
    return max(1, -(-vocab // target_chunk))


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result. bf16/f16 operands on the card go
    through cuBLAS with f32 output (no bf16 rounding of the logits); on
    the CPU through an f32 product of the same values."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, kernel, bias, labels, mask, z_loss: float,
                num_chunks: int, cdt, axis, vocab_start: int):
        e, v = kernel.shape
        x = hidden.reshape(-1, e).to(cdt)
        lab = labels.reshape(-1).long() - vocab_start
        vc = -(-v // num_chunks)
        lses, label_logit = [], torch.zeros(
            lab.shape, dtype=torch.float32, device=x.device)
        with torch.profiler.record_function("fused_ce_fwd"):
            for c0 in range(0, v, vc):
                c1 = min(c0 + vc, v)
                logits = _mm_f32(x, kernel[:, c0:c1].to(cdt))
                if bias is not None:
                    logits = logits + bias[c0:c1].float()
                lses.append(torch.logsumexp(logits, dim=-1))
                local = lab - c0
                hit = (local >= 0) & (local < c1 - c0)
                picked = logits.gather(
                    1, local.clamp(0, c1 - c0 - 1)[:, None])[:, 0]
                label_logit += torch.where(hit, picked, 0.0)
                del logits
            logz = torch.logsumexp(torch.stack(lses), dim=0)
            if axis is not None:
                # every rank's (logsumexp, label logit) per token
                ranks = tp.all_gather(torch.stack([logz, label_logit]), axis,
                                      "ce_forward")
                logz = torch.logsumexp(ranks[:, 0], dim=0)
                label_logit = ranks[:, 1].sum(0)
            losses = logz - label_logit
            if z_loss:
                losses = losses + z_loss * logz.square()
            if mask is not None:
                maskf = mask.reshape(-1).to(torch.float32)
                weights = maskf / maskf.sum().clamp_min(1.0)
            else:
                weights = torch.full_like(losses, 1.0 / losses.numel())
            loss = (losses * weights).sum()
        ctx.save_for_backward(x, kernel, bias, lab, logz, weights)
        ctx.z_loss, ctx.vc, ctx.axis = z_loss, vc, axis
        ctx.hidden_shape, ctx.hidden_dtype = hidden.shape, hidden.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        x, kernel, bias, lab, logz, weights = ctx.saved_tensors
        e, v = kernel.shape
        vc = ctx.vc
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        with torch.profiler.record_function("fused_ce_bwd"):
            # d loss / d logz and / d label logit, per token
            dlogz = g * weights * (1.0 + 2.0 * ctx.z_loss * logz)
            dlabel = -g * weights
            dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device) \
                if need_x else None
            dw = torch.empty_like(kernel) if need_w else None
            db = torch.empty_like(bias) if need_b else None
            rows = torch.arange(lab.numel(), device=x.device)
            for c0 in range(0, v, vc):
                c1 = min(c0 + vc, v)
                w_c = kernel[:, c0:c1].to(x.dtype)
                logits = _mm_f32(x, w_c)
                if bias is not None:
                    logits = logits + bias[c0:c1].float()
                # softmax of the full row times dlogz, plus the label term
                dlogits = torch.exp(logits - logz[:, None]) * dlogz[:, None]
                del logits
                local = lab - c0
                hit = (local >= 0) & (local < c1 - c0)
                dlogits[rows[hit], local[hit]] += dlabel[hit]
                dl = dlogits.to(x.dtype)
                if need_x:
                    dx += _mm_f32(dl, w_c.t())
                if need_w:
                    dw[:, c0:c1] = _mm_f32(x.t(), dl).to(dw.dtype)
                if need_b:
                    db[c0:c1] = dlogits.sum(0).to(db.dtype)
                del dlogits, dl
        if dx is not None:
            if ctx.axis is not None:
                # the sum over every rank's columns
                dx = tp.all_reduce(dx, ctx.axis, "ce_backward")
            dx = dx.to(ctx.hidden_dtype).reshape(ctx.hidden_shape)
        return dx, dw, db, None, None, None, None, None, None, None


def fused_lm_head_cross_entropy(
    hidden: torch.Tensor,  # [B, S, E] final hidden states (pre-lm_head)
    kernel: torch.Tensor,  # [E, V] head weights
    labels: torch.Tensor,  # [B, S] int
    mask: Optional[torch.Tensor] = None,  # [B, S]; truthy = counted
    z_loss: float = 0.0,
    target_chunk: int = 8192,
    bias: Optional[torch.Tensor] = None,  # [V] head bias (BERT-style heads)
    compute_dtype: Optional[torch.dtype] = None,
    mesh=None,
) -> torch.Tensor:
    """Mean token cross-entropy of ``softmax(hidden @ kernel + bias)``
    vs ``labels``, computed without materializing the full logits.

    Matches :func:`k8s_tpu_torch.train.cross_entropy_loss` semantics
    (masking, z-loss) on the same logits to f32-accumulation accuracy.
    Differentiable in ``hidden``, ``kernel`` and ``bias`` (a head with a
    bias must pass it, or the bias gets no gradient). ``compute_dtype``
    sets the head-matmul input dtype (default ``hidden.dtype``; pass
    ``torch.float32`` for parity with the unfused f32 head).

    ``mesh`` makes the head vocab-parallel over its ``tensor`` axis (see
    the module docstring): ``kernel`` is then a ``DTensor`` of the whole
    ``[E, V]`` head split by columns over ``tensor`` (the model's
    ``lm_head`` inside its forward) or a plain tensor of this rank's
    ``[E, V/t]`` columns, ``bias`` likewise, and ``hidden``, ``labels`` and ``mask`` are the
    rank's rows, the same on every rank of the axis. The loss is the
    global one on every rank. A vocab the axis does not divide raises.
    """
    e = kernel.shape[0]
    if hidden.shape[-1] != e or tuple(labels.shape) != tuple(hidden.shape[:-1]):
        raise ValueError(f"hidden {tuple(hidden.shape)}, kernel "
                         f"{tuple(kernel.shape)} and labels "
                         f"{tuple(labels.shape)} do not line up")
    axis, vocab_start = None, 0
    if mesh is not None:
        from k8s_tpu_torch.parallel.mesh import mesh_shape

        t = mesh_shape(mesh)["tensor"]
        vocab = kernel.shape[1] if hasattr(kernel, "to_local") \
            else kernel.shape[1] * t
        if vocab % t:
            raise ValueError(
                f"fused_lm_head_cross_entropy: vocab {vocab} is not "
                f"divisible by the tensor axis size {t}")
        axis = tp.TensorAxis.of(mesh)
        cols = axis.shard_range(vocab, "vocab")
        kernel = _local(kernel)
        bias = None if bias is None else _local(bias)
        vocab_start = cols.start
    cdt = compute_dtype if compute_dtype is not None else hidden.dtype
    return _FusedCE.apply(hidden, kernel, bias, labels, mask, float(z_loss),
                          _pick_num_chunks(kernel.shape[-1], target_chunk),
                          cdt, axis, vocab_start)


def _local(w: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s local shard (differentiable), any other tensor
    itself."""
    return w.to_local() if hasattr(w, "to_local") else w
