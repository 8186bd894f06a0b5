"""Megatron-style tensor parallelism over the mesh's ``tensor`` axis (the
collectives GSPMD inserts for the JAX package's ``TP``/``FSDP_TP`` rules,
``k8s_tpu/parallel/sharding.py``).

Under those rules the q/k/v, gate and up projections are column-parallel
(their output features split over ``tensor``), ``o_proj`` and
``down_proj`` row-parallel (their input features split), and the
embedding table and the LM head vocab-parallel. Eager PyTorch inserts no
collective, so the model calls the two conjugate ops of Megatron-LM
around each pair:

- :func:`copy_to_tensor_region` ("f"): identity forward, all-reduce of
  the gradient backward — before a column-parallel product, whose input
  every tensor rank holds whole and whose gradient each rank holds a
  part of;
- :func:`reduce_from_tensor_region` ("g"): all-reduce forward, identity
  backward — after a row-parallel product, whose output each rank holds
  a partial sum of;
- :func:`gather_from_tensor_region`: all-gather of the last dimension
  forward, this rank's slice of the gradient backward — the whole
  logits of a vocab-parallel head, for the unfused loss.

The row-parallel all-reduce runs in the activations' dtype (bf16 in
training on the card). XLA reduces a partitioned bf16 dot in bf16 too,
and bf16 halves the bytes the all-reduce moves. An f32 reduce would stay
closer to the one-process step, which rounds one f32 accumulation to
bf16 once instead of rounding each rank's partial. The CPU tests run
f32, so neither they nor the card's first-loss check at tensor 1 can
tell the two apart.

Every op issues its collective on any tensor group, the one-rank group
of a world of one included, and counts it in :data:`COLLECTIVES`, so
the card at world size 1 runs, and counts, what a gang runs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

#: tensor-axis collectives issued since the last :func:`reset_counts`,
#: by op: ``reduce`` (row-parallel outputs, forward), ``copy`` (column-
#: parallel inputs' gradients, backward), ``embed`` (the vocab-parallel
#: lookup, forward), ``ce_forward`` (the vocab-parallel loss's all-gather
#: of its per-rank statistics), ``ce_backward`` (its hidden gradient) and
#: ``logits`` (the whole logits of the unfused loss, forward); and the
#: ZeRO ladder's collectives over the ``data`` axis
#: (``train/trainer_lib.py``): ``data_reduce_scatter`` (a sliced leaf's
#: gradient into its piece), ``data_all_gather`` (the pieces back into a
#: parameter or FSDP2 shard) and ``data_all_reduce`` (one bucket of the
#: unsliced gradients); and the sequence-parallel layout's
#: ``seq_all_reduce`` (one bucket of the gradients summed over ``seq``)
COLLECTIVES: Dict[str, int] = {}


def reset_counts() -> None:
    COLLECTIVES.clear()


def _count(op: str) -> None:
    COLLECTIVES[op] = COLLECTIVES.get(op, 0) + 1


@dataclasses.dataclass(frozen=True)
class TensorAxis:
    """The ``tensor`` axis of a mesh as one rank sees it: its process
    group, its size and this rank's coordinate on it."""

    group: object
    size: int
    rank: int

    @classmethod
    def of(cls, mesh) -> "TensorAxis":
        sub = mesh["tensor"]
        return cls(sub.get_group(), int(sub.size()),
                   int(sub.get_local_rank()))

    def shard_range(self, n: int, what: str) -> range:
        """This rank's contiguous block of ``n`` items (the ``Shard`` rule
        for a size the axis divides)."""
        if n % self.size:
            raise ValueError(f"{what} {n} is not divisible by the tensor "
                             f"axis size {self.size}")
        per = n // self.size
        return range(self.rank * per, (self.rank + 1) * per)


def all_reduce(x: torch.Tensor, axis: TensorAxis, op: str) -> torch.Tensor:
    """Sum ``x`` over the tensor group in place, counted as ``op``."""
    _count(op)
    dist.all_reduce(x, group=axis.group)
    return x


def all_gather(x: torch.Tensor, axis: TensorAxis, op: str) -> torch.Tensor:
    """Every rank's ``x``, stacked in rank order (``[t, *x.shape]``),
    counted as ``op``."""
    parts = x.new_empty((axis.size * x.numel(),))
    _count(op)
    dist.all_gather_into_tensor(parts, x.contiguous().reshape(-1),
                                group=axis.group)
    return parts.view((axis.size,) + tuple(x.shape))


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.axis, "copy"), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, op):
        return all_reduce(x.contiguous().clone(), axis, op)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, op):
        ctx.axis = axis
        return torch.cat(all_gather(x, axis, op).unbind(0), dim=-1)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[-1] // ctx.axis.size
        return g[..., ctx.axis.rank * n:(ctx.axis.rank + 1) * n], None, None


def copy_to_tensor_region(x: torch.Tensor, axis: TensorAxis) -> torch.Tensor:
    """Identity forward; all-reduce of the gradient over ``tensor``
    backward (Megatron's "f")."""
    return _Copy.apply(x, axis)


def reduce_from_tensor_region(x: torch.Tensor, axis: TensorAxis,
                              op: str = "reduce") -> torch.Tensor:
    """All-reduce over ``tensor`` forward; identity backward (Megatron's
    "g")."""
    return _Reduce.apply(x, axis, op)


def gather_from_tensor_region(x: torch.Tensor, axis: TensorAxis,
                              op: str = "logits") -> torch.Tensor:
    """Every rank's ``x`` concatenated along the last dimension, in rank
    order (all-gather forward); backward, this rank's slice of the
    gradient, which every rank holds whole and the same."""
    return _Gather.apply(x, axis, op)


def vocab_parallel_embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                                    axis: TensorAxis,
                                    dtype: Optional[torch.dtype] = None
                                    ) -> torch.Tensor:
    """[V/t, E] local rows of a table split over ``tensor`` (rank r holds
    rows ``[r V / t, (r + 1) V / t)``), [B, S] global ids -> [B, S, E] in
    ``dtype``: each rank gathers the ids in its row range, zeroes the
    rest, and the ranks' results are summed — the function the JAX
    lookup computes over a vocab-sharded table
    (``k8s_tpu/parallel/sharding.py`` ``sharded_embedding_lookup``; one
    rank contributes each row, so the sum is exact in any dtype). The
    gradient reaches only the rows this rank owns."""
    n = table.shape[0]
    local = ids - axis.rank * n
    hit = (local >= 0) & (local < n)
    x = F.embedding(local.clamp(0, n - 1), table)
    x = torch.where(hit[..., None], x, 0.0)
    if dtype is not None:
        x = x.to(dtype)
    return reduce_from_tensor_region(x, axis, "embed")


def expected_per_step(num_layers: int, recompute: bool) -> Dict[str, int]:
    """The tensor-axis collectives of one training step of the Llama
    model, by :data:`COLLECTIVES` op: per block 2 ``reduce`` all-reduces
    forward (attention and MLP outputs) and 2 ``copy`` all-reduces
    backward (their inputs' gradients); with ``recompute`` (remat) the
    attention's ``reduce`` once more, since the recompute re-runs a
    block only up to its last saved tensor (``torch.utils.checkpoint``'s
    early stop), the MLP's down-projection input, which the MLP's
    all-reduce follows; for the head 1 ``embed`` all-reduce, the loss's
    ``ce_forward`` all-gather and its ``ce_backward`` all-reduce."""
    return {"reduce": num_layers * (3 if recompute else 2),
            "copy": 2 * num_layers, "embed": 1, "ce_forward": 1,
            "ce_backward": 1}
