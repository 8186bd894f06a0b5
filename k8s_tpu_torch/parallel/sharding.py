"""Logical-axis sharding rules and the ZeRO layouts (port of
``k8s_tpu/parallel/sharding.py``).

Parameters carry *logical* axis names ("embed", "vocab", "heads",
"mlp", ...); a rules table maps them to mesh axes, so a strategy is a
rules table, not a model change. The port's weights are the JAX kernels
flattened to ``[in, out]`` (``models/llama.py``), so each dimension
carries the logical name of the first JAX dimension merged into it
(:data:`LLAMA_PARAM_AXES`).

A placement is a tuple with one entry per dimension: None (replicated)
or the mesh axis name, or a tuple of names, that shards it — the
entries of a JAX ``PartitionSpec``. :func:`zero1_partition_spec` and
:func:`zero3_selected` are pure functions of (leaf shape, existing
placement, mesh sizes) and choose what the JAX functions choose; the
trainer turns each choice into a ``DTensor`` placement
(``train/trainer_lib.py``).

The ``DP``, ``FSDP``, ``TP``, ``FSDP_TP`` and ``FSDP_TP_SP`` tables run
(``llama_train --strategy=dp|fsdp|fsdp_tp|fsdp_tp_sp``). ``FSDP_TP_SP``'s
``length -> seq`` rule cuts every sequence into one contiguous chunk
per ``seq`` rank (:func:`sequence_chunk`); no parameter carries
``length``, so parameters are whole over ``seq``.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

MeshAxes = Union[None, str, Tuple[str, ...]]
Placement = Tuple[MeshAxes, ...]


class LogicalRules:
    """Ordered logical-name → mesh-axes mapping."""

    DP = (
        ("batch", ("data", "fsdp")),
        ("length", None),
    )
    # the output projections carry their own names ("mlp_down",
    # "heads_out") listed BEFORE "embed", so their dim 0 takes the fsdp
    # axis and every projection shards its input dimension
    FSDP = (
        ("batch", ("data", "fsdp")),
        ("mlp_down", "fsdp"),
        ("heads_out", "fsdp"),
        ("embed", "fsdp"),
        ("length", None),
    )
    # Megatron's layout: q/k/v, gate and up column-parallel, o_proj and
    # down_proj row-parallel (their own names map to "tensor" on dim 0),
    # the embedding and the head vocab-parallel
    TP = (
        ("batch", ("data", "fsdp")),
        ("heads", "tensor"),
        ("heads_out", "tensor"),
        ("kv_heads", "tensor"),
        ("mlp", "tensor"),
        ("mlp_down", "tensor"),
        ("vocab", "tensor"),
        ("length", None),
    )
    # "embed" first: every projection's embed dimension takes fsdp, so
    # o_proj and down_proj shard (tensor, fsdp), embed_tokens (tensor,
    # fsdp) and lm_head (fsdp, tensor)
    FSDP_TP = (
        ("batch", ("data", "fsdp")),
        ("embed", "fsdp"),
        ("heads", "tensor"),
        ("heads_out", "tensor"),
        ("kv_heads", "tensor"),
        ("mlp", "tensor"),
        ("mlp_down", "tensor"),
        ("vocab", "tensor"),
        ("length", None),
    )
    FSDP_TP_SP = (
        ("batch", ("data", "fsdp")),
        ("embed", "fsdp"),
        ("heads", "tensor"),
        ("heads_out", "tensor"),
        ("kv_heads", "tensor"),
        ("mlp", "tensor"),
        ("mlp_down", "tensor"),
        ("vocab", "tensor"),
        ("length", "seq"),
    )

    def __init__(self, rules: Sequence[Tuple[str, MeshAxes]]):
        self._rules: Dict[str, MeshAxes] = dict(rules)
        self._order = tuple(name for name, _ in rules)

    def spec(self, logical_axes: Sequence[Optional[str]]) -> Placement:
        """The placement of an array with these logical axes, with
        flax's rule semantics: rules apply in table order, and a mesh
        axis that an earlier rule gave to one dimension is not given to
        another (so ``o_proj``'s ``heads_out`` takes fsdp before
        ``embed`` can)."""
        out: list = [None] * len(logical_axes)
        used: set = set()
        for name in self._order:
            if name not in logical_axes:
                continue
            pos = list(logical_axes).index(name)
            axes = self._rules[name]
            names = () if axes is None else (
                (axes,) if isinstance(axes, str) else tuple(axes))
            if out[pos] is not None or used & set(names):
                continue
            out[pos] = axes
            used.update(names)
        return tuple(out)

    def __getitem__(self, name: str) -> MeshAxes:
        return self._rules.get(name)


# logical axes of every port parameter (``LlamaForCausalLM.
# named_parameters`` minus the ``layers.<i>.`` prefix): the JAX
# package's, one name per flattened dimension
LLAMA_PARAM_AXES: Dict[str, Tuple[str, ...]] = {
    "embed_tokens": ("vocab", "embed"),
    "lm_head": ("embed", "vocab"),
    "final_norm.weight": ("embed",),
    "input_norm.weight": ("embed",),
    "post_attn_norm.weight": ("embed",),
    "attn.q_proj": ("embed", "heads"),
    "attn.k_proj": ("embed", "kv_heads"),
    "attn.v_proj": ("embed", "kv_heads"),
    "attn.o_proj": ("heads_out", "embed"),
    "mlp.gate_proj": ("embed", "mlp"),
    "mlp.up_proj": ("embed", "mlp"),
    "mlp.down_proj": ("mlp_down", "embed"),
}


def param_logical_axes(name: str) -> Tuple[str, ...]:
    """The logical axes of the port parameter ``name``."""
    parts = name.split(".")
    key = ".".join(parts[2:]) if parts[0] == "layers" else name
    return LLAMA_PARAM_AXES[key]


def param_placement(name: str, rules: LogicalRules) -> Placement:
    return rules.spec(param_logical_axes(name))


def shard_dim(placement: Placement, axis: str) -> Optional[int]:
    """The dimension ``placement`` shards over mesh ``axis`` (None when
    it does not)."""
    for i, entry in enumerate(placement):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        if axis in names:
            return i
    return None


# ---------------------------------------------------------------------------
# ZeRO-1/2/3: optimizer-state, gradient and parameter slices over ``data``
# ---------------------------------------------------------------------------

ZERO1_AXIS = "data"


def zero1_partition_spec(placement: Sequence[MeshAxes], shape: Sequence[int],
                         mesh_sizes: Mapping[str, int],
                         axis: str = ZERO1_AXIS) -> Optional[Placement]:
    """The leaf's placement with the data-parallel mesh axis added to
    the first dimension whose per-shard size it divides — the ZeRO-1
    layout: optimizer moments, the reduced gradients and (stage 3) the
    selected parameters live 1/DP per rank.

    Existing axes are preserved. Returns None when nothing can be
    sharded: ``axis`` missing or of size 1, already used by the
    placement, a leaf of rank < 2 (norm scales stay replicated), or no
    dimension the DP degree divides."""
    dp = int(mesh_sizes.get(axis, 1))
    if dp <= 1 or len(shape) < 2:
        return None
    axes = list(placement) + [None] * (len(shape) - len(placement))
    used = set()
    for entry in axes:
        if isinstance(entry, str):
            used.add(entry)
        elif isinstance(entry, tuple):
            used.update(entry)
    if axis in used:
        return None
    for i, dim in enumerate(shape):
        entry = axes[i]
        names = (() if entry is None
                 else (entry,) if isinstance(entry, str) else tuple(entry))
        shard = dim
        for n in names:
            shard //= max(1, int(mesh_sizes.get(n, 1)))
        if shard and shard % dp == 0:
            axes[i] = (*names, axis) if names else axis
            return tuple(axes)
    return None


def zero3_selected(path: str, shape: Sequence[int], placement: Sequence[MeshAxes],
                   mesh_sizes: Mapping[str, int], min_leaf_size: int = 0,
                   leaves: Optional[Sequence[str]] = None,
                   axis: str = ZERO1_AXIS) -> Optional[Placement]:
    """The selective ZeRO-3 choice for one parameter: its ZeRO-1
    placement when ``path`` contains any of the ``leaves`` substrings or
    its element count is at least ``min_leaf_size`` (> 0), else None;
    also None, "unselected", when no dimension divides the DP degree."""
    numel = 1
    for d in shape:
        numel *= int(d)
    chosen = any(s in path for s in (leaves or ())) or (
        min_leaf_size and numel >= int(min_leaf_size))
    if not chosen:
        return None
    return zero1_partition_spec(placement, shape, mesh_sizes, axis=axis)


# ---------------------------------------------------------------------------
# Where a DTensor's local shard lies in its global array
# ---------------------------------------------------------------------------


def shard_index(shape: Sequence[int], mesh_dims: Sequence[int],
                placements: Sequence, coord: Sequence[int]
                ) -> Tuple[slice, ...]:
    """The global index of the shard at mesh coordinate ``coord`` of an
    array of ``shape`` placed by ``placements`` (one per mesh dimension,
    of sizes ``mesh_dims``): each ``Shard(d)``, in mesh order, cuts the
    current range of dimension ``d`` as ``torch.chunk`` does (chunks of
    ceil(n / k), the last ones short or empty) — FSDP2's and DTensor's
    rule, and the JAX package's for the sizes that divide."""
    bounds = [[0, int(n)] for n in shape]
    for size, place, c in zip(mesh_dims, placements, coord):
        d = getattr(place, "dim", None)
        if d is None or not hasattr(place, "is_shard") or not place.is_shard():
            continue
        lo, hi = bounds[d]
        chunk = -(-(hi - lo) // int(size))
        start = min(hi, lo + int(c) * chunk)
        bounds[d] = [start, min(hi, start + chunk)]
    return tuple(slice(lo, hi) for lo, hi in bounds)


def local_index(t: torch.Tensor) -> Tuple[slice, ...]:
    """The global index of this rank's shard of ``t``: its local shard's
    for a ``DTensor``, the whole array for any other tensor."""
    if not hasattr(t, "placements"):
        return tuple(slice(0, int(n)) for n in t.shape)
    mesh = t.device_mesh
    return shard_index(t.shape, mesh.mesh.shape, t.placements,
                       mesh.get_coordinate())


def all_indices(t: torch.Tensor) -> List[Tuple[slice, ...]]:
    """Every distinct shard index of ``t`` over its mesh (one, the whole
    array, for a tensor that is not a ``DTensor``)."""
    if not hasattr(t, "placements"):
        return [local_index(t)]
    dims = tuple(t.device_mesh.mesh.shape)
    out = []
    for coord in itertools.product(*(range(int(n)) for n in dims)):
        idx = shard_index(t.shape, dims, t.placements, coord)
        if idx not in out:
            out.append(idx)
    return out


def sequence_chunk(x: torch.Tensor, size: int, rank: int,
                   shift: int = 0) -> torch.Tensor:
    """Rank ``rank``'s chunk of ``x`` [B, S, ...] under the ``length ->
    seq`` rule over ``size`` ranks: positions ``[r S / n + shift, (r + 1)
    S / n + shift)``, cut at the sequence's end (``shift=1`` gives the
    next-token labels of the chunk: the last chunk's are one shorter). A
    length the axis does not divide raises."""
    s = x.shape[1]
    if s % size:
        raise ValueError(f"sequence length {s} is not divisible by the seq "
                         f"axis size {size}")
    c = s // size
    start = rank * c + shift
    return x[:, start:start + c]


def sharded_embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                             dtype: Optional[torch.dtype] = None
                             ) -> torch.Tensor:
    """[V, E] table, [B, S] ids -> [B, S, E], cast to ``dtype``. A plain
    gather: under ``fsdp`` the table is whole inside the forward of the
    module that owns it (FSDP2 gathered it), and a ZeRO-3 table is
    gathered before that forward."""
    x = F.embedding(ids, table)
    return x if dtype is None else x.to(dtype)
