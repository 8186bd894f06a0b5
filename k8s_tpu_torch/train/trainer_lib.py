"""The train step and the sharded training state (port of
``k8s_tpu/train/trainer_lib.py``).

:func:`make_train_step` builds ``run(state, batch) -> (state, metrics)``
over a :class:`TrainState` (step count, module, optimizer and, for a
sharded state, its :class:`ShardedLayout`): forward and backward through
``loss_fn``, optional gradient accumulation over microbatches, the
gradient sync of the state's strategy, one optimizer update, and
optionally the in-step health block. The optimizer comes from the
caller, as the JAX ``create_sharded_state`` takes an optax transform: a
learning rate means :func:`adamw` (``optax.adamw(lr,
weight_decay=0.1)``'s semantics in ``torch.optim.AdamW``, the Llama
trainer's), or a function from the parameter list to an optimizer, e.g.
``functools.partial(sgd, lr=0.1)`` (``optax.sgd(0.1, momentum=0.9,
nesterov=True)``) or ``functools.partial(adamw, lr=1e-3,
weight_decay=1e-4)`` (``optax.adamw(1e-3)``). A model's buffers are its
batch statistics (the JAX ``TrainState.batch_stats``: the ResNet's BN
running averages), updated in place by the training forward.
:func:`make_eval_step` runs the model in eval mode without gradients.

:func:`create_sharded_state` is the one place that lays the state out
over a mesh (``parallel/mesh.py``), one process per card:

- ``dp`` (the ``DP`` rules), ZeRO stage 0: every rank holds the whole
  state and all-reduces the mean gradient;
- ``dp``, stage 1: as 0, but each rank keeps only its
  :func:`~k8s_tpu_torch.parallel.sharding.zero1_partition_spec` slice
  ("piece") of each shardable leaf's moments: the leaf's gradient is
  reduce-scattered into the slice after the backward (the other leaves'
  all-reduced), AdamW updates the slice, then the updated slices are
  all-gathered into the replicated parameter — after the update, never
  in the backward;
- ``dp``, stage 2: as 1, with the reduce-scatter into the slice as each
  parameter's gradient lands (a post-accumulate-grad hook), so no
  full-size gradient outlives its own backward;
- ``dp``, stage 3: as 2, and the leaves
  :func:`~k8s_tpu_torch.parallel.sharding.zero3_selected` picks are held
  as their slice between steps and all-gathered once per step, in a
  forward pre-hook on the model that runs before its forward;
- ``fsdp`` (the ``FSDP`` rules): FSDP2 ``fully_shard`` per
  :class:`~k8s_tpu_torch.models.llama.LlamaBlock` and on the root over
  the mesh's ``fsdp`` axis — HSDP over ``(data, fsdp)`` with several
  slices — each parameter sharded on the dimension the rules give the
  ``fsdp`` axis. A ZeRO stage on top of it is a no-op while ``data`` is
  1, as in the JAX package;
- ``fsdp`` or ``fsdp_tp`` with ``data`` > 1 at stage 1–3 (ZeRO on the
  HSDP mesh): FSDP2 over the ``fsdp`` axis alone, and the ``data`` axis
  is the ZeRO ladder's, as under ``dp`` but on each rank's FSDP2 shard:
  the piece is the :func:`~k8s_tpu_torch.parallel.sharding.
  zero1_partition_spec` slice of the local shard (``data`` appended to
  the leaf's ``fsdp`` dimension, or a later dimension it divides), so a
  rank's moments are 1/``data`` of its shard; after FSDP2's
  reduce-scatter over ``fsdp`` the gradient is reduce-scattered over
  ``data`` into the piece (stage 1 after the backward, stages 2–3 as
  each FSDP2 unit's gradient lands, dropping the shard's gradient), the
  unsliced leaves' gradients (rank-1 norms) are all-reduced over
  ``data``, and after the update the pieces are all-gathered over
  ``data`` back into the shard (stages 1–2; stage 3 keeps the selected
  leaves as pieces between steps and gathers them before the root's
  forward, ahead of every FSDP2 unit's unshard). Every such collective
  is counted in :data:`~k8s_tpu_torch.parallel.tensor_parallel.COLLECTIVES`
  (``data_reduce_scatter``, ``data_all_gather``, ``data_all_reduce``);
- ``fsdp_tp`` (the ``FSDP_TP`` rules): first every parameter becomes a
  ``DTensor`` on the mesh's ``tensor`` axis, split on the dimension the
  rules give ``tensor`` (the norms ``Replicate()``), and the model runs
  its tensor-parallel forward
  (:meth:`~k8s_tpu_torch.models.llama.LlamaForCausalLM.use_tensor_parallel`);
  then FSDP2 as under ``fsdp``, which composes the two into one
  ``DTensor`` per leaf over ``(fsdp, tensor)`` (``(data, fsdp,
  tensor)`` under HSDP);
- ``fsdp_tp_sp`` (the ``FSDP_TP_SP`` rules): as ``fsdp_tp``, and the
  model runs on each ``seq`` rank's chunk of the sequence
  (:meth:`~k8s_tpu_torch.models.llama.LlamaForCausalLM.
  use_sequence_parallel`: ring or Ulysses attention over ``seq``).
  Parameters are whole over ``seq`` (no parameter carries ``length``);
  each ``seq`` rank's backward gives its chunk's share of the gradient,
  so after FSDP2's mean over ``fsdp`` (and ``data``) the shards'
  gradients are summed over the ``seq`` group (counted as
  ``seq_all_reduce``) — the gradient of the global loss, as GSPMD gives
  the JAX step. The loss must be the global one on every ``seq`` rank
  (:func:`sequence_mean`). ZeRO on top of a ``seq`` axis of more than
  one rank is not ported.

A sliced leaf appears in :func:`state_tree` as a ``DTensor`` whose local
tensor is the live slice (``Shard(dim)`` over ``data``; on the HSDP mesh
over a ``(fsdp, tensor, data)`` view of the mesh, so a dimension split by
``fsdp`` and then ``data`` is cut fsdp-major as the JAX placement
``("fsdp", "data")`` cuts it), and FSDP2's leaves are ``DTensor`` s
already, so the checkpoint tiers see each rank's shard with its global
index, and a restore at another ``data`` size re-cuts the shards from
the saved ones (``ckpt.local.union_covering_plan`` /
``overlap_covering_plan``) with no layout state carried across. Eager
PyTorch updates the state in place; ``run`` still returns it, as the
JAX step returns the new state.
Metric values stay device tensors until the caller reads them; they are
the gang's global values (the loss over the global batch, the health
block over every shard), the same on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from k8s_tpu_torch.parallel.mesh import mesh_shape
from k8s_tpu_torch.parallel.tensor_parallel import _count
from k8s_tpu_torch.parallel.sharding import (
    LogicalRules,
    param_placement,
    shard_dim,
    zero1_partition_spec,
    zero3_selected,
)

LossFn = Callable[["TrainState", Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
# the optimizer of a state: AdamW's learning rate, or a function from the
# parameter list to the optimizer
OptimizerSpec = Union[float, Callable[[list], torch.optim.Optimizer]]


@dataclasses.dataclass
class TrainState:
    """Step count, the module (its parameters are the trained state),
    the optimizer over them, and the layout of a sharded state (None:
    one replica, no collectives)."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    layout: Optional["ShardedLayout"] = None

    def params(self):
        return [p for p in self.model.parameters() if p.requires_grad]


def adamw(params, lr: float, weight_decay: float = 0.1) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=weight_decay)`` over one parameter
    group: b1 0.9, b2 0.999, eps 1e-8, decoupled decay of every leaf
    (torch's default decay is 0.01; optax's is set here). The per-tensor
    loop (``foreach=False``) keeps the optimizer's transient memory at one
    tensor's worth instead of a copy of all the moments."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay, foreach=False)


def sgd(params, lr: float, momentum: float = 0.9,
        nesterov: bool = True) -> torch.optim.SGD:
    """``optax.sgd(lr, momentum=momentum, nesterov=nesterov)``: the same
    update (optax's trace starts at zeros, torch's momentum buffer at the
    first gradient — the same first step), no weight decay, one tensor at
    a time."""
    return torch.optim.SGD(params, lr=lr, momentum=momentum,
                           nesterov=nesterov, foreach=False)


def _optimizer(spec: OptimizerSpec, params, weight_decay: float):
    if callable(spec):
        return spec(params)
    return adamw(params, float(spec), weight_decay)


def _trainable(model: nn.Module):
    params = [p for p in model.parameters() if p.requires_grad]
    if not params:
        raise ValueError("the model has no trainable parameters "
                         "(a decode config?)")
    return params


def create_train_state(model: nn.Module, optimizer: OptimizerSpec,
                       weight_decay: float = 0.1) -> TrainState:
    """One replica's state: ``optimizer`` is AdamW's learning rate (with
    ``weight_decay``) or a function from the parameters to the
    optimizer."""
    params = _trainable(model)
    return TrainState(step=0, model=model,
                      optimizer=_optimizer(optimizer, params, weight_decay))


# ---------------------------------------------------------------------------
# The sharded state
# ---------------------------------------------------------------------------


def _resolve_zero_stage(zero1: bool, zero_stage: Optional[int]) -> int:
    """Normalize the (legacy ``zero1`` bool, ``zero_stage`` int) pair to
    one stage 0..3. ``zero1=True`` alone means stage 1; an explicit
    ``zero_stage`` wins (stages are cumulative: 2 and 3 imply the
    sharded optimizer state of 1)."""
    if zero_stage is None:
        return 1 if zero1 else 0
    stage = int(zero_stage)
    if not 0 <= stage <= 3:
        raise ValueError(f"zero_stage must be 0..3, got {zero_stage}")
    if zero1 and stage == 0:
        return 1
    return stage


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _to_local(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s local shard (the tensor itself otherwise)."""
    return t.to_local() if hasattr(t, "to_local") else t


@dataclasses.dataclass
class _ZeroLeaf:
    """One ZeRO-sliced parameter: the model's parameter, the dimension
    its slices cut, and ``piece``, this rank's slice — the tensor AdamW
    updates (a view of the parameter at stages 1–2; its own storage at
    stage 3, where the parameter exists only between a forward's gather
    and the update). Under ``dp`` the piece is cut from the whole
    parameter; on the HSDP mesh from the rank's FSDP2 shard, and
    ``zspec`` is the leaf's placement with ``data`` added (its
    checkpoint index)."""

    name: str
    param: nn.Parameter
    dim: int
    piece: nn.Parameter
    stage3: bool
    shape: Tuple[int, ...]
    zspec: Optional[Tuple] = None
    nbytes: int = 0  # the storage a released stage-3 shard regrows to


class ShardedLayout:
    """How a :class:`TrainState` is laid out over the mesh, and the
    collectives of its step (:func:`make_train_step` calls them)."""

    def __init__(self, strategy: str, mesh, zero_stage: int):
        self.strategy = strategy
        self.mesh = mesh
        self.zero_stage = zero_stage
        self.data_group = mesh.get_group("data")
        self.data_mesh = mesh["data"]
        self.leaves: List[_ZeroLeaf] = []
        self.hooks = []
        # ZeRO on the HSDP mesh: the mesh as (fsdp, tensor, data), the
        # sliced leaves' checkpoint view (set by create_sharded_state)
        self.zero_mesh = None
        # the seq axis's group when it has more than one rank (set by
        # create_sharded_state): the gradients are summed over it
        self.seq_group = None

    @property
    def world(self) -> int:
        return dist.get_world_size()

    @property
    def fsdp2(self) -> bool:
        """Whether FSDP2 holds the parameters (``fsdp``, ``fsdp_tp``)."""
        return self.strategy in ("fsdp", "fsdp_tp")

    @property
    def hsdp_zero(self) -> bool:
        """Whether ZeRO slices FSDP2's shards over ``data`` (the HSDP
        mesh at stage >= 1)."""
        return self.fsdp2 and bool(self.leaves)

    def is_sharded(self, q: torch.Tensor) -> bool:
        """Whether optimizer parameter ``q`` is one rank's shard (FSDP2's
        ``DTensor`` s, a ZeRO piece) rather than a replica."""
        if any(q is z.piece for z in self.leaves):
            return True
        return self.fsdp2 and hasattr(q, "placements")

    def replicas(self, q: torch.Tensor) -> int:
        """How many ranks hold each shard of sharded parameter ``q``: the
        sizes of the mesh dimensions it is not split over (HSDP's
        ``data``, the ``tensor`` axis of a norm scale; with ZeRO on the
        HSDP mesh every FSDP2 shard also repeats over ``data``), 1 for a
        ZeRO piece; times the ``seq`` ranks, which hold the same
        parameters."""
        seq = _group_size(self.seq_group) if self.seq_group is not None else 1
        if not hasattr(q, "placements"):
            return seq
        n = seq * (_group_size(self.data_group) if self.hsdp_zero else 1)
        for size, place in zip(q.device_mesh.mesh.shape, q.placements):
            if not place.is_shard():
                n *= int(size)
        return n

    # -- dp ZeRO ---------------------------------------------------------

    def gather(self, z: _ZeroLeaf) -> torch.Tensor:
        """The parameter (its FSDP2 shard on the HSDP mesh) from every
        rank's piece (all-gather over ``data`` along ``z.dim``)."""
        _count("data_all_gather")
        dp = _group_size(self.data_group)
        local = z.piece.detach().movedim(z.dim, 0).contiguous()
        out = torch.empty((dp * local.shape[0],) + tuple(local.shape[1:]),
                          dtype=local.dtype, device=local.device)
        dist.all_gather_into_tensor(out, local, group=self.data_group)
        return out.movedim(0, z.dim)

    def reduce_scatter(self, z: _ZeroLeaf, grad: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the sum over ``data`` of ``grad``."""
        _count("data_reduce_scatter")
        dp = _group_size(self.data_group)
        full = grad.movedim(z.dim, 0).contiguous()
        out = torch.empty((full.shape[0] // dp,) + tuple(full.shape[1:]),
                          dtype=full.dtype, device=full.device)
        dist.reduce_scatter_tensor(out, full, group=self.data_group)
        return out.movedim(0, z.dim)

    def _stage2_hook(self, z: _ZeroLeaf):
        def hook(p: torch.Tensor) -> None:
            # this microbatch's gradient of p landed (FSDP2 calls the
            # hook on its shard after its reduce-scatter over fsdp):
            # reduce it into the slice, then drop it
            shard = self.reduce_scatter(z, _to_local(p.grad))
            z.piece.grad = (shard if z.piece.grad is None
                            else z.piece.grad.add_(shard))
            p.grad = None
        return hook

    def _shard(self, z: _ZeroLeaf) -> torch.Tensor:
        """The tensor ``z``'s pieces are cut from: the parameter, or its
        FSDP2 shard's local tensor (the storage FSDP2 gathers from)."""
        return _to_local(z.param.detach())

    def _stage3_pre_forward(self):
        def hook(module, *args):
            for z in self.leaves:
                if not z.stage3:
                    continue
                if self.hsdp_zero:
                    local = self._shard(z)
                    storage = local.untyped_storage()
                    if storage.nbytes() == 0:
                        storage.resize_(z.nbytes)
                        local.copy_(self.gather(z))
                elif z.param.numel() == 0:
                    z.param.data = self.gather(z)
        return hook

    def release_stage3(self) -> None:
        """Drop the stage-3 parameters (the pieces hold them): the
        whole parameter under ``dp``, the FSDP2 shard's storage on the
        HSDP mesh (refilled by the next forward's gather)."""
        for z in self.leaves:
            if not z.stage3:
                continue
            if self.hsdp_zero:
                self._shard(z).untyped_storage().resize_(0)
            else:
                z.param.data = z.param.data.new_empty((0,))

    def sync_gradients(self, params: Sequence[nn.Parameter],
                       accum_steps: int) -> None:
        """After the backward: the mean gradient over the gang, in each
        optimizer parameter's ``.grad`` (the piece's for a sliced
        leaf), summed over the ``seq`` ranks' chunks."""
        if self.seq_group is not None:
            _all_reduce_bucketed([_to_local(p.grad) for p in params
                                  if p.grad is not None], self.seq_group,
                                 "seq_all_reduce")
        if self.fsdp2 and not self.hsdp_zero:
            # FSDP2 reduce-scattered (and, under HSDP, all-reduced) the
            # mean already; tensor peers computed the same gradient of
            # their own columns (the model's collectives)
            if accum_steps > 1:
                for p in params:
                    if p.grad is not None:
                        p.grad.div_(accum_steps)
            return
        dp = _group_size(self.data_group)
        sliced = {id(z.param) for z in self.leaves}
        if dp > 1:
            # the unsliced gradients (on the HSDP mesh FSDP2 left each
            # rank the mean over fsdp of its data replica's, in its shard)
            # are summed over data; the sliced ones are reduce-scattered
            # into their pieces (stage 1 here, stages 2-3 in the hook)
            _all_reduce_bucketed(
                [_to_local(p.grad) for p in params
                 if p.grad is not None and id(p) not in sliced],
                self.data_group)
        for z in self.leaves:
            if self.zero_stage == 1 and z.param.grad is not None:
                z.piece.grad = self.reduce_scatter(z, _to_local(z.param.grad))
                z.param.grad = None
        if dp * accum_steps > 1:
            for q in self.optimizer_params(params):
                if q.grad is not None:
                    q.grad.div_(dp * accum_steps)

    def optimizer_params(self, params: Sequence[nn.Parameter]):
        """The tensors AdamW updates, in the model's parameter order:
        each sliced leaf's piece, every other parameter itself."""
        if self.fsdp2 and not self.hsdp_zero:
            return list(params)
        sliced = {id(z.param): z.piece for z in self.leaves}
        return [sliced.get(id(p), p) for p in params]

    def after_update(self) -> None:
        """After AdamW: stages 1–2 all-gather the updated slices into the
        replicated parameters; stage 3 frees its whole parameters."""
        with torch.no_grad():
            for z in self.leaves:
                if not z.stage3:
                    self._shard(z).copy_(self.gather(z))
        self.release_stage3()

    def leaf_tensor(self, z: _ZeroLeaf, local: torch.Tensor):
        """``local``, a piece-shaped tensor of ``z`` (the piece or one of
        its moments), as the ``DTensor`` of ``z``'s whole shape whose
        local shard it is (no copy: a restore into it fills ``local``):
        ``Shard(dim)`` over ``data``, and on the HSDP mesh over the
        ``(fsdp, tensor, data)`` view, each axis of ``z.zspec`` cutting
        its dimension in that order."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        stride = []
        acc = 1
        for d in reversed(z.shape):
            stride.append(acc)
            acc *= d
        mesh, places = self.data_mesh, [Shard(z.dim)]
        if z.zspec is not None:
            mesh = self.zero_mesh
            places = []
            for axis in ZERO_MESH_AXES:
                d = shard_dim(z.zspec, axis)
                places.append(Replicate() if d is None else Shard(d))
        return DTensor.from_local(
            local, mesh, places, run_check=False,
            shape=torch.Size(z.shape), stride=tuple(reversed(stride)))

    def close(self) -> None:
        for h in self.hooks:
            h.remove()
        self.hooks = []


# gradients summed per all-reduce: one flat buffer of at most this many
# bytes per dtype, as DDP's buckets
BUCKET_BYTES = 256 << 20


def _all_reduce_bucketed(tensors: Sequence[torch.Tensor], group,
                         op: str = "data_all_reduce") -> None:
    """Sum ``tensors`` over ``group`` in place, a few all-reduces of
    flat buckets instead of one per tensor (each counted as ``op``)."""
    bucket: List[torch.Tensor] = []
    nbytes = 0

    def flush():
        if not bucket:
            return
        flat = torch.cat([t.reshape(-1) for t in bucket])
        _count(op)
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
        bucket.clear()

    for t in tensors:
        if bucket and (t.dtype != bucket[0].dtype
                       or t.device != bucket[0].device
                       or nbytes + t.numel() * t.element_size() > BUCKET_BYTES):
            flush()
            nbytes = 0
        bucket.append(t)
        nbytes += t.numel() * t.element_size()
    flush()


# the mesh axes of a ZeRO piece's checkpoint view on the HSDP mesh, in
# the order they cut a dimension: the JAX placement appends ``data`` to a
# dimension's axes, and no FSDP_TP dimension carries both fsdp and tensor
ZERO_MESH_AXES = ("fsdp", "tensor", "data")


def _zero_mesh(mesh):
    """The mesh's ranks as a ``(fsdp, tensor, data)`` ``DeviceMesh`` (its
    stage, expert and seq axes are 1): the mesh a ZeRO piece on the HSDP
    mesh is a ``DTensor`` of. Every rank calls it (it makes groups)."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = mesh.mesh.reshape(mesh.mesh.shape[0], mesh.mesh.shape[1],
                              mesh.mesh.shape[-1])
    return DeviceMesh(mesh.device_type, ranks.permute(1, 2, 0).contiguous(),
                      mesh_dim_names=ZERO_MESH_AXES)


def _fsdp_wrap(model: nn.Module, mesh, rules: LogicalRules,
               over_data: bool = True) -> None:
    """FSDP2 over the ``fsdp`` axis (``(data, fsdp)``, HSDP, with several
    slices, unless ``over_data`` is False: then the ``data`` axis is the
    ZeRO ladder's): one unit per block and the root, each parameter
    sharded on the dimension the rules give ``fsdp``."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    sizes = mesh_shape(mesh)
    sub = (mesh["fsdp"] if sizes["data"] == 1 or not over_data
           else mesh["data", "fsdp"])
    name_of = {id(p): n for n, p in model.named_parameters()}

    def placement(p):
        dim = shard_dim(param_placement(name_of[id(p)], rules), "fsdp")
        return Shard(0 if dim is None else dim)

    for block in getattr(model, "layers", ()):
        fully_shard(block, mesh=sub, shard_placement_fn=placement)
    fully_shard(model, mesh=sub, shard_placement_fn=placement)


def _tensor_parallel_layout(model: nn.Module, mesh,
                            rules: LogicalRules) -> None:
    """Every parameter as a ``DTensor`` on the mesh's ``tensor`` axis:
    this rank's block of the dimension the rules give ``tensor``
    (``Shard``; a size the axis does not divide raises), or the whole
    parameter (``Replicate()``: the norm scales). Every rank holds the
    same whole parameters, so each cuts its own block and no collective
    runs. Then the model runs its tensor-parallel forward."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from k8s_tpu_torch.ops.attention import check_sharded_split
    from k8s_tpu_torch.parallel.tensor_parallel import TensorAxis

    cfg, sizes = model.config, mesh_shape(mesh)
    axis = TensorAxis.of(mesh)
    # the heads here, with the JAX message; the global batch where it is
    # cut (the sharder), every other split dimension below
    check_sharded_split(sizes["data"] * sizes["fsdp"], cfg.num_heads,
                        cfg.num_kv_heads, mesh)
    tmesh = mesh["tensor"]
    for name, p in list(model.named_parameters()):
        dim = shard_dim(param_placement(name, rules), "tensor")
        if dim is None:
            local, place = p.detach().clone(), Replicate()
        else:
            rows = axis.shard_range(p.shape[dim], name)
            local = p.detach().narrow(dim, rows.start, len(rows))
            local, place = local.contiguous(), Shard(dim)
        dt = DTensor.from_local(local, tmesh, [place], run_check=False,
                                shape=p.shape, stride=p.stride())
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf,
                nn.Parameter(dt, requires_grad=p.requires_grad))
    model.use_tensor_parallel(mesh)


def create_sharded_state(model: nn.Module, optimizer: OptimizerSpec, mesh,
                         rules: LogicalRules, zero_stage: int = 0,
                         zero3_min_leaf_size: int = 0,
                         zero3_leaves: Optional[Sequence[str]] = None,
                         weight_decay: float = 0.1) -> TrainState:
    """The state of ``model`` (its parameters loaded) laid out over
    ``mesh`` by ``rules`` (``LogicalRules.DP``, ``.FSDP``, ``.FSDP_TP`` or
    ``.FSDP_TP_SP``; ``.TP``, bert_train's table, only on a mesh whose
    ``tensor`` axis is one rank, where it lays the state out as ``.DP``
    does) and the ZeRO stage, with its optimizer (AdamW's
    learning rate, or a function from the parameters to the optimizer).
    Every rank calls it with the same parameters. The ZeRO ladder slices
    AdamW's moments, so a stage above 0 takes AdamW's learning rate and
    refuses an optimizer function (its state would be dropped). A
    model with synchronized BatchNorm (``use_sync_batch_norm``) gets the
    ``data`` group, so its statistics cover the global batch; it trains
    under ``dp`` only."""
    stage = int(zero_stage)
    if stage > 0 and callable(optimizer):
        raise ValueError(
            f"zero_stage={stage} slices AdamW's moments: give AdamW's learning "
            "rate, not an optimizer function (its state would be dropped)")
    sizes = mesh_shape(mesh)
    if any(sizes[a] != 1 for a in ("stage", "expert")):
        raise NotImplementedError(
            f"mesh {sizes}: stage and expert axes come with later "
            "slices (ROADMAP A8, A9)")
    seq = rules["length"] == "seq"
    if sizes["seq"] != 1 and not seq:
        raise ValueError(f"mesh {sizes} has a seq axis that the rules map no "
                         "dimension to (train with FSDP_TP_SP)")
    fsdp = rules["embed"] == "fsdp"
    tensor = rules["heads"] == "tensor"
    if tensor and not fsdp:
        if sizes["tensor"] != 1:
            raise NotImplementedError(
                "LogicalRules.TP on a tensor axis of more than one rank lays "
                "out tensor-parallel serving and BERT's tensor-parallel "
                "training, which are not ported to k8s_tpu_torch yet "
                "(ROADMAP A15, A16); train with FSDP_TP")
        # bert_train's table on a one-rank tensor axis: every rule maps to
        # an axis of size 1 but the batch's, so the layout is dp's
        tensor = False
    if sizes["tensor"] != 1 and not tensor:
        raise ValueError(f"mesh {sizes} has a tensor axis that the rules "
                         "map no parameter to (train with FSDP_TP)")
    strategy = "fsdp_tp" if tensor else ("fsdp" if fsdp else "dp")
    layout = ShardedLayout(strategy, mesh, stage)
    if hasattr(model, "use_sync_batch_norm"):
        if strategy != "dp":
            raise NotImplementedError(
                f"a model with synchronized BatchNorm trains under dp only, "
                f"not {strategy} (its statistics would cover one rank's rows)")
        model.use_sync_batch_norm(layout.data_group)
    zero = stage >= 1 and sizes["data"] > 1
    if zero and sizes["seq"] > 1:
        raise NotImplementedError(
            f"zero_stage={stage} over data with a seq axis of {sizes['seq']} "
            "ranks is not ported to k8s_tpu_torch yet (ROADMAP A7)")
    if tensor:
        _tensor_parallel_layout(model, mesh, rules)
    if seq:
        model.use_sequence_parallel(mesh)
        if sizes["seq"] > 1:
            layout.seq_group = mesh.get_group("seq")
    if fsdp:
        # ZeRO on top of fsdp is a no-op at data 1, as in the JAX package
        _fsdp_wrap(model, mesh, rules, over_data=not zero)
        if zero:
            layout.zero_mesh = _zero_mesh(mesh)
    if zero:
        dp = sizes["data"]
        r = dist.get_rank(layout.data_group)
        for name, p in model.named_parameters():
            if not p.requires_grad:
                continue
            placement = param_placement(name, rules)
            z = zero1_partition_spec(placement, p.shape, sizes)
            if z is None:
                continue
            dim = shard_dim(z, "data")
            local = _to_local(p.detach())
            n = local.shape[dim] // dp
            s3 = stage >= 3 and zero3_selected(
                name, p.shape, placement, sizes,
                min_leaf_size=zero3_min_leaf_size,
                leaves=zero3_leaves) is not None
            view = local.narrow(dim, r * n, n)
            piece = nn.Parameter(view.clone() if s3 else view)
            leaf = _ZeroLeaf(name, p, dim, piece, s3, tuple(p.shape),
                             z if fsdp else None,
                             local.untyped_storage().nbytes())
            layout.leaves.append(leaf)
            if stage >= 2:
                # FSDP2 calls a shard's hooks after its reduce-scatter
                layout.hooks.append(
                    p.register_post_accumulate_grad_hook(
                        layout._stage2_hook(leaf)))
        if any(z.stage3 for z in layout.leaves):
            # every stage-3 leaf refilled before the root's forward, ahead
            # of FSDP2's own root pre-forward: every unit's unshard (a
            # block's too) then reads a whole shard. The pieces are
            # gathered once per step; a remat recompute in the backward
            # calls no root hook.
            layout.hooks.append(model.register_forward_pre_hook(
                layout._stage3_pre_forward(), prepend=True))
        layout.release_stage3()
    opt = _optimizer(optimizer, layout.optimizer_params(_trainable(model)),
                     weight_decay)
    return TrainState(step=0, model=model, optimizer=opt, layout=layout)


def make_batch_sharder(mesh) -> Callable[[Dict], Dict]:
    """This rank's rows of a global batch: the batch splits over the
    ``data`` x ``fsdp`` ranks (the ``batch`` rule), rank ``r`` of them
    taking rows ``[r B / W, (r + 1) B / W)``. A batch W does not divide
    raises. Scalars ride along whole."""
    sizes = mesh_shape(mesh)
    w = sizes["data"] * sizes["fsdp"]
    coord = mesh.get_coordinate() or [0] * len(sizes)
    r = coord[0] * sizes["fsdp"] + coord[1]

    def shard(batch):
        out = {}
        for key, x in batch.items():
            if getattr(x, "ndim", 0) < 1:
                out[key] = x
                continue
            if x.shape[0] % w:
                raise ValueError(
                    f"global batch {x.shape[0]} is not divisible by the "
                    f"{w} data-parallel ranks")
            n = x.shape[0] // w
            out[key] = x[r * n:(r + 1) * n]
        return out

    return shard


def init_optimizer_state(state: TrainState) -> None:
    """Create the optimizer's per-parameter state as its first step
    would, for every parameter that has none yet: AdamW's float32
    ``step`` scalar on the CPU and ``exp_avg``/``exp_avg_sq`` zeros like
    the parameter; SGD's ``momentum_buffer`` zeros (its first step then
    sets it to ``0.9 * 0 + g = g``, as torch's first step and optax's
    trace do). The first update is the same either way; a checkpoint
    template needs the tensors before any step has run."""
    opt = state.optimizer
    adam = isinstance(opt, torch.optim.AdamW)
    for group in opt.param_groups:
        if not adam and not group.get("momentum"):
            continue  # plain SGD keeps no state
        for p in group["params"]:
            st = opt.state[p]
            if st:
                continue
            zeros = torch.zeros_like(p, memory_format=torch.preserve_format)
            if adam:
                st["step"] = torch.tensor(0.0, dtype=torch.float32)
                st["exp_avg"] = zeros
                st["exp_avg_sq"] = torch.zeros_like(zeros)
            else:
                st["momentum_buffer"] = zeros


def state_tree(state: TrainState) -> Dict[str, torch.Tensor]:
    """The state as the flat tree the checkpoint tiers save and restore:
    ``step`` (an int64 scalar), ``params/<name>`` (the model's
    ``named_parameters`` names), ``batch_stats/<name>`` (its buffers:
    BN running averages) and ``opt/<name>/{exp_avg,exp_avg_sq,step}``
    (AdamW) or ``opt/<name>/momentum_buffer`` (SGD). Every tensor but
    ``step`` IS the live state (a detached view of it), so a restore into
    this tree updates the model and the optimizer in place. A sharded leaf is a ``DTensor`` whose local
    shard is this rank's live slice (FSDP2's parameters and moments; a
    ZeRO slice's moments, and its parameter at stage 3). Call
    :func:`init_optimizer_state` first on a state that has not stepped."""
    tree = {"step": torch.tensor(int(state.step), dtype=torch.int64)}
    lay = state.layout
    sliced = {id(z.param): z for z in lay.leaves} if lay is not None else {}
    names = {}
    for name, p in state.model.named_parameters():
        if not p.requires_grad:
            continue
        z = sliced.get(id(p))
        if z is None:
            names[id(p)] = (name, None)
            tree[f"params/{name}"] = p.detach()
            continue
        names[id(z.piece)] = (name, z)
        tree[f"params/{name}"] = (lay.leaf_tensor(z, z.piece.detach())
                                  if z.stage3 else p.detach())
    for name, b in state.model.named_buffers():
        tree[f"batch_stats/{name}"] = b.detach()
    for q, st in state.optimizer.state.items():
        name, z = names[id(q)]
        for key in ("exp_avg", "exp_avg_sq", "step", "momentum_buffer"):
            if key in st:
                v = st[key]
                tree[f"opt/{name}/{key}"] = (
                    lay.leaf_tensor(z, v) if z is not None and key != "step"
                    else v)
    return tree


def _copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst``'s shard of ``src`` into ``dst`` (both whole, both the same
    layout, or a sharded ``dst`` of a whole ``src``)."""
    from k8s_tpu_torch.parallel.sharding import local_index

    local = _to_local(dst)
    if hasattr(src, "placements"):
        src = _to_local(src) if hasattr(dst, "placements") else src.full_tensor()
    elif hasattr(dst, "placements"):
        src = src[local_index(dst)]
    if local.data_ptr() != src.data_ptr():
        local.copy_(src)


def load_state_tree(state: TrainState, tree: Dict[str, torch.Tensor]) -> None:
    """Inverse of :func:`state_tree`: copy ``tree`` into the state (a
    no-op for the tensors a restore already filled in place) and set
    the step. The tree must name every tensor of ``state_tree(state)``
    (initialize a fresh optimizer first)."""
    own = state_tree(state)
    if set(own) != set(tree):
        raise ValueError(
            f"state tree differs: missing {sorted(set(own) - set(tree))[:8]}, "
            f"unexpected {sorted(set(tree) - set(own))[:8]}")
    with torch.no_grad():
        for key, dst in own.items():
            if key != "step":
                _copy_into(dst, tree[key])
        if state.layout is not None:
            # the parameters (shards) of a ZeRO slice follow its piece
            for z in state.layout.leaves:
                if not z.stage3:
                    state.layout._shard(z).copy_(state.layout.gather(z))
    state.step = int(tree["step"])


def cross_entropy_loss(
    logits: torch.Tensor,  # [..., V] f32
    labels: torch.Tensor,  # [...] int
    mask: Optional[torch.Tensor] = None,
    z_loss: float = 0.0,
) -> torch.Tensor:
    """Token-level CE with optional masking and z-loss regularizer
    (stabilizes the softmax normalizer at scale)."""
    logz = torch.logsumexp(logits, dim=-1)
    label_logits = logits.gather(-1, labels[..., None].long())[..., 0]
    losses = logz - label_logits
    if z_loss:
        losses = losses + z_loss * logz.square()
    if mask is not None:
        maskf = mask.to(losses.dtype)
        return (losses * maskf).sum() / maskf.sum().clamp_min(1.0)
    return losses.mean()


class _SeqSum(torch.autograd.Function):
    """Sum over the ``seq`` group forward, identity backward: each rank
    keeps the gradient of its own chunk's terms (Megatron's "g")."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def sequence_mean(mean: torch.Tensor, count, axis) -> torch.Tensor:
    """The global mean of a per-token loss from this ``seq`` rank's
    ``mean`` over its chunk's ``count`` tokens (an int, or a device
    scalar for a mask's count): ``sum(mean_r count_r) / sum(count_r)``
    over the ``seq`` axis ``axis`` (``.group``), the same on every rank.
    Chunks count differently — the last drops the final position, packed
    boundaries drop more — so a mean of the chunks' means would be
    wrong. The backward gives each rank ``count_r / sum(count_r)`` of
    the gradient of its own mean: summed over the ranks (the layout's
    ``seq_all_reduce``), the gradient of the global mean."""
    count = torch.as_tensor(count, dtype=torch.float32, device=mean.device)
    total = _SeqSum.apply(torch.stack([mean.float() * count, count]), axis.group)
    return total[0] / total[1].detach().clamp_min(1.0)


def _health_sums(old_params, new_params, grads, device=None) -> torch.Tensor:
    """``[sum g^2, non-finite count, sum (new - old)^2, sum old^2]`` in
    f32 over the given tensors (local shards: a sharded state adds them
    up over its ranks), on ``device`` (default: the first gradient's)."""
    dev = device if device is not None else grads[0].device
    out = torch.zeros(4, dtype=torch.float32, device=dev)
    for g in grads:
        gf = g.float()
        out[0] += gf.square().sum()
        out[1] += (~torch.isfinite(gf)).sum().float()
    for new, old in zip(new_params, old_params):
        out[2] += (new.float() - old.float()).square().sum()
        out[3] += old.float().square().sum()
    return out


def _health_metrics(sums: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {
        "grad_norm": sums[0].sqrt(),
        "nonfinite_grads": sums[1],
        "update_ratio": sums[2].sqrt() / (sums[3] + 1e-20).sqrt(),
    }


def _health_block(old_params, new_params, grads) -> Dict[str, torch.Tensor]:
    """The in-step numerics summary (``make_train_step(health=True)``):
    global gradient L2, count of non-finite gradient elements (f32, so
    huge models don't overflow an int), and the L2 of the applied update
    over the parameters' L2. Device tensors only — no host sync.
    NaN-transparent: a poisoned gradient shows as ``nonfinite_grads >
    0`` and a NaN ``grad_norm``/``update_ratio``."""
    return _health_metrics(_health_sums(old_params, new_params, grads))


def _split(batch: Dict[str, torch.Tensor], accum_steps: int):
    """The batch as ``accum_steps`` microbatches along dim 0 (a scalar
    leaf rides every microbatch)."""
    parts = {}
    for key, x in batch.items():
        if x.ndim < 1:
            parts[key] = [x] * accum_steps
            continue
        if x.shape[0] % accum_steps:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                             f"accum_steps {accum_steps}")
        parts[key] = list(x.chunk(accum_steps, dim=0))
    return [{key: parts[key][i] for key in batch} for i in range(accum_steps)]


def _mean_over_ranks(loss, aux, extra, world: int):
    """One all-reduce over the world: ``loss`` and every ``aux`` value
    averaged (each rank's is the mean over its equal share of the global
    batch), ``extra`` (a vector, or None) summed."""
    keys = list(aux)
    vec = torch.stack([loss.reshape(()).float()]
                      + [aux[k].reshape(()).to(loss.device) for k in keys])
    if extra is not None:
        vec = torch.cat([vec, extra])
    dist.all_reduce(vec)
    n = 1 + len(keys)
    means = vec[:n] / world
    return (means[0], {k: means[1 + i] for i, k in enumerate(keys)},
            vec[n:] if extra is not None else None)


def make_train_step(loss_fn: LossFn, accum_steps: int = 1,
                    health: bool = False):
    """Build the train step.

    ``loss_fn(state, batch) -> (loss, aux)`` with ``aux`` a dict of
    scalar metrics. ``accum_steps > 1`` accumulates gradients over that
    many microbatches (batch dim 0 must divide evenly; a batch that does
    not raises): the gradients of each microbatch add up in the f32
    parameter gradients and are divided by ``accum_steps`` — one
    optimizer update per call on the mean gradient, which for
    mean-reduced losses over equal microbatches equals the full-batch
    one. The loss and ``aux`` are averaged over microbatches. (A masked
    loss normalizes by its own microbatch's token count, so very uneven
    masks weigh sparse microbatches up, as in the JAX step.)

    ``health=True`` adds ``grad_norm``, ``nonfinite_grads`` and
    ``update_ratio`` (:func:`_health_block`) to the metrics; it keeps a
    copy of the parameters across the update to measure it.

    A state with a :class:`ShardedLayout` runs its collectives: the
    gradient sync of its strategy and stage after the backward, the
    slices' all-gather after the update, and one ``all_reduce`` of the
    loss and ``aux`` with the sharded leaves' health sums, so the metrics
    are the gang's (none of them in a world of one).
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def run(state: TrainState, batch: Dict[str, torch.Tensor]):
        lay = state.layout
        params = state.params()
        opt_params = lay.optimizer_params(params) if lay is not None else params
        state.optimizer.zero_grad(set_to_none=True)
        for p in params:
            p.grad = None
        micro = [batch] if accum_steps == 1 else _split(batch, accum_steps)
        loss_sum, aux_sum = None, {}
        for mb in micro:
            loss, aux = loss_fn(state, mb)
            loss.backward()
            loss = loss.detach().float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            for key, val in aux.items():
                val = torch.as_tensor(val).detach().float()
                aux_sum[key] = aux_sum[key] + val if key in aux_sum else val
        if lay is not None:
            lay.sync_gradients(params, accum_steps)
        elif accum_steps > 1:
            for p in params:
                if p.grad is not None:
                    p.grad.div_(accum_steps)
        grads = [_to_local(q.grad) if q.grad is not None
                 else torch.zeros_like(_to_local(q)) for q in opt_params]
        old = ([_to_local(q).detach().clone() for q in opt_params]
               if health else None)
        state.optimizer.step()
        if lay is not None:
            lay.after_update()
        state.step += 1
        loss = loss_sum / accum_steps
        sums = part = None
        if health:
            new = [_to_local(q).detach() for q in opt_params]
            sharded = ([lay.is_sharded(q) for q in opt_params]
                       if lay is not None else [False] * len(opt_params))

            def pick(xs, flag):
                return [x for x, f in zip(xs, sharded) if f == flag]

            sums = _health_sums(pick(old, False), pick(new, False),
                                pick(grads, False), loss.device)
            # each shard counted once over the gang: a shard held by r
            # ranks (HSDP's data replicas, a norm scale's tensor peers)
            # adds 1/r of its sums on each
            groups: Dict[int, List[int]] = {}
            for i, q in enumerate(opt_params):
                if sharded[i]:
                    groups.setdefault(lay.replicas(q), []).append(i)
            for r, idx in groups.items():
                h = _health_sums([old[i] for i in idx], [new[i] for i in idx],
                                 [grads[i] for i in idx], loss.device) / r
                part = h if part is None else part + h
        aux = {k: v / accum_steps for k, v in aux_sum.items()}
        if lay is not None and lay.world > 1:
            # one all-reduce: the ranks' losses and aux metrics (the
            # global batch's are the means of their means) and the
            # shards' health sums
            loss, aux, part = _mean_over_ranks(loss, aux, part, lay.world)
        if part is not None:
            sums = sums + part
        metrics = {"loss": loss, **aux}
        if health:
            metrics.update(_health_metrics(sums))
        return state, metrics

    return run


def make_eval_step(loss_fn: LossFn):
    """Build the eval step (port of the JAX ``make_eval_step``):
    ``run(state, batch) -> metrics``, ``loss_fn`` under ``torch.no_grad``
    with the model in eval mode (BatchNorm normalizes by its running
    averages and leaves them as they are), the model's mode restored
    after. The metrics are ``loss`` and ``aux`` without a
    ``batch_stats`` key; with a sharded state, averaged over the gang
    (one ``all_reduce``)."""

    def run(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                loss, aux = loss_fn(state, batch)
        finally:
            model.train(was_training)
        aux = {k: torch.as_tensor(v).detach().float()
               for k, v in (aux or {}).items() if k != "batch_stats"}
        loss = loss.detach().float()
        lay = state.layout
        if lay is not None and lay.world > 1:
            loss, aux, _ = _mean_over_ranks(loss, aux, None, lay.world)
        return {"loss": loss, **aux}

    return run
