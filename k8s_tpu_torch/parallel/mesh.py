"""Device-mesh construction (port of ``k8s_tpu/parallel/mesh.py``).

The mesh names the parallelism dimensions, as in the JAX package:

- ``data``   — pure data parallelism (gradient all-reduce; the ZeRO
  ladder slices optimizer state, gradients and selected parameters over
  it)
- ``fsdp``   — fully-sharded data parallelism (parameters and optimizer
  state sharded, gathered per block by FSDP2)
- ``tensor`` — Megatron-style tensor parallelism (heads, MLP columns
  and the vocab split; ``parallel/tensor_parallel.py``)
- ``seq`` — sequence parallelism: rank ``r`` of the axis holds the
  chunk ``[r S / n, (r + 1) S / n)`` of every sequence, and attention
  runs as ring or Ulysses attention over the axis
  (``parallel/ring_attention.py``, ``parallel/ulysses.py``)
- ``stage``, ``expert`` — pipeline and expert parallelism (later
  slices; their size is 1 here)

One process drives one card, so the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the world's ranks,
rank ``r`` at the row-major position ``r`` of :attr:`MeshConfig.shape`.
:func:`build_mesh` joins a one-process group when the process has none,
so a world of one runs the code of a world of eight. The TPU topology
helpers (``mesh_for_topology``) and the latency-hiding flags are XLA's
and are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

AXES = ("data", "fsdp", "stage", "expert", "seq", "tensor")


@dataclass(frozen=True)
class MeshConfig:
    """Sizes per logical axis; -1 on ``data`` means "absorb the rest"."""

    data: int = -1
    fsdp: int = 1
    stage: int = 1
    expert: int = 1
    seq: int = 1
    tensor: int = 1

    def resolved(self, n_devices: int) -> "MeshConfig":
        known = self.fsdp * self.stage * self.expert * self.seq * self.tensor
        data = self.data
        if data == -1:
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by non-data axes product {known}"
                )
            data = n_devices // known
        if data * known != n_devices:
            raise ValueError(
                f"mesh {self} needs {data * known} devices, have {n_devices}"
            )
        return MeshConfig(data, self.fsdp, self.stage, self.expert, self.seq, self.tensor)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.data, self.fsdp, self.stage, self.expert, self.seq, self.tensor)


# seconds the one-process group of :func:`ensure_process_group` took to
# join (None until it joined one)
PROCESS_GROUP_INIT_S = None


def ensure_process_group(device_type: str) -> None:
    """Join a one-process group when this process has none: NCCL on the
    card (its communicator created here, for the current card), gloo on
    the CPU, its store in memory (no port). A launcher with several
    processes has joined the job's group already."""
    import time

    import torch.distributed as dist

    global PROCESS_GROUP_INIT_S
    if dist.is_initialized():
        return
    kw = {}
    if device_type == "cuda":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    dist.init_process_group(
        backend="nccl" if device_type == "cuda" else "gloo",
        store=dist.HashStore(), rank=0, world_size=1, **kw)
    PROCESS_GROUP_INIT_S = time.perf_counter() - t0


def build_mesh(config: MeshConfig, device_type: str = "cuda"):
    """A ``DeviceMesh`` with the six named axes over the world's ranks
    (``config`` resolved against the world size) on ``device_type``
    (``"cuda"``, the card the launcher selected, or ``"cpu"``). Every
    rank must call it at the same point: the mesh makes one process
    group per axis."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    ensure_process_group(device_type)
    cfg = config.resolved(dist.get_world_size())
    return init_device_mesh(device_type, cfg.shape, mesh_dim_names=AXES)


def mesh_shape(mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh`` (the JAX ``dict(mesh.shape)``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


class MeshAxis(NamedTuple):
    """One named axis of a mesh as this rank sees it: the axis's process
    group, its size and this rank's index on it."""

    group: object
    size: int
    rank: int


def mesh_axis(mesh, name: str) -> MeshAxis:
    """The ``name`` axis of ``mesh`` (``"seq"``: the ranks that hold the
    other chunks of this rank's sequences) as a :class:`MeshAxis`."""
    sub = mesh[name]
    return MeshAxis(sub.get_group(), int(sub.size()), int(sub.get_local_rank()))


def data_parallel_degree(mesh) -> int:
    """The mesh's ``data`` axis size — the DP degree the elastic-resize
    loop reasons in. Every layout downstream is a pure function of the
    mesh, so a resized world needs no state from the old one."""
    try:
        return int(mesh_shape(mesh).get("data", 1) or 1)
    except Exception:
        return 1


def best_pow2_split(n: int, max_first: int) -> Tuple[int, int]:
    """Largest power-of-two ≤ max_first dividing n, and the cofactor."""
    first = 1
    while first * 2 <= max_first and n % (first * 2) == 0:
        first *= 2
    return first, n // first
