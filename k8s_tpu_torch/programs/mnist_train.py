"""MNIST data-parallel training (port of
``k8s_tpu/programs/mnist_train.py``), one process per card.

Run config (``KTPU_PROGRAM_ARGS``): ``--steps=N`` (default 60),
``--batch_size=N`` (default 64, the global batch: each rank trains on
its rows of it), ``--log_every=N`` (default 10), ``--device=cuda|cpu``
(default: the rendezvous' ``device``; raises without a card).

The CNN of :class:`~k8s_tpu_torch.models.MnistCNN` on fresh synthetic
batches (``synthetic_mnist``: every rank draws the same global batch and
trains on its rows), data parallel over the processes (``DP`` rules), with
``optax.adamw(1e-3)``: AdamW at 1e-3 with optax's default weight decay
1e-4. Each log point prints the :class:`~k8s_tpu_torch.programs.common.
MetricLogger` line of run ``mnist`` with the gang's ``loss`` and
``accuracy``. :func:`main` returns the logged metrics and the state.
"""

from __future__ import annotations

import functools

import torch

from k8s_tpu_torch import resolve_device
from k8s_tpu_torch.data import synthetic_mnist
from k8s_tpu_torch.models import MnistCNN
from k8s_tpu_torch.parallel import LogicalRules, MeshConfig, build_mesh
from k8s_tpu_torch.programs.common import MetricLogger, parse_run_config
from k8s_tpu_torch.train import (
    adamw,
    create_sharded_state,
    cross_entropy_loss,
    make_batch_sharder,
    make_train_step,
)


def main(rdzv) -> dict:
    import torch.distributed as dist

    from k8s_tpu_torch.parallel.mesh import ensure_process_group

    cfg = parse_run_config(rdzv, {"steps": 60, "batch_size": 64})
    extra = cfg.extra or {}
    device = resolve_device(extra.get("device", getattr(rdzv, "device", "cuda")))
    ensure_process_group(device.type)
    mesh = build_mesh(MeshConfig(data=dist.get_world_size()), device.type)
    state = create_sharded_state(
        MnistCNN(device=device),
        functools.partial(adamw, lr=1e-3, weight_decay=1e-4),
        mesh, LogicalRules(LogicalRules.DP))
    data = synthetic_mnist(cfg.batch_size)
    shard = make_batch_sharder(mesh)

    def loss_fn(state, b):
        logits = state.model(b["images"].permute(0, 3, 1, 2))
        acc = (logits.argmax(-1) == b["labels"].long()).float().mean()
        return cross_entropy_loss(logits, b["labels"]), {"accuracy": acc}

    step_fn = make_train_step(loss_fn)
    logger = MetricLogger(rdzv, "mnist")
    logged = []
    for step in range(1, cfg.steps + 1):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in shard(next(data)).items()}
        state, metrics = step_fn(state, batch)
        if step % cfg.log_every == 0 or step == cfg.steps:
            vals = {k: float(v) for k, v in metrics.items()}
            logged.append((step, vals))
            logger.log(step, vals)
    return {"logged": logged, "state": state}
