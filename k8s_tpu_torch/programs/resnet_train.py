"""ResNet-50 data-parallel training with checkpoint/resume and held-out
evaluation (port of ``k8s_tpu/programs/resnet_train.py``), one process
per card.

Run config (``KTPU_PROGRAM_ARGS``), the JAX program's keys:
  --steps=N, --batch_size=N   (default 50 and 256) the global batch:
                              each rank trains on its share of it
  --tiny=1                    ResNet (1, 1), 8 filters, 100 classes, 64²
                              (default: ResNet-50, 1000 classes, 224²)
  --stem=conv7|space_to_depth the ResNet-50 stem (default conv7); the
                              stems' ``conv_init`` weights differ, so a
                              checkpoint of one does not restore into the
                              other — clear the directory when switching
  --data_dir=DIR              train on the ``*.rec`` shards under DIR
                              (``data.records``) through the native
                              loader and the device prefetch; ``eval-*``
                              shards are held out for evaluation; without
                              it, one fixed synthetic batch
  --eval_every=N              evaluate every N steps and at the end:
                              ``--eval_steps`` batches (default 4) in eval
                              mode, loss and top-1
  --log_every=N               loss readback interval (default 10)
  --checkpoint_dir=DIR        the persistent tier (or the operator's
                              KTPU_CKPT_DIR); --checkpoint_every=N
  --device=cuda|cpu           default: the rendezvous' ``device``; raises
                              without a card

Data parallelism over the processes with the ``DP`` rules: every rank
holds the whole state, the BatchNorm statistics are synchronized over
the ``data`` group, and the gradients are all-reduced. From records each
rank reads the shard files ``index % world == rank`` and batches of
``batch_size / world`` records (the JAX program puts each process's
batch into a global array of ``batch_size`` rows, so each process trains
on ``batch_size / world`` of them: the same global batch); at least one
train (and eval) shard per process, as the JAX program requires.
Synthetic images are one fixed batch (``synthetic_image_batches``), so
it is moved to the device once. Record batches arrive as uint8 and are
normalized on the device (``/127.5 - 1``). After a restore the record
stream starts again from its beginning, as the JAX program's does: the
native loader cannot seek, and reading and dropping the batches of the
steps done would make a restart's cost grow with the run's progress.

SGD with Nesterov momentum (``optax.sgd(0.1, momentum=0.9,
nesterov=True)``). With a checkpoint directory the state (parameters, BN
running averages, momentum) restores before the loop (``restored``),
every step ends with the preemption poll (SIGTERM: flush at the current
step, exit 143) and the end force-saves.

Events: the JSON lines of :class:`~k8s_tpu_torch.programs.common.
MetricLogger` (run ``resnet50``: ``loss``; ``eval_loss`` and
``eval_top1`` at eval points), ``restored``, ``preempt_checkpoint``.
:func:`main` returns a summary: the logged losses, per-step wall and
data-wait seconds, the state, the step function and the fixed
synthetic batch on the device (None when training from records).
"""

from __future__ import annotations

import functools
import glob
import json
import os
import time

import torch

from k8s_tpu_torch import resolve_device
from k8s_tpu_torch.data import synthetic_image_batches
from k8s_tpu_torch.models import ResNet, ResNet50
from k8s_tpu_torch.parallel import LogicalRules, MeshConfig, build_mesh
from k8s_tpu_torch.programs.common import (
    MetricLogger,
    mark_preempt_aware,
    maybe_preempt_exit,
    parse_run_config,
)
from k8s_tpu_torch.train import (
    create_sharded_state,
    cross_entropy_loss,
    init_optimizer_state,
    load_state_tree,
    make_batch_sharder,
    make_eval_step,
    make_train_step,
    sgd,
    state_tree,
)


def prep_images(images: torch.Tensor) -> torch.Tensor:
    """NHWC images as the model's NCHW (``channels_last``) input: uint8
    record batches normalized to f32 ``/127.5 - 1`` on the device."""
    if images.dtype == torch.uint8:
        images = images.float() / 127.5 - 1.0
    return images.permute(0, 3, 1, 2)


def _record_paths(data_dir: str):
    """``(train, eval)`` shard paths under ``data_dir``, sorted."""
    paths = sorted(glob.glob(os.path.join(data_dir, "*.rec")))
    held = [p for p in paths if os.path.basename(p).startswith("eval-")]
    return [p for p in paths if p not in held], held


def _check_shards(paths, n_proc: int, what: str, data_dir: str) -> None:
    if len(paths) < n_proc:
        # the idx % num_shards file split: fewer files than processes
        # leaves some ranks EMPTY, which EOF at once while the rest wait
        # in the first collective
        raise ValueError(
            f"{len(paths)} {what} shard(s) under {data_dir} but {n_proc} "
            "processes — write at least one shard per process "
            "(write_image_shards(num_shards=...))")


def main(rdzv) -> dict:
    import torch.distributed as dist

    from k8s_tpu_torch.parallel.mesh import ensure_process_group

    cfg = parse_run_config(rdzv, {"steps": 50, "batch_size": 256})
    extra = cfg.extra or {}
    tiny = extra.get("tiny") == "1"
    image_size = 64 if tiny else 224
    num_classes = 100 if tiny else 1000
    device = resolve_device(extra.get("device", getattr(rdzv, "device", "cuda")))
    ensure_process_group(device.type)
    n_proc = dist.get_world_size()
    rank = dist.get_rank()
    mesh = build_mesh(MeshConfig(data=n_proc), device.type)
    model = (ResNet(stage_sizes=(1, 1), num_classes=num_classes, num_filters=8,
                    device=device)
             if tiny else
             ResNet50(num_classes=num_classes, stem=extra.get("stem", "conv7"),
                      device=device))
    state = create_sharded_state(
        model, functools.partial(sgd, lr=0.1, momentum=0.9, nesterov=True),
        mesh, LogicalRules(LogicalRules.DP))
    shard = make_batch_sharder(mesh)

    def to_device(batch):
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    mgr = None
    if cfg.checkpoint_dir:
        from k8s_tpu_torch.train.checkpoint import CheckpointManager

        # a replicated state: process 0 writes, every process restores
        mgr = CheckpointManager(cfg.checkpoint_dir, writer=rank == 0)
        init_optimizer_state(state)
        restored = mgr.restore(state_tree(state))
        if restored is not None:
            load_state_tree(state, restored)
            print(json.dumps({"event": "restored", "step": state.step}),
                  flush=True)

    data_dir = extra.get("data_dir")
    eval_paths = []
    fixed = None
    if data_dir:
        # the input pipeline: record shards -> native loader (C++ threads,
        # zero-copy ring) -> decode -> device prefetch
        from k8s_tpu_torch.data.prefetch import prefetch_to_device
        from k8s_tpu_torch.data.records import image_record_batches

        paths, eval_paths = _record_paths(data_dir)
        if not paths:
            raise FileNotFoundError(f"no .rec shards under {data_dir}")
        _check_shards(paths, n_proc, "record", data_dir)
        if cfg.batch_size % n_proc:
            raise ValueError(f"global batch {cfg.batch_size} is not divisible "
                             f"by the {n_proc} data-parallel ranks")
        local_batch = cfg.batch_size // n_proc
        records = image_record_batches(
            paths, local_batch, image_size,
            shuffle_buffer=4 * local_batch, seed=rank,
            shard_id=rank, num_shards=n_proc)
        data = prefetch_to_device(records, device)
    else:
        # one fixed batch forever: on the device once
        fixed = to_device(shard(next(synthetic_image_batches(
            cfg.batch_size, image_size, num_classes=num_classes))))
        data = iter(lambda: fixed, None)

    def loss_fn(state, b):
        logits = state.model(prep_images(b["images"]))
        return cross_entropy_loss(logits, b["labels"]), {}

    step_fn = make_train_step(loss_fn)

    # held-out evaluation: --eval_every=N runs --eval_steps batches in
    # eval mode (running batch stats) and logs loss and top-1
    eval_every = int(extra.get("eval_every", "0"))
    eval_steps = int(extra.get("eval_steps", "4"))
    run_eval = None
    if eval_every:
        def eval_loss_fn(state, b):
            logits = state.model(prep_images(b["images"]))
            top1 = (logits.argmax(-1) == b["labels"].long()).float().mean()
            return cross_entropy_loss(logits, b["labels"]), {"top1": top1}

        eval_step_fn = make_eval_step(eval_loss_fn)
        if data_dir:
            from k8s_tpu_torch.data.records import image_record_batches, record_bytes

            if not eval_paths:
                # real training data but no held-out shards: random
                # synthetic eval would log noise as the metric
                raise FileNotFoundError(
                    f"--eval_every set but no eval-*.rec shards under "
                    f"{data_dir} (write them with "
                    "write_image_shards(prefix='eval'))")
            _check_shards(eval_paths, n_proc, "eval", data_dir)
            # every rank must run the same number of eval steps: each
            # computes every shard's full-batch count from file sizes
            rb = record_bytes(image_size)

            def shard_batches(s):
                recs = sum(os.path.getsize(p) // rb
                           for i, p in enumerate(eval_paths) if i % n_proc == s)
                return recs // local_batch

            avail = min(shard_batches(s) for s in range(n_proc))
            if avail == 0:
                raise ValueError(
                    "an eval shard holds fewer records than one batch "
                    f"({local_batch}); a silent 0.0 eval metric would be "
                    "worse than failing — write bigger eval shards or "
                    "lower batch_size")
            eval_steps = min(eval_steps, avail)

            def make_eval_iter():
                # the same records from the start of the held-out set at
                # every eval; full batches only (the tail is not scored)
                return (to_device(b) for b in image_record_batches(
                    eval_paths, local_batch, image_size, shard_id=rank,
                    num_shards=n_proc, loop=False, drop_remainder=True))
        else:
            def make_eval_iter():
                # a deterministic synthetic stream, the same every eval
                return (to_device(shard(b)) for b in synthetic_image_batches(
                    cfg.batch_size, image_size, num_classes=num_classes,
                    seed=1))

        def run_eval(state):
            loss = top1 = 0.0
            it = make_eval_iter()
            for _ in range(eval_steps):  # the same count on every process
                m = eval_step_fn(state, next(it))
                loss += float(m["loss"])
                top1 += float(m["top1"])
            it.close()
            return loss / eval_steps, top1 / eval_steps

    logger = MetricLogger(rdzv, "resnet50")
    # the preemption contract (common.maybe_preempt_exit): flush at the
    # current step and exit 143 on a gang-wide SIGTERM verdict
    if mgr is not None:
        mark_preempt_aware()
    start = state.step
    losses, step_s, data_wait_s = [], [], []
    for step in range(start + 1, cfg.steps + 1):
        t0 = time.perf_counter()
        batch = next(data)
        data_wait_s.append(time.perf_counter() - t0)
        state, metrics = step_fn(state, batch)
        if step % cfg.log_every == 0 or step == cfg.steps:
            loss = float(metrics["loss"])
            losses.append((step, loss))
            logger.log(step, {"loss": loss})
        if run_eval is not None and (step % eval_every == 0 or step == cfg.steps):
            eval_loss, eval_top1 = run_eval(state)
            logger.log(step, {"eval_loss": eval_loss, "eval_top1": eval_top1})
        if mgr is not None:
            maybe_preempt_exit(mgr, rdzv, step, state_tree(state))
            if cfg.checkpoint_every and step % cfg.checkpoint_every == 0:
                mgr.save(step, state_tree(state))
        step_s.append(time.perf_counter() - t0)
    if mgr is not None:
        mgr.save(cfg.steps, state_tree(state), force=True)
        mgr.wait()
        mgr.close()
    if data_dir:
        data.close()
    return {"losses": losses, "step_s": step_s, "data_wait_s": data_wait_s,
            "state": state, "step_fn": step_fn, "fixed_batch": fixed,
            "mesh": mesh, "image_size": image_size}
