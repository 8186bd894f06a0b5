"""BERT MLM pretraining (port of ``k8s_tpu/programs/bert_train.py``),
one process per card.

Run config (``KTPU_PROGRAM_ARGS``), the JAX program's keys:
  --steps=N, --batch_size=N   (default 50 and 32) the global batch: each
                              rank trains on its rows of it
  --tiny=1                    BertConfig.tiny() at sequence 64 (default:
                              BERT-base, 12 x 768, 12 heads of 64, at its
                              max_seq_len 512)
  --fused_ce=0|1              (default 1) the MLM head fused into the
                              cross-entropy, no [B, S, V] logits
  --full_head=1               score every position (default: only the
                              gathered masked positions)
  --log_every=N               loss readback interval (default 10)
  --checkpoint_dir=DIR        the persistent tier (or the operator's
                              KTPU_CKPT_DIR); --checkpoint_every=N
  --device=cuda|cpu           default: the rendezvous' ``device``; raises
                              without a card

The mesh is the JAX program's :func:`tp_layout` over the world's ranks:
the tensor axis the largest power of two up to ``cap`` that divides the
ranks, the heads and the MLP width. A tensor axis above one rank raises
(BERT's tensor-parallel path, ROADMAP A16): one card, or an odd number of
ranks, trains data parallel with the ``TP`` table, which on a one-rank
tensor axis lays the state out as ``DP``.

The batch is the JAX program's, drawn from ``np.random.default_rng(0)``:
random token ids (labels = ids), a 15% token mask, ``n_pred = max(8,
int(seq * 0.15 + 7) // 8 * 8)`` sorted masked positions shared by every
row, their labels and unit weights — one fixed batch, on the device once.
No padding mask and no token types reach the model, as in the JAX
program. The loss (``loss_fn``, the JAX one's three paths): by default
the final hidden states (f32: the last LayerNorm's output) gathered at
the masked positions through the fused LM-head CE with ``mlm_head``'s
kernel and bias, the head product in f32 as the JAX code computes it;
``--full_head=1`` every position under the 15% mask; ``--fused_ce=0``
the model's f32 MLM logits into the plain cross-entropy. AdamW is
``optax.adamw(1e-4)``: weight decay 1e-4 on every leaf.

Weights are random from seed 0 (f32 masters, bf16 compute). With a
checkpoint directory the state (parameters and AdamW's moments) restores
before the loop (``restored``), every step ends with the preemption poll
(SIGTERM: flush at the current step, exit 143) and the end force-saves.

Events: the JSON lines of :class:`~k8s_tpu_torch.programs.common.
MetricLogger` (run ``bert``: ``loss``), ``restored``,
``preempt_checkpoint``. :func:`main` returns a summary: the logged
losses, per-step wall seconds, the state, the step function and the
batch on the device.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import time

import numpy as np
import torch

from k8s_tpu_torch import resolve_device
from k8s_tpu_torch.models import BertConfig, BertForPretraining
from k8s_tpu_torch.ops.fused_ce import fused_lm_head_cross_entropy
from k8s_tpu_torch.parallel import LogicalRules, MeshConfig, build_mesh
from k8s_tpu_torch.programs.common import (
    MetricLogger,
    mark_preempt_aware,
    maybe_preempt_exit,
    parse_run_config,
)
from k8s_tpu_torch.train import (
    adamw,
    create_sharded_state,
    cross_entropy_loss,
    init_optimizer_state,
    load_state_tree,
    make_batch_sharder,
    make_train_step,
    state_tree,
)

LR, WEIGHT_DECAY = 1e-4, 1e-4  # optax.adamw(1e-4): its default decay


def tp_layout(n: int, bcfg: BertConfig, cap: int = 8):
    """(tensor, data, rules) with the TP degree constrained by what the
    MODEL can shard: heads and mlp must divide (BERT-base's 12 heads make
    8-way TP impossible). The vocab row is dropped from the rules when
    the vocab (30522 = 2·3·5087) does not divide — the mlm head then
    replicates."""
    t = 1
    while (t * 2 <= cap and n % (t * 2) == 0
           and bcfg.num_heads % (t * 2) == 0
           and bcfg.intermediate_size % (t * 2) == 0):
        t *= 2
    rules = list(LogicalRules.TP)
    if bcfg.vocab_size % t:
        rules = [("vocab", None) if k == "vocab" else (k, v)
                 for k, v in rules]
    return t, n // t, LogicalRules(tuple(rules))


def synthetic_batch(batch_size: int, seq: int, vocab_size: int) -> dict:
    """The JAX program's fixed MLM batch (numpy), drawn in its order from
    ``np.random.default_rng(0)``."""
    n_pred = max(8, int(seq * 0.15 + 7) // 8 * 8)
    rng_np = np.random.default_rng(0)
    ids = rng_np.integers(0, vocab_size, (batch_size, seq)).astype("int32")
    mask = (rng_np.random((batch_size, seq)) < 0.15).astype("int32")
    masked_pos = np.sort(
        rng_np.permutation(seq)[:n_pred]
    ).astype("int32")[None].repeat(batch_size, axis=0)
    return {
        "input_ids": ids, "labels": ids, "mask": mask,
        "masked_pos": masked_pos,
        "masked_labels": np.take_along_axis(ids, masked_pos, axis=1),
        "masked_w": np.ones((batch_size, n_pred), "int32"),
    }


def make_loss_fn(fused_ce: bool = True, full_head: bool = False):
    """The JAX program's ``loss_fn`` as ``(state, batch) -> (loss, {})``:
    the gathered masked positions through the fused CE (default), every
    position through it (``full_head``), or the unfused f32 logits
    (``fused_ce=False``)."""

    def loss_fn(state, b):
        model = state.model
        if fused_ce:
            hidden, _ = model(b["input_ids"], return_hidden=True)
            head = model.mlm_head
            if not full_head:
                idx = b["masked_pos"].long()[:, :, None].expand(
                    -1, -1, hidden.shape[-1])
                gathered = torch.gather(hidden, 1, idx)
                return fused_lm_head_cross_entropy(
                    gathered, head.kernel, b["masked_labels"],
                    mask=b["masked_w"], bias=head.bias), {}
            return fused_lm_head_cross_entropy(
                hidden, head.kernel, b["labels"], mask=b["mask"],
                bias=head.bias), {}
        mlm, _ = model(b["input_ids"])
        return cross_entropy_loss(mlm, b["labels"], mask=b["mask"]), {}

    return loss_fn


def main(rdzv) -> dict:
    import torch.distributed as dist

    from k8s_tpu_torch.parallel.mesh import ensure_process_group

    cfg = parse_run_config(rdzv, {"steps": 50, "batch_size": 32})
    extra = cfg.extra or {}
    tiny = extra.get("tiny") == "1"
    device = resolve_device(extra.get("device", getattr(rdzv, "device", "cuda")))
    ensure_process_group(device.type)
    n = dist.get_world_size()
    rank = dist.get_rank()
    bcfg = BertConfig.tiny() if tiny else BertConfig.base()
    tensor, data, rules = tp_layout(n, bcfg, cap=4 if tiny else 8)
    mesh = build_mesh(MeshConfig(data=data, tensor=tensor), device.type)
    bcfg = dataclasses.replace(bcfg, mesh=mesh)  # raises at tensor > 1
    model = BertForPretraining(bcfg, device=device, seed=0)
    seq = bcfg.max_seq_len if not tiny else 64
    state = create_sharded_state(
        model, functools.partial(adamw, lr=LR, weight_decay=WEIGHT_DECAY),
        mesh, rules)
    shard = make_batch_sharder(mesh)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in shard(synthetic_batch(cfg.batch_size, seq,
                                               bcfg.vocab_size)).items()}

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

    fused_ce = extra.get("fused_ce", "1") not in ("0", "false")
    full_head = extra.get("full_head", "0") in ("1", "true")
    step_fn = make_train_step(make_loss_fn(fused_ce, full_head))
    logger = MetricLogger(rdzv, "bert")
    if mgr is not None:
        mark_preempt_aware()
    start = state.step
    losses, step_s = [], []
    for step in range(start + 1, cfg.steps + 1):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        if step % cfg.log_every == 0 or step == cfg.steps:
            loss = float(metrics["loss"])
            losses.append((step, loss))
            logger.log(step, {"loss": loss})
        if mgr is not None:
            maybe_preempt_exit(mgr, rdzv, step, state_tree(state))
            if cfg.checkpoint_every and step % cfg.checkpoint_every == 0:
                mgr.save(step, state_tree(state))
        step_s.append(time.perf_counter() - t0)
    if mgr is not None:
        mgr.save(cfg.steps, state_tree(state), force=True)
        mgr.wait()
        mgr.close()
    return {"losses": losses, "step_s": step_s, "state": state,
            "step_fn": step_fn, "batch": batch, "mesh": mesh, "seq": seq}
