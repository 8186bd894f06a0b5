"""The single-device train step (port of ``k8s_tpu/train/trainer_lib.py``).

:func:`make_train_step` builds ``run(state, batch) -> (state, metrics)``
over a :class:`TrainState` (step count, module, optimizer): forward and
backward through ``loss_fn``, optional gradient accumulation over
microbatches, one optimizer update, and optionally the in-step health
block. The optimizer is :func:`adamw`, ``optax.adamw(lr,
weight_decay=0.1)``'s semantics in ``torch.optim.AdamW``.

Eager PyTorch updates the state in place; ``run`` still returns it, as
the JAX step returns the new state. :func:`state_tree` is the state as
the flat tree of tensors the checkpoint tiers save and restore. Metric values stay device tensors
until the caller reads them (no host sync in the step). The mesh,
ZeRO stages, latency hiding and compiler options of the JAX step are
later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

LossFn = Callable[["TrainState", Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


@dataclasses.dataclass
class TrainState:
    """Step count, the module (its parameters are the trained state) and
    the optimizer over them."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer

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


def create_train_state(model: nn.Module, lr: float,
                       weight_decay: float = 0.1) -> TrainState:
    params = [p for p in model.parameters() if p.requires_grad]
    if not params:
        raise ValueError("the model has no trainable parameters "
                         "(a decode config?)")
    return TrainState(step=0, model=model,
                      optimizer=adamw(params, lr, weight_decay))


def init_optimizer_state(state: TrainState) -> None:
    """Create AdamW's per-parameter state as its first step would — a
    float32 ``step`` scalar on the CPU, and ``exp_avg``/``exp_avg_sq``
    zeros like the parameter — for every parameter that has none yet.
    The first update is the same either way; a checkpoint template needs
    the tensors before any step has run."""
    opt = state.optimizer
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state[p]
            if not st:
                st["step"] = torch.tensor(0.0, dtype=torch.float32)
                st["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)


def state_tree(state: TrainState) -> Dict[str, torch.Tensor]:
    """The state as the flat tree the checkpoint tiers save and restore:
    ``step`` (an int64 scalar), ``params/<name>`` (the model's
    ``named_parameters`` names) and ``opt/<name>/{exp_avg,exp_avg_sq,
    step}``. Every tensor but ``step`` IS the live state (a detached
    view of it), so a restore into this tree updates the model and the
    optimizer in place. Call :func:`init_optimizer_state` first on a
    state that has not stepped."""
    tree = {"step": torch.tensor(int(state.step), dtype=torch.int64)}
    names = {}
    for name, p in state.model.named_parameters():
        if p.requires_grad:
            names[p] = name
            tree[f"params/{name}"] = p.detach()
    for p, st in state.optimizer.state.items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            if key in st:
                tree[f"opt/{names[p]}/{key}"] = st[key]
    return tree


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
            src = tree[key]
            if key != "step" and src.data_ptr() != dst.data_ptr():
                dst.copy_(src)
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


def _health_block(old_params, new_params, grads) -> Dict[str, torch.Tensor]:
    """The in-step numerics summary (``make_train_step(health=True)``):
    global gradient L2, count of non-finite gradient elements (f32, so
    huge models don't overflow an int), and the L2 of the applied update
    over the parameters' L2. Device tensors only — no host sync.
    NaN-transparent: a poisoned gradient shows as ``nonfinite_grads >
    0`` and a NaN ``grad_norm``/``update_ratio``."""
    zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    gsq, nonfinite, usq, psq = zero, zero, zero, zero
    for g in grads:
        gf = g.float()
        gsq = gsq + gf.square().sum()
        nonfinite = nonfinite + (~torch.isfinite(gf)).sum().float()
    for new, old in zip(new_params, old_params):
        usq = usq + (new.float() - old.float()).square().sum()
        psq = psq + old.float().square().sum()
    return {
        "grad_norm": gsq.sqrt(),
        "nonfinite_grads": nonfinite,
        "update_ratio": usq.sqrt() / (psq + 1e-20).sqrt(),
    }


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
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def run(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params()
        state.optimizer.zero_grad(set_to_none=True)
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
        if accum_steps > 1:
            for p in params:
                if p.grad is not None:
                    p.grad.div_(accum_steps)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        old = [p.detach().clone() for p in params] if health else None
        state.optimizer.step()
        state.step += 1
        metrics = {"loss": loss_sum / accum_steps,
                   **{k: v / accum_steps for k, v in aux_sum.items()}}
        if health:
            metrics.update(_health_block(old, [p.detach() for p in params],
                                         grads))
        return state, metrics

    return run
