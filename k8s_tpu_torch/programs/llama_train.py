"""Llama causal-LM training on one device (port of
``k8s_tpu/programs/llama_train.py``, its single-device ``dp`` path).

Run config (``KTPU_PROGRAM_ARGS``), the JAX program's keys:
  --model=tiny|llama3-8b    model (default llama3-8b on cuda, tiny on
                            cpu: tiny's head_dim has no CUDA kernel)
  --layers=N                layer count (default 2 for tiny, 32 for
                            llama3-8b). Departure from the JAX program,
                            which applies it to tiny only: here it also
                            cuts llama3-8b, because one card holds no
                            more than ~12 layers of that width with f32
                            AdamW (16 bytes per parameter: weight, grad
                            and two moments)
  --seq_len=N               sequence length (default 128 tiny, 8192 8B)
  --batch_size=N            (default 16)   --steps=N (default 30)
  --accum_steps=N           gradient-accumulation microbatches (default 1)
  --log_every=N             loss/health readback interval (default 10)
  --lr=F                    AdamW learning rate (default 3e-4)
  --data=learnable          fresh batches of a next-token rule (default:
                            one fixed random batch)
  --fused_ce=0|1            fused LM-head cross-entropy (default 1)
  --health=0|1              in-step health block (default 1)
  --remat_policy=NAME       per-block activation checkpointing with this
                            policy (nothing_saveable|dots|flash|
                            flash_qkv); without it the config's default:
                            nothing_saveable for llama3-8b, off for tiny
  --require_convergence=R   fail unless final loss < R x first loss
  --step_sleep=S            sleep S seconds inside every step's span
                            (widens the window a fault or a poller
                            lands in)
  --device=cuda|cpu         default: the rendezvous' ``device`` (cuda
                            unless KTPU_FORCE_PLATFORM=cpu); raises
                            without a card

Weights are random from seed 0 (f32 masters, bf16 compute).
Options of later slices raise: a ``--strategy`` other than ``dp``,
``--zero_stage``/``--zero1``, ``--checkpoint_dir``, ``--latency_hiding``,
``--num_experts``, ``--quant``.

The loop runs the JAX program's runtime: every step inside a
:meth:`~k8s_tpu_torch.obs.trace.Tracer.step` span with phases
``data_wait``, ``compile`` (the first step, kernel builds included, up
to ``torch.cuda.synchronize()``: the ``block_until_ready``
counterpart), ``step_compute`` and ``host_sync`` (the log points'
readback); the health block on the heartbeat (``tracer.note_health``,
gated on the tracer being on); the per-host obs endpoint under
``KTPU_OBS_ADVERTISE``; the ``nan-grad`` chaos arm
(``KTPU_CHAOS_NAN_GRAD``); ``KTPU_PROFILE_DIR``'s loop profile.

Events (JSON lines): ``mesh`` (dp 1), ``obs_ready`` (with an obs
endpoint), ``compile_phase``, the step/loss lines of
:class:`~k8s_tpu_torch.programs.common.MetricLogger`, ``step_health``
and ``step_phases`` at each log point, ``chaos_nan_grad`` at a poisoned
step, and ``convergence`` at the end. :func:`main` returns a summary
(first and final loss, per-step wall times, the ``step_phases`` events,
the compile seconds, the tracer, and the state, step function and a
batch source for a caller that goes on measuring).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import torch

from k8s_tpu_torch import resolve_device
from k8s_tpu_torch.controller.metrics import CKPT_RESTORE_SECONDS
from k8s_tpu_torch.data import learnable_token_batches, synthetic_token_batches
from k8s_tpu_torch.models import LlamaConfig, LlamaForCausalLM, init_params
from k8s_tpu_torch.obs.health import consume_nan_grad, nan_grad_armed
from k8s_tpu_torch.ops.fused_ce import fused_lm_head_cross_entropy
from k8s_tpu_torch.programs.common import (
    MetricLogger,
    build_tracer,
    maybe_profile,
    parse_run_config,
    start_obs_server,
)
from k8s_tpu_torch.programs.llama_generate import default_model
from k8s_tpu_torch.train import (
    create_train_state,
    cross_entropy_loss,
    make_train_step,
)

Z_LOSS = 1e-4

# options of the JAX trainer this port does not have yet: (arg, env,
# values meaning "off")
_UNPORTED = (
    ("zero_stage", "KTPU_ZERO_STAGE", ("0", "")),
    ("zero1", "KTPU_ZERO1", ("0", "false", "")),
    ("latency_hiding", "KTPU_LATENCY_HIDING", ("0", "false", "")),
    ("num_experts", None, ("0",)),
    ("quant", None, ("none", "")),
)


def _check_unported(cfg, extra) -> None:
    strategy = extra.get("strategy", "dp")
    if strategy != "dp":
        raise NotImplementedError(
            f"strategy={strategy!r} is not ported to k8s_tpu_torch yet "
            "(one device: dp)")
    for key, env, off in _UNPORTED:
        val = extra.get(key, os.environ.get(env, off[0]) if env else off[0])
        if val not in off:
            raise NotImplementedError(
                f"{key}={val!r} is not ported to k8s_tpu_torch yet")
    if cfg.checkpoint_dir:
        raise NotImplementedError(
            f"checkpoint_dir={cfg.checkpoint_dir!r}: checkpointing is not "
            "ported yet")


def model_config(model_name: str, extra: dict) -> LlamaConfig:
    """The training LlamaConfig of ``--model``, ``--layers`` and the
    remat options."""
    if model_name == "llama3-8b":
        lcfg = LlamaConfig.llama3_8b(num_layers=int(extra.get("layers", "32")))
    elif model_name == "tiny":
        lcfg = LlamaConfig.tiny(num_heads=8, num_kv_heads=4, head_dim=16,
                                num_layers=int(extra.get("layers", "2")))
    else:
        raise ValueError(f"unknown model {model_name!r}; expected 'tiny' "
                         "or 'llama3-8b'")
    if "remat_policy" in extra:
        lcfg = dataclasses.replace(lcfg, remat=True,
                                   remat_policy=extra["remat_policy"])
    return lcfg


def _chaos_scaled(loss, batch):
    """Apply the ``nan-grad`` chaos poison when it rides the batch (a
    ``chaos_scale`` scalar, 1.0 normally and 0.0 at the poisoned step):
    ``scale / scale`` is 1 or 0/0 = NaN on the device, making every
    gradient of that step NaN. A no-op when the fault is not armed."""
    scale = batch.get("chaos_scale") if isinstance(batch, dict) else None
    return loss if scale is None else loss * (scale / scale)


def lm_loss(model: LlamaForCausalLM, ids: torch.Tensor,
            fused_ce: bool = True) -> torch.Tensor:
    """Next-token cross-entropy with z-loss 1e-4 of a batch ``ids`` [B,
    S]: the fused LM-head loss over the final hidden states (the [B, S,
    V] logits never exist), or the unfused loss over f32 logits."""
    if fused_ce:
        hidden = model(ids, return_hidden=True)
        return fused_lm_head_cross_entropy(
            hidden[:, :-1], model.lm_head, ids[:, 1:], z_loss=Z_LOSS)
    logits = model(ids)
    labels = torch.roll(ids, -1, dims=1)
    return cross_entropy_loss(logits[:, :-1], labels[:, :-1], z_loss=Z_LOSS)


def main(rdzv) -> dict:
    cfg = parse_run_config(rdzv, {"steps": 30, "batch_size": 16})
    extra = cfg.extra or {}
    _check_unported(cfg, extra)
    device = resolve_device(extra.get("device", getattr(rdzv, "device", "cuda")))
    model_name = extra.get("model", default_model(device))
    seq_len = int(extra.get("seq_len", "128" if model_name == "tiny" else "8192"))
    lead = getattr(rdzv, "process_id", 0) <= 0
    if lead:
        print(json.dumps({"event": "mesh", "num_slices": 1, "dp": 1,
                          "shape": {"data": 1}, "zero1": False,
                          "zero_stage": 0}), flush=True)
    lcfg = model_config(model_name, extra)
    lr = float(extra.get("lr", "3e-4"))
    model = LlamaForCausalLM(lcfg, device=device)
    model.load_params(init_params(lcfg, 0, device, dtype=torch.float32))
    state = create_train_state(model, lr, weight_decay=0.1)
    data_fn = (learnable_token_batches if extra.get("data") == "learnable"
               else synthetic_token_batches)
    data = data_fn(cfg.batch_size, seq_len, lcfg.vocab_size)
    fused_ce = extra.get("fused_ce", "1") not in ("0", "false")
    # tracing + per-host obs endpoint: the tracer wraps every step in
    # phase spans (flight recorder + the heartbeat the reconciler's
    # straggler detection reads); the obs server publishes them
    tracer = build_tracer(rdzv)
    obs_server = start_obs_server(rdzv, tracer)
    # the in-step health block rides the trace gate, as in the JAX
    # program: spec observability.trace=false turns both off
    health = tracer.enabled and extra.get("health", "1") not in ("0", "false")

    def loss_fn(state, b):
        return _chaos_scaled(lm_loss(state.model, b["input_ids"], fused_ce), b), {}

    step_fn = make_train_step(loss_fn, accum_steps=cfg.accum_steps,
                              health=health)
    logger = MetricLogger(rdzv, f"llama-{model_name}-dp")
    step_sleep = float(extra.get("step_sleep", "0"))

    def device_batch():
        return {k: torch.from_numpy(v).to(device) for k, v in next(data).items()}

    # chaos nan-grad (KTPU_CHAOS_NAN_GRAD="<step>" or arm_nan_grad):
    # once armed, a chaos_scale scalar rides every step's batch, NaN
    # only at the armed step
    chaos_nan_live = nan_grad_armed() is not None
    # losses stay device tensors in the loop: the host syncs only at log
    # points (and per step when --log_every=1)
    first_loss = final_loss = None
    step_s, phases, compile_s = [], [], None
    with maybe_profile(rdzv, device):
        for step in range(1, cfg.steps + 1):
            t0 = time.perf_counter()
            log_point = step % cfg.log_every == 0 or step == cfg.steps
            with tracer.step(step) as st:
                if step_sleep:
                    time.sleep(step_sleep)
                with st.phase("data_wait"):
                    batch = device_batch()
                chaos_nan_live = chaos_nan_live or nan_grad_armed() is not None
                if chaos_nan_live:
                    poison = consume_nan_grad(step)
                    batch["chaos_scale"] = torch.tensor(
                        0.0 if poison else 1.0, device=device)
                    if poison and lead:
                        print(json.dumps({"event": "chaos_nan_grad",
                                          "step": step}), flush=True)
                if step == 1:
                    # the first step: kernel builds and first-call setup
                    # dominate its wall, so it is its own `compile` phase,
                    # ended by a device sync (the block_until_ready of the
                    # JAX program); timed outside the tracer so the gauge
                    # and the event are real with tracing off too
                    c0 = time.perf_counter()
                    with st.phase("compile"):
                        state, metrics = step_fn(state, batch)
                        if device.type == "cuda":
                            torch.cuda.synchronize(device)
                    compile_s = time.perf_counter() - c0
                    CKPT_RESTORE_SECONDS.set(compile_s, {"phase": "compile"})
                    tracer.note_span("compile", compile_s, step=step)
                    if lead:
                        print(json.dumps({
                            "event": "compile_phase", "step": step,
                            "seconds": round(compile_s, 6),
                            "cache": bool(getattr(rdzv, "compile_cache_dir", "")),
                        }), flush=True)
                else:
                    with st.phase("step_compute"):
                        state, metrics = step_fn(state, batch)
                final_loss = metrics["loss"]
                if first_loss is None:
                    first_loss = final_loss
                if log_point:
                    with st.phase("host_sync"):
                        # the only per-step host sync, measured
                        loss_f = float(final_loss)
                        health_block = None
                        if health:
                            health_block = {
                                "loss": loss_f,
                                **{k: float(metrics[k]) for k in
                                   ("grad_norm", "nonfinite_grads",
                                    "update_ratio")},
                            }
                    logger.log(step, {"loss": loss_f})
                    if health_block is not None:
                        # heartbeat + flight-recorder ring on every host
                        tracer.note_health(step, health_block)
                        if lead:
                            print(json.dumps({
                                "event": "step_health", "step": step,
                                **{k: round(v, 6) for k, v in
                                   health_block.items()},
                            }), flush=True)
            if log_point and lead and tracer.enabled:
                # where this step's wall time went, next to the loss line
                last = tracer.last_step()
                ev = {"event": "step_phases", "step": step,
                      "wall_ms": round(1e3 * last.get("step_time_s", 0.0), 3),
                      "phases_ms": {
                          k: round(1e3 * v, 3)
                          for k, v in (last.get("phases_s") or {}).items()}}
                phases.append(ev)
                print(json.dumps(ev), flush=True)
            step_s.append(time.perf_counter() - t0)
    tracer.flush("done")
    if obs_server is not None:
        obs_server.stop()

    summary = {"config": lcfg, "step_s": step_s, "step_phases": phases,
               "compile_s": compile_s, "tracer": tracer, "state": state,
               "step_fn": step_fn, "next_batch": device_batch}
    req = float(extra.get("require_convergence", "0"))
    if first_loss is None:
        return summary
    first_loss, final_loss = float(first_loss), float(final_loss)
    ratio = final_loss / max(first_loss, 1e-9)
    summary.update(first_loss=first_loss, final_loss=final_loss, ratio=ratio)
    if lead:
        print(json.dumps({
            "event": "convergence", "first_loss": round(first_loss, 4),
            "final_loss": round(final_loss, 4), "ratio": round(ratio, 4),
        }), flush=True)
    if req and final_loss >= req * first_loss:
        raise SystemExit(
            f"convergence gate failed: final loss {final_loss:.4f} not "
            f"< {req} x first loss {first_loss:.4f}")
    return summary
