"""Llama causal-LM training, one process per card, data parallel, FSDP
or FSDP with tensor parallelism (port of
``k8s_tpu/programs/llama_train.py``).

Run config (``KTPU_PROGRAM_ARGS``), the JAX program's keys:
  --strategy=fsdp|dp|fsdp_tp
                            (default fsdp, as in the JAX program) the
                            mesh and rules: ``dp`` a ``data`` axis over
                            every rank; ``fsdp`` an ``fsdp`` axis within
                            a slice and ``data`` across the
                            ``MEGASCALE_NUM_SLICES`` slices (HSDP);
                            ``fsdp_tp`` as ``fsdp`` with a ``tensor`` axis
                            of 4, 2 or 1 ranks cut from each slice (the
                            largest that divides it), Megatron-style
                            tensor parallelism inside it
  --zero_stage=0..3         the ZeRO ladder under dp (or the operator's
                            KTPU_ZERO_STAGE; --zero1=1 / KTPU_ZERO1 is
                            stage 1); a no-op under fsdp and fsdp_tp at
                            one slice, refused with several (ROADMAP
                            A5.4)
  --zero3_leaves=a,b        stage 3's selected parameters: names holding
                            any of these substrings (KTPU_ZERO3_LEAVES)
  --zero3_min_leaf_size=N   ... or of at least N elements
                            (KTPU_ZERO3_MIN_LEAF_SIZE)
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
  --batch_size=N            the global batch (default 16): each rank
                            trains on its rows of it, so the ranks'
                            count must divide it
  --steps=N                 (default 30)
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
  --checkpoint_dir=DIR      persistent tier (DCP) directory (or the
                            operator's KTPU_CKPT_DIR)
  --checkpoint_every=N      persistent save interval (plain persistent
                            manager; KTPU_CKPT_PERSIST_EVERY)
  --restore_crc=0|1         after a restore, read every leaf back from
                            the device and print its crc32
                            (``restore_crc``: the check that the state
                            is bit-equal to what was saved)

Checkpointing (the JAX program's): ``KTPU_CKPT_LOCAL_DIR`` and
``KTPU_CKPT_LOCAL_EVERY`` turn on the multi-tier manager (local tier
every N steps, ``KTPU_CKPT_LOCAL_KEEP`` kept, the persistent tier on
``KTPU_CKPT_DIR``/``--checkpoint_dir`` every ``KTPU_CKPT_PERSIST_EVERY``
steps and at the end; ``KTPU_CKPT_SAVE_BUFFER_BYTES``,
``KTPU_CKPT_RESTORE_*``, ``KTPU_CKPT_PEER_PORT``/``KTPU_CKPT_PEERS``);
a ``--checkpoint_dir`` alone the plain persistent manager. With either,
the state restores before the loop (``restored``), every step ends with
the preemption poll (SIGTERM → flush at the current step,
``preempt_checkpoint``, exit 143), the routed saves run inside the
``ckpt_save`` phase, and the end force-saves (``ckpt_goodput`` with the
multi-tier manager, whose goodput block also rides the obs heartbeat as
``ckpt``).

Weights are random from seed 0 (f32 masters, bf16 compute), the same
on every rank before the state is sharded. Options of later slices
raise ``NotImplementedError`` naming their ROADMAP item: the
``fsdp_tp_sp``, ``pp`` and ``pp_fsdp`` strategies, ZeRO on several
slices under ``fsdp``/``fsdp_tp``, ``--latency_hiding``,
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

Events (JSON lines): ``mesh`` (the axes, the DP degree and the ZeRO
stage), ``obs_ready`` (with an obs
endpoint), ``ckpt_restore`` and ``restored`` (after a restore),
``compile_phase``, the step/loss lines of
:class:`~k8s_tpu_torch.programs.common.MetricLogger`, ``step_health``
and ``step_phases`` at each log point, ``chaos_nan_grad`` at a poisoned
step, ``preempt_checkpoint`` on a preemption flush,
``ckpt_persistent_save`` (the persistent tier's last save seconds),
``ckpt_goodput`` and ``convergence`` at the end. :func:`main` returns a summary
(first and final loss, per-step wall times, the ``step_phases`` events,
the compile seconds, the tracer, and the state, step function and a
batch source for a caller that goes on measuring).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import time

import torch

from k8s_tpu_torch import resolve_device
from k8s_tpu_torch.controller.metrics import CKPT_RESTORE_SECONDS
from k8s_tpu_torch.data import learnable_token_batches, synthetic_token_batches
from k8s_tpu_torch.models import LlamaConfig, LlamaForCausalLM, init_params
from k8s_tpu_torch.obs.health import consume_nan_grad, nan_grad_armed
from k8s_tpu_torch.programs.common import (
    MetricLogger,
    build_checkpoint_manager,
    build_tracer,
    mark_preempt_aware,
    maybe_preempt_exit,
    maybe_profile,
    parse_run_config,
    start_obs_server,
)
from k8s_tpu_torch.parallel import (
    LogicalRules,
    MeshConfig,
    build_mesh,
    data_parallel_degree,
    mesh_shape,
)
from k8s_tpu_torch.programs.llama_generate import default_model
from k8s_tpu_torch.train import (
    create_sharded_state,
    cross_entropy_loss,
    init_optimizer_state,
    load_state_tree,
    make_batch_sharder,
    make_train_step,
    state_tree,
)

Z_LOSS = 1e-4

STRATEGIES = {"dp": "DP", "fsdp": "FSDP", "fsdp_tp": "FSDP_TP"}
# strategies of the JAX program this port does not have yet, with the
# ROADMAP item that brings each
_UNPORTED_STRATEGIES = {
    "fsdp_tp_sp": "A7 (sequence parallel)",
    "pp": "A8 (pipeline parallel)",
    "pp_fsdp": "A8 (pipeline parallel)",
}
# options of the JAX trainer this port does not have yet: (arg, env,
# values meaning "off", ROADMAP item)
_UNPORTED = (
    ("latency_hiding", "KTPU_LATENCY_HIDING", ("0", "false", ""),
     "A13 (XLA's latency-hiding scheduler has no counterpart yet)"),
    ("num_experts", None, ("0",), "A9 (the MoE model)"),
    ("quant", None, ("none", ""), "A10 (int8 training matmuls)"),
)


def _check_unported(extra, num_slices: int = 1, zero_stage: int = 0) -> str:
    """The strategy of the run config; raises for the options of later
    slices."""
    strategy = extra.get("strategy", "fsdp")
    if strategy in _UNPORTED_STRATEGIES:
        raise NotImplementedError(
            f"strategy={strategy!r} is not ported to k8s_tpu_torch yet "
            f"(ROADMAP {_UNPORTED_STRATEGIES[strategy]})")
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    for key, env, off, item in _UNPORTED:
        val = extra.get(key, os.environ.get(env, off[0]) if env else off[0])
        if val not in off:
            raise NotImplementedError(
                f"{key}={val!r} is not ported to k8s_tpu_torch yet "
                f"(ROADMAP {item})")
    if strategy != "dp" and zero_stage >= 1 and num_slices > 1:
        raise NotImplementedError(
            f"zero_stage={zero_stage} with {num_slices} slices under "
            f"strategy={strategy!r} (ZeRO on an HSDP mesh) is not ported to "
            "k8s_tpu_torch yet (ROADMAP A5.4)")
    return strategy


def mesh_config_for(strategy: str, n: int, num_slices: int) -> MeshConfig:
    """The JAX program's mesh over ``n`` ranks in ``num_slices`` slices:
    ``dp`` one ``data`` axis over every rank; ``fsdp`` ``data`` across
    slices and ``fsdp`` within one; ``fsdp_tp`` as ``fsdp`` with a
    ``tensor`` axis of 4 ranks when a slice's count divides by 4, else
    2, else 1."""
    if strategy == "dp":
        return MeshConfig(data=n)
    per_slice = max(1, n // num_slices)
    if strategy == "fsdp":
        return MeshConfig(data=num_slices, fsdp=per_slice)
    if strategy == "fsdp_tp":
        tensor = 4 if per_slice % 4 == 0 else (2 if per_slice % 2 == 0 else 1)
        return MeshConfig(data=num_slices, fsdp=per_slice // tensor,
                          tensor=tensor)
    raise ValueError(f"unknown strategy {strategy!r}")


def _mesh_for(strategy: str, num_slices: int, device_type: str):
    """The mesh of :func:`mesh_config_for` over the world's ranks."""
    import torch.distributed as dist

    from k8s_tpu_torch.parallel.mesh import ensure_process_group

    ensure_process_group(device_type)
    return build_mesh(mesh_config_for(strategy, dist.get_world_size(),
                                      num_slices), device_type)


def _rdzv_flag(rdzv, attr: str, env: str) -> bool:
    """A trainer-mode flag from the launcher contract: the Rendezvous
    already parsed the operator-injected env; bare rdzv stubs (tests)
    fall back to reading the env var."""
    val = getattr(rdzv, attr, None)
    if val is not None:
        return bool(val)
    return os.environ.get(env, "0") in ("1", "true")


def _rdzv_int(rdzv, attr: str, env: str, default: int = 0) -> int:
    """Integer twin of :func:`_rdzv_flag`."""
    val = getattr(rdzv, attr, None)
    if val is not None:
        try:
            return int(val)
        except (TypeError, ValueError):
            return default
    try:
        return int(os.environ.get(env, str(default)))
    except ValueError:
        return default


def zero_options(rdzv, extra: dict):
    """``(zero_stage, zero3_leaves, zero3_min_leaf_size)`` from the flags,
    else the rendezvous (the operator's env), as the JAX program takes
    them."""
    zero1 = extra.get(
        "zero1", "1" if _rdzv_flag(rdzv, "zero1", "KTPU_ZERO1") else "0",
    ) in ("1", "true")
    zero_stage = int(extra.get(
        "zero_stage",
        _rdzv_int(rdzv, "zero_stage", "KTPU_ZERO_STAGE", 1 if zero1 else 0)))
    if zero1 and zero_stage == 0:
        zero_stage = 1
    if not 0 <= zero_stage <= 3:
        raise ValueError(f"zero_stage must be 0..3, got {zero_stage}")
    min_leaf = int(extra.get(
        "zero3_min_leaf_size",
        _rdzv_int(rdzv, "zero3_min_leaf_size", "KTPU_ZERO3_MIN_LEAF_SIZE")))
    default = getattr(rdzv, "zero3_leaves", None)
    if default is None:
        default = os.environ.get("KTPU_ZERO3_LEAVES", "")
    if not isinstance(default, str):
        default = ",".join(default)
    leaves = [x for x in str(extra.get("zero3_leaves", default)).split(",") if x]
    return zero_stage, leaves, min_leaf


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


def _unhealthy_state(health_enabled: bool, metrics) -> bool:
    """True when the LAST step's health block says the state is
    poisoned (non-finite gradients or loss) — the checkpoint-save gate.
    Reads two device scalars, so callers ask only on steps that would
    write. False without the health block."""
    if not health_enabled or not metrics:
        return False
    return (float(metrics["nonfinite_grads"]) > 0
            or not math.isfinite(float(metrics["loss"])))


def _restore_crc(tree) -> dict:
    """crc32 of this rank's shard of every leaf of ``tree`` as read back
    from its device, in the local tier's byte vocabulary (the manifest's
    crc of the same shard when the state is bit-equal to the
    checkpoint)."""
    from k8s_tpu_torch.ckpt.local import _leaf_paths
    from k8s_tpu_torch.ckpt.pipeline import crc32_array, to_numpy

    return {path: crc32_array(to_numpy(
                (t.to_local() if hasattr(t, "to_local") else t).detach().cpu()))
            for path, t in _leaf_paths(tree)}


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
    S]: the fused LM-head loss inside the model's forward (the [B, S, V]
    logits never exist, and ``lm_head`` is read where FSDP2 holds it
    whole), or the unfused loss over f32 logits."""
    if fused_ce:
        return model(ids, labels=ids[:, 1:], z_loss=Z_LOSS)
    logits = model(ids)
    labels = torch.roll(ids, -1, dims=1)
    return cross_entropy_loss(logits[:, :-1], labels[:, :-1], z_loss=Z_LOSS)


def kernel_launches() -> dict:
    """The flash kernels' launch counters (K1-K3): each wrapper ticks
    only where it launches its kernel on the card, so a CPU run counts
    none."""
    from k8s_tpu_torch.ops import attention as attn

    return {"flash_fwd": attn.flash_fwd.launches,
            "flash_bwd_dq": attn.flash_bwd.launches_dq,
            "flash_bwd_dkv": attn.flash_bwd.launches_dkv}


def main(rdzv) -> dict:
    cfg = parse_run_config(rdzv, {"steps": 30, "batch_size": 16})
    extra = cfg.extra or {}
    num_slices = max(1, int(getattr(rdzv, "num_slices", 1) or 1))
    zero_stage, zero3_leaves, zero3_min_leaf_size = zero_options(rdzv, extra)
    strategy = _check_unported(extra, num_slices, zero_stage)
    device = resolve_device(extra.get("device", getattr(rdzv, "device", "cuda")))
    model_name = extra.get("model", default_model(device))
    seq_len = int(extra.get("seq_len", "128" if model_name == "tiny" else "8192"))
    lead = getattr(rdzv, "process_id", 0) <= 0
    launches0 = kernel_launches()
    m0 = time.perf_counter()
    mesh = _mesh_for(strategy, num_slices, device.type)
    mesh_s = time.perf_counter() - m0
    if lead:
        # the JAX program's event: the mesh the env shaped
        print(json.dumps({"event": "mesh", "num_slices": num_slices,
                          "dp": data_parallel_degree(mesh),
                          "shape": mesh_shape(mesh),
                          "zero1": zero_stage >= 1,
                          "zero_stage": zero_stage}), flush=True)
    lcfg = model_config(model_name, extra)
    lr = float(extra.get("lr", "3e-4"))
    model = LlamaForCausalLM(lcfg, device=device)
    model.load_params(init_params(lcfg, 0, device, dtype=torch.float32))
    state = create_sharded_state(
        model, lr, mesh, LogicalRules(getattr(LogicalRules, STRATEGIES[strategy])),
        zero_stage=zero_stage, zero3_min_leaf_size=zero3_min_leaf_size,
        zero3_leaves=zero3_leaves)
    data_fn = (learnable_token_batches if extra.get("data") == "learnable"
               else synthetic_token_batches)
    # every rank draws the same global batch and trains on its rows
    data = data_fn(cfg.batch_size, seq_len, lcfg.vocab_size)
    shard_batch = make_batch_sharder(mesh)
    fused_ce = extra.get("fused_ce", "1") not in ("0", "false")
    # multi-tier when the job's checkpointPolicy enables the local tier
    # (KTPU_CKPT_LOCAL_DIR), plain persistent otherwise, or None
    mgr, peer_server = build_checkpoint_manager(cfg, rdzv)
    multi_tier = hasattr(mgr, "note_step")
    # tracing + per-host obs endpoint: the tracer wraps every step in
    # phase spans (flight recorder + the heartbeat the reconciler's
    # straggler detection reads); the obs server publishes them, with
    # the checkpoint goodput block riding along under the multi-tier
    # manager
    tracer = build_tracer(rdzv)
    obs_server = start_obs_server(
        rdzv, tracer,
        extra_stats=(lambda: {"ckpt": mgr.goodput()}) if multi_tier
        else None)
    restore_crc = None
    if mgr is not None:
        # the template: AdamW's moments exist only after a step, so
        # they are created (zeros) before a restore can fill them
        init_optimizer_state(state)
        restored = mgr.restore(state_tree(state))
        if restored is not None:
            load_state_tree(state, restored)
            if extra.get("restore_crc", "0") not in ("0", "false"):
                c0 = time.perf_counter()
                crcs = _restore_crc(restored)
                restore_crc = {"event": "restore_crc", "step": state.step,
                               "crc": crcs,
                               "seconds": round(time.perf_counter() - c0, 6)}
                if lead:
                    print(json.dumps(restore_crc), flush=True)
            if lead:
                # the resume marker (the multi-tier manager printed
                # ckpt_restore with its source tier and lost steps)
                print(json.dumps({"event": "restored", "step": state.step}),
                      flush=True)
    # the in-step health block rides the trace gate, as in the JAX
    # program: spec observability.trace=false turns both off
    health = tracer.enabled and extra.get("health", "1") not in ("0", "false")

    def loss_fn(state, b):
        return _chaos_scaled(lm_loss(state.model, b["input_ids"], fused_ce), b), {}

    step_fn = make_train_step(loss_fn, accum_steps=cfg.accum_steps,
                              health=health)
    logger = MetricLogger(rdzv, f"llama-{model_name}-{strategy}")
    step_sleep = float(extra.get("step_sleep", "0"))

    def device_batch():
        return {k: torch.from_numpy(v).to(device)
                for k, v in shard_batch(next(data)).items()}

    # preemption contract: with checkpointing on, every step ends with
    # the gang-wide poll; on a positive the state is flushed at the
    # CURRENT step and the program exits 143 (maybe_preempt_exit)
    if mgr is not None:
        mark_preempt_aware()
    start = state.step
    # chaos nan-grad (KTPU_CHAOS_NAN_GRAD="<step>" or arm_nan_grad): the
    # poison fires only on a FROM-SCRATCH run (a gang restarted from a
    # pre-divergence checkpoint replays the poisoned step clean); once
    # armed, a chaos_scale scalar rides every step's batch, NaN only at
    # the armed step
    chaos_nan_live = start == 0 and nan_grad_armed() is not None
    # losses stay device tensors in the loop: the host syncs only at log
    # points (and per step when --log_every=1)
    first_loss = final_loss = None
    metrics = None  # the last step's (None until a step ran)
    step_s, phases, compile_s = [], [], None
    losses = []  # (step, loss) at the log points

    def unhealthy_now() -> bool:
        # the never-checkpoint-a-poisoned-state gate: the LAST step's
        # health block, read only where a write would happen
        return _unhealthy_state(health, metrics)

    with maybe_profile(rdzv, device):
        for step in range(start + 1, cfg.steps + 1):
            t0 = time.perf_counter()
            log_point = step % cfg.log_every == 0 or step == cfg.steps
            with tracer.step(step) as st:
                if step_sleep:
                    time.sleep(step_sleep)
                with st.phase("data_wait"):
                    batch = device_batch()
                chaos_nan_live = chaos_nan_live or (
                    start == 0 and nan_grad_armed() is not None)
                if chaos_nan_live:
                    poison = consume_nan_grad(step)
                    batch["chaos_scale"] = torch.tensor(
                        0.0 if poison else 1.0, device=device)
                    if poison and lead:
                        print(json.dumps({"event": "chaos_nan_grad",
                                          "step": step}), flush=True)
                if step == start + 1:
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
                    losses.append((step, loss_f))
                    if health_block is not None:
                        # heartbeat + flight-recorder ring on every host
                        tracer.note_health(step, health_block)
                        if lead:
                            print(json.dumps({
                                "event": "step_health", "step": step,
                                **{k: round(v, 6) for k, v in
                                   health_block.items()},
                            }), flush=True)
                if mgr is not None:
                    tree = state_tree(state)
                    maybe_preempt_exit(mgr, rdzv, step, tree,
                                       unhealthy=unhealthy_now)
                    if multi_tier:
                        # the manager routes (local every
                        # localIntervalSteps, persistent every
                        # persistentIntervalSteps) and owns the
                        # unhealthy gate; ckpt_save times only the
                        # step-critical slice, the device→host
                        # snapshot (serialize/commit run behind it)
                        with st.phase("ckpt_save"):
                            mgr.save(step, tree, unhealthy=unhealthy_now)
                        mgr.note_step(step)
                    elif cfg.checkpoint_every and \
                            step % cfg.checkpoint_every == 0:
                        with st.phase("ckpt_save"):
                            mgr.save(step, tree, unhealthy=unhealthy_now)
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
    if lead:
        # the pod log's proof that the steps ran the card's kernels (the
        # operator phase of chip_smoke.py reads it); on stderr, so that
        # stdout keeps the JAX program's event schema
        print("llama_train: kernel launches " + json.dumps(
            {"steps": len(step_s),
             **{k: v - launches0[k] for k, v in kernel_launches().items()}}),
            file=sys.stderr, flush=True)
    goodput = None
    if mgr is not None:
        # the final force save rides the same gate: a diverged run must
        # not overwrite the tiers with NaN state as its parting act
        mgr.save(cfg.steps, state_tree(state), force=True,
                 unhealthy=unhealthy_now)
        mgr.wait()
        persistent = mgr.persistent if multi_tier else mgr
        if lead and persistent is not None \
                and persistent.last_save_s is not None:
            # the persistent tier's last write (the final one here)
            print(json.dumps({"event": "ckpt_persistent_save",
                              "step": max(persistent.all_steps()),
                              "seconds": round(persistent.last_save_s, 6)}),
                  flush=True)
        if multi_tier:
            goodput = mgr.goodput()
            if lead:
                print(json.dumps({"event": "ckpt_goodput", **goodput}),
                      flush=True)
        mgr.close()
    if peer_server is not None:
        peer_server.stop()
    tracer.flush("done")
    if obs_server is not None:
        obs_server.stop()

    summary = {"config": lcfg, "mesh": mesh, "mesh_s": mesh_s, "losses": losses,
               "step_s": step_s, "step_phases": phases,
               "compile_s": compile_s, "tracer": tracer, "state": state,
               "step_fn": step_fn, "next_batch": device_batch,
               "restored_step": start if mgr is not None and start else None,
               "restore_crc": restore_crc, "ckpt_goodput": goodput}
    req = float(extra.get("require_convergence", "0"))
    if first_loss is None:
        return summary
    first_loss, final_loss = float(first_loss), float(final_loss)
    ratio = final_loss / max(first_loss, 1e-9)
    summary.update(first_loss=first_loss, final_loss=final_loss, ratio=ratio)
    # the gate judges only runs that trained FROM SCRATCH: after a
    # restore the first loss is the resume point's, already trained
    gated = req and start == 0
    if lead:
        print(json.dumps({
            "event": "convergence", "first_loss": round(first_loss, 4),
            "final_loss": round(final_loss, 4), "ratio": round(ratio, 4),
            **({"gate": "skipped_restored"} if req and not gated else {}),
        }), flush=True)
    if gated and final_loss >= req * first_loss:
        raise SystemExit(
            f"convergence gate failed: final loss {final_loss:.4f} not "
            f"< {req} x first loss {first_loss:.4f}")
    return summary
