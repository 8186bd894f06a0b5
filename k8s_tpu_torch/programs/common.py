"""Program scaffolding of the port: run-config parsing, the preemption
contract (the launcher's flags and :func:`maybe_preempt_exit`, the
checkpoint flush on SIGTERM), the one checkpoint-manager construction
path, the tracer and the per-host obs endpoint every training program
shares, the env-gated loop profiler, and the step-metrics logger (own
copies of ``k8s_tpu/programs/common.py``'s helpers, so the port imports
nothing of it)."""

from __future__ import annotations

import json
import os
import shlex
import time
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class RunConfig:
    steps: int = 100
    batch_size: int = 64
    accum_steps: int = 1
    log_every: int = 10
    checkpoint_dir: str = ""
    checkpoint_every: int = 0
    extra: Optional[Dict[str, str]] = None


def preempt_requested() -> bool:
    """True once the launcher's SIGTERM handler has fired (the
    ``KTPU_PREEMPT_REQUESTED`` contract). Poll between steps only."""
    return os.environ.get("KTPU_PREEMPT_REQUESTED") == "1"


def mark_preempt_aware() -> None:
    """Tell the launcher's SIGTERM handler this program will USE the
    grace period (flush or drain, then exit) instead of exiting
    immediately. Call once, before the loop, iff the program can."""
    os.environ["KTPU_PREEMPT_AWARE"] = "1"


def maybe_preempt_exit(mgr, rdzv, step: int, state, unhealthy=None) -> None:
    """The per-step preemption contract of every training program: on a
    gang-wide preemption verdict — ``mgr.reached_preemption(step)`` (an
    ``all_reduce(MAX)`` of the flag over the process group) when
    distributed, the launcher's SIGTERM flag in one process — flush a
    checkpoint of ``state`` (the flat tree) at the CURRENT step, print
    ``preempt_checkpoint``, dump the flight recorder and exit 143
    (retryable), so the gang restart resumes here instead of at the last
    periodic save. A no-op when ``mgr`` is None.

    ``unhealthy`` (optional callable, evaluated ONLY on a positive
    verdict — it syncs the device) gates the flush: a diverged gang
    being preempted must not write its NaN state as the newest
    checkpoint (``preempt_skip_unhealthy``); the exit still happens."""
    if mgr is None:
        return
    preempted = (mgr.reached_preemption(step)
                 if getattr(rdzv, "num_processes", 1) > 1
                 else preempt_requested())
    if not preempted:
        return
    if unhealthy is not None and unhealthy():
        print(json.dumps({"event": "preempt_skip_unhealthy",
                          "step": step}), flush=True)
        mgr.wait()
        mgr.close()
    else:
        mgr.save(step, state, force=True)
        mgr.wait()
        mgr.close()
        print(json.dumps({"event": "preempt_checkpoint", "step": step}),
              flush=True)
    # the flight recorder's final spans land next to the flushed step
    from k8s_tpu_torch.obs.trace import dump_default

    dump_default("preempt")
    raise SystemExit(143)


def parse_run_config(rdzv, defaults: Optional[dict] = None) -> RunConfig:
    """Program args come from ``rdzv.program_args`` (shell-ish
    ``--key=value`` tokens): known :class:`RunConfig` fields are set,
    everything else lands in ``extra``. ``KTPU_STEPS`` overrides steps;
    the operator's ``KTPU_CKPT_DIR`` / ``KTPU_CKPT_PERSIST_EVERY`` fill
    an unset checkpoint dir / interval."""
    cfg = RunConfig(**(defaults or {}))
    extra: Dict[str, str] = {}
    for tok in shlex.split(getattr(rdzv, "program_args", "") or ""):
        if not tok.startswith("--") or "=" not in tok:
            continue
        key, _, val = tok[2:].partition("=")
        key = key.replace("-", "_")
        if hasattr(cfg, key) and key != "extra":
            cur = getattr(cfg, key)
            setattr(cfg, key, type(cur)(val) if cur is not None else val)
        else:
            extra[key] = val
    cfg.extra = extra
    if os.environ.get("KTPU_STEPS"):
        cfg.steps = int(os.environ["KTPU_STEPS"])
    if not cfg.checkpoint_dir and os.environ.get("KTPU_CKPT_DIR"):
        cfg.checkpoint_dir = os.environ["KTPU_CKPT_DIR"]
        if not cfg.checkpoint_every:
            try:
                cfg.checkpoint_every = int(
                    os.environ.get("KTPU_CKPT_PERSIST_EVERY", "0") or 0)
            except ValueError:
                pass
    return cfg


def _gang_hooks(rdzv):
    """``(barrier, consensus)`` of a multi-process run, over the process
    group: ``barrier(step)`` meets the gang before a local commit (on a
    gloo group of its own, since the local tier's writer thread calls it
    beside the training thread's collectives), ``consensus(step)`` is
    the ``all_reduce(MIN)`` of the planned restore step. ``(None,
    None)`` in one process."""
    import torch.distributed as dist

    if getattr(rdzv, "num_processes", 1) <= 1 or not (
            dist.is_available() and dist.is_initialized()):
        return None, None
    from k8s_tpu_torch.train.checkpoint import gang_reduce

    group = dist.new_group(backend="gloo")

    def barrier(step: int) -> None:
        dist.barrier(group=group)

    return barrier, lambda step: gang_reduce(step, "min")


def build_checkpoint_manager(cfg: RunConfig, rdzv):
    """The one checkpoint-construction path every training program
    shares: a :class:`k8s_tpu_torch.ckpt.MultiTierCheckpointManager`
    when the job's checkpointPolicy enables the local tier
    (``KTPU_CKPT_LOCAL_DIR``), else the plain persistent manager on
    ``cfg.checkpoint_dir``, else None. Returns ``(mgr, server)``.

    Host identity is the process id; the control replica (process_id <
    0) never checkpoints. With ``KTPU_CKPT_PEER_PORT`` the host also
    serves its local tier on the REST shard wire (``server``, else
    None). ``KTPU_CKPT_RESTORE_MAX_STEP`` is the restore ceiling of both
    kinds. In a multi-process run the gang's local commits meet at a
    barrier and the restore step is agreed by an ``all_reduce(MIN)``;
    process 0 alone writes a replicated state to the persistent tier,
    and every rank its shards of a sharded one."""
    if getattr(rdzv, "process_id", 0) < 0:
        return None, None
    host_id = max(0, getattr(rdzv, "process_id", 0))
    import torch.distributed as dist

    # the persistent tier's group for a sharded state's collective DCP
    # save and load: gloo, of its own (it runs on the committer thread)
    dcp_group = (dist.new_group(backend="gloo")
                 if dist.is_available() and dist.is_initialized() else None)
    if os.environ.get("KTPU_CKPT_LOCAL_DIR"):
        from k8s_tpu_torch.ckpt import MultiTierCheckpointManager, PeerShardServer
        from k8s_tpu_torch.ckpt.manager import CheckpointPolicy

        policy = CheckpointPolicy.from_env()
        env_dir = os.environ.get("KTPU_CKPT_DIR", "")
        if cfg.checkpoint_dir and cfg.checkpoint_dir != env_dir:
            # an EXPLICIT --checkpoint_dir (it differs from the policy
            # env, so it is not parse_run_config's fallback) overrides
            # the spec's persistent tier — program args win
            policy.persistent_dir = cfg.checkpoint_dir
            policy.persistent_interval_steps = (
                cfg.checkpoint_every or policy.persistent_interval_steps)
        elif not policy.persistent_dir and cfg.checkpoint_dir:
            policy.persistent_dir = cfg.checkpoint_dir
            policy.persistent_interval_steps = cfg.checkpoint_every
        barrier, consensus = _gang_hooks(rdzv)
        mgr = MultiTierCheckpointManager(
            policy, host_id=host_id, barrier=barrier, consensus=consensus,
            gang_consistent=getattr(rdzv, "num_processes", 1) > 1,
            process_group=dcp_group,
        )
        server = None
        try:
            peer_port = int(os.environ.get("KTPU_CKPT_PEER_PORT", "0") or 0)
        except ValueError:
            peer_port = 0
        if peer_port and mgr.local is not None:
            server = PeerShardServer(mgr.local, port=peer_port).start()
            print(json.dumps({"event": "ckpt_peer_server",
                              "host": host_id, "port": server.port}),
                  flush=True)
        return mgr, server
    if cfg.checkpoint_dir:
        from k8s_tpu_torch.train.checkpoint import CheckpointManager

        try:
            max_restore = int(
                os.environ.get("KTPU_CKPT_RESTORE_MAX_STEP", "") or -1)
        except ValueError:
            max_restore = -1
        return CheckpointManager(
            cfg.checkpoint_dir,
            max_restore_step=max_restore if max_restore >= 0 else None,
            writer=host_id == 0, process_group=dcp_group,
        ), None
    return None, None


def build_tracer(rdzv):
    """The one tracer-construction path every training program shares:
    trace id + knobs from the operator env (KTPU_TRACE_*), host/task
    identity from the rendezvous, registered as the process default so
    the launcher's SIGTERM/crash paths can dump the flight recorder."""
    from k8s_tpu_torch.obs.trace import Tracer, set_default_tracer

    host = max(0, getattr(rdzv, "process_id", 0))
    tracer = Tracer.from_env(
        task=f"{getattr(rdzv, 'replica_type', 'worker')}-{host}",
        host=host,
    )
    set_default_tracer(tracer)
    return tracer


def start_obs_server(rdzv, tracer, extra_stats=None):
    """Per-host observability endpoint (spec.observability →
    ``KTPU_OBS_ADVERTISE`` = "<svc-dns>:<port>"; port 0 binds a free
    one): serves the step heartbeat + the device-memory ``hbm`` block
    (+ any ``extra_stats``) in the /healthz stats block, the
    process-global /metrics registry, the live flight recorder at
    /debug/flightrecorder, and on-demand profiling at
    ``/debug/profile?seconds=N`` (a torch.profiler session into the
    flight-recorder dir).

    Best-effort: an unbindable port degrades observability for this
    host, never the training job. Returns the server or None; the
    bound port is printed as the machine-readable ``obs_ready`` event."""
    advertise = os.environ.get("KTPU_OBS_ADVERTISE", "")
    if not advertise:
        return None
    port = 0
    if ":" in advertise:
        try:
            port = int(advertise.rsplit(":", 1)[1])
        except ValueError:
            port = 0

    def stats():
        out = {"obs": tracer.heartbeat()}
        try:
            from k8s_tpu_torch.obs.health import hbm_block

            hbm = hbm_block(task=tracer.task)
            if hbm is not None:
                # the reconciler's MemoryPressure check reads this off
                # the heartbeat; the CPU reports nothing and the block
                # is simply absent
                out["obs"]["hbm"] = hbm
        except Exception:
            pass  # memory telemetry must never break the heartbeat
        if extra_stats is not None:
            try:
                out.update(extra_stats() or {})
            except Exception:
                pass  # aux stats must never break the heartbeat
        return out

    profile_dir = (os.environ.get("KTPU_FLIGHT_DIR", "")
                   or os.environ.get("KTPU_PROFILE_DIR", ""))

    def profiler(seconds: float) -> dict:
        from k8s_tpu_torch.obs.health import capture_profile

        return capture_profile(profile_dir, seconds)

    from k8s_tpu_torch.controller.health import HealthServer

    host_id = max(0, getattr(rdzv, "process_id", 0))
    try:
        srv = HealthServer(
            port=port, host="0.0.0.0", stats_provider=stats,
            flight_recorder=tracer.recorder, profiler=profiler,
        ).start()
    except OSError as e:
        print(json.dumps({"event": "obs_error", "host": host_id,
                          "error": str(e)}), flush=True)
        return None
    # pushed heartbeats: when KTPU_OBS_PUSH_URL is set this host POSTs
    # its own stats block to the operator — best-effort, the pull path
    # stays as the fallback
    from k8s_tpu_torch.obs.push import maybe_start_pusher

    srv.heartbeat_pusher = maybe_start_pusher(stats)
    print(json.dumps({"event": "obs_ready", "host": host_id,
                      "port": srv.port}), flush=True)
    return srv


class maybe_profile:
    """A torch.profiler session around the hot loop when
    ``KTPU_PROFILE_DIR`` is set (process 0 only), exported as a Chrome
    trace to ``<dir>/loop-<ms>.json``; CUDA activity when the loop runs
    on the card, CPU ops otherwise. The primary profiling path is
    on-demand (``GET /debug/profile?seconds=N`` on every host's obs
    endpoint); this whole-loop capture is for bench-style runs."""

    def __init__(self, rdzv, device="cpu"):
        self.dir = os.environ.get("KTPU_PROFILE_DIR", "")
        self.active = bool(self.dir) and getattr(rdzv, "process_id", 0) <= 0
        self.device = device
        self._prof = None

    def __enter__(self):
        if self.active:
            import torch
            from torch.profiler import ProfilerActivity, profile

            on_card = torch.device(self.device).type == "cuda"
            self._prof = profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else []))
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            os.makedirs(self.dir, exist_ok=True)
            self._prof.export_chrome_trace(
                os.path.join(self.dir, f"loop-{int(time.time() * 1e3)}.json"))
            self._prof = None
        return False


class MetricLogger:
    """Step-metrics logger: JSON lines on process 0's stdout,
    ``{"run", "step", "steps_per_sec", <metrics>}``.

    When ``KTPU_TB_LOGDIR`` is set (the job's ``tensorboard.logDir``),
    scalars are ALSO written as TensorBoard event files under
    ``<logdir>/<run_name>`` by worker 0 — best-effort: without
    ``torch.utils.tensorboard`` the logger says so once and keeps to
    stdout."""

    def __init__(self, rdzv, run_name: str):
        self.enabled = rdzv.process_id <= 0
        self.run_name = run_name
        self._last_step = 0
        self._last_t = time.perf_counter()
        self._tb = None
        logdir = os.environ.get("KTPU_TB_LOGDIR", "")
        # exactly worker 0 writes TB (process_id == 0): the control
        # replica (-1) also logs to stdout, and two writers on one run
        # dir would interleave duplicate scalars
        if logdir and rdzv.process_id == 0:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(logdir, run_name))
            except Exception as e:  # TB writing is best-effort aux
                print(f"tensorboard writer unavailable: {e}", flush=True)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        if not self.enabled:
            return
        now = time.perf_counter()
        steps_per_sec = (step - self._last_step) / max(now - self._last_t, 1e-9)
        self._last_step, self._last_t = step, now
        print(json.dumps({
            "run": self.run_name, "step": step,
            "steps_per_sec": round(steps_per_sec, 3),
            **{k: round(float(v), 5) for k, v in metrics.items()},
        }), flush=True)
        if self._tb is not None:
            try:
                for k, v in metrics.items():
                    self._tb.add_scalar(k, float(v), step)
                self._tb.add_scalar("steps_per_sec", steps_per_sec, step)
                self._tb.flush()
            except Exception as e:
                # best-effort aux end to end: a full volume must never
                # kill the training loop
                print(f"tensorboard write failed, disabling: {e}", flush=True)
                self._tb = None
