"""The program side of training-health telemetry (port of the
program-side parts of ``k8s_tpu/obs/health.py``): the ``nan-grad`` chaos
arm, the device-memory block of the obs heartbeat, and the on-demand
profiler capture behind ``GET /debug/profile?seconds=N``.

- Chaos: :func:`arm_nan_grad` in process, ``KTPU_CHAOS_NAN_GRAD="<step>"``
  for subprocess gangs; the training program consumes it per step
  (:func:`consume_nan_grad`) and poisons that step's gradients, making
  the divergence path drivable deterministically.
- :func:`device_memory_stats` / :func:`hbm_block` — the caching
  allocator's counters per CUDA device (``ktpu_obs_hbm_bytes_in_use`` /
  ``_peak`` / ``_limit``) plus the aggregate heartbeat block with the
  worst-device peak fraction the reconciler's MemoryPressure check
  reads. Empty / ``None`` on the CPU, as the JAX package's is.
- :func:`capture_profile` — one bounded ``torch.profiler`` session
  exported as a Chrome trace into the flight-recorder dir.
- :class:`HealthMonitor` — the operator side: the reconciler's pure
  decision logic over the ``step_health`` blocks of the heartbeats
  (divergence, loss spikes, plateaus), copied from the JAX package.

``torch`` is imported inside the functions that need it, so the chaos
arm and the monitor stay importable anywhere.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

# health-block keys the step emits / the heartbeat carries
HEALTH_KEYS = ("loss", "grad_norm", "nonfinite_grads", "update_ratio")


# -- chaos nan-grad hook (process-local arm) ------------------------------

_NAN_LOCK = threading.Lock()
# armed step: None = off, -1 = "the next consumed step", N = exactly N
_NAN_ARMED: Dict[str, Optional[int]] = {"step": None}


def arm_nan_grad(step: int = -1) -> None:
    """Poison the gradients of train step ``step`` of this process
    (-1 = the next step that polls) — the in-process arm of the
    ``nan-grad`` chaos fault. Subprocess gangs arm the same poison at
    spawn via ``KTPU_CHAOS_NAN_GRAD="<step>"``."""
    with _NAN_LOCK:
        _NAN_ARMED["step"] = int(step)


def nan_grad_armed(env=None) -> Optional[int]:
    """The armed poison step, from the process hook or the env
    contract (None when the fault is not armed at all — programs use
    this to decide whether the chaos-scale leaf rides the batch)."""
    with _NAN_LOCK:
        if _NAN_ARMED["step"] is not None:
            return _NAN_ARMED["step"]
    env = env if env is not None else os.environ
    spec = env.get("KTPU_CHAOS_NAN_GRAD", "")
    if spec:
        try:
            return int(spec)
        except ValueError:
            return None
    return None


def consume_nan_grad(step: int, env=None) -> bool:
    """True exactly once, at the armed step (or the first polled step
    for ``-1``): the caller must poison THIS step's gradients. The
    env arm clears process-locally so a poisoned run never re-fires."""
    armed = nan_grad_armed(env)
    if armed is None:
        return False
    if armed != -1 and armed != int(step):
        return False
    with _NAN_LOCK:
        _NAN_ARMED["step"] = None
    # the env stays set for the process lifetime — mask it so the next
    # poll sees the fault as spent (a restarted pod re-reads the real
    # env, which is exactly the once-per-pod-lifetime contract)
    if env is None and os.environ.get("KTPU_CHAOS_NAN_GRAD"):
        os.environ["KTPU_CHAOS_NAN_GRAD_FIRED"] = \
            os.environ.pop("KTPU_CHAOS_NAN_GRAD")
    return True


# -- pure health classification ------------------------------------------


def _finite(x) -> bool:
    try:
        return math.isfinite(float(x))
    except (TypeError, ValueError):
        return False


@dataclass
class HealthVerdict:
    """One observation's outcome. ``new_divergence`` fires exactly once
    per episode (the observation that tripped it); ``diverged`` holds
    while the episode lasts (until a restart's step regression resets
    it). ``new_warning``/``warning_cleared`` bracket a warning episode
    the same way."""

    observed_step: int = -1
    fresh: bool = False
    restarted: bool = False          # step regressed: a restart replayed
    new_divergence: bool = False
    diverged: bool = False
    first_bad_step: Optional[int] = None
    last_healthy_step: Optional[int] = None
    new_warning: Optional[str] = None   # "loss_spike" | "plateau"
    warning: Optional[str] = None       # active warning kind
    warning_cleared: Optional[str] = None
    reason: str = ""
    loss: Optional[float] = None


class HealthMonitor:
    def __init__(
        self,
        spike_factor: float = 3.0,
        spike_steps: int = 2,
        ema_alpha: float = 0.3,
        warmup_obs: int = 3,
        plateau_window: int = 0,
        plateau_rel: float = 1e-3,
        clear_after: int = 3,
        min_window_s: float = 0.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if spike_factor <= 1.0:
            raise ValueError("spike_factor must be > 1.0")
        self.spike_factor = float(spike_factor)
        self.spike_steps = max(1, int(spike_steps))
        self.ema_alpha = float(ema_alpha)
        self.warmup_obs = max(1, int(warmup_obs))
        self.plateau_window = max(0, int(plateau_window))
        self.plateau_rel = float(plateau_rel)
        self.clear_after = max(1, int(clear_after))
        self.min_window_s = float(min_window_s)
        self.clock = clock
        self._last_step = -1
        self._last_healthy: Optional[int] = None
        self._diverged = False
        self._first_bad: Optional[int] = None
        self._ema: Optional[float] = None
        self._healthy_obs = 0
        self._spike_streak = 0
        self._spike_started_at = 0.0
        self._warning: Optional[str] = None
        self._clear_streak = 0
        self._plateau: deque = deque(maxlen=max(1, self.plateau_window))

    def reset(self, floor_step: int) -> None:
        """Start a new episode after the CALLER acted on a verdict (the
        reconciler's divergence restart): clears the divergence/warning
        streaks and raises the fresh-observation floor to
        ``floor_step`` — the gang's progress at verdict time — so the
        torn-down gang's stale heartbeats (and the replay below the
        floor) can't re-trip on old evidence, while a RECURRING fault
        past the floor raises a new ``new_divergence`` (bounded by the
        caller's restart budget). Without this, a replay that resumes
        exactly at the old max step would never regress the step
        counter and a persistent fault would never re-raise.
        ``last_healthy_step`` survives — it is still the best-known
        restore ceiling."""
        self._diverged = False
        self._first_bad = None
        self._spike_streak = 0
        self._clear_streak = 0
        self._plateau.clear()
        self._last_step = max(self._last_step, int(floor_step))

    def observe(self, health: Dict) -> HealthVerdict:
        """Judge one health observation
        (``{"step", "loss", "grad_norm", "nonfinite_grads",
        "update_ratio"}`` — the ``step_health`` block). Observations
        with a non-advancing step are ignored (a reconciler re-polling
        an unchanged heartbeat must not inflate any streak)."""
        v = HealthVerdict(diverged=self._diverged,
                          first_bad_step=self._first_bad,
                          last_healthy_step=self._last_healthy,
                          warning=self._warning)
        try:
            step = int(health.get("step", -1))
        except (TypeError, ValueError):
            return v
        if step < 0:
            return v
        v.observed_step = step
        if step < self._last_step:
            # the gang restarted and replays from a restored step: the
            # old episode's evidence describes a state that no longer
            # exists — reset so the recovered run is judged afresh
            v.restarted = True
            self._diverged = False
            self._first_bad = None
            self._spike_streak = 0
            self._clear_streak = 0
            self._plateau.clear()
            self._last_step = step - 1
            v.diverged = False
            v.first_bad_step = None
        if step <= self._last_step:
            return v
        self._last_step = step
        v.fresh = True

        loss = health.get("loss")
        v.loss = float(loss) if _finite(loss) else None
        nonfinite = 0.0
        try:
            nf = float(health.get("nonfinite_grads", 0) or 0)
            nonfinite = nf if math.isfinite(nf) else 1.0
        except (TypeError, ValueError):
            nonfinite = 0.0
        bad = (
            nonfinite > 0
            or not _finite(loss)
            or not _finite(health.get("grad_norm", 0.0))
        )
        if bad:
            if not self._diverged:
                self._diverged = True
                self._first_bad = step
                v.new_divergence = True
                v.reason = (
                    f"non-finite numerics at step {step} "
                    f"(loss={health.get('loss')}, "
                    f"grad_norm={health.get('grad_norm')}, "
                    f"nonfinite_grads={nonfinite:g}); "
                    f"last healthy step: {self._last_healthy}"
                )
            v.diverged = True
            v.first_bad_step = self._first_bad
            return v

        # healthy observation
        self._last_healthy = step
        v.last_healthy_step = step
        if self._diverged:
            # NaN params cannot heal without a restore, so a healthy
            # observation while diverged means the evidence is mixed
            # (e.g. a host restarted without a step regression we saw)
            # — count toward clearing rather than trusting one sample
            self._clear_streak += 1
            if self._clear_streak >= self.clear_after:
                self._diverged = False
                self._first_bad = None
                self._clear_streak = 0
            v.diverged = self._diverged
            v.first_bad_step = self._first_bad
            return v

        lf = float(loss)
        self._healthy_obs += 1
        spiking = (
            self._ema is not None
            and self._healthy_obs > self.warmup_obs
            and lf >= self.spike_factor * self._ema
        )
        if spiking:
            if self._spike_streak == 0:
                self._spike_started_at = self.clock()
            self._spike_streak += 1
        else:
            self._spike_streak = 0
        # EMA freezes while spike evidence accumulates PRE-verdict
        # (updating it with the spiked samples would pull the baseline
        # up and kill the streak before the bar); once the warning is
        # raised it tracks again, so a sustained new loss level becomes
        # the baseline and the warning self-clears (hysteresis).
        if not (spiking and self._warning is None):
            self._ema = (lf if self._ema is None
                         else (1 - self.ema_alpha) * self._ema
                         + self.ema_alpha * lf)

        plateaued = False
        if self.plateau_window > 0 and not spiking:
            self._plateau.append(lf)
            if len(self._plateau) == self.plateau_window:
                first, last = self._plateau[0], self._plateau[-1]
                denom = max(abs(first), 1e-12)
                plateaued = (first - last) / denom < self.plateau_rel

        if (
            spiking
            and self._spike_streak >= self.spike_steps
            and self._warning != "loss_spike"
            and self.clock() - self._spike_started_at >= self.min_window_s
        ):
            self._warning = "loss_spike"
            self._clear_streak = 0
            v.new_warning = "loss_spike"
            v.reason = (
                f"loss {lf:.4g} >= {self.spike_factor:g}x EMA "
                f"{self._ema:.4g} for {self._spike_streak} consecutive "
                f"steps (step {step})"
            )
        elif plateaued and self._warning != "plateau":
            self._warning = "plateau"
            self._clear_streak = 0
            v.new_warning = "plateau"
            v.reason = (
                f"loss improvement under {self.plateau_rel:g} over the "
                f"last {self.plateau_window} observations (step {step})"
            )
        elif self._warning is not None and not spiking and not plateaued:
            self._clear_streak += 1
            if self._clear_streak >= self.clear_after:
                v.warning_cleared = self._warning
                self._warning = None
                self._clear_streak = 0
        v.warning = self._warning
        return v


# -- device memory (HBM) gauges ------------------------------------------


def device_memory_stats() -> List[Dict]:
    """Per-CUDA-device stats of this process's caching allocator:
    ``allocated_bytes.all.current`` as ``bytes_in_use``,
    ``allocated_bytes.all.peak`` as ``peak_bytes_in_use``, and the
    card's total memory as ``bytes_limit``.

    Only devices where the allocator has reserved memory are covered:
    this process holds a context there. The obs server calls this from
    its HTTP thread, and a CUDA call on a device without a context
    would create one (several hundred MB); the allocator's counters and
    the device properties need no CUDA call. Empty on the CPU (CUDA not
    initialized in this process) and on any error: memory telemetry is
    best-effort everywhere."""
    try:
        import torch

        if not torch.cuda.is_initialized():
            return []
        out: List[Dict] = []
        for d in range(torch.cuda.device_count()):
            ms = torch.cuda.memory_stats(d)
            if not ms.get("reserved_bytes.all.peak", 0):
                continue
            out.append({
                "device": d,
                "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
                "bytes_limit": int(torch.cuda.get_device_properties(d).total_memory),
            })
        return out
    except Exception:
        return []


def hbm_block(stats: Optional[List[Dict]] = None,
              export_gauges: bool = True,
              task: str = "") -> Optional[Dict]:
    """The heartbeat/healthz ``hbm`` block: per-device stats plus the
    aggregate the reconciler's MemoryPressure check reads (worst-device
    ``peak_fraction``). ``export_gauges`` also sets the process-global
    ``ktpu_obs_hbm_*`` series (one label set per device). Returns None
    when the backend reports nothing (CPU) — the block is simply absent
    from the heartbeat then."""
    stats = device_memory_stats() if stats is None else stats
    if not stats:
        return None
    if export_gauges:
        from k8s_tpu_torch.controller import metrics

        for s in stats:
            lbl = {"device": str(s["device"])}
            if task:
                lbl["task"] = task
            metrics.OBS_HBM_IN_USE.set(float(s["bytes_in_use"]), lbl)
            metrics.OBS_HBM_PEAK.set(float(s["peak_bytes_in_use"]), lbl)
            metrics.OBS_HBM_LIMIT.set(float(s["bytes_limit"]), lbl)
    peak_fraction = max(
        (s["peak_bytes_in_use"] / s["bytes_limit"]
         for s in stats if s["bytes_limit"] > 0),
        default=0.0,
    )
    return {
        "bytes_in_use": sum(s["bytes_in_use"] for s in stats),
        "peak_bytes_in_use": max(s["peak_bytes_in_use"] for s in stats),
        "bytes_limit": sum(s["bytes_limit"] for s in stats),
        "peak_fraction": round(peak_fraction, 4),
        "devices": stats,
    }


# -- on-demand profiling --------------------------------------------------

_PROFILE_LOCK = threading.Lock()
# Chrome-trace categories of device activity (CUPTI records)
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_event_counts(path: str) -> Dict[str, int]:
    """Events of a Chrome trace that torch.profiler exported, by
    category (``kernel``, ``cpu_op``, ...)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    counts: Dict[str, int] = {}
    for e in events:
        cat = e.get("cat")
        if cat:
            counts[cat] = counts.get(cat, 0) + 1
    return counts


def capture_profile(out_dir: str, seconds: float) -> Dict:
    """One bounded ``torch.profiler`` session, exported as a Chrome
    trace to ``<out_dir>/profile-<ms>/trace.json`` — the ``GET
    /debug/profile?seconds=N`` backend on the per-host obs server.
    Exactly one capture at a time per process (a concurrent request
    gets a busy error). Never raises.

    The session records CUDA activity when this process has initialized
    CUDA, CPU ops otherwise. It runs on the caller's thread (the obs
    server's): CUPTI's device activity is process-wide, so the training
    thread's kernels land in it, while CPU ops are recorded only for the
    thread that runs the session. A trace without a single device event
    (CPU ops on the CPU) is reported as ``ok: false``: a capture that
    recorded nothing is never claimed. The result is the JAX package's
    (``ok``, ``dir``, ``seconds``) plus ``trace`` and the ``events``
    count that decided ``ok``."""
    seconds = min(max(float(seconds), 0.1), 60.0)
    if not out_dir:
        return {"ok": False, "error": "no profile dir configured "
                                      "(set observability.flightRecorderDir)"}
    if not _PROFILE_LOCK.acquire(blocking=False):
        return {"ok": False, "error": "profile capture already in progress"}
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        path = os.path.join(out_dir, f"profile-{int(time.time() * 1e3)}")
        os.makedirs(path, exist_ok=True)
        on_card = torch.cuda.is_initialized()
        activity = ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU
        with profile(activities=[activity]) as prof:
            time.sleep(seconds)
        trace = os.path.join(path, "trace.json")
        prof.export_chrome_trace(trace)
        counts = trace_event_counts(trace)
        cats = DEVICE_EVENT_CATS if on_card else ("cpu_op",)
        events = sum(counts.get(c, 0) for c in cats)
        out = {"ok": events > 0, "dir": path, "seconds": seconds,
               "trace": trace, "events": events}
        if not events:
            out["error"] = (f"the trace holds no {'device' if on_card else 'CPU op'}"
                            " event")
        return out
    except Exception as e:
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}
    finally:
        _PROFILE_LOCK.release()
