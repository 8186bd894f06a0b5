"""Spans, trace ids, and the per-process flight recorder (the port's
copy of ``k8s_tpu/obs/trace.py``, pure stdlib, same contract).

The reconciler reads what this module writes, so the dump's schema, its
file name ``flight-host<N>.json``, the atomic tmp + fsync + rename and
the env knobs (``KTPU_TRACE``, ``KTPU_TRACE_ID``, ``KTPU_FLIGHT_DIR``,
``KTPU_FLIGHT_CAPACITY``, ``KTPU_CHAOS_SLOW_HOST``) are the JAX
package's, unchanged:

- **Trace id** — the operator stamps every job with one
  (``KTPU_TRACE_ID``); every span, heartbeat and flight record carries
  it.
- **Step phases** — :meth:`Tracer.step` wraps one train step; the
  phases inside it (``data_wait`` / ``compile`` / ``step_compute`` /
  ``host_sync``) are timed with two ``perf_counter`` calls each. The
  tracer accounts its own bookkeeping time in :attr:`Tracer.overhead_s`.
- **Flight recorder** — a bounded ring of the most recent step/span
  records, re-dumped atomically to node-local disk on a small interval
  and force-dumped on SIGTERM / crash (the port's ``spmd_launcher``).
  A SIGKILLed process still leaves its last interval's spans on disk.
  Served live at ``GET /debug/flightrecorder`` on the per-host obs
  endpoint (``k8s_tpu_torch/controller/health.py``).
- **Chaos hook** — ``slow-host``: :func:`arm_slow_host` (in process) or
  ``KTPU_CHAOS_SLOW_HOST="<host>:<seconds>[:<steps>]"`` throttles the
  matching host's steps inside the step span, making one gang member
  measurably slow.

When disabled (``KTPU_TRACE=0``) every surface degrades to branch-only
no-ops so the hot loop pays nothing.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

# Phases that are GANG-COUPLED: in synchronized SPMD training a slow
# peer inflates every host's step wall time through the collectives,
# and depending on the backend's dispatch model that wait surfaces
# either inside the jitted step's dispatch (sync-executing backends)
# or at the host-sync readback (async dispatch) — so neither phase can
# attribute slowness to THIS host. Straggler attribution therefore
# judges busy_s = wall - gang phases: the host's OWN work (input
# waits, checkpoint saves, host-side processing, injected throttles),
# which is exactly the straggler class host-side telemetry can see.
# (Device-compute slowness is indistinguishable from a host's
# perspective — every peer's collective stretches identically; that
# diagnosis needs device profiles, out of this layer's scope.)
# `compile` (the first step of an incarnation: trace + XLA compile +
# the step) is excluded too: it is one-shot bring-up, not steady-state
# slowness — and with a node-local compile cache a replaced pod
# compiles COLD next to warm-cache survivors, which busy attribution
# would misread as a straggler on its very first heartbeat.
GANG_PHASES = ("step_compute", "host_sync", "compile")

# -- chaos slow-host hook (process-local arm) ----------------------------

_SLOW_LOCK = threading.Lock()
_SLOW_ARMED = {"seconds": 0.0, "steps": 0}


def arm_slow_host(seconds: float, steps: int = 1 << 30) -> None:
    """Throttle the NEXT ``steps`` traced train steps of this process
    by ``seconds`` each — the in-process arm of the ``slow-host`` chaos
    fault (subprocess gangs arm the same throttle per-host via the
    ``KTPU_CHAOS_SLOW_HOST`` env at spawn)."""
    with _SLOW_LOCK:
        _SLOW_ARMED["seconds"] = float(seconds)
        _SLOW_ARMED["steps"] = int(steps)


def _consume_slow_throttle(tracer: "Tracer") -> float:
    """Seconds to sleep for THIS step: env-armed (per-host) plus
    process-armed (chaos matrix), each with its own step budget."""
    total = 0.0
    if tracer._env_slow_steps > 0:
        tracer._env_slow_steps -= 1
        total += tracer._env_slow_seconds
    with _SLOW_LOCK:
        if _SLOW_ARMED["steps"] > 0:
            _SLOW_ARMED["steps"] -= 1
            total += _SLOW_ARMED["seconds"]
    return total


# -- flight recorder -----------------------------------------------------


class FlightRecorder:
    """Bounded ring of recent telemetry records with atomic disk dumps.

    ``dump_path`` empty keeps the ring memory-only (the healthz route
    still serves it). With a path, :meth:`maybe_flush` re-dumps at most
    every ``flush_interval_s`` — cheap enough to call per step, frequent
    enough that a SIGKILL loses at most one interval of spans."""

    def __init__(self, capacity: int = 256, dump_path: str = "",
                 flush_interval_s: float = 0.5):
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        # RLocks: the launcher's SIGTERM handler dumps the recorder ON
        # THE MAIN THREAD between bytecodes — a plain Lock held by the
        # interrupted frame (a record() or an in-flight dump()) would
        # deadlock the handler forever and the pod would hang until the
        # kubelet's SIGKILL instead of exiting in the grace period
        self._lock = threading.RLock()
        self._dump_lock = threading.RLock()
        self.dump_path = dump_path
        self.flush_interval_s = float(flush_interval_s)
        self._last_flush = 0.0
        self.dumps = 0
        self.dump_failures = 0
        self._dump_seq = 0
        self._dump_warned = False

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    def record(self, entry: dict) -> None:
        with self._lock:
            self._ring.append(entry)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def maybe_flush(self) -> None:
        if not self.dump_path:
            return
        now = time.monotonic()
        if now - self._last_flush >= self.flush_interval_s:
            self.dump("interval")

    def dump(self, reason: str = "") -> Optional[str]:
        """Atomically (per-dump tmp + fsync + rename) rewrite the dump
        file with the current ring — a reader never sees a torn file,
        and the newest complete dump survives a crash mid-write.

        Best-effort END TO END: a full/read-only node disk degrades
        the post-mortem, never the training step that flushed it
        (returns None and logs once). The tmp name is unique per dump
        so a signal-handler dump interleaving an in-flight interval
        dump on the same thread writes its own file — the older frame
        can at worst replace the final file with a marginally staler
        snapshot, never a torn one."""
        if not self.dump_path:
            return None
        try:
            payload = {
                "reason": reason,
                "dumped_at": time.time(),
                "entries": self.snapshot(),
            }
            with self._dump_lock:
                self._dump_seq += 1
                tmp = f"{self.dump_path}.tmp{os.getpid()}-{self._dump_seq}"
            d = os.path.dirname(self.dump_path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(payload, f, default=str)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.dump_path)
        except Exception as e:
            self.dump_failures += 1
            # rate the clock anyway: retrying a dead disk every step
            # would turn telemetry into a per-step syscall storm
            self._last_flush = time.monotonic()
            if not self._dump_warned:
                self._dump_warned = True
                import logging

                logging.getLogger(__name__).warning(
                    "flight-recorder dump to %s failed (%s: %s); "
                    "post-mortem degraded, training unaffected",
                    self.dump_path, type(e).__name__, e)
            return None
        self._last_flush = time.monotonic()
        self.dumps += 1
        return self.dump_path


# -- step/phase spans ----------------------------------------------------


class _Phase:
    """One timed phase inside a step: two perf_counter calls total."""

    __slots__ = ("_st", "_name", "_t0")

    def __init__(self, st: "StepTrace", name: str):
        self._st = st
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        ph = self._st.phases
        ph[self._name] = ph.get(self._name, 0.0) + dt
        return False


class _NullPhase:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_PHASE = _NullPhase()


class _NullStep:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def phase(self, name: str):
        return _NULL_PHASE


_NULL_STEP = _NullStep()


class StepTrace:
    """Context manager for one train step: wall time + phase breakdown.
    On exit it applies any armed slow-host throttle (chaos), records a
    step entry into the flight recorder, refreshes the tracer's
    heartbeat, and accounts its own bookkeeping time into
    ``tracer.overhead_s``."""

    __slots__ = ("tracer", "step", "phases", "_t0")

    def __init__(self, tracer: "Tracer", step: int):
        self.tracer = tracer
        self.step = int(step)
        self.phases: Dict[str, float] = {}

    def phase(self, name: str) -> _Phase:
        return _Phase(self, name)

    def __enter__(self) -> "StepTrace":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        throttle = _consume_slow_throttle(self.tracer)
        if throttle > 0:
            # the throttle lives INSIDE the step window so the skew is
            # what the gang heartbeats actually observe
            time.sleep(throttle)
            self.phases["chaos_slow_host"] = throttle
        b0 = time.perf_counter()
        wall = b0 - self._t0
        self.tracer._finish_step(self.step, wall, self.phases)
        if exc_type is not None:
            # the step is dying (preempt SystemExit, crash): force the
            # CURRENT step's span into the on-disk dump — the interval
            # flush may not have fired yet and there is no next step
            try:
                self.tracer.recorder.dump(f"step-{exc_type.__name__}")
            except Exception:
                pass
        self.tracer.overhead_s += time.perf_counter() - b0
        return False


class Tracer:
    """Per-process tracing front door. Construct directly (tests,
    benches) or via :meth:`from_env` (the operator contract:
    ``KTPU_TRACE_ID`` / ``KTPU_TRACE`` / ``KTPU_FLIGHT_DIR`` /
    ``KTPU_FLIGHT_CAPACITY`` / ``KTPU_CHAOS_SLOW_HOST``)."""

    def __init__(self, trace_id: str = "", task: str = "", host: int = 0,
                 enabled: bool = True,
                 recorder: Optional[FlightRecorder] = None):
        self.trace_id = trace_id
        self.task = task
        self.host = int(host)
        self.enabled = bool(enabled)
        self.recorder = recorder if recorder is not None else FlightRecorder()
        self.overhead_s = 0.0
        self._hb_lock = threading.Lock()
        self._hb = {"step": 0, "step_time_s": 0.0, "phases_s": {}}
        # latest step_health block (note_health) — kept OUTSIDE _hb:
        # _finish_step rebuilds the heartbeat every step, while health
        # only refreshes at log points, and must survive in between
        self._hb_health: Optional[Dict] = None
        self._hb_at = 0.0  # monotonic of last heartbeat refresh
        self._env_slow_seconds = 0.0
        self._env_slow_steps = 0

    @classmethod
    def from_env(cls, env=None, task: str = "", host: int = 0) -> "Tracer":
        env = env if env is not None else os.environ
        enabled = env.get("KTPU_TRACE", "1") not in ("0", "false")
        try:
            cap = int(env.get("KTPU_FLIGHT_CAPACITY", "256") or 256)
        except ValueError:
            cap = 256
        dump_dir = env.get("KTPU_FLIGHT_DIR", "")
        dump_path = (
            os.path.join(dump_dir, f"flight-host{int(host)}.json")
            if dump_dir else "")
        t = cls(
            trace_id=env.get("KTPU_TRACE_ID", ""),
            task=task, host=host, enabled=enabled,
            recorder=FlightRecorder(capacity=cap, dump_path=dump_path),
        )
        # KTPU_CHAOS_SLOW_HOST="<host>:<seconds>[:<steps>]" — the
        # subprocess arm of the slow-host chaos fault: only the named
        # host throttles, everyone else parses and ignores it
        spec = env.get("KTPU_CHAOS_SLOW_HOST", "")
        if spec:
            parts = spec.split(":")
            try:
                if int(parts[0]) == int(host):
                    t._env_slow_seconds = float(parts[1])
                    t._env_slow_steps = (
                        int(parts[2]) if len(parts) > 2 else 1 << 30)
            except (ValueError, IndexError):
                pass
        return t

    # -- recording --------------------------------------------------------

    def step(self, step: int):
        """``with tracer.step(n) as st: ... st.phase("data_wait") ...``"""
        if not self.enabled:
            return _NULL_STEP
        return StepTrace(self, step)

    def event(self, name: str, **attrs) -> None:
        """Record a point event (restart, restore, drain, ...) into the
        flight recorder ring."""
        if not self.enabled:
            return
        self.recorder.record({
            "kind": "event", "name": name, "t": time.time(),
            "trace_id": self.trace_id, "task": self.task, **attrs,
        })

    def span(self, name: str, **attrs):
        """Standalone timed span (outside the step loop): restore,
        compile, drain."""
        if not self.enabled:
            return _NULL_PHASE
        return _SpanCtx(self, name, attrs)

    def note_span(self, name: str, wall_s: float, **attrs) -> None:
        """Record an externally-timed span — phases a subsystem measures
        itself (the checkpoint manager's restore_plan/fetch/device and
        save_snapshot/serialize/commit breakdowns, the program's
        first-step compile) and reports after the fact — possibly from
        a background thread (the save writer/committer call in here;
        the recorder is lock-protected). Same record shape as
        :meth:`span`, so the flight recorder and /debug/flightrecorder
        render both identically."""
        if not self.enabled:
            return
        self._record_span(name, float(wall_s), attrs)

    def _finish_step(self, step: int, wall_s: float,
                     phases: Dict[str, float]) -> None:
        phases_r = {k: round(v, 6) for k, v in phases.items()}
        busy = max(0.0, wall_s - sum(
            phases.get(p, 0.0) for p in GANG_PHASES))
        self.recorder.record({
            "kind": "step", "step": step, "t": time.time(),
            "trace_id": self.trace_id, "task": self.task,
            "wall_s": round(wall_s, 6), "phases_s": phases_r,
        })
        with self._hb_lock:
            self._hb = {"step": step, "step_time_s": round(wall_s, 6),
                        "busy_s": round(busy, 6), "phases_s": phases_r}
            self._hb_at = time.monotonic()
        self.recorder.maybe_flush()

    def note_health(self, step: int, health: Dict) -> None:
        """Attach a step's numerics-health block (loss, grad norm,
        nonfinite-grad count, update ratio — the ``step_health``
        contract) to the
        heartbeat the obs endpoint serves AND the flight-recorder ring,
        so a SIGKILLed diverging pod leaves its last losses/grad-norms
        on disk. Called at the program's existing log points only — the
        health scalars were device arrays until the caller read them,
        so this adds no sync of its own."""
        if not self.enabled:
            return
        t0 = time.perf_counter()
        block = {"step": int(step), **health}
        self.recorder.record({
            "kind": "health", "t": time.time(),
            "trace_id": self.trace_id, "task": self.task, **block,
        })
        with self._hb_lock:
            self._hb_health = block
        self.recorder.maybe_flush()
        # accounted like StepTrace bookkeeping: the llama_bench < 1%
        # overhead guard must cover the health-note path (including an
        # interval flush's fsync'd dump) — not just the phase spans
        self.overhead_s += time.perf_counter() - t0

    def _record_span(self, name: str, wall_s: float, attrs: dict) -> None:
        self.recorder.record({
            "kind": "span", "name": name, "t": time.time(),
            "trace_id": self.trace_id, "task": self.task,
            "wall_s": round(wall_s, 6), **attrs,
        })

    # -- export -----------------------------------------------------------

    def heartbeat(self) -> dict:
        """The per-host stats block the obs /healthz endpoint serves and
        the reconciler's straggler detector consumes: last completed
        step, its wall time + phase breakdown, and how stale it is."""
        with self._hb_lock:
            hb = dict(self._hb)
            at = self._hb_at
            if self._hb_health is not None:
                hb["health"] = dict(self._hb_health)
        hb["trace_id"] = self.trace_id
        hb["task"] = self.task
        hb["host"] = self.host
        hb["age_s"] = round(time.monotonic() - at, 3) if at else -1.0
        return hb

    def last_step(self) -> dict:
        """The latest step record (step + wall + phases) — what
        llama_train prints at log points as the ``step_phases`` event."""
        with self._hb_lock:
            return dict(self._hb)

    def flush(self, reason: str = "") -> Optional[str]:
        return self.recorder.dump(reason)


class _SpanCtx:
    __slots__ = ("_tracer", "_name", "_attrs", "_t0")

    def __init__(self, tracer: Tracer, name: str, attrs: dict):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer._record_span(
            self._name, time.perf_counter() - self._t0, self._attrs)
        return False


# -- process-global default (the launcher's signal path dumps it) --------

_DEFAULT: Optional[Tracer] = None
_DEFAULT_LOCK = threading.Lock()


def set_default_tracer(tracer: Optional[Tracer]) -> None:
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = tracer


def default_tracer() -> Optional[Tracer]:
    return _DEFAULT


def dump_default(reason: str = "") -> Optional[str]:
    """Force-dump the process default tracer's flight recorder —
    called from the launcher's SIGTERM handler, the crash exits, and
    the preemption-flush path. Never raises (a post-mortem aid must
    not change how the process dies)."""
    t = _DEFAULT
    if t is None:
        return None
    try:
        return t.flush(reason)
    except Exception:
        return None
