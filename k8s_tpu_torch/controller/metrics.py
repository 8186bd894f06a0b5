"""Prometheus-style counters, gauges and histograms with the text
exposition (the port's copy of ``k8s_tpu/controller/metrics.py``: the
registry classes, the series the program side sets — the ``ktpu_ckpt_*``
checkpoint series (goodput, restore and save seconds by phase, lost
steps, skipped saves; the training program's ``compile`` phase reports
into the restore gauge) and the device-memory gauges of the obs
endpoint — and the operator's series (reconciles, gang restarts, the
obs tick's straggler and health verdicts, the work queue). Same names,
help text and exposition format, so the series catalogue of
``docs/OBSERVABILITY.md`` covers them. The serving, scheduler and
resize series come with their slices.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

LabelKV = Tuple[Tuple[str, str], ...]


def _escape_label_value(v: str) -> str:
    """Prometheus text-exposition label-value escaping: backslash,
    double-quote, and newline must be escaped or a single hostile/odd
    value (a job name with a quote, a multi-line error string) corrupts
    the WHOLE scrape. Order matters: backslash first."""
    return (
        v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _escape_help(v: str) -> str:
    """HELP-line escaping per the text format: backslash and newline."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


class _Metric:
    def __init__(self, name: str, help_text: str, mtype: str):
        self.name = name
        self.help = help_text
        self.type = mtype
        self.values: Dict[LabelKV, float] = {}
        self._lock = threading.Lock()

    def _key(self, labels: Optional[Dict[str, str]]) -> LabelKV:
        return tuple(sorted((labels or {}).items()))

    def clear(self) -> None:
        """Drop all label series (a component whose truth this metric
        mirrored has shut down)."""
        with self._lock:
            self.values.clear()

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {_escape_help(self.help)}",
               f"# TYPE {self.name} {self.type}"]
        with self._lock:
            for key, v in sorted(self.values.items()):
                if key:
                    lbl = ",".join(
                        f'{k}="{_escape_label_value(val)}"'
                        for k, val in key)
                    out.append(f"{self.name}{{{lbl}}} {v}")
                else:
                    out.append(f"{self.name} {v}")
        return out


class Counter(_Metric):
    def __init__(self, name, help_text):
        super().__init__(name, help_text, "counter")

    def inc(self, labels: Optional[Dict[str, str]] = None, by: float = 1.0):
        key = self._key(labels)
        with self._lock:
            self.values[key] = self.values.get(key, 0.0) + by

    def get(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self.values.get(self._key(labels), 0.0)


class Gauge(_Metric):
    def __init__(self, name, help_text):
        super().__init__(name, help_text, "gauge")

    def set(self, value: float, labels: Optional[Dict[str, str]] = None):
        with self._lock:
            self.values[self._key(labels)] = value

    def get(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self.values.get(self._key(labels), 0.0)


_DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                    1.0, 2.5, 5.0, 10.0)


class Histogram(_Metric):
    """Cumulative-bucket histogram per the text exposition format:
    ``<name>_bucket{le=...}`` (cumulative, ``+Inf`` last), ``_sum``,
    ``_count``. One instance per labelset, like the other types."""

    def __init__(self, name, help_text, buckets=_DEFAULT_BUCKETS):
        super().__init__(name, help_text, "histogram")
        self.buckets = tuple(sorted(buckets))
        # per-labelset: [counts per bucket] + sum + count
        self._series: Dict[LabelKV, List[float]] = {}
        self._sums: Dict[LabelKV, float] = {}
        self._counts: Dict[LabelKV, float] = {}

    def observe(self, value: float,
                labels: Optional[Dict[str, str]] = None) -> None:
        key = self._key(labels)
        with self._lock:
            counts = self._series.setdefault(
                key, [0.0] * len(self.buckets))
            for i, le in enumerate(self.buckets):
                if value <= le:
                    counts[i] += 1.0
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._counts[key] = self._counts.get(key, 0.0) + 1.0

    def count(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._counts.get(self._key(labels), 0.0)

    def sum(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._sums.get(self._key(labels), 0.0)

    def clear(self) -> None:
        with self._lock:
            self._series.clear()
            self._sums.clear()
            self._counts.clear()

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {_escape_help(self.help)}",
               f"# TYPE {self.name} {self.type}"]
        with self._lock:
            for key in sorted(self._series):
                base = [f'{k}="{_escape_label_value(v)}"'
                        for k, v in key]
                cum = 0.0
                for le, n in zip(self.buckets, self._series[key]):
                    cum = n  # buckets are already cumulative
                    lbl = ",".join(base + [f'le="{le:g}"'])
                    out.append(f"{self.name}_bucket{{{lbl}}} {cum}")
                lbl = ",".join(base + ['le="+Inf"'])
                out.append(
                    f"{self.name}_bucket{{{lbl}}} {self._counts[key]}")
                suffix = f"{{{','.join(base)}}}" if base else ""
                out.append(f"{self.name}_sum{suffix} {self._sums[key]}")
                out.append(
                    f"{self.name}_count{suffix} {self._counts[key]}")
        return out


class Registry:
    def __init__(self):
        self._metrics: List[_Metric] = []
        self.start_time = time.time()
        # samplers run at exposition time (gauges whose truth lives in
        # another component, e.g. informer cache sizes)
        self._collectors: List = []
        self._broken_collectors: set = set()

    def on_collect(self, fn) -> None:
        self._collectors.append(fn)

    def remove_collector(self, fn) -> None:
        if fn in self._collectors:
            self._collectors.remove(fn)
        # drop broken-status too: the closure would otherwise be pinned
        # (with everything it references) for the process lifetime, and
        # a re-registered collector would inherit its silenced warning
        self._broken_collectors.discard(fn)

    def counter(self, name: str, help_text: str) -> Counter:
        m = Counter(name, help_text)
        self._metrics.append(m)
        return m

    def gauge(self, name: str, help_text: str) -> Gauge:
        m = Gauge(name, help_text)
        self._metrics.append(m)
        return m

    def histogram(self, name: str, help_text: str,
                  buckets=_DEFAULT_BUCKETS) -> Histogram:
        m = Histogram(name, help_text, buckets)
        self._metrics.append(m)
        return m

    def expose(self) -> str:
        for fn in list(self._collectors):
            try:
                fn()
            except Exception as e:
                # a broken sampler must not break /metrics, but a
                # silently-frozen gauge is a debugging trap — log once
                if fn not in self._broken_collectors:
                    self._broken_collectors.add(fn)
                    import logging

                    logging.getLogger(__name__).warning(
                        "metrics collector %r failed (gauges it feeds "
                        "are now stale): %s", fn, e)
        lines: List[str] = []
        for m in self._metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"


# process-global registry, served at /metrics by the obs endpoint
REGISTRY = Registry()
# Multi-tier checkpoint goodput (k8s_tpu_torch/ckpt): the JAX
# package's series, same names and help text.
CKPT_RESTORES = REGISTRY.counter(
    "ktpu_ckpt_restores_total",
    "Checkpoint restores, by source tier (local / local+peer / persistent)",
)
CKPT_LOST_STEPS = REGISTRY.counter(
    "ktpu_ckpt_lost_steps_total",
    "Train steps lost to restarts (progress past the restored step)",
)
CKPT_LOST_STEPS_PER_RESTART = REGISTRY.gauge(
    "ktpu_ckpt_lost_steps_per_restart",
    "Mean steps lost per restart since process start",
)
CKPT_LOCAL_SAVES = REGISTRY.counter(
    "ktpu_ckpt_local_saves_total",
    "Local-tier snapshot commits",
)
CKPT_OVERHEAD_FRACTION = REGISTRY.gauge(
    "ktpu_ckpt_overhead_fraction",
    "Fraction of loop wall-clock spent in checkpoint saves",
)
CKPT_RESTORE_SECONDS = REGISTRY.gauge(
    "ktpu_ckpt_restore_seconds",
    "Wall seconds of the last restore, by phase (plan / fetch / device "
    "/ total; compile = the first post-restore step incl. XLA compile) "
    "— the MTTR breakdown, docs/CHECKPOINT.md 'Restore critical path'",
)
CKPT_SAVE_SECONDS = REGISTRY.gauge(
    "ktpu_ckpt_save_seconds",
    "Wall seconds of the last save, by phase (snapshot = the step-"
    "critical-path parallel device-to-host staging; serialize / commit "
    "= the background writer/committer legs, which overlap training) — "
    "docs/CHECKPOINT.md 'Save critical path'",
)
CKPT_SAVE_SKIPPED = REGISTRY.counter(
    "ktpu_ckpt_save_skipped_total",
    "Routed checkpoint saves skipped because the previous save was "
    "still committing in the background, by reason (writer_busy = "
    "local tier, committer_busy = persistent tier) — the visible cost "
    "of a save interval tighter than the disk/store can drain",
)
# Device HBM gauges, exported by every process that serves an
# obs/metrics endpoint. Empty on backends that don't report (CPU).
OBS_HBM_IN_USE = REGISTRY.gauge(
    "ktpu_obs_hbm_bytes_in_use",
    "Device HBM bytes currently allocated, by device",
)
OBS_HBM_PEAK = REGISTRY.gauge(
    "ktpu_obs_hbm_bytes_peak",
    "Device HBM high-water mark since process start, by device",
)
OBS_HBM_LIMIT = REGISTRY.gauge(
    "ktpu_obs_hbm_bytes_limit",
    "Device HBM capacity visible to the allocator, by device",
)
# The operator's series (k8s_tpu_torch/controller, trainer): the JAX
# package's names and help text, for the operator's /metrics.
EVENTS_HANDLED = REGISTRY.counter(
    "ktpu_operator_events_total", "Watch events dispatched, by type"
)
JOBS_STARTED = REGISTRY.counter(
    "ktpu_operator_jobs_started_total", "TrainingJob reconcilers started"
)
JOBS_TERMINAL = REGISTRY.counter(
    "ktpu_operator_jobs_terminal_total", "Jobs reaching a terminal state, by state"
)
RECONCILES = REGISTRY.counter(
    "ktpu_operator_reconciles_total", "Reconcile passes executed"
)
LIVE_JOBS = REGISTRY.gauge(
    "ktpu_operator_live_jobs", "Reconcilers currently tracked"
)
INFORMER_OBJECTS = REGISTRY.gauge(
    "ktpu_operator_informer_objects",
    "Objects held by the watch-fed informer cache, by kind",
)
INFORMER_SYNCED = REGISTRY.gauge(
    "ktpu_operator_informer_synced",
    "1 when every informer kind has completed its initial list",
)
GANG_RESTART_BACKOFF = REGISTRY.gauge(
    "ktpu_operator_gang_restart_backoff_seconds",
    "Current gang-restart backoff hold-off per job (0 = no hold-off)",
)
GANG_RESTARTS_DELAYED = REGISTRY.counter(
    "ktpu_operator_gang_restarts_delayed_total",
    "Gang restarts deferred by the backoff schedule, by job",
)
# Step-phase telemetry + gang straggler detection, fed by the
# reconciler's per-host heartbeat aggregation over the workers' obs
# endpoints.
OBS_STEP_SKEW = REGISTRY.gauge(
    "ktpu_obs_step_skew_seconds",
    "Gang busy-step-time skew (slowest host - peer median), by job",
)
OBS_HOST_STEP_TIME = REGISTRY.gauge(
    "ktpu_obs_host_step_time_seconds",
    "Latest per-host train-step wall time, by job/host",
)
OBS_PHASE_SECONDS = REGISTRY.gauge(
    "ktpu_obs_phase_seconds",
    "Latest per-host step-phase duration, by job/host/phase",
)
OBS_STRAGGLERS = REGISTRY.counter(
    "ktpu_obs_stragglers_total",
    "StragglerDetected verdicts raised, by job",
)
# Training-health monitoring (obs/health.py HealthMonitor): numerics
# verdicts + the goodput cost of divergence, fed by the obs tick.
OBS_DIVERGENCE_RESTARTS = REGISTRY.counter(
    "ktpu_obs_divergence_restarts_total",
    "Gang restarts driven by a TrainingDiverged verdict, by job",
)
OBS_DIVERGED_STEPS = REGISTRY.counter(
    "ktpu_obs_diverged_steps_total",
    "Train steps discarded to divergence (progress past the last "
    "healthy step at verdict time), by job",
)
OBS_NUMERICS_WARNINGS = REGISTRY.counter(
    "ktpu_obs_numerics_warnings_total",
    "NumericsWarning verdicts raised (loss spike / plateau), by job/kind",
)
OBS_MEMORY_PRESSURE = REGISTRY.counter(
    "ktpu_obs_memory_pressure_total",
    "MemoryPressure events raised (HBM peak over the spec'd fraction "
    "of capacity), by job/host",
)
# the shared reconciler core's own telemetry — how much work the queue
# is doing, how much it avoided, and what each pass cost
RECONCILE_LATENCY = REGISTRY.histogram(
    "ktpu_controller_reconcile_latency_seconds",
    "Wall-clock duration of each reconcile pass through the shared "
    "worker pool",
)
WORKQUEUE_DEPTH = REGISTRY.gauge(
    "ktpu_controller_workqueue_depth",
    "Keys waiting in the shared reconciler work queue (ready + "
    "delayed requeues)",
)
WORKQUEUE_COALESCED = REGISTRY.counter(
    "ktpu_controller_workqueue_coalesced_total",
    "Queue adds merged into an already-queued or in-flight key — "
    "reconcile passes the coalescing saved",
)
RECONCILE_REQUEUES = REGISTRY.counter(
    "ktpu_controller_requeues_total",
    "Keys re-queued after a pass, by reason (poll = periodic "
    "obs/serving cadence, resync = slow backstop, error = exponential "
    "failure backoff)",
)
CONTROLLER_HTTP_CALLS = REGISTRY.counter(
    "ktpu_controller_http_calls_total",
    "Status-poll HTTP calls issued by the shared connection-reusing "
    "poller, by component (obs = worker heartbeat sweep, router = "
    "serving stats)",
)
HEARTBEATS_PUSHED = REGISTRY.counter(
    "ktpu_controller_heartbeats_pushed_total",
    "Worker obs heartbeats PUSHED into the control plane (the "
    "/v1/heartbeat receiver) instead of polled",
)
