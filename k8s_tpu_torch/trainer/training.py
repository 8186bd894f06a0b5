"""TrainingJob: the per-job reconciler and state machine (the port's
copy of ``k8s_tpu/trainer/training.py``, with elastic gang resize
counted in GPU nodes, and without the serving fleet's autoscaling — a
later slice, ROADMAP A12.5; validation refuses its spec block).

Analogue of reference ``pkg/trainer/training.go``: one worker thread
per TpuJob with an event queue (cap 100) and an 8s reconcile ticker
(:23,412-456); ``setup()`` = defaults → validate → replica sets →
TensorBoard → accelerators → 4-char RuntimeId (:245-301);
``cluster_spec()`` (:114-128); chief-decides-job ``get_status``
(:163-199); the exit-code retry policy (:201-238) is ported as
*policy*, verbatim semantics: OOMKilled ⇒ permanent, exit 0 ⇒ success,
1–127 ⇒ permanent, 128–255 ⇒ retryable; ``reconcile`` (:350-409) with
status written back only on change (:331-347).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from k8s_tpu_torch.api.client import KubeClient
from k8s_tpu_torch.api.crd_client import TpuJobClient
from k8s_tpu_torch.api.objects import ContainerStateTerminated
from k8s_tpu_torch.spec import (
    COORDINATOR,
    ControllerConfig,
    ReplicaState,
    ReplicaStatus,
    TpuJob,
    TpuJobPhase,
    TpuJobState,
    TpuJobStatus,
    WORKER,
)
from k8s_tpu_torch import utils
from k8s_tpu_torch.robustness.backoff import Backoff
from k8s_tpu_torch.trainer.replicas import ReplicaSetSnapshot, TpuReplicaSet
from k8s_tpu_torch.trainer.tensorboard import TensorBoardReplicaSet, init_tensorboard

log = logging.getLogger(__name__)

RECONCILE_INTERVAL = 8.0  # reference training.go:23
EVENT_QUEUE_CAP = 100  # reference training.go:412
# identical rejected spec edits re-report at most this often (caps the
# event/condition churn of a GitOps loop re-applying a bad spec)
REJECTION_REPORT_INTERVAL = 300.0

_EVENT_DELETE = "delete"
_EVENT_MODIFY = "modify"
_EVENT_NUDGE = "nudge"
_EVENT_PREEMPT = "preempt"


def is_retryable_termination_state(s: ContainerStateTerminated) -> bool:
    """Ported policy of reference ``isRetryableTerminationState``
    (training.go:201-238)."""
    if s.reason == "OOMKilled":
        return False
    if 0 <= s.exit_code <= 127:
        # 0 success; 1–127 permanent user error — neither is retried.
        return False
    # 128–255 (137=SIGKILL, 143=SIGTERM, …) → internal error, retryable.
    return True


class TrainingJob:
    """Reconciles one TpuJob to completion."""

    def __init__(
        self,
        client: KubeClient,
        job_client: TpuJobClient,
        job: TpuJob,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.client = client
        self.job_client = job_client
        self.job = job
        self.clock = clock  # injectable: backoff spacing tests run on a fake clock
        self.status: TpuJobStatus = job.status.deepcopy()
        self.replicas: List[TpuReplicaSet] = []
        self.tensorboard: Optional[TensorBoardReplicaSet] = None
        self._events: "queue.Queue[Tuple[str, Optional[TpuJob]]]" = queue.Queue(
            maxsize=EVENT_QUEUE_CAP
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._rejected_spec: Optional[dict] = None  # dedupe rejections
        self._rejected_at = 0.0
        self._restart_backoff: Optional[Backoff] = None
        self._backoff_waiting = False  # dedupe the BackoffRestarting condition
        # Gang straggler detection (spec.observability,
        # docs/OBSERVABILITY.md): the detector is pure decision logic
        # over per-host step heartbeats; the stats source is pluggable
        # (the default fetcher GETs each
        # worker's per-index Service obs endpoint, best-effort)
        self._straggler_detector = None
        self.worker_stats_fetcher: Optional[
            Callable[[], Optional[Dict[int, dict]]]] = None
        # Training-health monitor (spec.observability.onDivergence,
        # docs/OBSERVABILITY.md "Training health"): pure decision logic
        # over the step_health blocks riding the same heartbeats. On a
        # TrainingDiverged verdict the restore ceiling (last HEALTHY
        # step) is stamped here; replicas._checkpoint_env injects it
        # into the restarted gang so the planner never restores a NaN
        # checkpoint. Cleared once the recovered gang trains past it.
        self._health_monitor = None
        self.restore_ceiling: Optional[int] = None
        self._memory_pressure_hosts: set = set()
        # pluggable profile capture (host, seconds) -> result dict for
        # the straggler auto-profile; default GETs the host's obs
        # endpoint /debug/profile in a background thread
        self.profile_trigger: Optional[Callable[[int, float],
                                                Optional[dict]]] = None
        # (clock_time, delay_armed_for_the_NEXT_restart) per restart —
        # what the soak asserts spacing from
        self.restart_history: List[Tuple[float, float]] = []
        # Cluster-scheduler hooks (docs/SCHEDULER.md): the controller
        # sets on_terminal so a finishing job frees its nodes the tick
        # it finishes; reconcile_limiter is the shared worker-pool
        # semaphore bounding concurrent reconcile ticks at O(100) jobs
        # (None = unbounded, today's behavior); _last_worker_stats is
        # the freshest heartbeat sweep, kept so preemption_cost() can
        # price this job's eviction without a new fetch.
        self.on_terminal: Optional[Callable[["TrainingJob"], None]] = None
        self.reconcile_limiter = None
        self._preempt_reason: Optional[str] = None
        self._last_worker_stats: Optional[Dict[int, dict]] = None
        # Elastic gang resize (spec.elastic, docs/ELASTIC.md): the pure
        # decision core is built lazily from the spec; the capacity
        # view and the ledger re-charge are controller-wired callbacks
        # (None without a cluster scheduler — dead-heartbeat shrink
        # still works, inventory-driven shrink/grow need the ledger).
        self._resizer = None
        self.capacity_fn: Optional[Callable[[], Optional[int]]] = None
        # (job, old_dp, new_dp, trigger) -> ledger accepted; trigger is
        # the verdict rule that fired ("inventory"/"dead-hosts"/
        # "capacity-return") so the ledger can re-verify an inventory-
        # triggered shrink against the live pool deficit
        self.on_resize: Optional[
            Callable[["TrainingJob", int, int, str], bool]] = None
        # Event-driven mode (docs/SCHEDULER.md "Event-driven core"):
        # instead of owning a thread, the job registers a handler with
        # the controller's shared ReconcilerCore; events kick its key,
        # _process() drains + reconciles once, and the returned delay
        # is the requeue cadence (None = wait for the next event).
        self._core = None
        self._exited = False
        self._config: Optional[ControllerConfig] = None
        self._interval = RECONCILE_INTERVAL
        self.resync_seconds = 300.0
        # PUSHED heartbeats (the /v1/heartbeat receiver): host ->
        # (recv_time, payload). When fresh they satisfy the obs sweep
        # with zero HTTP polls from the control plane.
        self._pushed: Dict[int, Tuple[float, dict]] = {}
        self._pushed_lock = threading.Lock()
        # rv of the snapshot this reconciler was built from: watch
        # MODIFIED events at or below it carry no new information and
        # must not be diffed as user edits (see _handle_modify)
        try:
            self._spawn_rv = int(job.metadata.resource_version or 0)
        except (TypeError, ValueError):
            self._spawn_rv = 0

    # ------------------------------------------------------------ identity

    @property
    def name(self) -> str:
        return self.job.metadata.name

    @property
    def fullname(self) -> str:
        return f"{self.job.metadata.namespace}:{self.job.metadata.name}"

    def chief(self) -> Tuple[str, int]:
        tp = self.job.spec.termination_policy
        if tp is not None and tp.chief is not None:
            return tp.chief.replica_name, tp.chief.replica_index
        return COORDINATOR, 0

    # ------------------------------------------------------------ cluster map

    def cluster_spec(self) -> Dict[str, List[str]]:
        """``{role.lower(): ["<dns>:<port>", ...]}`` from replica naming
        (reference ClusterSpec, training.go:114-128). The per-index
        Service gives each name stable DNS."""
        out: Dict[str, List[str]] = {}
        for r in self.replicas:
            names = [
                f"{r.job_name(i)}:{r.spec.port}" for i in range(r.spec.replicas or 0)
            ]
            out[r.spec.replica_type.lower()] = names
        return out

    # ------------------------------------------------------------ setup

    def setup(self, config: ControllerConfig) -> None:
        """Reference setup() (training.go:245-301). ``QUEUED`` runs the
        same first-time path as ``NONE``: it is how a scheduler-admitted
        job (fresh, or a re-admitted preemption victim) materializes —
        a persisted ``runtime_id`` survives, so the victim's per-index
        Services (and therefore its peers' checkpoint/obs DNS) are
        stable across the preempt → re-admit cycle."""
        if self.status.phase not in (TpuJobPhase.NONE, TpuJobPhase.QUEUED):
            # Adopted mid-flight (operator restart / HA failover,
            # reference findAllTfJobs controller.go:172-201): the CRD
            # already carries phase + runtime_id, but THIS process has
            # no replica-set objects yet — materialize them from the
            # persisted spec so status/gang reconciliation can resume.
            # Phase/state/runtime_id are left untouched.
            if not self.replicas and self.job.spec.replica_specs:
                try:
                    self._materialize_replica_sets(validate=False)
                except Exception as e:
                    log.error("job %s: adopt materialize: %s", self.fullname, e)
            return
        try:
            self._materialize_replica_sets()
            self.job.spec.configure_accelerators(config.accelerators)
            if not self.job.spec.runtime_id:
                self.job.spec.runtime_id = utils.rand_string(4)
        except Exception as e:  # invalid spec → Failed, quarantined
            self.status.reason = str(e)
            self.status.phase = TpuJobPhase.FAILED
            self.status.state = TpuJobState.FAILED
            log.error("setup of job %s failed: %s", self.fullname, e)
            return
        self.status.phase = TpuJobPhase.CREATING
        self.status.state = TpuJobState.RUNNING

    def _materialize_replica_sets(self, validate: bool = True) -> None:
        """Defaults → (validate) → build replica-set + TB objects.
        Shared by first-time setup, mid-flight adoption, and the
        CLEANUP rebuild; idempotent (runtime_id persists in the spec).
        Adoption and teardown pass ``validate=False``: a spec that
        passed validation when the job was CREATED must still be
        reconcilable/deletable even if validation has tightened across
        an operator upgrade — re-validating there would brick a running
        job or leak its resources."""
        self.job.spec.set_defaults()
        # a resized elastic gang persists its width in status.dp_degree:
        # adoption and re-admission must materialize the RESIZED shape,
        # not the gpu block's node count
        if self.status.dp_degree > 0 and self.job.spec.elastic is not None:
            self._apply_dp_to_replicas(self.status.dp_degree,
                                       sets_exist=False)
        if validate:
            self.job.spec.validate()
        self.replicas = [
            TpuReplicaSet(self.client, rs, self)
            for rs in self.job.spec.replica_specs
        ]
        if validate:
            for r in self.replicas:
                r.check_programs()
        self.tensorboard = init_tensorboard(self.client, self)

    # ------------------------------------------------------------ resources

    def create_resources(self, config: ControllerConfig) -> None:
        for r in self.replicas:
            r.create(config)
        if self.tensorboard is not None:
            self.tensorboard.create()

    def delete_resources(self) -> None:
        # A job adopted after an operator restart in CLEANUP phase never
        # ran setup(), so materialize replica sets from the (persisted)
        # spec before tearing down — otherwise the delete is a no-op and
        # the job's Jobs/Services leak.
        if not self.replicas and self.job.spec.replica_specs:
            try:
                self._materialize_replica_sets(validate=False)
            except Exception as e:
                log.error("job %s: rebuild replica sets for delete: %s",
                          self.fullname, e)
        for r in self.replicas:
            r.delete()
        if self.tensorboard is not None:
            self.tensorboard.delete()

    # ------------------------------------------------------------ status

    def snapshots(self) -> List["ReplicaSetSnapshot"]:
        """One snapshot per replica set, computed ONCE per tick and
        shared by status aggregation and the gang policy — round 2 read
        the apiserver twice per tick for the same data (VERDICT weak #1);
        with the informer synced this reads no apiserver at all."""
        return [r.snapshot() for r in self.replicas]

    def get_status(
        self, snaps: Optional[List["ReplicaSetSnapshot"]] = None
    ) -> Tuple[str, List[ReplicaStatus]]:
        """Chief-decides-job aggregation (reference GetStatus,
        training.go:163-199): any failed replica ⇒ Failed tentatively;
        the chief replica's Succeeded/Failed is authoritative."""
        if snaps is None:
            snaps = self.snapshots()
        state = TpuJobState.UNKNOWN
        statuses: List[ReplicaStatus] = []
        set_states: Dict[str, str] = {}
        for r, snap in zip(self.replicas, snaps):
            rs = snap.status
            set_states[r.spec.replica_type] = rs.state
            statuses.append(rs)
            if rs.state == ReplicaState.FAILED:
                state = TpuJobState.FAILED
        chief_name, _ = self.chief()
        if chief_name not in set_states and WORKER in set_states:
            chief_name = WORKER  # no control replica → the gang decides
        chief_state = set_states.get(chief_name)
        if chief_state == ReplicaState.SUCCEEDED:
            return TpuJobState.SUCCEEDED, statuses
        if chief_state == ReplicaState.FAILED:
            return TpuJobState.FAILED, statuses
        if state == TpuJobState.FAILED:
            return state, statuses
        return TpuJobState.RUNNING, statuses

    def restart_backoff(self) -> Backoff:
        """The per-job gang-restart Backoff, built from the (defaulted)
        ``restartBackoff`` spec block on first use. Seeded from the job
        key so jitter is reproducible for a given job name."""
        if self._restart_backoff is None:
            import zlib

            rb = self.job.spec.restart_backoff
            policy = rb.to_policy() if rb is not None else None
            # crc32, not hash(): str hashing is salted per interpreter,
            # which would give a restarted operator different jitter for
            # the same job name
            seed = zlib.crc32(self.fullname.encode())
            self._restart_backoff = Backoff(policy, seed=seed, clock=self.clock)
        return self._restart_backoff

    def _maybe_gang_restart(
        self, snaps: Optional[List["ReplicaSetSnapshot"]] = None
    ) -> Optional[str]:
        """Gang-granular recovery (SURVEY §7.2 hard part #1). One
        retryable worker exit ⇒ delete and recreate ALL pods of the
        gang: the dead worker's peers are blocked in (or about to fail
        out of) NCCL collectives, so only a coherent whole-gang restart —
        with workers restoring from the latest checkpoint — makes
        progress. Returns ``"restarted"`` if a restart was initiated,
        ``"backoff"`` if one is wanted but held off by the restart
        backoff schedule (CrashLoopBackOff semantics — storm
        protection), ``"exhausted"`` if the budget is spent (job must
        fail), or ``None`` if the gang is healthy.

        The reference restarted replicas independently
        (replicas.go:216-229, README:204-214) — acceptable for
        PS/worker, wrong for an SPMD gang.
        """
        from k8s_tpu_torch.controller import metrics

        if snaps is None:
            snaps = self.snapshots()
        degraded = [
            (r, snap.degraded) for r, snap in zip(self.replicas, snaps)
            if r.is_gang and snap.degraded
        ]
        if not degraded:
            if self._backoff_waiting:
                # spontaneously healthy again (e.g. budget raised &
                # pods recovered) — leave the waiting state quietly
                self._backoff_waiting = False
            metrics.GANG_RESTART_BACKOFF.set(
                self.restart_backoff().remaining(), {"job": self.fullname})
            return None
        # Elastic pre-check: a degraded gang normally restores in place
        # — but when the scheduler inventory says the dead pod's node is
        # PERMANENTLY gone, a same-shape restart can never place. Shrink
        # to the attainable width instead; restore-in-place stays the
        # path whenever capacity is intact.
        resize = self._resize_instead_of_restart()
        if resize is not None:
            return resize
        if self.status.gang_restarts >= self.job.spec.max_gang_restarts:
            # budget spent: fail fast — there is no restart left to space
            names = [f"{r.spec.replica_type}{idxs}" for r, idxs in degraded]
            self.status.reason = (
                f"gang restart budget exhausted "
                f"({self.job.spec.max_gang_restarts}) after {names}"
            )
            return "exhausted"
        bo = self.restart_backoff()
        remaining = bo.remaining()  # also applies the stable-window reset
        metrics.GANG_RESTART_BACKOFF.set(remaining, {"job": self.fullname})
        if remaining > 0:
            if not self._backoff_waiting:
                self._backoff_waiting = True
                metrics.GANG_RESTARTS_DELAYED.inc({"job": self.fullname})
                self.status.append_condition(
                    "BackoffRestarting",
                    reason=f"gang restart {self.status.gang_restarts + 1} "
                           f"held for {remaining:.1f}s "
                           f"(consecutive failures: {bo.failures})",
                )
                log.info(
                    "job %s: gang restart held %.1fs by backoff "
                    "(failure streak %d)",
                    self.fullname, remaining, bo.failures,
                )
            return "backoff"
        self._backoff_waiting = False
        self.status.gang_restarts += 1
        # arm the hold-off for the NEXT restart and record this one's
        # timestamp — the soak asserts consecutive restarts are spaced
        # by at least the delay armed here
        next_delay = bo.note_failure()
        self.restart_history.append((self.clock(), next_delay))
        metrics.GANG_RESTART_BACKOFF.set(next_delay, {"job": self.fullname})
        self.status.append_condition(
            "GangRestart",
            reason=f"retryable worker exit at "
                   f"{[(r.spec.replica_type, i) for r, i in degraded]}; "
                   f"next restart backed off {next_delay:.1f}s",
        )
        log.warning(
            "job %s: gang restart %d/%d (degraded: %s)",
            self.fullname, self.status.gang_restarts,
            self.job.spec.max_gang_restarts,
            [(r.spec.replica_type, i) for r, i in degraded],
        )
        self._record_event(
            "GangRestart",
            f"restarting all gang pods "
            f"({self.status.gang_restarts}/{self.job.spec.max_gang_restarts})",
            etype="Warning",
        )
        # the WHOLE gang goes down together, not just the degraded set
        for r in self.replicas:
            if r.is_gang:
                try:
                    r.delete_compute()
                except Exception as e:
                    log.error("job %s: gang teardown: %s", self.fullname, e)
        return "restarted"

    # ------------------------------------------------------------ workers

    def _worker_set(self) -> Optional[TpuReplicaSet]:
        for r in self.replicas:
            if r.spec.replica_type == WORKER:
                return r
        return None

    # ------------------------------------------------------------ stragglers

    @staticmethod
    def _graft_ckpt(payload: dict) -> Optional[dict]:
        """Extract the obs heartbeat off a healthz payload, grafting
        the sibling ckpt goodput block on so the scheduler's
        preemption pricing (progress past ckpt.last_saved_step) sees
        it (docs/SCHEDULER.md)."""
        hb = payload.get("obs")
        if not isinstance(hb, dict):
            return None
        ck = payload.get("ckpt")
        if isinstance(ck, dict) and "ckpt" not in hb:
            hb = {**hb, "ckpt": ck}
        return hb

    def _http_worker_stats(self) -> Optional[Dict[int, dict]]:
        """Default per-host heartbeat source: GET each gang WORKER's
        per-index Service obs endpoint through the controller-wide
        :func:`~k8s_tpu_torch.controller.poller.shared_poller` — one batched
        sweep on persistent connections, replacing the fresh thread
        per replica per tick this used to spawn. Any per-host failure
        is a miss — a host that answers nothing is the gang-restart
        path's problem, not this one's."""
        from k8s_tpu_torch.controller.poller import shared_poller

        obs = self.job.spec.observability
        wset = self._worker_set()
        if obs is None or not obs.obs_port or wset is None:
            return None
        urls = {
            i: f"http://{wset.job_name(i)}:{obs.obs_port}/healthz"
            for i in range(wset.spec.replicas or 0)
        }
        payloads = shared_poller().fetch_json_many(
            urls, timeout=2.0, component="obs")
        out: Dict[int, dict] = {}
        for i, payload in payloads.items():
            hb = self._graft_ckpt(payload)
            if hb is not None:
                out[i] = hb
        return out or None

    # ------------------------------------------------------ pushed heartbeats

    def ingest_heartbeat(self, host: int, payload: dict) -> None:
        """A worker's obs heartbeat PUSHED into the control plane (the
        operator's ``/v1/heartbeat`` receiver) instead of polled: store
        it and kick this job's queue key — the obs sweep becomes an
        event, and the reconciler fetches nothing."""
        from k8s_tpu_torch.controller import metrics

        hb = self._graft_ckpt(payload) if "obs" in payload else payload
        if not isinstance(hb, dict):
            return
        with self._pushed_lock:
            self._pushed[int(host)] = (self.clock(), hb)
        metrics.HEARTBEATS_PUSHED.inc()
        self._kick()

    def _pushed_worker_stats(self) -> Optional[Dict[int, dict]]:
        """The pushed-heartbeat sweep, if fresh enough to stand in for
        a poll (hosts pushed within ~2 intervals); None ⇒ fall back to
        the pull path."""
        window = max(2.0 * self._interval, 5.0)
        now = self.clock()
        with self._pushed_lock:
            fresh = {h: hb for h, (t, hb) in self._pushed.items()
                     if now - t <= window}
        return fresh or None

    def _obs_tick(self) -> Optional[str]:
        """The reconciler's observability tick: ONE concurrent heartbeat
        sweep feeds straggler detection, the HBM-pressure check, and the
        training-health monitor (docs/OBSERVABILITY.md). Returns the
        health verdict's action (``"restarted"`` / ``"halt"`` /
        ``"exhausted"``) for reconcile to act on, or None."""
        obs = self.job.spec.observability
        wset = self._worker_set()
        if wset is None:
            return None
        if obs is None and self.worker_stats_fetcher is None:
            return None
        if self.worker_stats_fetcher is not None:
            stats = self.worker_stats_fetcher()
        else:
            # pushed heartbeats (fresh) satisfy the sweep with zero
            # polls; the batched shared-poller pull is the fallback
            stats = self._pushed_worker_stats() or self._http_worker_stats()
        if not stats:
            return None
        # freshest sweep kept for the cluster scheduler's preemption
        # pricing (preemption_cost reads step + ckpt.last_saved_step)
        self._last_worker_stats = stats
        try:
            self._maybe_detect_stragglers(stats)
        except Exception as e:
            log.error("job %s: straggler detection: %s", self.fullname, e)
        try:
            self._maybe_memory_pressure(stats)
        except Exception as e:
            log.error("job %s: memory-pressure check: %s", self.fullname, e)
        action = self._maybe_monitor_health(stats)
        if action is not None:
            return action
        try:
            # elastic resize rides the SAME sweep: dead-heartbeat hosts,
            # the inventory view, and the health gate in one observation
            return self._maybe_resize(stats)
        except Exception as e:
            log.error("job %s: resize tick: %s", self.fullname, e)
            return None

    def _maybe_detect_stragglers(self, stats: Dict[int, dict]) -> None:
        """Straggler tick: aggregate per-host step/phase heartbeats,
        export the skew gauges, and raise a ``StragglerDetected``
        condition + Warning Event NAMING the divergent pod when one
        host's step time stays past the threshold (all hysteresis
        lives in :class:`k8s_tpu_torch.obs.straggler.StragglerDetector`).
        On a fresh verdict the operator also auto-captures a profiler
        trace from the named host (``/debug/profile``), so the Event
        points at evidence, not just a pod name."""
        from k8s_tpu_torch.controller import metrics

        obs = self.job.spec.observability
        wset = self._worker_set()
        if wset is None:
            return
        if self._straggler_detector is None:
            from k8s_tpu_torch.obs.straggler import StragglerDetector

            self._straggler_detector = StragglerDetector(
                threshold=obs.straggler_threshold if obs else 1.5,
                consecutive=obs.straggler_steps if obs else 3,
                clock=self.clock,
            )
        verdict = self._straggler_detector.observe(stats)
        job_lbl = {"job": self.fullname}
        metrics.OBS_STEP_SKEW.set(verdict.skew_s, job_lbl)
        for host, hb in stats.items():
            host_lbl = {"job": self.fullname, "host": str(host)}
            metrics.OBS_HOST_STEP_TIME.set(
                float(hb.get("step_time_s", 0.0) or 0.0), host_lbl)
            for phase, secs in (hb.get("phases_s") or {}).items():
                metrics.OBS_PHASE_SECONDS.set(
                    float(secs), {**host_lbl, "phase": str(phase)})
        if verdict.new_straggler is not None:
            idx = verdict.new_straggler
            pod = wset.job_name(idx)
            reason = (
                f"host {idx} ({pod}) busy step time "
                f"{verdict.step_times.get(idx, 0.0):.3f}s vs gang median "
                f"{verdict.median_s:.3f}s (x{verdict.ratio:.2f} over "
                f"{verdict.streak} consecutive steps)"
            )
            profile_s = (obs.straggler_profile_seconds
                         if obs is not None else 0.0)
            if profile_s > 0:
                # evidence attached: the Event names where the profiler
                # trace will land; the capture itself runs off-tick (it
                # blocks for profile_s) and reports completion as its
                # own StragglerProfile Event
                reason += (f"; capturing a {profile_s:g}s device profile "
                           f"from {pod} (/debug/profile -> "
                           f"flightRecorderDir)")
                self._capture_straggler_profile(idx, profile_s)
            metrics.OBS_STRAGGLERS.inc(job_lbl)
            self.status.append_condition("StragglerDetected", reason=reason)
            log.warning("job %s: straggler detected: %s",
                        self.fullname, reason)
            self._record_event("StragglerDetected", reason, etype="Warning")
        if verdict.cleared is not None:
            pod = wset.job_name(verdict.cleared)
            reason = (f"host {verdict.cleared} ({pod}) back within "
                      f"x{self._straggler_detector.threshold:.2f} of the "
                      f"gang median")
            self.status.append_condition("StragglerCleared", reason=reason)
            self._record_event("StragglerCleared", reason)

    def _http_profile_trigger(self, host: int,
                              seconds: float) -> Optional[dict]:
        """Default profile capture: GET the named host's obs endpoint
        ``/debug/profile`` (stable per-index Service DNS on a real
        cluster). Blocks for ~``seconds`` — callers run it off-tick."""
        import json as _json
        import urllib.request

        obs = self.job.spec.observability
        wset = self._worker_set()
        if obs is None or not obs.obs_port or wset is None:
            return None
        url = (f"http://{wset.job_name(host)}:{obs.obs_port}"
               f"/debug/profile?seconds={seconds:g}")
        try:
            with urllib.request.urlopen(url, timeout=seconds + 10) as r:
                return _json.loads(r.read())
        except Exception:
            return None

    def _capture_straggler_profile(self, host: int, seconds: float) -> None:
        """Kick off the straggler auto-profile in a daemon thread (the
        capture blocks for the trace window — never the reconcile
        tick) and report the captured trace path as a
        ``StragglerProfile`` Event. Best-effort end to end: a dead obs
        endpoint degrades the evidence, never the tick."""
        trigger = self.profile_trigger or self._http_profile_trigger

        def run():
            try:
                result = trigger(host, seconds)
            except Exception as e:
                log.warning("job %s: straggler profile capture: %s",
                            self.fullname, e)
                return
            if result and result.get("ok"):
                self._record_event(
                    "StragglerProfile",
                    f"device profile of host {host} captured: "
                    f"{result.get('dir')} ({seconds:g}s)")
            else:
                log.warning(
                    "job %s: straggler profile of host %d failed: %s",
                    self.fullname, host,
                    (result or {}).get("error", "unreachable"))

        threading.Thread(target=run, daemon=True,
                         name=f"straggler-profile-{self.name}").start()

    # ------------------------------------------------------------ health

    def _maybe_memory_pressure(self, stats: Dict[int, dict]) -> None:
        """HBM-pressure tick: heartbeats carry per-host device
        ``memory_stats`` aggregates (``hbm.peak_fraction``); crossing
        ``observability.memoryPressureFraction`` raises one
        ``MemoryPressure`` condition + Warning Event per host episode —
        the warning shot BEFORE the first allocation failure kills the
        gang. Hosts without the block (CPU backends) are skipped.
        NB the allocator peak is a process-lifetime high-water mark
        (monotone), so an episode re-arms only when the observed peak
        DROPS — i.e. the host's process restarted and its allocator
        reset; within one process generation the warning fires once."""
        from k8s_tpu_torch.controller import metrics

        obs = self.job.spec.observability
        fraction = (obs.memory_pressure_fraction if obs is not None
                    else 0.9)
        wset = self._worker_set()
        for host, hb in stats.items():
            hbm = hb.get("hbm")
            if not isinstance(hbm, dict):
                continue
            peak = float(hbm.get("peak_fraction", 0.0) or 0.0)
            if peak >= fraction and host not in self._memory_pressure_hosts:
                self._memory_pressure_hosts.add(host)
                pod = wset.job_name(host) if wset is not None else str(host)
                # peak_fraction is per-DEVICE (worst device's peak over
                # ITS limit) — the evidence bytes must come from that
                # device, not the host aggregate (max peak over summed
                # limits would contradict the percentage)
                worst = max(
                    (d for d in (hbm.get("devices") or [])
                     if d.get("bytes_limit", 0) > 0),
                    key=lambda d: d["peak_bytes_in_use"] / d["bytes_limit"],
                    default=None)
                evidence = (
                    f"; device {worst['device']}: "
                    f"{worst['peak_bytes_in_use']} / "
                    f"{worst['bytes_limit']} bytes"
                ) if worst else ""
                reason = (
                    f"host {host} ({pod}) HBM peak at {peak:.0%} of "
                    f"device capacity (threshold {fraction:.0%}"
                    f"{evidence})"
                )
                metrics.OBS_MEMORY_PRESSURE.inc(
                    {"job": self.fullname, "host": str(host)})
                self.status.append_condition("MemoryPressure",
                                             reason=reason)
                log.warning("job %s: %s", self.fullname, reason)
                self._record_event("MemoryPressure", reason,
                                   etype="Warning")
            elif peak < fraction:
                self._memory_pressure_hosts.discard(host)

    def _maybe_monitor_health(self, stats: Dict[int, dict]) -> Optional[str]:
        """Numerics tick: feed the freshest ``step_health`` block off
        the gang heartbeats (the values are global/replicated — any
        host's copy is authoritative) into the
        :class:`k8s_tpu_torch.obs.health.HealthMonitor` and act per
        ``observability.onDivergence``:

        - ``restart``: stamp the restore ceiling (last HEALTHY step),
          account the discarded steps, and gang-restart — the recreated
          pods carry ``KTPU_CKPT_RESTORE_MAX_STEP`` so the planner
          restores strictly before the divergence. Counts against
          ``maxGangRestarts`` (a run that re-diverges every restart
          must eventually fail, not loop forever); deliberately NOT
          held by the restart backoff — a diverged gang makes zero
          progress, so waiting buys nothing.
        - ``halt``: tear the gang down (stop burning the reservation)
          and fail the job.
        - ``none``: condition + Warning Event only.

        Returns ``"restarted"`` / ``"exhausted"`` / ``"halt"`` for
        reconcile, or None."""
        from k8s_tpu_torch.controller import metrics

        obs = self.job.spec.observability
        blocks = [hb.get("health") for hb in stats.values()
                  if isinstance(hb.get("health"), dict)]
        if not blocks:
            return None
        if self._health_monitor is None:
            from k8s_tpu_torch.obs.health import HealthMonitor

            self._health_monitor = HealthMonitor(clock=self.clock)
        block = max(blocks, key=lambda b: int(b.get("step", -1) or -1))
        verdict = self._health_monitor.observe(block)
        job_lbl = {"job": self.fullname}

        if (
            self.restore_ceiling is not None
            and verdict.fresh and not verdict.diverged
            and verdict.observed_step > self.restore_ceiling
        ):
            reason = (f"trained past the divergence restore ceiling "
                      f"(step {verdict.observed_step} > "
                      f"{self.restore_ceiling}) with healthy numerics")
            self.restore_ceiling = None
            self.status.append_condition("TrainingRecovered",
                                         reason=reason)
            self._record_event("TrainingRecovered", reason)

        if verdict.new_warning is not None:
            metrics.OBS_NUMERICS_WARNINGS.inc(
                {**job_lbl, "kind": verdict.new_warning})
            self.status.append_condition("NumericsWarning",
                                         reason=verdict.reason)
            log.warning("job %s: numerics warning: %s",
                        self.fullname, verdict.reason)
            self._record_event("NumericsWarning", verdict.reason,
                               etype="Warning")

        if not verdict.new_divergence:
            return None
        # goodput: the steps whose work the recovery will discard —
        # gang progress at verdict time past the last healthy step
        progress = max(
            [int(hb.get("step", 0) or 0) for hb in stats.values()]
            + [verdict.observed_step])
        ceiling = (verdict.last_healthy_step
                   if verdict.last_healthy_step is not None else 0)
        discarded = max(0, progress - ceiling)
        metrics.OBS_DIVERGED_STEPS.inc(job_lbl, by=float(discarded))
        policy = obs.on_divergence if obs is not None else "none"
        reason = (
            f"{verdict.reason}; first bad step "
            f"{verdict.first_bad_step}, ~{discarded} steps discarded "
            f"(policy: {policy})"
        )
        self.status.append_condition("TrainingDiverged", reason=reason)
        log.warning("job %s: training diverged: %s", self.fullname, reason)
        self._record_event("TrainingDiverged", reason, etype="Warning")
        if policy == "restart":
            self.restore_ceiling = ceiling
            result = self._force_gang_restart(
                f"TrainingDiverged at step {verdict.first_bad_step}; "
                f"restoring from a checkpoint <= step {ceiling} "
                f"(the last healthy step)")
            # new episode with the observation floor at current
            # progress: the dying gang's stale heartbeats can't re-trip
            # on old evidence, while a fault that RECURS past the floor
            # raises a fresh verdict (bounded by the restart budget)
            self._health_monitor.reset(progress)
            if result == "restarted":
                # counted only when a restart actually happened — a
                # budget-exhausted verdict must not inflate the series
                metrics.OBS_DIVERGENCE_RESTARTS.inc(job_lbl)
            else:
                # budget spent: the job fails, but the alive-and-
                # poisoned gang must STILL be torn down — unlike the
                # degraded-pod exhaustion (pods already dead), these
                # pods would otherwise burn the reservation forever
                self._teardown_gang("divergence budget-exhausted")
            return result
        if policy == "halt":
            self.status.reason = f"training diverged: {reason}"
            # a halted job must FREE the slice, not leave a diverged
            # gang burning the reservation
            self._teardown_gang("halt")
            return "halt"
        return None

    def _teardown_gang(self, why: str) -> None:
        """Best-effort delete of every gang replica set's compute
        (Jobs/Pods; per-index Services stay for DNS stability)."""
        for r in self.replicas:
            if r.is_gang:
                try:
                    r.delete_compute()
                except Exception as e:
                    log.error("job %s: %s teardown: %s",
                              self.fullname, why, e)

    def _force_gang_restart(self, reason: str) -> str:
        """Policy-driven whole-gang restart (the divergence path): the
        pods are alive-but-poisoned, so there is no degraded set — but
        the budget, spacing bookkeeping, and teardown are exactly the
        `_maybe_gang_restart` contract. Returns ``"restarted"`` or
        ``"exhausted"`` (budget spent → the job must fail)."""
        from k8s_tpu_torch.controller import metrics

        if self.status.gang_restarts >= self.job.spec.max_gang_restarts:
            self.status.reason = (
                f"gang restart budget exhausted "
                f"({self.job.spec.max_gang_restarts}) after {reason}")
            return "exhausted"
        self.status.gang_restarts += 1
        bo = self.restart_backoff()
        next_delay = bo.note_failure()
        self.restart_history.append((self.clock(), next_delay))
        metrics.GANG_RESTART_BACKOFF.set(next_delay, {"job": self.fullname})
        self.status.append_condition("GangRestart", reason=reason)
        log.warning(
            "job %s: gang restart %d/%d (%s)", self.fullname,
            self.status.gang_restarts, self.job.spec.max_gang_restarts,
            reason)
        self._record_event(
            "GangRestart",
            f"restarting all gang pods "
            f"({self.status.gang_restarts}/"
            f"{self.job.spec.max_gang_restarts}): {reason}",
            etype="Warning",
        )
        self._teardown_gang("gang restart")
        return "restarted"

    # ------------------------------------------------------------ resize

    def current_dp(self) -> int:
        """The gang's CURRENT data-parallel degree in nodes: the last
        resize's target when one happened, else the gpu block's node
        count."""
        if self.status.dp_degree > 0:
            return self.status.dp_degree
        return self.job.spec.num_nodes()

    def _elastic_resizer(self):
        """The pure decision core, built lazily from ``spec.elastic``
        (docs/ELASTIC.md) on the reconciler's injected clock."""
        el = self.job.spec.elastic
        if el is None or self.job.spec.gpu is None:
            return None
        if self._resizer is None:
            from k8s_tpu_torch.resize import ElasticResizer

            lo, hi = el.bounds(self.job.spec.num_nodes())
            self._resizer = ElasticResizer(
                lo, hi,
                dead_after_s=el.dead_after_seconds,
                grow_hold_s=el.grow_hold_seconds,
                cooldown_s=el.cooldown_seconds,
                resize_on_permanent_loss=el.resize_on_permanent_loss,
                clock=self.clock,
            )
        return self._resizer

    def _attainable_nodes(self) -> Optional[int]:
        """Nodes this job could hold right now (held + pool free) per
        the cluster scheduler's inventory; None without a scheduler —
        the inventory shrink/grow triggers are then disabled and only
        dead-heartbeat shrink fires."""
        if self.capacity_fn is None:
            return None
        try:
            return self.capacity_fn()
        except Exception as e:
            log.warning("job %s: capacity view: %s", self.fullname, e)
            return None

    def _resize_budget_left(self) -> int:
        return self.job.spec.max_gang_restarts - self.status.gang_restarts

    def _maybe_resize(self, stats: Optional[Dict[int, dict]]
                      ) -> Optional[str]:
        """The obs tick's resize check: feed the decision core the
        heartbeat sweep + the inventory view and act on the verdict.
        Runs only in RUNNING phase — a gang mid-restart or mid-resize
        has no heartbeats worth judging."""
        resizer = self._elastic_resizer()
        if resizer is None or self.status.phase != TpuJobPhase.RUNNING:
            return None
        wset = self._worker_set()
        hosts = (wset.spec.replicas or 0) if wset is not None else 0
        verdict = resizer.observe(
            dp=self.current_dp(), hosts=hosts, stats=stats,
            attainable=self._attainable_nodes(),
            budget_left=self._resize_budget_left(),
            health=self._freshest_health(stats),
        )
        return self._act_on_resize(verdict)

    @staticmethod
    def _freshest_health(stats: Optional[Dict[int, dict]]
                         ) -> Optional[dict]:
        """The newest ``step_health`` block off a heartbeat sweep (the
        values are global/replicated — any host's copy is
        authoritative); None when no host carried one."""
        blocks = [hb.get("health") for hb in (stats or {}).values()
                  if isinstance(hb, dict)
                  and isinstance(hb.get("health"), dict)]
        if not blocks:
            return None
        return max(blocks, key=lambda b: int(b.get("step", -1) or -1))

    def _resize_instead_of_restart(self) -> Optional[str]:
        """The gang-restart pre-check: with pods already degraded AND
        the inventory reporting the capacity gone for good, route the
        recovery through shrink (the inventory trigger is decisive —
        no dead-heartbeat window to wait out)."""
        el = self.job.spec.elastic
        resizer = self._elastic_resizer()
        if resizer is None or el is None or not el.resize_on_permanent_loss:
            return None
        attainable = self._attainable_nodes()
        dp = self.current_dp()
        if attainable is None or attainable >= dp:
            return None  # capacity intact: restore in place as always
        wset = self._worker_set()
        hosts = (wset.spec.replicas or 0) if wset is not None else 0
        verdict = resizer.observe(
            dp=dp, hosts=hosts, stats=self._last_worker_stats,
            attainable=attainable,
            budget_left=self._resize_budget_left(),
            # the NaN-crash-plus-revocation case: the degraded-path
            # shrink must carry the health-gated restore ceiling too,
            # off the freshest sweep we have (a NaN step is never the
            # resize restore point on ANY path)
            health=self._freshest_health(self._last_worker_stats),
        )
        return self._act_on_resize(verdict)

    def _act_on_resize(self, verdict) -> Optional[str]:
        if verdict is None or verdict.action is None:
            return None
        if verdict.action == "exhausted":
            self.status.reason = (
                f"gang resize budget exhausted "
                f"({self.job.spec.max_gang_restarts}): {verdict.reason}")
            # the alive-but-unplaceable remainder must stop burning the
            # reservation — same contract as the divergence exhaustion
            self._teardown_gang("resize budget-exhausted")
            return "exhausted"
        return self._begin_resize(verdict)

    def _begin_resize(self, verdict) -> Optional[str]:
        """Drive one resize: ledger re-charge first (atomically frees /
        re-charges nodes — a grow the fleet cannot back is refused
        BEFORE anything is torn down), then the budget-counted
        flush-teardown and the ``Resizing`` transition. The recreated
        gang re-derives its mesh/ZeRO layouts from the new world size
        and the restore planner re-plans across the survivors' + the
        flushed shards (union_covering_plan, docs/CHECKPOINT.md)."""
        from k8s_tpu_torch.controller import metrics

        old = self.current_dp()
        target = int(verdict.target_dp)
        direction = "shrink" if target < old else "grow"
        if self.status.gang_restarts >= self.job.spec.max_gang_restarts:
            self.status.reason = (
                f"gang resize budget exhausted "
                f"({self.job.spec.max_gang_restarts}) before "
                f"DP={old} -> DP={target}")
            self._teardown_gang("resize budget-exhausted")
            return "exhausted"
        if self.on_resize is not None:
            try:
                ok = self.on_resize(self, old, target,
                                    getattr(verdict, "trigger", ""))
            except Exception as e:
                log.error("job %s: resize ledger callback: %s",
                          self.fullname, e)
                ok = False
            if not ok:
                # the ledger refused (a grow raced away, the pool is
                # gone entirely): keep the current shape — the next
                # tick re-decides against the fresh inventory
                log.warning(
                    "job %s: resize DP=%d -> DP=%d refused by the "
                    "scheduler ledger; keeping shape", self.fullname,
                    old, target)
                return None
        # budget + spacing bookkeeping, exactly the divergence-restart
        # contract: a fleet that keeps losing nodes must eventually
        # fail the job, not resize forever
        self.status.gang_restarts += 1
        bo = self.restart_backoff()
        next_delay = bo.note_failure()
        self.restart_history.append((self.clock(), next_delay))
        metrics.GANG_RESTART_BACKOFF.set(next_delay, {"job": self.fullname})
        ceiling_note = ""
        if verdict.restore_ceiling is not None:
            # health gate (docs/OBSERVABILITY.md "Training health"):
            # the freshest numerics are poisoned — the resized gang
            # carries KTPU_CKPT_RESTORE_MAX_STEP so a NaN step is never
            # the resize restore point
            self.restore_ceiling = int(verdict.restore_ceiling)
            ceiling_note = (f"; restore ceiling = step "
                            f"{self.restore_ceiling} (last healthy)")
        cost = self.preemption_cost() if direction == "shrink" else 0
        reason = (
            f"DP={old} -> DP={target}: {verdict.reason} "
            f"(resize {self.status.gang_restarts}/"
            f"{self.job.spec.max_gang_restarts}, ~{cost} steps since the "
            f"last checkpoint at stake{ceiling_note})")
        metrics.RESIZE_TOTAL.inc(
            {"job": self.fullname, "direction": direction})
        if cost > 0:
            metrics.RESIZE_LOST_STEPS.inc(
                {"job": self.fullname}, by=float(cost))
        self.status.append_condition("GangResized", reason=reason)
        log.warning("job %s: gang resize: %s", self.fullname, reason)
        self._record_event(
            "GangResized", reason,
            etype="Warning" if direction == "shrink" else "Normal")
        # flush-teardown: deleting the gang's Jobs/Pods SIGTERMs every
        # surviving process, and the launcher's preemption handler +
        # the program's preemption check flush a forced two-tier save at the
        # current step (health-gated in-process) inside the grace
        # window — the contract preemption already rides
        self._teardown_gang("elastic resize")
        self.status.dp_degree = target
        metrics.RESIZE_DP.set(float(target), {"job": self.fullname})
        self._apply_dp_to_replicas(target)
        resizer = self._elastic_resizer()
        if resizer is not None:
            resizer.note_resized(target)
        # the host set changed: stale per-host episodes must not carry
        # into the new world (the health monitor handles the restored
        # step regression itself)
        self._straggler_detector = None
        self.status.phase = TpuJobPhase.RESIZING
        self.status.state = TpuJobState.RUNNING
        return "resizing"

    def _apply_dp_to_replicas(self, dp: int, sets_exist: bool = True
                              ) -> None:
        """Re-point the WORKER width at ``dp`` nodes (``cards_per_node ×
        dp`` pods, one per card) — both views: the job spec (persisted
        by the next status write) and the live replica-set spec
        (create/snapshot/rendezvous read it)."""
        gpu = self.job.spec.gpu
        t = gpu.topology() if gpu is not None else None
        hosts = (t.cards_per_node if t is not None else 1) * max(1, int(dp))
        w = self.job.spec.replica_spec(WORKER)
        if w is not None:
            w.replicas = hosts
        if sets_exist:
            wset = self._worker_set()
            if wset is not None:
                wset.spec.replicas = hosts

    def _record_event(self, reason: str, message: str,
                      etype: str = "Normal") -> None:
        """Best-effort event write: a transient apiserver error must
        never crash the reconciler over observability — the status
        transition the event describes is what matters, and it persists
        through update_crd_status's own retry-next-tick path."""
        try:
            self.client.record_event(
                self.job.metadata.namespace,
                {"kind": "TpuJob", "name": self.name},
                reason, message, etype=etype,
            )
        except Exception as e:
            log.warning("job %s: event %s dropped: %s", self.fullname, reason, e)

    def update_crd_status(self) -> None:
        """Write status back iff changed (reference updateTPRStatus,
        training.go:331-347)."""
        if self.job.status.to_dict() == self.status.to_dict():
            return
        prev = self.job.status
        self.job.status = self.status.deepcopy()
        try:
            self.job = self.job_client.update(self.job)
        except Exception as e:
            # roll the local mirror back so the diff stays dirty and the
            # next tick retries — overwriting it before a FAILED write
            # made the iff-changed check above see "no change" forever,
            # wedging e.g. a terminal transition the apiserver never saw
            self.job.status = prev
            log.warning("job %s: failed to update CRD status: %s", self.fullname, e)

    # ------------------------------------------------------------ reconcile

    def reconcile(self, config: ControllerConfig) -> None:
        """Reference reconcile (training.go:350-409)."""
        from k8s_tpu_torch.controller import metrics

        metrics.RECONCILES.inc()
        was_terminal = self.status.phase in (TpuJobPhase.DONE, TpuJobPhase.FAILED)
        if self.status.phase in (TpuJobPhase.NONE, TpuJobPhase.QUEUED):
            self.setup(config)
            # Persist runtime_id + CREATING *before* any resource exists,
            # so a crash during create_resources() can't orphan resources
            # under a runtime_id the CRD never saw.
            self.update_crd_status()
        elif not self.replicas and self.job.spec.replica_specs:
            # adopted mid-flight (HA failover / operator restart):
            # setup()'s adoption branch materializes replica sets from
            # the persisted spec without touching phase or runtime_id
            self.setup(config)

        # A job adopted in CLEANUP (operator restarted mid-delete) only
        # needs its resources torn down.
        if self.status.phase == TpuJobPhase.CLEANUP:
            try:
                self.delete_resources()
            except Exception as e:
                log.error("job %s: delete resources: %s", self.fullname, e)
            return

        if self.status.phase in (TpuJobPhase.CREATING, TpuJobPhase.RUNNING,
                                 TpuJobPhase.RESIZING):
            try:
                self.create_resources(config)
            except Exception as e:
                log.error("job %s: create resources: %s", self.fullname, e)
            try:
                snaps = self.snapshots()
                state, replica_statuses = self.get_status(snaps)
            except Exception as e:
                # a transient apiserver error must not kill the reconciler
                # thread — leave status as-is and retry next tick
                log.error("job %s: get status: %s", self.fullname, e)
                return
            # Gang policy runs even when the aggregate state looks FAILED:
            # when a worker dies retryably (e.g. SIGKILL 137), its peers
            # may exit out of dead collectives with code 1 (a gloo or
            # NCCL error the launcher cannot tell from a user's) —
            # collateral, not a user error. If ANY gang index terminated
            # retryably, the gang restart takes precedence; a genuine user error yields exit
            # 1 on all workers with no retryable index and still fails.
            if state in (TpuJobState.RUNNING, TpuJobState.FAILED):
                gang = self._maybe_gang_restart(snaps)
                if gang in ("restarted", "resizing"):
                    # restart: next tick recreates the gang same-shape;
                    # resizing: next tick materializes the new DP
                    # degree's footprint (phase already RESIZING)
                    self.update_crd_status()
                    return
                if gang == "backoff":
                    # restart wanted but held by the schedule: persist
                    # the BackoffRestarting condition and re-check next
                    # tick — the job must NOT be marked Failed off the
                    # degraded pods while the hold-off runs
                    self.update_crd_status()
                    return
                if gang == "exhausted":
                    state = TpuJobState.FAILED
            if (
                state == TpuJobState.RUNNING
                and (self.job.spec.observability is not None
                     or self.worker_stats_fetcher is not None)
            ):
                action = None
                try:
                    # ONE heartbeat sweep: stragglers + HBM pressure +
                    # the training-health monitor (observe → act)
                    action = self._obs_tick()
                except Exception as e:
                    # observability is best-effort — it must never take
                    # down the reconcile tick
                    log.error("job %s: obs tick: %s", self.fullname, e)
                if action in ("restarted", "resizing"):
                    # divergence restart: next tick recreates the gang
                    # with the restore ceiling env; resizing: next tick
                    # materializes the new DP degree's footprint
                    self.update_crd_status()
                    return
                if action in ("halt", "exhausted"):
                    # health/resize verdict says stop: status.reason set
                    state = TpuJobState.FAILED
            self.status.replica_statuses = replica_statuses
            if state == TpuJobState.FAILED:
                self.status.phase = TpuJobPhase.DONE
                self.status.state = TpuJobState.FAILED
            elif state == TpuJobState.SUCCEEDED:
                self.status.phase = TpuJobPhase.DONE
                self.status.state = TpuJobState.SUCCEEDED
            elif self.status.phase in (TpuJobPhase.CREATING,
                                       TpuJobPhase.RESIZING) \
                    and state == TpuJobState.RUNNING:
                running = any(
                    rs.state == ReplicaState.RUNNING for rs in replica_statuses
                )
                if running:
                    self.status.phase = TpuJobPhase.RUNNING

        if not was_terminal and self.status.phase in (
            TpuJobPhase.DONE,
            TpuJobPhase.FAILED,
        ):
            metrics.JOBS_TERMINAL.inc({"state": self.status.state})
            metrics.GANG_RESTART_BACKOFF.set(0.0, {"job": self.fullname})
            self._record_event(
                "Finished",
                f"job reached {self.status.state}",
                etype="Normal" if self.status.state == TpuJobState.SUCCEEDED else "Warning",
            )
            if self.on_terminal is not None:
                # frees the nodes in the cluster scheduler the same
                # tick the job finishes (best-effort: a callback bug
                # must not wedge the terminal transition)
                try:
                    self.on_terminal(self)
                except Exception as e:
                    log.error("job %s: on_terminal callback: %s",
                              self.fullname, e)

        self.update_crd_status()

    # ------------------------------------------------------------ events

    def send(self, typ: str, job: Optional[TpuJob] = None) -> None:
        try:
            self._events.put_nowait((typ, job))
            if self._events.qsize() > int(EVENT_QUEUE_CAP * 0.8):
                log.warning("job %s: event queue almost full", self.fullname)
        except queue.Full:
            log.error("job %s: event queue full, dropping %s", self.fullname, typ)
        self._kick()

    def _kick(self, delay: float = 0.0) -> None:
        """Event-driven mode: wake the shared core for this job's key
        (coalesced by the work queue). No-op in threaded mode — the
        blocking event-queue get is the wakeup there."""
        core = self._core
        if core is not None and not self._exited:
            core.kick(self.job.key, delay)

    def delete(self) -> None:
        """External request to delete (reference Delete, training.go:303-320):
        just queues an event; the run loop does the work."""
        self.send(_EVENT_DELETE)

    def update(self, new_job: TpuJob) -> None:
        self.send(_EVENT_MODIFY, new_job)

    def preempt(self, reason: str = "") -> None:
        """Cluster-scheduler eviction (docs/SCHEDULER.md): queues the
        preempt event; the run loop drives the checkpoint-safe
        teardown and parks the job back in QUEUED."""
        self._preempt_reason = reason
        self.send(_EVENT_PREEMPT)

    def nudge(self) -> None:
        """Ask for an immediate reconcile tick: the controller's answer
        to a change of one of this job's Pods or batch Jobs, and the
        capacity-return tick (a freed node should reach a shrunken
        elastic gang's grow decision now, not next interval)."""
        self.send(_EVENT_NUDGE)

    def preemption_cost(self) -> int:
        """Price this job's eviction for the scheduler: gang progress
        past the last checkpointed step, read from the freshest
        heartbeat sweep (the ``ckpt`` goodput block riding along). No
        checkpointing observed ⇒ every completed step is at stake; no
        heartbeat at all ⇒ 0 (unknown progress is priced cheap — the
        job is young or unobservable, either way the eviction discards
        little we can *prove*)."""
        stats = self._last_worker_stats or {}
        best, saved = -1, -1
        for hb in stats.values():
            if not isinstance(hb, dict):
                continue
            try:
                best = max(best, int(hb.get("step", 0) or 0))
            except (TypeError, ValueError):
                pass
            ck = hb.get("ckpt")
            if isinstance(ck, dict):
                try:
                    saved = max(saved, int(ck.get("last_saved_step", -1)))
                except (TypeError, ValueError):
                    pass
        if best < 0:
            return 0
        if saved < 0:
            return best
        return max(0, best - saved)

    def _handle_preempt(self) -> None:
        """The victim side of a preemption: condition + Warning Event
        naming the preemptor, then the checkpoint-safe teardown —
        deleting the gang's Jobs/Pods SIGTERMs every process, and the
        launcher's preemption handler + ``maybe_preempt_exit`` flush a
        forced two-tier save (gated by the health check, so a NaN step
        is never flushed) inside the grace period (exit 143). Per-index
        Services stay, so the re-admitted gang keeps its DNS. The job
        parks in QUEUED with its checkpoint on disk: it loses steps,
        never its checkpoint."""
        if self.finished:
            return  # raced a terminal transition; nothing to evict
        reason = (self._preempt_reason
                  or "preempted by the cluster scheduler")
        self.status.append_condition("Preempted", reason=reason)
        log.warning("job %s: preempted: %s", self.fullname, reason)
        self._record_event("Preempted", reason, etype="Warning")
        for r in self.replicas:
            try:
                r.delete_compute()
            except Exception as e:
                log.error("job %s: preemption teardown: %s",
                          self.fullname, e)
        self.status.phase = TpuJobPhase.QUEUED
        self.status.state = TpuJobState.RUNNING
        self.update_crd_status()

    # ------------------------------------------------------------ run loop

    def attach_core(self, core, resync_seconds: float = 300.0) -> None:
        """Switch this job to event-driven mode BEFORE start(): it will
        register with the shared :class:`ReconcilerCore` instead of
        spawning a thread (docs/SCHEDULER.md "Event-driven core")."""
        self._core = core
        self.resync_seconds = resync_seconds

    def start(self, config: ControllerConfig, reconcile_interval: float = RECONCILE_INTERVAL):
        self._config = config
        self._interval = reconcile_interval
        if self._core is not None:
            # event-driven: no thread — register the handler and kick
            # the first pass; the returned requeue delay paces the rest
            self._core.register(self.job.key, self._process)
            self._core.kick(self.job.key)
            return None
        self._thread = threading.Thread(
            target=self.run, args=(config, reconcile_interval), daemon=True,
            name=f"trainingjob-{self.name}",
        )
        self._thread.start()
        return self._thread

    def stop(self) -> None:
        self._stop.set()
        # event-driven: the next pass observes the flag and exits; kick
        # so "the next pass" is now, not at the resync backstop
        self._kick()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._core is not None:
            # quiesce barrier: any in-flight pass for this key finishes
            # (the respawn path's safety — no concurrent status writers)
            self._core.wait_idle(self.job.key,
                                 timeout if timeout is not None else 10.0)
            return
        if self._thread is not None:
            self._thread.join(timeout)

    def is_alive(self) -> bool:
        """True while the reconciler runs — a live thread (threaded
        mode) or a registered, not-yet-exited core handler (event-
        driven mode). False for a preempted/queued job whose loop has
        exited — its events would go nowhere, so callers must act
        inline instead."""
        if self._core is not None:
            return not self._exited
        return self._thread is not None and self._thread.is_alive()

    # ------------------------------------------------- event-driven mode

    def _process(self) -> Optional[float]:
        """One pass through the shared core: drain pending events, then
        reconcile once; the return value is the requeue delay (None =
        stay quiescent until the next event/kick). The work-queue's
        processing set serializes passes per key, so this body needs no
        more locking than the threaded loop had."""
        config = self._config or ControllerConfig()
        while True:
            if self._stop.is_set():
                self._finish_core()
                return None
            try:
                typ, _new = self._events.get_nowait()
            except queue.Empty:
                break
            if typ == _EVENT_DELETE:
                log.info("TpuJob %s deleted by the user", self.fullname)
                self.status.phase = TpuJobPhase.CLEANUP
                self.update_crd_status()
                try:
                    self.delete_resources()
                except Exception as e:
                    log.error("job %s: deleteResources error: %s",
                              self.fullname, e)
                self._finish_core()
                return None
            if typ == _EVENT_PREEMPT:
                # checkpoint-safe eviction: flush-teardown, park in
                # QUEUED, and RETIRE the handler — the controller
                # registers a fresh one on re-admission
                self._handle_preempt()
                self._finish_core()
                return None
            if typ == _EVENT_MODIFY and _new is not None:
                self._handle_modify(_new)
            # nudges fall through: the reconcile below is the response
        self._safe_reconcile(config)
        if self._stop.is_set():
            self._finish_core()
            return None
        return self._requeue_delay()

    def _finish_core(self) -> None:
        self._exited = True
        if self._core is not None:
            self._core.deregister(self.job.key)

    def _requeue_delay(self) -> Optional[float]:
        """The event-driven requeue policy — what replaces the fixed
        ticker. Transitional phases poll fast (pod transitions also
        kick via the informer); jobs with genuine periodic needs
        (obs sweeps, elastic windows) keep the
        reconcile_interval cadence; a quiescent RUNNING job costs
        nothing until the slow resync backstop. A restart held by the
        gang backoff requeues exactly when the hold expires."""
        if self._exited or self._stop.is_set():
            return None
        if self.finished:
            return None  # terminal: events (delete) still kick the key
        interval = self._interval
        phase = self.status.phase
        if phase in (TpuJobPhase.NONE, TpuJobPhase.QUEUED,
                     TpuJobPhase.CREATING, TpuJobPhase.RESIZING):
            return min(interval, 1.0)
        if phase == TpuJobPhase.CLEANUP:
            return interval
        if self._backoff_waiting:
            return min(interval,
                       max(0.05, self.restart_backoff().remaining()))
        if self.job.status.to_dict() != self.status.to_dict():
            # a status write failed and rolled back: retry soon, not
            # at the resync backstop
            return min(interval, 1.0)
        spec = self.job.spec
        needs_poll = (spec.observability is not None
                      or spec.elastic is not None
                      or self.worker_stats_fetcher is not None)
        if needs_poll:
            return interval
        informer = getattr(self.client, "informer", None)
        if informer is None or not informer.synced:
            return interval  # no event feed: keep the polling cadence
        return max(interval, self.resync_seconds)

    def run(self, config: ControllerConfig, reconcile_interval: float = RECONCILE_INTERVAL):
        """Reference run loop (training.go:412-456): select over
        {event queue, stop, ticker}.

        A tick that raises (a transient apiserver error surfacing
        through an unguarded read) must NOT kill the reconciler thread
        — the job would silently never reach a terminal phase. The
        ticker itself paces the retry."""
        self._safe_reconcile(config)
        while not self._stop.is_set():
            try:
                typ, _new = self._events.get(timeout=reconcile_interval)
            except queue.Empty:
                self._safe_reconcile(config)
                continue
            if typ == _EVENT_DELETE:
                log.info("TpuJob %s deleted by the user", self.fullname)
                self.status.phase = TpuJobPhase.CLEANUP
                self.update_crd_status()
                try:
                    self.delete_resources()
                except Exception as e:
                    log.error("job %s: deleteResources error: %s", self.fullname, e)
                return
            if typ == _EVENT_PREEMPT:
                # checkpoint-safe eviction: flush-teardown, park in
                # QUEUED, and EXIT the reconciler — the controller
                # spawns a fresh one on re-admission
                self._handle_preempt()
                return
            if typ == _EVENT_NUDGE:
                self._safe_reconcile(config)
                continue
            if typ == _EVENT_MODIFY and _new is not None:
                self._handle_modify(_new)

    def _safe_reconcile(self, config: ControllerConfig) -> None:
        sem = self.reconcile_limiter
        try:
            if sem is not None:
                # O(100) hygiene: concurrent reconcile ticks share a
                # bounded worker pool — each job keeps its thread (and
                # its event queue stays responsive), but only N ticks
                # touch the apiserver/informer at once
                with sem:
                    self.reconcile(config)
            else:
                self.reconcile(config)
        except Exception as e:
            log.error("job %s: reconcile tick failed (%s); next tick retries",
                      self.fullname, e)

    def _handle_modify(self, new_job: TpuJob) -> None:
        """Spec-change policy for MODIFIED events. The reference left
        this a TODO and silently ignored edits (controller.go:154-159)
        — the one place matching it would preserve a known hole. Here:

        - ``maxGangRestarts`` is MUTABLE: the fault budget may be
          raised/lowered on a live job (a safe, reconciler-only knob).
        - Everything else (replicas, templates, topology) is immutable
          once running — resizing a TPU gang means new rendezvous info
          for every process, i.e. a new job. Rejected LOUDLY with a
          Warning event, and the stored spec is REVERTED to the running
          configuration (the status write below carries the whole
          object), so `kubectl get` never shows a spec the gang isn't
          actually running — with no admission webhook, revert-and-warn
          is the next-strongest enforcement.

        Self-inflicted MODIFIED events (our own status writes) diff as
        empty and fall through without noise. STALE events — a replayed
        write from before our latest round-trip, e.g. the controller's
        own Queued-phase write landing after the admitted reconciler
        already defaulted the spec — are dropped on resourceVersion:
        diffing against a snapshot older than what we wrote would
        misread our own defaulting as a user edit and churn a spurious
        SpecChangeRejected.
        """
        try:
            ours = int(self.job.metadata.resource_version or 0)
            theirs = int(new_job.metadata.resource_version or 0)
            # <= spawn rv: the very snapshot (or older) this reconciler
            # was built from; < ours: predates our latest round-trip
            if theirs and (theirs <= self._spawn_rv
                           or (ours and theirs < ours)):
                return
        except (TypeError, ValueError):
            pass  # non-numeric RVs (a real apiserver): fall through
        old_d = self.job.spec.to_dict()
        new_d = new_job.spec.to_dict()
        if new_d.get("maxGangRestarts") != old_d.get("maxGangRestarts"):
            log.info(
                "job %s: maxGangRestarts %s -> %s", self.fullname,
                self.job.spec.max_gang_restarts,
                new_job.spec.max_gang_restarts,
            )
            self.job.spec.max_gang_restarts = new_job.spec.max_gang_restarts
            old_d = self.job.spec.to_dict()
        if new_d == old_d:
            # either the user reverted, or this is the self-inflicted
            # MODIFIED from our own revert write — do NOT clear the
            # dedupe state here: a GitOps loop re-applying the same bad
            # spec every sync interleaves self-events between applies,
            # and clearing would make every apply loud again (churning
            # the 10-deep condition ring). The time window below re-arms
            # reporting instead.
            return
        import time as _time

        now = _time.monotonic()
        if self._rejected_spec == new_d and \
                now - self._rejected_at < REJECTION_REPORT_INTERVAL:
            # same attempted spec within the window: revert the store
            # again (quietly) so it keeps matching reality
            self._revert_spec()
            return
        self._rejected_spec = new_d
        self._rejected_at = now
        changed = sorted(
            k for k in set(old_d) | set(new_d)
            if old_d.get(k) != new_d.get(k)
        )
        log.warning(
            "job %s: rejecting immutable spec change: %s",
            self.fullname, changed,
        )
        self.status.append_condition(
            "SpecChangeRejected", reason=f"immutable fields: {changed}"
        )
        self._record_event(
            "SpecChangeRejected",
            f"spec fields {changed} are immutable on a running job; "
            "reverting to the running configuration — delete and "
            "recreate to resize",
            etype="Warning",
        )
        # persists the condition AND reverts the stored spec (the write
        # carries self.job, whose spec is the running one)
        self.update_crd_status()

    def _revert_spec(self) -> None:
        try:
            self.job = self.job_client.update(self.job)
        except Exception as e:
            log.warning("job %s: spec revert failed: %s", self.fullname, e)

    @property
    def finished(self) -> bool:
        return self.status.phase in (TpuJobPhase.DONE, TpuJobPhase.FAILED)
