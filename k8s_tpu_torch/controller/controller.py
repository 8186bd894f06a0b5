"""The operator controller: CRD registration, watch loop, dispatch
(the port's copy of ``k8s_tpu/controller/controller.py``, with the
elastic resize's ledger hooks counted in GPU nodes, and without the
chaos monkey's forced preemption of a later slice, ROADMAP A12.6).

Analogue of reference ``pkg/controller/controller.go``: holds the live
job map (:46-61); ``run()`` = init-resource with retry (:86-96) + the
event pump with a per-event watchdog (:109-119); Added → new
TrainingJob thread, Deleted → ``Delete()``, Modified forwarded but not
acted on (:123-170); ``find_all_jobs`` re-adopts existing jobs on
startup (:172-201) so an operator crash/restart is seamless; CRD
create + established wait (:234-286); watch staleness (410 Gone) →
``OutdatedVersionError`` → relist and re-watch (:292-376).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

from k8s_tpu_torch.api import errors
from k8s_tpu_torch.api.client import KubeClient
from k8s_tpu_torch.api.crd_client import TpuJobClient
from k8s_tpu_torch import utils
from k8s_tpu_torch.controller.reconciler import ReconcilerCore
from k8s_tpu_torch.controller.watchdog import PanicTimer
from k8s_tpu_torch.trainer.labels import JOB_NAME_LABEL
from k8s_tpu_torch.robustness.backoff import Backoff, BackoffPolicy
from k8s_tpu_torch.sched import (
    ClusterScheduler,
    JobRequest,
    PoolTopology,
    Preemption,
    SliceInventory,
    TickResult,
    footprint_of,
)
from k8s_tpu_torch.spec import ControllerConfig, TpuJob, TpuJobPhase
from k8s_tpu_torch.trainer.training import TrainingJob

log = logging.getLogger(__name__)

INIT_RETRY_WAIT = 30.0  # reference controller.go:33
WATCHDOG_DEADLINE = 60.0  # reference controller.go:110
# Event-driven mode's scheduler-tick backstop: every job/capacity
# delta kicks a tick explicitly, so the periodic pass is demoted from
# sched_interval (1s) to a slow catch-all for anything a kick missed.
SCHED_BACKSTOP_SECONDS = 30.0

# Requeue schedule for the controller's outer loop: init failures,
# relist-after-410, and pump crashes all hold off through this (capped
# at the reference's fixed 30s init wait, which it replaces).
REQUEUE_POLICY = BackoffPolicy(
    base=0.5, factor=2.0, cap=INIT_RETRY_WAIT, jitter=0.5, reset_after=120.0
)


def _dp_footprint(fp, dp: int):
    """A gang footprint rescaled to ``dp`` nodes, preserving its own
    cards-per-node ratio — the ONE way an elastic gang's charge is
    derived at any width (pricing, re-admission, resize re-charge), so
    the ledger can never see two inconsistent derivations of the same
    job (docs/ELASTIC.md)."""
    per_node = fp.chips // max(1, fp.slices)
    return type(fp)(fp.accelerator, slices=dp, chips=dp * per_node)


class Controller:
    def __init__(
        self,
        client: KubeClient,
        job_client: TpuJobClient,
        config: Optional[ControllerConfig] = None,
        namespace: Optional[str] = None,
        reconcile_interval: float = 8.0,
        watchdog_deadline: float = WATCHDOG_DEADLINE,
        sched_interval: float = 1.0,
    ):
        self.client = client
        self.job_client = job_client
        self.config = config or ControllerConfig()
        # refused here, at controller start: the native supervisor is a
        # later slice; a fleet key must name one of the port's GPUs
        self.config.check_ported()
        self.namespace = namespace
        self.reconcile_interval = reconcile_interval
        self.watchdog_deadline = watchdog_deadline
        self.jobs: Dict[str, TrainingJob] = {}  # reference jobs map, :46-61
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._owns_informer = False
        self._informer_sampler = None
        # Cluster scheduler (docs/SCHEDULER.md): ON iff the controller
        # config declares an accelerator fleet. With it on, jobs enter
        # QUEUED and a reconciler only spawns on admission; with it off
        # (the default empty fleet) every path below is byte-for-byte
        # today's start-immediately behavior.
        self.sched_interval = sched_interval
        self.scheduler: Optional[ClusterScheduler] = None
        if self.config.fleet:
            # fleet entries with a topology block get named nodes under
            # leaf switches; the placement scorer packs them only under
            # the backfill+pack policy (docs/SCHEDULER.md "Placement")
            policy = self.config.scheduler_policy
            topology = {
                accel: PoolTopology(int(shape[0]), int(shape[1]))
                for accel, shape in self.config.fleet_topology.items()
            }
            self.scheduler = ClusterScheduler(
                SliceInventory(self.config.fleet,
                               topology=topology,
                               packing=policy == "backfill+pack"),
                quotas=self.config.scheduler_quotas,
                cost_fn=self._preemption_cost,
                preemption_cooldown=self.config.scheduler_cooldown_seconds,
                backfill=policy in ("backfill", "backfill+pack"),
            )
            # capacity-return tick: a freed node nudges every elastic
            # gang's reconciler so grow decisions land within a tick,
            # not a polling interval
            self.scheduler.inventory.on_capacity(self._on_capacity_return)
        self._sched_lock = threading.RLock()
        self._sched_thread: Optional[threading.Thread] = None
        # key → blocked category last written into its Queued condition
        # (diagnosability): a condition is appended only when the WHY
        # changes, never per tick — a parked job must not accrete a
        # thousand identical conditions
        self._blocked_surfaced: Dict[str, str] = {}
        # dedup "kick" for the event-driven scheduler tick: a burst of
        # job deltas (N completions, a mass delete) wakes the tick loop
        # ONCE instead of running N full scheduler passes
        self._sched_kick_pending = threading.Event()
        # Event-driven reconciler core (docs/SCHEDULER.md "Event-driven
        # core", default ON): one informer-fed coalescing work queue
        # drained by a bounded worker pool replaces the thread-per-job
        # loops; reconciles fire on events + rate-limited requeues.
        core_workers = self.config.reconcile_workers
        if self.config.max_concurrent_reconciles:
            # the legacy concurrency knob stays meaningful in event
            # mode: it caps the worker pool
            core_workers = min(core_workers,
                               self.config.max_concurrent_reconciles)
        self.core: Optional[ReconcilerCore] = (
            ReconcilerCore(workers=core_workers)
            if self.config.event_driven else None)
        self._informer_listener = None
        # O(100) hygiene (LEGACY threaded mode only): one shared
        # semaphore bounds concurrent reconcile ticks across every
        # TrainingJob thread (0 = off); the core's worker pool subsumes
        # it in event-driven mode
        n = self.config.max_concurrent_reconciles
        self._reconcile_limiter = (
            threading.BoundedSemaphore(n)
            if n and n > 0 and self.core is None else None)
        # test/e2e seam: build a per-job worker-stats fetcher (the
        # heartbeat source preemption pricing reads) for reconcilers
        # the CONTROLLER spawns — outside a cluster there is no
        # Service DNS for the default HTTP fetcher to resolve
        self.worker_stats_fetcher_factory = None

    # ------------------------------------------------------------ bootstrap

    def init_resource(self) -> int:
        """Create the CRD if needed and wait Established (reference
        initResource + createCRD, controller.go:213-286). Returns the
        resourceVersion to start watching from."""
        if self.client.informer is None:
            # the informer replaces the reference's per-tick polling
            # (SURVEY §7.2 #4): one watch stream per kind, reconcilers
            # read the cache — not O(replicas) GETs every 8s
            inf = self.client.start_informer(namespace=self.namespace)
            self._owns_informer = True

            from k8s_tpu_torch.controller import metrics

            stopped = threading.Event()
            sample_lock = threading.Lock()

            def sample_informer(inf=inf, stopped=stopped,
                                lock=sample_lock):
                # the lock serializes the sampler body against stop()'s
                # gauge reset: without it a scrape that passed the flag
                # check could finish its writes AFTER the reset and
                # leave a dead informer reported synced forever (the
                # sampler is removed, so nothing would correct it)
                with lock:
                    if stopped.is_set():
                        metrics.INFORMER_SYNCED.set(0.0)
                        metrics.INFORMER_OBJECTS.clear()
                        return
                    for kind, cache in inf.caches.items():
                        with cache.lock:
                            n = len(cache.objects)
                        metrics.INFORMER_OBJECTS.set(
                            float(n), {"kind": kind})
                    metrics.INFORMER_SYNCED.set(
                        1.0 if inf.synced else 0.0)

            self._informer_sampler = sample_informer
            self._informer_sampler_stopped = stopped
            self._informer_sampler_lock = sample_lock
            metrics.REGISTRY.on_collect(sample_informer)
        if self.core is not None:
            self.core.start()
            inf = self.client.informer
            if inf is not None and self._informer_listener is None:
                # informer-fed kicks: a Pod/Job delta for an owned job
                # wakes exactly that job's reconcile key — how a
                # quiescent job learns its gang finished without a poll
                self._informer_listener = self._on_informer_event
                inf.add_listener(self._informer_listener)
        try:
            self.job_client.create_crd_definition()
        except errors.AlreadyExistsError:
            pass
        utils.retry(0.5, 120, self.job_client.crd_established)
        rv = self.find_all_jobs()
        self._ensure_sched_loop()
        return rv

    def find_all_jobs(self) -> int:
        """Adopt pre-existing TpuJobs (reference findAllTfJobs,
        controller.go:172-201): resource creation is idempotent, so
        re-adopting a live job is safe."""
        rv = self.client.cluster.resource_version
        for job in self.job_client.list(self.namespace):
            if job.status.is_failed():
                log.warning("ignoring failed job %s", job.key)
                continue
            if job.key not in self.jobs:
                self._start_job(job)
        return rv

    # ------------------------------------------------------------ dispatch

    def _start_job(self, job: TpuJob) -> None:
        """Entry for a newly-seen job (watch ADDED / startup adoption).
        Without a scheduler this spawns the reconciler immediately
        (reference behavior). With one (``config.fleet`` non-empty) the
        scheduler is consulted first: NONE-phase jobs park in QUEUED
        until admitted; already-materialized jobs (operator restart)
        are adopted straight into the ledger — a restart must never
        re-queue a gang that is physically running."""
        if self.scheduler is None:
            self._spawn_reconciler(job)
            return
        phase = job.status.phase
        if phase == TpuJobPhase.QUEUED:
            # re-adopted queued job (operator restart): back in line,
            # original status already says Queued
            self.scheduler.submit(self._request_for(job))
        elif phase == TpuJobPhase.NONE:
            self._submit_queued(job)
        elif phase in (TpuJobPhase.CREATING, TpuJobPhase.RUNNING,
                       TpuJobPhase.CLEANUP):
            self.scheduler.adopt_running(self._request_for(job))
            self._spawn_reconciler(job)
        else:  # terminal phases: reconciler handles bookkeeping, no charge
            self._spawn_reconciler(job)
        self._sched_kick()

    def _spawn_reconciler(self, job: TpuJob) -> bool:
        from k8s_tpu_torch.controller import metrics

        old = self.jobs.get(job.key)
        if old is not None:
            # re-admission after preemption: the previous reconciler
            # exited when it parked the job in QUEUED — quiesce it
            # before the fresh one takes the key (two reconcilers on
            # one job would race every status write)
            old.stop()
            old.join(timeout=10)
            if old.is_alive():
                # still tearing down (e.g. deletes stuck behind an
                # apiserver brown-out): spawning now would put two
                # reconcilers on one job — refuse; the caller re-queues
                log.error("job %s: previous reconciler still alive "
                          "after stop; deferring respawn", job.key)
                return False
        tj = TrainingJob(self.client, self.job_client, job)
        tj.reconcile_limiter = self._reconcile_limiter
        if self.core is not None:
            tj.attach_core(self.core, self.config.resync_seconds)
        if self.scheduler is not None:
            tj.on_terminal = self._on_job_terminal
            # elastic resize: the reconciler's inventory view + the
            # atomic ledger re-charge
            tj.capacity_fn = (
                lambda key=job.key: self._attainable_nodes(key))
            tj.on_resize = self._on_job_resize
        if self.worker_stats_fetcher_factory is not None:
            try:
                tj.worker_stats_fetcher = \
                    self.worker_stats_fetcher_factory(tj)
            except Exception as e:
                log.warning("job %s: stats fetcher factory: %s",
                            job.key, e)
        self.jobs[job.key] = tj
        tj.start(self.config, self.reconcile_interval)
        metrics.JOBS_STARTED.inc()
        metrics.LIVE_JOBS.set(len(self.jobs))
        self.client.record_event(
            job.metadata.namespace,
            {"kind": "TpuJob", "name": job.metadata.name},
            "Started",
            f"reconciler started for {job.key}",
        )
        return True

    # ------------------------------------------------------------ scheduler

    def _request_for(self, job: TpuJob) -> JobRequest:
        s = job.spec.scheduling
        priority = 0
        queue = "default"
        preemptible = True
        estimate = 0.0
        if s is not None:
            try:
                priority = int(s.priority)
            except (TypeError, ValueError):
                priority = 0  # validation rejects it properly at setup
            queue = s.queue or "default"
            preemptible = bool(s.preemptible)
            try:
                estimate = max(
                    0.0, float(s.runtime_estimate_seconds or 0.0))
            except (TypeError, ValueError):
                estimate = 0.0
        fp = footprint_of(job.spec)
        dp = job.status.dp_degree or 0
        if dp > 0 and job.spec.elastic is not None and not fp.empty:
            # a resized elastic gang is priced at its CURRENT width
            # (status.dp_degree), not the gpu block's node count —
            # re-admission/adoption must charge what the reconciler
            # will actually materialize
            fp = _dp_footprint(fp, dp)
        return JobRequest(
            key=job.key, footprint=fp,
            priority=priority, queue=queue, preemptible=preemptible,
            runtime_estimate_s=estimate,
        )

    # -------------------------------------------------------- elastic

    def _attainable_nodes(self, key: str) -> Optional[int]:
        """Nodes job ``key`` could hold right now = its current charge
        + the pool's (unclamped) headroom — the elastic resizer's
        inventory view. A pool driven UNDER its usage by a permanent
        loss yields attainable < held: the shrink trigger. None when the
        job holds no accelerator charge."""
        sched = self.scheduler
        if sched is None:
            return None
        held_fp = sched.inventory.holder(key)
        if held_fp is None or held_fp.empty:
            return None
        free = (sched.inventory.capacity(held_fp.accelerator)
                - sched.inventory.used(held_fp.accelerator))
        return max(0, held_fp.slices + free)

    def _on_job_resize(self, tj: TrainingJob, old_dp: int,
                       new_dp: int, trigger: str = "") -> bool:
        """The reconciler's ledger re-charge at a resize verdict: swap
        the job's charge for the reshaped footprint ATOMICALLY (shrink
        frees nodes, grow re-charges them — the high-water mark never
        sees both shapes). An INVENTORY-triggered shrink must re-verify
        the pool deficit inside the ledger's critical section: two
        elastic gangs sharing a pool both observe one revoked node,
        and without the check both would surrender a node for it
        (dead-host shrinks carry their own evidence and skip it). A
        shrink immediately re-runs the decision core: the freed nodes
        may admit a queued job this tick."""
        sched = self.scheduler
        if sched is None:
            return True  # no ledger to keep consistent
        key = tj.job.key
        req = sched.running_request(key)
        if req is None or req.footprint.empty:
            return True  # zero-footprint / unscheduled: nothing charged
        # scale the RUNNING charge, not a fresh topology lookup: the
        # charge's own nodes/cards ratio is consistent by construction
        new_fp = _dp_footprint(req.footprint, new_dp)
        if not sched.resize_running(
                key, new_fp,
                require_pool_deficit=(new_dp < old_dp
                                      and trigger == "inventory")):
            return False
        self._export_sched_metrics()
        if new_dp < old_dp:
            self._sched_kick()
        return True

    def _on_capacity_return(self, accelerator: str) -> None:
        """Inventory capacity-return listener: wake every running
        elastic gang's reconciler so the grow hold starts counting NOW
        (best-effort — the periodic tick remains the backstop)."""
        for tj in list(self.jobs.values()):
            try:
                if tj.job.spec.elastic is None or not tj.is_alive():
                    continue
                fp = (self.scheduler.inventory.holder(tj.job.key)
                      if self.scheduler is not None else None)
                if fp is not None and fp.accelerator == accelerator:
                    tj.nudge()
            except Exception:  # a nudge must never break the ledger path
                pass

    def _preemption_cost(self, key: str) -> int:
        """The scheduler's eviction pricing: steps the victim has run
        past its last checkpoint, read from the reconciler's freshest
        heartbeat sweep (PR 9's goodput block). Unknown ⇒ 0."""
        tj = self.jobs.get(key)
        return tj.preemption_cost() if tj is not None else 0

    def _submit_queued(self, job: TpuJob) -> None:
        """First sighting of a fresh job under the scheduler: park it
        in QUEUED (no resources exist yet — ``_start_job`` only spawns
        a reconciler on admission) and persist the gate so users see
        WHY nothing is running."""
        req = self._request_for(job)
        if (req.key in self.scheduler.pending_keys()
                or self.scheduler.is_running(req.key)):
            return  # watch replay — already in line
        # persist the gate BEFORE enqueueing: the background sched loop
        # may admit the instant submit() returns, and the admitted
        # reconciler's runtime_id+CREATING write must never be
        # overwritten by a stale pre-admission Queued snapshot (the
        # status write is last-write-wins, not CAS)
        job.status.phase = TpuJobPhase.QUEUED
        job.status.append_condition(
            "Queued",
            reason=f"queue '{req.queue}' priority {req.priority}: "
                   f"awaiting {req.footprint}")
        try:
            job = self.job_client.update(job)
        except Exception as e:
            # the gate is still effective (no reconciler spawns); only
            # the user-visible phase write is retried by the next event
            log.warning("job %s: queued status write: %s", job.key, e)
        self.scheduler.submit(req)
        self.client.record_event(
            job.metadata.namespace,
            {"kind": "TpuJob", "name": job.metadata.name},
            "Queued",
            f"queued by the cluster scheduler (queue '{req.queue}', "
            f"priority {req.priority}, {req.footprint})",
        )

    def _ensure_sched_loop(self) -> None:
        if self.scheduler is None or self._sched_thread is not None:
            return
        self._sched_thread = threading.Thread(
            target=self._sched_loop, daemon=True, name="cluster-sched")
        self._sched_thread.start()

    def _sched_kick(self) -> None:
        """Coalesced request for a scheduler pass: job/capacity deltas
        (submit, terminal, delete, resize, queued-edit) set ONE pending
        flag the tick loop drains — a burst of N events runs one pass,
        not N. Falls back to a synchronous tick when the loop is not
        running (unit tests driving the controller by hand)."""
        from k8s_tpu_torch.controller import metrics

        if self.scheduler is None:
            return
        t = self._sched_thread
        if t is None or not t.is_alive():
            self._sched_tick()
            return
        metrics.SCHED_KICKS.inc()
        if self._sched_kick_pending.is_set():
            metrics.SCHED_KICKS_COALESCED.inc()
        else:
            self._sched_kick_pending.set()

    def _sched_backstop(self) -> float:
        """How long the tick loop may sleep with no kicks. Legacy mode
        keeps the configured interval (the tick IS the event source);
        event-driven mode stretches it to the slow backstop (every
        delta kicks explicitly), shortened to the next preemption-
        cooldown expiry so a held victim is re-considered the moment
        its hold-off ends, not one backstop later."""
        base = self.sched_interval
        if self.core is not None:
            base = max(base, SCHED_BACKSTOP_SECONDS)
        sched = self.scheduler
        if sched is not None:
            exp = sched.next_holdoff_expiry()
            if exp is not None:
                delta = exp - sched.clock()
                if delta > 0:
                    base = min(base, delta + 0.01)
        return max(0.02, base)

    def _sched_loop(self) -> None:
        """Event-driven tick loop: woken by :meth:`_sched_kick` (job or
        capacity deltas), with the periodic interval demoted to a slow
        backstop for anything a kick ever misses."""
        while not self._stop.is_set():
            self._sched_kick_pending.wait(self._sched_backstop())
            if self._stop.is_set():
                return
            # clear BEFORE ticking: a kick landing mid-pass re-arms the
            # flag and the loop runs again immediately — never lost
            self._sched_kick_pending.clear()
            try:
                self._sched_tick()
            except Exception as e:  # a tick bug must not kill the loop
                log.error("scheduler tick failed: %s", e)

    def _sched_tick(self) -> None:
        """One scheduling round: let the pure core decide (briefly
        under the lock), then act OUTSIDE it — preempt flushes,
        reconciler spawns, and gauge export all do I/O or joins, and
        holding the lock through them would convoy the watch pump,
        and every reconciler's terminal callback behind
        one apiserver brown-out. Acting lock-free is safe: each
        decision in ``result`` belongs to exactly this caller (tick()
        already moved the jobs, so a concurrent tick cannot re-decide
        them)."""
        from k8s_tpu_torch.controller import metrics

        sched = self.scheduler
        if sched is None:
            return
        t0 = time.monotonic()
        with self._sched_lock:
            result = sched.tick()
        # placement-scoring cost at O(1000) jobs is a measured quantity
        # (the reconcile-latency idiom): only the pure decision pass is
        # timed — acting on the verdicts does I/O and is not the
        # scheduler's cost
        metrics.SCHED_TICK_SECONDS.observe(time.monotonic() - t0)
        for key in result.backfilled:
            req = sched.running_request(key)
            metrics.SCHED_BACKFILLS.inc(
                {"queue": req.queue if req is not None else "unknown"})
        for p in result.preempted:
            self._apply_preemption(p)
        for req in result.admitted:
            self._admit_job(req)
        self._surface_blocked(result)
        self._export_sched_metrics()

    def _surface_blocked(self, result: TickResult) -> None:
        """Queued-phase diagnosability: write each parked job's blocked
        WHY (capacity / quota / cooldown / reservation /
        backfill-refused) into its Queued condition — but only when the
        category CHANGES, so a job parked behind capacity for an hour
        carries one condition, not 3600. A key that leaves the blocked
        set is forgotten, so re-parking later re-surfaces."""
        for key in list(self._blocked_surfaced):
            if key not in result.blocked:
                self._blocked_surfaced.pop(key, None)
        for key, reason in result.blocked.items():
            category = result.blocked_category.get(key, "")
            if self._blocked_surfaced.get(key) == category:
                continue
            self._blocked_surfaced[key] = category
            ns, name = key.split("/", 1)
            # Some scheduler messages already lead with the category
            # word ("capacity: 2 × ..."); don't double the prefix.
            text = reason if reason.startswith(f"{category}:") \
                else f"{category}: {reason}"
            try:
                job = self.job_client.get(ns, name)
                if job.status.phase != TpuJobPhase.QUEUED:
                    continue
                job.status.append_condition("Queued", reason=text)
                self.job_client.update(job)
            except Exception as e:  # diagnosability is best-effort
                log.debug("job %s: blocked-reason write: %s", key, e)

    def _admit_job(self, req: JobRequest) -> None:
        from k8s_tpu_torch.controller import metrics

        ns, name = req.key.split("/", 1)
        try:
            job = self.job_client.get(ns, name)
        except Exception as e:
            log.warning("admitted job %s unreadable (%s); released",
                        req.key, e)
            self.scheduler.remove(req.key)
            return
        if job.status.phase in (TpuJobPhase.DONE, TpuJobPhase.FAILED):
            # raced a terminal transition (or a preempt raced the
            # finish): never charge the fleet for a finished job
            self.scheduler.remove(req.key)
            return
        fresh = self._request_for(job)
        if fresh.footprint != req.footprint:
            # the spec changed between the decision and this fetch (a
            # queued-edit racing the tick): the charge no longer
            # matches what the reconciler would materialize — release
            # and re-queue under the real footprint; the next tick
            # re-decides against the honest ledger
            log.warning("job %s: footprint changed at admission "
                        "(%s -> %s); re-queued", req.key,
                        req.footprint, fresh.footprint)
            fresh.seq = req.seq  # keep its place in line
            self.scheduler.reinstate(fresh)
            self._sched_kick()  # re-decide now, not at the backstop
            return
        metrics.SCHED_ADMITTED.inc({"queue": req.queue})
        job.status.append_condition(
            "Admitted",
            reason=f"admitted by the cluster scheduler "
                   f"({req.footprint} charged to queue '{req.queue}')")
        self.client.record_event(
            ns, {"kind": "TpuJob", "name": name},
            "Admitted",
            f"admitted (queue '{req.queue}', priority {req.priority}, "
            f"{req.footprint})",
        )
        if not self._spawn_reconciler(job):
            # the previous reconciler is still winding down: give the
            # slices back and re-queue AT ITS ORIGINAL position; a
            # DELAYED kick retries (an immediate one would hot-loop
            # against the still-draining reconciler)
            self.scheduler.reinstate(req)
            threading.Timer(1.0, self._sched_kick).start()

    def _apply_preemption(self, p: Preemption) -> None:
        """Act on an eviction verdict: goodput + Events naming BOTH
        parties, then drive the victim's reconciler through the
        checkpoint-safe preempt flush (condition, SIGTERM-flush
        teardown, park in QUEUED)."""
        from k8s_tpu_torch.controller import metrics

        metrics.SCHED_PREEMPTED.inc({"queue": p.queue})
        if p.cost > 0:
            metrics.SCHED_PREEMPT_LOST_STEPS.inc(
                {"job": p.victim}, by=float(p.cost))
        vns, vname = p.victim.split("/", 1)
        pns, pname = p.preemptor.split("/", 1)
        self.client.record_event(
            pns, {"kind": "TpuJob", "name": pname},
            "Preempting",
            f"preempting lower-priority {p.victim} "
            f"(~{p.cost} steps since its last checkpoint at stake)",
        )
        tj = self.jobs.get(p.victim)
        if tj is None:
            # adopted-queued edge: no reconciler exists; the scheduler
            # already re-queued it, the ledger is consistent
            log.warning("preemption victim %s has no reconciler",
                        p.victim)
            return
        tj.preempt(
            f"preempted by higher-priority job {p.preemptor} "
            f"(~{p.cost} steps since the last checkpoint discarded at "
            f"worst; the preempt flush preserves them when healthy)")

    def _on_job_terminal(self, tj: TrainingJob) -> None:
        """Reconciler callback at the terminal transition: free the
        slices and immediately re-run the decision core so the next
        queued job starts this tick, not next interval."""
        if self.scheduler is None:
            return
        self.scheduler.remove(tj.job.key)
        self._sched_kick()

    def _export_sched_metrics(self) -> None:
        from k8s_tpu_torch.controller import metrics

        stats = self.scheduler.stats()
        metrics.SCHED_QUEUE_DEPTH.clear()
        for q, d in stats["queue_depth"].items():
            metrics.SCHED_QUEUE_DEPTH.set(float(d), {"queue": q})
        metrics.SCHED_QUOTA_USED.clear()
        for q, chips in stats["quota_used_chips"].items():
            metrics.SCHED_QUOTA_USED.set(float(chips), {"queue": q})
        metrics.SCHED_SLICES_FREE.clear()
        for accel, pool in stats["pools"].items():
            metrics.SCHED_SLICES_FREE.set(
                float(pool["free"]), {"accelerator": accel})
        # placement scoring (pools with a fleet topology block only)
        for accel, p in stats.get("placement", {}).items():
            metrics.SCHED_FRAGMENTATION.set(
                p["fragmentation"], {"accelerator": accel})
            if p["contiguity_requests"] > 0:
                metrics.SCHED_CONTIGUITY_HIT_RATE.set(
                    p["contiguity_hits"] / p["contiguity_requests"],
                    {"accelerator": accel})

    # ---------------------------------------------------- event-driven feed

    def _on_informer_event(self, ev) -> None:
        """Informer listener (event-driven core): map a Pod/Job delta to
        the owning TpuJob's reconcile key via the ``tpu_job_name`` label
        and kick exactly that key. The informer only notifies on
        MATERIAL cache changes, and the local kubelet writes pod status
        once at launch and once at finish — so a quiescent 1000-job
        fleet generates no kicks at all. A synthetic RESYNC event
        (reflector relist: anything may have changed while the watch
        was down) re-kicks every live job once."""
        if self.core is None:
            return
        if ev.type == "RESYNC":
            for key, tj in list(self.jobs.items()):
                if tj.is_alive():
                    tj.nudge()
            return
        labels = ((ev.object.get("metadata") or {}).get("labels") or {})
        name = labels.get(JOB_NAME_LABEL)
        if not name:
            return
        key = f"{ev.namespace or 'default'}/{name}"
        tj = self.jobs.get(key)
        if tj is not None and tj.is_alive():
            tj.nudge()

    def ingest_heartbeat(self, namespace: str, name: str, host: int,
                         payload: dict) -> bool:
        """Pushed obs heartbeat (POST /v1/heartbeat/<ns>/<name>/<host>
        on the operator health server): route to the owning reconciler,
        which caches the stats and kicks its key — replacing a poll.
        Returns False for an unknown/dead job (HTTP 404)."""
        tj = self.jobs.get(f"{namespace}/{name}")
        if tj is None or not tj.is_alive():
            return False
        tj.ingest_heartbeat(host, payload)
        return True

    def handle_event(self, ev_type: str, job: TpuJob) -> None:
        """Reference handleTfJobEvent (controller.go:123-170)."""
        from k8s_tpu_torch.controller import metrics

        metrics.EVENTS_HANDLED.inc({"type": ev_type})
        key = job.key
        if ev_type == "ADDED":
            if job.status.is_failed():
                log.warning("ignoring failed job %s", key)  # quarantine, :126-133
                return
            if key in self.jobs:
                return
            self._start_job(job)
        elif ev_type == "DELETED":
            was_scheduled = False
            if self.scheduler is not None:
                # frees the slices (or drops the queue entry) whether a
                # reconciler exists or not — a QUEUED job has none
                was_scheduled = self.scheduler.remove(key)
            tj = self.jobs.pop(key, None)
            metrics.LIVE_JOBS.set(len(self.jobs))
            if tj is None:
                if not was_scheduled:
                    log.warning("unsafe state: %s deleted but not tracked",
                                key)
                self._sched_kick()
                return
            if tj.is_alive():
                tj.delete()
            else:
                # a preempted/queued job's reconciler has exited — its
                # event queue drains nowhere, so the teardown of what
                # survives the queue (per-index Services, TensorBoard,
                # launcher ConfigMap) must run inline or it leaks
                try:
                    tj.delete_resources()
                except Exception as e:
                    log.error("job %s: queued-job delete: %s", key, e)
            self._sched_kick()
        elif ev_type == "MODIFIED":
            tj = self.jobs.get(key)
            if tj is not None and tj.is_alive():
                tj.update(job)
            elif self.scheduler is not None:
                # spec edited while QUEUED (no reconciler polices
                # immutability yet): the ledger must charge what the
                # reconciler will materialize on admission, or the
                # stale footprint breaks zero-oversubscription
                if self.scheduler.update_pending(self._request_for(job)):
                    self._sched_kick()

    # ------------------------------------------------------------ run loop

    def run(self) -> None:
        """Watch pump (reference Run + watch, controller.go:80-119,292-376).

        Every requeue path — init failure, relist-after-410, a pump
        crash (e.g. an event handler exceeding the watchdog under an
        apiserver brown-out) — routes through one :class:`Backoff`:
        repeated failures space out exponentially instead of hot-
        looping the apiserver, and a stable stretch earns the fast
        retry back. A pump crash previously killed the controller
        thread silently; now it re-initializes and keeps serving."""
        requeue = Backoff(REQUEUE_POLICY)
        while not self._stop.is_set():
            try:
                watch_rv = self.init_resource()
            except Exception as e:
                delay = requeue.note_failure()
                log.error("initialization failed: %s; retrying in %.1fs",
                          e, delay)
                if requeue.wait(self._stop):
                    return
                continue
            try:
                self._pump(watch_rv)
                return
            except errors.OutdatedVersionError:
                # 410 Gone → relist and re-watch (reference
                # ErrVersionOutdated restart path, controller.go:331-344)
                delay = requeue.note_failure()
                log.info("watch outdated; relisting in %.1fs", delay)
            except Exception as e:
                delay = requeue.note_failure()
                log.error("event pump failed: %s; re-initializing in %.1fs",
                          e, delay)
            if requeue.wait(self._stop):
                return

    def _pump(self, watch_rv: int) -> None:
        watcher = self.job_client.watch(self.namespace, resource_version=watch_rv)
        try:
            while not self._stop.is_set():
                ev = watcher.next(timeout=0.2)
                if ev is None:
                    continue
                job = TpuJob.from_dict(ev.object)
                with PanicTimer(
                    self.watchdog_deadline,
                    msg=f"handling {ev.type} for {job.key}",
                    hard=False,
                ) as wd:
                    self.handle_event(ev.type, job)
                if wd.fired.is_set():
                    raise RuntimeError("event handler exceeded watchdog deadline")
        finally:
            watcher.stop()

    # ------------------------------------------------------------ lifecycle

    def start(self) -> threading.Thread:
        self._thread = threading.Thread(target=self.run, daemon=True, name="controller")
        self._thread.start()
        return self._thread

    def stop(self) -> None:
        self._stop.set()
        # wake the sched loop out of its backstop sleep immediately
        self._sched_kick_pending.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._sched_thread is not None:
            self._sched_thread.join(timeout=5)
            self._sched_thread = None
        # stop reconcilers only after the pump thread is down: run() /
        # find_all_jobs may still be adding jobs concurrently, and a job
        # added after an early stop loop would leak its thread. Join so
        # stop() really quiesces the process.
        inf = self.client.informer
        if self._informer_listener is not None and inf is not None:
            inf.remove_listener(self._informer_listener)
            self._informer_listener = None
        for tj in list(self.jobs.values()):
            tj.stop()
        for tj in list(self.jobs.values()):
            tj.join(timeout=5)
        if self.core is not None:
            self.core.stop()
        if self._owns_informer:
            if self._informer_sampler is not None:
                from k8s_tpu_torch.controller import metrics

                # under the sampler's own lock: flag + reset become
                # atomic w.r.t. any in-flight scrape, so a dead
                # informer can never be reported synced afterwards
                with self._informer_sampler_lock:
                    self._informer_sampler_stopped.set()
                    metrics.REGISTRY.remove_collector(
                        self._informer_sampler)
                    self._informer_sampler = None
                    metrics.INFORMER_SYNCED.set(0.0)
                    metrics.INFORMER_OBJECTS.clear()
            self.client.stop_informer()
            self._owns_informer = False

    def wait_for_job(
        self, namespace: str, name: str, timeout: float = 300.0, poll: float = 0.05
    ) -> TpuJob:
        """Poll a job to a terminal phase (the analogue of the e2e
        binary's wait, reference test/e2e/main.go:111-123)."""
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            job = self.job_client.get(namespace, name)
            if job.status.phase in (TpuJobPhase.DONE, TpuJobPhase.FAILED):
                return job
            time.sleep(poll)
        raise TimeoutError(f"job {namespace}/{name} did not finish in {timeout}s")
