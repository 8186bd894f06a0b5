"""The operator controller: CRD registration, watch loop, dispatch
(the port's copy of ``k8s_tpu/controller/controller.py``, without the
cluster scheduler — ROADMAP A12.3; a controller config that declares a
``fleet`` is refused when the controller starts).

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
from k8s_tpu_torch.spec import ControllerConfig, TpuJob, TpuJobPhase
from k8s_tpu_torch.trainer.training import TrainingJob

log = logging.getLogger(__name__)

INIT_RETRY_WAIT = 30.0  # reference controller.go:33
WATCHDOG_DEADLINE = 60.0  # reference controller.go:110

# Requeue schedule for the controller's outer loop: init failures,
# relist-after-410, and pump crashes all hold off through this (capped
# at the reference's fixed 30s init wait, which it replaces).
REQUEUE_POLICY = BackoffPolicy(
    base=0.5, factor=2.0, cap=INIT_RETRY_WAIT, jitter=0.5, reset_after=120.0
)


class Controller:
    def __init__(
        self,
        client: KubeClient,
        job_client: TpuJobClient,
        config: Optional[ControllerConfig] = None,
        namespace: Optional[str] = None,
        reconcile_interval: float = 8.0,
        watchdog_deadline: float = WATCHDOG_DEADLINE,
    ):
        self.client = client
        self.job_client = job_client
        self.config = config or ControllerConfig()
        # refused here, at controller start: the cluster scheduler and
        # the native supervisor are later slices
        self.config.check_ported()
        self.namespace = namespace
        self.reconcile_interval = reconcile_interval
        self.watchdog_deadline = watchdog_deadline
        self.jobs: Dict[str, TrainingJob] = {}  # reference jobs map, :46-61
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._owns_informer = False
        self._informer_sampler = None
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
        # heartbeat source of the obs tick) for reconcilers the
        # CONTROLLER spawns — outside a cluster there is no Service DNS
        # for the default HTTP fetcher to resolve
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
        return self.find_all_jobs()

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
        """Entry for a newly-seen job (watch ADDED / startup adoption):
        spawn the reconciler immediately (reference behavior)."""
        self._spawn_reconciler(job)

    def _spawn_reconciler(self, job: TpuJob) -> bool:
        from k8s_tpu_torch.controller import metrics

        old = self.jobs.get(job.key)
        if old is not None:
            # a previous reconciler of this key: quiesce it before the
            # fresh one takes the key (two reconcilers on one job would
            # race every status write)
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

    # ---------------------------------------------------- event-driven feed

    def _on_informer_event(self, ev) -> None:
        """Informer listener (event-driven core): map a Pod/Job delta to
        the owning TpuJob's reconcile key via the ``tpu_job_name`` label
        and kick exactly that key. The informer only notifies on
        MATERIAL cache changes, and the local kubelet writes pod status
        once at launch and once at finish — so a quiescent 1000-job
        fleet generates no kicks at all."""
        if self.core is None:
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
            tj = self.jobs.pop(key, None)
            metrics.LIVE_JOBS.set(len(self.jobs))
            if tj is None:
                log.warning("unsafe state: %s deleted but not tracked", key)
                return
            if tj.is_alive():
                tj.delete()
            else:
                # the reconciler has exited — its event queue drains
                # nowhere, so the teardown of what survives (per-index
                # Services, TensorBoard, launcher ConfigMap) must run
                # inline or it leaks
                try:
                    tj.delete_resources()
                except Exception as e:
                    log.error("job %s: exited-reconciler delete: %s", key, e)
        elif ev_type == "MODIFIED":
            tj = self.jobs.get(key)
            if tj is not None and tj.is_alive():
                tj.update(job)

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
        if self._thread is not None:
            self._thread.join(timeout=5)
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
