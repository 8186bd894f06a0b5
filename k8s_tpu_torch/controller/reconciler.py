"""ReconcilerCore: a bounded worker pool draining one shared
coalescing work queue — the event-driven replacement for one thread
per TrainingJob (docs/SCHEDULER.md "Event-driven core").

(The port's copy of ``k8s_tpu/controller/reconciler.py``.)

Each registered key owns a handler ``() -> Optional[float]``: process
the job once and return the desired requeue delay (None = wait for the
next event/kick; the slow resync backstop is the handler's own
business). The queue's dirty/processing sets guarantee a key is never
processed on two workers at once, so per-job reconcile logic needs no
extra locking beyond what the threaded mode already had.

Failure policy: a handler that *raises* is re-queued on the per-key
exponential :class:`~k8s_tpu_torch.controller.workqueue.RateLimiter`
(0.5s → 30s) — the event-driven analogue of "the ticker paces the
retry"; a handler that returns normally resets its key's backoff.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional

from k8s_tpu_torch.controller.workqueue import CoalescingWorkQueue, RateLimiter

log = logging.getLogger(__name__)

Handler = Callable[[], Optional[float]]


class ReconcilerCore:
    def __init__(self, workers: int = 4,
                 clock: Callable[[], float] = time.monotonic,
                 failure_base: float = 0.5, failure_cap: float = 30.0):
        self.queue = CoalescingWorkQueue(clock=clock)
        self.limiter = RateLimiter(base=failure_base, cap=failure_cap)
        self.clock = clock
        self.workers = max(1, int(workers))
        self._handlers: Dict[str, Handler] = {}
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._inflight: Dict[str, int] = {}
        self._threads: list = []
        self._stop = threading.Event()
        self._started = False
        self._coalesced_exported = 0

    # ------------------------------------------------------------ registry

    def register(self, key: str, handler: Handler) -> None:
        """(Re)bind ``key`` to ``handler``. Rebinding is how the
        controller replaces a preempted job's reconciler on
        re-admission: the queue's processing set serializes the old
        handler's in-flight pass against the new one's first."""
        with self._lock:
            self._handlers[key] = handler

    def deregister(self, key: str) -> None:
        with self._lock:
            self._handlers.pop(key, None)
        self.queue.discard(key)

    def registered(self, key: str) -> bool:
        with self._lock:
            return key in self._handlers

    # ------------------------------------------------------------ kicks

    def kick(self, key: str, delay: float = 0.0) -> None:
        if delay > 0:
            self.queue.add_after(key, delay)
        else:
            self.queue.add(key)

    def wait_idle(self, key: str, timeout: float = 10.0) -> bool:
        """Block until no worker is processing ``key`` (the respawn
        path's quiesce barrier). True = idle within the timeout."""
        deadline = self.clock() + timeout
        with self._idle:
            while self._inflight.get(key, 0) > 0:
                remaining = deadline - self.clock()
                if remaining <= 0:
                    return False
                self._idle.wait(remaining)
            return True

    # ------------------------------------------------------------ workers

    def start(self) -> "ReconcilerCore":
        if self._started:
            return self
        self._started = True
        for i in range(self.workers):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"reconciler-core-{i}")
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        self.queue.close()
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []
        self._started = False

    def _worker(self) -> None:
        from k8s_tpu_torch.controller import metrics

        while not self._stop.is_set():
            key = self.queue.get(timeout=0.2)
            if key is None:
                continue
            with self._lock:
                handler = self._handlers.get(key)
                self._inflight[key] = self._inflight.get(key, 0) + 1
            try:
                if handler is None:
                    continue  # deregistered while queued: drop
                t0 = time.monotonic()
                try:
                    delay = handler()
                except Exception as e:
                    backoff = self.limiter.when(key)
                    metrics.RECONCILE_REQUEUES.inc({"reason": "error"})
                    log.error("key %s: reconcile failed (%s); requeued "
                              "in %.1fs", key, e, backoff)
                    self.queue.add_after(key, backoff)
                else:
                    self.limiter.forget(key)
                    if delay is not None:
                        metrics.RECONCILE_REQUEUES.inc(
                            {"reason": "resync" if delay >= 60.0
                             else "poll"})
                        self.queue.add_after(key, max(0.0, delay))
                metrics.RECONCILE_LATENCY.observe(time.monotonic() - t0)
            finally:
                self.queue.done(key)
                with self._idle:
                    n = self._inflight.get(key, 1) - 1
                    if n <= 0:
                        self._inflight.pop(key, None)
                    else:
                        self._inflight[key] = n
                    self._idle.notify_all()
            self._export()

    def _export(self) -> None:
        from k8s_tpu_torch.controller import metrics

        metrics.WORKQUEUE_DEPTH.set(float(len(self.queue)))
        delta = self.queue.coalesced - self._coalesced_exported
        if delta > 0:
            self._coalesced_exported = self.queue.coalesced
            metrics.WORKQUEUE_COALESCED.inc(by=float(delta))
