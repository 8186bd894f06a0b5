"""Keyed, coalescing, rate-limited work queue — the event-driven
reconciler core's spine (docs/SCHEDULER.md "Event-driven core").

(The port's copy of ``k8s_tpu/controller/workqueue.py``.)

client-go workqueue semantics, dependency-free:

- **Coalescing**: a key added while already queued (dirty) is merged —
  a burst of N events for one job costs ONE reconcile, not N. A key
  added while being *processed* is re-queued once ``done()`` is called,
  so no event is ever lost and no key is processed concurrently.
- **Delayed adds**: ``add_after(key, delay)`` parks the key on a heap
  until its due time — the requeue-with-backoff and slow-resync
  mechanism that replaces the per-job fixed-interval sleep loop.
- **Injected clock**: every time read goes through ``clock`` so
  ``benches/sched_bench.py`` replays this exact code on a virtual
  clock (``pop_ready`` + ``next_ready_at`` are the non-blocking
  surface the simulator drives; worker threads use blocking ``get``).

The per-key :class:`RateLimiter` provides the exponential failure
backoff: each consecutive failure doubles the requeue delay up to a
cap; ``forget()`` on success resets the key to the base delay.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple


class RateLimiter:
    """Per-key exponential backoff: ``when(key)`` returns the delay to
    wait before the next retry of ``key`` and arms the next step;
    ``forget(key)`` resets it after a success."""

    def __init__(self, base: float = 0.05, cap: float = 30.0):
        self.base = base
        self.cap = cap
        self._failures: Dict[str, int] = {}
        self._lock = threading.Lock()

    def when(self, key: str) -> float:
        with self._lock:
            n = self._failures.get(key, 0)
            self._failures[key] = n + 1
        return min(self.cap, self.base * (2.0 ** n))

    def failures(self, key: str) -> int:
        with self._lock:
            return self._failures.get(key, 0)

    def forget(self, key: str) -> None:
        with self._lock:
            self._failures.pop(key, None)


class CoalescingWorkQueue:
    """Keyed FIFO with dirty/processing coalescing + a delayed heap."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: List[str] = []          # ready keys, FIFO
        self._dirty: Set[str] = set()        # queued or needs-requeue
        self._processing: Set[str] = set()   # handed out, not done()
        self._delayed: List[Tuple[float, int, str]] = []  # (due, seq, key)
        self._seq = 0
        self._closed = False
        # counters mirrored into the controller metrics by the owner;
        # kept as plain ints so the simulator reads them with no
        # Prometheus coupling
        self.added = 0
        self.coalesced = 0
        self.requeued = 0

    # ------------------------------------------------------------ producers

    def add(self, key: str) -> bool:
        """Mark ``key`` dirty and queue it unless it already is. Returns
        True when a new queue entry was created (False = coalesced into
        an existing one)."""
        with self._cond:
            if self._closed:
                return False
            self.added += 1
            if key in self._dirty:
                # already queued (or will re-queue at done()): merge
                self.coalesced += 1
                return False
            self._dirty.add(key)
            if key in self._processing:
                # re-queued by done(); counts as coalesced-into-flight
                self.coalesced += 1
                return False
            self._queue.append(key)
            self._cond.notify()
            return True

    def add_after(self, key: str, delay: float) -> None:
        """Queue ``key`` after ``delay`` seconds (0 ⇒ immediate). An
        earlier pending delayed add for the same key wins — the heap
        just delivers the first due entry; later ones coalesce."""
        if delay <= 0:
            self.add(key)
            return
        with self._cond:
            if self._closed:
                return
            self.requeued += 1
            self._seq += 1
            heapq.heappush(
                self._delayed, (self.clock() + delay, self._seq, key))
            self._cond.notify()

    # ------------------------------------------------------------ consumers

    def _promote_due(self) -> None:
        """Move due delayed entries to the ready queue (lock held)."""
        now = self.clock()
        while self._delayed and self._delayed[0][0] <= now:
            _, _, key = heapq.heappop(self._delayed)
            if key in self._dirty:
                continue  # already queued: coalesce
            self._dirty.add(key)
            if key not in self._processing:
                self._queue.append(key)

    def get(self, timeout: Optional[float] = None) -> Optional[str]:
        """Blocking pop: the next ready key (marked processing), or
        None on timeout/close. Workers MUST call :meth:`done` after."""
        deadline = None if timeout is None else self.clock() + timeout
        with self._cond:
            while True:
                self._promote_due()
                if self._queue:
                    key = self._queue.pop(0)
                    self._dirty.discard(key)
                    self._processing.add(key)
                    return key
                if self._closed:
                    return None
                # wake early for the nearest delayed entry
                wait = None
                if deadline is not None:
                    wait = deadline - self.clock()
                    if wait <= 0:
                        return None
                if self._delayed:
                    until_due = self._delayed[0][0] - self.clock()
                    wait = until_due if wait is None else min(wait, until_due)
                    wait = max(wait, 0.005)
                self._cond.wait(wait)

    def done(self, key: str) -> None:
        """Processing finished; a key re-added mid-flight re-queues."""
        with self._cond:
            self._processing.discard(key)
            if key in self._dirty:
                self._queue.append(key)
                self._cond.notify()

    # ------------------------------------------ simulator (virtual clock)

    def pop_ready(self) -> Optional[str]:
        """Non-blocking pop for discrete-event replay: the next key due
        at or before ``clock()`` (marked processing), else None."""
        with self._cond:
            self._promote_due()
            if not self._queue:
                return None
            key = self._queue.pop(0)
            self._dirty.discard(key)
            self._processing.add(key)
            return key

    def next_ready_at(self) -> Optional[float]:
        """The earliest time a key becomes deliverable: ``clock()`` if
        one is ready now, the nearest delayed due-time otherwise, None
        when the queue is empty — the simulator's next-event time."""
        with self._cond:
            self._promote_due()
            if self._queue:
                return self.clock()
            if self._delayed:
                return self._delayed[0][0]
            return None

    # ------------------------------------------------------------ lifecycle

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue) + len(self._delayed)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def discard(self, key: str) -> None:
        """Forget a key entirely (job deregistered): drop its ready
        entry; delayed entries drain harmlessly (the consumer drops
        unknown keys)."""
        with self._cond:
            self._dirty.discard(key)
            if key in self._queue:
                self._queue.remove(key)
