"""Exponential backoff with full jitter, cap, and reset-after-stable-
period (the port's copy of ``k8s_tpu/robustness/backoff.py``; the
checkpoint-save retry of :mod:`k8s_tpu_torch.train.checkpoint` uses it).

- delay grows ``base * factor**(failures-1)``, capped at ``cap``;
- *full jitter*: the actual delay is uniform in ``[raw*(1-jitter),
  raw]``, which decorrelates a gang of retrying processes;
- after ``reset_after`` seconds without a failure the streak resets,
  so a job that ran stably for a while earns back a fast first retry.

Everything is injectable for tests: ``clock`` (fake monotonic time),
``seed`` (deterministic jitter), ``sleep`` in :func:`retry_call`.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type


@dataclass(frozen=True)
class BackoffPolicy:
    """Immutable knobs of one backoff schedule."""

    base: float = 1.0          # delay after the first failure (seconds)
    factor: float = 2.0        # growth per consecutive failure
    cap: float = 300.0         # delay ceiling
    jitter: float = 1.0        # randomized fraction of the raw delay [0, 1]
    reset_after: float = 600.0 # stable window that clears the streak; 0 = never

    def validate(self) -> None:
        if self.base < 0:
            raise ValueError(f"backoff base must be >= 0, got {self.base}")
        if self.factor < 1.0:
            raise ValueError(f"backoff factor must be >= 1, got {self.factor}")
        if self.cap < self.base:
            raise ValueError(
                f"backoff cap ({self.cap}) must be >= base ({self.base})")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"backoff jitter must be in [0, 1], got {self.jitter}")
        if self.reset_after < 0:
            raise ValueError(
                f"backoff reset_after must be >= 0, got {self.reset_after}")

    def raw_delay(self, failures: int) -> float:
        """Un-jittered delay for the Nth consecutive failure (N >= 1)."""
        if failures <= 0:
            return 0.0
        return min(self.cap, self.base * self.factor ** (failures - 1))

    def delay(self, failures: int, rng: random.Random) -> float:
        """Jittered delay: uniform in ``[raw*(1-jitter), raw]``."""
        raw = self.raw_delay(failures)
        if raw <= 0.0 or self.jitter <= 0.0:
            return raw
        low = raw * (1.0 - self.jitter)
        return rng.uniform(low, raw)


class Backoff:
    """Mutable backoff state for ONE retry site.

    Contract: call :meth:`note_failure` when the protected operation
    fails (returns the delay to hold off); gate the next attempt on
    :meth:`ready` / :meth:`remaining` (tick-driven reconcilers) or
    block with :meth:`wait` (dedicated threads); call
    :meth:`note_success` — or just let ``reset_after`` elapse — once
    the operation is healthy again.
    """

    def __init__(
        self,
        policy: Optional[BackoffPolicy] = None,
        seed: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.policy = policy or BackoffPolicy()
        self.rng = random.Random(seed)
        self.clock = clock
        self.failures = 0
        self.current_delay = 0.0
        self._not_before: Optional[float] = None
        self._last_failure: Optional[float] = None

    def _maybe_reset(self, now: float) -> None:
        if (
            self._last_failure is not None
            and self.policy.reset_after > 0
            and now - self._last_failure >= self.policy.reset_after
        ):
            self.note_success()

    def note_failure(self) -> float:
        """Record one failure; returns the jittered delay before the
        next attempt may run."""
        now = self.clock()
        self._maybe_reset(now)
        self.failures += 1
        self.current_delay = self.policy.delay(self.failures, self.rng)
        self._not_before = now + self.current_delay
        self._last_failure = now
        return self.current_delay

    def note_success(self) -> None:
        """Clear the streak (stable again)."""
        self.failures = 0
        self.current_delay = 0.0
        self._not_before = None
        self._last_failure = None

    # alias: sites that think in reset() terms
    reset = note_success

    def remaining(self) -> float:
        """Seconds left before the next attempt is allowed (0 = go)."""
        now = self.clock()
        self._maybe_reset(now)
        if self._not_before is None:
            return 0.0
        return max(0.0, self._not_before - now)

    def ready(self) -> bool:
        return self.remaining() <= 0.0

    def wait(self, stop: Optional[threading.Event] = None) -> bool:
        """Block out the current hold-off. With a stop event, waits on
        it (interruptible) and returns True if stop fired; plain sleep
        otherwise (returns False)."""
        delay = self.remaining()
        if delay <= 0:
            return False
        if stop is not None:
            return stop.wait(delay)
        time.sleep(delay)
        return False


def retry_call(
    fn: Callable,
    *,
    policy: Optional[BackoffPolicy] = None,
    max_attempts: int = 3,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    should_retry: Optional[Callable[[BaseException], bool]] = None,
    seed: Optional[int] = None,
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
):
    """Call ``fn()`` up to ``max_attempts`` times, sleeping the policy's
    backoff between attempts. An exception not matching ``retry_on`` —
    or rejected by the ``should_retry`` predicate — propagates
    immediately; the last attempt's exception always propagates.
    ``on_retry`` (attempt#, exception, upcoming delay) lets callers
    log/count."""
    if max_attempts < 1:
        raise ValueError("max_attempts must be >= 1")
    bo = Backoff(policy or BackoffPolicy(base=0.1, cap=5.0), seed=seed)
    for attempt in range(1, max_attempts + 1):
        try:
            return fn()
        except retry_on as e:
            if should_retry is not None and not should_retry(e):
                raise
            if attempt >= max_attempts:
                raise
            delay = bo.note_failure()
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)
