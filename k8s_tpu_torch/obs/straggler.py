"""Gang straggler detection: pure decision logic.

(The port's copy of ``k8s_tpu/obs/straggler.py``.)

One slow host drags the WHOLE gang (every collective waits for the
last arrival), so "which host is the straggler" is the first question
of any slow-step investigation — and the one aggregate counters can't
answer. The reconciler feeds this detector the per-host step
heartbeats it polls from each worker's obs endpoint
(``{host: {"step", "step_time_s", "phases_s", "age_s"}}``) and acts on
the verdict (``StragglerDetected`` condition + K8s Event + skew
gauges, ``trainer/training.py``).

Decision rule, deliberately simple and fully deterministic (the unit
test surface):

- hosts are judged on ``busy_s`` when the heartbeat carries it (step
  wall MINUS the gang-coupled phases — see
  :data:`k8s_tpu_torch.obs.trace.GANG_PHASES`): synchronized SPMD equalizes
  wall time through the collectives, so only a host's OWN work (input
  waits, checkpoint stalls, host-side processing) attributes slowness
  to it; heartbeats without ``busy_s`` fall back to ``step_time_s``;
- baseline = median busy time of the OTHER hosts (excluding the
  slowest), so a 2-host gang still has an honest peer baseline;
- a host is a straggler CANDIDATE when its busy time >=
  ``threshold`` x that baseline;
- the verdict fires only after the SAME host is the candidate for
  ``consecutive`` FRESH observations — an observation only counts
  when the gang's max step advanced since the last counted one, so a
  reconciler re-polling an unchanged heartbeat can't inflate the
  streak (ticks are much faster than steps);
- hysteresis both ways: a raised verdict stays ``active`` (no
  re-raise flapping) until ``clear_after`` fresh clean observations,
  and an optional ``min_window_s`` of clock time must span the streak
  (guards against N heartbeats arriving in one burst after a stall);
- heartbeats staler than ``stale_after_s`` are excluded — a DEAD host
  is the gang-restart path's problem, not a straggler.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional


@dataclass
class StragglerVerdict:
    """One observation's outcome. ``new_straggler`` is set exactly once
    per episode (the tick the streak crosses the bar); ``active`` holds
    while the episode lasts; ``cleared`` is set on the tick the episode
    ends."""

    observed_hosts: int = 0
    skew_s: float = 0.0        # slowest - peer median (busy time)
    median_s: float = 0.0      # peer median (excluding the slowest)
    slowest: Optional[int] = None
    ratio: float = 0.0         # slowest / peer median
    streak: int = 0
    new_straggler: Optional[int] = None
    active: Optional[int] = None
    cleared: Optional[int] = None
    step_times: Dict[int, float] = field(default_factory=dict)


class StragglerDetector:
    def __init__(
        self,
        threshold: float = 1.5,
        consecutive: int = 3,
        clear_after: int = 3,
        min_hosts: int = 2,
        stale_after_s: float = 60.0,
        min_window_s: float = 0.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if threshold <= 1.0:
            raise ValueError("threshold must be > 1.0")
        self.threshold = float(threshold)
        self.consecutive = max(1, int(consecutive))
        self.clear_after = max(1, int(clear_after))
        self.min_hosts = max(2, int(min_hosts))
        self.stale_after_s = float(stale_after_s)
        self.min_window_s = float(min_window_s)
        self.clock = clock
        self._streak_host: Optional[int] = None
        self._streak = 0
        self._streak_started_at = 0.0
        self._clear_streak = 0
        self._active: Optional[int] = None
        self._last_max_step = -1

    def observe(self, stats: Dict[int, dict]) -> StragglerVerdict:
        v = StragglerVerdict(active=self._active)
        fresh = {
            int(h): s for h, s in (stats or {}).items()
            if float(s.get("step_time_s", 0.0) or 0.0) > 0.0
            and float(s.get("age_s", 0.0) or 0.0) <= self.stale_after_s
        }
        v.observed_hosts = len(fresh)
        if len(fresh) < self.min_hosts:
            return v
        # judge on busy time when PRESENT (wall minus gang-coupled
        # phases; see module docstring), wall time otherwise. Presence,
        # not truthiness: a host whose whole step was gang-coupled
        # legitimately reports busy_s == 0.0, and falling back to its
        # gang-equalized WALL there would make the least-busy host
        # look like the straggler.
        times = {
            h: float(s["busy_s"] if s.get("busy_s") is not None
                     else s["step_time_s"])
            for h, s in fresh.items()
        }
        v.step_times = dict(times)
        slowest = max(times, key=lambda h: (times[h], h))
        peers = [t for h, t in times.items() if h != slowest]
        med = statistics.median(peers)
        v.slowest = slowest
        v.median_s = med
        v.skew_s = max(0.0, times[slowest] - med)
        v.ratio = times[slowest] / med if med > 0 else 0.0
        over = med > 0 and v.ratio >= self.threshold

        # fresh-observation gate: only a gang that made progress since
        # the last counted observation yields a countable sample
        max_step = max(int(s.get("step", 0) or 0) for s in fresh.values())
        advanced = max_step > self._last_max_step
        if advanced:
            self._last_max_step = max_step

        if over:
            self._clear_streak = 0
            if advanced:
                if slowest == self._streak_host:
                    self._streak += 1
                else:
                    self._streak_host = slowest
                    self._streak = 1
                    self._streak_started_at = self.clock()
        else:
            self._streak_host, self._streak = None, 0
            if advanced and self._active is not None:
                self._clear_streak += 1
                if self._clear_streak >= self.clear_after:
                    v.cleared = self._active
                    self._active = None
                    self._clear_streak = 0
        v.streak = self._streak

        if (
            over
            and self._streak >= self.consecutive
            and self._active != self._streak_host
            and self.clock() - self._streak_started_at >= self.min_window_s
        ):
            if self._active is not None:
                # the straggler identity SWITCHED hosts: close the old
                # episode in the same verdict — without this the
                # previous host's StragglerDetected would never be
                # followed by a StragglerCleared
                v.cleared = self._active
            self._active = self._streak_host
            v.new_straggler = self._streak_host
            self._clear_streak = 0
        v.active = self._active
        return v
