"""Elastic-resize decision core (the port's copy of
``k8s_tpu/resize/elastic.py``, docs/ELASTIC.md). Where the JAX package
counts TPU slices this counts GPU nodes of a ``GpuTopology``: the DP
degree is the gang's node count, the ``data`` axis of its HSDP mesh,
and a host is one worker pod (one card), ``cards_per_node`` of them to
a node.

Pure decision logic in the StragglerDetector/HealthMonitor/
SloAutoscaler idiom: an injected clock, no I/O, no threads — the
reconciler feeds :meth:`ElasticResizer.observe` one observation per
obs tick and acts on the verdict. That is what makes the whole
decision table unit-testable on a fake clock.

Decision rules, in order, per observation:

1. **cooldown** — within ``cooldown_s`` of the last acted-on resize
   (``note_resized``) nothing fires: a resize is a whole-gang restart,
   and back-to-back resizes are churn, not recovery (no-flap).
2. **shrink (inventory)** — the scheduler's attainable-node view says
   this job can hold fewer nodes than its current DP degree (a node
   was revoked / a node pool shrank under the gang). Decisive — the
   ledger already knows the capacity is gone, there is nothing to wait
   out. Target = attainable, clamped to ``[min_dp, max_dp]``; below
   ``min_dp`` the job cannot run at any legal shape and the verdict
   says so (the caller falls through to the plain restart/Failed
   path rather than resizing into the floor).
3. **shrink (dead heartbeat)** — a host that WAS answering and then
   went silent for ``dead_after_s`` while at least one peer still
   answers (an operator-wide outage must not read as host death) is
   presumed permanently lost along with its node. Target = surviving
   nodes, same clamping. Requires ``resize_on_permanent_loss``.
   A host never seen this episode is *starting*, not dead — pod
   scheduling/image pulls routinely exceed any honest silence window,
   and a fresh post-resize gang must not be shrunk for booting slowly
   (an actually-failed pod surfaces through the degraded-pod gang
   path, and a revoked node through the inventory trigger).
4. **grow** — attainable nodes exceed the current DP degree for
   ``grow_hold_s`` of sustained clock time (a capacity blip shorter
   than the hold moves nothing — hysteresis mirrors the
   SloAutoscaler's breach streaks). Target = attainable, capped at
   ``max_dp``.

Every verdict carries the **health-gated restore ceiling**: when the
freshest numerics block is poisoned (non-finite loss/grads — the
``step_health`` contract), ``restore_ceiling`` is the last *healthy*
step, which the caller threads into the restarted gang as
``KTPU_CKPT_RESTORE_MAX_STEP`` so a NaN step is never the resize
restore point. ``budget_left <= 0`` turns any would-be action into
``"exhausted"`` — resizes are budget-counted like divergence restarts,
and a fleet that keeps losing nodes must eventually fail the job,
not resize forever.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

ACTION_SHRINK = "shrink"
ACTION_GROW = "grow"
ACTION_EXHAUSTED = "exhausted"


def _finite(x) -> bool:
    try:
        return math.isfinite(float(x))
    except (TypeError, ValueError):
        return False


@dataclass
class ResizeVerdict:
    """One observation's outcome. ``action`` is None when the gang
    should keep its shape (``reason`` says why a trigger that looked
    armed did not fire); ``target_dp`` accompanies shrink/grow.
    ``restore_ceiling`` is set iff the freshest numerics are poisoned —
    the last healthy step the resize restore must not exceed."""

    action: Optional[str] = None
    target_dp: int = 0
    reason: str = ""
    restore_ceiling: Optional[int] = None
    dead_hosts: Tuple[int, ...] = field(default_factory=tuple)
    # which rule fired: "inventory" | "dead-hosts" | "capacity-return".
    # The ledger callback uses it to re-verify an inventory-triggered
    # shrink against the LIVE pool deficit inside its critical section
    # (two gangs sharing a pool must not both surrender a node for
    # one revocation).
    trigger: str = ""


class ElasticResizer:
    """Pure shrink/grow decision over heartbeat + inventory signals.

    ``min_dp``/``max_dp`` bound the legal DP degrees (from
    ``spec.elastic``); the window knobs come from the same block so a
    chaos e2e can run the whole cycle in seconds while production
    defaults ride out transient blips."""

    def __init__(
        self,
        min_dp: int,
        max_dp: int,
        dead_after_s: float = 10.0,
        grow_hold_s: float = 10.0,
        cooldown_s: float = 30.0,
        resize_on_permanent_loss: bool = True,
        clock: Callable[[], float] = time.monotonic,
    ):
        if min_dp < 1 or max_dp < min_dp:
            raise ValueError(
                f"need 1 <= min_dp <= max_dp, got [{min_dp}, {max_dp}]")
        self.min_dp = int(min_dp)
        self.max_dp = int(max_dp)
        self.dead_after_s = float(dead_after_s)
        self.grow_hold_s = float(grow_hold_s)
        self.cooldown_s = float(cooldown_s)
        self.resize_on_permanent_loss = bool(resize_on_permanent_loss)
        self.clock = clock
        # host -> last time it answered a sweep; a host with no entry
        # has never answered THIS episode and is treated as starting,
        # never as dead (see _maybe_shrink)
        self._last_seen: Dict[int, float] = {}
        self._grow_since: Optional[float] = None
        self._last_resize_at: Optional[float] = None
        self._last_healthy_step: Optional[int] = None

    # -------------------------------------------------------------- intake

    def note_resized(self, new_dp: int) -> None:
        """The caller ACTED on a verdict: arm the cooldown and clear
        every streak — the new gang is a new episode (its host set and
        heartbeat cadence have nothing to do with the old one's)."""
        self._last_resize_at = self.clock()
        self._grow_since = None
        self._last_seen.clear()

    # -------------------------------------------------------------- decide

    def observe(
        self,
        dp: int,
        hosts: int,
        stats: Optional[Dict[int, dict]] = None,
        attainable: Optional[int] = None,
        budget_left: Optional[int] = None,
        health: Optional[dict] = None,
    ) -> ResizeVerdict:
        """Judge one observation.

        ``dp``: the gang's current DP degree (nodes held).
        ``hosts``: expected live host count at this degree.
        ``stats``: the obs tick's heartbeat sweep (host → heartbeat);
        hosts absent from it did not answer.
        ``attainable``: nodes this job could hold right now = held +
        pool free (None = no scheduler; inventory triggers disabled).
        ``budget_left``: remaining resize/restart budget (None =
        unbounded).
        ``health``: the freshest ``step_health`` block, for the
        restore-ceiling gate.
        """
        now = self.clock()
        v = ResizeVerdict()
        for h, hb in (stats or {}).items():
            if isinstance(hb, dict):
                self._last_seen[int(h)] = now
        # drop hosts beyond the current width (stale entries from a
        # wider incarnation must not read as deaths)
        for h in [h for h in self._last_seen if h >= hosts]:
            del self._last_seen[h]

        v.restore_ceiling = self._health_ceiling(health)

        # the inventory shrink is DECISIVE and bypasses the cooldown:
        # the capacity is gone, waiting cannot help, and a degraded
        # gang falling through to a same-shape restart could never
        # place — the cooldown exists to damp flappy evidence, and a
        # ledger deficit is not flappy evidence
        verdict = self._inventory_shrink(v, dp, attainable)
        if verdict is None:
            if (self._last_resize_at is not None
                    and now - self._last_resize_at < self.cooldown_s):
                v.reason = (
                    f"resize cooldown "
                    f"({self._last_resize_at + self.cooldown_s - now:.1f}s"
                    f" left)")
                return v
            verdict = self._dead_host_shrink(v, dp, hosts, now)
        if verdict is None:
            verdict = self._maybe_grow(v, dp, now, attainable)
        if verdict is None:
            return v
        if budget_left is not None and budget_left <= 0:
            if verdict == ACTION_GROW:
                # a blocked GROW must never hurt the running gang: it
                # keeps training at its current width — only a shrink
                # the budget cannot back turns terminal (the gang
                # cannot run at its current shape at all)
                v.reason = (f"grow to DP={v.target_dp} wanted but the "
                            f"restart budget is spent; keeping DP={dp}")
                v.action = None
                v.target_dp = 0
                return v
            v.action = ACTION_EXHAUSTED
            v.reason = (f"resize wanted ({verdict}: DP={dp} -> "
                        f"DP={v.target_dp}) but the restart budget is spent")
            return v
        v.action = verdict
        return v

    # -------------------------------------------------------------- rules

    def _health_ceiling(self, health: Optional[dict]) -> Optional[int]:
        """Track the last healthy step off the freshest numerics block;
        return it as the restore ceiling iff the CURRENT block is
        poisoned (the training-health rule: a NaN step must never be the restore
        point — healthy runs get no ceiling at all)."""
        if not isinstance(health, dict):
            return None
        try:
            step = int(health.get("step", -1))
        except (TypeError, ValueError):
            return None
        nonfinite = 0.0
        try:
            nonfinite = float(health.get("nonfinite_grads", 0) or 0)
        except (TypeError, ValueError):
            nonfinite = 0.0
        bad = (nonfinite > 0
               or not _finite(health.get("loss"))
               or not _finite(health.get("grad_norm", 0.0)))
        if not bad:
            if step >= 0:
                # track the run, not a max(): a restore regresses the
                # step, and the ceiling must follow it DOWN — a stale
                # pre-resize high-water mark would exclude nothing of
                # the new run's poisoned window
                self._last_healthy_step = step
            return None
        return self._last_healthy_step if self._last_healthy_step is not None \
            else 0

    def _clamp_target(self, v: ResizeVerdict, want: int, dp: int,
                      why: str) -> Optional[str]:
        target = min(self.max_dp, want)
        if target < self.min_dp:
            v.reason = (f"{why}, but DP={target} is below minDpDegree="
                        f"{self.min_dp} — no legal shape fits; not resizing")
            return None
        if target == dp:
            v.reason = f"{why}, already at DP={dp}"
            return None
        v.target_dp = target
        v.reason = why
        return ACTION_SHRINK if target < dp else ACTION_GROW

    def _inventory_shrink(self, v: ResizeVerdict, dp: int,
                          attainable: Optional[int]) -> Optional[str]:
        """Inventory trigger: the ledger says the capacity is gone."""
        if not self.resize_on_permanent_loss:
            return None
        if attainable is None or attainable >= dp:
            return None
        got = self._clamp_target(
            v, attainable, dp,
            f"inventory shrink: {attainable} attainable node(s) "
            f"< DP={dp}")
        if got == ACTION_SHRINK:
            v.trigger = "inventory"
            return got
        return None

    def _dead_host_shrink(self, v: ResizeVerdict, dp: int, hosts: int,
                          now: float) -> Optional[str]:
        if not self.resize_on_permanent_loss:
            return None
        # dead-heartbeat trigger: a host that WAS answering went silent
        # past the window while a peer still answers. Never-seen hosts
        # are STARTING, not dead — judging them from the monitor floor
        # would declare a pod that boots slower than the window (image
        # pull, CUDA init) permanently lost and flap a fresh grow right
        # back into a shrink.
        stats_alive = [h for h, t in self._last_seen.items()
                       if now - t < self.dead_after_s]
        if not stats_alive:
            return None  # nobody answering: outage or startup, not loss
        dead = tuple(sorted(
            h for h, t in self._last_seen.items()
            if now - t >= self.dead_after_s))
        if not dead:
            return None
        hosts_per_node = max(1, hosts // max(1, dp))
        lost_nodes = len({h // hosts_per_node for h in dead})
        v.dead_hosts = dead
        got = self._clamp_target(
            v, dp - lost_nodes, dp,
            f"host(s) {list(dead)} heartbeat-dead for >= "
            f"{self.dead_after_s:g}s ({lost_nodes} node(s) presumed "
            f"permanently lost)")
        if got == ACTION_SHRINK:
            v.trigger = "dead-hosts"
            return got
        return None

    def _maybe_grow(self, v: ResizeVerdict, dp: int, now: float,
                    attainable: Optional[int]) -> Optional[str]:
        if attainable is None or attainable <= dp or dp >= self.max_dp:
            self._grow_since = None
            return None
        if self._grow_since is None:
            self._grow_since = now
        held = now - self._grow_since
        if held < self.grow_hold_s:
            v.reason = (f"capacity returned ({attainable} attainable > "
                        f"DP={dp}); holding {self.grow_hold_s - held:.1f}s "
                        f"more for stability")
            return None
        got = self._clamp_target(
            v, attainable, dp,
            f"capacity returned: {attainable} attainable node(s) held "
            f"for >= {self.grow_hold_s:g}s")
        if got is not None:
            v.trigger = "capacity-return"
        return got
