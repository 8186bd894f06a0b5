"""Cluster scheduler decision core (the port's copy of
``k8s_tpu/sched/scheduler.py``; docs/SCHEDULER.md).

In the port the ledger's unit is a GPU node where the JAX package's is
a TPU slice, and quotas are metered in cards where it meters chips
(:mod:`k8s_tpu_torch.sched.inventory` maps the terms); the rules below
are the JAX ones, word for word, with "slices" read as nodes and
"CHIPS" as cards.

Pure decision logic in the StragglerDetector/SloAutoscaler idiom: an
injected clock, no I/O, no threads — the Controller feeds it job
requests and drives :meth:`ClusterScheduler.tick`; every verdict is
returned as data for the operator to act on (spawn a reconciler, drive
a preempt flush, export gauges). That is what makes the whole decision
table unit-testable on a fake clock, including the O(100)-job scale
matrix.

Decision rules, in order, per tick (full table in docs/SCHEDULER.md):

1. pending jobs are scanned by (priority desc, submit order) —
   priority orders admission, FIFO breaks ties;
2. a re-queued preemption victim in its cooldown window is skipped
   (no-flap: a victim must not be re-admitted into the churn that just
   evicted it);
3. per-queue quota is metered in CHIPS: a queue at quota blocks only
   its own jobs, never the other queues;
4. a job whose whole gang footprint fits is admitted — slices charge
   atomically, a partial gang is never placed;
5. a job that does not fit may PREEMPT: victims must be preemptible,
   strictly lower priority, on the same accelerator; they are chosen
   by (priority asc, checkpoint cost asc) — cost = steps at risk since
   the victim's last healthy checkpoint, read from the goodput
   telemetry — and only taken if the freed slices actually fit the
   preemptor (never preempt uselessly);
6. a capacity-blocked job RESERVES its accelerator for the rest of the
   scan: nothing behind it in the order may backfill onto that pool
   (starvation protection for big gangs — head-of-line reservation);
7. with ``backfill=True`` (docs/SCHEDULER.md "Placement"), the
   reservation is priced instead of absolute: the reserved job gets an
   expected-start horizon (free slices + slices it could preempt at
   any moment + declared ``runtimeEstimateSeconds`` finish times of
   the jobs it is waiting out), and a strictly-smaller job behind it
   may slot into the gap ONLY when it provably cannot move that
   horizon — it finishes before the horizon, or the pool still holds
   the reserved gang's slices at the horizon even with it running.
   Zero starvation is asserted per round: after the scan the horizon
   is recomputed and must not have regressed (:class:`StarvationError`
   is a scheduler bug, exactly like OversubscriptionError).
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from k8s_tpu_torch.sched.inventory import Footprint, SliceInventory

log = logging.getLogger(__name__)

DEFAULT_QUEUE = "default"
# Re-admission hold-off after a preemption: long enough for the
# victim's preempt flush + teardown to land before its next placement
# is even considered (no-flap), short enough that a freed slice is
# never idle for long. Overridable per scheduler (tests run it at 0).
DEFAULT_PREEMPTION_COOLDOWN = 5.0


class StarvationError(RuntimeError):
    """A backfill admission moved a reserved job's expected-start
    horizon later (scheduler invariant bug — backfill must be free)."""


@dataclass
class JobRequest:
    """One job as the scheduler sees it (derived from spec.scheduling
    + the footprint lookup; the scheduler never reads a CRD).

    ``runtime_estimate_s`` is the operator-declared expected runtime
    (``scheduling.runtimeEstimateSeconds``; 0 = undeclared). It is
    advisory and only ever used by conservative backfill — a job is
    never killed for outliving its estimate, it just stops being
    eligible to slot into reservation gaps."""

    key: str
    footprint: Footprint = field(default_factory=Footprint)
    priority: int = 0
    queue: str = DEFAULT_QUEUE
    preemptible: bool = True
    runtime_estimate_s: float = 0.0
    seq: int = 0  # submit order, assigned by the scheduler

    def sort_key(self):
        return (-self.priority, self.seq)


@dataclass(frozen=True)
class Preemption:
    """One eviction verdict: ``victim`` loses its slices to
    ``preemptor``; ``cost`` is the victim's priced checkpoint cost
    (steps at risk since its last save) at decision time."""

    victim: str
    preemptor: str
    queue: str  # the VICTIM's queue
    cost: int = 0


@dataclass
class TickResult:
    admitted: List[JobRequest] = field(default_factory=list)
    preempted: List[Preemption] = field(default_factory=list)
    # key → human-readable reason the job stayed queued this tick
    blocked: Dict[str, str] = field(default_factory=dict)
    # key → machine-readable WHY for the same jobs, one of BLOCKED_*:
    # the reconciler surfaces this in the Queued condition so a parked
    # job tells the operator which lever (quota? capacity? estimate?)
    # would move it
    blocked_category: Dict[str, str] = field(default_factory=dict)
    # the admitted keys that entered through a reservation gap
    backfilled: List[str] = field(default_factory=list)


# blocked_category vocabulary (stable strings — surfaced in conditions)
BLOCKED_COOLDOWN = "cooldown"
BLOCKED_QUOTA = "quota"
BLOCKED_NO_POOL = "no-pool"
BLOCKED_CAPACITY = "capacity"
BLOCKED_RESERVATION = "reservation"
BLOCKED_BACKFILL_REFUSED = "backfill-refused"


@dataclass
class _Reservation:
    """Head-of-line reservation, priced: ``horizon`` is the absolute
    clock time the reserved gang can expect to start (``math.inf``
    when the jobs it waits on declared no runtime estimate), and
    ``avail_at_horizon`` the slices projected free at that instant —
    current free + slices held by jobs the reserved gang may preempt
    whenever it likes (the victim-pricing input: their eviction is
    already paid for by priority) + slices returned by declared-
    estimate finishes. Slack-based backfill draws this balance down;
    it must never dip below the reserved gang's own need."""

    key: str
    slices: int
    horizon: float
    avail_at_horizon: int


class ClusterScheduler:
    """Quota + priority + bin-packing + preemption over one inventory.

    ``quotas`` meters chips per queue (absent queue = unlimited).
    ``cost_fn(key) -> int`` prices a running job's eviction (steps at
    risk since its last healthy checkpoint — the operator wires it to
    the goodput telemetry; defaults to 0 = cheapest).
    ``backfill`` turns the head-of-line reservation from an absolute
    wall into a priced one (decision rule 7; default off — the
    decision table is bit-identical to the pre-backfill scheduler
    until the operator opts in)."""

    def __init__(
        self,
        inventory: SliceInventory,
        quotas: Optional[Dict[str, int]] = None,
        clock: Callable[[], float] = time.monotonic,
        cost_fn: Optional[Callable[[str], int]] = None,
        preemption_cooldown: float = DEFAULT_PREEMPTION_COOLDOWN,
        backfill: bool = False,
    ):
        self.inventory = inventory
        self.quotas = dict(quotas or {})
        self.clock = clock
        self.cost_fn = cost_fn
        self.preemption_cooldown = preemption_cooldown
        self.backfill = backfill
        self._pending: Dict[str, JobRequest] = {}
        self._running: Dict[str, JobRequest] = {}
        self._holdoff: Dict[str, float] = {}
        # when each running job was (re-)admitted: remaining-runtime
        # estimates for the backfill horizon count from here
        self._admitted_at: Dict[str, float] = {}
        # every key that has ever held a head-of-line reservation, and
        # the cumulative backfill count — the bench's starvation audit
        # and the ktpu_sched_backfill_total counter feed
        self.reserved_ever: set = set()
        self.backfills_total = 0
        self._last_blocked: Dict[str, Tuple[str, str]] = {}
        self._seq = 0
        import threading

        self._lock = threading.RLock()

    # ------------------------------------------------------------- intake

    def submit(self, req: JobRequest) -> bool:
        """Enqueue a job (idempotent: a key already pending or running
        is left untouched — watch replays must not re-order the queue).
        Returns True when the request was newly enqueued."""
        with self._lock:
            if req.key in self._pending or req.key in self._running:
                return False
            self._seq += 1
            req.seq = self._seq
            self._pending[req.key] = req
            return True

    def update_pending(self, req: JobRequest) -> bool:
        """Replace a PENDING job's terms in place (spec edited while
        queued — no reconciler exists to police immutability yet, and
        the ledger must charge what the reconciler will actually
        materialize on admission). Queue position (seq) and any
        cooldown are preserved. Running jobs are left alone: their
        charge reflects placed reality."""
        with self._lock:
            cur = self._pending.get(req.key)
            if cur is None:
                return False
            req.seq = cur.seq
            self._pending[req.key] = req
            return True

    def adopt_running(self, req: JobRequest) -> None:
        """Adoption path (operator restart): the gang is already
        physically running, so it is charged FORCE — the ledger must
        reflect reality even if a config shrink made reality exceed
        capacity (logged; the pool admits nothing until it drains)."""
        with self._lock:
            if req.key in self._running:
                return
            self._pending.pop(req.key, None)
            self._seq += 1
            req.seq = self._seq
            if not self.inventory.fits(req.footprint):
                log.warning(
                    "adopting %s (%s) over capacity — fleet shrank "
                    "under a running gang; pool blocked until it drains",
                    req.key, req.footprint)
            self.inventory.charge(req.key, req.footprint, force=True)
            self._running[req.key] = req
            # estimates restart from adoption time: conservative (an
            # adopted gang mid-run looks LONGER than it is, never
            # shorter — backfill horizons may only be pessimistic)
            self._admitted_at[req.key] = self.clock()

    def remove(self, key: str) -> bool:
        """The job is gone (terminal or deleted): drop it from wherever
        it is and free its slices."""
        with self._lock:
            self._holdoff.pop(key, None)
            self._admitted_at.pop(key, None)
            if self._pending.pop(key, None) is not None:
                return True
            if self._running.pop(key, None) is not None:
                self.inventory.release(key)
                return True
            return False

    def reinstate(self, req: JobRequest) -> None:
        """Return a just-admitted job to the queue WITHOUT losing its
        submit order — the operator could not act on the admission
        (previous reconciler still winding down, or the footprint
        changed under the decision). Slices are released; ``req.seq``
        is preserved so the job keeps its head-of-line position (the
        no-flap contract ``requeue`` honors for preemption victims);
        no cooldown — nothing was torn down."""
        with self._lock:
            if self._running.pop(req.key, None) is not None:
                self.inventory.release(req.key)
            self._admitted_at.pop(req.key, None)
            if req.seq <= 0:
                self._seq += 1
                req.seq = self._seq
            self._pending[req.key] = req

    def resize_running(self, key: str, new_fp: Footprint,
                       require_pool_deficit: bool = False) -> bool:
        """Re-admit a RUNNING job's reshaped footprint in place — the
        elastic-resize ledger move (docs/ELASTIC.md): the inventory
        swap is atomic (shrink frees slices, grow re-charges them, the
        high-water mark never sees both shapes at once), and the
        running request's terms are updated so later decisions (quota
        pricing, victim selection) see the real shape. Returns False —
        changing nothing — when the job is not running here, the grown
        footprint does not fit, or ``require_pool_deficit`` is set and
        the pool is no longer over-subscribed (an inventory-triggered
        shrink whose deficit another gang's shrink already absorbed:
        N gangs sharing a pool must surrender exactly ONE slice per
        revoked slice, not one each); the caller keeps the old shape
        and re-decides against the fresh inventory next tick."""
        with self._lock:
            req = self._running.get(key)
            if req is None:
                return False
            if (require_pool_deficit
                    and self.inventory.available(new_fp.accelerator) >= 0):
                log.info(
                    "inventory-triggered shrink of %s refused: pool "
                    "'%s' deficit already absorbed", key,
                    new_fp.accelerator)
                return False
            try:
                self.inventory.recharge(key, new_fp)
            except Exception as e:
                log.warning("resize of %s to %s refused: %s",
                            key, new_fp, e)
                return False
            req.footprint = new_fp
            return True

    def requeue(self, key: str, cooldown: Optional[float] = None) -> bool:
        """Move a RUNNING job back to the queue (the preemption /
        chaos-eviction path): slices freed, original submit order kept
        (a victim re-enters ahead of later arrivals at its priority),
        re-admission held off for the cooldown window."""
        with self._lock:
            req = self._running.pop(key, None)
            if req is None:
                return False
            self.inventory.release(key)
            self._admitted_at.pop(key, None)
            self._pending[key] = req
            cd = self.preemption_cooldown if cooldown is None else cooldown
            self._holdoff[key] = self.clock() + cd
            return True

    # ------------------------------------------------------------- reads

    def running_keys(self, preemptible_only: bool = False) -> List[str]:
        with self._lock:
            return sorted(
                k for k, r in self._running.items()
                if (not preemptible_only
                    or (r.preemptible and not r.footprint.empty)))

    def pending_keys(self) -> List[str]:
        with self._lock:
            return sorted(self._pending)

    def next_holdoff_expiry(self) -> Optional[float]:
        """Clock time when the earliest pending job's preemption
        cooldown expires (None = nothing held). The event-driven tick
        loop wakes exactly then instead of discovering the expiry one
        periodic backstop later (docs/SCHEDULER.md)."""
        with self._lock:
            now = self.clock()
            expiries = [t for k, t in self._holdoff.items()
                        if k in self._pending and t > now]
            return min(expiries) if expiries else None

    def is_running(self, key: str) -> bool:
        with self._lock:
            return key in self._running

    def running_request(self, key: str) -> Optional[JobRequest]:
        with self._lock:
            return self._running.get(key)

    def queue_used_chips(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for r in self._running.values():
                out[r.queue] = out.get(r.queue, 0) + r.footprint.chips
            return out

    def stats(self) -> Dict[str, Dict]:
        """The gauge feed (ktpu_sched_*): queue depths, quota usage,
        free slices per pool, per-pool placement scoring, and the last
        tick's per-job blocked verdicts (category + readable reason —
        the Queued-condition diagnosability feed)."""
        with self._lock:
            depth: Dict[str, int] = {}
            for r in self._pending.values():
                depth[r.queue] = depth.get(r.queue, 0) + 1
            return {
                "queue_depth": depth,
                "quota_used_chips": self.queue_used_chips(),
                "pools": self.inventory.snapshot(),
                "placement": self.inventory.placement_stats(),
                "running": len(self._running),
                "pending": len(self._pending),
                "backfills_total": self.backfills_total,
                "blocked": {
                    k: {"category": c, "reason": r}
                    for k, (c, r) in self._last_blocked.items()
                    if k in self._pending
                },
            }

    # ------------------------------------------------------------- decide

    def tick(self) -> TickResult:
        """One scheduling round over the pending queue. Deterministic:
        same submissions + same clock ⇒ same decisions, in the same
        order (the O(100) scale test replays a whole run twice and
        compares decision logs)."""
        with self._lock:
            now = self.clock()
            result = TickResult()
            reserved: Dict[str, _Reservation] = {}  # accelerator → head
            quota_used = self.queue_used_chips()
            for req in sorted(self._pending.values(),
                              key=JobRequest.sort_key):
                fp = req.footprint
                hold = self._holdoff.get(req.key, 0.0)
                if now < hold:
                    self._block(result, req, BLOCKED_COOLDOWN,
                                f"preemption cooldown "
                                f"({hold - now:.1f}s left)")
                    continue
                if fp.empty:
                    self._admit(req, result, quota_used)
                    continue
                quota = self.quotas.get(req.queue)
                used = quota_used.get(req.queue, 0)
                if quota is not None and used + fp.chips > quota:
                    self._block(result, req, BLOCKED_QUOTA,
                                f"queue '{req.queue}' quota: "
                                f"{used}+{fp.chips} > {quota} cards")
                    continue
                if not self.inventory.knows(fp.accelerator):
                    self._block(result, req, BLOCKED_NO_POOL,
                                f"fleet has no '{fp.accelerator}' pool")
                    continue
                if fp.accelerator in reserved:
                    res = reserved[fp.accelerator]
                    if not self.backfill:
                        self._block(result, req, BLOCKED_RESERVATION,
                                    f"held behind higher-priority "
                                    f"{res.key} waiting on "
                                    f"{fp.accelerator}")
                        continue
                    ok, why = self._backfill_check(req, res, now)
                    if ok:
                        self._admit(req, result, quota_used)
                        result.backfilled.append(req.key)
                        self.backfills_total += 1
                        continue
                    self._block(result, req, BLOCKED_BACKFILL_REFUSED,
                                f"backfill behind {res.key} refused: "
                                f"{why}")
                    continue
                if self.inventory.fits(fp):
                    self._admit(req, result, quota_used)
                    continue
                victims = self._select_victims(req)
                if victims is None:
                    self._block(result, req, BLOCKED_CAPACITY,
                                f"capacity: {fp} > "
                                f"{self.inventory.available(fp.accelerator)} "
                                f"free {fp.accelerator} nodes")
                    # head-of-line reservation: nothing behind this job
                    # may take the pool it is waiting for — except,
                    # under rule 7, a backfill that provably cannot
                    # delay it
                    reserved[fp.accelerator] = self._reservation_for(
                        req, now)
                    self.reserved_ever.add(req.key)
                    continue
                for victim, cost in victims:
                    self._running.pop(victim.key, None)
                    self.inventory.release(victim.key)
                    self._admitted_at.pop(victim.key, None)
                    self._pending[victim.key] = victim
                    self._holdoff[victim.key] = (
                        now + self.preemption_cooldown)
                    quota_used[victim.queue] = max(
                        0, quota_used.get(victim.queue, 0)
                        - victim.footprint.chips)
                    result.preempted.append(Preemption(
                        victim=victim.key, preemptor=req.key,
                        queue=victim.queue, cost=cost))
                self._admit(req, result, quota_used)
            # zero-starvation invariant, asserted every round exactly
            # like the oversubscription high-water mark: whatever this
            # round backfilled, no reservation's expected start may
            # have moved later. A violation is a bug in the safety
            # rules, not an operational condition.
            if self.backfill:
                for accel, res in reserved.items():
                    head = self._pending.get(res.key)
                    if head is None:
                        continue
                    fresh = self._reservation_for(head, now)
                    if fresh.horizon > res.horizon + 1e-6:
                        raise StarvationError(
                            f"backfill delayed reserved {res.key} on "
                            f"{accel}: expected start moved "
                            f"{res.horizon:.1f} → {fresh.horizon:.1f}")
            self._last_blocked = {
                k: (result.blocked_category[k], r)
                for k, r in result.blocked.items()
            }
            return result

    @staticmethod
    def _block(result: TickResult, req: JobRequest, category: str,
               reason: str) -> None:
        result.blocked[req.key] = reason
        result.blocked_category[req.key] = category

    def _remaining_estimate(self, req: JobRequest,
                            now: float) -> Optional[float]:
        """Declared-estimate remaining runtime of a RUNNING job (None
        when it declared nothing — an unbounded job for horizon math)."""
        est = req.runtime_estimate_s or 0.0
        if est <= 0:
            return None
        started = self._admitted_at.get(req.key, now)
        return max(0.0, est - (now - started))

    def _reservation_for(self, req: JobRequest,
                         now: float) -> _Reservation:
        """Price the head-of-line reservation: walk the pool's running
        jobs; slices held by jobs ``req`` may preempt at will (its
        priced victims) count as available immediately, declared-
        estimate jobs return their slices at their expected finish,
        undeclared jobs never (math.inf — conservative). The horizon is
        the earliest instant the cumulative balance covers the gang."""
        fp = req.footprint
        free = max(0, self.inventory.available(fp.accelerator))
        victim_slices = 0
        finishers: List[Tuple[float, int]] = []  # (remaining_s, slices)
        for r in self._running.values():
            if (r.footprint.empty
                    or r.footprint.accelerator != fp.accelerator):
                continue
            if r.preemptible and r.priority < req.priority:
                victim_slices += r.footprint.slices
                continue
            rem = self._remaining_estimate(r, now)
            if rem is not None:
                finishers.append((rem, r.footprint.slices))
        finishers.sort()
        have = free + victim_slices
        horizon = math.inf
        if have >= fp.slices:  # races only: tick would have admitted
            horizon = now
        else:
            for rem, s in finishers:
                have += s
                if have >= fp.slices:
                    horizon = now + rem
                    break
        if math.isinf(horizon):
            avail = free + victim_slices
        else:
            avail = free + victim_slices + sum(
                s for rem, s in finishers
                if now + rem <= horizon + 1e-9)
        return _Reservation(req.key, fp.slices, horizon, avail)

    def _backfill_check(self, req: JobRequest, res: _Reservation,
                        now: float) -> Tuple[bool, str]:
        """Decision rule 7's safety proof, per candidate. A backfill is
        admitted only on one of two grounds, both of which keep the
        reservation horizon fixed by construction:

        - **gap-fit**: the candidate declared a runtime estimate and
          finishes before the horizon — the slices it borrows are back
          before the reserved gang can use them;
        - **slack**: even if the candidate runs forever, the pool still
          holds the reserved gang's slices at the horizon
          (``avail_at_horizon`` is drawn down so stacked backfills
          share one slack budget, not each the whole of it).

        Everything else — bigger-than-the-gang, no free slices, no
        declared estimates to price the horizon with — is refused with
        the reason in hand."""
        fp = req.footprint
        if fp.slices >= res.slices:
            return False, (
                f"{fp.slices} nodes is not strictly smaller than the "
                f"reserved gang's {res.slices}")
        if not self.inventory.fits(fp):
            return False, "no free nodes to backfill into"
        if math.isinf(res.horizon):
            return False, (
                "reservation has no expected-start horizon (running "
                "jobs declared no runtimeEstimateSeconds)")
        est = req.runtime_estimate_s or 0.0
        if est > 0 and now + est <= res.horizon + 1e-9:
            return True, "fits inside the reservation gap"
        if res.avail_at_horizon - fp.slices >= res.slices:
            res.avail_at_horizon -= fp.slices
            return True, "leaves slack at the reservation horizon"
        return False, (
            f"would hold nodes the reserved gang needs at its "
            f"expected start (in {res.horizon - now:.1f}s)")

    def _admit(self, req: JobRequest, result: TickResult,
               quota_used: Dict[str, int]) -> None:
        self._pending.pop(req.key, None)
        self._holdoff.pop(req.key, None)
        self.inventory.charge(req.key, req.footprint)  # raises on bug
        self._running[req.key] = req
        self._admitted_at[req.key] = self.clock()
        quota_used[req.queue] = (
            quota_used.get(req.queue, 0) + req.footprint.chips)
        result.admitted.append(req)

    def _select_victims(self, req: JobRequest):
        """Pick the cheapest sufficient victim set for ``req``:
        candidates are preemptible, STRICTLY lower priority, on the
        same pool; ordered by (priority asc, checkpoint cost asc,
        newest first) so the least important work with the least
        un-checkpointed progress is evicted first. Returns
        ``[(victim, cost), ...]`` or None when even evicting every
        candidate would not fit the gang — in which case nobody is
        evicted at all (an eviction that cannot place the preemptor is
        pure loss)."""
        fp = req.footprint
        cands = []
        for r in self._running.values():
            if (not r.preemptible or r.footprint.empty
                    or r.footprint.accelerator != fp.accelerator
                    or r.priority >= req.priority):
                continue
            cost = 0
            if self.cost_fn is not None:
                try:
                    cost = max(0, int(self.cost_fn(r.key)))
                except Exception:  # pricing must never break placement
                    cost = 0
            cands.append((r, cost))
        cands.sort(key=lambda rc: (rc[0].priority, rc[1], -rc[0].seq))
        freed = 0
        chosen = []
        available = self.inventory.available(fp.accelerator)
        for r, cost in cands:
            if available + freed >= fp.slices:
                break
            chosen.append((r, cost))
            freed += r.footprint.slices
        if available + freed < fp.slices:
            return None
        return chosen
