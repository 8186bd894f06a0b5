"""Node inventory: the cluster's GPU capacity model (the port's copy of
``k8s_tpu/sched/inventory.py``, whose ledger counts TPU slices).

Two jobs placed independently can both believe they own the last free
node. This module gives the operator ONE ledger of truth:

- capacity comes from the controller-config ``fleet:`` block
  (accelerator → number of NODES of that shape the cluster owns, e.g.
  ``h100-80gb: 4`` for four 8-card HGX nodes, ``h100-80gb-x1: 1`` for
  one one-card machine);
- every admitted job is charged its **gang footprint**, derived from
  ``spec.gpu`` through :class:`k8s_tpu_torch.spec.topology.GpuTopology`:
  a gang of ``numCards`` cards charges ``GpuTopology.nodes(numCards)``
  WHOLE nodes atomically, as a TPU gang charges whole slices — there
  is no partial gang. A job of fewer cards than a node still charges
  that node (no two jobs share a node; node sharing is later work,
  ROADMAP A12.3's note).

The mapping from the JAX package's ledger, term by term:

=====================================  ==================================
JAX (TPU)                              port (GPU)
=====================================  ==================================
a slice of ``spec.tpu.accelerator``     a node of ``spec.gpu.accelerator``
``numSlices`` slices per gang          ``GpuTopology.nodes(numCards)``
chips (slices × chips/slice)           cards (nodes × cards/node)
``PoolTopology``: ICI pods ×           leaf switches × nodes per switch
``slicesPerPod`` (contiguous in a pod) (NVLink/InfiniBand rail-local in
                                       one leaf switch; ``leafSwitches``
                                       and ``nodesPerSwitch`` in the
                                       controller config)
=====================================  ==================================

The field names stay the JAX ones, so one decision core serves both:
:class:`Footprint` ``slices`` counts nodes and ``chips`` counts cards,
and per-queue quotas are metered in cards. Serving fleets are a later slice (ROADMAP A12.5),
so no footprint is ``per_replica`` here.

The inventory enforces the zero-oversubscription invariant at the
charge site — :class:`OversubscriptionError` is a scheduler bug, not a
recoverable condition — and keeps a high-water mark per accelerator so
tests can assert the invariant held across a whole run, not just at
the end.

Placement: a pool may additionally declare a :class:`PoolTopology` —
its nodes become NAMED positions on a grid of leaf switches (each a
linear chain of ``slices_per_pod`` node positions; a gang inside one
switch talks without crossing the spine). ``charge`` then also plans
and returns a :class:`SliceAssignment` — which concrete positions the
gang holds — via the pure scorer :func:`plan_placement`: multi-node
gangs prefer a block under one switch, single nodes best-fit into the
smallest free block so the large blocks future gangs need stay whole.
The counting ledger stays the ONLY admission authority: with no
topology configured nothing below changes at all, and even with one,
placement annotates decisions but never vetoes them (a gang that fits
by count but not under one switch is placed across switches, not
refused).
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from k8s_tpu_torch.spec import topology as topo


class OversubscriptionError(RuntimeError):
    """A charge would exceed fleet capacity (scheduler invariant bug)."""


@dataclass(frozen=True)
class Footprint:
    """What one admitted job costs the fleet.

    ``slices`` whole nodes of ``accelerator`` are charged atomically;
    ``chips`` (= nodes × cards/node) is the quota currency, in cards —
    queues meter cards so an 8-card HGX node counts 8× a one-card
    machine wherever quotas mix shapes. ``per_replica`` marks serving
    fleets (the JAX field; no port footprint sets it yet)."""

    accelerator: str = ""
    slices: int = 0
    chips: int = 0
    per_replica: bool = False

    @property
    def empty(self) -> bool:
        """Zero-footprint jobs (no ``gpu:`` block — CPU smoke jobs,
        control-plane-only workloads) bypass the inventory entirely."""
        return self.slices <= 0 or not self.accelerator

    def __str__(self) -> str:
        if self.empty:
            return "no accelerator footprint"
        kind = "replica-node" if self.per_replica else "node"
        return (f"{self.slices} × {self.accelerator} {kind}"
                f"{'s' if self.slices != 1 else ''} ({self.chips} cards)")


def footprint_of(spec) -> Footprint:
    """Derive a job spec's gang footprint from its ``gpu:`` block: the
    ``GpuTopology.nodes(numCards)`` whole nodes, metered at their cards.
    Unknown accelerators yield an EMPTY footprint on purpose: the spec
    will fail validation in the reconciler with the readable error,
    instead of queueing forever behind capacity that cannot exist."""
    gpu = getattr(spec, "gpu", None)
    if gpu is None or not gpu.accelerator:
        return Footprint()
    t = topo.lookup(gpu.accelerator)
    if t is None:
        return Footprint()
    n = t.nodes(max(1, int(gpu.num_cards or 1)))
    return Footprint(gpu.accelerator, slices=n, chips=n * t.cards_per_node)


# ---------------------------------------------------------------------------
# Named nodes: pool topology + assignments + the pure placement scorer
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PoolTopology:
    """Network shape of one pool: ``pods`` leaf switches
    (``leafSwitches``), each a linear chain of ``slices_per_pod`` node
    positions (``nodesPerSwitch``). Position ``p`` on the global grid
    hangs off switch ``p // slices_per_pod``; two positions are adjacent
    iff they are under the same switch at consecutive indices. (A
    linear chain is deliberately the whole model: it captures the thing
    the scorer must protect — blocks under one switch are scarce and
    fragmentation destroys them.) The field names are the JAX ones,
    where a "pod" is an ICI domain of slices."""

    pods: int
    slices_per_pod: int

    @property
    def positions(self) -> int:
        return self.pods * self.slices_per_pod

    def validate(self) -> None:
        if self.pods <= 0 or self.slices_per_pod <= 0:
            raise ValueError(
                f"pool topology needs positive leafSwitches/nodesPerSwitch, got "
                f"{self.pods}×{self.slices_per_pod}")


@dataclass(frozen=True)
class SliceAssignment:
    """Which concrete grid positions one admitted gang holds.
    ``contiguous`` is True when the whole gang sits on adjacent
    positions under one leaf switch (its collectives never cross the
    spine); single-node jobs are trivially contiguous."""

    accelerator: str
    positions: Tuple[int, ...]
    slices_per_pod: int
    contiguous: bool

    def pods(self) -> Tuple[int, ...]:
        return tuple(sorted({p // self.slices_per_pod
                             for p in self.positions}))

    def __str__(self) -> str:
        coords = ",".join(
            f"{p // self.slices_per_pod}.{p % self.slices_per_pod}"
            for p in self.positions)
        kind = "one-switch" if self.contiguous else "cross-switch"
        return f"{self.accelerator}[{coords}] ({kind})"


def _free_runs(free: Set[int], t: PoolTopology) -> List[Tuple[int, int]]:
    """Maximal runs of free positions that do not cross a pod boundary,
    as ``(start, length)`` ascending by start. Pure."""
    runs: List[Tuple[int, int]] = []
    start = None
    for p in range(t.positions):
        boundary = p % t.slices_per_pod == 0
        if p in free and not (boundary and start is not None):
            if start is None:
                start = p
            continue
        if start is not None:
            runs.append((start, p - start))
            start = None
        if p in free:  # run ended exactly at a pod boundary
            start = p
    if start is not None:
        runs.append((start, t.positions - start))
    return runs


def plan_placement(free: Set[int], t: PoolTopology, slices: int,
                   packing: bool = True) -> Tuple[Tuple[int, ...], bool]:
    """The pure placement scorer. Given the free positions of one pool,
    pick ``slices`` of them. Returns ``(positions, contiguous)``;
    callers guarantee ``len(free) >= slices`` (admission is counting).

    ``packing=True`` (the backfill+pack policy):

    - a multi-slice gang takes the SMALLEST free in-pod run that still
      holds it whole (best-fit: exact fits are consumed first, the big
      contiguous blocks survive for bigger gangs); when no single run
      fits, it falls back to consuming the smallest runs first — the
      fragments — so the spill costs the least future contiguity;
    - a single slice best-fits the same way: into the smallest run,
      never splitting a large block a gang could have used.

    ``packing=False`` models a topology-blind ledger: first-fit at the
    lowest free positions, whatever that does to the blocks."""
    if slices <= 0:
        return (), True
    runs = _free_runs(free, t)
    if not packing:
        chosen = sorted(free)[:slices]
        contiguous = any(
            s <= chosen[0] and chosen[-1] < s + ln
            for s, ln in runs) and (
            chosen[-1] - chosen[0] + 1 == slices)
        return tuple(chosen), contiguous
    fitting = [(ln, s) for s, ln in runs if ln >= slices]
    if fitting:
        ln, s = min(fitting)
        return tuple(range(s, s + slices)), True
    # no single in-pod run holds the gang: spend the smallest fragments
    # first so the largest surviving block stays as large as possible
    chosen: List[int] = []
    for ln, s in sorted((ln, s) for s, ln in runs):
        take = min(ln, slices - len(chosen))
        chosen.extend(range(s, s + take))
        if len(chosen) >= slices:
            break
    return tuple(sorted(chosen)), False


class SliceInventory:
    """The fleet ledger: capacity per accelerator type, charges per job.

    Thread-safe (the scheduler mutates it under its own lock, but
    metrics exporters and tests read it from other threads).

    ``topology`` optionally names the slices of some pools (see
    :class:`PoolTopology`); those pools additionally track WHICH
    positions each holder owns and ``charge``/``recharge`` return the
    planned :class:`SliceAssignment`. ``packing`` selects the scorer
    policy (:func:`plan_placement`); it changes assignments only,
    never admission counts."""

    def __init__(self, fleet: Dict[str, int],
                 topology: Optional[Dict[str, PoolTopology]] = None,
                 packing: bool = True):
        self._capacity: Dict[str, int] = {
            a: int(n) for a, n in (fleet or {}).items() if int(n) > 0
        }
        self._used: Dict[str, int] = {a: 0 for a in self._capacity}
        self._holders: Dict[str, Footprint] = {}
        self._lock = threading.RLock()
        # per-accelerator high-water mark: lets a scale test assert the
        # zero-oversubscription invariant held over the WHOLE run
        self.max_used: Dict[str, int] = {a: 0 for a in self._capacity}
        # capacity-return listeners (docs/ELASTIC.md): called with the
        # accelerator name whenever free slices INCREASE (a release, an
        # elastic shrink, a pool grow) — the elastic-resize grow tick.
        # Called OUTSIDE the lock: a listener that re-enters the
        # inventory (or nudges a reconciler) must never deadlock it.
        self._capacity_listeners: list = []
        # ------------------------------------------------ named slices
        self.packing = bool(packing)
        self._topology: Dict[str, PoolTopology] = {}
        # accelerator → position → holder key (occupied positions only)
        self._grid: Dict[str, Dict[int, str]] = {}
        # positions administratively off after a capacity shrink —
        # they stay on the grid (coordinates are physical) but the
        # scorer may not place on them
        self._revoked: Dict[str, Set[int]] = {}
        self._assignments: Dict[str, SliceAssignment] = {}
        # contiguity hit-rate inputs (multi-slice placements only)
        self.contiguity_requests: Dict[str, int] = {}
        self.contiguity_hits: Dict[str, int] = {}
        for a, t in (topology or {}).items():
            if a not in self._capacity:
                continue
            t.validate()
            self._topology[a] = t
            self._grid[a] = {}
            self._revoked[a] = set()
            self.contiguity_requests[a] = 0
            self.contiguity_hits[a] = 0
            self._sync_topology_locked(a)

    # ------------------------------------------------------------- reads

    def knows(self, accelerator: str) -> bool:
        with self._lock:
            return accelerator in self._capacity

    def capacity(self, accelerator: str) -> int:
        with self._lock:
            return self._capacity.get(accelerator, 0)

    def used(self, accelerator: str) -> int:
        with self._lock:
            return self._used.get(accelerator, 0)

    def available(self, accelerator: str) -> int:
        with self._lock:
            return (self._capacity.get(accelerator, 0)
                    - self._used.get(accelerator, 0))

    def fits(self, fp: Footprint) -> bool:
        if fp.empty:
            return True
        with self._lock:
            return (fp.accelerator in self._capacity
                    and self.available(fp.accelerator) >= fp.slices)

    def holder(self, key: str) -> Optional[Footprint]:
        with self._lock:
            return self._holders.get(key)

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        """Per-pool view for metrics/tests. ``free`` is clamped at 0:
        a pool driven over capacity by adoption or a config shrink has
        zero UNASSIGNED slices, not a negative number — the
        ktpu_sched_slices_free gauge must stay sane; ``available()``
        (the decision input) stays unclamped so admission still sees
        the deficit."""
        with self._lock:
            return {
                a: {"capacity": c, "used": self._used.get(a, 0),
                    "free": max(0, c - self._used.get(a, 0))}
                for a, c in self._capacity.items()
            }

    def topology(self, accelerator: str) -> Optional[PoolTopology]:
        with self._lock:
            return self._topology.get(accelerator)

    def assignment(self, key: str) -> Optional[SliceAssignment]:
        with self._lock:
            return self._assignments.get(key)

    def fragmentation(self, accelerator: str) -> float:
        """How broken the pool's free space is: ``1 − largest free
        in-pod run / total free positions`` (0 = every free slice sits
        in one contiguous block, →1 = pure confetti; 0 when the pool
        is full or has no topology)."""
        with self._lock:
            t = self._topology.get(accelerator)
            if t is None:
                return 0.0
            free = self._free_positions_locked(accelerator)
            if not free:
                return 0.0
            runs = _free_runs(free, t)
            return 1.0 - max(ln for _s, ln in runs) / len(free)

    def contiguity_hit_rate(self, accelerator: str) -> Optional[float]:
        """Fraction of multi-slice placements that landed ICI-contiguous
        (None until the pool has seen one)."""
        with self._lock:
            n = self.contiguity_requests.get(accelerator, 0)
            if n == 0:
                return None
            return self.contiguity_hits.get(accelerator, 0) / n

    def placement_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-topology-pool scoring feed (the ktpu_sched_fragmentation
        / contiguity gauges): empty when no pool declares a topology."""
        with self._lock:
            out: Dict[str, Dict[str, float]] = {}
            for a, t in self._topology.items():
                free = self._free_positions_locked(a)
                runs = _free_runs(free, t) if free else []
                out[a] = {
                    "fragmentation": self.fragmentation(a),
                    "largest_free_block": float(
                        max((ln for _s, ln in runs), default=0)),
                    "contiguity_requests": float(
                        self.contiguity_requests.get(a, 0)),
                    "contiguity_hits": float(
                        self.contiguity_hits.get(a, 0)),
                }
            return out

    # ------------------------------------------------------------- writes

    def charge(self, key: str, fp: Footprint,
               force: bool = False) -> Optional[SliceAssignment]:
        """Charge ``key``'s whole footprint atomically. ``force`` is the
        adoption path ONLY (an operator restart re-adopting a gang that
        is already physically running must never kill it over a ledger
        it cannot have corrupted) — everywhere else an over-capacity
        charge raises, because admitting past capacity is exactly the
        two-jobs-own-one-slice bug this subsystem exists to end.

        Returns the planned :class:`SliceAssignment` when the pool has
        a topology (None otherwise, and None for a force-charge the
        grid has no room for — the counting ledger still holds the
        charge; placement never overrules it)."""
        if fp.empty:
            return None
        with self._lock:
            self._charge_count_locked(key, fp, force)
            return self._place_locked(key, fp)

    def _charge_count_locked(self, key: str, fp: Footprint,
                             force: bool) -> None:
        if key in self._holders:
            raise ValueError(f"{key} is already charged")
        if not force and not self.fits(fp):
            raise OversubscriptionError(
                f"charging {key} ({fp}) would oversubscribe "
                f"{fp.accelerator}: used {self.used(fp.accelerator)}"
                f"/{self.capacity(fp.accelerator)} nodes")
        self._used[fp.accelerator] = (
            self._used.get(fp.accelerator, 0) + fp.slices)
        self._capacity.setdefault(fp.accelerator, 0)
        self._holders[key] = fp
        self.max_used[fp.accelerator] = max(
            self.max_used.get(fp.accelerator, 0),
            self._used[fp.accelerator])

    def release(self, key: str) -> Optional[Footprint]:
        with self._lock:
            fp = self._holders.pop(key, None)
            if fp is not None:
                self._used[fp.accelerator] = max(
                    0, self._used.get(fp.accelerator, 0) - fp.slices)
                self._unplace_locked(key, fp.accelerator)
        if fp is not None and not fp.empty:
            self._notify_capacity(fp.accelerator)
        return fp

    def recharge(self, key: str, fp: Footprint) -> Optional[SliceAssignment]:
        """Atomically replace ``key``'s charge with ``fp`` — the
        elastic-resize ledger move (docs/ELASTIC.md): a shrink frees
        slices and a grow re-charges them in ONE critical section, so
        no observer (and no high-water mark) ever sees the job owning
        both shapes at once, and a grow that would oversubscribe raises
        WITHOUT losing the old charge (the gang still physically holds
        its current slices). On a topology pool the gang resizes IN
        PLACE: a shrink surrenders its highest positions, a grow
        extends from its existing ones — a resize is a re-partition of
        the same hardware, not a move."""
        freed = False
        with self._lock:
            old = self._holders.pop(key, None)
            old_asg = self._assignments.get(key)
            if old is not None:
                self._used[old.accelerator] = max(
                    0, self._used.get(old.accelerator, 0) - old.slices)
                self._unplace_locked(key, old.accelerator, sync=False)
            try:
                if not fp.empty:
                    self._charge_count_locked(key, fp, force=False)
            except Exception:
                if old is not None:  # restore the old charge untouched
                    self._used[old.accelerator] = (
                        self._used.get(old.accelerator, 0) + old.slices)
                    self._holders[key] = old
                    if old_asg is not None:
                        self._restore_locked(key, old_asg)
                raise
            asg = (self._place_locked(key, fp, prefer=old_asg)
                   if not fp.empty else None)
            if old is not None:
                self._sync_topology_locked(old.accelerator)
            freed = (old is not None and not old.empty
                     and (fp.empty or fp.slices < old.slices
                          or fp.accelerator != old.accelerator))
        if freed:
            self._notify_capacity(old.accelerator)
        return asg

    def set_capacity(self, accelerator: str, slices: int) -> None:
        """Resize one pool (node-pool scale events, the
        permanent-pod-loss chaos fault). Shrinking below current usage
        never retro-preempts — running gangs keep their slices and the
        pool simply admits nothing until it drains back under the new
        capacity (the no-flap rule: inventory flaps must not translate
        into admission/preemption churn). Growing the pool notifies the
        capacity-return listeners (the elastic grow tick). On a
        topology pool a shrink revokes concrete FREE positions (highest
        first); when usage exceeds the new capacity the revocation debt
        is collected from future releases instead — same no-flap rule,
        expressed in named slices."""
        grew = False
        with self._lock:
            if slices <= 0:
                self._capacity.pop(accelerator, None)
            else:
                grew = int(slices) > self._capacity.get(accelerator, 0)
                self._capacity[accelerator] = int(slices)
            self._sync_topology_locked(accelerator)
        if grew:
            self._notify_capacity(accelerator)

    # --------------------------------------------------- placement (locked)

    def _free_positions_locked(self, accelerator: str) -> Set[int]:
        t = self._topology[accelerator]
        taken = set(self._grid[accelerator]) | self._revoked[accelerator]
        return {p for p in range(t.positions) if p not in taken}

    def _place_locked(self, key: str, fp: Footprint,
                      prefer: Optional[SliceAssignment] = None
                      ) -> Optional[SliceAssignment]:
        t = self._topology.get(fp.accelerator)
        if t is None:
            return None
        free = self._free_positions_locked(fp.accelerator)
        keep: Tuple[int, ...] = ()
        if (prefer is not None
                and prefer.accelerator == fp.accelerator):
            # in-place resize: retain the (lowest) positions the gang
            # already physically holds, plan only the delta
            keep = tuple(sorted(prefer.positions))[:fp.slices]
            free -= set(keep)
        needed = fp.slices - len(keep)
        if len(free) < needed:
            # force-charge past capacity (adoption over a shrunken
            # fleet): the annotation cannot name slices that do not
            # exist — the counting ledger still records the deficit
            return None
        extra, _ = plan_placement(free, t, needed, self.packing)
        positions = tuple(sorted(keep + extra))
        contiguous = self._contiguous(positions, t)
        asg = SliceAssignment(fp.accelerator, positions,
                              t.slices_per_pod, contiguous)
        grid = self._grid[fp.accelerator]
        for p in positions:
            grid[p] = key
        self._assignments[key] = asg
        if fp.slices > 1:
            self.contiguity_requests[fp.accelerator] = (
                self.contiguity_requests.get(fp.accelerator, 0) + 1)
            if contiguous:
                self.contiguity_hits[fp.accelerator] = (
                    self.contiguity_hits.get(fp.accelerator, 0) + 1)
        return asg

    @staticmethod
    def _contiguous(positions: Tuple[int, ...], t: PoolTopology) -> bool:
        if len(positions) <= 1:
            return True
        lo, hi = positions[0], positions[-1]
        return (hi - lo + 1 == len(positions)
                and lo // t.slices_per_pod == hi // t.slices_per_pod)

    def _unplace_locked(self, key: str, accelerator: str,
                        sync: bool = True) -> None:
        asg = self._assignments.pop(key, None)
        if asg is None or accelerator not in self._grid:
            return
        grid = self._grid[accelerator]
        for p in asg.positions:
            if grid.get(p) == key:
                del grid[p]
        if sync:
            # a shrink may be waiting on this release to collect its
            # revocation debt (set_capacity below usage never preempts)
            self._sync_topology_locked(accelerator)

    def _restore_locked(self, key: str, asg: SliceAssignment) -> None:
        grid = self._grid.get(asg.accelerator)
        if grid is None:
            return
        for p in asg.positions:
            grid[p] = key
        self._revoked[asg.accelerator] -= set(asg.positions)
        self._assignments[key] = asg

    def _sync_topology_locked(self, accelerator: str) -> None:
        """Reconcile the revoked-position set with the counting
        capacity: grid positions beyond capacity are revoked (highest
        FREE positions first — never an occupied one), and a grow
        un-revokes (lowest first) or extends the grid by whole pods."""
        t = self._topology.get(accelerator)
        if t is None:
            return
        cap = self._capacity.get(accelerator, 0)
        if cap > t.positions:
            pods = math.ceil(cap / t.slices_per_pod)
            t = PoolTopology(pods, t.slices_per_pod)
            self._topology[accelerator] = t
        revoked = self._revoked[accelerator]
        target = t.positions - cap
        while len(revoked) > target:
            revoked.discard(min(revoked))
        if len(revoked) < target:
            occupied = set(self._grid[accelerator])
            for p in range(t.positions - 1, -1, -1):
                if len(revoked) >= target:
                    break
                if p not in occupied:
                    revoked.add(p)
            # any remaining debt is held by running gangs; collected
            # as they release (no retro-preemption)

    # --------------------------------------------------------- listeners

    def on_capacity(self, fn) -> None:
        """Subscribe to capacity-return ticks: ``fn(accelerator)`` runs
        (outside the inventory lock, best-effort) whenever free slices
        increase. The elastic-resize grow path rides this so a freed
        slice reaches a shrunken gang within a reconcile tick instead
        of a polling interval."""
        self._capacity_listeners.append(fn)

    def _notify_capacity(self, accelerator: str) -> None:
        for fn in list(self._capacity_listeners):
            try:
                fn(accelerator)
            except Exception:  # a listener bug must never break the ledger
                import logging

                logging.getLogger(__name__).warning(
                    "capacity listener failed for %s", accelerator,
                    exc_info=True)
