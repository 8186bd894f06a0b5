"""Restore planner (port of ``k8s_tpu/ckpt/planner.py``): pick the
newest *consistent* step across tiers and source every shard this host
needs.

Decision table (docs/CHECKPOINT.md):

==========================  ============================================
situation                   restore
==========================  ============================================
local step > persistent,    local tier (fast path — no durable-store
all shards on own disk      read at all)
local step > persistent,    own disk + data-parallel peers for the
own shards missing/corrupt  missing indices ("local+peer")
no achievable local step    persistent tier (torch.distributed.checkpoint)
newer than persistent
nothing anywhere            fresh start (restore returns None)
==========================  ============================================

A local step at or below the persistent tier's newest step loses to it
(the durable tier wins a tie). Uncommitted steps (pending dirs without
the COMMIT marker) are invisible: :meth:`LocalTier.committed_steps`
never lists them. ``gang_consistent`` demands that the union of every
visible manifest cover every index of every leaf, so every host reaches
the same verdict without communicating; ``consensus`` (in a
multi-process run an ``all_reduce(MIN)`` of the planned step over the
process group) may lower the step further; ``max_step`` is the restore
ceiling ("last healthy step").

Execution is a **pipeline**: shard fetches fan out across a bounded
thread pool, admission is leaf-granular against an in-flight-bytes
gate, and the consumer copies each leaf's host shard into the
TEMPLATE's own tensor on its device (parameters and optimizer moments
are restored in place) while later leaves still stream. Per-shard crc
verification and single-shard reroute on failure run in every worker,
so a parallel restore is byte-identical to a serial one.

In-place restore has one consequence the JAX planner does not share: a
local restore that fails after some leaves were written leaves the
template part-restored. It falls back to the persistent tier (which
rewrites every leaf) as in the JAX planner; with no persistent step to
fall back to it raises instead of reporting a fresh start over a
half-overwritten state.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from k8s_tpu_torch.ckpt.local import (
    LocalTier,
    _leaf_paths,
    compose_shard,
    covering_plan,
    full_key,
    index_key,
    overlap_covering_plan,
    parse_index_key,
    required_indices,
    union_covering_plan,
)
from k8s_tpu_torch.ckpt.pipeline import InflightGate, from_numpy, itemsize

log = logging.getLogger(__name__)


def _full_indices(template_leaf) -> List[str]:
    """EVERY shard index of the leaf's global array — the gang-coverage
    vocabulary: each distinct shard of a ``DTensor`` over its mesh, else
    the whole array."""
    if isinstance(template_leaf, torch.Tensor):
        from k8s_tpu_torch.parallel.sharding import all_indices

        shape = tuple(int(d) for d in template_leaf.shape)
        return [index_key(i, shape) for i in all_indices(template_leaf)]
    return [full_key(getattr(template_leaf, "shape", ()))]


def _tiling_plan(key: str, have_by_source):
    """The pieces that rebuild ``key`` across several manifests: the
    shards inside it (:func:`union_covering_plan`), else the shards that
    overlap it (:func:`overlap_covering_plan`: a checkpoint of another
    layout and world size)."""
    plan = union_covering_plan(key, have_by_source)
    return plan if plan is not None else overlap_covering_plan(
        key, have_by_source)


SOURCE_LOCAL = "local"
SOURCE_LOCAL_PEER = "local+peer"
SOURCE_PERSISTENT = "persistent"
SOURCE_NONE = "none"

# pipeline defaults (overridable via CheckpointPolicy /
# KTPU_CKPT_RESTORE_PARALLEL / KTPU_CKPT_RESTORE_INFLIGHT_MB)
DEFAULT_RESTORE_PARALLEL = 8
DEFAULT_INFLIGHT_BYTES = 1 << 30  # 1 GiB of host shard buffers


def _est_shard_bytes(leaf, key: str) -> int:
    """Host bytes one fetched shard will hold — geometry × itemsize
    from the template, no payload read (the admission-gate estimate)."""
    size = itemsize(getattr(leaf, "dtype", None))
    try:
        slices = parse_index_key(key)
    except ValueError:
        return size
    n = 1
    for s in slices or ():
        n *= max(0, int(s.stop) - int(s.start))
    return max(1, n) * size


@dataclass
class RestorePlan:
    step: Optional[int]
    source: str
    # leaf path -> {index_key: host_id} for shards sourced from peers
    peer_shards: Dict[str, Dict[str, int]] = field(default_factory=dict)
    # leaf path -> {index_key: [(stored_key, host_id|None), ...]} for
    # shards no single manifest covers — assembled from pieces spread
    # across own disk (host None) and peers
    tiled: Dict[str, Dict[str, List[Tuple[str, Optional[int]]]]] = field(
        default_factory=dict)
    peer_fetches: int = 0


class RestorePlanner:
    """Plans and executes a restore across the local tier, peers, and
    the persistent (DCP) tier."""

    def __init__(
        self,
        local: Optional[LocalTier],
        persistent=None,
        transport=None,
        consensus: Optional[Callable[[int], int]] = None,
        gang_consistent: bool = False,
        max_step: Optional[int] = None,
        parallel: int = DEFAULT_RESTORE_PARALLEL,
        inflight_bytes: int = DEFAULT_INFLIGHT_BYTES,
    ):
        self.local = local
        self.persistent = persistent  # train.checkpoint.CheckpointManager
        self.transport = transport
        self.consensus = consensus or (lambda step: step)
        # multi-process mode: candidate steps must be FULLY covered by
        # the union of visible manifests
        self.gang_consistent = gang_consistent
        # restore ceiling ("last healthy step"): steps past it are
        # invisible to planning on EVERY tier
        self.max_step = max_step
        # fetch-pool width (1 = the serial schedule) and the in-flight
        # host-bytes cap
        self.parallel = max(1, int(parallel))
        self.inflight_bytes = int(inflight_bytes)
        # phase timings + pipeline counters of the LAST restore() (the
        # MTTR evidence the manager exports). fetch_s and device_s
        # overlap by design; their sum can exceed the restore wall.
        self.last_restore_stats: Dict[str, Any] = {}

    # ------------------------------------------------------------ planning

    def _peer_steps(self) -> Dict[int, List[int]]:
        if self.transport is None:
            return {}
        try:
            return self.transport.steps()
        except Exception as e:
            log.warning("restore planner: peer step discovery failed (%s); "
                        "continuing without peers", e)
            return {}

    def _candidate_steps(
        self, peer_steps: Dict[int, List[int]]
    ) -> List[int]:
        """Local-tier candidate steps, newest first: own committed steps
        plus any step some peer committed (a replaced pod has NO own
        steps — peers are its only local-tier source)."""
        steps = set(self.local.committed_steps() if self.local else [])
        for peer_list in peer_steps.values():
            steps.update(peer_list)
        if self.max_step is not None:
            steps = {s for s in steps if s <= self.max_step}
        return sorted(steps, reverse=True)

    def _persistent_step(self) -> Optional[int]:
        """Newest persistent-tier step within the restore ceiling.
        The persistent manager exposes ``all_steps`` so a bounded plan can reach
        past a too-new latest; a persistent tier without it degrades to
        all-or-nothing (its latest counts only when within bound)."""
        if self.persistent is None:
            return None
        try:
            if self.max_step is not None:
                all_steps = getattr(self.persistent, "all_steps", None)
                if callable(all_steps):
                    steps = [s for s in (all_steps() or [])
                             if s <= self.max_step]
                    return max(steps) if steps else None
            step = self.persistent.latest_step()
        except Exception as e:
            log.warning("restore planner: persistent tier step discovery "
                        "failed (%s)", e)
            return None
        if (self.max_step is not None and step is not None
                and step > self.max_step):
            return None
        return step

    def plan(self, template: Any) -> RestorePlan:
        """Choose the step + per-shard sources for this host. Template
        leaves are the tensors the restore will fill (same contract as
        CheckpointManager.restore)."""
        if self.transport is not None and hasattr(self.transport, "reset"):
            # a peer blacklisted during an earlier restore (booting,
            # transient timeout) gets a fresh chance each plan
            self.transport.reset()
        persistent_step = self._persistent_step()
        needed = {
            path: required_indices(leaf)
            for path, leaf in _leaf_paths(template)
        }
        # gang mode additionally demands the union of manifests cover
        # EVERY index of every leaf — the deterministic, communication-
        # free proof that each peer can restore this step too
        coverage = None
        if self.gang_consistent:
            coverage = {
                path: _full_indices(leaf)
                for path, leaf in _leaf_paths(template)
            }
        # one peer round-trip per plan, shared by candidate listing and
        # every per-step achievability check (a dead peer costs one
        # timeout, not one per retained step)
        peer_steps = self._peer_steps()
        best_local = None
        for step in self._candidate_steps(peer_steps):
            if persistent_step is not None and step <= persistent_step:
                break  # older than the durable tier — no point
            achievable, peer_shards, tiled, fetches = self._achievable(
                step, needed, coverage, peer_steps)
            if achievable:
                best_local = (step, peer_shards, tiled, fetches)
                break
        if best_local is not None:
            step = self.consensus(best_local[0])
            if step != best_local[0]:
                # the gang agreed on an older step (some peer couldn't
                # source ours) — re-plan shard sources for THAT step
                achievable, peer_shards, tiled, fetches = self._achievable(
                    step, needed, coverage, peer_steps)
                if not achievable:
                    return self._persistent_plan(persistent_step)
                best_local = (step, peer_shards, tiled, fetches)
            step, peer_shards, tiled, fetches = best_local
            return RestorePlan(
                step=step,
                source=SOURCE_LOCAL_PEER if fetches else SOURCE_LOCAL,
                peer_shards=peer_shards,
                tiled=tiled,
                peer_fetches=fetches,
            )
        return self._persistent_plan(persistent_step)

    def _persistent_plan(self, persistent_step) -> RestorePlan:
        if persistent_step is None:
            return RestorePlan(step=None, source=SOURCE_NONE)
        return RestorePlan(step=persistent_step, source=SOURCE_PERSISTENT)

    def _achievable(
        self, step: int, needed: Dict[str, List[str]],
        coverage: Optional[Dict[str, List[str]]] = None,
        peer_steps: Optional[Dict[int, List[int]]] = None,
    ) -> Tuple[bool, Dict[str, Dict[str, int]],
               Dict[str, Dict[str, List[Tuple[str, Optional[int]]]]], int]:
        """Can this host source every required shard at ``step``?
        Checks manifests only (no payload reads): own manifest first,
        then peers'. crc validation happens at fetch time; a corrupt
        own-shard is re-sourced from a peer then. A required index
        counts as held when a manifest's stored shards COVER it
        (covering_plan): a checkpoint saved under a different layout —
        replicated opt state vs a ``zero1=True`` template, or the
        reverse — is resharded on read instead of forcing the restore
        down to the persistent tier (or silently to a fresh start).
        When no SINGLE manifest covers an index (a multi-host ZeRO-1
        checkpoint: each host stores only its own 1/DP opt tile), the
        UNION of own + peer manifests may still tile it —
        union_covering_plan records the per-piece sources in ``tiled``,
        and overlap_covering_plan the shards that only overlap it (a
        checkpoint of another world size or strategy).
        ``coverage`` (gang mode) additionally requires the union of
        visible manifests to hold EVERY listed index — proving every
        peer could restore this step too."""
        own = self.local.manifest(step) if self.local else None
        peer_manifests: Dict[int, dict] = {}
        peer_hosts = []
        if self.transport is not None:
            if peer_steps is None:
                peer_steps = self._peer_steps()
            for h, steps in sorted(peer_steps.items()):
                if step in steps:
                    peer_hosts.append(h)
        peer_shards: Dict[str, Dict[str, int]] = {}
        tiled: Dict[str, Dict[str, List[Tuple[str, Optional[int]]]]] = {}
        fetches = 0
        for path, keys in needed.items():
            own_entry = ((own or {}).get("leaves") or {}).get(path, {})
            own_keys = set((own_entry.get("shards") or {}))
            for key in keys:
                if covering_plan(key, own_keys) is not None:
                    continue
                host = self._peer_with(step, path, key, peer_hosts,
                                       peer_manifests)
                if host is not None:
                    peer_shards.setdefault(path, {})[key] = host
                    fetches += 1
                    continue
                union = _tiling_plan(
                    key, self._sources(path, own_keys, peer_hosts,
                                       peer_manifests))
                if union is None:
                    return False, {}, {}, 0
                tiled.setdefault(path, {})[key] = union
                fetches += sum(1 for _, src in union if src is not None)
        if coverage is not None:
            for path, keys in coverage.items():
                own_entry = ((own or {}).get("leaves") or {}).get(path, {})
                own_keys = set((own_entry.get("shards") or {}))
                for key in keys:
                    if covering_plan(key, own_keys) is not None:
                        continue
                    if self._peer_with(step, path, key, peer_hosts,
                                       peer_manifests) is not None:
                        continue
                    if _tiling_plan(
                            key, self._sources(path, own_keys, peer_hosts,
                                               peer_manifests)) is None:
                        return False, {}, {}, 0
        return True, peer_shards, tiled, fetches

    def _sources(self, path, own_keys, peer_hosts, peer_manifests):
        """Ordered ``[(source, stored keys), ...]`` for one leaf across
        every visible manifest — own disk first (source None), then
        peers. Peer manifests are already cached by the _peer_with pass
        that ran (and missed) before any union plan is attempted."""
        out = [(None, own_keys)]
        for h in peer_hosts:
            entry = ((peer_manifests.get(h) or {}).get("leaves")
                     or {}).get(path, {})
            out.append((h, set(entry.get("shards") or {})))
        return out

    def _peer_with(self, step, path, key, peer_hosts, peer_manifests):
        """First peer whose manifest can source ``key`` — exactly or by
        resharding from its stored shards (the transports' fetch routes
        through LocalTier.read_shard, which composes the same plan)."""
        for h in peer_hosts:
            man = peer_manifests.get(h)
            if man is None:
                try:
                    man = self.transport.manifest(step, h) or {}
                except Exception:
                    man = {}
                peer_manifests[h] = man
            entry = (man.get("leaves") or {}).get(path, {})
            if covering_plan(key, (entry.get("shards") or {}).keys()) \
                    is not None:
                return h
        return None

    # ------------------------------------------------------------ execution

    def restore(self, template: Any) -> Tuple[Optional[Any], RestorePlan]:
        """Execute the plan, filling ``template``'s tensors in place.
        Returns ``(tree, plan)``: ``tree`` is the template, restored, or
        None for a fresh start. A mid-restore sourcing failure (peer
        died after planning, crc rot) degrades to the persistent tier."""
        t0 = time.perf_counter()
        plan = self.plan(template)
        self.last_restore_stats = {
            "plan_s": time.perf_counter() - t0,
            "fetch_s": 0.0,
            "device_s": 0.0,
            "parallel": self.parallel,
            "peak_inflight_bytes": 0,
            "gate_waits": 0,
            "bytes": 0,
            "leaves_written": 0,
        }
        if plan.source in (SOURCE_LOCAL, SOURCE_LOCAL_PEER):
            tree = self._restore_local(plan, template)
            if tree is not None:
                return tree, plan
            log.warning(
                "restore: local-tier restore of step %s failed mid-way; "
                "falling back to the persistent tier", plan.step)
            plan = self._persistent_plan(self._persistent_step())
            if plan.source == SOURCE_NONE \
                    and self.last_restore_stats["leaves_written"]:
                raise RuntimeError(
                    f"restore: the local-tier restore failed after writing "
                    f"{self.last_restore_stats['leaves_written']} leaves of "
                    "the template in place and no persistent step exists to "
                    "restore over them; refusing to start fresh from a "
                    "part-restored state")
        if plan.source == SOURCE_PERSISTENT:
            t1 = time.perf_counter()
            tree = self.persistent.restore(template, step=plan.step)
            # the DCP read is opaque to us: its whole wall time lands in
            # the fetch phase
            self.last_restore_stats["fetch_s"] += time.perf_counter() - t1
            if tree is None:
                return None, RestorePlan(step=None, source=SOURCE_NONE)
            return tree, plan
        return None, plan

    def _fetch_shard(self, plan: RestorePlan, path: str,
                     key: str) -> Optional[np.ndarray]:
        """The per-shard sourcing ladder — IDENTICAL to the old serial
        path, now also run from pool workers: tiled union pieces, else
        the planned peer (reroute to ANY peer when it died between
        planning and fetching), else own disk (reroute to any peer on a
        crc miss). crc validation lives in read_shard/the wire loaders;
        a None return fails the whole restore (degrade, never wedge)."""
        step = plan.step
        pieces = plan.tiled.get(path, {}).get(key)
        if pieces is not None:
            # assembled from shards no single manifest covers: own
            # tiles read locally, peer tiles fetched by their EXACT
            # stored key (read_shard serves exact keys trivially),
            # composed into the template slice
            src_of = dict(pieces)

            def load(k, _src=src_of, _step=step, _path=path):
                h = _src[k]
                if h is None:
                    return (self.local.read_shard(_step, _path, k)
                            if self.local is not None else None)
                return self.transport.fetch(_step, _path, k, h)

            return compose_shard(key, [k for k, _ in pieces], load)
        arr = None
        peer = plan.peer_shards.get(path, {}).get(key)
        if peer is None and self.local is not None:
            arr = self.local.read_shard(step, path, key)
            if arr is None and self.transport is not None:
                # own shard corrupt/raced away — any peer will do
                for h in sorted(self.transport.steps()):
                    arr = self.transport.fetch(step, path, key, h)
                    if arr is not None:
                        break
        elif peer is not None:
            arr = self.transport.fetch(step, path, key, peer)
            if arr is None:
                # planned peer died: try the others
                for h in sorted(self.transport.steps()):
                    if h == peer:
                        continue
                    arr = self.transport.fetch(step, path, key, h)
                    if arr is not None:
                        break
        return arr

    @staticmethod
    def _materialize_leaf(leaf: torch.Tensor,
                          shard_data: Dict[str, np.ndarray]) -> torch.Tensor:
        """The host shard → the TEMPLATE's own tensor, on its device and
        in its dtype (``copy_``: parameters and optimizer moments are
        restored in place, so the model and optimizer keep their
        tensors; a ``DTensor``'s local shard is written in place)."""
        arr = next(iter(shard_data.values()))
        host = from_numpy(arr, leaf.dtype)
        dst = leaf.to_local() if hasattr(leaf, "to_local") else leaf
        if tuple(host.shape) != tuple(dst.shape):
            raise ValueError(f"restored shard shape {tuple(host.shape)} != "
                             f"template {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(host)
        return leaf

    def _restore_local(self, plan: RestorePlan, template) -> Optional[Any]:
        """Execute a local/local+peer plan as a fetch→device pipeline.

        A scheduler thread admits leaves in template order against the
        in-flight-bytes gate and fans their shard fetches onto a bounded
        pool; the calling thread consumes leaves in the same order,
        copying leaf N into the template while leaf N+1.. stream from
        disk/peers. Any failed shard aborts the pipeline promptly — the
        caller degrades to the persistent tier, never a wedge."""
        from concurrent.futures import ThreadPoolExecutor
        from queue import Queue

        specs = []
        for path, leaf in _leaf_paths(template):
            keys = required_indices(leaf)
            est = sum(_est_shard_bytes(leaf, k) for k in keys)
            specs.append((path, leaf, keys, est))
        gate = InflightGate(self.inflight_bytes)
        abort = threading.Event()
        fetch_t0 = time.perf_counter()
        fetch_end = [fetch_t0]
        fetch_end_lock = threading.Lock()

        def task(path, key):
            if abort.is_set():
                return None
            try:
                arr = self._fetch_shard(plan, path, key)
            except Exception as e:
                log.warning("restore: shard fetch %s[%s] raised (%s: %s)",
                            path, key, type(e).__name__, e)
                arr = None
            if arr is None:
                abort.set()  # fail fast: later fetches become no-ops
            now = time.perf_counter()
            with fetch_end_lock:  # last-finish max across pool workers
                if now > fetch_end[0]:
                    fetch_end[0] = now
            return arr

        ready: Queue = Queue()
        pool = ThreadPoolExecutor(
            max_workers=self.parallel, thread_name_prefix="ckpt-restore")

        def schedule():
            try:
                for path, leaf, keys, est in specs:
                    if abort.is_set():
                        break
                    gate.acquire(est, abort)
                    futs = [(k, pool.submit(task, path, k)) for k in keys]
                    ready.put((leaf, est, futs))
            finally:
                ready.put(None)

        sched = threading.Thread(target=schedule, daemon=True,
                                 name="ckpt-restore-sched")
        sched.start()
        stats = self.last_restore_stats
        device_s = 0.0
        ok = True
        aborted = True  # stays True if the consumer loop dies mid-way
        try:
            while True:
                item = ready.get()
                if item is None:
                    aborted = abort.is_set()
                    break
                leaf, est, futs = item
                shard_data: Dict[str, np.ndarray] = {}
                for key, fut in futs:
                    arr = fut.result()
                    if arr is None:
                        ok = False
                    shard_data[key] = arr
                if ok and not abort.is_set():
                    t0 = time.perf_counter()
                    self._materialize_leaf(leaf, shard_data)
                    device_s += time.perf_counter() - t0
                    stats["leaves_written"] += 1
                    stats["bytes"] += est
                # drop host buffers BEFORE releasing their bytes
                shard_data.clear()
                gate.release(est)
        finally:
            # an exception escaping the consumer must not strand the
            # scheduler in gate.acquire or leak the pool's threads
            abort.set()
            sched.join()
            pool.shutdown(wait=True)
        if any(isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"
               for _, leaf, _, _ in specs):
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            device_s += time.perf_counter() - t0
        stats["fetch_s"] = max(0.0, fetch_end[0] - fetch_t0)
        stats["device_s"] = device_s
        stats["peak_inflight_bytes"] = gate.peak
        stats["gate_waits"] = gate.waits
        if not ok or aborted:
            return None
        return template
