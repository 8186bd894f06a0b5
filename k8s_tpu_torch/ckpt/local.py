"""Local checkpoint tier: per-host snapshots on node-local disk (port of
``k8s_tpu/ckpt/local.py``).

The cheap, frequent half of the multi-tier model (docs/CHECKPOINT.md):
every few steps each process snapshots its state — a device→host copy
plus a node-local disk write, far cheaper than a durable-store save —
so a gang restart loses at most ``local_interval`` steps instead of
``persistent_interval``.

The save is a **pipeline**: the step-critical slice is the device→host
snapshot (:func:`~k8s_tpu_torch.ckpt.pipeline.host_copy` per leaf,
page-locked buffers, ``non_blocking`` copies waited for on an event,
fanned across a bounded pool and admitted leaf by leaf against an
in-flight-bytes gate); npy serialization, streaming crc, manifest,
barrier and the atomic commit run on a background writer thread that
only touches the staged host copies. ``save()`` returns once every
copy has landed, so the caller may update the live tensors in place
right after (the JAX package's donate-after contract). A ``block=False``
caller that finds the previous writer still committing gets a counted
skip instead of a stall.

Crash-safety is a **two-phase commit**: shards + a per-host manifest
(crc32 per shard) land in ``step-<N>.pending/``; after the gang barrier
the pending dir is renamed to ``step-<N>/`` and a ``COMMIT`` marker is
fsynced into it. A step counts as committed ONLY when the marker
exists. crcs are verified at read time.

The on-disk format is the JAX package's, byte for byte: the same leaf
directory names, file names, npy files (a bfloat16 leaf as its 16-bit
words, descr ``<V2``) and manifest keys, so either package reads the
other's steps. One process drives one device, so every tensor is one
fully-replicated shard whose key covers the whole array; the shard
geometry (``index_key`` … ``compose_shard``) is copied unchanged for
the sharded layouts of a later slice.

Chaos hooks (``arm_partial_commit``, ``corrupt_one_shard``,
``drop_host``) are for fault tests — never production.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
import zlib
from queue import Queue
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from k8s_tpu_torch.ckpt.pipeline import (
    HostBuffers,
    InflightGate,
    crc32_array,
    dtype_name,
    est_leaf_bytes,
    host_copy,
    to_numpy,
)

log = logging.getLogger(__name__)

COMMIT_MARKER = "COMMIT"
MANIFEST = "manifest.json"
PENDING_SUFFIX = ".pending"
PROGRESS_FILE = "progress.json"

# Chaos hook: when armed, the next n commits stop after the write phase
# (pending dir on disk, no rename, no marker) and raise — exactly what
# a host crash between phase 1 and phase 2 leaves behind.
_partial_commit_lock = threading.Lock()
_partial_commit_remaining = 0


def arm_partial_commit(n: int) -> None:
    """Make the next ``n`` local-tier commits (process-wide) fail after
    the write phase. ``n=0`` disarms."""
    global _partial_commit_remaining
    with _partial_commit_lock:
        _partial_commit_remaining = n


def _take_partial_commit() -> bool:
    global _partial_commit_remaining
    with _partial_commit_lock:
        if _partial_commit_remaining > 0:
            _partial_commit_remaining -= 1
            return True
    return False


def index_key(idx: Tuple, shape: Tuple[int, ...]) -> str:
    """Serialize a shard's global index (tuple of slices) as
    ``"0:4,8:16"`` — one ``start:stop`` per dim, scalars as ``"-"``."""
    if not shape:
        return "-"
    parts = []
    for s, dim in zip(idx, shape):
        start, stop, _ = s.indices(dim)
        parts.append(f"{start}:{stop}")
    return ",".join(parts)


def parse_index_key(key: str) -> Optional[Tuple[slice, ...]]:
    if key == "-":
        return ()
    out = []
    for part in key.split(","):
        start, _, stop = part.partition(":")
        out.append(slice(int(start), int(stop)))
    return tuple(out)


# ---------------------------------------------------------------------------
# Shard-index geometry: restoring ACROSS layouts (replicated ↔ ZeRO-1 /
# resharded opt state) means the exact index a template asks for may not
# exist in a manifest written under the other layout — but a bigger
# stored shard may CONTAIN it, or a set of smaller stored shards may
# tile it exactly. These helpers answer both without loading payloads.
# ---------------------------------------------------------------------------


def _box(key: str) -> Optional[Tuple[Tuple[int, int], ...]]:
    """Index key → ((start, stop), ...) box; None for the scalar key
    (or a malformed one). Wraps :func:`parse_index_key` so the covering
    geometry can never diverge from the save-side key vocabulary."""
    try:
        slices = parse_index_key(key)
    except ValueError:
        return None
    if not slices:
        return None
    return tuple((s.start, s.stop) for s in slices)


def _box_contains(outer, inner) -> bool:
    return len(outer) == len(inner) and all(
        o[0] <= i[0] and i[1] <= o[1] for o, i in zip(outer, inner)
    )


def _box_volume(b) -> int:
    v = 1
    for lo, hi in b:
        v *= max(0, hi - lo)
    return v


def _boxes_disjoint(a, b) -> bool:
    return any(a[i][1] <= b[i][0] or b[i][1] <= a[i][0]
               for i in range(len(a)))


def _tiles_exactly(want, boxes) -> bool:
    """Do ``boxes`` (each already contained in ``want``) tile it
    exactly? Equal total volume + pairwise disjoint + all inside want
    ⇒ gap-free, overlap-free cover. Shared by the single-manifest and
    union covering plans so the tiling rule cannot diverge."""
    boxes = list(boxes)
    if not boxes:
        return False
    if sum(_box_volume(b) for b in boxes) != _box_volume(want):
        return False
    return all(
        _boxes_disjoint(boxes[i], boxes[j])
        for i in range(len(boxes)) for j in range(i + 1, len(boxes))
    )


def covering_plan(
    want_key: str, have_keys,
) -> Optional[List[str]]:
    """Which stored shard keys rebuild ``want_key``: the exact key, ONE
    containing shard (replicated checkpoint → sharded template), or a
    set of contained shards that tile it exactly (sharded checkpoint →
    replicated/coarser template). None when the manifest cannot cover
    the request. Geometry only — no payload reads."""
    have = list(have_keys)
    if want_key in have:
        return [want_key]
    want = _box(want_key)
    if want is None:
        return None  # scalar: exact key or nothing
    for k in have:
        hb = _box(k)
        if hb is not None and _box_contains(hb, want):
            return [k]
    pieces = [(k, _box(k)) for k in have]
    pieces = [(k, b) for k, b in pieces
              if b is not None and _box_contains(want, b)]
    if not _tiles_exactly(want, [b for _, b in pieces]):
        return None
    return [k for k, _ in pieces]


def union_covering_plan(
    want_key: str, have_by_source,
) -> Optional[List[Tuple[str, Any]]]:
    """:func:`covering_plan` across SEVERAL manifests: rebuild
    ``want_key`` from shards held by different sources (own disk +
    peers). ``have_by_source`` is an ordered ``[(source, keys), ...]``
    — sources earlier in the list are preferred. Returns
    ``[(key, source), ...]`` or None.

    This is what makes a multi-host ZeRO-1 checkpoint restorable into a
    replicated/coarser template: each host's manifest holds only its
    own 1/DP tile, so no SINGLE manifest covers the full leaf — but the
    union does. Single-source plans win first (no cross-host assembly);
    otherwise contained pieces are pooled across sources (first source
    holding a key claims it) and must tile ``want_key`` exactly —
    pairwise-disjoint, gap-free — or the union is no cover either."""
    for src, keys in have_by_source:
        plan = covering_plan(want_key, keys)
        if plan is not None:
            return [(k, src) for k in plan]
    want = _box(want_key)
    if want is None:
        return None  # scalar: exact key or nothing, per source
    pieces: Dict[str, Tuple[Any, Tuple]] = {}
    for src, keys in have_by_source:
        for k in keys:
            if k in pieces:
                continue
            b = _box(k)
            if b is not None and _box_contains(want, b):
                pieces[k] = (src, b)
    if not _tiles_exactly(want, [b for _, b in pieces.values()]):
        return None
    return [(k, src) for k, (src, _) in pieces.items()]


def _intersection(a, b) -> Optional[Tuple[Tuple[int, int], ...]]:
    """The box ``a`` ∩ ``b`` (None when they share no element)."""
    if len(a) != len(b):
        return None
    out = tuple((max(x[0], y[0]), min(x[1], y[1])) for x, y in zip(a, b))
    return None if any(lo >= hi for lo, hi in out) else out


def overlap_covering_plan(
    want_key: str, have_by_source,
) -> Optional[List[Tuple[str, Any]]]:
    """:func:`union_covering_plan` for shards that OVERLAP ``want_key``
    without lying inside it: a checkpoint written under a layout that
    cuts another dimension (an ``fsdp_tp`` state's ``[E, H·D/4]`` column
    blocks read back as an ``fsdp`` rank's ``[E/2, H·D]`` row block) has
    no stored shard inside the wanted one. Every stored shard that
    shares elements with ``want_key`` contributes that intersection (the
    first source holding a key claims it); the intersections must tile
    ``want_key`` exactly. Returns ``[(key, source), ...]`` or None.
    Shards of one checkpoint are disjoint or identical (one layout), so
    their intersections with a box are disjoint too."""
    want = _box(want_key)
    if want is None:
        return None
    pieces: Dict[str, Tuple[Any, Tuple]] = {}
    for src, keys in have_by_source:
        for k in keys:
            if k in pieces:
                continue
            b = _box(k)
            cut = None if b is None else _intersection(b, want)
            if cut is not None:
                pieces[k] = (src, cut)
    if not _tiles_exactly(want, [c for _, c in pieces.values()]):
        return None
    return [(k, src) for k, (src, _) in pieces.items()]


def compose_shard(
    want_key: str, plan: List[str], load,
) -> Optional[np.ndarray]:
    """Assemble the ``want_key`` slice from the shards named by a
    :func:`covering_plan` (or :func:`overlap_covering_plan`): each
    stored shard's intersection with the wanted box lands at its place.
    ``load(key) -> ndarray | None`` reads one stored shard (crc-verified
    by the caller's loader); any failed load fails the composition
    (caller falls back to a peer / the persistent tier)."""
    want = _box(want_key)
    if plan == [want_key] or want is None:
        return load(want_key)
    if len(plan) == 1:  # one containing shard: cut our slice out of it
        outer = _box(plan[0])
        arr = load(plan[0])
        if arr is None:
            return None
        rel = tuple(
            slice(w[0] - o[0], w[1] - o[0]) for w, o in zip(want, outer)
        )
        return np.ascontiguousarray(arr[rel])
    out = None
    for k in plan:
        arr = load(k)
        if arr is None:
            return None
        if out is None:
            out = np.empty(
                tuple(hi - lo for lo, hi in want), dtype=arr.dtype)
        kb = _box(k)
        cut = _intersection(kb, want)
        dst = tuple(slice(c[0] - w[0], c[1] - w[0]) for c, w in zip(cut, want))
        src = tuple(slice(c[0] - b[0], c[1] - b[0]) for c, b in zip(cut, kb))
        out[dst] = arr[src]
    return out


def full_key(shape) -> str:
    """The index key of a whole array of ``shape``."""
    shape = tuple(int(d) for d in shape)
    return index_key(tuple(slice(0, d) for d in shape), shape)


def _leaf_paths(tree) -> List[Tuple[str, Any]]:
    """Stable ``(path-string, leaf)`` pairs of a (possibly nested) dict
    of tensors: '/'-joined keys in sorted order, as the JAX package's
    key paths flatten a dict — the manifest vocabulary both save and
    restore agree on. The port's state is a flat dict whose keys
    already hold the '/' (``params/<name>``, ``opt/<name>/exp_avg``)."""
    out: List[Tuple[str, Any]] = []

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}/{k}" if prefix else str(k), node[k])
        else:
            out.append((prefix, node))

    walk("", tree)
    return out


def _leaf_dirname(path: str) -> str:
    """Filesystem-safe per-leaf directory: a short hash prefix guards
    against collisions after character replacement."""
    safe = path.replace("/", "__").replace(".", "_")[:120]
    return f"{zlib.crc32(path.encode()) & 0xFFFFFFFF:08x}-{safe}"


def _shape_dtype(leaf):
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.dtype
    arr = np.asarray(leaf)
    return arr.shape, arr.dtype


def local_shards_of(leaf) -> Dict[str, np.ndarray]:
    """This process's shards of ``leaf`` as host arrays: a ``DTensor``'s
    local shard keyed by its global index, any other tensor (or a
    numpy/python leaf) one whole-array shard. Eager spelling of
    :func:`shard_copy_jobs`."""
    jobs, _ = shard_copy_jobs(leaf)
    return {key: to_numpy(materialize()[0]) for key, materialize in jobs}


def _local_key(leaf) -> str:
    """The index key of this process's shard of a tensor leaf: a
    ``DTensor``'s local shard (FSDP2's parameters and moments, a ZeRO
    slice) at its global index, else the whole array."""
    from k8s_tpu_torch.parallel.sharding import local_index

    shape = tuple(int(d) for d in leaf.shape)
    return index_key(local_index(leaf), shape)


def shard_copy_jobs(leaf, buffers: Optional[HostBuffers] = None,
                    stream=None):
    """This process's shards of ``leaf`` as DEFERRED copy jobs: a list of
    ``(index_key, materialize)`` pairs plus the host bytes the copies
    will stage. ``materialize()`` returns ``(host tensor, buffer)``
    (:func:`~k8s_tpu_torch.ckpt.pipeline.host_copy`): the copy has
    landed when it returns, so the writer never reads live storage —
    PyTorch updates the state in place, and a view of it would let the
    next step scribble into a crc-consistent checkpoint. A ``DTensor``
    stages its local shard only."""
    shape, dtype = _shape_dtype(leaf)
    if isinstance(leaf, torch.Tensor):
        local = leaf.to_local() if hasattr(leaf, "to_local") else leaf

        def materialize(_l=local):
            return host_copy(_l, buffers, stream)
        return ([(_local_key(leaf), materialize)],
                est_leaf_bytes(tuple(local.shape), dtype))

    def materialize(_l=leaf):
        return torch.from_numpy(np.array(_l, copy=True)), None
    return [(full_key(shape), materialize)], est_leaf_bytes(shape, dtype)


def required_indices(template_leaf) -> List[str]:
    """The shard indices this process must source to rebuild
    ``template_leaf``: its local shard's for a ``DTensor``, else the
    whole array."""
    if isinstance(template_leaf, torch.Tensor):
        return [_local_key(template_leaf)]
    return [full_key(_shape_dtype(template_leaf)[0])]


def _write_npy(f, arr: np.ndarray) -> None:
    """``np.save`` of ``arr``, except that bfloat16 words (dtype V2) get
    the header numpy writes for ``ml_dtypes.bfloat16`` (descr ``<V2``;
    a plain V2 array would say ``|V2``), so the file is byte-identical
    to the JAX package's."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        np.lib.format.write_array_header_1_0(f, {
            "descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).view(np.uint8).tobytes())
    else:
        np.save(f, arr)


class LocalTier:
    """One host's local snapshot store.

    ``root`` is the node-local directory; this host's snapshots live
    under ``root/host-<host_id>/`` (sibling ``host-*`` dirs are peers'
    disks when the root is shared, which is what
    :class:`~k8s_tpu_torch.ckpt.peer.FilesystemPeerTransport` reads).

    ``barrier(step)`` is the gang-wide commit barrier, called by the
    writer before the atomic rename (a ``torch.distributed`` barrier in
    a multi-process run); ``None`` is the single-host no-op.
    """

    def __init__(
        self,
        root: str,
        host_id: int = 0,
        max_to_keep: int = 2,
        barrier: Optional[Callable[[int], None]] = None,
        sync: bool = False,
        parallel: int = 8,
        buffer_bytes: int = 1 << 30,
        on_phases: Optional[Callable[[int, Dict[str, float]], None]] = None,
    ):
        self.root = root
        self.host_id = int(host_id)
        self.max_to_keep = max_to_keep
        self.barrier = barrier
        self.sync = sync
        # snapshot-pool width (1 = serial copies; byte-identical output
        # either way) and the staged-bytes cap shared between the
        # snapshot and the background writer
        self.parallel = max(1, int(parallel))
        self.buffer_bytes = int(buffer_bytes)
        # called by the WRITER after each commit with the background
        # phase timings {"serialize": s, "commit": s}
        self.on_phases = on_phases
        # created lazily on first WRITE: instantiating a tier (or a peer
        # transport) must not resurrect a dropped host's dir
        self.host_dir = os.path.join(root, f"host-{self.host_id}")
        self._writer: Optional[threading.Thread] = None
        self._writer_error: Optional[BaseException] = None
        # page-locked staging buffers, reused save after save
        self.buffers = HostBuffers()
        self.saves = 0
        self.commit_failures = 0
        self.skipped_busy = 0
        self.last_skip_reason: Optional[str] = None
        # pipeline evidence of the LAST accepted save (gate peak/waits,
        # snapshot seconds, bytes)
        self.last_save_stats: Dict[str, Any] = {}

    # ------------------------------------------------------------ paths

    def step_dir(self, step: int) -> str:
        return os.path.join(self.host_dir, f"step-{step}")

    def _pending_dir(self, step: int) -> str:
        return self.step_dir(step) + PENDING_SUFFIX

    # ------------------------------------------------------------ save

    def save(self, step: int, tree: Any, block: bool = True) -> bool:
        """Snapshot ``tree`` (a dict of tensors) at ``step``.

        The device→host copies happen NOW — fanned across a bounded
        pool (``parallel``), leaf-admitted against the staged-bytes gate
        (``buffer_bytes``) — and ALL complete before this returns, so
        the caller may update the tensors in place right after.
        Serialization, crc, manifest, barrier and the atomic commit run
        on a background writer that consumes the staged copies leaf by
        leaf (releasing their gate bytes as each leaf lands on disk).

        ``block=True`` drains a still-running previous writer first.
        ``block=False`` (the manager's zero-stall routed path) returns
        False with ``last_skip_reason="writer_busy"`` instead. Returns
        False (``"already_committed"``) if the step is committed.
        """
        self.last_skip_reason = None
        prev = self._writer
        if prev is not None and prev.is_alive() and not block \
                and self.barrier is None:
            # zero-stall skip is only sound WITHOUT a commit barrier: a
            # barrier-wired gang tier must take part in every step's
            # commit, or a peer's writer blocked in barrier(step) wedges
            self.skipped_busy += 1
            self.last_skip_reason = "writer_busy"
            return False
        # drain the previous write FIRST so the committed check sees its
        # outcome: a force save at the step the writer is committing
        # must be the no-op, not a doomed re-write
        self.wait()
        if step in self.committed_steps():
            self.last_skip_reason = "already_committed"
            return False
        # the copies follow every kernel already queued on the caller's
        # stream (the step that produced this state)
        streams = {}
        jobs = []  # (path, est_bytes, [(key, materialize), ...])
        meta: Dict[str, Dict[str, Any]] = {}
        for path, leaf in _leaf_paths(tree):
            stream = None
            if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
                if leaf.device not in streams:
                    streams[leaf.device] = torch.cuda.current_stream(leaf.device)
                stream = streams[leaf.device]
            shard_fns, est = shard_copy_jobs(leaf, self.buffers, stream)
            jobs.append((path, est, shard_fns))
            shape, dtype = _shape_dtype(leaf)
            meta[path] = {"shape": list(shape), "dtype": dtype_name(dtype)}
        from concurrent.futures import ThreadPoolExecutor

        gate = InflightGate(self.buffer_bytes)
        abort = threading.Event()
        ready: Queue = Queue()
        phases = {"serialize": 0.0, "commit": 0.0}
        stats: Dict[str, Any] = {"parallel": self.parallel,
                                 "bytes": sum(est for _, est, _ in jobs)}
        self.last_save_stats = stats
        writer = threading.Thread(
            target=self._write_pipeline,
            args=(step, ready, meta, gate, abort, phases),
            daemon=True,
            name=f"ckpt-local-{self.host_id}",
        )
        self._writer = writer
        writer.start()
        pool = ThreadPoolExecutor(
            max_workers=self.parallel,
            thread_name_prefix=f"ckpt-snap-{self.host_id}")
        snap0 = time.perf_counter()
        all_futs = []
        try:
            for path, est, shard_fns in jobs:
                # leaf-granular admission: with the cap below the tree
                # size the snapshot throttles against the writer
                gate.acquire(est, abort)
                # copies DEPOSIT into a writer-owned dict and the
                # futures resolve to None, so the writer's clear() after
                # each leaf is the only liveness that matters
                staged: Dict[str, Any] = {}
                futs = [pool.submit(self._copy_shard, fn, staged, key,
                                    abort)
                        for key, fn in shard_fns]
                all_futs.extend(futs)
                ready.put((path, est, staged, futs))
        finally:
            ready.put(None)
        # every copy has completed (or died) before save() returns
        err: Optional[BaseException] = None
        for f in all_futs:
            try:
                f.result()
            except BaseException as e:
                if err is None:
                    err = e
                abort.set()
        pool.shutdown(wait=True)
        stats["snapshot_s"] = time.perf_counter() - snap0
        stats["peak_staged_bytes"] = gate.peak
        stats["gate_waits"] = gate.waits
        if err is not None:
            # ONE failure surfaces exactly once: when the writer died
            # first the copies were aborted as a side effect — raise
            # the writer's root cause here
            try:
                self.wait()
            except BaseException as werr:
                err = werr
            raise err
        if self.sync:
            self.wait()  # deterministic tests: commit, then return
        return True

    @staticmethod
    def _copy_shard(materialize, staged: Dict[str, Any], key: str,
                    abort: threading.Event) -> None:
        if abort.is_set():
            raise RuntimeError("ckpt save aborted")
        staged[key] = materialize()

    def _write_pipeline(self, step, ready: Queue, meta, gate, abort,
                        phases) -> None:
        """Background writer: staged copies → npy files + streaming crc
        (serialize), then manifest + barrier + atomic rename + marker
        (commit). Gate bytes and staging buffers are released leaf by
        leaf; any failure drains the queue (so the snapshot side never
        wedges in ``gate.acquire``) and removes the pending dir."""
        pending = self._pending_dir(step)
        manifest: Dict[str, Any] = {
            "step": step,
            "host": self.host_id,
            "leaves": {},
        }
        failed: Optional[BaseException] = None
        try:
            os.makedirs(self.host_dir, exist_ok=True)
            if os.path.exists(pending):
                shutil.rmtree(pending, ignore_errors=True)
            os.makedirs(pending)
        except BaseException as e:
            failed = e
            abort.set()
        while True:
            item = ready.get()
            if item is None:
                break
            path, est, staged, futs = item
            copies_ok = True
            try:
                for fut in futs:
                    try:
                        fut.result()  # join; copies live in `staged`
                    except BaseException:
                        # snapshot-side failure: save() raises it
                        abort.set()
                        copies_ok = False
                        break
                if copies_ok and failed is None and not abort.is_set():
                    t0 = time.perf_counter()
                    self._write_leaf(pending, path, meta[path], staged,
                                     manifest)
                    phases["serialize"] += time.perf_counter() - t0
            except BaseException as e:  # the WRITE died: writer-owned
                if failed is None:
                    failed = e
                abort.set()
            finally:
                # drop the staged copies BEFORE releasing their bytes
                for _, buf in list(staged.values()):
                    if buf is not None:
                        self.buffers.give(buf)
                staged.clear()
                gate.release(est)
        if abort.is_set() or failed is not None:
            shutil.rmtree(pending, ignore_errors=True)
            if failed is not None:
                self._writer_error = failed
            return
        try:
            t0 = time.perf_counter()
            self._commit(step, pending, manifest)
            phases["commit"] += time.perf_counter() - t0
        except BaseException as e:  # surfaced by the next wait()/save()
            self._writer_error = e
            return
        if self.on_phases is not None:
            try:
                self.on_phases(step, dict(phases))
            except Exception:
                log.warning("ckpt save phase callback failed",
                            exc_info=True)

    def _write_leaf(self, pending, path, entry_meta, staged,
                    manifest) -> None:
        leaf_dir = os.path.join(pending, _leaf_dirname(path))
        os.makedirs(leaf_dir, exist_ok=True)
        entry = dict(entry_meta)
        entry["shards"] = {}
        for key, (host, _) in staged.items():
            arr = to_numpy(host)
            fname = key.replace(":", "_").replace(",", "+") or "scalar"
            fpath = os.path.join(leaf_dir, fname + ".npy")
            with open(fpath, "wb") as f:
                _write_npy(f, arr)
                f.flush()
                os.fsync(f.fileno())
            entry["shards"][key] = {
                "file": os.path.relpath(fpath, pending),
                "crc": crc32_array(arr),
            }
        manifest["leaves"][path] = entry

    def _commit(self, step, pending, manifest) -> None:
        mpath = os.path.join(pending, MANIFEST)
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        # ---- phase 2: barrier, then atomic publish --------------------
        if _take_partial_commit():
            self.commit_failures += 1
            raise OSError(
                f"chaos: injected partial local commit at step {step} "
                f"(pending dir left behind)"
            )
        if self.barrier is not None:
            self.barrier(step)
        final = self.step_dir(step)
        os.rename(pending, final)
        cpath = os.path.join(final, COMMIT_MARKER)
        with open(cpath, "w") as f:
            f.write(f"{step}\n")
            f.flush()
            os.fsync(f.fileno())
        self.saves += 1
        self._retain()

    def wait(self) -> None:
        """Block until the in-flight write (if any) finished; re-raise
        its error exactly once."""
        t = self._writer
        if t is not None:
            t.join()
            self._writer = None
        err, self._writer_error = self._writer_error, None
        if err is not None:
            raise err

    def close(self) -> None:
        """Drain the writer and release the page-locked buffers."""
        try:
            self.wait()
        finally:
            self.buffers.close()

    def _retain(self) -> None:
        steps = self.committed_steps()
        for old in steps[: max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(self.step_dir(old), ignore_errors=True)
        # stale pending dirs from a crashed/failed commit are garbage
        for name in os.listdir(self.host_dir):
            if name.endswith(PENDING_SUFFIX):
                try:
                    pstep = int(name[len("step-"):-len(PENDING_SUFFIX)])
                except ValueError:
                    continue
                if steps and pstep < steps[-1]:
                    shutil.rmtree(
                        os.path.join(self.host_dir, name), ignore_errors=True
                    )

    # ------------------------------------------------------------ progress

    def note_progress(self, step: int) -> None:
        """Record the last COMPLETED train step — a tiny atomic write
        per step. Restore reads it (from any surviving host) to compute
        lost-steps-per-restart: progress - restored_step."""
        os.makedirs(self.host_dir, exist_ok=True)
        tmp = os.path.join(self.host_dir, PROGRESS_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump({"step": int(step)}, f)
        os.replace(tmp, os.path.join(self.host_dir, PROGRESS_FILE))

    def progress(self) -> int:
        try:
            with open(os.path.join(self.host_dir, PROGRESS_FILE)) as f:
                return int(json.load(f)["step"])
        except (OSError, ValueError, KeyError):
            return -1

    # ------------------------------------------------------------ read side

    def _hdir(self, host_id: Optional[int]) -> str:
        return (self.host_dir if host_id is None
                else os.path.join(self.root, f"host-{host_id}"))

    def committed_steps(self, host_id: Optional[int] = None) -> List[int]:
        """Ascending committed steps for a host on THIS filesystem
        (committed = dir renamed AND marker present)."""
        hdir = self._hdir(host_id)
        steps = []
        try:
            names = os.listdir(hdir)
        except OSError:
            return []
        for name in names:
            if not name.startswith("step-") or name.endswith(PENDING_SUFFIX):
                continue
            if not os.path.exists(os.path.join(hdir, name, COMMIT_MARKER)):
                continue
            try:
                steps.append(int(name[len("step-"):]))
            except ValueError:
                continue
        return sorted(steps)

    def manifest(self, step: int, host_id: Optional[int] = None) -> Optional[dict]:
        sdir = os.path.join(self._hdir(host_id), f"step-{step}")
        if not os.path.exists(os.path.join(sdir, COMMIT_MARKER)):
            return None
        try:
            with open(os.path.join(sdir, MANIFEST)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def read_shard(
        self, step: int, leaf_path: str, key: str, host_id: Optional[int] = None
    ) -> Optional[np.ndarray]:
        """Load + crc-verify one shard (an ndarray; a bfloat16 leaf as
        its 16-bit words); None when missing or corrupt (the caller
        falls back to a peer / the persistent tier). A requested index
        that is not stored is cut out of, or assembled from, the stored
        shards that cover it (:func:`covering_plan`)."""
        man = self.manifest(step, host_id=host_id)
        if man is None:
            return None
        entry = (man.get("leaves") or {}).get(leaf_path)
        if entry is None:
            return None
        shards = entry.get("shards") or {}
        plan = covering_plan(key, shards.keys())
        if plan is None:
            return None
        hdir = self._hdir(host_id)

        def load(stored_key: str) -> Optional[np.ndarray]:
            shard = shards[stored_key]
            fpath = os.path.join(hdir, f"step-{step}", shard["file"])
            try:
                arr = np.load(fpath)
            except (OSError, ValueError):
                return None
            if crc32_array(arr) != shard["crc"]:
                log.warning(
                    "local tier: crc mismatch for %s[%s] step %d host %s — "
                    "treating shard as lost",
                    leaf_path, stored_key, step,
                    host_id if host_id is not None else self.host_id,
                )
                return None
            return arr

        return compose_shard(key, plan, load)

    # ------------------------------------------------------------ chaos
    # helpers operating on a whole local root (any host), deterministic
    # given the caller's seeded rng.

    @staticmethod
    def corrupt_one_shard(root: str, rng) -> Optional[str]:
        """Flip bytes in one random committed shard file under ``root``.
        Returns the corrupted path, or None when nothing is committed."""
        candidates = []
        for host in sorted(os.listdir(root) if os.path.isdir(root) else []):
            hdir = os.path.join(root, host)
            if not host.startswith("host-") or not os.path.isdir(hdir):
                continue
            for sname in sorted(os.listdir(hdir)):
                sdir = os.path.join(hdir, sname)
                if sname.endswith(PENDING_SUFFIX) or not os.path.isdir(sdir):
                    continue
                if not os.path.exists(os.path.join(sdir, COMMIT_MARKER)):
                    continue
                for dirpath, _, files in os.walk(sdir):
                    for fn in files:
                        if fn.endswith(".npy"):
                            candidates.append(os.path.join(dirpath, fn))
        if not candidates:
            return None
        victim = rng.choice(sorted(candidates))
        with open(victim, "r+b") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            # stomp the tail (payload bytes, past the npy header)
            f.seek(max(0, size - 16))
            f.write(b"\xde\xad\xbe\xef" * 4)
        return victim

    @staticmethod
    def drop_host(root: str, rng, keep_at_least: int = 1) -> Optional[int]:
        """Delete one random host's entire local dir — the replaced-pod
        simulation. Refuses to drop below ``keep_at_least`` surviving
        hosts WITH DATA. Returns the dropped host id."""
        populated = []
        for n in sorted(os.listdir(root) if os.path.isdir(root) else []):
            hdir = os.path.join(root, n)
            if not n.startswith("host-") or not os.path.isdir(hdir):
                continue
            has_commit = any(
                s.startswith("step-") and not s.endswith(PENDING_SUFFIX)
                and os.path.exists(os.path.join(hdir, s, COMMIT_MARKER))
                for s in os.listdir(hdir)
            )
            if has_commit:
                try:
                    populated.append(int(n[len("host-"):]))
                except ValueError:
                    continue
        if len(populated) <= keep_at_least:
            return None
        victim = rng.choice(populated)
        shutil.rmtree(os.path.join(root, f"host-{victim}"), ignore_errors=True)
        return victim
