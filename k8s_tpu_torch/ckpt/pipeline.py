"""Shared checkpoint-pipeline primitives (port of
``k8s_tpu/ckpt/pipeline.py``): bounded staging, streaming crc, and the
device→host snapshot of tensors.

- :class:`InflightGate` — the leaf-granular host-bytes admission gate
  (copied). The restore planner acquires a leaf's shard bytes before
  its fetches start and releases them once the template's tensor holds
  them; the save path acquires before a leaf's device→host copy starts
  and releases once the background writer has flushed that leaf.
- :func:`crc32_array` — chunked ``zlib.crc32`` over an ndarray's
  contiguous payload, without the ``tobytes`` copy; a payload of
  ``CRC_PARALLEL_BYTES`` or more is cut into pieces whose crcs are taken
  on a thread pool (``zlib.crc32`` releases the GIL) and joined with
  :func:`crc32_combine`: the same value, several cores' rate.
- :func:`host_copy` / :func:`stage_tree` — the device→host snapshot.
  PyTorch updates parameters and optimizer moments IN PLACE (there is
  no donation), so a snapshot must own its bytes before the next step
  runs: a CUDA tensor is copied into page-locked host memory with a
  ``non_blocking`` copy on the caller's stream and the copy waited for
  on an event before the function returns; a CPU tensor is cloned
  (``t.cpu()`` and ``t.numpy()`` alias the live storage).
- :func:`to_numpy` / :func:`from_numpy` / :func:`dtype_name` — the
  on-disk vocabulary shared with the JAX package: a ``bfloat16`` leaf
  is written as its raw 16-bit words (npy descr ``<V2``, manifest dtype
  ``"bfloat16"``), which is what numpy writes for ``ml_dtypes``' type.
"""

from __future__ import annotations

import concurrent.futures
import functools
import os
import threading
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

# Default chunk for streaming crc: big enough that the Python-loop
# overhead vanishes, small enough to stay cache-friendly.
CRC_CHUNK_BYTES = 1 << 20


# Payloads at least this large take the parallel crc (the largest
# leaves of a Llama-3-8B-width state are 2.1 GB each)
CRC_PARALLEL_BYTES = 64 << 20
_CRC_POOL: Optional[concurrent.futures.ThreadPoolExecutor] = None
_CRC_POOL_LOCK = threading.Lock()


def _gf2_times(mat: List[int], vec: int) -> int:
    """The 32x32 GF(2) matrix ``mat`` (one int per column) times ``vec``."""
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_mul(a: List[int], b: List[int]) -> List[int]:
    return [_gf2_times(a, col) for col in b]


@functools.lru_cache(maxsize=64)
def _zeros_operator(nbytes: int) -> tuple:
    """The operator that feeds ``nbytes`` zero bytes through a crc32
    register (zlib's ``crc32_combine`` matrices, composed once per
    length)."""
    bit = [0xEDB88320] + [1 << n for n in range(31)]  # one zero bit
    byte = bit
    for _ in range(3):
        byte = _gf2_mul(byte, byte)                  # 8 zero bits
    out = [1 << n for n in range(32)]                 # the identity
    while nbytes:
        if nbytes & 1:
            out = _gf2_mul(byte, out)
        nbytes >>= 1
        if nbytes:
            byte = _gf2_mul(byte, byte)
    return tuple(out)


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """``zlib.crc32(a + b)`` from ``crc1 = zlib.crc32(a)``, ``crc2 =
    zlib.crc32(b)`` and ``len2 = len(b)`` (zlib's ``crc32_combine``)."""
    if len2 <= 0:
        return crc1
    return _gf2_times(list(_zeros_operator(int(len2))), crc1) ^ crc2


def _crc_chunked(mv, chunk_bytes: int) -> int:
    crc = 0
    for off in range(0, len(mv), chunk_bytes):
        crc = zlib.crc32(mv[off:off + chunk_bytes], crc)
    return crc


def _crc_pool() -> concurrent.futures.ThreadPoolExecutor:
    global _CRC_POOL
    with _CRC_POOL_LOCK:
        if _CRC_POOL is None:
            _CRC_POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1),
                thread_name_prefix="ckpt-crc")
        return _CRC_POOL


def crc32_array(arr: np.ndarray, chunk_bytes: int = CRC_CHUNK_BYTES) -> int:
    """crc32 of an ndarray's payload bytes WITHOUT the tobytes copy:
    identical to ``zlib.crc32(arr.tobytes())`` for any array, zero-copy
    for contiguous input (a non-contiguous one pays one compaction).
    ``CRC_PARALLEL_BYTES`` or more: pieces on the crc thread pool."""
    a = np.ascontiguousarray(arr)
    mv = memoryview(a).cast("B") if a.ndim else memoryview(a.tobytes())
    step = max(1, int(chunk_bytes))
    n = len(mv)
    workers = min(8, os.cpu_count() or 1)
    if n < CRC_PARALLEL_BYTES or workers < 2:
        return _crc_chunked(mv, step) & 0xFFFFFFFF
    piece = -(-n // (2 * workers))
    bounds = [(off, min(n, off + piece)) for off in range(0, n, piece)]
    crcs = list(_crc_pool().map(
        lambda b: _crc_chunked(mv[b[0]:b[1]], step), bounds))
    crc = crcs[0]
    for (lo, hi), c in zip(bounds[1:], crcs[1:]):
        crc = crc32_combine(crc, c, hi - lo)
    return crc & 0xFFFFFFFF


class InflightGate:
    """Bounds the host bytes a checkpoint pipeline holds at once.

    Admission is LEAF-granular: the scheduler acquires a whole leaf's
    bytes before any of its work starts, and the consumer releases them
    when the leaf's buffers are dropped. A single leaf may exceed the
    cap alone (``inflight == 0`` always admits; per-shard accounting
    would deadlock a leaf against its own release), and the cap bounds
    everything beyond it. ``cap <= 0`` disables the bound (peak still
    tracked)."""

    def __init__(self, cap_bytes: int):
        self.cap = int(cap_bytes)
        self._cond = threading.Condition()
        self.inflight = 0
        self.peak = 0
        self.waits = 0

    def acquire(self, n: int, abort: threading.Event) -> None:
        n = int(n)
        with self._cond:
            # n == 0 admits immediately: a leaf with nothing to stage
            # must not queue behind an oversized in-flight leaf
            if self.cap > 0 and n > 0:
                waited = False
                while (self.inflight > 0 and self.inflight + n > self.cap
                       and not abort.is_set()):
                    if not waited:
                        waited = True
                        self.waits += 1
                    self._cond.wait(timeout=0.1)
            self.inflight += n
            self.peak = max(self.peak, self.inflight)

    def release(self, n: int) -> None:
        with self._cond:
            self.inflight -= int(n)
            self._cond.notify_all()


def itemsize(dtype) -> int:
    """Bytes per element of a torch or numpy dtype (4 when unknown)."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    try:
        return np.dtype(dtype).itemsize if dtype is not None else 4
    except TypeError:
        return 4


def est_leaf_bytes(shape, dtype) -> int:
    """Host bytes a staged copy of ``shape``/``dtype`` will hold —
    geometry only, no payload read (the admission-gate estimate)."""
    n = 1
    for d in shape or ():
        n *= max(0, int(d))
    return max(1, n) * itemsize(dtype)


def dtype_name(dtype) -> str:
    """The manifest's dtype string: numpy's name (``"float32"``,
    ``"bfloat16"``, ``"int32"``), as the JAX package writes
    ``str(array.dtype)``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return str(np.dtype(dtype))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's payload as an ndarray sharing its memory; a
    bfloat16 tensor becomes its 16-bit words (dtype ``<V2``, the bytes
    numpy writes and reads for ``ml_dtypes.bfloat16``)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("<V2"))
    return t.numpy()


def from_numpy(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A CPU tensor of ``dtype`` over ``arr``'s bytes (no copy for a
    contiguous array): a 16-bit array (``<V2``/``uint16``/the JAX
    side's ``bfloat16``) read as ``torch.bfloat16`` keeps its bits;
    other dtypes convert only when they differ."""
    a = np.asarray(arr, order="C")  # keeps a 0-d array 0-d
    if dtype == torch.bfloat16 and a.dtype.itemsize == 2 \
            and a.dtype.kind != "f":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if not a.flags.writeable:
        a = a.copy()
    out = torch.from_numpy(a)
    return out if out.dtype == dtype else out.to(dtype)


class HostBuffers:
    """Page-locked host buffers for device→host snapshots, reused across
    saves. Each buffer is exactly the bytes asked for (memory from the
    CPU allocator, page-locked with ``cudaHostRegister``: the CUDA
    caching host allocator may round a request up to a power of two,
    which nearly doubles a multi-GB state), kept on a free list by size
    when the writer is done with it, and unregistered by
    :meth:`close`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._free: Dict[int, List[torch.Tensor]] = {}
        self._owned: List[torch.Tensor] = []
        self.allocated_bytes = 0

    def take(self, nbytes: int) -> torch.Tensor:
        """A uint8 ``[nbytes]`` page-locked buffer."""
        with self._lock:
            free = self._free.get(nbytes)
            if free:
                return free.pop()
        buf = torch.empty(nbytes, dtype=torch.uint8)
        if nbytes:
            rc = int(torch.cuda.cudart().cudaHostRegister(
                buf.data_ptr(), nbytes, 0))
            if rc != 0:
                raise RuntimeError(
                    f"cudaHostRegister of {nbytes} bytes failed (error {rc})")
        with self._lock:
            self._owned.append(buf)
            self.allocated_bytes += nbytes
        return buf

    def give(self, buf: torch.Tensor) -> None:
        with self._lock:
            self._free.setdefault(buf.numel(), []).append(buf)

    def close(self) -> None:
        with self._lock:
            owned, self._owned, self._free = self._owned, [], {}
            self.allocated_bytes = 0
        for buf in owned:
            if buf.numel():
                torch.cuda.cudart().cudaHostUnregister(buf.data_ptr())


def host_copy(t: torch.Tensor, buffers: Optional[HostBuffers] = None,
              stream=None):
    """``(copy, buffer)``: a host tensor holding ``t``'s values NOW, and
    the :class:`HostBuffers` buffer it lives in (None when it owns its
    memory). A CUDA tensor is copied ``non_blocking`` on ``stream``
    (default: the device's current stream, so the copy follows every
    kernel already queued there) into page-locked memory, and the copy
    is waited for on an event before this returns; a CPU tensor is
    cloned."""
    t = t.detach()
    if t.device.type != "cuda":
        return t.clone(memory_format=torch.contiguous_format), None
    stream = stream if stream is not None else torch.cuda.current_stream(t.device)
    nbytes = t.numel() * t.element_size()
    if buffers is not None:
        buf = buffers.take(nbytes)
        out = buf.view(t.dtype).view(t.shape) if nbytes else \
            torch.empty(t.shape, dtype=t.dtype)
    else:
        buf = None
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    with torch.cuda.stream(stream):
        out.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return out, buf


def stage_tree(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Host-staged copy of a flat ``{path: tensor}`` tree for a
    background committer: every CUDA leaf is copied device→host into
    page-locked memory with ``non_blocking`` copies on its device's
    current stream, one event per device waited for before this
    returns; CPU leaves are cloned. The caller may update the live
    tensors the moment this returns."""
    out: Dict[str, torch.Tensor] = {}
    streams = {}
    for path, t in tree.items():
        t = t.detach()
        if t.device.type != "cuda":
            out[path] = t.clone(memory_format=torch.contiguous_format)
            continue
        stream = streams.setdefault(t.device, torch.cuda.current_stream(t.device))
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        with torch.cuda.stream(stream):
            host.copy_(t, non_blocking=True)
        out[path] = host
    for stream in streams.values():
        done = torch.cuda.Event()
        done.record(stream)
        done.synchronize()
    return out


__all__ = [
    "CRC_CHUNK_BYTES",
    "HostBuffers",
    "InflightGate",
    "crc32_array",
    "dtype_name",
    "est_leaf_bytes",
    "from_numpy",
    "host_copy",
    "stage_tree",
    "to_numpy",
]
