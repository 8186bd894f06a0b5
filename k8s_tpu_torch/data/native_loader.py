"""The port's ctypes binding of the native record loader
(``native/data_loader.cc``; port of ``k8s_tpu/data/native_loader.py``).

Fixed-size binary records -> batched numpy arrays, with the IO, shuffle
and batch assembly running on C++ threads outside the GIL. The JAX
package links ``data_loader.cc`` into its runtime library together with
``ktpu_runtime.cc``; the loader includes only standard headers, so the
port builds it alone (``g++ -O2 -std=c++17 -fPIC -shared -pthread``) at
first use — never at import — into the port's git-ignored build
directory (``ops/_kernels.BUILD_DIR``), keyed by a hash of the source
and the flags, as the CUDA kernels are. A missing ``g++`` or a failed
build raises: there is no Python reader to fall back to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

from k8s_tpu_torch.ops._kernels import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "data_loader.cc"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the loader library is built: keyed by its source and the
    compiler flags."""
    digest = hashlib.sha1(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libktpu_loader-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the loader library unless it is built already; returns its
    path. Raises with the compiler's output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native record loader "
                           f"({SOURCE}) cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native loader build failed ({cxx} exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loader library, built on the first call, every entry point's
    ``argtypes`` and ``restype`` declared."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        for name, args, res in (
            ("ktpu_loader_open", [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int], ctypes.c_int),
            ("ktpu_loader_register_buffers",
             [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int],
             ctypes.c_int),
            ("ktpu_loader_next_slot",
             [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
              ctypes.c_void_p, ctypes.c_int], ctypes.c_int),
            ("ktpu_loader_close", [ctypes.c_int], None),
        ):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _lib = lib
        return lib


class NativeRecordLoader:
    """Iterate batches of fixed-size records from a sharded file list
    (the file split is ``index % num_shards == shard_id``), assembled by
    the C++ producers straight into a ring of numpy buffers this loader
    owns (:meth:`next_zero_copy`).

    Each batch is a ``[n, record_bytes]`` uint8 view (n == ``batch``
    except possibly the last when ``drop_remainder=False``); reshape /
    view-cast to the record's layout at the call site.
    """

    def __init__(
        self,
        paths: Sequence[str],
        record_bytes: int,
        batch: int,
        *,
        queue_depth: int = 4,
        num_threads: int = 4,
        shuffle_buffer: int = 0,
        seed: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
        drop_remainder: bool = False,
        loop: bool = False,
    ):
        self._lib = load()
        self.record_bytes = record_bytes
        self.batch = batch
        h = self._lib.ktpu_loader_open(
            "\n".join(paths).encode(), record_bytes, batch, queue_depth,
            num_threads, shuffle_buffer, seed, shard_id, num_shards,
            int(drop_remainder), int(loop),
        )
        if h < 0:
            raise ValueError(f"ktpu_loader_open failed: errno {-h}")
        self._handle: Optional[int] = h
        self._queue_depth = queue_depth
        self._ring: Optional[np.ndarray] = None  # zero-copy buffers
        self._fallback: Optional[np.ndarray] = None
        self._prev_slot = -1

    def next_zero_copy(self, timeout_s: float = 60.0) -> Optional[np.ndarray]:
        """One batch with NO consumer-side copy: the producers assemble
        batches directly into a ring of numpy buffers this loader owns.
        The returned array is a view into that ring, VALID ONLY UNTIL THE
        NEXT CALL (its slot is then recycled): consume it synchronously
        or copy it."""
        if self._handle is None:
            raise RuntimeError("loader is closed")
        if self._ring is None:
            n = self._queue_depth + 4  # > queue_depth: producers never starve
            self._ring = np.empty((n, self.batch, self.record_bytes), np.uint8)
            ptrs = (ctypes.c_void_p * n)(
                *(self._ring[i].ctypes.data for i in range(n)))
            rc = self._lib.ktpu_loader_register_buffers(self._handle, ptrs, n)
            if rc < 0:
                raise OSError(-rc, "ktpu_loader_register_buffers")
            self._fallback = np.empty((self.batch, self.record_bytes), np.uint8)
        slot = ctypes.c_int(-1)
        n = self._lib.ktpu_loader_next_slot(
            self._handle, self._prev_slot, ctypes.byref(slot),
            self._fallback.ctypes.data_as(ctypes.c_void_p),
            int(timeout_s * 1000))
        self._prev_slot = slot.value
        if n == 0:
            return None
        if n == -110:
            raise TimeoutError("ktpu_loader_next_slot: no batch in time")
        if n < 0:
            raise OSError(-n, "ktpu_loader_next_slot")
        if slot.value < 0:  # a batch queued before registration, copied
            return self._fallback[:n]
        return self._ring[slot.value, :n]

    def iter_zero_copy(self) -> Iterator[np.ndarray]:
        """Iterate batches via :meth:`next_zero_copy` (each yielded array
        is invalidated by the following iteration)."""
        while True:
            b = self.next_zero_copy()
            if b is None:
                return
            yield b

    def close(self) -> None:
        if self._handle is not None:
            self._lib.ktpu_loader_close(self._handle)
            self._handle = None
            self._ring = None  # safe to release only after close joins

    def __del__(self):
        # zero-copy mode registers numpy ring buffers with the C++
        # producer threads; dropping the object without close() would
        # free memory those threads still write into. close() joins them
        # first. Guarded: ctypes may be torn down at interpreter exit.
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

