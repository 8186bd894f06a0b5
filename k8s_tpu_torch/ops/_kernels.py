"""Build and bind the port's hand-written CUDA kernels.

Each ``k8s_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers: a few seconds per source instead of
minutes). The build runs at first use, from the sources in the
checkout only, into ``k8s_tpu_torch/build/`` (git-ignored); one
``nvcc`` per source, all started together. A source may include the
shared header ``csrc/hopper.cuh`` (TMA tensor maps and loads, mbarrier
rings, wgmma descriptors and products, ``setmaxnreg``). A library is
keyed by a hash of its source, every ``csrc/*.cuh`` header and the
flags, so an edited source or header rebuilds and an unchanged one is
reused.

Every C entry point takes device pointers, sizes, strides and the CUDA
stream, launches on that stream without synchronising or allocating,
and returns ``cudaGetLastError()``; :func:`check` turns a non-zero code
into an exception. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# library name -> (source file, {C entry point: argtypes})
KERNELS = {
    "flash_fwd": ("flash_fwd.cu", {
        # q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, D,
        # q/k/v/o strides (batch, seq, head), scale, causal, tile config,
        # stream
        "k8s_flash_fwd_bf16": [_P] * 5 + [_I] * 6 + [_L] * 12 + [_F, _I, _I, _P],
        # tile config -> dynamic shared memory per block (bytes)
        "k8s_flash_fwd_smem_bytes": [_I],
    }),
    "flash_bwd": ("flash_bwd.cu", {
        # q, k, v, dout, lse, dd, dq, B, Sq, Sk, Hq, Hkv, D,
        # q/k/v/dout/dq strides (batch, seq, head), lse/dd row stride,
        # scale, causal, stream
        "k8s_flash_bwd_dq_bf16": [_P] * 7 + [_I] * 6 + [_L] * 16 + [_F, _I, _P],
        # q, k, v, dout, lse, dd, dk, dv, B, Sq, Sk, Hq, Hkv, D,
        # q/k/v/dout/dk/dv strides (batch, seq, head), lse/dd row stride,
        # scale, causal, stream
        "k8s_flash_bwd_dkv_bf16": [_P] * 8 + [_I] * 6 + [_L] * 19 + [_F, _I, _P],
        # kernel (0: dq, 1: dk/dv) -> dynamic shared memory per block (bytes)
        "k8s_flash_bwd_smem_bytes": [_I],
    }),
    "decode_attn": ("decode_attn.cu", {
        # q, k_new, v_new, k_cache, v_cache, pos, partial out, partial
        # lse, out, B, Hkv, G, S, D, split rows, scale, stream
        "k8s_decode_attn_bf16": [_P] * 9 + [_I] * 6 + [_F, _P],
    }),
    "decode_attn_q8": ("decode_attn_q8.cu", {
        # q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, pos,
        # partial out, partial lse, out, B, Hkv, G, S, D, split rows,
        # scale, stream
        "k8s_decode_attn_q8": [_P] * 11 + [_I] * 6 + [_F, _P],
    }),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where ``name``'s library is built: keyed by its source, the bytes
    of every header under ``csrc/`` (any source may include any) and
    the nvcc flags."""
    digest = hashlib.sha1((CSRC / KERNELS[name][0]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_log(name: str) -> str:
    """nvcc/ptxas output of the build that produced ``name``'s library
    (registers, shared memory and spills per kernel)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all() -> Dict[str, Path]:
    """Compile every kernel library that is not built yet — one nvcc
    process per source, all running at once — and return their paths.
    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in KERNELS}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name][0])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        out.with_suffix(".log").write_text(text)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, building every kernel
    library on the first call."""
    with _lock:
        if not _libs:
            for n, path in build_all().items():
                cdll = ctypes.CDLL(str(path))
                for entry, argtypes in KERNELS[n][1].items():
                    fn = getattr(cdll, entry)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                err = cdll.k8s_cuda_error_string
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                _libs[n] = cdll
        return _libs[name]


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused
    launch never runs, and a later synchronize would not report it)."""
    if code != 0:
        msg = _libs[name].k8s_cuda_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: error {code}: {msg}")
