#!/usr/bin/env python3
"""A/B of K1-K3 builds (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) in
one process on one card.

Each argument is a directory holding one build's ``flash_fwd.cu``,
``flash_bwd.cu`` and ``hopper.cuh`` (e.g. a parent commit's, unpacked
with ``git show <rev>:k8s_tpu_torch/csrc/<file>``); ``tree`` names this
checkout's ``k8s_tpu_torch/csrc``. Every build is compiled with the
port's nvcc flags into a library of its own and called through its C
entries (sources without segment ids, which take no segment pointer,
and sources without the kv-side segment row and the f32-output flags
are called with their older argument lists). At each shape (causal B 8, S
2048, Hq/Hkv 32/8, D 128 — Llama-3-8B's training attention — and
non-causal B 32, S 512, Hq = Hkv = 12, D 128) K1, K2 and K3 of every
build are timed with CUDA events (30 calls after 3 warm-ups; three
rounds, the builds in order then reversed; the median is printed), on
the same inputs, and their outputs are compared bit for bit with the
first build's.

    python3 scripts/flash_kernel_ab.py DIR_PARENT tree > ab.json
"""

from __future__ import annotations

import ctypes
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from k8s_tpu_torch.ops import _kernels  # noqa: E402
from k8s_tpu_torch.ops import attention as attn  # noqa: E402

P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# the C entries' argument lists: without segment ids ("old"), with one
# segment row ("seg"), and with the kv-side row and the f32-output flags
# ("kv": the entries of _kernels.KERNELS)
ABIS = {
    "old": {"k8s_flash_fwd_bf16": [P] * 5 + [I] * 6 + [L] * 12 + [F, I, I, P],
            "k8s_flash_bwd_dq_bf16": [P] * 7 + [I] * 6 + [L] * 16 + [F, I, P],
            "k8s_flash_bwd_dkv_bf16": [P] * 8 + [I] * 6 + [L] * 19 + [F, I, P]},
    "seg": {"k8s_flash_fwd_bf16": [P] * 6 + [L] + [I] * 6 + [L] * 12 + [F, I, I, P],
            "k8s_flash_bwd_dq_bf16": [P] * 8 + [I] * 6 + [L] * 16 + [F, I, P],
            "k8s_flash_bwd_dkv_bf16": [P] * 9 + [I] * 6 + [L] * 19 + [F, I, P]},
    "kv": {name: args for lib in ("flash_fwd", "flash_bwd")
           for name, args in _kernels.KERNELS[lib][1].items()},
}
SHAPES = ((8, 2048, 32, 8, 128, True), (32, 512, 12, 12, 128, False))


def build(srcdir: pathlib.Path, out: pathlib.Path):
    """The two libraries of one build, and its ABI (a key of ABIS)."""
    text = (srcdir / "flash_fwd.cu").read_text()
    abi = "kv" if "seg_kv" in text else ("seg" if "seg_stride" in text else "old")
    libs = {}
    for name in ("flash_fwd", "flash_bwd"):
        so = out / f"lib{name}.so"
        r = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(so),
                            str(srcdir / f"{name}.cu")], capture_output=True, text=True)
        if r.returncode:
            sys.exit(f"build of {srcdir / name}.cu failed:\n{r.stdout}{r.stderr}")
        lib = ctypes.CDLL(str(so))
        for entry, args in ABIS[abi].items():
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes = args
                getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs, abi


def calls(libs, abi, q, k, v, o, lse, do, dd, dq, dk, dv, causal, scale):
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    st = lambda x: list(x.stride()[:3])  # noqa: E731
    stream = torch.cuda.current_stream().cuda_stream

    # the segment pointers (null: none) and, for "kv", the f32-output flag
    # (0: bf16) each entry takes
    segs = {"old": [], "seg": [None], "kv": [None, None]}[abi]
    f32 = [0] if abi == "kv" else []

    def k1():
        fwd_segs = segs + [0] if segs else []  # + the row stride
        libs["flash_fwd"].k8s_flash_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            *fwd_segs, b, s, s, hq, hkv, d, *st(q), *st(k), *st(v), *st(o), scale,
            int(causal), *f32, 0, stream)

    def k2():
        libs["flash_bwd"].k8s_flash_bwd_dq_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dd.data_ptr(), *segs, dq.data_ptr(), b, s, s, hq, hkv, d, *st(q), *st(k),
            *st(v), *st(do), *st(dq), s, scale, int(causal), *f32, stream)

    def k3():
        libs["flash_bwd"].k8s_flash_bwd_dkv_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dd.data_ptr(), *segs, dk.data_ptr(), dv.data_ptr(), b, s, s, hq, hkv, d,
            *st(q), *st(k), *st(v), *st(do), *st(dk), *st(dv), s, scale, int(causal),
            *f32, stream)

    return {"k1": k1, "k2": k2, "k3": k3}


def ms(fn, reps: int = 30) -> float:
    for _ in range(3):
        fn()
    a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    z.record()
    torch.cuda.synchronize()
    return a.elapsed_time(z) / reps


def main(argv) -> None:
    if not argv or not torch.cuda.is_available():
        sys.exit("usage: flash_kernel_ab.py DIR|tree ... (needs a CUDA device)")
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="flash-ab-"))
    builds = {}
    for i, arg in enumerate(argv):
        src = _kernels.CSRC if arg == "tree" else pathlib.Path(arg)
        out = tmp / str(i)
        out.mkdir()
        builds[arg] = build(src, out)
    names = list(builds)
    g = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": torch.cuda.get_device_name(0)}
    for b, s, hq, hkv, d, causal in SHAPES:
        def rnd(*sh):
            return torch.randn(sh, generator=g, device="cuda").bfloat16()
        q, k, v, do = rnd(b, s, hq, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d), rnd(b, s, hq, d)
        scale = d ** -0.5
        o, lse = attn.flash_fwd(q, k, v, causal, scale, with_lse=True)
        dd = attn.compute_dd(o, do)
        bufs = {n: (torch.empty_like(o), torch.empty_like(lse), torch.empty_like(q),
                    torch.empty_like(k), torch.empty_like(v)) for n in names}
        fns = {n: calls(builds[n][0], builds[n][1], q, k, v, bufs[n][0], bufs[n][1], do,
                        dd, bufs[n][2], bufs[n][3], bufs[n][4], causal, scale)
               for n in names}
        times = {n: {kk: [] for kk in ("k1", "k2", "k3")} for n in names}
        for _ in range(3):
            for n in names + names[::-1]:
                for kk in ("k1", "k2", "k3"):
                    times[n][kk].append(ms(fns[n][kk]))
        torch.cuda.synchronize()
        key = f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} causal={causal}"
        result[key] = {n: {kk: sorted(x)[len(x) // 2] for kk, x in t.items()}
                       for n, t in times.items()}
        result[key]["bit_equal_to_first(o, lse, dq, dk, dv)"] = {
            n: [torch.equal(bufs[n][i], bufs[names[0]][i]) for i in range(5)]
            for n in names}
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main(sys.argv[1:])
