#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``k8s_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``k8s_tpu_torch/csrc/``, holds
each one against its plain PyTorch version at the serving and training
paths' shapes (error, kernel / plain / library times and the kernel's
roofline bound), then drives the port's three main paths, in this order:

- serving: Llama-3-8B at full width and depth (random bf16 weights from
  a fixed seed) through the continuous-batching engine behind a real
  HTTP front-end, every emitted token checked against a teacher-forced
  forward;
- training: ``programs.llama_train.main`` at Llama-3-8B width cut to 8
  layers (seq 2048, batch 8, ``flash`` remat, fused CE, f32 AdamW) for
  10 steps on learnable data, the loss required to fall; a gradient
  oracle (2 layers, batch 1) against a forward of its own through plain
  attention; step time, tokens/s, MFU, peak memory and one profiled
  step's device-time split;
- int8 serving, once the bf16 model and the training state are freed:
  the same Llama-3-8B with int8 weights and an int8 KV cache
  (``--quant=int8_serving --kv_quant=int8``), 16 slots of 8192 rows, 16
  concurrent requests of 12…6000 prompt tokens, every emitted token
  checked against a teacher-forced forward of the same int8 model, and
  the bf16 model of the same seed compared for information.

Each path runs with the launch counts set to 0 just before it and read
just after, and fails unless every kernel of the path launched. Every
phase must pass; the script exits non-zero at the first failure and
prints its result lines only on success. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It needs no network and leaves no process behind.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import re
import statistics
import subprocess
import sys
import threading
import time
import types
import urllib.request

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): the roofline bounds
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
# tolerances. Each kernel is held against its plain version computed in
# f32 on the same bf16 inputs, row by row: a row (one query head's
# D-vector) errs by its L2 distance over the reference row's L2 norm.
# Rounding the output to bf16 alone moves a row by at most 2^-8 (0.0039)
# of its norm; the flash kernel also rounds P to bf16 for its P*V
# product. The f32 lse is held to the f32 logsumexp, absolutely.
FLASH_REL_TOL = 8e-3
DECODE_REL_TOL = 5e-3
FLASH_LSE_TOL = 1e-4
# The int8-KV decode kernel does K4's f32 math on the same int8 rows and
# scales as its plain version (the scales applied to the [G] scores and
# probs in both) and rounds its output to bf16 once: K4's limit holds.
# Its appended int8 rows and scales must be bit-equal.
DECODE_Q8_REL_TOL = DECODE_REL_TOL
# The backward kernels round dS and P to bf16 for their second products
# (each ~2^-9 relative, independent over the summed keys or queries) and
# their outputs to bf16: ~1.6e-3 rms per row, a few times that at the
# worst of ~10^5 rows. Rows whose reference is (near) zero in exact math
# — causal dq row 0, where dS = P (dP - D) vanishes — are measured
# against a floor of this share of the tensor's largest row norm.
FLASH_BWD_REL_TOL = 1e-2
FLASH_BWD_ROW_FLOOR = 1e-3
# each limit must sit below the error of a planted fault: the longest
# row with its last FAULT_ROWS keys dropped (8 are reported beside it)
FAULT_ROWS = 1
# teacher-forced oracle: every emitted token's logit within this much of
# the row max. Greedy decode runs the batched ragged path (decode
# kernel, batch-8 GEMMs); the oracle one forward per request through
# the plain attention path (no kernel, length-L GEMMs); bf16 rounding
# differs between the two, so a near-tie may resolve either way, but
# never by more than rounding.
ORACLE_LOGIT_TOL = 0.25
# training gradient oracle: every parameter's gradient after one step
# (2 layers at 8B width, batch 1, seq 2048) against the gradient of a
# forward of this script's own that runs plain attention (mha_reference,
# f32 softmax) and an unfused f32 head. Both compute in bf16 but round
# at different places (the kernels round P and dS, the fused head its
# inputs, to bf16), each rounding <= 2^-8 relative and independent over
# the 2047 summed tokens; the worst tensor's relative L2 error stays at
# the 1e-2 level, while a fault in a kernel's scale, a dropped diagonal
# or a remat replay moves a gradient by O(1).
GRAD_ORACLE_TOL = 5e-2
# int8 serving oracle: every emitted token's logit within this much of
# the row max of a teacher-forced forward of the same int8 model (same
# int8 weights and per-token activation quantization). That forward's
# one-shot prefill attends the exact k/v, while the served tokens saw
# the int8 cache: every earlier row quantized per row (rms error ~0.6%
# of a Gaussian row: amax ~2.8 sigma over 127 levels, over sqrt(12)),
# about six times the ~0.1% rms bf16 rounding that the bf16 oracle's
# 0.25 covers with its observed 0.034 (PERF.md) — so ~0.2 here, and a
# limit of five times that. A token scored one step off (a decode that
# reads the wrong position) sits at the distance of an unrelated token
# from the row max, and must exceed the limit, as must a token scored
# against another request's logits.
ORACLE_Q8_LOGIT_TOL = 1.0
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH = 8, 10, 2048, 8
# K1's tile config -> its kernel instance (csrc/flash_fwd.cu, templated on
# the number of consumer warpgroups), as torch.profiler names it
K1_INSTANCES = {0: "flash_fwd_kernel<2>", 1: "flash_fwd_kernel<1>"}
# the decode kernels' two launches per call (split, merge), by library
DECODE_KERNELS = {
    "decode_attn": ("decode_attn_split_kernel", "decode_attn_merge_kernel"),
    "decode_attn_q8": ("decode_attn_q8_split_kernel", "decode_attn_q8_merge_kernel"),
}
# the engine's slot depths in chip_smoke's decode profiles (bf16, int8)
SERVING_DEPTHS = [12, 300, 700, 1000, 1500, 2000, 40, 97]
SERVING_DEPTHS_INT8 = [12, 300, 700, 1000, 1500, 2000, 2500, 3000, 3500,
                       4000, 5000, 6000, 7000, 8000, 40, 97]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _profiled(torch, fn, reps: int):
    """key_averages() of ``reps`` calls of ``fn`` under torch.profiler
    (after one warm-up call). A session that records no device event at
    all is taken once more before giving up: one came back empty in a
    process that had opened ~40 sessions (PERF.md)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        if events:
            return events
    fail("torch.profiler recorded no device time")


def device_ms(torch, fn, reps: int = 10) -> float:
    """Device time per call: the device-side events (kernels, memcpy,
    memset) that torch.profiler records over ``reps`` calls, summed."""
    return sum(e.self_device_time_total for e in _profiled(torch, fn, reps)) / 1e3 / reps


def call_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Wall time per call of back-to-back calls between CUDA events: the
    larger of the device time and the host's launch path."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(torch, fn, names, reps: int = 5):
    """Device time per call of each kernel whose name contains one of
    ``names`` (torch.profiler over ``reps`` calls of ``fn``)."""
    out = {n: 0.0 for n in names}
    for e in _profiled(torch, fn, reps):
        for n in names:
            if n in e.key:
                out[n] += e.self_device_time_total / 1e3 / reps
    if not all(out.values()):
        fail(f"torch.profiler recorded no device time for {out}")
    return out


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row_rel_err(out, ref, floor: float = 0.0, floor_of=None) -> float:
    """Largest error of a row (the last axis): ||out - ref|| / ||ref||,
    with ||ref|| raised to ``floor`` times the largest row norm of
    ``floor_of`` (default: ref itself)."""
    ref = ref.float()
    diff = (out.float() - ref).norm(dim=-1)
    norms = ref.norm(dim=-1)
    top = (norms if floor_of is None else floor_of.float().norm(dim=-1)).max().item()
    denom = norms.clamp_min(max(floor * top, 1e-30))
    return (diff / denom).max().item()


def uncancelled_dq_dk(q, k, v, do, scale):
    """scale * dP * K and scale * dP * Q (f32, dP = dO . V per query row),
    what dq and dk would be with one visible key and no cancellation.
    At causal S 1 that is the situation: P = 1, dS = dP - D = 0 in exact
    math, so dq and dk vanish and their reference rows are rounding
    noise; their floor is taken from these instead (FLASH_BWD_ROW_FLOOR
    of it), so the limit says they are zero to 1e-5 of their terms."""
    hq, hkv = q.shape[2], k.shape[2]
    kx, vx = (x.float().repeat_interleave(hq // hkv, dim=2) for x in (k, v))
    dp = (do.float() * vx).sum(-1, keepdim=True)
    dk = (dp * q.float()).reshape(*q.shape[:2], hkv, hq // hkv, -1).sum(3)
    return scale * dp * kx, scale * dk


def sdpa(torch, q, k, v, **kw):
    """One PyTorch SDPA call as the library yardstick ([B, H, S, D])."""
    F = torch.nn.functional
    return lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)


def phase_flash(torch, attn, kernels, gen):
    """K1 against its plain version, Hq 32, Hkv 8, D 128: causal at B 1
    over the serving sweep S 16, 100, 256, 512, 1024, 2048 (each also
    timed under both tile configs: _flash_fwd_config's threshold)
    and at the training shape B 8 S 2048; then the edges of the tiling at
    B 2 — ragged causal S 129, 1000, 2047, non-causal Sq 300 over Sk 777,
    and q/k/v as strided views of one fused [B, S, Hq + 2 Hkv, D]
    tensor (the tensor maps' strides)."""
    hq, hkv, d = 32, 8, 128
    scale = 1.0 / d ** 0.5
    rnd = lambda *sh: torch.randn(sh, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731

    def check(what, q, k, v, causal):
        out, lse = attn.flash_fwd(q, k, v, causal, scale, with_lse=True)
        ref, ref_lse = attn.flash_fwd_plain(q.float(), k.float(), v.float(), causal, scale)
        torch.cuda.synchronize()
        row = {"rel_err": row_rel_err(out, ref),
               "max_abs_err": (out.float() - ref).abs().max().item(),
               "lse_err": (lse - ref_lse).abs().max().item(),
               "config": attn._flash_fwd_config(q.shape[0], q.shape[1], hq)}
        if not (row["rel_err"] <= FLASH_REL_TOL and row["lse_err"] <= FLASH_LSE_TOL):
            fail(f"flash_fwd {what}: {row} (tol {FLASH_REL_TOL}, lse {FLASH_LSE_TOL})")
        return row, ref, ref_lse

    def timed(row, b, s, q, k, v, plain=False):
        kernel = lambda: attn.flash_fwd(q, k, v, True, scale)  # noqa: E731
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        library = sdpa(torch, qt, kt, vt, is_causal=True)
        nbytes = 2 * (2 * b * s * hq * d + 2 * b * s * hkv * d)
        flops = 4 * b * hq * d * s * (s + 1) / 2  # visible causal pairs
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
        # both tile configs in one profiler session, told apart by instance
        both = kernel_ms(torch, lambda: [attn.flash_fwd(q, k, v, True, scale, config=c)
                                         for c in K1_INSTANCES], list(K1_INSTANCES.values()), reps=10)
        row["config_ms"] = {str(c): both[name] for c, name in K1_INSTANCES.items()}
        row["ms"] = row["config_ms"][str(row["config"])]
        row["tflops"] = flops / row["ms"] / 1e9
        if plain:
            row["plain_ms"] = device_ms(torch, lambda: attn.flash_fwd_plain(q, k, v, True, scale), reps=1)
        row["library_ms"] = device_ms(torch, library)
        row["call_ms"] = call_ms(torch, kernel)
        row["library_call_ms"] = call_ms(torch, library)

    rows, faults = [], {}
    for s in (16, 100, 256, 512, 1024, 2048):
        q, k, v = rnd(1, s, hq, d), rnd(1, s, hkv, d), rnd(1, s, hkv, d)
        row, ref, ref_lse = check(f"B=1 S={s}", q, k, v, True)
        if s == 2048:
            # planted faults: the last query row without its last n keys,
            # rounded to bf16 as the kernel's output would be
            for n in (FAULT_ROWS, 8):
                f_out, f_lse = attn.flash_fwd_plain(
                    q[:, -1:].float(), k[:, :-n].float(), v[:, :-n].float(),
                    False, scale)
                faults[f"drop_{n}"] = {
                    "rel_err": row_rel_err(f_out.to(torch.bfloat16), ref[:, -1:]),
                    "lse_err": (f_lse - ref_lse[:, :, -1:]).abs().max().item()}
            caught = faults[f"drop_{FAULT_ROWS}"]
            if not (caught["rel_err"] > FLASH_REL_TOL
                    and caught["lse_err"] > FLASH_LSE_TOL):
                fail(f"flash_fwd: the tolerances do not see a planted fault "
                     f"({FAULT_ROWS} keys dropped): {caught}")
        timed(row, 1, s, q, k, v, plain=s == 256)
        rows.append(dict(row, B=1, S=s))
    headline = next(r for r in rows if r["S"] == 256)

    b, s = TRAIN_BATCH, TRAIN_SEQ
    q, k, v = rnd(b, s, hq, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d)
    train, _, _ = check(f"B={b} S={s}", q, k, v, True)
    timed(train, b, s, q, k, v, plain=True)
    del q, k, v

    edges = []
    for sq, sk, causal, fused in ((129, 129, True, False), (1000, 1000, True, False),
                                  (2047, 2047, True, False), (300, 777, False, False),
                                  (1000, 1000, True, True)):
        if fused:
            qkv = rnd(2, sq, hq + 2 * hkv, d)
            q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
        else:
            q, k, v = rnd(2, sq, hq, d), rnd(2, sk, hkv, d), rnd(2, sk, hkv, d)
        row, _, _ = check(f"B=2 Sq={sq} Sk={sk} causal={causal} fused={fused}",
                          q, k, v, causal)
        edges.append(dict(row, B=2, Sq=sq, Sk=sk, causal=causal, fused_qkv=fused))

    # registers, spills (ptxas -v) and dynamic shared memory of both instances
    log = kernels.build_log("flash_fwd")
    ptxas = [ln.strip() for ln in log.splitlines() if "flash_fwd_kernel" in ln
             or "registers" in ln or "spill" in ln or "setmaxnreg" in ln]
    spill_bytes = sum(int(n) for n in re.findall(r"(\d+) bytes spill", log))
    smem = {str(c): kernels.lib("flash_fwd").k8s_flash_fwd_smem_bytes(c)
            for c in attn.FLASH_FWD_TILES}
    emit({"phase": "flash_fwd", "shape": "Hq=32 Hkv=8 D=128 bf16",
          "rel_tol": FLASH_REL_TOL, "lse_tol": FLASH_LSE_TOL,
          "planted_faults_S2048": faults, "rows_B1_causal": rows,
          "train_shape": dict(train, B=b, S=s), "edges_B2": edges,
          "ptxas": ptxas, "spill_bytes": spill_bytes, "dynamic_smem_bytes": smem})
    worst = max([*rows, train, *edges], key=lambda r: r["rel_err"])
    return dict(headline, max_abs_err=max(r["max_abs_err"] for r in [*rows, train, *edges]),
                rel_err=worst["rel_err"], train=train)


def phase_flash_bwd(torch, attn, kernels, gen):
    """K2 and K3 against their plain version in f32: B=2, Hq 32, Hkv 8,
    D 128, causal at S 128, 1000 (ragged tail) and 2048, and non-causal
    at S 777; then the edges of the tiling at B 2 — causal S 1, 65, 129,
    1000, 2047, non-causal Sq 300 over Sk 777, q/k/v as strided views of
    one fused [B, S, Hq + 2 Hkv, D] tensor, and Hq 12 over Hkv 4 (G 3);
    a repeat call bit-identical (no atomics); `ptxas -v` of both kernels;
    then K2, K3, the plain backward and SDPA's backward timed at the
    training shape (B=8, S=2048, causal)."""
    b, hq, hkv, d = 2, 32, 8, 128
    scale = 1.0 / d ** 0.5
    rnd = lambda *sh: torch.randn(sh, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
    rows, edges, faults = [], [], {}
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    worst_abs = {"dq": 0.0, "dkv": 0.0}

    def check(what, q, k, v, do, causal):
        out, lse = attn.flash_fwd(q, k, v, causal, scale, with_lse=True)
        got = attn.flash_bwd(q, k, v, out, lse, do, causal, scale)
        ref = attn.flash_bwd_plain(q.float(), k.float(), v.float(), out.float(),
                                   lse, do.float(), causal, scale)
        torch.cuda.synchronize()
        sq = q.shape[1]
        floor_of = (uncancelled_dq_dk(q, k, v, do, scale) if causal and sq == 1
                    else (None, None)) + (None,)
        row = {}
        for name, x, r, fl in zip(("dq", "dk", "dv"), got, ref, floor_of):
            row[name + "_rel_err"] = row_rel_err(x, r, floor=FLASH_BWD_ROW_FLOOR, floor_of=fl)
            row[name + "_max_abs_err"] = (x.float() - r).abs().max().item()
            worst[name] = max(worst[name], row[name + "_rel_err"])
        worst_abs["dq"] = max(worst_abs["dq"], row["dq_max_abs_err"])
        worst_abs["dkv"] = max(worst_abs["dkv"], row["dk_max_abs_err"],
                               row["dv_max_abs_err"])
        if max(row[n + "_rel_err"] for n in ("dq", "dk", "dv")) > FLASH_BWD_REL_TOL:
            fail(f"flash_bwd {what}: {row} (tol {FLASH_BWD_REL_TOL})")
        return row, out, lse, got, ref

    for s, causal in ((128, True), (1000, True), (2048, True), (777, False)):
        q, k, v, do = rnd(b, s, hq, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d), rnd(b, s, hq, d)
        row, out, lse, got, ref = check(f"S={s} causal={causal}", q, k, v, do, causal)
        if s == 2048:
            # planted faults. dq: the last query row without its last key
            # (a kv loop one key short). dk/dv: the first key of the last
            # tile without its diagonal query (a q loop starting one row
            # late). Both with the true lse, as a faulty kernel would.
            f_dq, _, _ = attn.flash_bwd_plain(
                q[:, -1:].float(), k[:, :-1].float(), v[:, :-1].float(),
                out[:, -1:].float(), lse[:, :, -1:], do[:, -1:].float(),
                False, scale)
            j = s - 64
            _, f_dk, f_dv = attn.flash_bwd_plain(
                q[:, j + 1:].float(), k[:, j:j + 1].float(), v[:, j:j + 1].float(),
                out[:, j + 1:].float(), lse[:, :, j + 1:].contiguous(),
                do[:, j + 1:].float(), False, scale)
            faults = {
                "dq_last_row_drop_last_key": row_rel_err(f_dq.to(torch.bfloat16), ref[0][:, -1:]),
                "dk_key_drop_diagonal_query": row_rel_err(f_dk.to(torch.bfloat16), ref[1][:, j:j + 1]),
                "dv_key_drop_diagonal_query": row_rel_err(f_dv.to(torch.bfloat16), ref[2][:, j:j + 1]),
            }
            if not min(faults.values()) > FLASH_BWD_REL_TOL:
                fail(f"flash_bwd: the tolerance does not see a planted fault: {faults}")
        rows.append(dict(row, S=s, causal=causal))
        del q, k, v, do, out, lse, got, ref

    repeat = None
    for sq, sk, causal, fused, h in ((1, 1, True, False, (32, 8)), (65, 65, True, False, (32, 8)),
                                     (129, 129, True, False, (32, 8)),
                                     (1000, 1000, True, False, (32, 8)),
                                     (2047, 2047, True, False, (32, 8)),
                                     (300, 777, False, False, (32, 8)),
                                     (1000, 1000, True, True, (32, 8)),
                                     (1000, 1000, True, False, (12, 4))):
        eq, ekv = h
        if fused:
            qkv = rnd(b, sq, eq + 2 * ekv, d)
            q, k, v = qkv[:, :, :eq], qkv[:, :, eq:eq + ekv], qkv[:, :, eq + ekv:]
        else:
            q, k, v = rnd(b, sq, eq, d), rnd(b, sk, ekv, d), rnd(b, sk, ekv, d)
        do = rnd(b, sq, eq, d)
        what = f"B=2 Sq={sq} Sk={sk} Hq={eq} Hkv={ekv} causal={causal} fused={fused}"
        row, out, lse, got, _ = check(what, q, k, v, do, causal)
        if fused:
            # the repeat check: no atomics, so a second call is bit-identical
            again = attn.flash_bwd(q, k, v, out, lse, do, causal, scale)
            torch.cuda.synchronize()
            repeat = all(torch.equal(x, y) for x, y in zip(got, again))
            if not repeat:
                fail(f"flash_bwd {what}: a repeat call is not bit-identical")
        edges.append(dict(row, B=b, Sq=sq, Sk=sk, Hq=eq, Hkv=ekv, causal=causal, fused_qkv=fused))
        del q, k, v, do, out, lse, got

    # registers, spills (ptxas -v) and dynamic shared memory of both kernels
    log = kernels.build_log("flash_bwd")
    ptxas = [ln.strip() for ln in log.splitlines() if "flash_bwd_d" in ln
             or "registers" in ln or "spill" in ln]
    spill_bytes = sum(int(n) for n in re.findall(r"(\d+) bytes spill", log))
    smem = {name: kernels.lib("flash_bwd").k8s_flash_bwd_smem_bytes(i)
            for i, name in enumerate(("dq", "dkv"))}

    # the training shape: one layer's attention, B 8, S 2048, causal
    b, s = TRAIN_BATCH, TRAIN_SEQ
    q, k, v, do = rnd(b, s, hq, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d), rnd(b, s, hq, d)
    out, lse = attn.flash_fwd(q, k, v, True, scale, with_lse=True)
    names = ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
    t_bwd = kernel_ms(torch, lambda: attn.flash_bwd(q, k, v, out, lse, do, True, scale), names)
    bwd_ms = device_ms(torch, lambda: attn.flash_bwd(q, k, v, out, lse, do, True, scale))
    plain_ms = device_ms(torch, lambda: attn.flash_bwd_plain(q, k, v, out, lse, do, True, scale), reps=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    o_sdpa = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    library_ms = device_ms(torch, lambda: torch.autograd.grad(
        o_sdpa, (qt, kt, vt), dot, retain_graph=True))
    pairs = s * (s + 1) / 2  # visible causal (query, key) pairs per head
    qo_bytes = 2 * b * s * hq * d           # one bf16 [B, S, Hq, D] tensor
    kv_bytes = 2 * b * s * hkv * d          # one bf16 [B, S, Hkv, D] tensor
    row_bytes = 4 * b * hq * s              # one f32 [B, Hq, S] row tensor
    k2_flops, k3_flops = 6 * b * hq * d * pairs, 8 * b * hq * d * pairs
    k2 = bound(3 * qo_bytes + 2 * kv_bytes + 2 * row_bytes, k2_flops)
    k3 = bound(2 * qo_bytes + 4 * kv_bytes + 2 * row_bytes, k3_flops)
    train = {
        "shape": f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} causal bf16",
        "k2_ms": t_bwd[names[0]], "k2_bound_ms": k2[0], "k2_bound_by": k2[1],
        "k2_tflops": k2_flops / t_bwd[names[0]] / 1e9,
        "k3_ms": t_bwd[names[1]], "k3_bound_ms": k3[0], "k3_bound_by": k3[1],
        "k3_tflops": k3_flops / t_bwd[names[1]] / 1e9,
        "k2_k3_ms": t_bwd[names[0]] + t_bwd[names[1]],
        "flash_bwd_ms": bwd_ms, "plain_bwd_ms": plain_ms,
        "sdpa_bwd_ms": library_ms,
        "k2_k3_over_sdpa": (t_bwd[names[0]] + t_bwd[names[1]]) / library_ms}
    emit({"phase": "flash_bwd", "shape": "B=2 Hq=32 Hkv=8 D=128 bf16",
          "rel_tol": FLASH_BWD_REL_TOL, "row_floor": FLASH_BWD_ROW_FLOOR,
          "planted_faults_S2048": faults, "rows": rows, "edges": edges,
          "repeat_bit_identical": repeat, "train_shape": train,
          "ptxas": ptxas, "spill_bytes": spill_bytes, "dynamic_smem_bytes": smem})
    del q, k, v, do, out, lse, qt, kt, vt, o_sdpa, dot
    torch.cuda.empty_cache()
    common = {"shape": train["shape"] + " (errors: worst over B=2 S 128,1000,2048 causal, "
                                        "777 non-causal and the edges)",
              "plain_ms": plain_ms, "library_ms": library_ms}
    return {
        "flash_bwd_dq": dict(common, max_abs_err=worst_abs["dq"], rel_err=worst["dq"],
                             ms=train["k2_ms"], bound_ms=k2[0], bound_by=k2[1]),
        "flash_bwd_dkv": dict(common, max_abs_err=worst_abs["dkv"],
                              rel_err=max(worst["dk"], worst["dv"]),
                              ms=train["k3_ms"], bound_ms=k3[0], bound_by=k3[1]),
    }


def ptxas_by_kernel(log: str, names) -> dict:
    """Registers, spill bytes and static shared memory of each kernel of
    ``names`` from a ``ptxas -v`` build log (mangled names contain them)."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = next((n for n in names if n in m.group(1)), None)
            continue
        if cur is None:
            continue
        row = out.setdefault(cur, {})
        if (r := re.search(r"Used (\d+) registers", ln)):
            row["registers"] = int(r.group(1))
        if (r := re.search(r"(\d+) bytes smem", ln)):
            row["static_smem_bytes"] = int(r.group(1))
        if (r := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            row["spill_bytes"] = int(r.group(1)) + int(r.group(2))
    return out


def split_boundary_pos(s: int, rows: int):
    """Cache depths on the decode kernels' split boundaries for split
    length ``rows``, with 0, 1, S - 2 and S - 1."""
    cand = {0, 1, rows - 1, rows, rows + 1, 2 * rows - 1, 2 * rows, 2 * rows + 1,
            s - rows - 1, s - rows, s - rows + 1, s - 2, s - 1}
    return sorted(p for p in cand if 0 <= p < s)


def decode_split_checks(torch, attn, kernels, lib, call, plain, fresh, b, s, hkv,
                        pos, sweep_pos):
    """The split grid's extras for one decode kernel (``lib``): split length
    and grid, the device time of its split and merge launches at ``pos``,
    a repeat call bit-identical (outputs and caches), every split boundary
    within the decode limit, ``ptxas -v`` of both kernels, and each split
    length of DECODE_SPLIT_ROWS timed at ``pos`` and at ``sweep_pos``.
    ``call(caches, pos, split_rows)`` runs the kernel on ``caches``,
    ``plain(caches, pos)`` the plain version in f32 (each returns out and
    appends to the caches), ``fresh()`` gives a copy of the original
    caches."""
    names = DECODE_KERNELS[lib]
    rows = attn._decode_split_rows(b, hkv, s)
    first, second = fresh(), fresh()
    a, b_out = call(first, pos, None), call(second, pos, None)
    torch.cuda.synchronize()
    repeat = torch.equal(a, b_out) and all(torch.equal(x, y) for x, y in zip(first, second))
    if not repeat:
        fail(f"{lib}: a repeat call is not bit-identical")
    tol = DECODE_Q8_REL_TOL if lib == "decode_attn_q8" else DECODE_REL_TOL
    boundary = split_boundary_pos(s, rows)
    errs = []
    for i in range(0, len(boundary), b):
        chunk = boundary[i:i + b]
        p = torch.tensor(chunk + [0] * (b - len(chunk)), dtype=torch.int32, device="cuda")
        got, want = fresh(), fresh()
        out = call(got, p, None)
        ref = plain(want, p)
        torch.cuda.synchronize()
        errs.append(row_rel_err(out, ref))
        if not (errs[-1] <= tol and all(torch.equal(x, y) for x, y in zip(got, want))):
            fail(f"{lib}: at split-boundary depths {chunk}: row error {errs[-1]} "
                 f"(tol {tol}); caches after the append equal the plain "
                 f"version's: {all(torch.equal(x, y) for x, y in zip(got, want))}")
    caches = fresh()
    split_ms = kernel_ms(torch, lambda: call(caches, pos, None), names, reps=10)
    sweep = {}
    for label, sp in (("pos", pos), ("serving_depths", sweep_pos)):
        for c in attn.DECODE_SPLIT_ROWS:
            t = kernel_ms(torch, lambda: call(caches, sp, c), names, reps=10)
            sweep[f"{label}_C{c}"] = {"split": t[names[0]], "merge": t[names[1]],
                                      "total": t[names[0]] + t[names[1]]}
    return {"split_rows": rows, "grid": [-(-s // rows), hkv, b],
            "kernel_ms": split_ms, "repeat_bit_identical": repeat,
            "boundary_pos": boundary, "boundary_rel_err": max(errs),
            "split_rows_sweep_ms": sweep,
            "ptxas": ptxas_by_kernel(kernels.build_log(lib), names)}


def phase_decode(torch, attn, kernels, gen):
    """K4 against its plain version: B=8 slots, S=2048, Hq 32, Hkv 8;
    then its split grid's extras (decode_split_checks)."""
    b, hq, hkv, s, d = 8, 32, 8, 2048, 128
    scale = 1.0 / d ** 0.5
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
    q, kn, vn = rnd(b, hq, d), rnd(b, hkv, d), rnd(b, hkv, d)
    kc, vc = rnd(b, hkv, s, d), rnd(b, hkv, s, d)
    pos = torch.tensor([0, 2047, 1, 100, 513, 1024, 1500, 2000],
                       dtype=torch.int32, device="cuda")
    kc1, vc1, kc2, vc2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    out, _, _ = attn.decode_attention_update(q, kn, vn, kc1, vc1, pos, scale)

    def plain_f32(i, p):
        """The plain version in f32 for batch rows ``i`` at depths ``p``
        (on f32 copies of the caches, which it appends to)."""
        return attn.decode_attention_plain(
            *(x[i].float() for x in (q, kn, vn, kc, vc)), p, scale)

    every = slice(None)
    ref = plain_f32(every, pos)
    torch.cuda.synchronize()
    err = row_rel_err(out, ref)
    abs_err = (out.float() - ref).abs().max().item()
    want_k, want_v = kc.clone(), vc.clone()
    rows = torch.arange(b, device="cuda")
    want_k[rows, :, pos.long()] = kn
    want_v[rows, :, pos.long()] = vn
    cache_ok = torch.equal(kc1, want_k) and torch.equal(vc1, want_v)
    if not (err <= DECODE_REL_TOL and cache_ok):
        fail(f"decode_attn: row error {err} (tol {DECODE_REL_TOL}), "
             f"cache rows appended at pos and nothing else: {cache_ok}")
    # planted faults: the deepest row without its last n cache rows (the
    # plain version at depth pos - n), rounded to bf16 like the kernel's
    deep = int(pos.argmax().item())
    one = slice(deep, deep + 1)
    faults = {f"drop_{n}": row_rel_err(
        plain_f32(one, pos[one] - n).to(torch.bfloat16), ref[one])
        for n in (FAULT_ROWS, 8)}
    if not faults[f"drop_{FAULT_ROWS}"] > DECODE_REL_TOL:
        fail(f"decode_attn: the tolerance does not see a planted fault "
             f"({FAULT_ROWS} rows dropped at pos {int(pos[deep])}): {faults}")
    kernel = lambda: attn.decode_attention_update(q, kn, vn, kc1, vc1, pos, scale)  # noqa: E731
    visible = (torch.arange(s, device="cuda")[None, :] <= pos[:, None].long())
    library = sdpa(torch, q[:, :, None], kc1, vc1,
                   attn_mask=visible[:, None, None, :])
    rows_read = int(pos.sum().item())
    nbytes = (2 * rows_read * hkv * d * 2          # cache rows < pos, k and v
              + 2 * (2 * b * hq * d)               # q in, out
              + 2 * 2 * (2 * b * hkv * d)          # k/v new in, row written
              + 4 * b)                             # pos
    flops = 4 * (rows_read + b) * hq * d
    bound_ms, by = bound(nbytes, flops)
    def call(caches, p, rows):
        return attn.decode_attention_update(q, kn, vn, *caches, p, scale, split_rows=rows)[0]

    split = decode_split_checks(
        torch, attn, kernels, "decode_attn", call,
        lambda caches, p: attn.decode_attention_plain(
            *(x.float() for x in (q, kn, vn)), *caches, p, scale),
        lambda: [kc.clone(), vc.clone()], b, s, hkv, pos, torch.tensor(SERVING_DEPTHS, dtype=torch.int32, device="cuda"))
    row = {"rel_err": max(err, split["boundary_rel_err"]), "max_abs_err": abs_err,
           "cache_rows_ok": cache_ok, "planted_faults": faults, **split,
           "ms": device_ms(torch, kernel),
           "plain_ms": device_ms(torch, lambda: attn.decode_attention_plain(q, kn, vn, kc2, vc2, pos, scale)),
           "library_ms": device_ms(torch, library),
           "bound_ms": bound_ms, "bound_by": by,
           "call_ms": call_ms(torch, kernel),
           "library_call_ms": call_ms(torch, library)}
    emit({"phase": "decode_attn",
          "shape": "B=8 S=2048 Hq=32 Hkv=8 D=128 bf16, pos " + str(pos.tolist()),
          "rel_tol": DECODE_REL_TOL, **row})
    return row


def phase_decode_q8(torch, attn, kernels, gen):
    """K5 against its plain version: B=16 slots, S=8192, Hq 32, Hkv 8,
    D 128, ragged pos over [0, S) with 0 and S - 1, caches quantized
    from seeded bf16 rows, then its split grid's extras
    (decode_split_checks); K4 and SDPA timed at the same positions over
    those bf16 rows, K4's split and merge apart."""
    b, hq, hkv, s, d = 16, 32, 8, 8192, 128
    scale = 1.0 / d ** 0.5
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
    q, kn, vn = rnd(b, hq, d), rnd(b, hkv, d), rnd(b, hkv, d)
    kb, vb = rnd(b, hkv, s, d), rnd(b, hkv, s, d)
    (kc, ks), (vc, vs) = attn.quantize_kv_rows(kb), attn.quantize_kv_rows(vb)
    orig = (kc, vc, ks, vs)
    pos = torch.tensor([0, 8191, 1, 37, 500, 1024, 2047, 3000, 4095, 4500,
                        5000, 6000, 6500, 7000, 7777, 8190],
                       dtype=torch.int32, device="cuda")
    got = [t.clone() for t in orig]
    out = attn.decode_attention_update_q8(q, kn, vn, *got, pos, scale)[0]
    plain_caches = [t.clone() for t in orig]
    ref = attn.decode_attention_q8_plain(q.float(), kn.float(), vn.float(),
                                         *plain_caches, pos, scale)
    torch.cuda.synchronize()
    err = row_rel_err(out, ref)
    abs_err = (out.float() - ref).abs().max().item()
    # what the append must leave: the original caches with row pos[b]
    # of each (b, head) replaced by the quantized new row and its scales
    want = [t.clone() for t in orig]
    rows = torch.arange(b, device="cuda")
    for (c, sc), new in (((want[0], want[2]), kn), ((want[1], want[3]), vn)):
        c[rows, :, pos.long()], sc[rows, :, pos.long()] = attn.quantize_kv_rows(new)
    caches_ok = all(torch.equal(x, w) for x, w in zip(got, want))
    plain_ok = all(torch.equal(x, w) for x, w in zip(plain_caches, want))
    if not (err <= DECODE_Q8_REL_TOL and caches_ok and plain_ok):
        fail(f"decode_attn_q8: row error {err} (tol {DECODE_Q8_REL_TOL}); "
             f"kernel caches = original + quantized row at pos: {caches_ok}; "
             f"plain caches likewise: {plain_ok}")

    # planted faults on the deepest row, rounded to bf16 like the kernel's
    # out: its last n cache rows dropped, and every row's value scale
    # taken from the row before
    deep = int(pos.argmax().item())
    one = slice(deep, deep + 1)

    def plain_one(p, v_scale):
        c = [t[one].clone() for t in orig]
        c[3] = v_scale
        return attn.decode_attention_q8_plain(
            q[one].float(), kn[one].float(), vn[one].float(), *c, p, scale
        ).to(torch.bfloat16)

    faults = {f"drop_{n}": row_rel_err(plain_one(pos[one] - n, vs[one].clone()), ref[one])
              for n in (FAULT_ROWS, 8)}
    faults["v_scale_of_previous_row"] = row_rel_err(
        plain_one(pos[one], torch.roll(vs[one], 1, dims=-1)), ref[one])
    if not min(faults[f"drop_{FAULT_ROWS}"], faults["v_scale_of_previous_row"]) > DECODE_Q8_REL_TOL:
        fail(f"decode_attn_q8: the tolerance does not see a planted fault: {faults}")

    def call(caches, p, rows):
        return attn.decode_attention_update_q8(q, kn, vn, *caches, p, scale,
                                               split_rows=rows)[0]

    split = decode_split_checks(
        torch, attn, kernels, "decode_attn_q8", call,
        lambda caches, p: attn.decode_attention_q8_plain(
            *(x.float() for x in (q, kn, vn)), *caches, p, scale),
        lambda: [t.clone() for t in orig], b, s, hkv, pos,
        torch.tensor(SERVING_DEPTHS_INT8, dtype=torch.int32, device="cuda"))
    kernel = lambda: attn.decode_attention_update_q8(q, kn, vn, *got, pos, scale)  # noqa: E731
    # the library yardstick: SDPA over the cache dequantized to bf16 (the
    # dequantization itself is not timed: SDPA has no int8 input)
    kd = (got[0].float() * got[2][..., None]).to(torch.bfloat16)
    vd = (got[1].float() * got[3][..., None]).to(torch.bfloat16)
    visible = (torch.arange(s, device="cuda")[None, :] <= pos[:, None].long())
    library = sdpa(torch, q[:, :, None], kd, vd, attn_mask=visible[:, None, None, :])
    kb4, vb4 = kb.clone(), vb.clone()
    k4 = lambda: attn.decode_attention_update(q, kn, vn, kb4, vb4, pos, scale)  # noqa: E731
    rows_read = int(pos.sum().item())
    new_rows = 2 * b * hkv * d
    nbytes = (rows_read * hkv * (2 * d + 2 * 4)    # int8 k and v rows < pos, 2 scales
              + 2 * (2 * b * hq * d)               # q in, out (bf16)
              + 2 * new_rows                       # k/v new in (bf16)
              + new_rows + 2 * b * hkv * 4         # new int8 rows and scales written
              + 4 * b)                             # pos
    flops = 4 * (rows_read + b) * hq * d
    bound_ms, by = bound(nbytes, flops)
    k4_bytes = (2 * rows_read * hkv * d * 2 + 2 * (2 * b * hq * d)
                + 2 * 2 * new_rows + 4 * b)
    k4_bound_ms, _ = bound(k4_bytes, flops)
    row = {"rel_err": max(err, split["boundary_rel_err"]), "max_abs_err": abs_err,
           "caches_bit_equal": caches_ok, "planted_faults": faults, **split,
           "ms": device_ms(torch, kernel),
           "plain_ms": device_ms(torch, lambda: attn.decode_attention_q8_plain(
               q, kn, vn, *plain_caches, pos, scale), reps=3),
           "library_ms": device_ms(torch, library),
           "bound_ms": bound_ms, "bound_by": by, "bytes": nbytes,
           "k4_same_pos_ms": device_ms(torch, k4),
           "k4_same_pos_split_rows": attn._decode_split_rows(b, hkv, s),
           "k4_same_pos_kernel_ms": kernel_ms(torch, k4, DECODE_KERNELS["decode_attn"]),
           "k4_same_pos_bound_ms": k4_bound_ms, "k4_bytes": k4_bytes,
           # the library yardstick for K4 at these positions: SDPA over the
           # bf16 rows, visibility mask as above
           "k4_same_pos_library_ms": device_ms(torch, sdpa(
               torch, q[:, :, None], kb4, vb4, attn_mask=visible[:, None, None, :])),
           "k4_same_pos_plain_ms": device_ms(torch, lambda: attn.decode_attention_plain(
               q, kn, vn, kb, vb, pos, scale), reps=3),
           "call_ms": call_ms(torch, kernel),
           "library_call_ms": call_ms(torch, library)}
    emit({"phase": "decode_attn_q8",
          "shape": "B=16 S=8192 Hq=32 Hkv=8 D=128, int8 cache + f32 row scales, pos "
                   + str(pos.tolist()),
          "rel_tol": DECODE_Q8_REL_TOL, **row})
    del kb, vb, kc, vc, ks, vs, got, plain_caches, want, kd, vd, kb4, vb4
    torch.cuda.empty_cache()
    return row


def post(port, payload, timeout=600):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def phase_serving(torch, attn, card):
    """Llama-3-8B through the engine and a real HTTP front-end: the
    wiring of k8s_tpu_torch.programs.serving.main."""
    from k8s_tpu_torch.programs.llama_generate import (
        decode_model_config, load_decode_params)
    from k8s_tpu_torch.serving import ContinuousBatchingEngine, ServingFrontend

    max_seq, new_tokens = 2048, 32
    t0 = time.perf_counter()
    cfg = decode_model_config("llama3-8b", max_seq, {}, ragged=True)
    model = load_decode_params(cfg, "", seed=0, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    buckets = [b for b in (16, 32, 64, 128, 256, 512, 1024) if b < max_seq]
    engine = ContinuousBatchingEngine(
        model, max_slots=8, decode_chunk=32, prompt_buckets=buckets,
        prefill_chunk=256)
    frontend = ServingFrontend(engine, port=0)
    stop = threading.Event()
    pump = threading.Thread(target=frontend.serve, args=(stop.is_set,))
    pump.start()
    rng = np.random.RandomState(0)
    lens = [12, 40, 97, 160, 256, 257, 300, 513, 700, 1000]
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in lens]
    results = [None] * len(prompts)
    try:
        post(frontend.port, {"prompt": prompts[0][:20], "max_new_tokens": 4})  # warm-up
        stats0 = dict(engine.stats)
        attn.flash_fwd.launches = 0
        attn.decode_attention_update.launches = 0

        def client(i):
            results[i] = post(frontend.port, {"prompt": prompts[i],
                                              "max_new_tokens": new_tokens})

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t1
        launches = {"flash_fwd": attn.flash_fwd.launches,
                    "decode_attn": attn.decode_attention_update.launches}
    finally:
        stop.set()
        pump.join(timeout=300)
    if pump.is_alive() or any(r is None for r in results):
        fail("serving: a request or the pump did not finish")
    for name, n in launches.items():
        if n <= 0:
            fail(f"serving: kernel {name} never launched on the main path")

    # oracle: one teacher-forced forward per request through the plain
    # attention path (a warm cache of its own takes _cached_attention),
    # so neither kernel runs on the oracle's side and a kernel fault
    # cannot cancel out
    gaps, exact = [], 0
    for p, r in zip(prompts, results):
        toks = r["tokens"]
        if len(toks) != new_tokens:
            fail(f"serving: {len(toks)} tokens for a {new_tokens}-token request")
        ids = torch.tensor([p + toks], dtype=torch.long, device="cuda")
        cache = model.new_cache(1)
        cache.fresh = False
        hidden, _ = model(ids, positions=torch.arange(ids.shape[1], device="cuda")[None],
                          cache=cache, return_hidden=True)
        del cache
        logits = model.lm_head_logits(hidden[0, len(p) - 1:len(p) - 1 + len(toks)])
        if not torch.isfinite(logits).all():
            fail("serving: non-finite logits in the oracle forward")
        tok_t = torch.tensor(toks, device="cuda")
        gap = logits.max(-1).values - logits.gather(1, tok_t[:, None])[:, 0]
        gaps.append(gap.max().item())
        exact += int((logits.argmax(-1) == tok_t).sum().item())
    worst = max(gaps)
    if (attn.flash_fwd.launches, attn.decode_attention_update.launches) != (
            launches["flash_fwd"], launches["decode_attn"]):
        fail("serving oracle: a kernel launched on the oracle's plain path")
    if worst > ORACLE_LOGIT_TOL:
        fail(f"serving oracle: emitted-token logit {worst} below the row max "
             f"(tol {ORACLE_LOGIT_TOL})")
    n_tok = new_tokens * len(prompts)
    ttfts = sorted(r["ttft_s"] for r in results)
    stats = {k: v - stats0.get(k, 0) for k, v in engine.stats.items()
             if k != "queue_depth"}
    emit({
        "phase": "serving", "model": "llama3_8b", "layers": cfg.num_layers,
        "vocab": cfg.vocab_size, "dtype": "bfloat16", "max_seq_len": max_seq,
        "max_slots": 8, "decode_chunk": 32, "prefill_chunk": 256,
        "requests": len(prompts), "prompt_lens": lens, "new_tokens": new_tokens,
        "load_s": load_s, "wall_s": wall, "tokens_per_s": n_tok / wall,
        # tokens decoded (all but each request's prefill token) over the
        # engine's decode-chunk time
        "decode_tokens_per_s": (n_tok - len(prompts)) / stats["chunk_s"],
        "decode_step_ms": 1e3 * stats["chunk_s"] / stats["decode_steps"],
        "ttft_p50_s": float(np.median(ttfts)), "ttft_max_s": ttfts[-1],
        "oracle_max_gap": worst, "oracle_tol": ORACLE_LOGIT_TOL,
        "oracle_exact_share": exact / n_tok, "launches": launches,
        "engine_stats": stats, "card": card,
    })
    phase_decode_profile(torch, model, card,
                         [12, 300, 700, 1000, 1500, 2000, 40, 97])
    # free the serving model (16 GB) and its caches before training
    del engine, frontend, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_decode_profile(torch, model, card, depths, phase="decode_profile"):
    """Where one decode step's time goes: torch.profiler over a few
    steps at the serving shapes, one slot at each of ``depths`` (device
    busy share, top kernels). Returns the device ms per step."""
    from torch.profiler import ProfilerActivity, profile

    b, steps = len(depths), 4
    cache = model.new_cache(b)
    cache.fresh = False
    tok = torch.zeros((b, 1), dtype=torch.int32, device="cuda")
    pos = torch.tensor(depths, dtype=torch.int32, device="cuda")[:, None]
    model(tok, positions=pos, cache=cache)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            model(tok, positions=pos, cache=cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device-side events only (kernels, memcpy/memset): CPU-side ops
    # carry their kernels' time too and would count it twice
    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_ms = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    emit({"phase": phase, "batch": b, "steps": steps, "depths": list(depths),
          "step_wall_ms": wall_ms,
          "step_device_ms": device_ms if rows else None,
          "device_busy_share": device_ms / wall_ms if rows else None,
          "device_ops_per_step": sum(r[2] for r in rows),
          "top": [{"op": k, "ms_per_step": t, "calls_per_step": n}
                  for k, t, n in rows[:8]],
          "card": card})
    del cache
    if not rows:
        fail(f"{phase}: torch.profiler recorded no device time")
    return device_ms


def _param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def _forced_logits(torch, model, prompt, toks):
    """Teacher-forced f32 logits at the positions that emitted ``toks``:
    one forward of prompt + toks over a FRESH cache of its own length —
    the one-shot prefill, which attends the exact (never quantized) k/v
    through K1 — and the lm_head on those rows only."""
    from k8s_tpu_torch.models import KVCache

    ids = torch.tensor([prompt + toks], dtype=torch.long, device="cuda")
    cache = KVCache.zeros(model.config, 1, ids.shape[1], "cuda")
    hidden, _ = model(ids, positions=torch.arange(ids.shape[1], device="cuda")[None],
                      cache=cache, return_hidden=True)
    del cache
    n = len(prompt)
    return model.lm_head_logits(hidden[0, n - 1:n - 1 + len(toks)])


def phase_serving_int8(torch, attn, card):
    """Llama-3-8B with int8 weights and an int8 KV cache through the
    engine and a real HTTP front-end (the wiring of
    programs.serving.main with --quant=int8_serving --kv_quant=int8):
    16 slots x 8192 rows, 16 concurrent requests of 12..6000 prompt
    tokens; every emitted token against a teacher-forced forward of the
    same int8 model; then the same forwards through the bf16 model of
    the same seed, for information."""
    from k8s_tpu_torch.models import LlamaForCausalLM
    from k8s_tpu_torch.programs.llama_generate import (
        decode_model_config, load_decode_params)
    from k8s_tpu_torch.serving import ContinuousBatchingEngine, ServingFrontend

    max_seq, slots, new_tokens = 8192, 16, 32
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = decode_model_config("llama3-8b", max_seq, {"kv_quant": "int8"}, ragged=True)
    model = load_decode_params(cfg, "", seed=0, device="cuda", quant="int8_serving")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = model.config
    weight_bytes = _param_bytes(model)
    bf16_cfg = dataclasses.replace(cfg, quant="none", kv_quant="none")
    bf16_weight_bytes = _param_bytes(LlamaForCausalLM(bf16_cfg, device="meta"))
    buckets = [b for b in (16, 32, 64, 128, 256, 512, 1024, 2048, 4096) if b < max_seq]
    engine = ContinuousBatchingEngine(
        model, max_slots=slots, decode_chunk=32, prompt_buckets=buckets,
        prefill_chunk=256)
    kv = engine._cache
    kv_bytes = sum(t.numel() * t.element_size() for t in
                   kv.keys + kv.values + kv.key_scales + kv.value_scales)
    bf16_kv_bytes = 2 * sum(t.numel() * 2 for t in kv.keys)
    frontend = ServingFrontend(engine, port=0)
    stop = threading.Event()
    pump = threading.Thread(target=frontend.serve, args=(stop.is_set,))
    pump.start()
    rng = np.random.RandomState(1)
    lens = [12, 33, 64, 100, 150, 200, 256, 300, 400, 512, 800, 1000, 1500,
            2500, 4000, 6000]
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in lens]
    results = [None] * len(prompts)
    try:
        post(frontend.port, {"prompt": prompts[0][:20], "max_new_tokens": 4})  # warm-up
        stats0 = dict(engine.stats)
        attn.flash_fwd.launches = 0
        attn.decode_attention_update.launches = 0
        attn.decode_attention_update_q8.launches = 0

        def client(i):
            results[i] = post(frontend.port, {"prompt": prompts[i],
                                              "max_new_tokens": new_tokens})

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t1
        launches = {"flash_fwd": attn.flash_fwd.launches,
                    "decode_attn": attn.decode_attention_update.launches,
                    "decode_attn_q8": attn.decode_attention_update_q8.launches}
    finally:
        stop.set()
        pump.join(timeout=300)
    if pump.is_alive() or any(r is None for r in results):
        fail("serving_int8: a request or the pump did not finish")
    if launches["decode_attn_q8"] <= 0 or launches["flash_fwd"] <= 0:
        fail(f"serving_int8: a kernel of the path never launched: {launches}")
    if launches["decode_attn"] != 0:
        fail(f"serving_int8: the bf16 decode kernel ran over the int8 cache: {launches}")
    serve_peak = torch.cuda.max_memory_allocated()
    stats = {k: v - stats0.get(k, 0) for k, v in engine.stats.items()
             if k != "queue_depth"}
    del engine, frontend, kv
    gc.collect()
    torch.cuda.empty_cache()

    # oracle: teacher-forced forwards of the same int8 model whose
    # one-shot prefill attends exact k/v; the served tokens saw the int8
    # cache (K5 steps, dequantized continuation chunks). Planted faults,
    # judged as the oracle judges the served tokens (the worst gap over
    # every token): each request's tokens scored one step early (a
    # decode off by one), and scored against the next request's logits
    # (a decode that reads another slot)
    def gap(logits, toks):
        tok_t = torch.tensor(toks, device="cuda")
        return logits.max(-1).values - logits.gather(1, tok_t[:, None])[:, 0]

    toks_all = [r["tokens"] for r in results]
    gaps, exact, int8_logits = [], 0, []
    faults = {"off_by_one": [], "other_request": []}
    for i, (p, toks) in enumerate(zip(prompts, toks_all)):
        if len(toks) != new_tokens:
            fail(f"serving_int8: {len(toks)} tokens for a {new_tokens}-token request")
        logits = _forced_logits(torch, model, p, toks)
        if not torch.isfinite(logits).all():
            fail("serving_int8: non-finite logits in the oracle forward")
        gaps.append(gap(logits, toks).max().item())
        faults["off_by_one"].append(gap(logits[:-1], toks[1:]).max().item())
        faults["other_request"].append(
            gap(logits, toks_all[(i + 1) % len(toks_all)]).max().item())
        exact += int((logits.argmax(-1) == torch.tensor(toks, device="cuda")).sum().item())
        int8_logits.append(logits)
    worst = max(gaps)
    fault_worst = {k: max(v) for k, v in faults.items()}
    if worst > ORACLE_Q8_LOGIT_TOL or not min(fault_worst.values()) > ORACLE_Q8_LOGIT_TOL:
        fail(f"serving_int8 oracle: emitted-token gap {worst} (tol "
             f"{ORACLE_Q8_LOGIT_TOL}, per request {gaps}); each planted fault's "
             f"worst gap must exceed it: {faults}")
    depths = [12, 300, 700, 1000, 1500, 2000, 2500, 3000, 3500, 4000, 5000,
              6000, 7000, 8000, 40, 97]
    step_device_ms = phase_decode_profile(torch, model, card, depths,
                                          phase="decode_profile_int8")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # information only: the bf16 model of the same seed, same forwards
    model = load_decode_params(bf16_cfg, "", seed=0, device="cuda")
    diffs, agree, bf16_gaps = [], 0, []
    for p, toks, l8 in zip(prompts, toks_all, int8_logits):
        lb = _forced_logits(torch, model, p, toks)
        diffs.append((lb - l8).abs().max().item())
        agree += int((lb.argmax(-1) == l8.argmax(-1)).sum().item())
        bf16_gaps.append(gap(lb, toks).max().item())
    del model, int8_logits
    gc.collect()
    torch.cuda.empty_cache()

    n_tok = new_tokens * len(prompts)
    ttfts = sorted(r["ttft_s"] for r in results)
    emit({
        "phase": "serving_int8", "model": "llama3_8b", "layers": cfg.num_layers,
        "vocab": cfg.vocab_size, "quant": cfg.quant, "kv_quant": cfg.kv_quant,
        "max_seq_len": max_seq, "max_slots": slots, "decode_chunk": 32,
        "prefill_chunk": 256, "requests": len(prompts), "prompt_lens": lens,
        "new_tokens": new_tokens, "load_s": load_s, "wall_s": wall,
        "tokens_per_s": n_tok / wall,
        "decode_tokens_per_s": (n_tok - len(prompts)) / stats["chunk_s"],
        "decode_step_ms": 1e3 * stats["chunk_s"] / stats["decode_steps"],
        "decode_step_device_ms": step_device_ms,
        "ttft_p50_s": float(np.median(ttfts)), "ttft_max_s": ttfts[-1],
        "weight_bytes": weight_bytes, "bf16_weight_bytes": bf16_weight_bytes,
        "kv_bytes": kv_bytes, "bf16_kv_bytes": bf16_kv_bytes,
        "load_peak_gb": load_peak / 1e9, "serve_peak_gb": serve_peak / 1e9,
        "oracle_max_gap": worst, "oracle_tol": ORACLE_Q8_LOGIT_TOL,
        "oracle_exact_share": exact / n_tok,
        "planted_faults_worst_gap": fault_worst,
        "planted_faults_per_request": faults,
        "int8_vs_bf16": {"max_abs_logit_diff": max(diffs),
                         "top1_agreement": agree / n_tok,
                         "bf16_gap_of_int8_tokens_max": max(bf16_gaps)},
        "launches": launches, "engine_stats": stats, "card": card,
    })
    return launches


def _oracle_grads(torch, attn, model, ids):
    """Gradients of the next-token loss (z-loss 1e-4) through this
    script's own forward over ``model``'s parameters: plain attention
    (mha_reference, f32 softmax), bf16 projections, an unfused f32 head
    — no kernel, no fused CE, no remat."""
    import torch.nn.functional as F

    cfg = model.config
    P = dict(model.named_parameters())
    bf = cfg.dtype
    b, s = ids.shape
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pos = torch.arange(s, device=ids.device, dtype=torch.float32)
    freqs = 1.0 / (cfg.rope_theta ** (torch.arange(0, d, 2, device=ids.device,
                                                   dtype=torch.float32) / d))
    ang = pos[:, None] * freqs
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]

    def rope(x):
        x1, x2 = x.float().chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)

    def norm(x, w):
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + cfg.rms_eps)
        return (y * w).to(x.dtype)

    x = F.embedding(ids, P["embed_tokens"]).to(bf)
    for i in range(cfg.num_layers):
        L = lambda n: P[f"layers.{i}.{n}"]  # noqa: E731
        y = norm(x, L("input_norm.weight"))
        q = rope((y @ L("attn.q_proj").to(bf)).view(b, s, h, d))
        k = rope((y @ L("attn.k_proj").to(bf)).view(b, s, kv, d))
        v = (y @ L("attn.v_proj").to(bf)).view(b, s, kv, d)
        a = attn.mha_reference(q, k, v, causal=True)
        x = x + a.reshape(b, s, h * d) @ L("attn.o_proj").to(bf)
        y = norm(x, L("post_attn_norm.weight"))
        m = F.silu(y @ L("mlp.gate_proj").to(bf)) * (y @ L("mlp.up_proj").to(bf))
        x = x + m @ L("mlp.down_proj").to(bf)
    x = norm(x, P["final_norm.weight"])
    logits = x[:, :-1].float() @ P["lm_head"]
    logz = torch.logsumexp(logits, -1)
    picked = logits.gather(-1, ids[:, 1:, None].long())[..., 0]
    loss = (logz - picked + 1e-4 * logz.square()).mean()
    del logits
    names = list(P)
    grads = torch.autograd.grad(loss, [P[n] for n in names])
    return loss.detach(), dict(zip(names, grads))


def phase_train(torch, attn, card):
    """The training path: programs.llama_train.main at Llama-3-8B width,
    8 layers, seq 2048, batch 8, flash remat, fused CE, lr 3e-4,
    learnable data, 10 steps; then a gradient oracle and one profiled
    step."""
    from k8s_tpu_torch.data import learnable_token_batches
    from k8s_tpu_torch.models import LlamaConfig, LlamaForCausalLM, init_params
    from k8s_tpu_torch.programs import llama_train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    layers, steps = TRAIN_LAYERS, TRAIN_STEPS
    rdzv = types.SimpleNamespace(process_id=0, program_args=(
        f"--model=llama3-8b --layers={layers} --seq_len={TRAIN_SEQ} "
        f"--batch_size={TRAIN_BATCH} --steps={steps} --log_every=1 "
        "--remat_policy=flash --fused_ce=1 --lr=3e-4 --data=learnable "
        "--device=cuda"))
    attn.flash_fwd.launches = 0
    attn.flash_bwd.launches_dq = attn.flash_bwd.launches_dkv = 0
    t0 = time.perf_counter()
    run = llama_train.main(rdzv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": attn.flash_fwd.launches,
                "flash_bwd_dq": attn.flash_bwd.launches_dq,
                "flash_bwd_dkv": attn.flash_bwd.launches_dkv}
    peak = torch.cuda.max_memory_allocated()
    want = layers * steps
    if set(launches.values()) != {want}:
        fail(f"train: kernel launches {launches}, expected {want} each "
             "(flash remat must not re-run K1)")
    ratio = run.get("ratio")
    if not (ratio is not None and np.isfinite(run["final_loss"]) and ratio < 1.0):
        fail(f"train: loss did not fall: first {run.get('first_loss')} "
             f"final {run.get('final_loss')}")
    state = run["state"]
    n_params = sum(p.numel() for p in state.model.parameters())
    step_ms = 1e3 * statistics.median(run["step_s"][2:])
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    profile = _profile_train_step(torch, run)
    emit({"phase": "train", "model": "llama3_8b", "layers": layers,
          "seq_len": TRAIN_SEQ, "batch": TRAIN_BATCH, "steps": steps,
          "remat_policy": "flash", "fused_ce": True, "lr": 3e-4,
          "n_params": n_params, "first_loss": run["first_loss"],
          "final_loss": run["final_loss"], "convergence_ratio": ratio,
          "step_ms_median_3_10": step_ms,
          "step_ms": [1e3 * t for t in run["step_s"]],
          "tokens_per_s": tokens_per_s,
          "mfu_6nd": 6 * n_params * tokens_per_s / PEAK_BF16_FLOPS,
          "peak_mem_gb": peak / 1e9, "wall_s": wall, "launches": launches,
          "profiled_step": profile, "card": card})
    del run, state
    torch.cuda.empty_cache()

    # gradient oracle: one step's gradients at batch 1, 2 layers, same
    # width, against this script's own forward through plain attention
    cfg = LlamaConfig.llama3_8b(num_layers=2, remat=True, remat_policy="flash")
    model = LlamaForCausalLM(cfg, device="cuda")
    model.load_params(init_params(cfg, 1, "cuda", dtype=torch.float32))
    ids = torch.from_numpy(next(learnable_token_batches(1, TRAIN_SEQ, cfg.vocab_size, seed=1))
                           ["input_ids"]).cuda()
    n0 = (attn.flash_fwd.launches, attn.flash_bwd.launches_dq, attn.flash_bwd.launches_dkv)
    loss = llama_train.lm_loss(model, ids, fused_ce=True)
    loss.backward()
    if (attn.flash_fwd.launches - n0[0], attn.flash_bwd.launches_dq - n0[1],
            attn.flash_bwd.launches_dkv - n0[2]) != (2, 2, 2):
        fail("train oracle: the port's step did not run K1-K3 once per layer")
    port = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    n1 = (attn.flash_fwd.launches, attn.flash_bwd.launches_dq)
    ref_loss, ref = _oracle_grads(torch, attn, model, ids)
    if (attn.flash_fwd.launches, attn.flash_bwd.launches_dq) != n1:
        fail("train oracle: a kernel launched on the oracle's plain path")
    errs = {}
    for n, g in port.items():
        if not torch.isfinite(g).all():
            fail(f"train oracle: non-finite gradient of {n}")
        r = ref[n].float()
        errs[n] = ((g.float() - r).norm() / r.norm().clamp_min(1e-30)).item()
    worst = max(errs, key=errs.get)
    if errs[worst] > GRAD_ORACLE_TOL:
        fail(f"train oracle: gradient of {worst} off by {errs[worst]} "
             f"(tol {GRAD_ORACLE_TOL}); all: {errs}")
    emit({"phase": "train_grad_oracle", "layers": 2, "batch": 1, "seq_len": TRAIN_SEQ,
          "loss": loss.item(), "oracle_loss": ref_loss.item(),
          "tol": GRAD_ORACLE_TOL, "worst_param": worst, "worst_rel_l2": errs[worst],
          "median_rel_l2": statistics.median(errs.values()),
          "rel_l2": {n: round(e, 6) for n, e in errs.items()
                     if n.startswith(("embed", "lm_head", "final", "layers.1."))},
          "card": card})
    del model, port, ref
    torch.cuda.empty_cache()
    return launches


def _profile_train_step(torch, run):
    """One more train step under torch.profiler: device time by kernel
    class (GEMMs outside the loss, K1, K2, K3, the fused CE, the
    optimizer, the rest) and the device's busy share of the step."""
    from torch.profiler import ProfilerActivity, profile

    state, step_fn, batch = run["state"], run["step_fn"], run["next_batch"]()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def is_gemm(name):
        n = name.lower()
        return any(t in n for t in ("gemm", "nvjet", "xmma", "cutlass", "cublas"))

    # record_function ranges also appear on the device timeline (as
    # user annotations spanning their kernels): not kernels, skip them
    ranges = {e.name for e in prof.events()
              if getattr(e, "is_user_annotation", False)}
    ranges |= {"fused_ce_fwd", "fused_ce_bwd"}
    kernels = [(e.key, e.self_device_time_total / 1e3)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and e.key not in ranges and not e.key.startswith("Optimizer.")]
    total = sum(t for _, t in kernels)
    split = {"gemm": 0.0, "k1": 0.0, "k2": 0.0, "k3": 0.0, "other": 0.0}
    for name, t in kernels:
        key = ("k1" if "flash_fwd_kernel" in name else
               "k2" if "flash_bwd_dq_kernel" in name else
               "k3" if "flash_bwd_dkv_kernel" in name else
               "gemm" if is_gemm(name) else "other")
        split[key] += t

    def range_ms(prefix):
        """Device time of the kernels launched inside the record_function
        ranges whose name starts with ``prefix`` (and of their GEMMs)."""
        t_all = t_gemm = 0.0
        seen = set()

        def walk(ev):
            nonlocal t_all, t_gemm
            if id(ev) in seen:
                return
            seen.add(id(ev))
            for k in getattr(ev, "kernels", []):
                t_all += k.duration / 1e3
                if is_gemm(k.name):
                    t_gemm += k.duration / 1e3
            for ch in ev.cpu_children:
                walk(ch)

        for ev in prof.events():
            if ev.name.startswith(prefix) and ev.device_type == torch.autograd.DeviceType.CPU:
                walk(ev)
        return t_all, t_gemm

    ce_f, ce_fg = range_ms("fused_ce_fwd")
    ce_b, ce_bg = range_ms("fused_ce_bwd")
    opt, _ = range_ms("Optimizer.step")
    split["fused_ce"] = ce_f + ce_b
    split["gemm_outside_ce"] = split["gemm"] - ce_fg - ce_bg
    split["optimizer"] = opt
    top = sorted(kernels, key=lambda r: -r[1])
    top_other = [r for r in top if not is_gemm(r[0]) and "flash_" not in r[0]]

    # cross-checks with CUDA events, outside the profiler: the optimizer
    # step alone, and the fused CE forward + backward alone
    from k8s_tpu_torch.ops.fused_ce import fused_lm_head_cross_entropy

    def events_ms(fn):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    model, ids = state.model, batch["input_ids"]
    with torch.no_grad():
        hidden = model(ids, return_hidden=True)[:, :-1].detach()
    hidden.requires_grad_()

    def ce_step():
        loss = fused_lm_head_cross_entropy(hidden, model.lm_head, ids[:, 1:], z_loss=1e-4)
        loss.backward()

    ce_step()
    checks = {"fused_ce_fwd_bwd_ms": events_ms(ce_step),
              "optimizer_step_ms": events_ms(state.optimizer.step)}
    del hidden
    state.optimizer.zero_grad(set_to_none=True)
    return {"step_wall_ms": wall_ms, "device_ms": total,
            "device_busy_share": total / wall_ms if wall_ms else None,
            "split_ms": split, "cuda_event_checks": checks,
            "annotation_ranges": sorted(ranges),
            "top": [{"kernel": k[:120], "ms": t} for k, t in top[:10]],
            "top_other": [{"kernel": k[:160], "ms": t} for k, t in top_other[:15]]}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device visible to torch")
    try:
        from k8s_tpu_torch.ops import _kernels
        from k8s_tpu_torch.ops import attention as attn
    except ImportError as e:
        fail(f"k8s_tpu_torch is not importable next to this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(card, flush=True)
    emit({"device": {"torch_name": name, "count": count, "nvidia_smi": card,
                     "torch": torch.__version__, "cuda": torch.version.cuda}})

    t0 = time.perf_counter()
    paths = _kernels.build_all()
    for lib in paths:
        _kernels.lib(lib)
    ptxas = {n: [ln.strip() for ln in _kernels.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in paths}
    emit({"build": {"seconds": time.perf_counter() - t0,
                    "libs": [str(p.name) for p in paths.values()],
                    "ptxas": ptxas}})

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    k1 = phase_flash(torch, attn, _kernels, gen)
    bwd = phase_flash_bwd(torch, attn, _kernels, gen)
    k4 = phase_decode(torch, attn, _kernels, gen)
    k5 = phase_decode_q8(torch, attn, _kernels, gen)
    serving = phase_serving(torch, attn, card)
    train = phase_train(torch, attn, card)
    serving_int8 = phase_serving_int8(torch, attn, card)
    launches = {"flash_fwd": serving["flash_fwd"] + train["flash_fwd"]
                + serving_int8["flash_fwd"],
                "decode_attn": serving["decode_attn"],
                "decode_attn_q8": serving_int8["decode_attn_q8"],
                "flash_bwd_dq": train["flash_bwd_dq"],
                "flash_bwd_dkv": train["flash_bwd_dkv"]}

    def entry(name, src, replaces, row):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "launches_serving": serving.get(name, 0),
                "launches_train": train.get(name, 0),
                "launches_serving_int8": serving_int8.get(name, 0),
                "max_abs_err": row["max_abs_err"], "rel_err": row["rel_err"],
                "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "card": card}

    emit({"kernels": [
        dict(entry("flash_fwd", "k8s_tpu_torch/csrc/flash_fwd.cu",
                   "k8s_tpu/ops/attention.py:185", k1),
             shape="B=1 S=256 Hq=32 Hkv=8 D=128 causal (errors: worst over B=1 S in "
                   "16..2048, B=8 S=2048 and the B=2 edges)",
             train_shape_ms=k1["train"]["ms"],
             train_shape_bound_ms=k1["train"]["bound_ms"],
             train_shape_library_ms=k1["train"]["library_ms"],
             train_shape_tflops=k1["train"]["tflops"]),
        entry("flash_bwd_dq", "k8s_tpu_torch/csrc/flash_bwd.cu",
              "k8s_tpu/ops/attention.py:354", bwd["flash_bwd_dq"])
        | {"shape": bwd["flash_bwd_dq"]["shape"],
           "note": "plain_ms and library_ms compute dq, dk and dv together"},
        entry("flash_bwd_dkv", "k8s_tpu_torch/csrc/flash_bwd.cu",
              "k8s_tpu/ops/attention.py:414", bwd["flash_bwd_dkv"])
        | {"shape": bwd["flash_bwd_dkv"]["shape"],
           "note": "plain_ms and library_ms compute dq, dk and dv together"},
        dict(entry("decode_attn", "k8s_tpu_torch/csrc/decode_attn.cu",
                   "k8s_tpu/ops/attention.py:875", k4),
             shape="B=8 S=2048 Hq=32 Hkv=8 D=128 ragged pos",
             split_rows=k4["split_rows"], kernel_ms=k4["kernel_ms"]),
        dict(entry("decode_attn_q8", "k8s_tpu_torch/csrc/decode_attn_q8.cu",
                   "k8s_tpu/ops/attention.py:1012", k5),
             shape="B=16 S=8192 Hq=32 Hkv=8 D=128 int8 cache, ragged pos",
             k4_same_pos_ms=k5["k4_same_pos_ms"],
             k4_same_pos_bound_ms=k5["k4_same_pos_bound_ms"],
             k4_same_pos_library_ms=k5["k4_same_pos_library_ms"],
             k4_same_pos_plain_ms=k5["k4_same_pos_plain_ms"],
             split_rows=k5["split_rows"], kernel_ms=k5["kernel_ms"],
             note="library_ms: SDPA over the cache dequantized to bf16 "
                  "(dequantization not timed)"),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}})


if __name__ == "__main__":
    main()
