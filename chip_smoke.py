#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``k8s_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``k8s_tpu_torch/csrc/``, holds
each one against its plain PyTorch version at the serving and training
paths' shapes (error, kernel / plain / library times and the kernel's
roofline bound), then drives the port's two main paths:

- serving: Llama-3-8B at full width and depth (random bf16 weights from
  a fixed seed) through the continuous-batching engine behind a real
  HTTP front-end, every emitted token checked against a teacher-forced
  forward;
- training: ``programs.llama_train.main`` at Llama-3-8B width cut to 8
  layers (seq 2048, batch 8, ``flash`` remat, fused CE, f32 AdamW) for
  10 steps on learnable data, the loss required to fall; a gradient
  oracle (2 layers, batch 1) against a forward of its own through plain
  attention; step time, tokens/s, MFU, peak memory and one profiled
  step's device-time split.

Each path runs with the launch counts set to 0 just before it and read
just after, and fails unless every kernel of the path launched. Every
phase must pass; the script exits non-zero at the first failure and
prints its result lines only on success. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It needs no network and leaves no process behind.
"""

from __future__ import annotations

import gc
import json
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
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH = 8, 10, 2048, 8


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def device_ms(torch, fn, reps: int = 10) -> float:
    """Device time per call: the device-side events (kernels, memcpy,
    memset) that torch.profiler records over ``reps`` calls, summed."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if total_us <= 0:
        fail("torch.profiler recorded no device time")
    return total_us / 1e3 / reps


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
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {n: 0.0 for n in names}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
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


def row_rel_err(out, ref, floor: float = 0.0) -> float:
    """Largest error of a row (the last axis): ||out - ref|| / ||ref||,
    with ||ref|| raised to ``floor`` times the largest row norm."""
    ref = ref.float()
    diff = (out.float() - ref).norm(dim=-1)
    norms = ref.norm(dim=-1)
    denom = norms.clamp_min(max(floor * norms.max().item(), 1e-30))
    return (diff / denom).max().item()


def sdpa(torch, q, k, v, **kw):
    """One PyTorch SDPA call as the library yardstick ([B, H, S, D])."""
    F = torch.nn.functional
    return lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)


def phase_flash(torch, attn, gen):
    """K1 against its plain version: B=1, Hq 32, Hkv 8, D 128, causal."""
    b, hq, hkv, d = 1, 32, 8, 128
    scale = 1.0 / d ** 0.5
    rows, worst, worst_rel, headline, faults = [], 0.0, 0.0, None, {}
    for s in (16, 100, 256, 2048):
        q = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        out, lse = attn.flash_fwd(q, k, v, True, scale, with_lse=True)
        ref, ref_lse = attn.flash_fwd_plain(q.float(), k.float(), v.float(), True, scale)
        torch.cuda.synchronize()
        err = row_rel_err(out, ref)
        abs_err = (out.float() - ref).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        if not (err <= FLASH_REL_TOL and lse_err <= FLASH_LSE_TOL):
            fail(f"flash_fwd S={s}: row error {err} (tol {FLASH_REL_TOL}), "
                 f"lse err {lse_err} (tol {FLASH_LSE_TOL})")
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
        kernel = lambda: attn.flash_fwd(q, k, v, True, scale)  # noqa: E731
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        library = sdpa(torch, qt, kt, vt, is_causal=True)
        nbytes = 2 * (2 * b * s * hq * d + 2 * b * s * hkv * d)
        flops = 4 * b * hq * d * s * (s + 1) / 2  # visible causal pairs
        bound_ms, by = bound(nbytes, flops)
        row = {"S": s, "rel_err": err, "max_abs_err": abs_err, "lse_err": lse_err,
               "ms": device_ms(torch, kernel),
               "plain_ms": device_ms(torch, lambda: attn.flash_fwd_plain(q, k, v, True, scale), reps=3),
               "library_ms": device_ms(torch, library),
               "bound_ms": bound_ms, "bound_by": by,
               "call_ms": call_ms(torch, kernel),
               "library_call_ms": call_ms(torch, library)}
        rows.append(row)
        worst, worst_rel = max(worst, abs_err), max(worst_rel, err)
        if s == 256:
            headline = row
    emit({"phase": "flash_fwd", "shape": "B=1 Hq=32 Hkv=8 D=128 causal bf16",
          "rel_tol": FLASH_REL_TOL, "lse_tol": FLASH_LSE_TOL,
          "planted_faults_S2048": faults, "rows": rows})
    return dict(headline, max_abs_err=worst, rel_err=worst_rel)


def phase_flash_bwd(torch, attn, gen):
    """K2 and K3 against their plain version in f32: B=2, Hq 32, Hkv 8,
    D 128, causal at S 128, 1000 (ragged tail) and 2048, and non-causal
    at S 777; then K1, K2, K3, the plain backward and SDPA's backward
    timed at the training shape (B=8, S=2048, causal)."""
    b, hq, hkv, d = 2, 32, 8, 128
    scale = 1.0 / d ** 0.5
    rnd = lambda *sh: torch.randn(sh, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
    rows, faults = [], {}
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    worst_abs = {"dq": 0.0, "dkv": 0.0}
    for s, causal in ((128, True), (1000, True), (2048, True), (777, False)):
        q, k, v, do = rnd(b, s, hq, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d), rnd(b, s, hq, d)
        out, lse = attn.flash_fwd(q, k, v, causal, scale, with_lse=True)
        got = attn.flash_bwd(q, k, v, out, lse, do, causal, scale)
        ref = attn.flash_bwd_plain(q.float(), k.float(), v.float(), out.float(),
                                   lse, do.float(), causal, scale)
        torch.cuda.synchronize()
        row = {"S": s, "causal": causal}
        for name, x, r in zip(("dq", "dk", "dv"), got, ref):
            row[name + "_rel_err"] = row_rel_err(x, r, floor=FLASH_BWD_ROW_FLOOR)
            row[name + "_max_abs_err"] = (x.float() - r).abs().max().item()
            worst[name] = max(worst[name], row[name + "_rel_err"])
        worst_abs["dq"] = max(worst_abs["dq"], row["dq_max_abs_err"])
        worst_abs["dkv"] = max(worst_abs["dkv"], row["dk_max_abs_err"],
                               row["dv_max_abs_err"])
        if max(row[n + "_rel_err"] for n in ("dq", "dk", "dv")) > FLASH_BWD_REL_TOL:
            fail(f"flash_bwd S={s} causal={causal}: {row} (tol {FLASH_BWD_REL_TOL})")
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
        rows.append(row)
        del q, k, v, do, out, lse, got, ref

    # the training shape: one layer's attention, B 8, S 2048, causal
    b, s = TRAIN_BATCH, TRAIN_SEQ
    q, k, v, do = rnd(b, s, hq, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d), rnd(b, s, hq, d)
    out, lse = attn.flash_fwd(q, k, v, True, scale, with_lse=True)
    names = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
    t_fwd = kernel_ms(torch, lambda: attn.flash_fwd(q, k, v, True, scale, with_lse=True), names[:1])
    t_bwd = kernel_ms(torch, lambda: attn.flash_bwd(q, k, v, out, lse, do, True, scale), names[1:])
    bwd_ms = device_ms(torch, lambda: attn.flash_bwd(q, k, v, out, lse, do, True, scale))
    plain_ms = device_ms(torch, lambda: attn.flash_bwd_plain(q, k, v, out, lse, do, True, scale), reps=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    o_sdpa = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    library_ms = device_ms(torch, lambda: torch.autograd.grad(
        o_sdpa, (qt, kt, vt), dot, retain_graph=True))
    library_fwd_ms = device_ms(torch, sdpa(torch, qt.detach(), kt.detach(), vt.detach(), is_causal=True))
    pairs = s * (s + 1) / 2  # visible causal (query, key) pairs per head
    qo_bytes = 2 * b * s * hq * d           # one bf16 [B, S, Hq, D] tensor
    kv_bytes = 2 * b * s * hkv * d          # one bf16 [B, S, Hkv, D] tensor
    row_bytes = 4 * b * hq * s              # one f32 [B, Hq, S] row tensor
    k1 = bound(2 * qo_bytes + 2 * kv_bytes + row_bytes, 4 * b * hq * d * pairs)
    k2 = bound(3 * qo_bytes + 2 * kv_bytes + 2 * row_bytes, 6 * b * hq * d * pairs)
    k3 = bound(2 * qo_bytes + 4 * kv_bytes + 2 * row_bytes, 8 * b * hq * d * pairs)
    train = {
        "shape": f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} causal bf16",
        "k1_ms": t_fwd[names[0]], "k1_bound_ms": k1[0], "k1_bound_by": k1[1],
        "k1_library_ms": library_fwd_ms,
        "k2_ms": t_bwd[names[1]], "k2_bound_ms": k2[0], "k2_bound_by": k2[1],
        "k3_ms": t_bwd[names[2]], "k3_bound_ms": k3[0], "k3_bound_by": k3[1],
        "flash_bwd_ms": bwd_ms, "plain_bwd_ms": plain_ms,
        "sdpa_bwd_ms": library_ms}
    emit({"phase": "flash_bwd", "shape": "B=2 Hq=32 Hkv=8 D=128 bf16",
          "rel_tol": FLASH_BWD_REL_TOL, "row_floor": FLASH_BWD_ROW_FLOOR,
          "planted_faults_S2048": faults, "rows": rows, "train_shape": train})
    del q, k, v, do, out, lse, qt, kt, vt, o_sdpa, dot
    torch.cuda.empty_cache()
    common = {"shape": train["shape"] + " (errors: worst over B=2 S 128,1000,2048 causal, 777 non-causal)",
              "plain_ms": plain_ms, "library_ms": library_ms}
    return {
        "flash_bwd_dq": dict(common, max_abs_err=worst_abs["dq"], rel_err=worst["dq"],
                             ms=train["k2_ms"], bound_ms=k2[0], bound_by=k2[1]),
        "flash_bwd_dkv": dict(common, max_abs_err=worst_abs["dkv"],
                              rel_err=max(worst["dk"], worst["dv"]),
                              ms=train["k3_ms"], bound_ms=k3[0], bound_by=k3[1]),
        "k1_train": {"ms": train["k1_ms"], "bound_ms": k1[0], "library_ms": library_fwd_ms},
    }


def phase_decode(torch, attn, gen):
    """K4 against its plain version: B=8 slots, S=2048, Hq 32, Hkv 8."""
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
    row = {"rel_err": err, "max_abs_err": abs_err, "cache_rows_ok": cache_ok,
           "planted_faults": faults,
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
    phase_decode_profile(torch, model, card)
    # free the serving model (16 GB) and its caches before training
    del engine, frontend, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_decode_profile(torch, model, card):
    """Where one batch-8 decode step's time goes: torch.profiler over a
    few steps at the serving shapes (device busy share, top kernels)."""
    from torch.profiler import ProfilerActivity, profile

    b, steps = 8, 4
    cache = model.new_cache(b)
    cache.fresh = False
    tok = torch.zeros((b, 1), dtype=torch.int32, device="cuda")
    pos = torch.tensor([[12], [300], [700], [1000], [1500], [2000], [40], [97]],
                       dtype=torch.int32, device="cuda")
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
    emit({"phase": "decode_profile", "batch": b, "steps": steps,
          "step_wall_ms": wall_ms,
          "step_device_ms": device_ms if rows else None,
          "device_busy_share": device_ms / wall_ms if rows else None,
          "device_ops_per_step": sum(r[2] for r in rows),
          "top": [{"op": k, "ms_per_step": t, "calls_per_step": n}
                  for k, t, n in rows[:8]],
          "card": card})


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
    k1 = phase_flash(torch, attn, gen)
    bwd = phase_flash_bwd(torch, attn, gen)
    k4 = phase_decode(torch, attn, gen)
    serving = phase_serving(torch, attn, card)
    train = phase_train(torch, attn, card)
    launches = {"flash_fwd": serving["flash_fwd"] + train["flash_fwd"],
                "decode_attn": serving["decode_attn"],
                "flash_bwd_dq": train["flash_bwd_dq"],
                "flash_bwd_dkv": train["flash_bwd_dkv"]}

    def entry(name, src, replaces, row):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "launches_serving": serving.get(name, 0),
                "launches_train": train.get(name, 0),
                "max_abs_err": row["max_abs_err"], "rel_err": row["rel_err"],
                "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "card": card}

    emit({"kernels": [
        dict(entry("flash_fwd", "k8s_tpu_torch/csrc/flash_fwd.cu",
                   "k8s_tpu/ops/attention.py:185", k1),
             shape="B=1 S=256 Hq=32 Hkv=8 D=128 causal (errors: worst over S in 16,100,256,2048)",
             train_shape_ms=bwd["k1_train"]["ms"],
             train_shape_bound_ms=bwd["k1_train"]["bound_ms"],
             train_shape_library_ms=bwd["k1_train"]["library_ms"]),
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
             shape="B=8 S=2048 Hq=32 Hkv=8 D=128 ragged pos"),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}})


if __name__ == "__main__":
    main()
