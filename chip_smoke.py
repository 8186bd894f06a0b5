#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``k8s_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``k8s_tpu_torch/csrc/``, holds
each one against its plain PyTorch version at the serving path's
shapes (error, kernel / plain / library times and the kernel's
roofline bound), then serves Llama-3-8B at full width and depth
(random bf16 weights from a fixed seed) through the continuous-batching
engine behind a real HTTP front-end, checks every emitted token against
a teacher-forced forward, and reports how many times each kernel
launched while serving. Every phase must pass; the script exits
non-zero at the first failure and prints its result lines only on
success. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It needs no network and leaves no process behind.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
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


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row_rel_err(out, ref) -> float:
    """Largest error of a row (the last axis): ||out - ref|| / ||ref||."""
    ref = ref.float()
    diff = (out.float() - ref).norm(dim=-1)
    return (diff / ref.norm(dim=-1).clamp_min(1e-30)).max().item()


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
    k4 = phase_decode(torch, attn, gen)
    launches = phase_serving(torch, attn, card)

    def entry(name, src, replaces, row):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": row["max_abs_err"], "rel_err": row["rel_err"],
                "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "card": card}

    emit({"kernels": [
        dict(entry("flash_fwd", "k8s_tpu_torch/csrc/flash_fwd.cu",
                   "k8s_tpu/ops/attention.py:185", k1),
             shape="B=1 S=256 Hq=32 Hkv=8 D=128 causal (errors: worst over S in 16,100,256,2048)"),
        dict(entry("decode_attn", "k8s_tpu_torch/csrc/decode_attn.cu",
                   "k8s_tpu/ops/attention.py:875", k4),
             shape="B=8 S=2048 Hq=32 Hkv=8 D=128 ragged pos"),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}})


if __name__ == "__main__":
    main()
