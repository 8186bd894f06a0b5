#!/usr/bin/env python3
"""Look for launches of the port's flash kernels that disagree with
their other launches on the same inputs, on one NVIDIA card.

Builds the kernels once, then starts ``--children`` fresh processes,
``--parallel`` of them at a time, on card 0. Then ``--fresh`` more,
one at a time, each in a copy of the package (``k8s_tpu_torch/``,
``chip_smoke.py`` and this script) whose ``k8s_tpu_torch/build/`` is
empty: such a child builds every kernel library in-process with
``build_all`` and loads them before its first K1 launch, as
``chip_smoke.py`` does in a fresh checkout. Each child draws
chip_smoke.py's first K1 inputs (CUDA generator seeded 0; B 1, S 16,
Hq 32, Hkv 8, D 128, causal) after loading every kernel library, as
chip_smoke.py does, and holds the process's first K1 launch
against ``flash_fwd_plain`` at chip_smoke's tolerances. Then it calls K1
``--reps`` times at each shape of chip_smoke's B 1 sweep under both tile
configs, and K2/K3 (``flash_bwd``) at two shapes, each call synchronised
and required to be bit-identical to that child's first output of the
same shape (the kernels use no atomics), and each first output within
chip_smoke's tolerance of the plain version. A disagreement is
described by the query rows, heads and 64-row tiles it touches.

    python3 scripts/kernel_repeat_stress.py [--children 32] [--parallel 4] [--reps 1000]
        [--fresh 0] [--fresh_reps 100] [--poison N]

``--poison N`` (ROADMAP C4) runs instead ``--children`` children, each
making N rounds of launches with fresh inputs per launch (a seed per
launch: child, round and shape) and every SM's shared memory filled
with NaN words just before each K1, K2, K3 and K5 kernel launch
(``poison_shared_memory``, at the next kernel's own dynamic
shared-memory size; K5's, which also has static shared memory, at the
device's maximum). A round: K1 at B 1, S 16 in both tile configs and at
B 2, S 1000; the flash backward (K2 then K3) at B 2, S 1000; K5 at B 4,
S 2048. Each output is held against its plain version at chip_smoke.py's
limits (K1 8e-3, lse 1e-4; K2/K3 1e-2; K5 5e-3 and its appended rows and
scales bit-equal). A consumer reading a tile before its bytes land
would read NaN there and fail the check.

Prints one JSON line per child and a summary line (also written to
``chiprun_out/kernel_repeat_stress.json``); exits 1 if any launch
disagreed.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

HQ, HKV, D = 32, 8, 128
K1_SWEEP = (16, 100, 256, 512, 1024, 2048)
K23_SHAPES = ((2, 128), (2, 1000))


def describe(got, first):
    """Where ``got`` [B, S, H, D] differs from ``first``."""
    bad = (got != first).any(-1)  # [B, S, H]
    idx = bad.nonzero().tolist()
    return {"rows": len(idx),
            "heads": sorted({h for _, _, h in idx})[:40],
            "tiles64": sorted({s // 64 for _, s, _ in idx})[:40],
            "batches": sorted({b for b, _, _ in idx}),
            "max_abs_diff": (got.float() - first.float()).abs().max().item()}


def child(reps: int, build: bool = False) -> dict:
    import torch

    import chip_smoke as cs
    from k8s_tpu_torch.ops import _kernels
    from k8s_tpu_torch.ops import attention as attn

    built = None
    if build:  # a fresh copy: nothing built yet, the build runs here
        if _kernels.BUILD_DIR.exists() and any(_kernels.BUILD_DIR.glob("*.so")):
            raise SystemExit(f"{_kernels.BUILD_DIR} is not empty")
        t0 = time.perf_counter()
        _kernels.build_all()
        built = time.perf_counter() - t0
    for name in _kernels.KERNELS:  # every library loaded first, as chip_smoke.py does
        _kernels.lib(name)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rnd = lambda *sh: torch.randn(sh, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
    scale = 1.0 / D ** 0.5
    out = {"faults": [], "first_launch": None, "launches": 0, "build_s": built}

    def ref_err(o, lse, q, k, v):
        ref, ref_lse = attn.flash_fwd_plain(q.float(), k.float(), v.float(), True, scale)
        return {"rel_err": cs.row_rel_err(o, ref),
                "lse_err": (lse - ref_lse).abs().max().item()}

    def within(err):
        return err["rel_err"] <= cs.FLASH_REL_TOL and err["lse_err"] <= cs.FLASH_LSE_TOL

    for s in K1_SWEEP:
        q, k, v = rnd(1, s, HQ, D), rnd(1, s, HKV, D), rnd(1, s, HKV, D)
        for config in (1, 0):
            o0, l0 = attn.flash_fwd(q, k, v, True, scale, with_lse=True, config=config)
            torch.cuda.synchronize()
            out["launches"] += 1
            err = ref_err(o0, l0, q, k, v)
            if out["first_launch"] is None:
                out["first_launch"] = dict(err, S=s, config=config)
            if not within(err):
                out["faults"].append(dict(err, kernel="flash_fwd", S=s, config=config,
                                          rep=0, where="first output vs plain"))
            for rep in range(1, reps if s <= 256 else max(reps // 10, 2)):
                o, lse = attn.flash_fwd(q, k, v, True, scale, with_lse=True, config=config)
                torch.cuda.synchronize()
                out["launches"] += 1
                if not (torch.equal(o, o0) and torch.equal(lse, l0)):
                    out["faults"].append(dict(
                        describe(o, o0), kernel="flash_fwd", S=s, config=config,
                        rep=rep, lse_rows=int((lse != l0).sum().item()),
                        vs_plain=ref_err(o, lse, q, k, v)))
                    if len(out["faults"]) > 20:
                        return out

    for b, s in K23_SHAPES:
        q, k, v, do = rnd(b, s, HQ, D), rnd(b, s, HKV, D), rnd(b, s, HKV, D), rnd(b, s, HQ, D)
        o, lse = attn.flash_fwd(q, k, v, True, scale, with_lse=True)
        first = attn.flash_bwd(q, k, v, o, lse, do, True, scale)
        ref = attn.flash_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                   do.float(), True, scale)
        torch.cuda.synchronize()
        errs = {n: cs.row_rel_err(x, r, floor=cs.FLASH_BWD_ROW_FLOOR)
                for n, x, r in zip(("dq", "dk", "dv"), first, ref)}
        if max(errs.values()) > cs.FLASH_BWD_REL_TOL:
            out["faults"].append(dict(errs, kernel="flash_bwd", S=s, rep=0,
                                      where="first output vs plain"))
        for rep in range(1, max(reps // 10, 2)):
            got = attn.flash_bwd(q, k, v, o, lse, do, True, scale)
            torch.cuda.synchronize()
            out["launches"] += 2
            for n, x, x0 in zip(("dq", "dk", "dv"), got, first):
                if not torch.equal(x, x0):
                    out["faults"].append(dict(describe(x, x0), kernel="flash_bwd",
                                              output=n, S=s, rep=rep))
    return out


POISON_K1 = ((1, 16), (2, 1000))
POISON_BWD = (2, 1000)
POISON_K5 = (4, 2048)


def poison_child(rounds: int, child_index: int) -> dict:
    """``rounds`` rounds of K1/K2/K3/K5 launches, each kernel launch
    preceded by the shared-memory poison, every launch on fresh inputs,
    each output held against its plain version."""
    import torch

    import chip_smoke as cs
    from k8s_tpu_torch.ops import _kernels
    from k8s_tpu_torch.ops import attention as attn

    for name in _kernels.KERNELS:
        _kernels.lib(name)
    dev = torch.device("cuda")
    sizes = {"k8s_flash_bwd_dq_bf16": attn.flash_smem_bytes("dq"),
             "k8s_flash_bwd_dkv_bf16": attn.flash_smem_bytes("dkv")}
    launch, poisoned = attn._launch, {"n": 0}

    def with_poison(name, entry, device, *args):
        if name in ("flash_fwd", "flash_bwd", "decode_attn_q8"):
            if entry == "k8s_flash_fwd_bf16":
                size = attn.flash_smem_bytes("fwd", args[-1])
            else:
                size = sizes.get(entry)
            attn.poison_shared_memory(device, size)
            poisoned["n"] += 1
        return launch(name, entry, device, *args)

    attn._launch = with_poison
    out = {"faults": [], "launches": 0, "poisons": 0, "worst": {}}

    def note(kernel, err, limit, **where):
        out["worst"][kernel] = max(out["worst"].get(kernel, 0.0), err)
        if not err <= limit:
            out["faults"].append(dict(where, kernel=kernel, err=err, limit=limit))

    scale = 1.0 / D ** 0.5
    try:
        for r in range(rounds):
            seed = [child_index * 1_000_003 + r * 101]

            def rnd(*shape):
                seed[0] += 1
                gen = torch.Generator(device="cuda")
                gen.manual_seed(seed[0])
                return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

            for b, s in POISON_K1:
                for config in (1, 0):
                    q, k, v = rnd(b, s, HQ, D), rnd(b, s, HKV, D), rnd(b, s, HKV, D)
                    o, lse = attn.flash_fwd(q, k, v, True, scale, with_lse=True,
                                            config=config)
                    ref, ref_lse = attn.flash_fwd_plain(q.float(), k.float(), v.float(),
                                                        True, scale)
                    out["launches"] += 1
                    note("flash_fwd", cs.row_rel_err(o, ref), cs.FLASH_REL_TOL,
                         round=r, B=b, S=s, config=config)
                    note("flash_fwd_lse", (lse - ref_lse).abs().max().item(),
                         cs.FLASH_LSE_TOL, round=r, B=b, S=s, config=config)
            b, s = POISON_BWD
            q, k, v, do = rnd(b, s, HQ, D), rnd(b, s, HKV, D), rnd(b, s, HKV, D), \
                rnd(b, s, HQ, D)
            o, lse = attn.flash_fwd(q, k, v, True, scale, with_lse=True)
            got = attn.flash_bwd(q, k, v, o, lse, do, True, scale)
            ref = attn.flash_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                       do.float(), True, scale)
            out["launches"] += 3
            for n, x, want in zip(("dq", "dk", "dv"), got, ref):
                note(f"flash_bwd_{n}", cs.row_rel_err(x, want, floor=cs.FLASH_BWD_ROW_FLOOR),
                     cs.FLASH_BWD_REL_TOL, round=r, B=b, S=s)
            b, s = POISON_K5
            hq = HQ
            qd, kn, vn = rnd(b, hq, D), rnd(b, HKV, D), rnd(b, HKV, D)
            (kc, ks), (vc, vs) = (attn.quantize_kv_rows(rnd(b, HKV, s, D)),
                                  attn.quantize_kv_rows(rnd(b, HKV, s, D)))
            gen = torch.Generator(device="cuda")
            gen.manual_seed(seed[0] + 1)
            pos = torch.randint(0, s, (b,), generator=gen, device="cuda",
                                dtype=torch.int32)
            caches = [t.clone() for t in (kc, vc, ks, vs)]
            plain = [t.clone() for t in (kc, vc, ks, vs)]
            o = attn.decode_attention_update_q8(qd, kn, vn, *caches, pos, scale)[0]
            ref = attn.decode_attention_q8_plain(qd.float(), kn.float(), vn.float(),
                                                 *plain, pos, scale)
            out["launches"] += 1
            note("decode_attn_q8", cs.row_rel_err(o, ref), cs.DECODE_Q8_REL_TOL,
                 round=r, B=b, S=s)
            if not all(torch.equal(x, w) for x, w in zip(caches, plain)):
                out["faults"].append({"kernel": "decode_attn_q8", "round": r,
                                      "where": "appended rows or scales differ"})
            torch.cuda.synchronize()
            if len(out["faults"]) > 20:
                break
    finally:
        attn._launch = launch
    out["poisons"] = poisoned["n"]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--children", type=int, default=32)
    ap.add_argument("--parallel", type=int, default=4)
    ap.add_argument("--reps", type=int, default=1000)
    ap.add_argument("--fresh", type=int, default=0)
    ap.add_argument("--fresh_reps", type=int, default=100)
    ap.add_argument("--poison", type=int, default=0)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--child_index", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--build", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        res = (poison_child(args.poison, args.child_index) if args.poison
               else child(args.reps, args.build))
        print(json.dumps(res), flush=True)
        return

    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_repeat_stress: no CUDA device visible to torch")
    from k8s_tpu_torch.ops import _kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(card, flush=True)
    _kernels.build_all()
    t0 = time.perf_counter()
    results = []
    # (index, cwd, argv extra, parallel) per child: the built checkout's
    # children, then the fresh copies one at a time
    jobs = [(i, ROOT, ["--poison", str(args.poison), "--child_index", str(i)]
             if args.poison else ["--reps", str(args.reps)])
            for i in range(args.children)]
    fresh_root = tempfile.mkdtemp(prefix="kernel-stress-fresh-") if args.fresh else None
    try:
        for j in range(args.fresh):
            copy = pathlib.Path(fresh_root) / f"copy-{j}"
            shutil.copytree(ROOT / "k8s_tpu_torch", copy / "k8s_tpu_torch",
                            ignore=shutil.ignore_patterns("build", "__pycache__"))
            (copy / "scripts").mkdir()
            shutil.copy2(ROOT / "chip_smoke.py", copy / "chip_smoke.py")
            shutil.copy2(__file__, copy / "scripts" / "kernel_repeat_stress.py")
            jobs.append((args.children + j, copy,
                         ["--reps", str(args.fresh_reps), "--build"]))
        running, pending = [], list(jobs)
        while pending or running:
            while pending and len(running) < (
                    args.parallel if pending[0][0] < args.children else 1):
                i, cwd, extra = pending.pop(0)
                running.append((i, cwd, subprocess.Popen(
                    [sys.executable, str(pathlib.Path(cwd) / "scripts" /
                                         "kernel_repeat_stress.py"), "--child", *extra],
                    cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            i, cwd, proc = running.pop(0)
            try:
                so, se = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                so, se = proc.communicate()
            line = so.strip().splitlines()[-1] if so.strip() else ""
            try:
                res = json.loads(line)
            except json.JSONDecodeError:
                res = {"faults": [{"where": "child crashed", "rc": proc.returncode,
                                   "stderr": se[-2000:]}], "launches": 0}
            res["child"] = i
            res["fresh"] = cwd != ROOT
            print(json.dumps(res), flush=True)
            results.append(res)
    finally:
        if fresh_root:
            shutil.rmtree(fresh_root, ignore_errors=True)
    faults = sum(len(r["faults"]) for r in results)
    fresh = [r for r in results if r["fresh"]]
    summary = {"card": card, "children": args.children, "parallel": args.parallel,
               "reps": args.reps, "poison_rounds": args.poison,
               "poisons": sum(r.get("poisons", 0) for r in results),
               "launches": sum(r["launches"] for r in results),
               "faulty_children": sum(1 for r in results if r["faults"]),
               "faults": faults,
               "fresh_children": len(fresh),
               "fresh_faulty_children": sum(1 for r in fresh if r["faults"]),
               "fresh_first_launch_rel_err": [
                   (r.get("first_launch") or {}).get("rel_err") for r in fresh],
               "fresh_build_s": [r.get("build_s") for r in fresh],
               "seconds": time.perf_counter() - t0}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "kernel_repeat_stress.json").write_text(
        json.dumps({"summary": summary, "children": results}, indent=1))
    print(json.dumps(summary), flush=True)
    sys.exit(1 if faults else 0)


if __name__ == "__main__":
    main()
