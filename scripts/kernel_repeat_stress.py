#!/usr/bin/env python3
"""Look for launches of the port's flash kernels that disagree with
their other launches on the same inputs, on one NVIDIA card.

Builds the kernels once, then starts ``--children`` fresh processes,
``--parallel`` of them at a time, on card 0. Each child draws
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

Prints one JSON line per child and a summary line (also written to
``chiprun_out/kernel_repeat_stress.json``); exits 1 if any launch
disagreed.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
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


def child(reps: int) -> dict:
    import torch

    import chip_smoke as cs
    from k8s_tpu_torch.ops import _kernels
    from k8s_tpu_torch.ops import attention as attn

    for name in _kernels.KERNELS:  # every library loaded first, as chip_smoke.py does
        _kernels.lib(name)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rnd = lambda *sh: torch.randn(sh, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
    scale = 1.0 / D ** 0.5
    out = {"faults": [], "first_launch": None, "launches": 0}

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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--children", type=int, default=32)
    ap.add_argument("--parallel", type=int, default=4)
    ap.add_argument("--reps", type=int, default=1000)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.reps)), flush=True)
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
    results, pending = [], list(range(args.children))
    running = []
    while pending or running:
        while pending and len(running) < args.parallel:
            i = pending.pop(0)
            running.append((i, subprocess.Popen(
                [sys.executable, __file__, "--child", "--reps", str(args.reps)],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        i, proc = running.pop(0)
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
        print(json.dumps(res), flush=True)
        results.append(res)
    faults = sum(len(r["faults"]) for r in results)
    summary = {"card": card, "children": args.children, "parallel": args.parallel,
               "reps": args.reps, "launches": sum(r["launches"] for r in results),
               "faulty_children": sum(1 for r in results if r["faults"]),
               "faults": faults, "seconds": time.perf_counter() - t0}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "kernel_repeat_stress.json").write_text(
        json.dumps({"summary": summary, "children": results}, indent=1))
    print(json.dumps(summary), flush=True)
    sys.exit(1 if faults else 0)


if __name__ == "__main__":
    main()
