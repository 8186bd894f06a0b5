#!/usr/bin/env python3
"""Alternate the port's training run between two checkouts on one card.

    python3 scripts/train_path_ab.py PARENT_DIR [CHANGE_DIR] [--pairs N]

Runs chip_smoke.py's training configuration (Llama-3-8B width cut to 8
layers, seq 2048, batch 8, flash remat, fused CE, learnable data, 10
steps) once per fresh process in each checkout, in the order parent,
change, change, parent, ... (N pairs, default 3), and prints one JSON
line per run (median step of steps 3-10, every step, the tracer's
overhead per step where the checkout has one) and a summary line with
each side's medians, beside the card's name and power limit. A checkout
with ``k8s_tpu_torch.launcher`` runs the program through ``Rendezvous``
+ ``run_program``; an older one calls ``llama_train.main`` directly.
CHANGE_DIR defaults to this script's checkout. Needs one card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ARGS = ("--model=llama3-8b --layers=8 --seq_len=2048 --batch_size=8 "
        "--steps=10 --log_every=1 --remat_policy=flash --fused_ce=1 "
        "--lr=3e-4 --data=learnable")

ONE_RUN = r'''
import contextlib, io, json, statistics, sys, types
sys.path.insert(0, ".")
import torch
torch.backends.cuda.matmul.allow_tf32 = False
ARGS = sys.argv[1]
with contextlib.redirect_stdout(io.StringIO()):
    try:
        from k8s_tpu_torch.launcher.spmd_launcher import Rendezvous, run_program
    except ImportError:
        from k8s_tpu_torch.programs import llama_train
        path = "llama_train.main"
        run = llama_train.main(types.SimpleNamespace(
            process_id=0, program_args=ARGS + " --device=cuda"))
    else:
        path = "Rendezvous + run_program"
        run = run_program(Rendezvous({
            "KTPU_PROGRAM": "k8s_tpu_torch.programs.llama_train:main",
            "KTPU_PROGRAM_ARGS": ARGS}))
    torch.cuda.synchronize()
steps = len(run["step_s"])
tracer = run.get("tracer")
print(json.dumps({
    "path": path,
    "step_ms_median_3_10": 1e3 * statistics.median(run["step_s"][2:]),
    "step_ms": [1e3 * t for t in run["step_s"]],
    "tracer_overhead_ms_per_step":
        None if tracer is None else 1e3 * tracer.overhead_s / steps}))
'''


def run_once(checkout: pathlib.Path) -> dict:
    res = subprocess.run([sys.executable, "-c", ONE_RUN, ARGS], cwd=checkout,
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        sys.exit(f"train_path_ab: run in {checkout} failed:\n{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", type=pathlib.Path)
    ap.add_argument("change", type=pathlib.Path, nargs="?",
                    default=pathlib.Path(__file__).resolve().parent.parent)
    ap.add_argument("--pairs", type=int, default=3)
    a = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    sides = {"parent": a.parent.resolve(), "change": a.change.resolve()}
    order = []
    for i in range(a.pairs):
        order += ["parent", "change"] if i % 2 == 0 else ["change", "parent"]
    medians = {"parent": [], "change": []}
    for side in order:
        r = run_once(sides[side])
        medians[side].append(r["step_ms_median_3_10"])
        print(json.dumps({"side": side, **r}), flush=True)
    print(json.dumps({"card": card, "order": order, "step_ms_medians": medians,
                      "median_of_medians": {k: statistics.median(v)
                                            for k, v in medians.items()}}),
          flush=True)


if __name__ == "__main__":
    main()
