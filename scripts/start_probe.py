#!/usr/bin/env python3
"""Where a fresh Python process's start goes on a card machine.

First a bare process, timed step by step: ``import torch``, CUDA's
first allocation, the import of ``k8s_tpu_torch.programs.llama_train``,
a one-rank NCCL process group, then one 8 GiB device allocation, its
memset and release, and 64 allocations of 64 MiB. Then the launcher's
``llama_train`` child (Llama-3-8B width, 2 layers, S 2048, batch 8, 2
steps, the ``chip_smoke.py`` launcher phase's arguments) under cProfile:
the arrival time of each event line, and the functions by cumulative
time (``builtins.compile`` counts the modules compiled from source).
Run from the root of a checkout on a machine with a card:

    python3 scripts/start_probe.py
"""

from __future__ import annotations

import argparse
import json
import os
import pstats
import socket
import subprocess
import sys
import tempfile
import time

BARE = """
import time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t2 = time.perf_counter()
import k8s_tpu_torch.programs.llama_train
t3 = time.perf_counter()
import torch.distributed as dist
dist.init_process_group("nccl", init_method="tcp://127.0.0.1:{port}", rank=0,
                        world_size=1, device_id=torch.device("cuda", 0))
t4 = time.perf_counter()
x = torch.empty(8 << 30, dtype=torch.uint8, device="cuda")
torch.cuda.synchronize()
t5 = time.perf_counter()
x.zero_()
torch.cuda.synchronize()
t6 = time.perf_counter()
del x
torch.cuda.empty_cache()
torch.cuda.synchronize()
t7 = time.perf_counter()
ys = [torch.empty(64 << 20, dtype=torch.uint8, device="cuda") for _ in range(64)]
torch.cuda.synchronize()
t8 = time.perf_counter()
dist.destroy_process_group()
print({{"import_torch_s": t1 - t0, "cuda_init_s": t2 - t1,
        "import_llama_train_s": t3 - t2, "nccl_group_s": t4 - t3,
        "malloc_8g_s": t5 - t4, "zero_8g_s": t6 - t5, "free_8g_s": t7 - t6,
        "malloc_64x64m_s": t8 - t7}})
"""

CHILD_ARGS = ("--strategy=fsdp --model=llama3-8b --layers=2 --seq_len=2048 "
              "--batch_size=8 --log_every=1 --steps=2 --remat_policy=flash "
              "--fused_ce=1 --lr=3e-4 --data=learnable")


def main() -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    root = os.getcwd()
    env = {k: v for k, v in os.environ.items() if not k.startswith("KTPU_")}
    env["PYTHONPATH"] = root
    with socket.socket() as s:  # a free port for the one-rank group
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    t0 = time.time()
    r = subprocess.run([sys.executable, "-c", BARE.format(port=port)], cwd=root,
                       env=env, capture_output=True, text=True, timeout=600)
    print("bare process", round(time.time() - t0, 2), "s:", r.stdout.strip(),
          r.stderr[-500:] if r.returncode else "", flush=True)

    child_env = dict(env, KTPU_PROGRAM="k8s_tpu_torch.programs.llama_train:main",
                     KTPU_PROGRAM_ARGS=CHILD_ARGS, KTPU_OBS_ADVERTISE="127.0.0.1:0")
    with tempfile.TemporaryDirectory(prefix="start-probe-") as tmp:
        prof = os.path.join(tmp, "child.prof")
        t0 = time.time()
        p = subprocess.Popen([sys.executable, "-m", "cProfile", "-o", prof, "-m",
                              "k8s_tpu_torch.launcher.spmd_launcher"], cwd=root,
                             env=child_env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
        for line in p.stdout:
            if line.startswith("{"):
                try:
                    print(round(time.time() - t0, 2), "s:",
                          json.loads(line).get("event"), flush=True)
                except ValueError:
                    pass
        p.wait(timeout=600)
        print("child exit", p.returncode, "after", round(time.time() - t0, 2), "s",
              p.stderr.read()[-1500:] if p.returncode else "", flush=True)
        pstats.Stats(prof).sort_stats("cumulative").print_stats(70)


if __name__ == "__main__":
    main()
