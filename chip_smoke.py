#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``k8s_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``k8s_tpu_torch/csrc/``, holds
each one against its plain PyTorch version at the serving and training
paths' shapes (error, kernel / plain / library times and the kernel's
roofline bound) and K1-K3 also at one rank's heads under tensor
parallelism (``flash_head_split``: Hq/Hkv 16/4 and 8/2 at the training
batch and sequence), then drives the port's three main paths, in this
order:

- serving: Llama-3-8B at full width and depth (random bf16 weights from
  a fixed seed) through the continuous-batching engine behind a real
  HTTP front-end (two decode chunks in flight, each after the engine's
  first replayed from its CUDA graph), every emitted token checked
  against a teacher-forced forward; then the compiled chunk alone at
  the decode-profile depths: one replay bit-equal to one eager chunk
  from the same state (packed output, state, cache), the eager and
  graph walls per step, the replays' device time and busy share, and
  fresh draws in two replays at temperature 1; then, over the same
  model, the shared-prefix cache (``serving_prefix``: a 512-token
  prefix, one miss, 7 concurrent hits and a repeated hit bit-equal to
  the miss, the counters and snapshot bytes against ``/metrics``, TTFT
  beside a prefix-off engine, the snapshot fetched over ``GET
  /v1/prefix/<digest>`` and installed into another engine) and
  self-speculative decode (``serving_spec``: 4 drafts, 8 repetitive
  prompts and one ending at the cache's last row, which takes the plain
  fallback round; one verify round's wall and device time, the wall per
  token beside a non-spec engine), every token against the oracle;
- training: ``programs.llama_train.main`` through the launcher's API in
  process (``Rendezvous`` of a dict env + ``run_program``, the tracer
  on) at Llama-3-8B width cut to 8 layers (seq 2048, batch 8, ``flash``
  remat, fused CE, f32 AdamW) for 10 steps on learnable data, the loss
  required to fall; a gradient oracle (2 layers, batch 1) against a
  forward of its own through plain attention; step time, tokens/s, MFU,
  peak memory, the compile phase, the tracer's overhead, the median
  step phases and one profiled step's device-time split (``--strategy=
  dp``); then the same run with ``--strategy=fsdp`` at world size 1 on
  the one-process NCCL group ``build_mesh`` joined, FSDP2 on every block
  and the root: the backend and the wrapping checked, K1-K3 launched
  layers x steps times, the first 3 losses against ``dp``'s, step time,
  tokens/s, MFU and peak memory beside ``dp``'s, and the group's NCCL
  init seconds; then ``--strategy=fsdp_tp`` the same way, its tensor
  axis of one rank: every parameter a ``DTensor`` over ``(fsdp,
  tensor)`` checked, the tensor-axis collectives of each step counted
  against their expected number, the first 3 losses against ``dp``'s,
  and its step time, tokens/s, MFU and peak beside ``dp``'s and
  ``fsdp``'s;
- the launcher: ``python -m k8s_tpu_torch.launcher.spmd_launcher`` as a
  child process: the mesh smoke check (exit 0); training at Llama-3-8B
  width, 2 layers, 6 steps, with the per-host obs endpoint polled
  mid-run (the ``/healthz`` heartbeat and its ``hbm`` block against the
  card's memory, the ``/metrics`` HBM series, a one-second
  ``/debug/profile`` holding CUDA kernels, the live flight recorder;
  exit 0; every training child runs ``--strategy=fsdp``, the default,
  so its state is ``DTensor`` s); the same run with the local checkpoint tier sent SIGTERM
  after step 2 (the flush at the current step, exit 143, the flight
  recorder's dump on disk); a restart that restores the flushed step
  from the local tier bit-equal (every leaf's crc read back from the
  card against the manifest's), writes the persistent tier (DCP) and
  exits 0; one more restore timed to its first step (MTTR); then, in
  this process, the restored model served from the DCP step (K1 and K4
  counted, the teacher-forced oracle, its weights against the local
  tier's copy) and a ``checkpoint`` line of save, flush, restore and
  MTTR seconds beside the measured rates;
- the operator: the port's ``LocalWorld`` (controller, reconciler,
  kubelet with subprocess pods on this card) runs three ``TpuJob`` s of
  that 2-layer child, one WORKER with ``nvidia.com/gpu: 1`` each: one to
  ``Succeeded`` with K1-K3 launched layers x steps times in the pod, one
  SIGTERMed at step 2 (exit 143, one gang restart, then ``Succeeded``),
  one with an argument the program refuses (exit 1, ``Failed``), with
  create -> Running -> first step -> ``Succeeded`` beside the launcher's
  direct child;
- the operator over REST (``operator_rest``): ``python -m
  k8s_tpu_torch.api.apiserver --port 0 --with-kubelet`` (its kubelet the
  card's device plugin) and ``python -m k8s_tpu_torch.operator`` without
  ``--local``, as processes; (r1) ``kubectl_local create --server`` of a
  one-card job of that child to ``Succeeded``, ``kubectl_local logs
  --server`` showing K1-K3 launched layers x steps times, create ->
  Running -> first step -> ``Succeeded`` beside the local-mode
  operator's and the direct child's; (r2) a standby operator beside the
  leader, the leader SIGKILLed after the job's first step: the standby
  takes the lock after the 15 s lease and adopts the running job, whose
  one pod trains its steps without a restart to ``Succeeded``;
- the cluster scheduler (``sched``): a ``LocalWorld`` whose controller
  config declares ``fleet: {h100-80gb-x1: 1}``; job A (priority 0,
  preemptible) trains until its heartbeat shows step 2, then job B
  (priority 10) arrives: A is preempted (SIGTERM, exit 143, ``Queued``),
  B trains on the card to ``Succeeded``, A is re-admitted after B's
  release and its cooldown and runs to ``Succeeded``; the ledger's
  high-water mark is one node, the ``ktpu_sched_*`` series are printed,
  and the device plugin's hand-outs show no two pods holding card 0 at
  once. A runs with a local checkpoint directory only if a save still
  fits the call's disk-write limit after the earlier phases;
- the elastic gang (``elastic``): a ``LocalWorld`` over the same
  one-node fleet runs one job of that child with ``training.zeroStage:
  1`` and ``elastic: {minDpDegree: 1, maxDpDegree: 2,
  resizeOnPermanentLoss: true}``: (e1) it is admitted at dp 1, its pod
  carries ``KTPU_ELASTIC_*``, Services exist for both indices of the
  ``maxDpDegree`` range, the ``mesh`` event says dp 1 and ZeRO stage 1,
  and over the obs ticks before its first step the resizer holds
  (attainable nodes = dp); (e2) the pod is SIGKILLed after its first
  step and the gang restarts in place (no ``GangResized``,
  ``ktpu_resize_total`` 0), trains its steps from step 0 with K1-K3
  launched layers x steps times, and the job ends ``Succeeded``; its
  times are printed beside the ``sched`` phase's;
- int8 serving, once the bf16 model and the training state are freed:
  the same Llama-3-8B with int8 weights and an int8 KV cache
  (``--quant=int8_serving --kv_quant=int8``), 16 slots of 8192 rows, 16
  concurrent requests of 12…6000 prompt tokens, every emitted token
  checked against a teacher-forced forward of the same int8 model, the
  compiled chunk checked and timed as above (cache scales included),
  a prefix miss then a hit (bit-equal, the snapshot's f32 scales in its
  bytes) and one speculative request (``serving_prefix_int8``,
  ``serving_spec_int8``), and the bf16 model of the same seed compared
  for information.
- ResNet-50 (``resnet``), the headline workload: the tiny ResNet with
  the same weights on the card and on the CPU (logits and running stats
  within the CPU tests' bf16 limits); ``programs.resnet_train`` through
  the launcher's API in process at ``bench.py``'s shape (batch 256,
  224², conv7 stem, bf16, SGD with Nesterov momentum, one fixed
  synthetic batch), 5 warm-up steps then 20 timed: step ms, images/s,
  MFU, peak memory, the losses falling, one profiled step's device ms
  of the convolutions, BN, the optimizer and the rest, and the step
  with BN's plain f32 ops (its CPU path) beside PyTorch's fused BN
  pieces; then 12 record-fed steps (two shards of 224² uint8 images
  through the native loader, built by g++ at first use, and the device
  prefetch) with the data wait per step beside the step time; K1-K5
  launch 0 times on this path (checked);
- the operator with MNIST (``mnist_operator``): a one-step TpuJob of
  ``programs.mnist_train`` through the local operator on the card, as
  ``bench.py --metric startup`` runs the JAX program's: create -> pod
  Running -> first step -> ``Succeeded``, beside the llama child's.

- BERT-base (``bert``): ``programs.bert_train`` in process at its full
  width and defaults (12 x 768, 12 heads of 64, batch 32, sequence 512,
  masked positions through the fused CE) for BERT_STEPS steps — step ms,
  sequences/s, MFU, peak memory, the losses falling, K1-K3 once per layer
  and step, one profiled step's device ms by class — then BERT-base with
  a padding mask against each row run alone, and one backward through it
  against the plain attention (``_bert_padded_check``).

After the K1-K3 checks at Llama's head dim, ``flash_segments`` holds
K1-K3 with segment ids and at head dim 64 (BERT-base's attention with a
padding mask and without, causal packed documents at D 128, ragged
lengths) against their plain versions, timed beside SDPA with the same
mask.

Before the first K1 check, every SM's shared memory is filled with NaN
words (``poison_shared_memory``, ROADMAP C4), so that check's launch
meets no bytes an earlier launch left.

Each path runs with the launch counts set to 0 just before it and read
just after, and fails unless every kernel of the path launched. A
wrapper's counter ticks when it launches its kernel eagerly or records
it into a graph; a serving path's launches are the eager ones plus, for
each graph replay, the launches its capture recorded
(:func:`path_launches`). Every
phase must pass; the script exits non-zero at the first failure and
prints its result lines only on success. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It needs no network and leaves no process behind.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import pathlib
import queue
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
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
# the BERT padded-model check's limit on a real token's MLM logit row
# (see BERT_PAD_LENGTHS)
BERT_PAD_ROW_TOL = 2 * FLASH_REL_TOL * 12 ** 0.5
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
# train_fsdp against dp at world size 1: the same gradients from the same
# kernels and GEMMs (FSDP2 adds copies, a reduce-scatter over one rank and
# a division by 1), so the first losses agree to f32 rounding of the
# loss's sums
FSDP_DP_LOSS_RTOL = 1e-4
# the launcher phase's training child: Llama-3-8B width, 2 layers
LAUNCHER_LAYERS, LAUNCHER_STEPS = 2, 6
# its checkpoints. A full-state save is 17.85 GB and a run of this script
# must stay under 45 GiB of disk writes (deleted files count), so the
# phase writes two saves: (c)'s SIGTERM flush to the local tier and (d)'s
# persistent (DCP) save. (b) runs without checkpoints, the local tier's
# routed interval lies past every run's steps (the flush is (c)'s only
# local save), and (d) takes no step past its restore (its final save
# finds the local step committed and writes DCP alone); (d') restores
# once more and takes one step, for MTTR, and is killed. The staging cap
# lies above the whole state (the snapshot is one device-to-host stage,
# never throttled by the writer); the grace period a flush must fit is
# Kubernetes' default terminationGracePeriodSeconds.
CKPT_LOCAL_EVERY, CKPT_SAVE_BUFFER_BYTES, CKPT_GRACE_S = 1000, 24 << 30, 30
# the operator phase's jobs (the launcher phase's child configuration):
# (o1) runs to its end, (o2) is SIGTERMed at step 2 and restarted by the
# operator, then trains its steps; the obs port the jobs declare; the
# deadline of every wait
OPERATOR_STEPS, OPERATOR_TERM_STEPS, OPERATOR_OBS_PORT = 6, 5, 8790
OPERATOR_DEADLINE_S = 300
# ResNet-50 at bench.py's shape (batch 256 at 224², conv7 stem, bf16,
# SGD with Nesterov momentum): 5 warm-up steps, then 20 timed; the
# record-fed run loops over 1024 uint8 images (154 MB) in two shards
RESNET_BATCH, RESNET_WARMUP, RESNET_TIMED = 256, 5, 20
RESNET_RECORDS, RESNET_RECORD_STEPS = 1024, 12
# the tiny ResNet on the card against the CPU (tiny_resnet_card_vs_cpu)
# from these seeds: per config the largest error allowed on the logits
# (of the largest logit, at least 1), on the running stats (absolute) and
# on a gradient (relative L2; a BN scale's or bias's sum cancels, so its
# relative error is the largest). Set from the errors the card showed on
# these seeds (PERF.md §6), with 3-20x headroom
RESNET_CARD_SEEDS = range(6)
RESNET_CARD_TOL = {"f32": {"logits": 1e-5, "stats": 2e-6, "grads": 1e-2},
                   "bf16": {"logits": 1e-2, "stats": 1e-4, "grads": 2e-1}}
MNIST_OPERATOR_DEADLINE_S = 180
# the ring phase (sequence parallelism, ROADMAP A7): RING_RANKS threads on
# the one card, one rank of the ring each, over a sequence of RING_SEQ
# (chunks of RING_SEQ / RING_RANKS) at Llama-3-8B's attention heads; the
# packed documents' boundary lies inside chunk 1, on no chunk edge
RING_RANKS, RING_SEQ, RING_BOUNDARY = 4, 8192, 3000
# the model through the ring: Llama-3-8B width cut to this many layers,
# batch 1 at RING_SEQ, this many steps with attention="ring" (a one-rank
# seq group) and with "flash"
RING_MODEL_LAYERS, RING_MODEL_STEPS = 2, 3
# llama_train --strategy=fsdp_tp_sp at world size 1 (a seq axis of 1)
RING_TRAIN_LAYERS, RING_TRAIN_STEPS, RING_TRAIN_SEQ, RING_TRAIN_BATCH = 2, 4, 2048, 4
# BERT-base MLM pretraining (bert_train's defaults: batch 32, sequence
# 512) for this many steps; the step time is the median of steps 3 on
BERT_BATCH, BERT_SEQ, BERT_STEPS, BERT_LAYERS = 32, 512, 20, 12
# the padded-model check: BERT-base at B 2, S 512, rows with these real
# lengths. The real tokens' MLM logits of the padded batch against each
# row run alone, unpadded: the masked keys add exact zeros to K1's sums,
# so what differs is bf16 rounding at other points (the GEMMs' tilings at
# another row count) — at most K1's row limit per layer in each of the
# two runs, independent over the layers: 2 x FLASH_REL_TOL x sqrt(layers)
# of a row's norm (FLASH_REL_TOL is defined below)
BERT_PAD_LENGTHS = (384, 448)
# the operator_rest phase: (r2)'s job trains this many steps (~0.87 s
# each) so that it outlasts the leader's 15 s lease, the standby's 3 s
# retry and its adoption after the leader is killed at the first step
REST_FAILOVER_STEPS = 36
# the sched phase: A's and B's steps; A's re-admission hold-off after
# its preemption (the scheduler's cooldown)
SCHED_A_STEPS, SCHED_B_STEPS, SCHED_COOLDOWN_S = 8, 4, 5.0
# the elastic phase: its job's steps (its pod is SIGKILLed after the
# first, and the restarted pod trains them all), and the resizer's
# observations it must see hold before the kill
ELASTIC_STEPS, ELASTIC_MIN_TICKS = 5, 2
# a chip call may write 45 GiB (deleted files included); one save of the
# 2-layer child's state is 17.84 GB. A's flush (sched) needs one save of
# room, and a pod's terminationGracePeriodSeconds long enough for it
WRITE_LIMIT_BYTES, CHILD_SAVE_BYTES, SCHED_FLUSH_GRACE_S = 45 << 30, 17.9e9, 180
REPO = pathlib.Path(__file__).resolve().parent


def k1_instance(d: int, config: int, seg: bool = False, out_f32: bool = False) -> str:
    """K1's kernel instance at head dim ``d`` and tile config ``config``,
    with or without segment ids, O in bf16 or f32 (csrc/flash_fwd.cu,
    templated on the head dim, the number of consumer warpgroups, the
    segment flag and the f32-output flag), as torch.profiler names it."""
    return (f"flash_fwd_kernel<{d}, {2 if config == 0 else 1}, {str(seg).lower()}, "
            f"{str(out_f32).lower()}>")


def k23_instances(seg: bool, grads_f32: bool, d: int = 128):
    """K2's and K3's instances (csrc/flash_bwd.cu, templated on the head
    dim, the segment flag and the f32-gradient flag), as torch.profiler
    names them."""
    flags = f"{d}, {str(seg).lower()}, {str(grads_f32).lower()}>"
    return f"flash_bwd_dq_kernel<{flags}", f"flash_bwd_dkv_kernel<{flags}"


# K1's tile config -> its instance at head dim 128 (Llama-3-8B)
K1_INSTANCES = {0: k1_instance(128, 0), 1: k1_instance(128, 1)}
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
    if len(msg) > 400:
        # a message that carries a log tail: its head once more, last,
        # so that the end of stderr says what failed
        print(f"chip_smoke: FAIL (head of the message above): {msg[:400]}",
              file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


PHASE_SECONDS = {}


def timed(name: str, fn, *args):
    """``fn(*args)``, its wall seconds kept in ``PHASE_SECONDS[name]``."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    return out


def _profiled(torch, fn, reps: int):
    """key_averages() of ``reps`` calls of ``fn`` under torch.profiler
    (after one warm-up call). A session that records no device event at
    all is taken again, up to four sessions, after a pause that grows,
    the later ones with CPU activity on too: sessions have come back
    empty at random, twice in a row once (PERF.md)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(4):
        activities = [ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if attempt >= 2 else [])
        with profile(activities=activities) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        if events:
            return events
        print(f"chip_smoke: torch.profiler session {attempt + 1} recorded no "
              "device time; taking it again", file=sys.stderr, flush=True)
        time.sleep(attempt + 1)
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
    ``names`` (torch.profiler over ``reps`` calls of ``fn``). A session
    that recorded some of the kernels and not the others is taken again,
    up to three sessions: one came back without the K5 merge kernel while
    it held the split kernel (PR 17)."""
    for attempt in range(3):
        out = {n: 0.0 for n in names}
        for e in _profiled(torch, fn, reps):
            for n in names:
                if n in e.key:
                    out[n] += e.self_device_time_total / 1e3 / reps
        if all(out.values()):
            return out
        print(f"chip_smoke: torch.profiler session held no device time for some "
              f"of {out}; taking it again", file=sys.stderr, flush=True)
        time.sleep(attempt + 1)
    fail(f"torch.profiler recorded no device time for {out}")


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


def rows_off(out, ref, tol: float = FLASH_REL_TOL) -> dict:
    """Where a [B, S, H, D] output errs past ``tol`` (row errors as in
    :func:`row_rel_err`): the count of such rows, and the batches, heads
    and 64-row query tiles they fall in."""
    ref = ref.float()
    err = (out.float() - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)
    idx = (err > tol).nonzero().tolist()
    return {"rows": len(idx), "of": err.numel(),
            "batches": sorted({b for b, _, _ in idx}),
            "heads": sorted({h for _, _, h in idx}),
            "tiles64": sorted({s // 64 for _, s, _ in idx})[:32]}


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


class ThreadRing:
    """Ring attention's transport over threads of one process, one thread
    per rank (the ``ring`` phase's 4 ranks on the one card, since NCCL
    refuses two ranks on one card): ``.size``, ``.rank`` and ``.rotate``
    as ``parallel.ring_attention.ProcessGroupRing`` has them. A rotation
    puts this rank's tensors in its slot, waits for every rank, takes
    the slot of rank ``rank - shift`` and waits again, so no slot is
    overwritten before it is read. The threads launch on the same
    stream, so a received tensor is ready for whatever is launched after
    it; the ring functions never write a received tensor in place."""

    def __init__(self, slots, barrier, size: int, rank: int):
        self.slots, self.barrier, self.size, self.rank = slots, barrier, size, rank

    def rotate(self, *tensors, shift: int = 1):
        self.slots[self.rank] = tensors
        self.barrier.wait()
        got = self.slots[(self.rank - shift) % self.size]
        self.barrier.wait()
        return tuple(got)


def run_thread_ring(n: int, fn, timeout: float = 300.0) -> list:
    """``fn(ring)`` on ``n`` threads, one :class:`ThreadRing` rank each;
    returns their results in rank order. A rank that raises breaks the
    barrier (the others raise too, instead of waiting), and its error is
    raised here."""
    barrier = threading.Barrier(n, timeout=timeout)
    slots = [None] * n
    results, errors = [None] * n, [None] * n

    def body(rank):
        try:
            results[rank] = fn(ThreadRing(slots, barrier, n, rank))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors[rank] = e
            barrier.abort()

    threads = [threading.Thread(target=body, args=(r,), daemon=True) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if any(t.is_alive() for t in threads):
        raise RuntimeError(f"thread ring: a rank did not finish in {timeout} s")
    first = next((e for e in errors if e is not None
                  and not isinstance(e, threading.BrokenBarrierError)), None)
    first = first or next((e for e in errors if e is not None), None)
    if first is not None:
        raise first
    return results


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
            # still a failure; say where it erred and whether the same
            # call errs again, so that a rare fault can be told apart
            again, again_lse = attn.flash_fwd(q, k, v, causal, scale, with_lse=True)
            torch.cuda.synchronize()
            fail(f"flash_fwd {what}: {row} (tol {FLASH_REL_TOL}, lse {FLASH_LSE_TOL}); "
                 f"rows off: {rows_off(out, ref)}; the same call again: "
                 f"rel_err {row_rel_err(again, ref)}, "
                 f"lse_err {(again_lse - ref_lse).abs().max().item()}, "
                 f"bit-equal to the first {torch.equal(again, out)}")
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
    smem = {f"D{d}_config{c}": attn.flash_smem_bytes("fwd", c, d)
            for d in attn.KERNEL_HEAD_DIMS for c in attn.FLASH_FWD_TILES}
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
    smem = {f"{name}_D{d}": attn.flash_smem_bytes(name, d=d)
            for name in ("dq", "dkv") for d in attn.KERNEL_HEAD_DIMS}

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
                                        "777 non-causal, the edges and flash_segments)",
              "plain_ms": plain_ms, "library_ms": library_ms}
    return {
        "flash_bwd_dq": dict(common, max_abs_err=worst_abs["dq"], rel_err=worst["dq"],
                             ms=train["k2_ms"], bound_ms=k2[0], bound_by=k2[1]),
        "flash_bwd_dkv": dict(common, max_abs_err=worst_abs["dkv"],
                              rel_err=max(worst["dk"], worst["dv"]),
                              ms=train["k3_ms"], bound_ms=k3[0], bound_by=k3[1]),
    }


# the per-rank head counts of llama_train --strategy=fsdp_tp at tensor 2
# and 4 (Llama-3-8B's 32 q / 8 kv heads split contiguously over the
# tensor axis), at the training phase's batch and sequence
HEAD_SPLITS = ((16, 4), (8, 2))


def phase_flash_head_split(torch, attn, gen):
    """K1, K2 and K3 at each rank's shape under tensor parallelism
    (``flash_attention_sharded``'s local block): B 8, S 2048, D 128,
    causal, Hq/Hkv 16/4 (tensor 2) and 8/2 (tensor 4). Each is held
    against its plain version at the limits of the full-head checks (K1
    rows 8e-3, lse 1e-4; K2/K3 rows 1e-2 with the row floor) and timed
    beside its bound, its plain version and SDPA (forward; forward and
    backward for K2/K3), with the K1 tile config ``_flash_fwd_config``
    chose."""
    b, s, d = TRAIN_BATCH, TRAIN_SEQ, 128
    scale = 1.0 / d ** 0.5
    rnd = lambda *sh: torch.randn(sh, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
    rows = []
    names = ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
    for hq, hkv in HEAD_SPLITS:
        q, k, v, do = rnd(b, s, hq, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d), rnd(b, s, hq, d)
        config = attn._flash_fwd_config(b, s, hq)
        out, lse = attn.flash_fwd(q, k, v, True, scale, with_lse=True)
        ref, ref_lse = attn.flash_fwd_plain(q.float(), k.float(), v.float(), True, scale)
        got = attn.flash_bwd(q, k, v, out, lse, do, True, scale)
        gref = attn.flash_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse,
                                    do.float(), True, scale)
        torch.cuda.synchronize()
        row = {"Hq": hq, "Hkv": hkv, "tensor": 32 // hq, "config": config,
               "k1_rel_err": row_rel_err(out, ref),
               "k1_max_abs_err": (out.float() - ref).abs().max().item(),
               "lse_err": (lse - ref_lse).abs().max().item()}
        for name, x, r in zip(("dq", "dk", "dv"), got, gref):
            row[name + "_rel_err"] = row_rel_err(x, r, floor=FLASH_BWD_ROW_FLOOR)
            row[name + "_max_abs_err"] = (x.float() - r).abs().max().item()
        del ref, gref
        if not (row["k1_rel_err"] <= FLASH_REL_TOL and row["lse_err"] <= FLASH_LSE_TOL):
            fail(f"flash_head_split K1 Hq={hq} Hkv={hkv}: {row} (tol {FLASH_REL_TOL}, "
                 f"lse {FLASH_LSE_TOL})")
        if max(row[n + "_rel_err"] for n in ("dq", "dk", "dv")) > FLASH_BWD_REL_TOL:
            fail(f"flash_head_split K2/K3 Hq={hq} Hkv={hkv}: {row} "
                 f"(tol {FLASH_BWD_REL_TOL})")
        pairs = s * (s + 1) / 2
        qo, kv, rowb = 2 * b * s * hq * d, 2 * b * s * hkv * d, 4 * b * hq * s
        k1_flops = 4 * b * hq * d * pairs
        row["k1_bound_ms"], row["k1_bound_by"] = bound(2 * qo + 2 * kv, k1_flops)
        row["k2_bound_ms"], row["k2_bound_by"] = bound(3 * qo + 2 * kv + 2 * rowb,
                                                       6 * b * hq * d * pairs)
        row["k3_bound_ms"], row["k3_bound_by"] = bound(2 * qo + 4 * kv + 2 * rowb,
                                                       8 * b * hq * d * pairs)
        row["k1_ms"] = kernel_ms(torch, lambda: attn.flash_fwd(q, k, v, True, scale),
                                 [K1_INSTANCES[config]], reps=10)[K1_INSTANCES[config]]
        t_bwd = kernel_ms(torch, lambda: attn.flash_bwd(q, k, v, out, lse, do, True, scale),
                          names)
        row["k2_ms"], row["k3_ms"] = t_bwd[names[0]], t_bwd[names[1]]
        row["k1_tflops"] = k1_flops / row["k1_ms"] / 1e9
        row["k1_plain_ms"] = device_ms(
            torch, lambda: attn.flash_fwd_plain(q, k, v, True, scale), reps=1)
        row["bwd_plain_ms"] = device_ms(
            torch, lambda: attn.flash_bwd_plain(q, k, v, out, lse, do, True, scale), reps=1)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        row["k1_sdpa_ms"] = device_ms(torch, sdpa(torch, qt.detach(), kt.detach(),
                                                  vt.detach(), is_causal=True))
        o_sdpa = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        row["bwd_sdpa_ms"] = device_ms(torch, lambda: torch.autograd.grad(
            o_sdpa, (qt, kt, vt), dot, retain_graph=True))
        rows.append(row)
        del q, k, v, do, out, lse, got, qt, kt, vt, o_sdpa, dot
        torch.cuda.empty_cache()
    emit({"phase": "flash_head_split", "shape": f"B={b} S={s} D={d} causal bf16",
          "rel_tol": FLASH_REL_TOL, "lse_tol": FLASH_LSE_TOL,
          "bwd_rel_tol": FLASH_BWD_REL_TOL, "row_floor": FLASH_BWD_ROW_FLOOR,
          "rows": rows})
    return rows


def segment_rows(kind: str, b: int, s: int, gen):
    """[B, S] int32 segment ids on the CPU: ``"pad"`` a padding mask (1
    real, 0 pad) with each row's real length drawn from 64..S; ``"packed"``
    3-5 documents per row (ids 1, 2, ...; a document at least 16 tokens),
    the tail after the last one padding (0)."""
    import torch

    rows = torch.zeros(b, s, dtype=torch.int32)
    for i in range(b):
        if kind == "pad":
            n = int(torch.randint(64, s + 1, (1,), generator=gen))
            rows[i, :n] = 1
            continue
        docs = int(torch.randint(3, 6, (1,), generator=gen))
        cuts = sorted(torch.randperm(s // 16 - 1, generator=gen)[:docs].add(1)
                      .mul(16).tolist())
        start = 0
        for j, end in enumerate(cuts):
            rows[i, start:end] = j + 1
            start = end
    return rows


def visible_pairs(seg, b: int, s: int, causal: bool) -> int:
    """The (query, key) pairs one head's attention computes over a batch
    of ``b`` rows of ``s``: per row, the pairs of equal segment ids (every
    pair without ids), and only key <= query when causal — the work this
    run's data needs (the kernels mask the rest)."""
    if seg is None:
        return b * (s * (s + 1) // 2 if causal else s * s)
    total = 0
    for row in seg.tolist():
        counts = {}
        for x in row:
            counts[x] = counts.get(x, 0) + 1
            if causal:
                total += counts[x]  # this query's keys <= it with its id
        if not causal:
            total += sum(n * n for n in counts.values())
    return total


def visible_mask(torch, seg, s: int, causal: bool, device):
    """The boolean [B, 1, S, S] mask (True: attend) of segment ids and
    the causal diagonal, SDPA's ``attn_mask`` for the same function."""
    mask = (seg[:, :, None] == seg[:, None, :]).to(device)
    if causal:
        mask &= torch.ones(s, s, dtype=torch.bool, device=device).tril()
    return mask[:, None]


# (name, B, S, Hq, Hkv, D, causal, segment ids): BERT-base's attention
# with a padding mask and without one, causal packed documents at D 128,
# and ragged lengths with ids at both head dims
SEGMENT_CASES = (
    ("bert_base_pad", BERT_BATCH, BERT_SEQ, 12, 12, 64, False, "pad"),
    ("bert_base_nomask", BERT_BATCH, BERT_SEQ, 12, 12, 64, False, None),
    ("packed_causal_d128", 2, 2048, 32, 8, 128, True, "packed"),
    ("ragged_packed_causal_d128", 2, 777, 32, 8, 128, True, "packed"),
    ("ragged_pad_d64", 2, 777, 12, 12, 64, False, "pad"),
)


def phase_flash_segments(torch, attn, gen):
    """K1, K2 and K3 with segment ids and at head dim 64 (R8's two
    features, BERT's path) against their plain versions in f32 on the same
    bf16 inputs, at the limits of the other checks (K1 rows 8e-3 and lse
    1e-4; K2/K3 rows 1e-2 with the row floor): BERT-base's attention (B
    32, S 512, Hq = Hkv = 12, D 64, non-causal) with a padding mask of
    real lengths 64..512 and without one; causal packed documents (3-5
    per row) at B 2, S 2048, Hq/Hkv 32/8, D 128; and ragged S 777 with
    ids at both head dims. The limits must see a fault: the BERT-shape
    output with the mask dropped. Each case is timed — K1, K2 and K3 by
    kernel name in one profiler session; the plain versions, and SDPA
    forward and forward + backward with the equivalent boolean mask (the
    yardstick, never the path), with CUDA events over back-to-back calls
    (no more profiler sessions in this process: they came back partial
    once too many were opened) — beside their bounds, which count the
    pairs this data makes visible."""
    rnd = lambda *sh: torch.randn(sh, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
    cpu_gen = torch.Generator().manual_seed(17)
    names = ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
    rows, fault = [], None
    for name, b, s, hq, hkv, d, causal, kind in SEGMENT_CASES:
        scale = 1.0 / d ** 0.5
        q, k, v, do = rnd(b, s, hq, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d), rnd(b, s, hq, d)
        seg = None if kind is None else segment_rows(kind, b, s, cpu_gen).cuda()
        config = attn._flash_fwd_config(b, s, hq)
        out, lse = attn.flash_fwd(q, k, v, causal, scale, with_lse=True, segment_ids=seg)
        ref, ref_lse = attn.flash_fwd_plain(q.float(), k.float(), v.float(), causal,
                                            scale, seg)
        got = attn.flash_bwd(q, k, v, out, lse, do, causal, scale, segment_ids=seg)
        gref = attn.flash_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse,
                                    do.float(), causal, scale, seg)
        torch.cuda.synchronize()
        row = {"case": name, "B": b, "S": s, "Hq": hq, "Hkv": hkv, "D": d,
               "causal": causal, "segment_ids": kind, "config": config,
               "k1_rel_err": row_rel_err(out, ref),
               "k1_max_abs_err": (out.float() - ref).abs().max().item(),
               "lse_err": (lse - ref_lse).abs().max().item()}
        if seg is not None:
            row["segments_per_row"] = [len(set(r)) for r in seg.tolist()][:8]
        for n, x, r in zip(("dq", "dk", "dv"), got, gref):
            row[n + "_rel_err"] = row_rel_err(x, r, floor=FLASH_BWD_ROW_FLOOR)
            row[n + "_max_abs_err"] = (x.float() - r).abs().max().item()
        if not (row["k1_rel_err"] <= FLASH_REL_TOL and row["lse_err"] <= FLASH_LSE_TOL):
            fail(f"flash_segments {name}: K1 {row} (tol {FLASH_REL_TOL}, lse "
                 f"{FLASH_LSE_TOL}); rows off: {rows_off(out, ref)}")
        if max(row[n + "_rel_err"] for n in ("dq", "dk", "dv")) > FLASH_BWD_REL_TOL:
            fail(f"flash_segments {name}: K2/K3 {row} (tol {FLASH_BWD_REL_TOL})")
        if name == "bert_base_pad":
            # a planted fault: the padding mask dropped (pad keys leak into
            # the real rows)
            leak, _ = attn.flash_fwd_plain(q.float(), k.float(), v.float(), causal, scale)
            fault = row_rel_err(leak.to(torch.bfloat16), ref)
            if not fault > FLASH_REL_TOL:
                fail(f"flash_segments: the K1 limit does not see the mask dropped ({fault})")
        del ref, gref, got
        pairs = visible_pairs(seg.cpu() if seg is not None else None, b, s, causal)
        qo, kv, rowb = 2 * b * s * hq * d, 2 * b * s * hkv * d, 4 * b * hq * s
        segb = 4 * b * s if seg is not None else 0
        row["visible_pairs_per_head"] = pairs
        row["k1_bound_ms"], row["k1_bound_by"] = bound(2 * qo + 2 * kv + rowb + segb,
                                                       4 * hq * d * pairs)
        row["k2_bound_ms"], row["k2_bound_by"] = bound(3 * qo + 2 * kv + 2 * rowb + segb,
                                                       6 * hq * d * pairs)
        row["k3_bound_ms"], row["k3_bound_by"] = bound(2 * qo + 4 * kv + 2 * rowb + segb,
                                                       8 * hq * d * pairs)
        inst = k1_instance(d, config, seg is not None)
        t = kernel_ms(torch, lambda: (
            attn.flash_fwd(q, k, v, causal, scale, segment_ids=seg),
            attn.flash_bwd(q, k, v, out, lse, do, causal, scale, segment_ids=seg)),
            [inst, *names], reps=10)
        row["k1_ms"], row["k2_ms"], row["k3_ms"] = t[inst], t[names[0]], t[names[1]]
        row["k1_plain_ms"] = call_ms(torch, lambda: attn.flash_fwd_plain(
            q, k, v, causal, scale, seg), reps=3, warmup=1)
        row["bwd_plain_ms"] = call_ms(torch, lambda: attn.flash_bwd_plain(
            q, k, v, out, lse, do, causal, scale, seg), reps=3, warmup=1)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = (visible_mask(torch, seg, s, causal, q.device) if seg is not None
                else None)
        sd_kw = ({"attn_mask": mask} if mask is not None else {"is_causal": causal})
        row["k1_sdpa_ms"] = call_ms(torch, sdpa(torch, qt, kt, vt, **sd_kw))
        qg, kg, vg = (x.requires_grad_() for x in (qt.clone(), kt.clone(), vt.clone()))
        o_sdpa = torch.nn.functional.scaled_dot_product_attention(
            qg, kg, vg, enable_gqa=True, **sd_kw)
        dot = do.transpose(1, 2).contiguous()
        row["bwd_sdpa_ms"] = call_ms(torch, lambda: torch.autograd.grad(
            o_sdpa, (qg, kg, vg), dot, retain_graph=True))
        del qt, kt, vt, qg, kg, vg, o_sdpa, dot, mask
        rows.append(row)
        del q, k, v, do, out, lse, seg
        torch.cuda.empty_cache()
    emit({"phase": "flash_segments", "rel_tol": FLASH_REL_TOL, "lse_tol": FLASH_LSE_TOL,
          "bwd_rel_tol": FLASH_BWD_REL_TOL, "row_floor": FLASH_BWD_ROW_FLOOR,
          "planted_fault_mask_dropped_k1_rel_err": fault, "rows": rows,
          "note": "bounds count the visible (query, key) pairs of this data; "
                  "k*_ms are device ms per call of the kernel by name "
                  "(torch.profiler); the plain and SDPA times are CUDA-event "
                  "walls per call of back-to-back calls; bwd_plain_ms and "
                  "bwd_sdpa_ms compute dq, dk and dv together"})
    return rows


def _ring_plain_reference(torch, attn, q, k, v, do, seg, c, scale, outs):
    """The whole causal sequence's attention and gradients in f32 from the
    plain versions, one query chunk at a time (chunk r against keys [0,
    (r + 1) c): the plain causal diagonal ``tril(k=sk-sq)`` is then the
    global one), so no [S, S] score matrix is held: ``(out, lse, grads)``,
    ``grads`` the ``(dq, dk, dv)`` for each bf16 output of ``outs``. The
    backward takes D = rowsum(dO O) from that output, as the kernels do
    (from the forward's bf16 O): a row whose dq nearly cancels (one that
    sees almost only itself) moves with D by far more than the kernels'
    rounding, so each run's gradients are held against the plain backward
    of its own output, as the other K2/K3 checks hold them."""
    n = q.shape[1] // c
    fwd, lses = [], []
    grads = [[[], torch.zeros(k.shape, dtype=torch.float32, device=k.device),
              torch.zeros(k.shape, dtype=torch.float32, device=k.device)] for _ in outs]
    for r in range(n):
        rows, keys = slice(r * c, (r + 1) * c), slice(0, (r + 1) * c)
        qr, kr, vr, dor = (x.float() for x in (q[:, rows], k[:, keys], v[:, keys],
                                               do[:, rows]))
        sq, skv = (None, None) if seg is None else (seg[:, rows], seg[:, keys])
        out, lse = attn.flash_fwd_plain(qr, kr, vr, True, scale, sq, skv, out_f32=True)
        fwd.append(out)
        lses.append(lse)
        for acc, o in zip(grads, outs):
            g = attn.flash_bwd_plain(qr, kr, vr, o[:, rows].float(), lse, dor, True,
                                     scale, sq, skv, grads_f32=True)
            acc[0].append(g[0])
            acc[1][:, keys] += g[1]
            acc[2][:, keys] += g[2]
    return (torch.cat(fwd, 1), torch.cat(lses, 2),
            [(torch.cat(dq, 1), dk, dv) for dq, dk, dv in grads])


def phase_ring(torch, attn, card, gen):
    """Sequence parallelism (ROADMAP A7) on the card: ring attention through
    K1-K3's ring features (``out_f32``, ``grads_f32``, the kv-side segment
    row), at Llama-3-8B's attention heads (Hq 32, Hkv 8, D 128).

    1. The new kernel variants against their plain versions at the ring's
       chunk shape (B 1, S_local 2048) with the limits of K1 (rows 8e-3,
       lse 1e-4) and K2/K3 (rows 1e-2 with the row floor), shared memory
       poisoned before the first launch: K1 with ``out_f32`` causal (the
       diagonal block) and non-causal (a past chunk), and with a kv-side
       row that differs from the query row (queries of chunk 2, all of
       document 2; the resident chunk 1 holds the packed boundary at 3000,
       so only its keys from 3000 on are visible); K2/K3 with
       ``grads_f32``, causal, and with the kv row. A planted fault (the kv
       row dropped) must exceed the K1 limit. Each is timed by kernel name
       (torch.profiler) beside its bound, its plain version and SDPA on the
       same inputs (SDPA writes bf16; K1 here writes f32).
    2. The 4-rank ring at S 8192 (4 chunks of 2048), causal, without and
       with packed ids: 4 threads of this process, one rank each, over
       ``ThreadRing`` (NCCL refuses two ranks on one card), each calling
       ``ring_flash_forward`` and ``ring_flash_backward`` (not through
       autograd: its engine has one worker thread per device, so backward
       calls that wait on each other at a barrier would deadlock). The
       gathered O, dQ, dK and dV are held against K1-K3 on the whole
       sequence on this card at the row limits, and both against the plain
       versions in f32 (chunk by chunk; each run's gradients against the
       plain backward of its own bf16 O, whose D they take); the ring's wall beside the whole
       sequence's, and the device time of each (torch.profiler: K1-K3 by
       instance, and every device event, the ring's merges and sums too);
       K1-K3 each launched n + n (n - 1) / 2 times (the diagonal and the
       past chunks), all in their f32 instances.
    3. A training step of the model through the ring and through Ulysses:
       the port's Llama at Llama-3-8B width cut to RING_MODEL_LAYERS
       layers, B 1, S 8192, ``attention="ring"`` (one diagonal block with
       ``out_f32`` and ``grads_f32`` per layer) and ``attention="ulysses"``
       (the all-to-alls around flash attention), each on a one-rank seq
       group, against the same model with ``attention="flash"``,
       RING_MODEL_STEPS steps each from the same weights and batch: the
       first losses and the largest gradient difference (the ring rounds
       its f32 block to bf16 once, as K1 does; one rank's all-to-all is a
       copy; so equality is expected).
    4. ``llama_train --strategy=fsdp_tp_sp`` at world size 1 through the
       launcher's API in process (its seq axis of one rank: flash
       attention, as in the JAX program): admitted and run, K1-K3 launched
       layers x steps times, finite losses.

    Returns the launches of the paths (2-4) and the rows of the kernels
    line."""
    from k8s_tpu_torch.launcher.spmd_launcher import Rendezvous, run_program
    from k8s_tpu_torch.models import LlamaConfig, LlamaForCausalLM, init_params
    from k8s_tpu_torch.parallel import MeshConfig, build_mesh, mesh_shape
    from k8s_tpu_torch.parallel import ring_attention as ring_mod
    from k8s_tpu_torch.train import create_train_state, make_train_step

    t_phase = time.perf_counter()
    hq, hkv, d = 32, 8, 128
    scale = 1.0 / d ** 0.5
    n, s = RING_RANKS, RING_SEQ
    c = s // n
    bf16 = torch.bfloat16
    rnd = lambda *sh: torch.randn(sh, generator=gen, device="cuda").to(bf16)  # noqa: E731
    seg_all = torch.where(torch.arange(s, device="cuda") < RING_BOUNDARY, 1, 2)[None]
    seg_all = seg_all.to(torch.int32)

    def counts():
        return {"flash_fwd": attn.flash_fwd.launches,
                "flash_bwd_dq": attn.flash_bwd.launches_dq,
                "flash_bwd_dkv": attn.flash_bwd.launches_dkv,
                "flash_fwd_out_f32": attn.flash_fwd.launches_out_f32,
                "flash_bwd_grads_f32": attn.flash_bwd.launches_grads_f32}

    def reset():
        attn.flash_fwd.launches = attn.flash_fwd.launches_out_f32 = 0
        attn.flash_bwd.launches_dq = attn.flash_bwd.launches_dkv = 0
        attn.flash_bwd.launches_grads_f32 = 0

    # -- 1. the new variants at the chunk shape ------------------------------
    q, k, v, do = rnd(1, c, hq, d), rnd(1, c, hkv, d), rnd(1, c, hkv, d), rnd(1, c, hq, d)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    seg_q = seg_all[:, 2 * c:3 * c].contiguous()
    seg_kv = seg_all[:, c:2 * c].contiguous()
    config = attn._flash_fwd_config(1, c, hq)
    attn.poison_shared_memory(torch.device("cuda"), attn.flash_smem_bytes("fwd", config))
    visible_kv = int((seg_kv == 2).sum())  # every query is document 2
    pairs = {"causal": c * (c + 1) // 2, "full": c * c, "kv_row": c * visible_kv}
    qo, kvb, rowb, segb = 2 * c * hq * d, 2 * c * hkv * d, 4 * hq * c, 2 * 4 * c
    variants, fault = [], None
    for name, causal, sq_, skv, bwd in (
            ("out_f32_causal", True, None, None, True),
            ("out_f32_noncausal", False, None, None, False),
            ("out_f32_kv_row", False, seg_q, seg_kv, True)):
        out, lse = attn.flash_fwd(q, k, v, causal, scale, with_lse=True, segment_ids=sq_,
                                  segment_ids_kv=skv, out_f32=True)
        ref, ref_lse = attn.flash_fwd_plain(qf, kf, vf, causal, scale, sq_, skv,
                                            out_f32=True)
        torch.cuda.synchronize()
        key = "kv_row" if skv is not None else ("causal" if causal else "full")
        row = {"variant": name, "causal": causal, "kv_row": skv is not None,
               "B": 1, "S_local": c, "out_dtype": str(out.dtype),
               "k1_rel_err": row_rel_err(out, ref),
               "k1_max_abs_err": (out - ref).abs().max().item(),
               "lse_err": (lse - ref_lse).abs().max().item(),
               "visible_pairs_per_head": pairs[key]}
        if out.dtype != torch.float32:
            fail(f"ring {name}: K1 wrote {out.dtype}, not float32")
        if not (row["k1_rel_err"] <= FLASH_REL_TOL and row["lse_err"] <= FLASH_LSE_TOL):
            fail(f"ring {name}: K1 {row} (tol {FLASH_REL_TOL}, lse {FLASH_LSE_TOL}); "
                 f"rows off: {rows_off(out, ref)}")
        if skv is not None:
            # a planted fault: the kv row dropped (the query row on both
            # sides makes every key of the resident chunk visible)
            leak, _ = attn.flash_fwd_plain(qf, kf, vf, causal, scale, sq_, out_f32=True)
            fault = row_rel_err(leak, ref)
            if not fault > FLASH_REL_TOL:
                fail(f"ring: the K1 limit does not see the kv row dropped ({fault})")
        extra = segb if skv is not None else 0
        row["k1_bound_ms"], row["k1_bound_by"] = bound(
            qo + 2 * kvb + 2 * qo + rowb + extra, 4 * hq * d * pairs[key])
        if bwd:
            ob = out.to(bf16)
            got = attn.flash_bwd(q, k, v, ob, lse, do, causal, scale, segment_ids=sq_,
                                 segment_ids_kv=skv, grads_f32=True)
            gref = attn.flash_bwd_plain(qf, kf, vf, ob.float(), lse, dof, causal, scale,
                                        sq_, skv, grads_f32=True)
            torch.cuda.synchronize()
            if any(x.dtype != torch.float32 for x in got):
                fail(f"ring {name}: K2/K3 wrote {[str(x.dtype) for x in got]}, not float32")
            for gname, x, r in zip(("dq", "dk", "dv"), got, gref):
                row[gname + "_rel_err"] = row_rel_err(x, r, floor=FLASH_BWD_ROW_FLOOR)
                row[gname + "_max_abs_err"] = (x - r).abs().max().item()
            if max(row[g + "_rel_err"] for g in ("dq", "dk", "dv")) > FLASH_BWD_REL_TOL:
                fail(f"ring {name}: K2/K3 {row} (tol {FLASH_BWD_REL_TOL})")
            row["k2_bound_ms"], row["k2_bound_by"] = bound(
                2 * qo + 2 * qo + 2 * kvb + 2 * rowb + extra, 6 * hq * d * pairs[key])
            row["k3_bound_ms"], row["k3_bound_by"] = bound(
                2 * qo + 2 * kvb + 4 * kvb + 2 * rowb + extra, 8 * hq * d * pairs[key])
            del got, gref, ob
        row["_args"] = (causal, sq_, skv, out, lse)
        variants.append(row)
        del ref, ref_lse

    # device times by instance: the causal and the kv-row variants with
    # their backward in one profiler session, the non-causal K1 (the same
    # instance as the causal one) in a second
    for group in ((variants[0], variants[2]), (variants[1],)):
        names, calls = [], []
        for row in group:
            causal, sq_, skv, out, lse = row["_args"]
            inst = k1_instance(d, config, skv is not None, True)
            names.append(inst)
            calls.append(lambda causal=causal, sq_=sq_, skv=skv: attn.flash_fwd(
                q, k, v, causal, scale, segment_ids=sq_, segment_ids_kv=skv, out_f32=True))
            if "k2_bound_ms" in row:
                names += list(k23_instances(skv is not None, True, d))
                ob = out.to(bf16)
                calls.append(lambda causal=causal, sq_=sq_, skv=skv, ob=ob, lse=lse:
                             attn.flash_bwd(q, k, v, ob, lse, do, causal, scale,
                                            segment_ids=sq_, segment_ids_kv=skv,
                                            grads_f32=True))
        t = kernel_ms(torch, lambda calls=calls: [f() for f in calls], names, reps=10)
        for row in group:
            causal, sq_, skv, out, lse = row["_args"]
            row["k1_ms"] = t[k1_instance(d, config, skv is not None, True)]
            if "k2_bound_ms" in row:
                k2n, k3n = k23_instances(skv is not None, True, d)
                row["k2_ms"], row["k3_ms"] = t[k2n], t[k3n]
    for row in variants:
        causal, sq_, skv, out, lse = row.pop("_args")
        row["k1_plain_ms"] = call_ms(torch, lambda: attn.flash_fwd_plain(
            qf, kf, vf, causal, scale, sq_, skv, out_f32=True), reps=3, warmup=1)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sd_kw = ({"attn_mask": (sq_[:, :, None] == skv[:, None, :])[:, None]}
                 if skv is not None else {"is_causal": causal})
        row["k1_sdpa_ms"] = call_ms(torch, sdpa(torch, qt, kt, vt, **sd_kw))
        if "k2_bound_ms" in row:
            ob = out.to(bf16)
            row["bwd_plain_ms"] = call_ms(torch, lambda: attn.flash_bwd_plain(
                qf, kf, vf, ob.float(), lse, dof, causal, scale, sq_, skv,
                grads_f32=True), reps=3, warmup=1)
            qg, kg, vg = (x.requires_grad_() for x in (qt.clone(), kt.clone(), vt.clone()))
            o_sdpa = torch.nn.functional.scaled_dot_product_attention(
                qg, kg, vg, enable_gqa=True, **sd_kw)
            dot = do.transpose(1, 2).contiguous()
            row["bwd_sdpa_ms"] = call_ms(torch, lambda: torch.autograd.grad(
                o_sdpa, (qg, kg, vg), dot, retain_graph=True))
            del qg, kg, vg, o_sdpa, dot
        del qt, kt, vt
    del q, k, v, do, qf, kf, vf, dof
    torch.cuda.empty_cache()

    # -- 2. the 4-rank ring at S 8192 -----------------------------------------
    q, k, v, do = rnd(1, s, hq, d), rnd(1, s, hkv, d), rnd(1, s, hkv, d), rnd(1, s, hq, d)
    ring_rows, ring_launches = [], {}
    for packed in (False, True):
        seg = seg_all if packed else None

        def rank_body(ring, seg=seg):
            r = ring.rank
            cut = lambda x: None if x is None else x[:, r * c:(r + 1) * c]  # noqa: E731
            out, lse = ring_mod.ring_flash_forward(cut(q), cut(k), cut(v), cut(seg),
                                                   ring, True, scale)
            return (out, lse) + ring_mod.ring_flash_backward(
                cut(q), cut(k), cut(v), cut(seg), out, lse, cut(do), ring, True, scale)

        def whole(seg=seg):
            out, lse = attn.flash_fwd(q, k, v, True, scale, with_lse=True, segment_ids=seg)
            return (out, lse) + attn.flash_bwd(q, k, v, out, lse, do, True, scale,
                                               segment_ids=seg)

        whole()  # warm: the instances' first launch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = whole()
        torch.cuda.synchronize()
        whole_ms = (time.perf_counter() - t0) * 1e3
        run_thread_ring(n, rank_body)  # warm
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        res = run_thread_ring(n, rank_body)
        torch.cuda.synchronize()
        ring_ms = (time.perf_counter() - t0) * 1e3
        launched = counts()
        want = n + n * (n - 1) // 2
        if set(launched.values()) != {want}:
            fail(f"ring packed={packed}: launches {launched}, expected {want} each "
                 "(the diagonal and the past chunks, all f32)")
        for key, val in launched.items():
            ring_launches[key] = ring_launches.get(key, 0) + val
        # device ms per call of the ring run (every rank's launches) and
        # of the whole sequence's: K1-K3 by instance, and all device
        # events under "" (a substring of every kernel's name)
        ring_k = (k1_instance(d, attn._flash_fwd_config(1, c, hq), packed, True),
                  *k23_instances(packed, True, d))
        whole_k = (k1_instance(d, attn._flash_fwd_config(1, s, hq), packed, False),
                   *k23_instances(packed, False, d))
        t_ring = kernel_ms(torch, lambda: run_thread_ring(n, rank_body), ("",) + ring_k,
                           reps=3)
        t_whole = kernel_ms(torch, whole, ("",) + whole_k, reps=3)
        got = [torch.cat([r_[i] for r_ in res], 2 if i == 1 else 1) for i in range(5)]
        p_out, p_lse, (p_ring, p_whole) = _ring_plain_reference(
            torch, attn, q, k, v, do, seg, c, scale, (got[0], ref[0]))
        plain_ring = (p_out, p_lse) + p_ring
        plain_whole = (p_out, p_lse) + p_whole
        torch.cuda.synchronize()
        row = {"S": s, "ranks": n, "chunk": c, "causal": True,
               "packed_boundary": RING_BOUNDARY if packed else None,
               "ring_ms": ring_ms, "whole_ms": whole_ms,
               "ring_device_ms": t_ring[""], "whole_device_ms": t_whole[""],
               "ring_k1_k3_ms": [t_ring[nm] for nm in ring_k],
               "whole_k1_k3_ms": [t_whole[nm] for nm in whole_k], "launches": launched}
        for i, name in enumerate(("out", "lse", "dq", "dk", "dv")):
            if name == "lse":
                row["lse_err_vs_whole"] = (got[1] - ref[1]).abs().max().item()
                row["lse_err_vs_plain"] = (got[1] - p_lse).abs().max().item()
                row["whole_lse_err_vs_plain"] = (ref[1] - p_lse).abs().max().item()
                continue
            floor = 0.0 if name == "out" else FLASH_BWD_ROW_FLOOR
            row[name + "_rel_vs_whole"] = row_rel_err(got[i], ref[i], floor=floor)
            row[name + "_rel_vs_plain"] = row_rel_err(got[i], plain_ring[i], floor=floor)
            row["whole_" + name + "_rel_vs_plain"] = row_rel_err(ref[i], plain_whole[i],
                                                                 floor=floor)
        lim = {"out": FLASH_REL_TOL, "dq": FLASH_BWD_REL_TOL, "dk": FLASH_BWD_REL_TOL,
               "dv": FLASH_BWD_REL_TOL}
        off = {key: row[key] for name, tol in lim.items()
               for key in (name + "_rel_vs_whole", name + "_rel_vs_plain",
                           "whole_" + name + "_rel_vs_plain") if not row[key] <= tol}
        lse_off = max(row["lse_err_vs_whole"], row["lse_err_vs_plain"]) > FLASH_LSE_TOL
        if off or lse_off:
            fail(f"ring S={s} packed={packed}: {off or row} (limits {lim}, lse "
                 f"{FLASH_LSE_TOL})")
        ring_rows.append(row)
        del res, got, plain_ring, plain_whole, p_ring, p_whole, ref
    del q, k, v, do
    torch.cuda.empty_cache()

    # -- 3. the model through the ring and through Ulysses ------------------
    mesh = build_mesh(MeshConfig())
    cpu_gen = torch.Generator().manual_seed(23)
    ids = torch.randint(0, LlamaConfig().vocab_size, (1, s), generator=cpu_gen).cuda()
    model_rows, grads, model_launches = {}, None, {}

    def loss_fn(state, b):
        return state.model(b["ids"], labels=b["ids"][:, 1:], z_loss=1e-4), {}

    # flash first: the reference of the other two
    for attention in ("flash", "ring", "ulysses"):
        gc.collect()
        torch.cuda.empty_cache()
        cfg = LlamaConfig.llama3_8b(num_layers=RING_MODEL_LAYERS, attention=attention)
        model = LlamaForCausalLM(cfg, device="cuda")
        model.load_params(init_params(cfg, 0, "cuda", dtype=torch.float32))
        if attention != "flash":
            model.use_sequence_parallel(mesh)
        state = create_train_state(model, 3e-4)
        step = make_train_step(loss_fn)
        reset()
        row, losses, t0 = {}, [], time.perf_counter()
        for i in range(RING_MODEL_STEPS):
            m = step(state, {"ids": ids})[1]
            losses.append(float(m["loss"]))
            if i == 0:
                now = {nm: p.grad.detach().clone() for nm, p in model.named_parameters()}
                if grads is None:
                    grads = now
                else:
                    diff = {nm: (now[nm] - grads[nm]).abs().max().item() for nm in now}
                    scale_of = {nm: grads[nm].abs().max().item() for nm in now}
                    worst = max(diff, key=diff.get)
                    row["grad_max_abs_diff"] = diff[worst]
                    row["grad_max_abs_diff_leaf"] = worst
                    row["grad_max_rel_diff"] = max(
                        diff[nm] / max(scale_of[nm], 1e-30) for nm in now)
                    row["grads_bit_equal"] = all(
                        torch.equal(now[nm], grads[nm]) for nm in now)
                    del now
        torch.cuda.synchronize()
        launched = counts()
        model_launches[attention] = launched
        model_rows[attention] = row
        row.update(losses=losses, wall_s=time.perf_counter() - t0, launches=launched)
        if not all(np.isfinite(losses)):
            fail(f"model ({attention}): losses {losses}")
        if launched["flash_fwd"] == 0 or launched["flash_bwd_dq"] == 0 \
                or launched["flash_bwd_dkv"] == 0:
            fail(f"model ({attention}): K1-K3 launches {launched}")
        if attention == "ring" and (launched["flash_fwd_out_f32"] != launched["flash_fwd"]
                                    or launched["flash_bwd_grads_f32"]
                                    != launched["flash_bwd_dq"]):
            fail(f"ring model: not every launch took the f32 instances: {launched}")
        if attention == "ulysses" and launched != model_launches["flash"]:
            fail(f"ulysses model: launches {launched}, not the flash model's "
                 f"{model_launches['flash']}")
        if attention == "flash" and (launched["flash_fwd_out_f32"]
                                     or launched["flash_bwd_grads_f32"]):
            fail(f"flash model: an f32 instance launched: {launched}")
        if attention != "flash":
            first = (losses[0], model_rows["flash"]["losses"][0])
            row["first_losses_equal"] = first[0] == first[1]
            row["first_loss_rel_diff"] = abs(first[0] - first[1]) / abs(first[1])
            if row["first_loss_rel_diff"] > FSDP_DP_LOSS_RTOL \
                    or row["grad_max_rel_diff"] > GRAD_ORACLE_TOL:
                fail(f"{attention} model against flash: {row} (loss "
                     f"rtol {FSDP_DP_LOSS_RTOL}, gradient {GRAD_ORACLE_TOL})")
        del model, state, step
    del grads
    gc.collect()
    torch.cuda.empty_cache()

    # -- 4. llama_train --strategy=fsdp_tp_sp at world size 1 ----------------
    rdzv = Rendezvous({
        "KTPU_PROGRAM": "k8s_tpu_torch.programs.llama_train:main",
        "KTPU_PROGRAM_ARGS": (
            f"--strategy=fsdp_tp_sp --model=llama3-8b --layers={RING_TRAIN_LAYERS} "
            f"--seq_len={RING_TRAIN_SEQ} --batch_size={RING_TRAIN_BATCH} "
            f"--steps={RING_TRAIN_STEPS} --log_every=1 --remat_policy=flash "
            "--fused_ce=1 --lr=3e-4 --data=learnable")})
    reset()
    t0 = time.perf_counter()
    run = run_program(rdzv)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_launches = counts()
    mesh_run = mesh_shape(run["mesh"])
    losses = [l for _, l in run["losses"]]
    want = RING_TRAIN_LAYERS * RING_TRAIN_STEPS
    if mesh_run["seq"] != 1 or run["state"].model.seq is None \
            or run["config"].attention != "flash":
        fail(f"train_fsdp_tp_sp: mesh {mesh_run}, attention {run['config'].attention}")
    if {train_launches[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")} \
            != {want}:
        fail(f"train_fsdp_tp_sp: launches {train_launches}, expected {want} each")
    if len(losses) != RING_TRAIN_STEPS or not all(np.isfinite(losses)):
        fail(f"train_fsdp_tp_sp: losses {losses}")
    train_row = {"mesh": mesh_run, "losses": losses, "wall_s": train_wall,
                 "compile_s": run["compile_s"], "launches": train_launches,
                 "step_ms": [1e3 * t for t in run["step_s"]]}
    del run, rdzv
    gc.collect()
    torch.cuda.empty_cache()

    launches = {}
    for part in (ring_launches, *model_launches.values(), train_launches):
        for key, val in part.items():
            launches[key] = launches.get(key, 0) + val
    emit({"phase": "ring", "shape": "Hq=32 Hkv=8 D=128 bf16", "rel_tol": FLASH_REL_TOL,
          "lse_tol": FLASH_LSE_TOL, "bwd_rel_tol": FLASH_BWD_REL_TOL,
          "row_floor": FLASH_BWD_ROW_FLOOR, "variants": variants,
          "planted_fault_kv_row_dropped_k1_rel_err": fault,
          "ring_S8192": ring_rows, "model": model_rows, "train_fsdp_tp_sp": train_row,
          "launches": launches, "seconds": time.perf_counter() - t_phase,
          "transport": "threads (one per rank) of one process on one card",
          "note": "k*_ms: device ms per call by kernel name (torch.profiler); plain "
                  "and SDPA: CUDA-event walls per call of back-to-back calls; SDPA "
                  "writes bf16, the f32 variants f32; bwd_* compute dq, dk and dv "
                  "together; ring_ms/whole_ms: host walls of forward + backward, "
                  "the ring's 4 ranks taking turns on the one card",
          "card": card})
    return launches, variants


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


def _pcts(xs):
    """(p50, p95) as benches/serving_bench.py takes them (copied)."""
    if len(xs) == 0:
        return 0.0, 0.0
    xs = np.sort(np.asarray(xs))
    return (float(xs[int(0.5 * (len(xs) - 1))]),
            float(xs[int(0.95 * (len(xs) - 1))]))


def itl_pcts(reqs):
    """Inter-token latency p50 / p95 (s) from the requests'
    ``token_times``, as benches/serving_bench.py ``_stream_stats`` takes
    it (copied): each gap between two attributions over the tokens the
    later one delivered, counted once per token."""
    itl = []
    for r in reqs:
        for (t_prev, _), (t_cur, n_cur) in zip(r.token_times, r.token_times[1:]):
            itl.extend([(t_cur - t_prev) / n_cur] * n_cur)
    return _pcts(itl)


def recording_engine(engine_cls):
    """``engine_cls`` keeping every request it hands out in ``finished``
    (their ``token_times`` give the inter-token latencies)."""

    class Recording(engine_cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.finished = []

        def pop_finished(self):
            done = super().pop_finished()
            self.finished.extend(done.values())
            return done

    return Recording


def path_launches(counted, stats, engine):
    """Kernel launches of a serving run: the wrappers' counters over the
    run (eager launches, plus those a capture in the run recorded, which
    ran no kernel) less the captures', plus each replay's launches.
    ``counted`` maps a kernel name to its counter's delta, ``stats`` is
    the engine's stats delta."""
    per = engine.graph_launches or {}
    return {name: n + (stats["graph_replays"] - stats["graph_captures"])
            * per.get(name, 0) for name, n in counted.items()}


def fill_engine_state(torch, engine, depths, seed):
    """Every slot of ``engine`` decoding at ``depths`` (random tokens,
    budgets that outlast the measurement) over a cache of random rows
    (int8 rows and scales of the size int8 quantization makes)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    b, vocab = engine.max_slots, engine.model.config.vocab_size
    engine._tok.copy_(torch.randint(0, vocab, (b,), generator=g, device="cuda"))
    engine._lengths.copy_(torch.tensor(depths, dtype=torch.int32))
    engine._active.fill_(True)
    engine._budget.fill_(1 << 30)
    for t in engine._cache._tensors():
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g, device="cuda",
                                  dtype=torch.int8))
        elif t.dtype == torch.float32:
            t.copy_(torch.rand(t.shape, generator=g, device="cuda") * 0.02 + 0.01)
        else:
            t.copy_(torch.randn(t.shape, generator=g, device="cuda"))


def engine_state(engine):
    return [engine._tok, engine._lengths, engine._active, engine._budget]


def graph_vs_eager(torch, engine):
    """One chunk replayed from the engine's CUDA graph against one eager
    chunk (the module-level ``_decode_chunk``) from a clone of the same
    state and cache: ``{what: number of differing elements}`` over the
    packed array, the state and every cache tensor (rows and scales).
    The engine's first chunk runs eagerly, as it does in serving, then
    the graph is captured."""
    from k8s_tpu_torch.models import KVCache
    from k8s_tpu_torch.serving.engine import _decode_chunk

    engine._run_decode()  # the engine's eager first chunk
    engine._capture()
    cache = engine._cache
    copy = (lambda ts: None if ts is None else [t.clone() for t in ts])  # noqa: E731
    twin = KVCache(copy(cache.keys), copy(cache.values), False,
                   copy(cache.key_scales), copy(cache.value_scales))
    *state, packed = _decode_chunk(
        engine.model, twin, *[t.clone() for t in engine_state(engine)],
        engine._gen, n_steps=engine.decode_chunk,
        temperature=engine.temperature, eos_id=engine.eos_id)
    replayed = engine._run_decode()
    torch.cuda.synchronize()
    if engine.stats["graph_replays"] != 1:
        fail(f"graph_vs_eager: {engine.stats['graph_replays']} replays, not 1")

    def ne(a, b):
        return int((a != b).sum().item())

    diff = {"packed": ne(packed, replayed)}
    for name, a, b in zip(("tok", "lengths", "active", "budget"), state,
                          engine_state(engine)):
        diff[name] = ne(a, b)
    diff["cache"] = sum(ne(a, b) for a, b in zip(twin._tensors(), cache._tensors()))
    return diff


def graph_draws_fresh(torch, engine):
    """Two replays of a sampling engine's graph from the same state: the
    share of (step, slot) tokens that differ (0 if a replay repeated the
    generator's draws)."""
    engine._run_decode()
    engine._capture()
    saved = [t.clone() for t in engine_state(engine)]
    first = engine._run_decode().clone()
    for dst, src in zip(engine_state(engine), saved):
        dst.copy_(src)
    second = engine._run_decode()
    k = engine.decode_chunk
    return (first[1:k + 1] != second[1:k + 1]).float().mean().item()


def chunk_walls(torch, engine, reps: int = 3):
    """Per decode step: the eager chunk's wall over one whole chunk (its
    path is warm: :func:`graph_vs_eager` ran two eager chunks) and the
    graph replay's over ``reps``, each started from the same state
    (every slot active), and one replay's device time (torch.profiler)
    and busy share (that device time over the unprofiled replay wall).
    The engine must hold a captured graph."""
    from k8s_tpu_torch.serving.engine import _decode_chunk

    saved = [t.clone() for t in engine_state(engine)]
    k = engine.decode_chunk

    def restore():
        for dst, src in zip(engine_state(engine), saved):
            dst.copy_(src)

    def eager():
        restore()
        _decode_chunk(engine.model, engine._cache, *engine_state(engine),
                      engine._gen, n_steps=k, temperature=engine.temperature,
                      eos_id=engine.eos_id)

    def replay():
        restore()
        engine._graph.replay()

    walls = {}
    for name, fn, n in (("eager", eager, 1), ("graph", replay, reps)):
        if name == "graph":
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3 / (n * k)
    # one profiled replay: a replay is 32 steps of the 2248 (bf16) or
    # 4503 (int8) device ops a step that decode_profile counts, and the
    # profiler's processing grows with the events it recorded
    device = sum(e.self_device_time_total
                 for e in _profiled(torch, replay, 1)) / 1e3 / k
    restore()
    return {"eager_step_wall_ms": walls["eager"], "graph_step_wall_ms": walls["graph"],
            "graph_step_device_ms": device, "graph_busy_share": device / walls["graph"],
            "profiled_replays": 1}


def phase_decode_chunk_graph(torch, model, card, depths, phase, sampling: bool):
    """The compiled chunk at the decode-profile depths: bit-equality of a
    replay with an eager chunk, the eager and graph walls per step, and
    (``sampling``) fresh draws in consecutive replays at temperature 1."""
    from k8s_tpu_torch.serving import ContinuousBatchingEngine

    t0 = time.perf_counter()
    engine = ContinuousBatchingEngine(model, max_slots=len(depths), decode_chunk=32)
    fill_engine_state(torch, engine, depths, seed=5)
    diff = graph_vs_eager(torch, engine)
    if any(diff.values()):
        fail(f"{phase}: the replayed chunk differs from the eager one: {diff}")
    row = {"phase": phase, "batch": len(depths), "depths": list(depths),
           "decode_chunk": engine.decode_chunk, "bit_equal": True,
           "launches_per_capture": engine.graph_launches,
           **chunk_walls(torch, engine)}
    del engine
    if sampling:
        engine = ContinuousBatchingEngine(model, max_slots=len(depths), decode_chunk=32,
                                          temperature=1.0, seed=3)
        fill_engine_state(torch, engine, depths, seed=5)
        share = graph_draws_fresh(torch, engine)
        if not share > 0:
            fail(f"{phase}: two replays at temperature 1 drew the same tokens")
        row["sampling_replays_differ_share"] = share
        del engine
    gc.collect()
    torch.cuda.empty_cache()
    row.update(seconds=time.perf_counter() - t0, card=card)
    emit(row)
    return row


# the streams whose inter-token latency the serving phases report: each
# request's 128 tokens span several 32-step chunks (a 32-token request
# arrives in one attribution and has no inter-token gap to measure)
ITL_NEW_TOKENS = 128


def burst(port, prompts, new_tokens):
    """Post every prompt at once, one client thread each: the
    responses (None where a client failed), the start time and the wall
    until the last response."""
    results = [None] * len(prompts)

    def client(i):
        results[i] = post(port, {"prompt": prompts[i], "max_new_tokens": new_tokens})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
    t1 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return results, t1, time.perf_counter() - t1


def itl_burst(port, engine, prompts):
    """One long stream per slot (``ITL_NEW_TOKENS`` each): their
    responses and their inter-token latency p50 / p95 in ms, from the
    engine's ``token_times``."""
    results, t1, wall = burst(port, prompts, ITL_NEW_TOKENS)
    p50, p95 = itl_pcts([r for r in engine.finished if r.submitted_at >= t1])
    return results, {"itl_requests": len(prompts), "itl_new_tokens": ITL_NEW_TOKENS,
                     "itl_wall_s": wall, "itl_p50_ms": 1e3 * p50,
                     "itl_p95_ms": 1e3 * p95}


def decode_rates(stats, decoded: int) -> dict:
    """Decode rates of a serving run from the engine's stats delta:
    ``decode_step_wall_ms`` and ``decode_tokens_per_s`` over the wall
    time in which a chunk was in flight (``decode_wall_s``), and
    ``decode_step_ms``, each chunk's dispatch-to-attribution latency per
    step (``chunk_s``; chunks in flight together both count their
    overlap, so with pipeline_depth > 1 it is not the step's wall)."""
    return {"decode_tokens_per_s": decoded / stats["decode_wall_s"],
            "decode_step_wall_ms": 1e3 * stats["decode_wall_s"] / stats["decode_steps"],
            "decode_step_ms": 1e3 * stats["chunk_s"] / stats["decode_steps"]}


# the serving features' cells: a 512-token shared prefix (an LRU of 8
# snapshots) and self-speculative decode with up to 4 drafts a round
PREFIX_TOKENS, PREFIX_MAX, SPEC_K = 512, 8, 4


def served_by(engine, fn):
    """``fn(frontend)`` with ``engine`` behind a ServingFrontend and its
    pump thread; the pump is stopped (the engine drained and closed)
    before the result is returned."""
    from k8s_tpu_torch.serving import ServingFrontend

    frontend = ServingFrontend(engine, port=0)
    stop = threading.Event()
    pump = threading.Thread(target=frontend.serve, args=(stop.is_set,))
    pump.start()
    try:
        return fn(frontend)
    finally:
        stop.set()
        pump.join(timeout=300)
        if pump.is_alive():
            fail("serving: the front-end's pump did not stop")


def forced_gap(torch, model, prompt, toks):
    """(worst gap, exact count) of ``toks`` against one teacher-forced
    forward through the plain attention path (a warm cache of its own
    takes _cached_attention), so no kernel runs on the oracle's side."""
    dev = model.device
    ids = torch.tensor([prompt + toks], dtype=torch.long, device=dev)
    cache = model.new_cache(1)
    cache.fresh = False
    hidden, _ = model(ids, positions=torch.arange(ids.shape[1], device=dev)[None],
                      cache=cache, return_hidden=True)
    del cache
    logits = model.lm_head_logits(hidden[0, len(prompt) - 1:len(prompt) - 1 + len(toks)])
    if not torch.isfinite(logits).all():
        fail("serving: non-finite logits in the oracle forward")
    tok_t = torch.tensor(toks, device=dev)
    gap = logits.max(-1).values - logits.gather(1, tok_t[:, None])[:, 0]
    return gap.max().item(), int((logits.argmax(-1) == tok_t).sum().item())


def gauge(metrics_text: str, name: str) -> float:
    """The value of an unlabelled series in a /metrics body."""
    for line in metrics_text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    fail(f"serving: /metrics has no {name}")


def counted_launches(attn):
    return {"flash_fwd": attn.flash_fwd.launches,
            "decode_attn": attn.decode_attention_update.launches,
            "decode_attn_q8": attn.decode_attention_update_q8.launches}


def zero_launches(attn):
    attn.flash_fwd.launches = 0
    attn.decode_attention_update.launches = 0
    attn.decode_attention_update_q8.launches = 0


def drive_counted(attn, engine, fn):
    """``fn()`` with the launch counts set to 0 just before and read just
    after: ``(fn's result, the path's launches, the stats delta)``."""
    stats0 = dict(engine.stats)
    zero_launches(attn)
    out = fn()
    counted = counted_launches(attn)
    stats = {k: v - stats0.get(k, 0) for k, v in engine.stats.items()
             if k != "queue_depth"}
    return out, path_launches(counted, stats, engine), stats


def serving_prefix(torch, attn, model, card, engine_kw, gap_fn, tol, what,
                   suffix_lens=(40, 88, 137, 190, 245, 300, 350, 400), baseline=None):
    """The shared-prefix cache on the card: a seeded 512-token prefix and
    seeded suffixes of ``suffix_lens`` tokens, 32 new tokens each, behind
    the HTTP front-end: the first request alone (a miss, which captures),
    the others at once (hits), the first again (a hit, bit-equal to the
    miss). With ``baseline`` (the running front-end of a prefix-off
    engine of the same sizes over the same model): then the same
    requests there, and the snapshot fetched over GET
    /v1/prefix/<digest>, unpacked and installed into another engine,
    whose first request on the prompt must be a hit with the first
    engine's tokens. ``gap_fn(prompt, toks)`` is
    the oracle's (worst gap, exact count) of a request, ``tol`` its
    limit."""
    from k8s_tpu_torch.serving import ContinuousBatchingEngine
    from k8s_tpu_torch.serving.kv_transfer import unpack_kv

    t_new = time.perf_counter()
    cfg = model.config
    rng = np.random.RandomState(19)
    prefix = rng.randint(0, cfg.vocab_size, size=PREFIX_TOKENS).tolist()
    suffix_lens = list(suffix_lens)
    prompts = [prefix + rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in suffix_lens]
    warm = rng.randint(0, cfg.vocab_size, size=20).tolist()
    new = 32

    def sequence(fe):
        # the warm-up's 2 chunks: the eager first one, then the capture
        post(fe.port, {"prompt": warm, "max_new_tokens": 40})
        eng = fe.engine

        def run():
            t1 = time.perf_counter()
            first = post(fe.port, {"prompt": prompts[0], "max_new_tokens": new})
            rest, _, _ = burst(fe.port, prompts[1:], new)
            again = post(fe.port, {"prompt": prompts[0], "max_new_tokens": new})
            return [first] + rest + [again], time.perf_counter() - t1

        (results, wall), launches, stats = drive_counted(attn, eng, run)
        extra = {}
        if eng.prefix_cache_tokens and baseline is not None:
            digest = eng.prefix_digest(prompts[0])
            t0 = time.perf_counter()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{fe.port}/v1/prefix/{digest}", timeout=300) as r:
                extra["body"] = r.read()
            extra["get_s"] = time.perf_counter() - t0
            extra["digest"] = digest
        if eng.prefix_cache_tokens:
            extra["metrics"] = get_url(fe.port, "/metrics")
        return results, wall, launches, stats, extra

    kw = dict(engine_kw, prefix_cache_tokens=PREFIX_TOKENS, prefix_cache_max=PREFIX_MAX)
    engine = ContinuousBatchingEngine(model, **kw)
    results, wall, launches, stats, extra = served_by(engine, sequence)
    if any(r is None for r in results):
        fail(f"{what}: a request did not finish")
    snap_bytes = sum(snap.nbytes() for _, snap in engine._prefix_cache.values())
    q8 = cfg.kv_quant == "int8"
    rows = cfg.num_kv_heads * PREFIX_TOKENS
    want_bytes = cfg.num_layers * 2 * rows * (
        cfg.head_dim * (1 if q8 else 2) + (4 if q8 else 0))
    held = engine.stats["prefix_cache_bytes"]
    metric_bytes = gauge(extra["metrics"], "ktpu_serving_prefix_cache_bytes")
    if (stats["prefix_captures"], stats["prefix_hits"], stats["prefix_tokens_saved"]) \
            != (1, len(prompts), PREFIX_TOKENS * len(prompts)):
        fail(f"{what}: prefix counters {stats}")
    if not held == snap_bytes == want_bytes == metric_bytes:
        fail(f"{what}: prefix_cache_bytes {held}, snapshots {snap_bytes}, expected "
             f"{want_bytes}, /metrics {metric_bytes}")
    toks = [r["tokens"] for r in results]
    if toks[-1] != toks[0]:
        fail(f"{what}: the repeated prompt's hit differs from its miss")
    for t in toks:
        if len(t) != new:
            fail(f"{what}: {len(t)} tokens for a {new}-token request")
    # every prompt here is chunked (the continuation path, plain
    # attention): the decode kernel must run, K1 is recorded
    decode = "decode_attn_q8" if q8 else "decode_attn"
    if launches[decode] <= 0:
        fail(f"{what}: kernel {decode} never launched: {launches}")
    del engine
    gc.collect()
    gaps, exact = zip(*(gap_fn(p, t) for p, t in zip(prompts + [prompts[0]], toks)))
    if max(gaps) > tol:
        fail(f"{what} oracle: emitted-token gap {max(gaps)} (tol {tol}): {gaps}")
    row = {"phase": what, "model": "llama3_8b", "layers": cfg.num_layers,
           "kv_quant": cfg.kv_quant, "quant": cfg.quant,
           "max_seq_len": cfg.max_seq_len, "max_slots": engine_kw["max_slots"],
           "prefix_cache_tokens": PREFIX_TOKENS, "prefix_cache_max": PREFIX_MAX,
           "suffix_lens": suffix_lens, "new_tokens": new,
           "requests": len(results),
           "order": "the first alone (miss), the others at once (hits), the "
                    "first again (hit)",
           "counters": {k: stats[k] for k in (
               "prefix_captures", "prefix_hits", "prefix_misses",
               "prefix_tokens_saved", "prefill_tokens", "prefill_chunks")},
           "prefix_cache_bytes": held, "metrics_prefix_cache_bytes": metric_bytes,
           "repeat_bit_equal_to_miss": True,
           "ttft_miss_s": results[0]["ttft_s"],
           "ttft_hits_p50_s": float(np.median([r["ttft_s"] for r in results[1:]])),
           "wall_s": wall, "oracle_max_gap": max(gaps), "oracle_tol": tol,
           "oracle_exact_share": sum(exact) / (new * len(toks)),
           "launches": launches}
    if baseline is None:
        row.update(seconds=time.perf_counter() - t_new, card=card)
        emit(row)
        return launches, row["seconds"]

    off_results, off_wall, off_launches, off_stats, _ = sequence(baseline)
    if any(r is None for r in off_results):
        fail(f"{what}: a request on the prefix-off engine did not finish")
    if not stats["prefill_tokens"] < off_stats["prefill_tokens"]:
        fail(f"{what}: prefill_tokens {stats['prefill_tokens']} not below the "
             f"prefix-off engine's {off_stats['prefill_tokens']}")

    # the prefix directory on one card: the fetched snapshot installed
    # into another engine over the same model
    t0 = time.perf_counter()
    meta, leaves = unpack_kv(extra["body"])
    unpack_s = time.perf_counter() - t0
    dest = ContinuousBatchingEngine(model, **kw)
    t0 = time.perf_counter()
    dest.install_prefix(meta, leaves)
    torch.cuda.synchronize()
    install_s = time.perf_counter() - t0
    dest.submit(prompts[1][:20], 40)  # warm-up: the eager chunk, the capture
    dest.run()
    stats0 = dict(dest.stats)
    rid = dest.submit(prompts[0], new)
    installed = dest.run()[rid].tolist()
    dest_hits = dest.stats["prefix_hits"] - stats0["prefix_hits"]
    if dest.stats["prefix_installs"] != 1 or dest_hits != 1 \
            or dest.stats["prefix_captures"] != 0:
        fail(f"{what}: the installed prefix was not hit: {dest.stats}")
    if installed != toks[0]:
        fail(f"{what}: the installed prefix's tokens differ from the first engine's")
    dest.close()
    del dest, leaves
    gc.collect()
    off_ttft = [r["ttft_s"] for r in off_results[1:]]
    row.update({
        "prefill_tokens_prefix_off": off_stats["prefill_tokens"],
        "ttft_same_prompts_prefix_off_p50_s": float(np.median(off_ttft)),
        "ttft_first_prompt_prefix_off_s": off_results[0]["ttft_s"],
        "wall_prefix_off_s": off_wall,
        "tokens_equal_prefix_off_share": float(np.mean(
            [a == r["tokens"] for a, r in zip(toks, off_results)])),
        "directory": {"digest": extra["digest"], "body_bytes": len(extra["body"]),
                      "get_s": extra["get_s"], "unpack_s": unpack_s,
                      "install_s": install_s, "installed_hit_bit_equal": True},
        "launches_prefix_off": off_launches,
        "seconds": time.perf_counter() - t_new, "card": card})
    emit(row)
    return launches, row["seconds"]


def verify_round_ms(torch, engine, depth: int, reps: int = 5):
    """One verify round of ``engine`` as its spec pump runs it
    (``engine._verify``: the graph replay, inputs copied in and the
    greedy tokens copied out), every slot at ``depth`` with K + 1 seeded
    tokens: its wall (host clock) and device time (CUDA events), each
    the median of ``reps``."""
    b, k = engine.max_slots, engine.spec_decode_k
    rng = np.random.RandomState(7)
    x = rng.randint(0, engine.model.config.vocab_size, size=(b, k + 1)).astype(np.int64)
    pos = (depth + np.arange(k + 1, dtype=np.int64))[None].repeat(b, 0)
    engine._verify(x, pos)
    torch.cuda.synchronize()
    walls, dev = [], []
    for _ in range(reps):
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        engine._verify(x, pos)
        z.record()
        z.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        dev.append(a.elapsed_time(z))
    return float(np.median(walls)), float(np.median(dev))


def serving_spec(torch, attn, model, card, engine_kw, gap_fn, tol, what,
                 n_blocks=8, baseline=None):
    """Self-speculative decode on the card (greedy, up to SPEC_K drafts):
    ``n_blocks`` prompts each repeating a seeded 64-token block 4 times
    (so n-gram drafts exist), 64 new tokens each, behind the HTTP
    front-end, every token against the oracle. With ``baseline`` (the
    running front-end of a non-spec engine of the same sizes over the
    same model): also one prompt of ``max_seq - 64`` tokens, whose last
    rows take the plain fallback round (a decode chunk, the decode
    kernel), and the same requests there for the wall per emitted
    token."""
    from k8s_tpu_torch.serving import ContinuousBatchingEngine

    t_new = time.perf_counter()
    full = baseline is not None
    cfg = model.config
    rng = np.random.RandomState(23)
    new = 64
    prompts = [rng.randint(0, cfg.vocab_size, size=64).tolist() * 4
               for _ in range(n_blocks)]
    if full:
        prompts.append(rng.randint(0, cfg.vocab_size,
                                   size=cfg.max_seq_len - new).tolist())
    warm = rng.randint(0, cfg.vocab_size, size=20).tolist()

    def sequence(fe):
        post(fe.port, {"prompt": warm, "max_new_tokens": 8})
        eng = fe.engine

        def run():
            results, _, wall = burst(fe.port, prompts, new)
            return results, wall

        (results, wall), launches, stats = drive_counted(attn, eng, run)
        return results, wall, launches, stats, get_url(fe.port, "/metrics")

    engine = ContinuousBatchingEngine(model, **engine_kw, spec_decode_k=SPEC_K)
    results, wall, launches, stats, metrics = served_by(engine, sequence)
    if any(r is None for r in results):
        fail(f"{what}: a request did not finish")
    q8 = cfg.kv_quant == "int8"
    decode = "decode_attn_q8" if q8 else "decode_attn"
    if not (stats["spec_decode_rounds"] > 0 and stats["spec_decode_drafted"] > 0
            and (stats["spec_decode_fallbacks"] > 0 or not full)):
        fail(f"{what}: spec counters {stats}")
    if full and launches[decode] <= 0:
        fail(f"{what}: {decode} did not launch in the fallback rounds: {launches}")
    for key, series in (("spec_decode_rounds", "ktpu_serving_spec_decode_rounds"),
                        ("spec_decode_drafted", "ktpu_serving_spec_decode_drafted"),
                        ("spec_decode_accepted", "ktpu_serving_spec_decode_accepted")):
        if gauge(metrics, series) != engine.stats[key]:
            fail(f"{what}: /metrics {series} {gauge(metrics, series)} != "
                 f"stats {engine.stats[key]}")
    verify_wall_ms, verify_device_ms = verify_round_ms(torch, engine, 300)
    del engine
    gc.collect()
    toks = [r["tokens"] for r in results]
    for t in toks:
        if len(t) != new:
            fail(f"{what}: {len(t)} tokens for a {new}-token request")
    gaps, exact = zip(*(gap_fn(p, t) for p, t in zip(prompts, toks)))
    if max(gaps) > tol:
        fail(f"{what} oracle: emitted-token gap {max(gaps)} (tol {tol}): {gaps}")

    n_tok = new * len(prompts)
    decoded = n_tok - len(prompts)
    row = {}
    if full:
        plain_results, plain_wall, plain_launches, _, _ = sequence(baseline)
        row = {"wall_non_spec_s": plain_wall,
               "wall_per_token_non_spec_ms": 1e3 * plain_wall / n_tok,
               "tokens_equal_non_spec_share": float(np.mean(
                   [a == r["tokens"] for a, r in zip(toks, plain_results)])),
               "launches_non_spec": plain_launches}
    emit({"phase": what, "model": "llama3_8b", "layers": cfg.num_layers,
          "kv_quant": cfg.kv_quant, "quant": cfg.quant, "max_seq_len": cfg.max_seq_len,
          "max_slots": engine_kw["max_slots"], "spec_decode_k": SPEC_K,
          "requests": len(prompts), "prompt_lens": [len(p) for p in prompts],
          "new_tokens": new,
          "counters": {k: stats[k] for k in ("spec_decode_rounds", "spec_decode_drafted",
                                             "spec_decode_accepted",
                                             "spec_decode_fallbacks")},
          "accepted_share": stats["spec_decode_accepted"] / stats["spec_decode_drafted"],
          "decoded_tokens_per_verify_round": decoded / stats["spec_decode_rounds"],
          "verify_round_wall_ms": verify_wall_ms,
          "verify_round_device_ms": verify_device_ms, "verify_depth": 300,
          "wall_s": wall, "wall_per_token_ms": 1e3 * wall / n_tok, **row,
          "oracle_max_gap": max(gaps), "oracle_tol": tol,
          "oracle_exact_share": sum(exact) / n_tok, "launches": launches,
          "seconds": time.perf_counter() - t_new, "card": card})
    return launches, time.perf_counter() - t_new


def add_launches(*dicts):
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


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
    engine = recording_engine(ContinuousBatchingEngine)(
        model, max_slots=8, decode_chunk=32, prompt_buckets=buckets,
        prefill_chunk=256, pipeline_depth=2)
    frontend = ServingFrontend(engine, port=0)
    stop = threading.Event()
    pump = threading.Thread(target=frontend.serve, args=(stop.is_set,))
    pump.start()
    rng = np.random.RandomState(0)
    lens = [12, 40, 97, 160, 256, 257, 300, 513, 700, 1000]
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in lens]
    itl_prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
                   for n in (16, 33, 64, 100, 150, 200, 256, 300)]
    engine_kw = dict(max_slots=8, decode_chunk=32, prompt_buckets=buckets,
                     prefill_chunk=256, pipeline_depth=2)

    def gap_fn(p, toks):
        return forced_gap(torch, model, p, toks)

    features = {}
    try:
        post(frontend.port, {"prompt": prompts[0][:20], "max_new_tokens": 4})  # warm-up
        stats0 = dict(engine.stats)
        attn.flash_fwd.launches = 0
        attn.decode_attention_update.launches = 0
        results, t1, wall = burst(frontend.port, prompts, new_tokens)
        counted = {"flash_fwd": attn.flash_fwd.launches,
                   "decode_attn": attn.decode_attention_update.launches}
        stats = {k: v - stats0.get(k, 0) for k, v in engine.stats.items()
                 if k != "queue_depth"}
        itl_results, itl = itl_burst(frontend.port, engine, itl_prompts)
        # the prefix cache and speculative decode over the same model,
        # each beside this engine (prefix off, no drafts) on the same
        # requests
        features["serving_prefix"], prefix_s = serving_prefix(
            torch, attn, model, card, engine_kw, gap_fn, ORACLE_LOGIT_TOL,
            "serving_prefix", baseline=frontend)
        features["serving_spec"], spec_s = serving_spec(
            torch, attn, model, card, engine_kw, gap_fn, ORACLE_LOGIT_TOL,
            "serving_spec", baseline=frontend)
    finally:
        stop.set()
        pump.join(timeout=300)
    counted_all = {"flash_fwd": attn.flash_fwd.launches,
                   "decode_attn": attn.decode_attention_update.launches}
    if pump.is_alive() or any(r is None for r in results + itl_results):
        fail("serving: a request or the pump did not finish")
    launches = path_launches(counted, stats, engine)
    for name, n in launches.items():
        if n <= 0:
            fail(f"serving: kernel {name} never launched on the main path")
    if stats["graph_replays"] <= 0:
        fail("serving: no decode chunk replayed the CUDA graph")

    # oracle: one teacher-forced forward per request through the plain
    # attention path (a warm cache of its own takes _cached_attention),
    # so neither kernel runs on the oracle's side and a kernel fault
    # cannot cancel out
    gaps, exact = [], 0
    served = [(p, r, new_tokens) for p, r in zip(prompts, results)]
    served += [(p, r, ITL_NEW_TOKENS) for p, r in zip(itl_prompts, itl_results)]
    for p, r, n in served:
        toks = r["tokens"]
        if len(toks) != n:
            fail(f"serving: {len(toks)} tokens for a {n}-token request")
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
    oracle_launches = (attn.flash_fwd.launches, attn.decode_attention_update.launches)
    if oracle_launches != tuple(counted_all.values()):
        fail("serving oracle: a kernel launched on the oracle's plain path")
    if worst > ORACLE_LOGIT_TOL:
        fail(f"serving oracle: emitted-token logit {worst} below the row max "
             f"(tol {ORACLE_LOGIT_TOL})")
    n_tok = new_tokens * len(prompts)
    n_served = sum(n for _, _, n in served)
    ttfts = sorted(r["ttft_s"] for r in results)
    emit({
        "phase": "serving", "model": "llama3_8b", "layers": cfg.num_layers,
        "vocab": cfg.vocab_size, "dtype": "bfloat16", "max_seq_len": max_seq,
        "max_slots": 8, "decode_chunk": 32, "prefill_chunk": 256,
        "pipeline_depth": engine.pipeline_depth,
        "requests": len(prompts), "prompt_lens": lens, "new_tokens": new_tokens,
        "load_s": load_s, "wall_s": wall, "tokens_per_s": n_tok / wall,
        **decode_rates(stats, n_tok - len(prompts)),
        "ttft_p50_s": float(np.median(ttfts)), "ttft_max_s": ttfts[-1], **itl,
        "graph_replays": stats["graph_replays"],
        "launches_per_replay": engine.graph_launches,
        "oracle_max_gap": worst, "oracle_tol": ORACLE_LOGIT_TOL,
        "oracle_tokens": n_served, "oracle_exact_share": exact / n_served,
        "launches": launches,
        "launches_counted": counted, "engine_stats": stats, "card": card,
    })
    del engine, frontend
    gc.collect()
    phase_decode_chunk_graph(torch, model, card, SERVING_DEPTHS,
                             "decode_chunk_graph", sampling=True)
    phase_decode_profile(torch, model, card, SERVING_DEPTHS)
    # free the serving model (16 GB) and its caches before training
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, features, prefix_s + spec_s


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
    engine = recording_engine(ContinuousBatchingEngine)(
        model, max_slots=slots, decode_chunk=32, prompt_buckets=buckets,
        prefill_chunk=256, pipeline_depth=2)
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
    itl_prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
                   for n in (16, 33, 64, 100, 150, 200, 256, 300, 350, 400,
                             450, 500, 20, 40, 80, 120)]
    try:
        post(frontend.port, {"prompt": prompts[0][:20], "max_new_tokens": 4})  # warm-up
        stats0 = dict(engine.stats)
        attn.flash_fwd.launches = 0
        attn.decode_attention_update.launches = 0
        attn.decode_attention_update_q8.launches = 0
        results, t1, wall = burst(frontend.port, prompts, new_tokens)
        counted = {"flash_fwd": attn.flash_fwd.launches,
                   "decode_attn": attn.decode_attention_update.launches,
                   "decode_attn_q8": attn.decode_attention_update_q8.launches}
        stats = {k: v - stats0.get(k, 0) for k, v in engine.stats.items()
                 if k != "queue_depth"}
        itl_results, itl = itl_burst(frontend.port, engine, itl_prompts)
    finally:
        stop.set()
        pump.join(timeout=300)
    if pump.is_alive() or any(r is None for r in results + itl_results):
        fail("serving_int8: a request or the pump did not finish")
    launches = path_launches(counted, stats, engine)
    if launches["decode_attn_q8"] <= 0 or launches["flash_fwd"] <= 0:
        fail(f"serving_int8: a kernel of the path never launched: {launches}")
    if launches["decode_attn"] != 0:
        fail(f"serving_int8: the bf16 decode kernel ran over the int8 cache: {launches}")
    if stats["graph_replays"] <= 0:
        fail("serving_int8: no decode chunk replayed the CUDA graph")
    serve_peak = torch.cuda.max_memory_allocated()
    pipeline_depth, per_replay = engine.pipeline_depth, engine.graph_launches
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
    for p, r in zip(itl_prompts, itl_results):  # the long streams: gaps only
        toks = r["tokens"]
        if len(toks) != ITL_NEW_TOKENS:
            fail(f"serving_int8: {len(toks)} tokens for a {ITL_NEW_TOKENS}-token request")
        logits = _forced_logits(torch, model, p, toks)
        if not torch.isfinite(logits).all():
            fail("serving_int8: non-finite logits in the oracle forward")
        gaps.append(gap(logits, toks).max().item())
        exact += int((logits.argmax(-1) == torch.tensor(toks, device="cuda")).sum().item())
    worst = max(gaps)
    fault_worst = {k: max(v) for k, v in faults.items()}
    if worst > ORACLE_Q8_LOGIT_TOL or not min(fault_worst.values()) > ORACLE_Q8_LOGIT_TOL:
        fail(f"serving_int8 oracle: emitted-token gap {worst} (tol "
             f"{ORACLE_Q8_LOGIT_TOL}, per request {gaps}); each planted fault's "
             f"worst gap must exceed it: {faults}")
    # the prefix cache (a miss, then a hit) and one speculative request
    # over the same int8 model
    engine_kw = dict(max_slots=slots, decode_chunk=32, prompt_buckets=buckets,
                     prefill_chunk=256, pipeline_depth=2)

    def gap_fn(p, toks):
        logits = _forced_logits(torch, model, p, toks)
        tok_t = torch.tensor(toks, device="cuda")
        return (gap(logits, toks).max().item(),
                int((logits.argmax(-1) == tok_t).sum().item()))

    features = {}
    features["serving_prefix_int8"], prefix_s = serving_prefix(
        torch, attn, model, card, engine_kw, gap_fn, ORACLE_Q8_LOGIT_TOL,
        "serving_prefix_int8", suffix_lens=(100,))
    features["serving_spec_int8"], spec_s = serving_spec(
        torch, attn, model, card, engine_kw, gap_fn, ORACLE_Q8_LOGIT_TOL,
        "serving_spec_int8", n_blocks=1)
    phase_decode_chunk_graph(torch, model, card, SERVING_DEPTHS_INT8,
                             "decode_chunk_graph_int8", sampling=False)
    step_device_ms = phase_decode_profile(torch, model, card, SERVING_DEPTHS_INT8,
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
    n_served = n_tok + ITL_NEW_TOKENS * len(itl_prompts)
    ttfts = sorted(r["ttft_s"] for r in results)
    emit({
        "phase": "serving_int8", "model": "llama3_8b", "layers": cfg.num_layers,
        "vocab": cfg.vocab_size, "quant": cfg.quant, "kv_quant": cfg.kv_quant,
        "max_seq_len": max_seq, "max_slots": slots, "decode_chunk": 32,
        "prefill_chunk": 256, "pipeline_depth": pipeline_depth,
        "requests": len(prompts), "prompt_lens": lens,
        "new_tokens": new_tokens, "load_s": load_s, "wall_s": wall,
        "tokens_per_s": n_tok / wall,
        **decode_rates(stats, n_tok - len(prompts)),
        "decode_step_device_ms": step_device_ms,
        "ttft_p50_s": float(np.median(ttfts)), "ttft_max_s": ttfts[-1], **itl,
        "graph_replays": stats["graph_replays"], "launches_per_replay": per_replay,
        "weight_bytes": weight_bytes, "bf16_weight_bytes": bf16_weight_bytes,
        "kv_bytes": kv_bytes, "bf16_kv_bytes": bf16_kv_bytes,
        "load_peak_gb": load_peak / 1e9, "serve_peak_gb": serve_peak / 1e9,
        "oracle_max_gap": worst, "oracle_tol": ORACLE_Q8_LOGIT_TOL,
        "oracle_tokens": n_served, "oracle_exact_share": exact / n_served,
        "planted_faults_worst_gap": fault_worst,
        "planted_faults_per_request": faults,
        "int8_vs_bf16": {"max_abs_logit_diff": max(diffs),
                         "top1_agreement": agree / n_tok,
                         "bf16_gap_of_int8_tokens_max": max(bf16_gaps)},
        "launches": launches, "launches_counted": counted, "engine_stats": stats,
        "card": card,
    })
    return launches, features, prefix_s + spec_s


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


def median_phases(events):
    """Median of each phase's ms over ``step_phases`` events."""
    keys = sorted({k for e in events for k in e["phases_ms"]})
    return {k: statistics.median(e["phases_ms"].get(k, 0.0) for e in events)
            for k in keys}


def phase_train(torch, attn, card):
    """The training path through the launcher's API, in process: a
    ``Rendezvous`` of a dict env naming ``programs.llama_train:main``
    and ``run_program``, as ``spmd_launcher.main`` runs it (the device
    comes from the rendezvous; the tracer is on, its default). Llama-3-8B
    width, 8 layers, seq 2048, batch 8, flash remat, fused CE, lr 3e-4,
    learnable data, 10 steps; then a gradient oracle and one profiled
    step."""
    from k8s_tpu_torch.data import learnable_token_batches
    from k8s_tpu_torch.launcher.spmd_launcher import Rendezvous, run_program
    from k8s_tpu_torch.models import LlamaConfig, LlamaForCausalLM, init_params
    from k8s_tpu_torch.programs import llama_train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    layers, steps = TRAIN_LAYERS, TRAIN_STEPS
    rdzv = Rendezvous({
        "KTPU_PROGRAM": "k8s_tpu_torch.programs.llama_train:main",
        "KTPU_PROGRAM_ARGS": (
            f"--strategy=dp --model=llama3-8b --layers={layers} --seq_len={TRAIN_SEQ} "
            f"--batch_size={TRAIN_BATCH} --steps={steps} --log_every=1 "
            "--remat_policy=flash --fused_ce=1 --lr=3e-4 --data=learnable")})
    if rdzv.device != "cuda":
        fail(f"train: the rendezvous chose device {rdzv.device!r}")
    attn.flash_fwd.launches = 0
    attn.flash_bwd.launches_dq = attn.flash_bwd.launches_dkv = 0
    t0 = time.perf_counter()
    run = run_program(rdzv)
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
    phases = run["step_phases"]
    if [e["step"] for e in phases] != list(range(1, steps + 1)) \
            or "compile" not in phases[0]["phases_ms"]:
        fail(f"train: step_phases {phases}")
    tracer_ms = 1e3 * run["tracer"].overhead_s / steps
    dp = {"layers": layers, "losses": [l for _, l in run["losses"]],
          "step_ms_median_3_10": step_ms, "tokens_per_s": tokens_per_s,
          "mfu_6nd": 6 * n_params * tokens_per_s / PEAK_BF16_FLOPS,
          "peak_mem_gb": peak / 1e9, "mesh_s": run["mesh_s"],
          "backend": _backend()}
    profile = _profile_train_step(torch, run)
    emit({"phase": "train", "model": "llama3_8b", "layers": layers,
          "seq_len": TRAIN_SEQ, "batch": TRAIN_BATCH, "steps": steps,
          "remat_policy": "flash", "fused_ce": True, "lr": 3e-4,
          "path": "Rendezvous + run_program (in process), tracer on",
          "n_params": n_params, "first_loss": run["first_loss"],
          "final_loss": run["final_loss"], "convergence_ratio": ratio,
          "step_ms_median_3_10": step_ms,
          "step_ms": [1e3 * t for t in run["step_s"]],
          "tokens_per_s": tokens_per_s,
          "mfu_6nd": 6 * n_params * tokens_per_s / PEAK_BF16_FLOPS,
          "peak_mem_gb": peak / 1e9, "wall_s": wall, "launches": launches,
          "compile_s": run["compile_s"],
          "tracer_overhead_ms_per_step": tracer_ms,
          "phases_ms_median_3_10": median_phases(phases[2:]),
          "step_phases_wall_ms_median_3_10":
              statistics.median(e["wall_ms"] for e in phases[2:]),
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
    return launches, tracer_ms, dp


def _backend():
    import torch.distributed as dist

    return dist.get_backend() if dist.is_initialized() else None


def phase_train_fsdp(torch, attn, card, dp):
    """``llama_train --strategy=fsdp`` through the launcher's API in
    process, as :func:`phase_train` runs ``dp``: the same model, depth,
    data, seed and steps, at world size 1 on the one-process NCCL group
    that ``build_mesh`` joined (in the first training phase), FSDP2
    ``fully_shard`` on every block and the root. Checks the backend, the
    wrapping, K1-K3 launched layers x steps times each, the loss falling
    and the first 3 losses within ``FSDP_DP_LOSS_RTOL`` of ``dp``'s (at
    world size 1 both compute the same gradients); reports step time,
    tokens/s, MFU and peak memory beside ``dp``'s, and the group's
    NCCL init seconds."""
    import torch.distributed as dist
    from torch.distributed.fsdp import FSDPModule

    from k8s_tpu_torch.launcher.spmd_launcher import Rendezvous, run_program
    from k8s_tpu_torch.parallel import mesh as pmesh

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    layers, steps = dp["layers"], TRAIN_STEPS
    rdzv = Rendezvous({
        "KTPU_PROGRAM": "k8s_tpu_torch.programs.llama_train:main",
        "KTPU_PROGRAM_ARGS": (
            f"--strategy=fsdp --model=llama3-8b --layers={layers} "
            f"--seq_len={TRAIN_SEQ} --batch_size={TRAIN_BATCH} --steps={steps} "
            "--log_every=1 --remat_policy=flash --fused_ce=1 --lr=3e-4 "
            "--data=learnable")})
    attn.flash_fwd.launches = 0
    attn.flash_bwd.launches_dq = attn.flash_bwd.launches_dkv = 0
    t0 = time.perf_counter()
    run = run_program(rdzv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": attn.flash_fwd.launches,
                "flash_bwd_dq": attn.flash_bwd.launches_dq,
                "flash_bwd_dkv": attn.flash_bwd.launches_dkv}
    peak = torch.cuda.max_memory_allocated()
    backend = dist.get_backend()
    if backend != "nccl" or dist.get_world_size() != 1:
        fail(f"train_fsdp: process group {backend!r} of "
             f"{dist.get_world_size()} ranks, expected one NCCL rank")
    state = run["state"]
    blocks = list(state.model.layers)
    wrapped = sum(isinstance(b, FSDPModule) for b in blocks)
    if wrapped != len(blocks) or not isinstance(state.model, FSDPModule):
        fail(f"train_fsdp: fully_shard wrapped {wrapped} of {len(blocks)} "
             "blocks (and the root must be wrapped too)")
    want = layers * steps
    if set(launches.values()) != {want}:
        fail(f"train_fsdp: kernel launches {launches}, expected {want} each")
    ratio = run.get("ratio")
    if not (ratio is not None and np.isfinite(run["final_loss"]) and ratio < 1.0):
        fail(f"train_fsdp: loss did not fall: first {run.get('first_loss')} "
             f"final {run.get('final_loss')}")
    losses = [l for _, l in run["losses"]]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[:3], dp["losses"][:3])]
    if len(rel) != 3 or max(rel) > FSDP_DP_LOSS_RTOL:
        fail(f"train_fsdp: first losses {losses[:3]} vs dp's {dp['losses'][:3]} "
             f"(rel {rel}, tol {FSDP_DP_LOSS_RTOL})")
    n_params = sum(p.numel() for p in state.model.parameters())
    step_ms = 1e3 * statistics.median(run["step_s"][2:])
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    emit({"phase": "train_fsdp", "model": "llama3_8b", "layers": layers,
          "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH, "steps": steps,
          "world_size": dist.get_world_size(), "backend": backend,
          "fully_shard_blocks": wrapped, "mesh": pmesh.mesh_shape(run["mesh"]),
          "nccl_init_s": pmesh.PROCESS_GROUP_INIT_S,
          "mesh_s": run["mesh_s"], "n_params": n_params,
          "losses": losses, "first3_rel_vs_dp": rel,
          "first3_rel_tol": FSDP_DP_LOSS_RTOL, "convergence_ratio": ratio,
          "step_ms_median_3_10": step_ms, "step_ms": [1e3 * t for t in run["step_s"]],
          "tokens_per_s": tokens_per_s,
          "mfu_6nd": 6 * n_params * tokens_per_s / PEAK_BF16_FLOPS,
          "peak_mem_gb": peak / 1e9, "wall_s": wall, "compile_s": run["compile_s"],
          "launches": launches,
          "phases_ms_median_3_10": median_phases(run["step_phases"][2:]),
          "dp": {k: v for k, v in dp.items() if k != "losses"},
          "dp_first3_losses": dp["losses"][:3], "card": card})
    summary = {"step_ms_median_3_10": step_ms, "tokens_per_s": tokens_per_s,
               "mfu_6nd": 6 * n_params * tokens_per_s / PEAK_BF16_FLOPS,
               "peak_mem_gb": peak / 1e9,
               "phases_ms_median_3_10": median_phases(run["step_phases"][2:])}
    del run, state, blocks
    gc.collect()
    torch.cuda.empty_cache()
    return launches, summary


def phase_train_fsdp_tp(torch, attn, card, dp, fsdp):
    """``llama_train --strategy=fsdp_tp`` through the launcher's API in
    process, as :func:`phase_train_fsdp` runs ``fsdp``: the same model,
    depth, data, seed and steps, at world size 1 on the one-process NCCL
    group, so the mesh's tensor axis has one rank — and the same code as
    at tensor 4: every parameter a ``DTensor`` over ``(fsdp, tensor)``
    with the ``FSDP_TP`` rules' placements, the model's tensor-axis
    collectives issued on a one-rank NCCL group. Checks the backend, the
    placements, K1-K3 launched layers x steps times each, the loss
    falling, the first 3 losses within ``FSDP_DP_LOSS_RTOL`` of ``dp``'s
    and the tensor-axis collectives of each step against
    ``tensor_parallel.expected_per_step``; reports step time, tokens/s,
    MFU, peak memory and the step phases beside ``dp``'s and ``fsdp``'s."""
    import torch.distributed as dist
    from torch.distributed.fsdp import FSDPModule

    from k8s_tpu_torch.launcher.spmd_launcher import Rendezvous, run_program
    from k8s_tpu_torch.parallel import mesh as pmesh
    from k8s_tpu_torch.parallel import tensor_parallel as ptp

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    layers, steps = dp["layers"], TRAIN_STEPS
    rdzv = Rendezvous({
        "KTPU_PROGRAM": "k8s_tpu_torch.programs.llama_train:main",
        "KTPU_PROGRAM_ARGS": (
            f"--strategy=fsdp_tp --model=llama3-8b --layers={layers} "
            f"--seq_len={TRAIN_SEQ} --batch_size={TRAIN_BATCH} --steps={steps} "
            "--log_every=1 --remat_policy=flash --fused_ce=1 --lr=3e-4 "
            "--data=learnable")})
    attn.flash_fwd.launches = 0
    attn.flash_bwd.launches_dq = attn.flash_bwd.launches_dkv = 0
    ptp.reset_counts()
    t0 = time.perf_counter()
    run = run_program(rdzv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": attn.flash_fwd.launches,
                "flash_bwd_dq": attn.flash_bwd.launches_dq,
                "flash_bwd_dkv": attn.flash_bwd.launches_dkv}
    counted = dict(ptp.COLLECTIVES)
    peak = torch.cuda.max_memory_allocated()
    backend = dist.get_backend()
    if backend != "nccl" or dist.get_world_size() != 1:
        fail(f"train_fsdp_tp: process group {backend!r} of "
             f"{dist.get_world_size()} ranks, expected one NCCL rank")
    state = run["state"]
    mesh = pmesh.mesh_shape(run["mesh"])
    if mesh["tensor"] != 1 or mesh["fsdp"] != 1:
        fail(f"train_fsdp_tp: mesh {mesh}, expected fsdp 1 x tensor 1")
    blocks = list(state.model.layers)
    wrapped = sum(isinstance(b, FSDPModule) for b in blocks)
    if wrapped != len(blocks) or not isinstance(state.model, FSDPModule):
        fail(f"train_fsdp_tp: fully_shard wrapped {wrapped} of {len(blocks)} "
             "blocks (and the root must be wrapped too)")
    placements = {n: (tuple(p.device_mesh.mesh_dim_names), tuple(repr(x) for x in p.placements))
                  for n, p in state.model.named_parameters()}
    want_placements = {
        "layers.0.attn.q_proj": (("fsdp", "tensor"), ("Shard(dim=0)", "Shard(dim=1)")),
        "layers.0.attn.o_proj": (("fsdp", "tensor"), ("Shard(dim=1)", "Shard(dim=0)")),
        "layers.0.mlp.down_proj": (("fsdp", "tensor"), ("Shard(dim=1)", "Shard(dim=0)")),
        "layers.0.input_norm.weight": (("fsdp", "tensor"), ("Shard(dim=0)", "Replicate()")),
        "embed_tokens": (("fsdp", "tensor"), ("Shard(dim=1)", "Shard(dim=0)")),
        "lm_head": (("fsdp", "tensor"), ("Shard(dim=0)", "Shard(dim=1)"))}
    off = {n: placements.get(n) for n, w in want_placements.items() if placements.get(n) != w}
    if off:
        fail(f"train_fsdp_tp: placements {off}, expected {want_placements}")
    want = layers * steps
    if set(launches.values()) != {want}:
        fail(f"train_fsdp_tp: kernel launches {launches}, expected {want} each")
    per_step = ptp.expected_per_step(layers, recompute=True)
    if counted != {k: v * steps for k, v in per_step.items()}:
        fail(f"train_fsdp_tp: tensor-axis collectives {counted} over {steps} steps, "
             f"expected {per_step} per step")
    ratio = run.get("ratio")
    if not (ratio is not None and np.isfinite(run["final_loss"]) and ratio < 1.0):
        fail(f"train_fsdp_tp: loss did not fall: first {run.get('first_loss')} "
             f"final {run.get('final_loss')}")
    losses = [l for _, l in run["losses"]]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[:3], dp["losses"][:3])]
    if len(rel) != 3 or max(rel) > FSDP_DP_LOSS_RTOL:
        fail(f"train_fsdp_tp: first losses {losses[:3]} vs dp's {dp['losses'][:3]} "
             f"(rel {rel}, tol {FSDP_DP_LOSS_RTOL})")
    n_params = sum(p.numel() for p in state.model.parameters())
    step_ms = 1e3 * statistics.median(run["step_s"][2:])
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    emit({"phase": "train_fsdp_tp", "model": "llama3_8b", "layers": layers,
          "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH, "steps": steps,
          "world_size": dist.get_world_size(), "backend": backend, "mesh": mesh,
          "fully_shard_blocks": wrapped,
          "placements": {n: list(placements[n][1]) for n in want_placements},
          "tensor_collectives_per_step": {k: v / steps for k, v in counted.items()},
          "tensor_collectives_expected_per_step": per_step,
          "mesh_s": run["mesh_s"], "n_params": n_params,
          "losses": losses, "first3_rel_vs_dp": rel,
          "first3_rel_tol": FSDP_DP_LOSS_RTOL, "convergence_ratio": ratio,
          "step_ms_median_3_10": step_ms, "step_ms": [1e3 * t for t in run["step_s"]],
          "tokens_per_s": tokens_per_s,
          "mfu_6nd": 6 * n_params * tokens_per_s / PEAK_BF16_FLOPS,
          "peak_mem_gb": peak / 1e9, "wall_s": wall, "compile_s": run["compile_s"],
          "launches": launches,
          "phases_ms_median_3_10": median_phases(run["step_phases"][2:]),
          "dp": {k: v for k, v in dp.items() if k != "losses"},
          "fsdp": fsdp, "card": card})
    del run, state, blocks
    gc.collect()
    torch.cuda.empty_cache()
    return launches


class Child:
    """``python -m k8s_tpu_torch.launcher.spmd_launcher`` as a child
    process of this script, from the repository root, with a reader
    thread collecting its stdout lines so that the script can wait for an
    event with a deadline and act while the child runs."""

    def __init__(self, env, what):
        from k8s_tpu_torch.obs.events import parse_events

        self._parse = parse_events
        self.what = what
        full = {k: v for k, v in os.environ.items()
                if not k.startswith(("KTPU_", "MEGASCALE_"))}
        full["PYTHONPATH"] = str(REPO)
        full.update({k: str(v) for k, v in env.items()})
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "k8s_tpu_torch.launcher.spmd_launcher"],
            cwd=REPO, env=full, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        self.started = time.monotonic()
        self.lines = []
        self.times = {}  # event name -> arrival time (monotonic) of its first line
        self._q = queue.Queue()
        self._err = []
        threading.Thread(target=lambda: [self._q.put((time.monotonic(), ln))
                                         for ln in self.proc.stdout],
                         daemon=True).start()
        threading.Thread(target=lambda: self._err.extend(self.proc.stderr),
                         daemon=True).start()

    def _drain(self, timeout):
        try:
            t, line = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        self.lines.append(line)
        for e in self._parse(line):
            self.times.setdefault(e["event"], t)
        return line

    def wait_event(self, name, pred=lambda e: True, timeout=300.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            line = self._drain(0.2)
            if line is None:
                if self.proc.poll() is not None and self._q.empty():
                    break
                continue
            for e in self._parse(line):
                if e["event"] == name and pred(e):
                    return e
        self.kill()
        fail(f"launcher {self.what}: no {name} event within {timeout} s "
             f"(exit {self.proc.poll()}); stdout tail: {self.lines[-5:]}; "
             f"stderr tail: {''.join(self._err)[-2000:]}")

    def finish(self, timeout=300.0):
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.kill()
            fail(f"launcher {self.what}: still running after {timeout} s")
        while self._drain(1.0) is not None:
            pass
        return rc, "".join(self.lines), "".join(self._err)

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


def get_url(port, path, timeout=120):
    """The body of a GET on the child's obs endpoint, whatever its status
    (/healthz answers 503 when unhealthy, /debug/profile when its
    capture failed: the body says why)."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.read().decode()
    except urllib.error.HTTPError as e:
        return e.read().decode()


def poll_heartbeat(child, port, min_step, timeout=300.0):
    """/healthz until the heartbeat's step reaches ``min_step``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        hz = json.loads(get_url(port, "/healthz"))
        if hz.get("obs", {}).get("step", 0) >= min_step:
            return hz
        if child.proc.poll() is not None:
            break
        time.sleep(0.1)
    child.kill()
    fail(f"launcher {child.what}: heartbeat never reached step {min_step}")


def llama_params(cfg) -> int:
    """Parameter count of a Llama config (embedding, lm_head, layers,
    norms)."""
    e, f = cfg.hidden_size, cfg.intermediate_size
    hd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    layer = e * hd + 2 * e * kvd + hd * e + 3 * e * f + 2 * e
    return 2 * cfg.vocab_size * e + cfg.num_layers * layer + e


def host_ram_available() -> float:
    """Bytes of host memory available (``MemAvailable``)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return float(line.split()[1]) * 1024
    return 0.0


def measure_io(torch, dirpath) -> dict:
    """The rates the checkpoint tiers are held to: the card's
    device-to-host copy into page-locked memory (2 GiB, CUDA events,
    best of 3); the local tier's first-save cost, page-locking a fresh
    2 GiB host buffer (``HostBuffers.take``: allocation and
    ``cudaHostRegister``), and its snapshot into it once locked
    (``host_copy``, host clock); and a sequential write of 1 GiB to
    ``dirpath`` in 64 MiB chunks, fsynced (the local tier's disk)."""
    from k8s_tpu_torch.ckpt.pipeline import HostBuffers, host_copy

    n = 2 << 30
    src = torch.empty(n, dtype=torch.uint8, device="cuda")
    dst = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    rates = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        dst.copy_(src, non_blocking=True)
        b.record()
        b.synchronize()
        rates.append(n / (a.elapsed_time(b) / 1e3) / 1e9)
    del dst
    buffers = HostBuffers()
    try:
        t0 = time.perf_counter()
        buffers.give(buffers.take(n))
        register_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host_copy(src, buffers)
        copy_s = time.perf_counter() - t0
    finally:
        buffers.close()
    del src
    torch.cuda.empty_cache()
    chunk = np.full(64 << 20, 7, dtype=np.uint8)
    path = os.path.join(dirpath, "write-rate.bin")
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        for _ in range(16):
            f.write(chunk)
        f.flush()
        os.fsync(f.fileno())
    write_s = time.perf_counter() - t0
    os.remove(path)
    DISK_WRITES.append(("write-rate probe", 16 * chunk.nbytes))
    return {"pinned_d2h_gb_per_s": max(rates),
            "host_register_gb_per_s": n / register_s / 1e9,
            "host_copy_registered_gb_per_s": n / copy_s / 1e9,
            "seq_write_gb_per_s": 16 * chunk.nbytes / write_s / 1e9}


def phase_restored_serving(torch, attn, card, persist_dir, local_step_dir, tmp):
    """(e) of the launcher phase: the model the training child (d) saved,
    restored from its persistent (DCP) dir by
    ``programs.llama_generate.load_decode_params`` (2 layers at
    Llama-3-8B width, bf16, no random init) and served through the
    engine behind the HTTP front-end, the launch counts set to 0 just
    before the requests and read just after (K1 prefill and K4 decode
    must launch). Every weight must equal the bf16 cast of the same
    step's local-tier copy (the two tiers hold one state), every served
    token must pass the teacher-forced oracle (0.25), and a restore from
    an empty directory must raise. Returns the launches and the load
    seconds."""
    from k8s_tpu_torch.ckpt import LocalTier
    from k8s_tpu_torch.ckpt.pipeline import from_numpy
    from k8s_tpu_torch.programs.llama_generate import (
        decode_model_config, load_decode_params)
    from k8s_tpu_torch.serving import ContinuousBatchingEngine, ServingFrontend

    t_phase = time.perf_counter()
    max_seq, new_tokens = 2048, 32
    cfg = decode_model_config("llama3-8b", max_seq, {"layers": str(LAUNCHER_LAYERS)},
                              ragged=True)
    empty = os.path.join(tmp, "empty-checkpoint")
    os.makedirs(empty)
    try:
        load_decode_params(cfg, empty, device="cuda")
        fail("restored serving: a restore from an empty dir did not raise")
    except FileNotFoundError:
        pass
    t0 = time.perf_counter()
    model = load_decode_params(cfg, persist_dir, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    params_bytes = 4 * sum(p.numel() for p in model.parameters())  # f32 on disk
    # the served weights are the bf16 cast of the local tier's copy of
    # the same step (the lm_head is held in f32 after that cast)
    step = int(os.path.basename(local_step_dir).split("-")[1])
    tier = LocalTier(os.path.dirname(os.path.dirname(local_step_dir)), host_id=0)
    off = []
    for name, p in model.named_parameters():
        path = f"params/{name}"
        entry = tier.manifest(step)["leaves"][path]
        arr = tier.read_shard(step, path, next(iter(entry["shards"])))
        ref = from_numpy(arr, torch.float32).to("cuda").to(torch.bfloat16).to(p.dtype)
        if not torch.equal(ref, p.detach()):
            off.append(name)
    if off:
        fail(f"restored serving: weights differ from the local tier's step {step}: {off[:6]}")
    buckets = [b for b in (16, 32, 64, 128, 256, 512, 1024) if b < max_seq]
    engine = ContinuousBatchingEngine(model, max_slots=8, decode_chunk=32,
                                      prompt_buckets=buckets, prefill_chunk=256,
                                      pipeline_depth=2)
    frontend = ServingFrontend(engine, port=0)
    stop = threading.Event()
    pump = threading.Thread(target=frontend.serve, args=(stop.is_set,))
    pump.start()
    rng = np.random.RandomState(5)
    lens = [12, 97, 256, 300, 700, 1000]
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in lens]
    try:
        post(frontend.port, {"prompt": prompts[0][:20], "max_new_tokens": 4})  # warm-up
        stats0 = dict(engine.stats)
        attn.flash_fwd.launches = 0
        attn.decode_attention_update.launches = 0
        results, _, wall = burst(frontend.port, prompts, new_tokens)
        counted = {"flash_fwd": attn.flash_fwd.launches,
                   "decode_attn": attn.decode_attention_update.launches}
        stats = {k: v - stats0.get(k, 0) for k, v in engine.stats.items()
                 if k != "queue_depth"}
    finally:
        stop.set()
        pump.join(timeout=300)
    if pump.is_alive() or any(r is None for r in results):
        fail("restored serving: a request or the pump did not finish")
    launches = path_launches(counted, stats, engine)
    for name, n in launches.items():
        if n <= 0:
            fail(f"restored serving: kernel {name} never launched on the main path")
    gaps = []
    for p, r in zip(prompts, results):
        toks = r["tokens"]
        if len(toks) != new_tokens:
            fail(f"restored serving: {len(toks)} tokens for a {new_tokens}-token request")
        ids = torch.tensor([p + toks], dtype=torch.long, device="cuda")
        cache = model.new_cache(1)
        cache.fresh = False
        hidden, _ = model(ids, positions=torch.arange(ids.shape[1], device="cuda")[None],
                          cache=cache, return_hidden=True)
        del cache
        logits = model.lm_head_logits(hidden[0, len(p) - 1:len(p) - 1 + len(toks)])
        if not torch.isfinite(logits).all():
            fail("restored serving: non-finite logits in the oracle forward")
        tok_t = torch.tensor(toks, device="cuda")
        gaps.append((logits.max(-1).values
                     - logits.gather(1, tok_t[:, None])[:, 0]).max().item())
    if max(gaps) > ORACLE_LOGIT_TOL:
        fail(f"restored serving oracle: emitted-token logit {max(gaps)} below the row "
             f"max (tol {ORACLE_LOGIT_TOL})")
    emit({"phase": "serving_restored", "model": "llama3_8b", "layers": cfg.num_layers,
          "dtype": "bfloat16", "checkpoint_step": step, "load_s": load_s,
          "params_bytes_read": params_bytes, "weights_equal_local_tier": True,
          "empty_dir_raises": True, "requests": len(prompts), "prompt_lens": lens,
          "new_tokens": new_tokens, "wall_s": wall,
          "graph_replays": stats["graph_replays"], "launches": launches,
          "launches_counted": counted, "oracle_max_gap": max(gaps),
          "oracle_tol": ORACLE_LOGIT_TOL, "card": card})
    del engine, frontend, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "load_s": load_s, "params_bytes": params_bytes,
            "seconds": time.perf_counter() - t_phase}


def phase_launcher(torch, attn, card, train_tracer_ms):
    """See :func:`_phase_launcher`; its flight dirs, profiles and
    checkpoints go to a temporary directory that is removed afterwards.
    Returns the kernel launches of the restored serving run (e) and the
    seconds from (b)'s child start to its first step's end."""
    tmp = tempfile.mkdtemp(prefix="ktpu-launcher-")
    try:
        return _phase_launcher(torch, attn, card, train_tracer_ms, tmp)
    finally:
        # its checkpoints, dumps and profiles count against the call's
        # disk-write limit (the write-rate probe is noted where it runs)
        DISK_WRITES.append(("launcher", tree_bytes(tmp)))
        shutil.rmtree(tmp, ignore_errors=True)


def _phase_launcher(torch, attn, card, train_tracer_ms, tmp):
    """The port's launcher as the operator runs it: ``python -m
    k8s_tpu_torch.launcher.spmd_launcher`` as a child process on the
    card — (a) no program: the mesh smoke check; (b) llama_train at
    Llama-3-8B width, 2 layers, with an obs endpoint that this script
    polls mid-run (/healthz and its hbm block, /metrics, /debug/profile,
    /debug/flightrecorder); (c) the same run with the local checkpoint
    tier, SIGTERM after the heartbeat reaches step 2: the flush at the
    current step (``preempt_checkpoint``), exit 143 and the flight
    recorder's dump on disk (with the flush's save spans); (d) a fresh
    child on (c)'s dirs: the restore from the local tier at the flushed
    step with 0 lost steps, every leaf's crc read back from the card
    equal to the manifest's, exit 0 after its final save (the persistent
    tier, DCP); (d') one more restore, timed to its first step (MTTR),
    then killed; then (e), in this process, the model (d) saved served
    from its persistent dir (:func:`phase_restored_serving`). See
    ``CKPT_LOCAL_EVERY`` for why only (c) and (d) write. The
    ``checkpoint`` line holds the save, flush and restore seconds, MTTR
    and their rates beside the card's pinned device-to-host rate and the
    disk's sequential write rate, measured here."""
    from k8s_tpu_torch.models import LlamaConfig
    from k8s_tpu_torch.obs.events import events_of
    from k8s_tpu_torch.obs.health import trace_event_counts

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    cfg = LlamaConfig.llama3_8b(num_layers=LAUNCHER_LAYERS)
    n_params = llama_params(cfg)
    # f32 weight, grad, two AdamW moments and the health block's copy of
    # the weights (20 B per parameter), plus activations and the fused
    # CE's chunks (the 8-layer run peaks ~6 GB above its 20 B/param)
    need = 20 * n_params + 8e9
    print(f"chip_smoke: launcher phase: {free / 1e9:.2f} GB free of "
          f"{total / 1e9:.2f}, the training child needs ~{need / 1e9:.1f}",
          flush=True)
    if free < need:
        fail(f"launcher: {free / 1e9:.2f} GB free, the child needs {need / 1e9:.1f}")
    codes = {}

    # (a) the mesh smoke check
    t0 = time.perf_counter()
    child = Child({}, "mesh check")
    rc, out, err = child.finish(timeout=180)
    smoke = events_of(out, "smoke_ok")
    if rc != 0 or len(smoke) != 1 or smoke[0]["devices"] != 1 \
            or not events_of(out, "done"):
        fail(f"launcher mesh check: exit {rc}, stdout {out!r}, stderr {err[-2000:]}")
    codes["mesh"] = rc
    mesh_s = time.perf_counter() - t0

    args = (f"--strategy=fsdp --model=llama3-8b --layers={LAUNCHER_LAYERS} "
            f"--seq_len={TRAIN_SEQ} "
            f"--batch_size={TRAIN_BATCH} --log_every=1 --step_sleep=0.5 "
            "--remat_policy=flash --fused_ce=1 --lr=3e-4 --data=learnable")

    # the checkpoint tiers' disk, host memory and rates
    save_bytes = 12 * n_params  # f32 weights and the two AdamW moments
    disk_free = shutil.disk_usage(tmp).free
    ram_free = host_ram_available()
    print(f"chip_smoke: launcher phase: {disk_free / 1e9:.2f} GB free on the "
          f"checkpoint disk ({tmp}), {ram_free / 1e9:.2f} GB of host RAM "
          f"available; a save is {save_bytes / 1e9:.2f} GB, the phase writes "
          f"two (~{2 * save_bytes / 1e9:.1f} GB of disk) and needs "
          f"~{(save_bytes + 8e9) / 1e9:.1f} GB of RAM", flush=True)
    if disk_free < 2.2 * save_bytes or ram_free < save_bytes + 8e9:
        fail(f"launcher: {disk_free / 1e9:.2f} GB of disk and {ram_free / 1e9:.2f} GB "
             f"of RAM free; the checkpoint runs need {2.2 * save_bytes / 1e9:.1f} "
             f"and {(save_bytes + 8e9) / 1e9:.1f}")
    io_rates = measure_io(torch, tmp)

    def ckpt_env(name, persistent: bool):
        env = {"KTPU_CKPT_LOCAL_DIR": os.path.join(tmp, name, "local"),
               "KTPU_CKPT_LOCAL_EVERY": str(CKPT_LOCAL_EVERY),
               "KTPU_CKPT_LOCAL_KEEP": "1",
               "KTPU_CKPT_SAVE_BUFFER_BYTES": str(CKPT_SAVE_BUFFER_BYTES)}
        if persistent:
            env["KTPU_CKPT_DIR"] = os.path.join(tmp, name, "persist")
        return env

    # (b) training with the obs endpoint, polled mid-run
    t0 = time.perf_counter()
    flight_b = os.path.join(tmp, "train")
    child = Child({"KTPU_PROGRAM": "k8s_tpu_torch.programs.llama_train:main",
                   "KTPU_PROGRAM_ARGS": f"{args} --steps={LAUNCHER_STEPS}",
                   "KTPU_OBS_ADVERTISE": "127.0.0.1:0",
                   "KTPU_FLIGHT_DIR": flight_b,
                   "KTPU_TRACE_ID": "chip-smoke-launcher"}, "train")
    try:
        port = child.wait_event("obs_ready")["port"]
        hz = poll_heartbeat(child, port, 2)
        hbm = hz["obs"].get("hbm")
        limit = torch.cuda.get_device_properties(0).total_memory
        if not hbm or hbm["bytes_in_use"] <= 0 or hbm["bytes_limit"] != limit:
            fail(f"launcher train: /healthz hbm block {hbm}, card memory {limit}")
        if hz["obs"]["trace_id"] != "chip-smoke-launcher" or "health" not in hz["obs"]:
            fail(f"launcher train: /healthz heartbeat {hz['obs']}")
        metrics_text = get_url(port, "/metrics")
        hbm_lines = [ln for ln in metrics_text.splitlines()
                     if ln.startswith("ktpu_obs_hbm_bytes_in_use{")]
        if not hbm_lines or float(hbm_lines[0].rsplit(" ", 1)[1]) <= 0:
            fail(f"launcher train: /metrics has no HBM series: {metrics_text[:2000]}")
        prof = json.loads(get_url(port, "/debug/profile?seconds=1"))
        counts = trace_event_counts(prof["trace"]) if prof.get("trace") else {}
        if not prof.get("ok") or counts.get("kernel", 0) < 1:
            fail(f"launcher train: /debug/profile {prof}, events {counts}")
        with open(prof["trace"]) as f:
            names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel"]
        flash_in_profile = {k: sum(k in n for n in names) for k in
                            ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                             "flash_bwd_dkv_kernel")}
        ring = json.loads(get_url(port, "/debug/flightrecorder"))["entries"]
        ring_steps = [e for e in ring if e.get("kind") == "step"]
        if not ring_steps or {e["trace_id"] for e in ring_steps} != {"chip-smoke-launcher"}:
            fail(f"launcher train: /debug/flightrecorder {ring[:4]}")
        rc, out, err = child.finish(timeout=300)
    finally:
        child.kill()
    phases = events_of(out, "step_phases")
    if rc != 0 or [e["step"] for e in phases] != list(range(1, LAUNCHER_STEPS + 1)) \
            or not all(events_of(out, n) for n in
                       ("compile_phase", "step_health", "convergence", "done")):
        fail(f"launcher train: exit {rc}; stdout tail {out[-3000:]}; stderr {err[-3000:]}")
    codes["train"] = rc
    train_s = time.perf_counter() - t0
    # the operator phase's reference: a direct child's start -> step 1
    child_first_step_s = child.times["compile_phase"] - child.started
    compile_s = events_of(out, "compile_phase")[0]["seconds"]
    walls = [e["wall_ms"] for e in phases[1:]]
    steady = median_phases(phases[1:])
    unphased = statistics.median(
        e["wall_ms"] - sum(e["phases_ms"].values()) for e in phases[1:])

    # (c) SIGTERM after the heartbeat reaches step 2: the flush at the
    # current step to the local tier, then 143
    t0 = time.perf_counter()
    flight_c = os.path.join(tmp, "sigterm")
    child = Child({"KTPU_PROGRAM": "k8s_tpu_torch.programs.llama_train:main",
                   "KTPU_PROGRAM_ARGS": f"{args} --steps=50",
                   "KTPU_OBS_ADVERTISE": "127.0.0.1:0",
                   "KTPU_FLIGHT_DIR": flight_c,
                   "KTPU_TRACE_ID": "chip-smoke-sigterm",
                   **ckpt_env("cd", persistent=False)}, "sigterm")
    try:
        port = child.wait_event("obs_ready")["port"]
        poll_heartbeat(child, port, 2)
        t_term = time.monotonic()
        child.proc.send_signal(signal.SIGTERM)
        rc, out, err = child.finish(timeout=600)
        t_exit = time.monotonic()
    finally:
        child.kill()
    dump_path = pathlib.Path(flight_c) / "flight-host0.json"
    dump = json.loads(dump_path.read_text()) if dump_path.exists() else {}
    dumped = [e["step"] for e in dump.get("entries", []) if e.get("kind") == "step"]
    flushed = events_of(out, "preempt_checkpoint")
    if rc != 143 or not events_of(out, "preempt_requested") or dumped[:2] != [1, 2] \
            or len(flushed) != 1 or flushed[0]["step"] < 3:
        fail(f"launcher sigterm: exit {rc}, dump steps {dumped}, flush {flushed}, "
             f"stdout tail {out[-2000:]}, stderr {err[-2000:]}")
    codes["sigterm"] = rc
    sigterm_s = time.perf_counter() - t0
    flush_step = flushed[0]["step"]
    # the flush's phases, as the manager noted them on the tracer (the
    # flight recorder's dump)
    flush_phases = {e["name"][len("save_"):]: e["wall_s"] for e in dump.get("entries", [])
                    if e.get("kind") == "span" and e.get("step") == flush_step
                    and e.get("name", "").startswith("save_")}
    if set(flush_phases) != {"snapshot", "serialize", "commit"}:
        fail(f"launcher sigterm: the flush's save spans {flush_phases}")
    local_cd = os.path.join(tmp, "cd", "local")
    with open(os.path.join(local_cd, "host-0", f"step-{flush_step}", "manifest.json")) as f:
        manifest = json.load(f)
    man_crc = {p: next(iter(e["shards"].values()))["crc"]
               for p, e in manifest["leaves"].items()}
    man_bytes = sum(int(np.prod(e["shape"], dtype=np.int64))
                    * (2 if e["dtype"] == "bfloat16" else np.dtype(e["dtype"]).itemsize)
                    for e in manifest["leaves"].values())
    sigterm = {"flush_step": flush_step, "dump_reason": dump.get("reason"),
               "requested_to_checkpoint_s":
                   child.times["preempt_checkpoint"] - child.times["preempt_requested"],
               "sigterm_to_exit_s": t_exit - t_term, "flush_phases_s": flush_phases}
    sigterm["fits_grace_period"] = sigterm["sigterm_to_exit_s"] <= CKPT_GRACE_S

    # (d) a fresh child on the same dirs: restore from the local tier at
    # (c)'s flushed step, every leaf's crc as read back from the card
    # against the manifest's; no step past it, so its final save finds
    # the local step committed and writes the persistent tier (DCP) alone
    t0 = time.perf_counter()
    child = Child({"KTPU_PROGRAM": "k8s_tpu_torch.programs.llama_train:main",
                   "KTPU_PROGRAM_ARGS": f"{args} --steps={flush_step} --restore_crc=1",
                   "KTPU_TRACE_ID": "chip-smoke-restore",
                   **ckpt_env("cd", persistent=True)}, "restore")
    try:
        rc, out, err = child.finish(timeout=600)
    finally:
        child.kill()
    restore = events_of(out, "ckpt_restore")
    crc = events_of(out, "restore_crc")
    if rc != 0 or len(restore) != 1 or not crc or events_of(out, "step_phases") \
            or events_of(out, "restored") != [{"event": "restored", "step": flush_step}] \
            or not events_of(out, "ckpt_persistent_save"):
        fail(f"launcher restore: exit {rc}; stdout tail {out[-3000:]}; stderr {err[-3000:]}")
    restore, crc = restore[0], crc[0]
    if (restore["source"], restore["step"], restore["lost_steps"]) != ("local", flush_step, 0):
        fail(f"launcher restore: {restore}, expected local at step {flush_step}, 0 lost")
    bad = sorted(p for p in man_crc if crc["crc"].get(p) != man_crc[p])
    if bad or set(crc["crc"]) != set(man_crc):
        fail(f"launcher restore: the card's state differs from the flushed step in "
             f"{len(bad)} leaves ({bad[:6]}), leaves {len(crc['crc'])} vs {len(man_crc)}")
    good_d = events_of(out, "ckpt_goodput")[0]
    if good_d["persistent_saves"] != 1 or good_d["local_saves"] != 0:
        fail(f"launcher restore: final save goodput {good_d}")
    codes["restore"] = rc
    restore_run_s = time.perf_counter() - t0
    dcp_d = events_of(out, "ckpt_persistent_save")[0]

    # (d') MTTR: restore once more (the local tier alone) and take the
    # first step past it; the pod is then killed (no flush, nothing written)
    child = Child({"KTPU_PROGRAM": "k8s_tpu_torch.programs.llama_train:main",
                   "KTPU_PROGRAM_ARGS": f"{args} --steps=50",
                   "KTPU_TRACE_ID": "chip-smoke-mttr",
                   **ckpt_env("cd", persistent=False)}, "mttr")
    try:
        child.wait_event("compile_phase", timeout=600)
        mttr = child.times["compile_phase"] - child.started
    finally:
        child.kill()
    mttr_restore = events_of("".join(child.lines), "ckpt_restore")[0]
    if (mttr_restore["source"], mttr_restore["step"]) != ("local", flush_step):
        fail(f"launcher mttr: restored {mttr_restore}")
    mttr_parts = {"to_ckpt_restore_s": child.times["ckpt_restore"] - child.started,
                  "restore_s": mttr_restore["seconds"],
                  "first_step_s": child.times["compile_phase"] - child.times["restored"]}

    # (e) the restored model served: 2 layers at full width, bf16
    persist_cd = os.path.join(tmp, "cd", "persist")
    served = phase_restored_serving(
        torch, attn, card, persist_cd,
        os.path.join(local_cd, "host-0", f"step-{flush_step}"), tmp)

    def rate(sec):
        return None if not sec else man_bytes / sec / 1e9

    background = flush_phases["serialize"] + flush_phases["commit"]

    emit({"phase": "checkpoint", "model": "llama3_8b", "layers": LAUNCHER_LAYERS,
          "n_params": n_params, "bytes_per_save": man_bytes,
          "leaves": len(manifest["leaves"]),
          "disk_free_gb_before": disk_free / 1e9,
          "host_ram_available_gb": ram_free / 1e9, **io_rates,
          "save_buffer_bytes": CKPT_SAVE_BUFFER_BYTES,
          "local_interval_steps": CKPT_LOCAL_EVERY,
          "snapshot_s": flush_phases["snapshot"],
          "snapshot_gb_per_s": rate(flush_phases["snapshot"]),
          "serialize_commit_s": background,
          "serialize_commit_gb_per_s": rate(background),
          "sigterm": sigterm, "grace_period_s": CKPT_GRACE_S,
          "restore": {"source": restore["source"], "step": restore["step"],
                      "lost_steps": restore["lost_steps"], "seconds": restore["seconds"],
                      "phases_s": restore["phases_s"],
                      "gb_per_s": rate(restore["seconds"])},
          "mttr_s": mttr, "mttr_parts": mttr_parts,
          "restore_crc_readback_s": crc["seconds"],
          "crc": {"leaves": len(man_crc), "equal": len(man_crc) - len(bad)},
          "dcp": {"save_s": dcp_d["seconds"], "save_gb_per_s": rate(dcp_d["seconds"]),
                  "load_params_s": served["load_s"],
                  "load_params_gb_per_s": served["params_bytes"] / served["load_s"] / 1e9},
          "seconds": {"c": sigterm_s, "d": restore_run_s, "e": served["seconds"]},
          "card": card})
    emit({"phase": "launcher", "exit_codes": codes,
          "mesh_check": smoke[0], "train_model": "llama3_8b",
          "train_layers": LAUNCHER_LAYERS, "train_steps": LAUNCHER_STEPS,
          "seq_len": TRAIN_SEQ, "batch": TRAIN_BATCH, "step_sleep_s": 0.5,
          "n_params": n_params, "free_gb_before": free / 1e9,
          "need_gb": need / 1e9,
          "compile_s": compile_s,
          "step_wall_ms_median_2_6": statistics.median(walls),
          "step_wall_ms": [e["wall_ms"] for e in phases],
          "phases_ms_median_2_6": steady,
          "unphased_ms_median_2_6": unphased,
          "hbm": {k: hbm[k] for k in ("bytes_in_use", "peak_bytes_in_use",
                                      "bytes_limit", "peak_fraction")},
          "hbm_at_step": hz["obs"]["step"],
          "profile": {"seconds": prof["seconds"], "kernel_events": counts.get("kernel", 0),
                      "device_events": prof["events"], "flash_kernels": flash_in_profile},
          "flightrecorder_live_steps": [e["step"] for e in ring_steps],
          "sigterm_dump": {"reason": dump.get("reason"), "steps": dumped},
          "k1_k3_launches_in_child_computed": LAUNCHER_LAYERS * LAUNCHER_STEPS,
          "train_child_start_to_first_step_s": child_first_step_s,
          "tracer_overhead_ms_per_step_in_process": train_tracer_ms,
          "seconds": {"mesh": mesh_s, "train": train_s, "sigterm": sigterm_s,
                      "restore": restore_run_s,
                      "phase": time.perf_counter() - t_phase},
          "card": card})
    return served["launches"], child_first_step_s


def operator_child_args():
    """``llama_train``'s arguments in every operator phase's pods: the
    launcher phase's child configuration (Llama-3-8B width, 2 layers)."""
    return (f"--strategy=fsdp --model=llama3-8b --layers={LAUNCHER_LAYERS} "
            f"--seq_len={TRAIN_SEQ} --batch_size={TRAIN_BATCH} --log_every=1 "
            "--step_sleep=0.5 --remat_policy=flash --fused_ce=1 --lr=3e-4 "
            "--data=learnable")


def _operator_job(name, args, obs=True, priority=None, local_dir=None,
                  program="llama_train"):
    """A TpuJob of one WORKER on one card (the gpu block of a one-card
    node: ``nvidia.com/gpu: 1``), running ``program`` (a module of
    ``k8s_tpu_torch.programs``) with ``args`` and one gang restart
    allowed; with ``obs`` an obs port (its
    heartbeats are read on this machine's loopback, which only the
    in-process ``LocalWorld`` resolves); with ``priority`` a scheduling
    block (preemptible); with ``local_dir`` the local checkpoint tier
    there and a grace period its flush fits."""
    from k8s_tpu_torch import spec as S

    spec = {
        "gpu": {"accelerator": "h100-80gb-x1", "numCards": 1},
        "maxGangRestarts": 1,
        "replicaSpecs": [{"tpuReplicaType": "WORKER", "template": {"spec": {
            "containers": [{
                "name": "jax", "image": "local",
                "command": ["python", "-m", "k8s_tpu_torch.launcher.spmd_launcher"],
                "env": [{"name": "KTPU_PROGRAM",
                         "value": f"k8s_tpu_torch.programs.{program}:main"},
                        {"name": "KTPU_PROGRAM_ARGS", "value": args}]}]}}}],
    }
    if obs:
        spec["observability"] = {"obsPort": OPERATOR_OBS_PORT}
    if priority is not None:
        spec["scheduling"] = {"priority": priority, "preemptible": True}
    if local_dir is not None:
        spec["checkpointPolicy"] = {"localDir": local_dir,
                                    "localIntervalSteps": CKPT_LOCAL_EVERY,
                                    "saveBufferBytes": CKPT_SAVE_BUFFER_BYTES}
        spec["replicaSpecs"][0]["template"]["spec"][
            "terminationGracePeriodSeconds"] = SCHED_FLUSH_GRACE_S
    return S.TpuJob.from_dict({
        "apiVersion": "tpu.k8s.io/v1alpha1", "kind": "TpuJob",
        "metadata": {"name": name, "namespace": "default"}, "spec": spec})


def first_write(timeline, kind, name, *phases, after=0.0):
    """The time of the first row of ``timeline`` ((time, kind, name,
    phase) per write) for ``kind``/``name`` in one of ``phases`` later
    than ``after``; None if there is none yet."""
    ts = [t for t, k, n, ph in list(timeline)
          if t > after and k == kind and n == name and ph in phases]
    return min(ts) if ts else None


class OperatorRun:
    """One TpuJob through the port's ``LocalWorld``: every write of its
    TpuJob and Pods, from the in-memory cluster's commit hook, and the
    pod log's events by arrival time."""

    def __init__(self, world, name, args, log_dir, job=None):
        self.world, self.name, self.log_dir = world, name, log_dir
        self.timeline = []  # (time, kind, name, phase) of every write
        world.cluster.hooks.append(self._hook)
        self.t_create = time.monotonic()
        world.api.create(job or _operator_job(name, args))

    def _hook(self, ev):
        if ev.kind not in ("Pod", "TpuJob") or ev.type == "DELETED":
            return
        st = ev.object.get("status") or {}
        self.timeline.append((time.monotonic(), ev.kind, ev.name, st.get("phase")))

    def first(self, kind, name, *phases, after=0.0):
        return first_write(self.timeline, kind, name, *phases, after=after)

    @property
    def pod(self):
        rid = self.world.api.get("default", self.name).spec.runtime_id
        return f"{self.name}-worker-{rid}-0-pod-0" if rid else None

    def log(self):
        path = os.path.join(self.log_dir, f"{self.pod}.log")
        return open(path, errors="replace").read() if os.path.exists(path) else ""

    def wait_log(self, pred, what, timeout=OPERATOR_DEADLINE_S):
        """Poll the pod log until ``pred(text)``; the arrival time."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.pod and pred(self.log()):
                return time.monotonic()
            time.sleep(0.05)
        fail(f"operator {self.name}: no {what} in the pod log within {timeout} s; "
             f"log tail {self.log()[-3000:]}")

    def wait_done(self, timeout=OPERATOR_DEADLINE_S):
        from k8s_tpu_torch import spec as S

        try:
            job = self.world.api.wait_for_job("default", self.name, timeout=timeout,
                                              polling_interval=0.05)
        except TimeoutError:
            fail(f"operator {self.name}: not done within {timeout} s; "
                 f"log tail {self.log()[-3000:]}")
        t = self.first("TpuJob", self.name, S.TpuJobPhase.DONE)
        return job, t


def _pod_launches(log_text):
    """The K1-K3 launch counts the training program printed (stderr)."""
    lines = [ln for ln in log_text.splitlines()
             if ln.startswith("llama_train: kernel launches ")]
    return [json.loads(ln.split(" ", 3)[3]) for ln in lines]


def _pod_launches_so_far(log_text):
    """The K1-K3 launch counts the training program printed after each
    log point (stderr), the record of a pod killed before its end."""
    prefix = "llama_train: launches so far "
    return [json.loads(ln[len(prefix):]) for ln in log_text.splitlines()
            if ln.startswith(prefix)]


def _count_events(text, name):
    from k8s_tpu_torch.obs.events import parse_events

    return sum(1 for ln in text.splitlines() for e in parse_events(ln)
               if e["event"] == name)


def phase_operator(torch, card, launcher_child_first_step_s):
    """See :func:`_phase_operator`; its pod logs go to a temporary
    directory that is removed afterwards. Returns the K1-K3 launches the
    pods counted."""
    tmp = tempfile.mkdtemp(prefix="ktpu-operator-")
    try:
        return _phase_operator(torch, card, launcher_child_first_step_s, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _phase_operator(torch, card, launcher_child_first_step_s, tmp):
    """The port's operator on the card: a ``LocalWorld`` (in-memory
    cluster, controller, kubelet with subprocess pods; no platform
    forced) takes three ``TpuJob`` s through the port's ``TpuJobApi``,
    each one WORKER with ``nvidia.com/gpu: 1`` running ``llama_train``
    at Llama-3-8B width, 2 layers (the launcher phase's child), with no
    checkpoint directory:

    - (o1) 6 steps: the job ends ``Succeeded``; the pod got card 0
      through ``CUDA_VISIBLE_DEVICES`` and its log shows K1-K3 launched
      layers x steps times;
    - (o2) the worker's process SIGTERMed once its heartbeat (the obs
      endpoint on the port the kubelet's resolver gave its Service)
      shows step 2: exit 143, one gang restart, the restarted pod trains
      its 5 steps and the job ends ``Succeeded`` with ``gang_restarts`` 1;
    - (o3) ``--strategy=bogus``, which the program refuses: an exit in
      1-127 and the job ``Failed`` with 0 restarts.

    The ``operator`` line holds create -> pod Running -> first step ->
    ``Succeeded`` (and, in (o2), the exit -> the restarted pod's first
    step) beside the launcher phase's direct child start -> first step."""
    from k8s_tpu_torch import spec as S
    from k8s_tpu_torch.tools.local_world import LocalWorld

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"chip_smoke: operator phase: {free / 1e9:.2f} GB free of "
          f"{total / 1e9:.2f}", flush=True)
    args = operator_child_args()
    out = {}
    world = LocalWorld(subprocess_pods=True, log_dir=tmp, reconcile_interval=0.1)
    if world.kubelet.executor.extra_env:
        fail(f"operator: the world forces {world.kubelet.executor.extra_env}")
    with world:
        cards = world.kubelet.devices.cards
        if not cards:
            fail("operator: the kubelet found no card")

        # (o1) to Succeeded
        o1 = OperatorRun(world, "op-o1", f"{args} --steps={OPERATOR_STEPS}", tmp)
        t_step = o1.wait_log(lambda t: _count_events(t, "compile_phase") >= 1,
                             "first step")
        job, t_done = o1.wait_done()
        t_run = o1.first("Pod", o1.pod, "Running")
        pod = world.client.pods.get("default", o1.pod)
        launches = _pod_launches(o1.log())
        want = LAUNCHER_LAYERS * OPERATOR_STEPS
        if job.status.state != S.TpuJobState.SUCCEEDED or job.status.gang_restarts:
            fail(f"operator o1: {job.status.state} after {job.status.gang_restarts} "
                 f"restarts ({job.status.reason}); log tail {o1.log()[-3000:]}")
        if pod.metadata.annotations.get("tpu.k8s.io/cuda-visible-devices") != cards[0]:
            fail(f"operator o1: pod cards {pod.metadata.annotations}, node {cards}")
        if launches != [{"steps": OPERATOR_STEPS, "flash_fwd": want,
                         "flash_bwd_dq": want, "flash_bwd_dkv": want}]:
            fail(f"operator o1: the pod's K1-K3 launches {launches}, want {want} each")
        out["o1"] = {"state": job.status.state, "gang_restarts": 0,
                     "cuda_visible_devices": cards[0], "pod_launches": launches[0],
                     "create_to_running_s": t_run - o1.t_create,
                     "running_to_first_step_s": t_step - t_run,
                     "first_step_to_succeeded_s": t_done - t_step,
                     "create_to_first_step_s": t_step - o1.t_create,
                     "create_to_succeeded_s": t_done - o1.t_create}

        # (o2) SIGTERM at step 2, one gang restart, Succeeded
        o2 = OperatorRun(world, "op-o2", f"{args} --steps={OPERATOR_TERM_STEPS}", tmp)
        o2.wait_log(lambda t: "obs_ready" in t, "obs endpoint")
        rid = world.api.get("default", "op-o2").spec.runtime_id
        port = world.kubelet.resolver.port_for(f"op-o2-worker-{rid}-0", OPERATOR_OBS_PORT)
        proc = world.kubelet.executor.procs[o2.pod]
        deadline = time.monotonic() + OPERATOR_DEADLINE_S
        while True:
            try:
                hz = json.loads(get_url(port, "/healthz", timeout=10))
            except (OSError, ValueError):
                hz = {}
            if hz.get("obs", {}).get("step", 0) >= 2:
                break
            if proc.poll() is not None or time.monotonic() > deadline:
                fail(f"operator o2: heartbeat never reached step 2 (exit "
                     f"{proc.poll()}); log tail {o2.log()[-3000:]}")
            time.sleep(0.1)
        t_term = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=OPERATOR_DEADLINE_S)
        except subprocess.TimeoutExpired:
            fail("operator o2: the SIGTERMed worker did not exit")
        t_exit = time.monotonic()
        t_step2 = o2.wait_log(lambda t: _count_events(t, "compile_phase") >= 2,
                              "restarted pod's first step")
        job, t_done = o2.wait_done()
        if rc != 143 or job.status.state != S.TpuJobState.SUCCEEDED \
                or job.status.gang_restarts != 1 \
                or _count_events(o2.log(), "preempt_requested") != 1:
            fail(f"operator o2: exit {rc}, {job.status.state} after "
                 f"{job.status.gang_restarts} restarts ({job.status.reason}); "
                 f"log tail {o2.log()[-3000:]}")
        restarted = _pod_launches(o2.log())
        want2 = LAUNCHER_LAYERS * OPERATOR_TERM_STEPS
        if restarted[-1:] != [{"steps": OPERATOR_TERM_STEPS, "flash_fwd": want2,
                               "flash_bwd_dq": want2, "flash_bwd_dkv": want2}]:
            fail(f"operator o2: the restarted pod's K1-K3 launches {restarted}")
        out["o2"] = {"state": job.status.state, "gang_restarts": job.status.gang_restarts,
                     "exit_code": rc, "heartbeat_step_at_sigterm": hz["obs"]["step"],
                     "conditions": [c.type for c in job.status.conditions],
                     "sigterm_to_exit_s": t_exit - t_term,
                     "exit_to_restarted_first_step_s": t_step2 - t_exit,
                     "create_to_succeeded_s": t_done - o2.t_create,
                     "pod_launches_after_restart": restarted[-1]}

        # (o3) an argument the program refuses: Failed, no restart
        o3 = OperatorRun(world, "op-o3", f"{args} --steps=2 --strategy=bogus", tmp)
        job, t_done = o3.wait_done()
        pod = world.client.pods.get("default", o3.pod)
        term = pod.status.container_statuses[0].state.terminated
        if job.status.state != S.TpuJobState.FAILED or job.status.gang_restarts \
                or term is None or not 1 <= term.exit_code <= 127:
            fail(f"operator o3: {job.status.state}, {job.status.gang_restarts} "
                 f"restarts, pod {pod.status.to_dict()}; log tail {o3.log()[-3000:]}")
        out["o3"] = {"state": job.status.state, "gang_restarts": 0,
                     "exit_code": term.exit_code,
                     "create_to_failed_s": t_done - o3.t_create}
    emit({"phase": "operator", "model": "llama3_8b", "layers": LAUNCHER_LAYERS,
          "seq_len": TRAIN_SEQ, "batch": TRAIN_BATCH, "step_sleep_s": 0.5,
          "free_gb_before": free / 1e9, "node_cards": cards, **out,
          "launcher_child_start_to_first_step_s": launcher_child_first_step_s,
          "operator_overhead_to_first_step_s": (
              None if launcher_child_first_step_s is None
              else out["o1"]["create_to_first_step_s"] - launcher_child_first_step_s),
          "seconds": time.perf_counter() - t_phase, "card": card})
    return ({k: out["o1"]["pod_launches"][k] + out["o2"]["pod_launches_after_restart"][k]
             for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}, out["o1"])


def _check_pod_launches(what, lines, steps=None):
    """Every ``kernel launches`` line of a pod log: K1-K3 launched
    layers x steps times (``steps``: the runs' step counts, if known)."""
    if not lines or (steps is not None and [ln["steps"] for ln in lines] != steps):
        fail(f"{what}: the pod's kernel launch lines {lines}, want steps {steps}")
    for ln in lines:
        want = LAUNCHER_LAYERS * ln["steps"]
        if any(ln[k] != want for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")):
            fail(f"{what}: the pod's K1-K3 launches {ln}, want {want} each")
    return {k: sum(ln[k] for ln in lines)
            for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}


def _pod_steps(log_text):
    """The steps of a pod log's ``step_phases`` events, in order."""
    from k8s_tpu_torch.obs.events import parse_events

    return [e["step"] for ln in log_text.splitlines() for e in parse_events(ln)
            if e["event"] == "step_phases"]


class DevCluster:
    """The dev cluster as processes of this script: ``python -m
    k8s_tpu_torch.api.apiserver --port 0 --with-kubelet`` (its kubelet
    runs the pods on this machine's card and is the device plugin), the
    operators started against it (``python -m k8s_tpu_torch.operator``
    without ``--local``), and this script's own watches of TpuJobs and
    Pods over REST, which note when each (kind, name, phase) was first
    seen."""

    def __init__(self, tmp):
        from k8s_tpu_torch.api.restcluster import RestCluster

        self.tmp = pathlib.Path(tmp)
        self.env = {k: v for k, v in os.environ.items()
                    if not k.startswith(("KTPU_", "MEGASCALE_"))}
        self.env["PYTHONPATH"] = str(REPO)
        self.log_dir = self.tmp / "logs"
        self.api_out = []
        self.api = subprocess.Popen(
            [sys.executable, "-m", "k8s_tpu_torch.api.apiserver", "--port", "0",
             "--with-kubelet", "--log-dir", str(self.log_dir)],
            cwd=REPO, env=self.env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        self.ops = {}
        self._stop = threading.Event()
        self.timeline = []  # (time, kind, name, phase)
        deadline = time.monotonic() + 120
        self.url = None
        while self.url is None and time.monotonic() < deadline:
            line = self.api.stdout.readline()
            if not line:
                break
            self.api_out.append(line)
            if line.startswith("serving on "):
                self.url = line.split()[2]
        if self.url is None:
            self.close()
            fail(f"operator_rest: the apiserver printed no URL: {self.api_out[-20:]}")
        threading.Thread(target=lambda: self.api_out.extend(self.api.stdout),
                         daemon=True).start()
        self.rest = RestCluster(self.url)
        for kind in ("TpuJob", "Pod"):
            threading.Thread(target=self._watch, args=(kind,), daemon=True).start()

    def _watch(self, kind):
        from k8s_tpu_torch.api.restcluster import RestCluster

        rest = RestCluster(self.url)
        while not self._stop.is_set():
            try:
                _, rv = rest.list_with_rv(kind, "default")
                w = rest.watch(kind, "default", rv)
                while not self._stop.is_set():
                    ev = w.next(timeout=0.2)
                    if ev is not None and ev.type != "DELETED":
                        st = ev.object.get("status") or {}
                        self.timeline.append((time.monotonic(), kind, ev.name,
                                              st.get("phase")))
                w.stop()
            except Exception:  # a 410 or a closed stream: relist
                time.sleep(0.1)

    def first(self, kind, name, *phases, after=0.0):
        return first_write(self.timeline, kind, name, *phases, after=after)

    def wait(self, pred, what, timeout=OPERATOR_DEADLINE_S):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            v = pred()
            if v:
                return v
            time.sleep(0.05)
        fail(f"operator_rest: no {what} within {timeout} s; apiserver "
             f"{''.join(self.api_out[-20:])}; operators "
             + "; ".join(f"{n}: {self.op_log(n)[-1500:]}" for n in self.ops))

    def start_operator(self, name):
        log = open(self.tmp / f"{name}.log", "w")
        self.ops[name] = subprocess.Popen(
            [sys.executable, "-m", "k8s_tpu_torch.operator", "--health-port=-1"],
            cwd=REPO, env={**self.env, "KTPU_APISERVER_URL": self.url,
                           "MY_POD_NAMESPACE": "default", "MY_POD_NAME": name},
            stdout=log, stderr=subprocess.STDOUT)
        log.close()

    def op_log(self, name):
        return (self.tmp / f"{name}.log").read_text(errors="replace")

    def leader(self):
        from k8s_tpu_torch.api import errors

        try:
            lock = self.rest.get("Endpoints", "default", "tpu-operator")
        except errors.NotFoundError:
            return None
        raw = (lock["metadata"].get("annotations") or {}).get(
            "control-plane.alpha.kubernetes.io/leader", "")
        return json.loads(raw).get("holderIdentity") if raw else None

    def kubectl(self, *argv, timeout=120):
        return subprocess.run(
            [sys.executable, "-m", "k8s_tpu_torch.tools.kubectl_local", *argv,
             "--server", self.url], cwd=REPO, env=self.env, capture_output=True,
            text=True, timeout=timeout)

    def job(self, name):
        from k8s_tpu_torch import spec as S

        return S.TpuJob.from_dict(self.rest.get(S.CRD_KIND, "default", name))

    def pod_log(self, pod):
        from k8s_tpu_torch.api import errors

        try:
            return self.rest.pod_log("default", pod)
        except errors.NotFoundError:
            return ""

    def close(self):
        self._stop.set()
        procs = list(self.ops.values()) + [self.api]
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=30)


def phase_operator_rest(torch, card, o1, launcher_child_first_step_s):
    """See :func:`_phase_operator_rest`; its logs go to a temporary
    directory that is removed afterwards. Returns the K1-K3 launches
    the pods counted."""
    tmp = tempfile.mkdtemp(prefix="ktpu-operator-rest-")
    try:
        return _phase_operator_rest(torch, card, o1, launcher_child_first_step_s, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _phase_operator_rest(torch, card, o1, launcher_child_first_step_s, tmp):
    """The port's operator against an apiserver, every component a
    process: the dev apiserver with its kubelet, the operators over REST
    with leader election, ``kubectl_local --server``. Each job is one
    WORKER with ``nvidia.com/gpu: 1`` running the operator phase's child
    (no obs port: its heartbeats would need the cluster's Service DNS).

    - (r1) operator A leads; ``kubectl_local create --server`` of a job
      of ``OPERATOR_STEPS`` steps, to ``Succeeded``; ``kubectl_local logs
      --server`` returns the pod's log, with K1-K3 launched layers x
      steps times; create -> pod Running -> first step -> ``Succeeded``
      beside the local-mode operator's (o1) and the direct child's.
    - (r2) operator B stands by; a job of ``REST_FAILOVER_STEPS`` steps;
      at its first step A is SIGKILLed: B takes the lock (15 s lease)
      and adopts the running job; its one pod trains one contiguous run
      of steps, ``gang_restarts`` 0, ``Succeeded``; leader kill ->
      standby leading -> ``Succeeded``."""
    from k8s_tpu_torch import spec as S

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    args = operator_child_args()
    out = {}
    dc = DevCluster(tmp)
    try:
        dc.start_operator("op-a")
        dc.wait(lambda: dc.leader() == "op-a", "op-a leading")

        def run_job(name, steps):
            manifest = pathlib.Path(tmp) / f"{name}.json"
            manifest.write_text(json.dumps(_operator_job(
                name, f"{args} --steps={steps}", obs=False).to_dict()))
            r = dc.kubectl("create", "-f", str(manifest), "--no-wait")
            if r.returncode != 0:
                fail(f"operator_rest {name}: kubectl_local create --server: "
                     f"{r.stdout}{r.stderr}")
            t_create = dc.wait(lambda: dc.first("TpuJob", name, None, ""),
                               f"{name} created")
            rid = dc.wait(lambda: dc.job(name).spec.runtime_id, f"{name} runtime id")
            pod = f"{name}-worker-{rid}-0-pod-0"
            t_step = dc.wait(lambda: _count_events(dc.pod_log(pod), "compile_phase") >= 1
                             and time.monotonic(), f"{name}'s first step")
            return t_create, pod, t_step

        # (r1) to Succeeded through the REST path
        t_create, pod, t_step = run_job("op-r1", OPERATOR_STEPS)
        t_done = dc.wait(lambda: dc.first("TpuJob", "op-r1", S.TpuJobPhase.DONE),
                         "op-r1 done")
        t_run = dc.first("Pod", pod, "Running")
        job = dc.job("op-r1")
        if job.status.state != S.TpuJobState.SUCCEEDED or job.status.gang_restarts:
            fail(f"operator_rest r1: {job.status.state} after "
                 f"{job.status.gang_restarts} restarts ({job.status.reason}); "
                 f"log tail {dc.pod_log(pod)[-3000:]}")
        r = dc.kubectl("logs", "op-r1")
        if r.returncode != 0 or f"# logs of {pod}" not in r.stdout:
            fail(f"operator_rest r1: kubectl_local logs --server: {r.stdout[-2000:]}"
                 f"{r.stderr[-2000:]}")
        r1_launches = _check_pod_launches("operator_rest r1", _pod_launches(r.stdout),
                                          [OPERATOR_STEPS])
        cards = dc.rest.get("Pod", "default", pod)["metadata"].get(
            "annotations", {}).get("tpu.k8s.io/cuda-visible-devices")
        if not cards:
            fail(f"operator_rest r1: the pod got no card ({cards!r})")
        out["r1"] = {"state": job.status.state, "gang_restarts": 0,
                     "cuda_visible_devices": cards, "pod_launches": r1_launches,
                     "create_to_running_s": t_run - t_create,
                     "running_to_first_step_s": t_step - t_run,
                     "first_step_to_succeeded_s": t_done - t_step,
                     "create_to_first_step_s": t_step - t_create,
                     "create_to_succeeded_s": t_done - t_create,
                     "local_mode_o1": {k: o1[k] for k in (
                         "create_to_running_s", "running_to_first_step_s",
                         "first_step_to_succeeded_s", "create_to_first_step_s",
                         "create_to_succeeded_s")} if o1 else None,
                     "rest_over_local_to_first_step_s": (
                         t_step - t_create - o1["create_to_first_step_s"]) if o1 else None}

        # (r2) the leader dies at the first step; the standby adopts
        dc.start_operator("op-b")
        dc.wait(lambda: "waiting for the lock" in dc.op_log("op-b"), "op-b standing by")
        _, pod2, t_step = run_job("op-r2", REST_FAILOVER_STEPS)
        if dc.leader() != "op-a":
            fail(f"operator_rest r2: the lock is held by {dc.leader()}, not op-a")
        t_kill = time.monotonic()
        dc.ops["op-a"].kill()
        dc.ops["op-a"].wait(timeout=30)
        t_lead = dc.wait(lambda: dc.leader() == "op-b" and time.monotonic(),
                         "op-b leading", timeout=120)
        phase_at_takeover = dc.job("op-r2").status.phase
        dc.wait(lambda: "running (leading)" in dc.op_log("op-b"), "op-b's controller")
        t_done = dc.wait(lambda: dc.first("TpuJob", "op-r2", S.TpuJobPhase.DONE),
                         "op-r2 done")
        job = dc.job("op-r2")
        log2 = dc.pod_log(pod2)
        steps = _pod_steps(log2)
        pods = [p["metadata"]["name"] for p in dc.rest.list("Pod", "default")
                if p["metadata"]["name"].startswith("op-r2-")]
        r2_launches = _check_pod_launches("operator_rest r2", _pod_launches(log2),
                                          [REST_FAILOVER_STEPS])
        if job.status.state != S.TpuJobState.SUCCEEDED or job.status.gang_restarts \
                or steps != list(range(1, REST_FAILOVER_STEPS + 1)) \
                or pods not in ([pod2], []) or phase_at_takeover != S.TpuJobPhase.RUNNING:
            fail(f"operator_rest r2: {job.status.state} after "
                 f"{job.status.gang_restarts} restarts ({job.status.reason}), "
                 f"steps {steps}, pods {pods}, phase at takeover {phase_at_takeover}; "
                 f"op-b {dc.op_log('op-b')[-2000:]}")
        out["r2"] = {"state": job.status.state, "gang_restarts": 0,
                     "steps": len(steps), "pods": [pod2], "pod_launches": r2_launches,
                     "job_phase_at_takeover": phase_at_takeover,
                     "leader_kill_at_step": 1,
                     "first_step_to_leader_kill_s": t_kill - t_step,
                     "leader_kill_to_standby_leading_s": t_lead - t_kill,
                     "standby_leading_to_succeeded_s": t_done - t_lead,
                     "leader_kill_to_succeeded_s": t_done - t_kill}
    finally:
        dc.close()
    emit({"phase": "operator_rest", "model": "llama3_8b", "layers": LAUNCHER_LAYERS,
          "seq_len": TRAIN_SEQ, "batch": TRAIN_BATCH, "step_sleep_s": 0.5,
          "lease_s": 15.0, "renew_deadline_s": 5.0, "retry_period_s": 3.0, **out,
          "launcher_child_start_to_first_step_s": launcher_child_first_step_s,
          "seconds": time.perf_counter() - t_phase, "card": card})
    return {k: out["r1"]["pod_launches"][k] + out["r2"]["pod_launches"][k]
            for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}


# (what, bytes) the phases wrote to disk: the files each phase left in
# its directory before removing it, and the write-rate probe (the
# sandbox's /proc/self/io reads write_bytes 0, so the files are counted)
DISK_WRITES = []


def tree_bytes(path) -> int:
    """The bytes of the files under ``path``."""
    total = 0
    for root, _, files in os.walk(path):
        for f in files:
            try:
                total += os.lstat(os.path.join(root, f)).st_size
            except OSError:
                pass
    return total


def phase_sched(torch, card):
    """See :func:`_phase_sched`; its logs (and A's checkpoint, if any) go
    to a temporary directory that is removed afterwards. Returns the
    K1-K3 launches the pods counted and the phase's times."""
    tmp = tempfile.mkdtemp(prefix="ktpu-sched-")
    try:
        return _phase_sched(torch, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _phase_sched(torch, card, tmp):
    """The cluster scheduler on the card: a ``LocalWorld`` whose
    controller config declares ``fleet: {h100-80gb-x1: 1}`` (one node of
    one card). Job A (priority 0, preemptible, the operator phase's
    child with an obs port) trains until its heartbeat shows step 2;
    job B (priority 10) then arrives. The scheduler preempts A (SIGTERM,
    exit 143, ``Queued``); B trains on the card to ``Succeeded``; after
    B's release and A's cooldown A is re-admitted and runs to
    ``Succeeded``. A gets a local checkpoint directory only when one
    save still fits this call's disk-write limit (else it restarts from
    step 0). The device plugin's hand-outs of card 0 are recorded: no
    two pods may hold it at once."""
    from k8s_tpu_torch import spec as S
    from k8s_tpu_torch.controller import metrics
    from k8s_tpu_torch.tools.local_world import LocalWorld

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    written = sum(n for _, n in DISK_WRITES)
    with_ckpt = WRITE_LIMIT_BYTES - written >= CHILD_SAVE_BYTES
    args = operator_child_args()
    config = S.ControllerConfig(fleet={"h100-80gb-x1": 1},
                                scheduler_cooldown_seconds=SCHED_COOLDOWN_S)
    world = LocalWorld(subprocess_pods=True, log_dir=tmp, config=config,
                       reconcile_interval=0.1)
    holds = []  # (time, +1 take / -1 give back, cards)
    with world:
        plugin = world.kubelet.devices
        take, give_back = plugin.take, plugin.give_back

        def logged_take(n, stop=None):
            got = take(n, stop=stop)
            if got:
                holds.append((time.monotonic(), 1, tuple(got)))
            return got

        def logged_give_back(cards):
            if cards:
                holds.append((time.monotonic(), -1, tuple(cards)))
            give_back(cards)

        plugin.take, plugin.give_back = logged_take, logged_give_back
        a = OperatorRun(world, "sched-a", None, tmp, job=_operator_job(
            "sched-a", f"{args} --steps={SCHED_A_STEPS}", priority=0,
            local_dir=os.path.join(tmp, "a-local") if with_ckpt else None))
        a.wait_log(lambda t: "obs_ready" in t, "A's obs endpoint")
        rid = world.api.get("default", "sched-a").spec.runtime_id
        port = world.kubelet.resolver.port_for(f"sched-a-worker-{rid}-0", OPERATOR_OBS_PORT)
        proc_a = world.kubelet.executor.procs[a.pod]
        deadline = time.monotonic() + OPERATOR_DEADLINE_S
        while True:
            try:
                hz = json.loads(get_url(port, "/healthz", timeout=10))
            except (OSError, ValueError):
                hz = {}
            if hz.get("obs", {}).get("step", 0) >= 2:
                break
            if proc_a.poll() is not None or time.monotonic() > deadline:
                fail(f"sched: A's heartbeat never reached step 2 (exit "
                     f"{proc_a.poll()}); log tail {a.log()[-3000:]}")
            time.sleep(0.1)
        b = OperatorRun(world, "sched-b", None, tmp, job=_operator_job(
            "sched-b", f"{args} --steps={SCHED_B_STEPS}", priority=10))
        try:
            rc_a = proc_a.wait(timeout=OPERATOR_DEADLINE_S)
        except subprocess.TimeoutExpired:
            fail("sched: the preempted A did not exit")
        t_a_exit = time.monotonic()
        deadline = time.monotonic() + OPERATOR_DEADLINE_S
        while a.first("TpuJob", "sched-a", S.TpuJobPhase.QUEUED, after=b.t_create) is None \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        t_a_queued = a.first("TpuJob", "sched-a", S.TpuJobPhase.QUEUED, after=b.t_create)
        queued = world.api.get("default", "sched-a")
        t_b_step = b.wait_log(lambda t: _count_events(t, "compile_phase") >= 1,
                              "B's first step")
        job_b, t_b_done = b.wait_done()
        t_a_step = a.wait_log(lambda t: _count_events(t, "compile_phase") >= 2,
                              "A's first step after re-admission")
        job_a, t_a_done = a.wait_done()
        # A's first write out of Queued, read once A is done: the
        # re-admission follows B's release by milliseconds, so a read
        # right after B's wait can come before it
        t_a_admit = a.first("TpuJob", "sched-a", S.TpuJobPhase.CREATING,
                            S.TpuJobPhase.RUNNING, after=t_a_queued)
        log_a = a.log()
        preempted = [c for c in queued.status.conditions if c.type == "Preempted"]
        if rc_a != 143 or queued.status.phase not in (S.TpuJobPhase.QUEUED,
                                                      S.TpuJobPhase.CREATING) \
                or t_a_queued is None or not preempted \
                or "default/sched-b" not in preempted[-1].reason:
            fail(f"sched: A exited {rc_a}, phase {queued.status.phase} (queued at "
                 f"{t_a_queued}), conditions {[c.to_dict() for c in queued.status.conditions]}")
        if job_b.status.state != S.TpuJobState.SUCCEEDED \
                or job_a.status.state != S.TpuJobState.SUCCEEDED \
                or job_a.status.gang_restarts or job_b.status.gang_restarts \
                or t_a_admit is None:
            fail(f"sched: B {job_b.status.state}, A {job_a.status.state} "
                 f"(restarts {job_a.status.gang_restarts}/{job_b.status.gang_restarts}), "
                 f"A re-admitted at {t_a_admit} after B done at {t_b_done}; "
                 f"A log tail {log_a[-3000:]}")
        a_steps = _pod_steps(log_a)
        restart_from = a_steps[a_steps.index(1, 1) - 1] if 1 in a_steps[1:] else None
        from k8s_tpu_torch.obs.events import parse_events

        restored = [e["step"] for ln in log_a.splitlines() for e in parse_events(ln)
                    if e["event"] == "ckpt_restore"]
        if with_ckpt != bool(restored) or (not with_ckpt and restart_from is None):
            fail(f"sched: A (checkpoint {with_ckpt}) ran steps {a_steps}, "
                 f"restored {restored}")
        launches = {k: v for k, v in _check_pod_launches(
            "sched B", _pod_launches(b.log()), [SCHED_B_STEPS]).items()}
        a_lines = _pod_launches(log_a)
        a_launches = _check_pod_launches("sched A", a_lines)
        for k in launches:
            launches[k] += a_launches[k]
        inv = world.controller.scheduler.inventory
        high_water = inv.max_used.get("h100-80gb-x1")
        # card 0 held by one pod at a time: replay the hand-outs
        held, most = {}, 0
        for _, sign, got in sorted(holds):
            for c in got:
                held[c] = held.get(c, 0) + sign
                most = max(most, held[c])
        if high_water != 1 or inv.used("h100-80gb-x1") != 0 or most != 1 \
                or sum(1 for _, sign, _ in holds if sign > 0) != 3:
            fail(f"sched: high-water {high_water}, used {inv.used('h100-80gb-x1')}, "
                 f"card hand-outs {holds}")
        series = [ln for ln in metrics.REGISTRY.expose().splitlines()
                  if ln.startswith("ktpu_sched_") and "_bucket" not in ln]
    emit({"phase": "sched", "model": "llama3_8b", "layers": LAUNCHER_LAYERS,
          "seq_len": TRAIN_SEQ, "batch": TRAIN_BATCH, "step_sleep_s": 0.5,
          "fleet": {"h100-80gb-x1": 1}, "cooldown_s": SCHED_COOLDOWN_S,
          "bytes_written_before": written, "writes_before": DISK_WRITES,
          "write_limit_bytes": WRITE_LIMIT_BYTES,
          "a_checkpoint": "local tier" if with_ckpt else "none (one save no longer fits)",
          "a": {"state": job_a.status.state, "exit_code_preempted": rc_a,
                "heartbeat_step_at_b_create": hz["obs"]["step"],
                "steps_before_preemption": restart_from,
                "restored_from_step": restored[0] if restored else None,
                "kernel_launch_lines": a_lines,
                "conditions": [c.type for c in job_a.status.conditions]},
          "b": {"state": job_b.status.state, "pod_launches": _pod_launches(b.log())},
          "b_create_to_a_exit_s": t_a_exit - b.t_create,
          "b_create_to_a_queued_s": t_a_queued - b.t_create,
          "a_exit_to_b_first_step_s": t_b_step - t_a_exit,
          "b_create_to_b_first_step_s": t_b_step - b.t_create,
          "b_succeeded_to_a_readmitted_s": t_a_admit - t_b_done,
          "a_readmitted_to_a_first_step_s": t_a_step - t_a_admit,
          "b_succeeded_to_a_first_step_s": t_a_step - t_b_done,
          "a_create_to_succeeded_s": t_a_done - a.t_create,
          "inventory_high_water_nodes": high_water,
          "card_handouts": [[round(t - a.t_create, 3), sign, list(got)]
                            for t, sign, got in holds],
          "card0_max_holders": most, "ktpu_sched": series,
          "seconds": time.perf_counter() - t_phase, "card": card})
    times = {"b_create_to_b_first_step_s": t_b_step - b.t_create,
             "a_exit_to_b_first_step_s": t_b_step - t_a_exit,
             "a_readmitted_to_a_first_step_s": t_a_step - t_a_admit,
             "a_create_to_succeeded_s": t_a_done - a.t_create}
    return launches, times


def phase_elastic(torch, card, sched_times):
    """See :func:`_phase_elastic`; its logs go to a temporary directory
    that is removed afterwards. Returns the K1-K3 launches the pods
    counted."""
    tmp = tempfile.mkdtemp(prefix="ktpu-elastic-")
    try:
        return _phase_elastic(torch, card, sched_times, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _phase_elastic(torch, card, sched_times, tmp):
    """The elastic gang on the card: a ``LocalWorld`` whose controller
    config declares ``fleet: {h100-80gb-x1: 1}`` runs one job of the
    operator phases' child (obs port, no checkpoint directory) with
    ``training.zeroStage: 1`` and ``elastic: {minDpDegree: 1,
    maxDpDegree: 2, resizeOnPermanentLoss: true}``.

    - (e1) the job is admitted at dp 1 (one node charged), its pod's env
      carries ``KTPU_ELASTIC_*``, the Services of both indices of the
      ``maxDpDegree`` range exist, the ``mesh`` event prints dp 1 and
      ZeRO stage 1, the pod's last launch record before the kill shows
      K1-K3 launched layers x steps times, and the resizer (every ``observe`` of the port's
      ``ElasticResizer`` recorded) sees at least ``ELASTIC_MIN_TICKS``
      obs ticks before the kill, each at dp 1 with 1 attainable node and
      no action;
    - (e2) the pod is SIGKILLed after its first step: exit 137, one gang
      restart at the same shape (no ``GangResized``, ``ktpu_resize_total``
      0 in both directions), the restarted pod trains its steps from
      step 0 with K1-K3 launched layers x steps times, and the job ends
      ``Succeeded``.

    The ``elastic`` line holds create -> first step, kill -> the
    restarted pod's first step and -> ``Succeeded`` beside the ``sched``
    phase's times of the same call."""
    from k8s_tpu_torch import spec as S
    from k8s_tpu_torch.controller import metrics
    from k8s_tpu_torch.resize.elastic import ElasticResizer
    from k8s_tpu_torch.tools.local_world import LocalWorld

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    config = S.ControllerConfig(fleet={"h100-80gb-x1": 1},
                                scheduler_cooldown_seconds=SCHED_COOLDOWN_S)
    job = _operator_job("elastic", f"{operator_child_args()} --steps={ELASTIC_STEPS}",
                        priority=0)
    job.spec.training = S.TrainingSpec(zero_stage=1)
    job.spec.elastic = S.ElasticSpec(min_dp_degree=1, max_dp_degree=2,
                                     resize_on_permanent_loss=True)
    observed = []  # (time, dp, attainable, action, reason)
    observe = ElasticResizer.observe

    def recorded(self, *a, **kw):
        v = observe(self, *a, **kw)
        observed.append((time.monotonic(), kw.get("dp"), kw.get("attainable"),
                         v.action, v.reason))
        return v

    labels = [{"job": "default:elastic", "direction": d} for d in ("shrink", "grow")]
    resizes_before = [metrics.RESIZE_TOTAL.get(x) for x in labels]
    world = LocalWorld(subprocess_pods=True, log_dir=tmp, config=config,
                       reconcile_interval=0.1)
    ElasticResizer.observe = recorded
    try:
        with world:
            run = OperatorRun(world, "elastic", None, tmp, job=job)
            t_step = run.wait_log(lambda t: _count_events(t, "compile_phase") >= 1,
                                  "first step")
            rid = world.api.get("default", "elastic").spec.runtime_id
            proc = world.kubelet.executor.procs[run.pod]
            deadline = time.monotonic() + OPERATOR_DEADLINE_S
            while len(observed) < ELASTIC_MIN_TICKS and time.monotonic() < deadline:
                time.sleep(0.05)
            ticks = list(observed)
            if proc.poll() is not None:
                fail(f"elastic e2: the pod exited ({proc.poll()}) before the kill; "
                     f"log tail {run.log()[-3000:]}")
            t_kill = time.monotonic()
            proc.kill()
            rc = proc.wait(timeout=OPERATOR_DEADLINE_S)
            first_log = run.log()
            admitted = world.api.get("default", "elastic")
            pod_env = world.client.pods.get("default", run.pod).spec.containers[0].env_dict()
            services = [world.client.services.get("default", f"elastic-worker-{rid}-{i}")
                        is not None for i in range(2)]
            # the restarted pod has the same name; its log is appended
            t_step2 = run.wait_log(
                lambda t: _count_events(t[len(first_log):], "compile_phase") >= 1,
                "the restarted pod's first step")
            done, t_done = run.wait_done()
            restarted = run.log()[len(first_log):]
            inv = world.controller.scheduler.inventory
            high_water = inv.max_used.get("h100-80gb-x1")
    finally:
        ElasticResizer.observe = observe
    from k8s_tpu_torch.obs.events import parse_events

    mesh = [e for ln in (first_log + restarted).splitlines()
            for e in parse_events(ln) if e["event"] == "mesh"]
    elastic_env = {k: v for k, v in pod_env.items() if k.startswith("KTPU_ELASTIC_")}
    if admitted.status.dp_degree not in (0, 1) or admitted.spec.num_nodes() != 1 \
            or high_water != 1 or elastic_env != {
                "KTPU_ELASTIC_MIN_DP": "1", "KTPU_ELASTIC_MAX_DP": "2",
                "KTPU_ELASTIC_RESIZE": "1"} or services != [True, True]:
        fail(f"elastic e1: dp {admitted.status.dp_degree}, high-water {high_water}, "
             f"env {elastic_env}, services {services}")
    if [(e["dp"], e["zero_stage"]) for e in mesh] != [(1, 1), (1, 1)]:
        fail(f"elastic e1: mesh events {mesh}")
    held = [t for t in ticks if t[1:4] == (1, 1, None)]
    if len(ticks) < ELASTIC_MIN_TICKS or len(held) != len(ticks):
        fail(f"elastic e1: the resizer's observations before the kill {ticks}")
    resized = [metrics.RESIZE_TOTAL.get(x) - b for x, b in zip(labels, resizes_before)]
    conditions = [c.type for c in done.status.conditions]
    if rc != -signal.SIGKILL or done.status.state != S.TpuJobState.SUCCEEDED \
            or done.status.gang_restarts != 1 or "GangRestart" not in conditions \
            or "GangResized" in conditions or resized != [0, 0] \
            or done.status.dp_degree != 0:
        fail(f"elastic e2: exit {rc}, {done.status.state} after "
             f"{done.status.gang_restarts} restarts ({done.status.reason}), "
             f"conditions {conditions}, resizes {resized}, dp {done.status.dp_degree}; "
             f"log tail {restarted[-3000:]}")
    steps = _pod_steps(restarted)
    if steps != list(range(1, ELASTIC_STEPS + 1)):
        fail(f"elastic e2: the restarted pod ran steps {steps}")
    launches = _check_pod_launches("elastic e2", _pod_launches(restarted),
                                   [ELASTIC_STEPS])
    so_far = _pod_launches_so_far(first_log)
    first_steps = _pod_steps(first_log)
    # the kill may land between a step's step_phases event and its record
    if not so_far or [ln["steps"] for ln in so_far] != first_steps[:len(so_far)] \
            or first_steps != list(range(1, len(first_steps) + 1)) \
            or len(first_steps) - len(so_far) not in (0, 1):
        fail(f"elastic e1: the killed pod's launch records {so_far}, "
             f"its steps {first_steps}")
    first_launches = _check_pod_launches("elastic e1", so_far[-1:])
    emit({"phase": "elastic", "model": "llama3_8b", "layers": LAUNCHER_LAYERS,
          "seq_len": TRAIN_SEQ, "batch": TRAIN_BATCH, "step_sleep_s": 0.5,
          "fleet": {"h100-80gb-x1": 1}, "zero_stage": 1,
          "elastic": {"minDpDegree": 1, "maxDpDegree": 2,
                      "resizeOnPermanentLoss": True},
          "e1": {"dp": 1, "mesh": mesh[0], "elastic_env": elastic_env,
                 "services": services, "inventory_high_water_nodes": high_water,
                 "resizer_ticks_before_kill": len(ticks),
                 "resizer_reason": ticks[-1][4],
                 "killed_pod_steps": so_far[-1]["steps"],
                 "killed_pod_launches": first_launches},
          "e2": {"exit_code": rc, "state": done.status.state,
                 "gang_restarts": done.status.gang_restarts,
                 "conditions": conditions, "ktpu_resize_total": resized,
                 "restarted_steps": steps, "pod_launches": launches},
          "create_to_first_step_s": t_step - run.t_create,
          "kill_to_restarted_first_step_s": t_step2 - t_kill,
          "kill_to_succeeded_s": t_done - t_kill,
          "create_to_succeeded_s": t_done - run.t_create,
          "sched_same_call": sched_times,
          "seconds": time.perf_counter() - t_phase, "card": card})
    return {k: v + first_launches[k] for k, v in launches.items()}


def kernel_launch_counts(attn) -> dict:
    """K1-K5's launch counters, by kernel name."""
    return {"flash_fwd": attn.flash_fwd.launches,
            "flash_bwd_dq": attn.flash_bwd.launches_dq,
            "flash_bwd_dkv": attn.flash_bwd.launches_dkv,
            "decode_attn": attn.decode_attention_update.launches,
            "decode_attn_q8": attn.decode_attention_update_q8.launches}


def resnet_step_flops(torch, model, batch) -> float:
    """One training step's FLOPs from the layer shapes of an eval-mode
    forward of one image, times the batch: each convolution's and the
    head's multiply-adds x 2, three times (the forward, the input gradient
    and the weight gradient), but the stem's twice (the images need no
    gradient)."""
    from k8s_tpu_torch.models import resnet as rn

    flops = []

    def conv_hook(mod, inp, out):
        cin, k = mod.weight.shape[1], mod.weight.shape[2]
        passes = 2 if mod is model.conv_init else 3
        flops.append(passes * 2.0 * out.shape[1] * cin * k * k
                     * out.shape[2] * out.shape[3])

    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if isinstance(m, rn.Conv)]
    from k8s_tpu_torch.programs.resnet_train import prep_images

    model.eval()
    try:
        with torch.no_grad():
            model(prep_images(batch["images"][:1]))
    finally:
        model.train()
        for h in hooks:
            h.remove()
    head = 3 * 2.0 * model.head.weight.numel()
    return (sum(flops) + head) * batch["images"].shape[0]


def tiny_resnet_card_vs_cpu(torch, dt: str, seed: int) -> dict:
    """The tiny ResNet (stages (1, 1), 8 filters, 100 classes, 64², batch
    8) with the same weights on the card and on the CPU, in the ``f32``
    config (``dtype`` and ``norm_dtype`` f32, TF32 off) or the ``bf16``
    one, every BN's scale and bias drawn at random (at init the third BN
    of a block has scale 0, which hides bn_0-bn_2 and their backward from
    the logits): one training step's forward and backward on both, the
    card's BN through PyTorch's fused pieces, the CPU's through plain f32
    ops. Returns the card's largest errors against the CPU: ``logits``
    (over the largest CPU logit, at least 1), ``stats`` (the running
    averages, absolute) and ``grads`` (relative L2, the worst parameter,
    named in ``worst_grad``)."""
    from k8s_tpu_torch.models import ResNet
    from k8s_tpu_torch.models import resnet as rn
    from k8s_tpu_torch.train import cross_entropy_loss

    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    kw = dict(stage_sizes=(1, 1), num_classes=100, num_filters=8, dtype=dtype,
              norm_dtype=dtype, seed=seed)
    rng = np.random.default_rng(seed)
    cpu = ResNet(device="cpu", **kw)
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, rn.BatchNorm):
                shape = m.scale.shape
                m.scale.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, shape)))
                m.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.2, shape)))
    dev = ResNet(device="cuda", **kw)
    dev.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(rng.standard_normal((8, 64, 64, 3)).astype(np.float32))
    x = x.permute(0, 3, 1, 2)
    y = torch.from_numpy(rng.integers(0, 100, (8,)))

    def step(model, x, y):
        model.zero_grad(set_to_none=True)
        logits = model(x)
        cross_entropy_loss(logits, y).backward()
        return (logits.detach().float().cpu(),
                {n: b.detach().cpu() for n, b in model.named_buffers()},
                {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()})

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref, ref_stats, ref_grads = step(cpu, x, y)
        out, stats, grads = step(dev, x.cuda(), y.cuda())
        channels_last = dev.conv_init(x.cuda()).is_contiguous(
            memory_format=torch.channels_last)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    grad_err = {n: float((grads[n] - g).norm() / g.norm().clamp_min(1e-30))
                for n, g in ref_grads.items()}
    return {"finite": bool(torch.isfinite(out).all()),
            "logits": float((out - ref).abs().max()) / max(1.0, float(ref.abs().max())),
            "stats": max(float((stats[n] - b).abs().max()) for n, b in ref_stats.items()),
            "grads": max(grad_err.values()),
            "worst_grad": max(grad_err, key=grad_err.get),
            "channels_last": channels_last}


def _profile_resnet_step(torch, state, step_fn, batch):
    """One more ResNet train step under torch.profiler: device time of the
    convolutions (the kernels under ``aten::cudnn_convolution`` and
    ``aten::convolution_backward``), of BatchNorm (under the forward's
    ``batch_norm_fwd`` range, which this profile wraps around
    ``BatchNorm.forward``, and the backward's ``_SyncBatchNormFnBackward``
    node), of the optimizer and of the rest, and the device's busy share
    of the step's wall."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from k8s_tpu_torch.models import resnet as rn

    orig = rn.BatchNorm.forward

    def bn_forward(self, x):
        with record_function("batch_norm_fwd"):
            return orig(self, x)

    rn.BatchNorm.forward = bn_forward
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step_fn(state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        rn.BatchNorm.forward = orig
    ranges = {e.name for e in prof.events()
              if getattr(e, "is_user_annotation", False)}
    kernels = [(e.key, e.self_device_time_total / 1e3)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and e.key not in ranges and not e.key.startswith("Optimizer.")]
    total = sum(t for _, t in kernels)
    seen = set()

    def under(match):
        """Device ms of the kernels of the CPU events whose name
        ``match`` accepts, and of their children (each event once)."""
        ms = 0.0

        def walk(ev):
            nonlocal ms
            if id(ev) in seen:
                return
            seen.add(id(ev))
            ms += sum(k.duration for k in getattr(ev, "kernels", [])) / 1e3
            for ch in ev.cpu_children:
                walk(ch)

        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CPU and match(ev.name):
                walk(ev)
        return ms

    conv = under(lambda n: n.startswith(("aten::cudnn_convolution",
                                         "aten::convolution_backward")))
    bn = under(lambda n: n == "batch_norm_fwd" or "_SyncBatchNormFnBackward" in n)
    opt = under(lambda n: n.startswith("Optimizer.step"))
    top = sorted(kernels, key=lambda r: -r[1])
    return {"step_wall_ms": wall_ms, "device_ms": total,
            "device_busy_share": total / wall_ms if wall_ms else None,
            "split_ms": {"conv": conv, "batch_norm": bn, "optimizer": opt,
                         "rest": total - conv - bn - opt},
            "top": [{"kernel": k[:120], "ms": t} for k, t in top[:12]]}


def _plain_bn_step_ms(torch, state, step_fn, batch, warmup=2, reps=10):
    """The same step with BatchNorm's plain f32 tensor ops (the CPU path)
    on the card in place of PyTorch's fused BatchNorm pieces: ms per step
    over ``reps`` steps after ``warmup``, ended by a loss readback, and
    the device ms of BN in one profiled step."""
    from k8s_tpu_torch.models import resnet as rn

    fused = rn._fused_bn
    rn._fused_bn = lambda x: False
    try:
        for _ in range(warmup):
            step_fn(state, batch)
        t0 = time.perf_counter()
        for _ in range(reps):
            _, metrics = step_fn(state, batch)
        float(metrics["loss"])
        ms = 1e3 * (time.perf_counter() - t0) / reps
        bn_ms = _profile_resnet_step(torch, state, step_fn, batch)["split_ms"]["batch_norm"]
    finally:
        rn._fused_bn = fused
    return {"step_ms": ms, "batch_norm_device_ms": bn_ms}


def phase_resnet(torch, attn, card):
    """ResNet-50, the headline workload, through the port's
    ``programs.resnet_train`` (``Rendezvous`` of a dict env +
    ``run_program``, in process):

    - (a) the tiny ResNet with random BN scales on the card against the
      CPU, in the f32 and the bf16 config, from each of
      ``RESNET_CARD_SEEDS`` (:func:`tiny_resnet_card_vs_cpu`): logits,
      running stats and gradients of one training step within
      ``RESNET_CARD_TOL``;
    - (b) ResNet-50 at ``bench.py``'s shape (batch 256, 224², conv7 stem,
      bf16, SGD with Nesterov momentum) on one fixed synthetic batch: the
      program's 5 warm-up steps, then 20 timed steps of its step function
      ended by a loss readback (``bench.py``'s timing): step ms, images/s,
      MFU against the dense bf16 peak (FLOPs from the layer shapes,
      :func:`resnet_step_flops`), peak memory, the losses (finite and
      falling) and one profiled step's device ms of the convolutions, BN,
      the optimizer and the rest; then the step with BN's plain f32
      tensor ops (its CPU path) for comparison;
    - (c) a record-fed run: two shards of 224² uint8 images written to a
      temporary directory, ``resnet_train --data_dir`` for 12 steps
      through the native loader (built by g++ at its first use) and the
      device prefetch, the data wait per step beside the step time.

    K1-K5 launch no time here (the path has no Pallas kernel); their
    counts are read before and after and printed."""
    from k8s_tpu_torch.data.records import write_image_shards
    from k8s_tpu_torch.launcher.spmd_launcher import Rendezvous, run_program

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    k0 = kernel_launch_counts(attn)

    # (a) the card against the CPU
    card_vs_cpu = {}
    for dt, tol in RESNET_CARD_TOL.items():
        runs = [tiny_resnet_card_vs_cpu(torch, dt, seed) for seed in RESNET_CARD_SEEDS]
        worst = {k: max(r[k] for r in runs) for k in tol}
        card_vs_cpu[dt] = {"worst": worst, "tol": tol, "per_seed": runs}
        if not (all(r["finite"] and r["channels_last"] for r in runs)
                and all(worst[k] <= tol[k] for k in tol)):
            fail(f"resnet: tiny ResNet ({dt}) on the card vs the CPU: {runs} "
                 f"(limits {tol})")

    # (b) ResNet-50 at bench.py's shape
    torch.cuda.reset_peak_memory_stats()
    rdzv = Rendezvous({
        "KTPU_PROGRAM": "k8s_tpu_torch.programs.resnet_train:main",
        "KTPU_PROGRAM_ARGS": f"--batch_size={RESNET_BATCH} "
                             f"--steps={RESNET_WARMUP} --log_every=1"})
    if rdzv.device != "cuda":
        fail(f"resnet: the rendezvous chose device {rdzv.device!r}")
    t0 = time.perf_counter()
    run = run_program(rdzv)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    state, step_fn, batch = run["state"], run["step_fn"], run["fixed_batch"]
    t0 = time.perf_counter()
    for _ in range(RESNET_TIMED):
        state, metrics = step_fn(state, batch)
    last_loss = float(metrics["loss"])
    timed_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [loss for _, loss in run["losses"]] + [last_loss]
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"resnet: losses {losses} not finite and falling")
    step_ms = 1e3 * timed_s / RESNET_TIMED
    images_per_s = RESNET_BATCH / (step_ms / 1e3)
    flops = resnet_step_flops(torch, state.model, batch)
    profile = _profile_resnet_step(torch, state, step_fn, batch)
    plain_bn = _plain_bn_step_ms(torch, state, step_fn, batch)
    n_params = sum(p.numel() for p in state.model.parameters())
    del run, state, step_fn, batch, metrics
    gc.collect()
    torch.cuda.empty_cache()

    # (c) record-fed steps through the native loader and the prefetch
    tmp = tempfile.mkdtemp(prefix="ktpu-resnet-records-")
    try:
        rng = np.random.default_rng(0)
        images = rng.integers(0, 256, (RESNET_RECORDS, 224, 224, 3), dtype=np.uint8)
        labels = rng.integers(0, 1000, RESNET_RECORDS)
        t0 = time.perf_counter()
        write_image_shards(tmp, images, labels, num_shards=2)
        write_s = time.perf_counter() - t0
        written = tree_bytes(tmp)
        DISK_WRITES.append(("resnet records", written))
        del images
        rec = run_program(Rendezvous({
            "KTPU_PROGRAM": "k8s_tpu_torch.programs.resnet_train:main",
            "KTPU_PROGRAM_ARGS": f"--batch_size={RESNET_BATCH} "
                                 f"--steps={RESNET_RECORD_STEPS} --log_every=1 "
                                 f"--data_dir={tmp}"}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec_losses = [loss for _, loss in rec["losses"]]
    if len(rec_losses) != RESNET_RECORD_STEPS or not np.all(np.isfinite(rec_losses)):
        fail(f"resnet: record-fed losses {rec_losses}")
    wait_ms = [1e3 * t for t in rec["data_wait_s"]]
    rec_step_ms = [1e3 * t for t in rec["step_s"]]
    del rec
    gc.collect()
    torch.cuda.empty_cache()
    k1 = kernel_launch_counts(attn)
    launches = {k: k1[k] - k0[k] for k in k0}
    emit({"phase": "resnet", "model": "resnet50", "stem": "conv7",
          "batch": RESNET_BATCH, "image_size": 224, "dtype": "bf16",
          "optimizer": "SGD lr 0.1, momentum 0.9, Nesterov",
          "path": "Rendezvous + run_program(resnet_train) (in process), "
                  "then its step function",
          "free_gb_before": free / 1e9, "card_vs_cpu_tiny": card_vs_cpu,
          "n_params": n_params, "warmup_steps": RESNET_WARMUP,
          "warmup_s": warmup_s, "timed_steps": RESNET_TIMED,
          "step_ms": step_ms, "images_per_s": images_per_s,
          "step_flops": flops,
          "flops_count": "multiply-adds x 2 from the layer shapes, x 3 (forward, "
                         "input and weight gradients), the stem conv x 2 (no "
                         "input gradient)",
          "mfu": flops / (step_ms / 1e3) / PEAK_BF16_FLOPS,
          "peak_mem_gb": peak / 1e9, "losses": losses,
          "profiled_step": profile,
          "plain_bn": dict(plain_bn, note="the same step with BN's plain f32 "
                           "tensor ops (the CPU path) on the card"),
          "records": {"images": RESNET_RECORDS, "shards": 2, "bytes": written,
                      "write_s": write_s, "steps": RESNET_RECORD_STEPS,
                      "losses": rec_losses, "data_wait_ms": wait_ms,
                      "step_ms": rec_step_ms,
                      "data_wait_ms_median_3_on": statistics.median(wait_ms[2:]),
                      "step_ms_median_3_on": statistics.median(rec_step_ms[2:]),
                      "first_step_note": "includes the loader's g++ build"},
          "launches_k1_k5": launches,
          "seconds": time.perf_counter() - t_phase, "card": card})
    if any(launches.values()):
        fail(f"resnet: a Pallas-kernel port launched on the ResNet path: {launches}")
    return launches


def bert_step_flops(cfg, batch: int, seq: int, n_pred: int) -> float:
    """One BERT training step's FLOPs from the layer shapes: per layer the
    q/k/v/o and MLP products (2 x tokens x weights) and the attention's
    two S x S products (4 x B x H x S^2 x D, non-causal), plus the MLM
    head on the gathered positions (2 x B x n_pred x E x V); all x 3 (the
    forward, the input and the weight gradients; the attention's
    backward counted as twice its forward)."""
    e, f, h, d = cfg.hidden_size, cfg.intermediate_size, cfg.num_heads, cfg.head_dim
    tokens = batch * seq
    per_layer = 2 * tokens * (4 * e * e + 2 * e * f) + 4 * batch * h * seq * seq * d
    head = 2 * batch * n_pred * e * cfg.vocab_size
    return 3.0 * (cfg.num_layers * per_layer + head)


def _profile_bert_step(torch, state, step_fn, batch):
    """One more BERT train step under torch.profiler: device ms of the
    attention kernels (K1-K3 by name), the GEMMs outside the loss, the
    LayerNorms and GELUs (the kernels under ``bert_layer_norm`` and
    ``bert_gelu`` ranges this profile wraps around them in the forward,
    and those of the backward nodes whose forward op ran inside one: the
    autograd ``sequence_nr`` links them), the fused CE (its
    ``fused_ce_fwd``/``fused_ce_bwd`` ranges), the optimizer
    (``Optimizer.step``) and the rest, and the device's busy share of the
    step's wall."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from k8s_tpu_torch.models import bert as bm

    ln_orig, gelu_orig = bm.layer_norm, bm._gelu

    def ln(*a, **kw):
        with record_function("bert_layer_norm"):
            return ln_orig(*a, **kw)

    def gelu(*a, **kw):
        with record_function("bert_gelu"):
            return gelu_orig(*a, **kw)

    bm.layer_norm, bm._gelu = ln, gelu
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step_fn(state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        bm.layer_norm, bm._gelu = ln_orig, gelu_orig

    def is_gemm(name):
        n = name.lower()
        return any(t in n for t in ("gemm", "nvjet", "xmma", "cutlass", "cublas"))

    ranges = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
    ranges |= {"fused_ce_fwd", "fused_ce_bwd", "bert_layer_norm", "bert_gelu"}
    kernels = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and e.key not in ranges and not e.key.startswith("Optimizer.")]
    total = sum(t for _, t in kernels)
    attention = sum(t for k, t in kernels if "flash_fwd_kernel" in k
                    or "flash_bwd_d" in k)
    gemm = sum(t for k, t in kernels if is_gemm(k))
    cpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]

    def walk(ev, seen, acc, seqs=None):
        """Add the device ms (and GEMM ms) of ``ev``'s kernels and its
        children's to ``acc``, each event once; collect their autograd
        sequence numbers into ``seqs``."""
        if id(ev) in seen:
            return
        seen.add(id(ev))
        for kern in getattr(ev, "kernels", []):
            acc[0] += kern.duration / 1e3
            if is_gemm(kern.name):
                acc[1] += kern.duration / 1e3
        if seqs is not None and getattr(ev, "sequence_nr", -1) >= 0:
            seqs.add(ev.sequence_nr)
        for ch in ev.cpu_children:
            walk(ch, seen, acc, seqs)

    def under(pred, seqs=None):
        acc, seen = [0.0, 0.0], set()
        for ev in cpu:
            if pred(ev.name):
                walk(ev, seen, acc, seqs)
        return acc

    ce = under(lambda n: n in ("fused_ce_fwd", "fused_ce_bwd"))
    opt = under(lambda n: n.startswith("Optimizer.step"))
    fwd_seqs = set()
    ln_fwd = under(lambda n: n in ("bert_layer_norm", "bert_gelu"), fwd_seqs)
    # the backward nodes of the ops that ran inside those ranges
    acc, seen = [0.0, 0.0], set()
    for ev in cpu:
        if (getattr(ev, "sequence_nr", -1) in fwd_seqs
                and ("Backward" in ev.name or ev.name.startswith("autograd::"))):
            walk(ev, seen, acc)
    ln_bwd = acc[0]
    split = {"attention_k1_k3": attention, "gemm_outside_ce": gemm - ce[1],
             "layer_norm_gelu_fwd": ln_fwd[0], "layer_norm_gelu_bwd": ln_bwd,
             "fused_ce": ce[0], "optimizer": opt[0]}
    split["rest"] = total - sum(split.values())
    top = sorted(kernels, key=lambda r: -r[1])
    top_other = [r for r in top if not is_gemm(r[0]) and "flash_" not in r[0]]
    return {"step_wall_ms": wall_ms, "device_ms": total,
            "device_busy_share": total / wall_ms if wall_ms else None,
            "split_ms": split,
            "top": [{"kernel": k[:120], "ms": t} for k, t in top[:10]],
            "top_other": [{"kernel": k[:160], "ms": t} for k, t in top_other[:12]]}


def _bert_padded_check(torch, attn):
    """BERT-base on the card (random weights, seed 1) at B 2, S 512 with
    ``attention_mask`` rows of BERT_PAD_LENGTHS real tokens: (1) each real
    token's MLM logit row against the same row run alone without padding
    (the JAX package's own property, tests/test_dataplane.py), within
    BERT_PAD_ROW_TOL of the row's norm; (2) one backward of a loss over
    the real tokens: every parameter gradient finite, the first layer's
    K2/K3 results (dq, dk, dv, captured with the layer's q/k/v, segment
    ids and output gradient) against the plain backward in f32 on the
    same tensors within the K2/K3 row limit, and every parameter gradient
    against the same model run with the plain attention on the card,
    within the training gradient oracle's limit (GRAD_ORACLE_TOL,
    relative L2) — but the k projections' biases: their gradient is zero
    in exact math (softmax ignores a score shift that every key of a row
    shares), so each run's must be rounding noise, below 1e-4 of the
    largest gradient's norm."""
    from k8s_tpu_torch.models import BertConfig, BertForPretraining
    from k8s_tpu_torch.models import bert as bm

    b, s = len(BERT_PAD_LENGTHS), BERT_SEQ
    model = BertForPretraining(BertConfig.base(), device="cuda", seed=1)
    g = torch.Generator(device="cuda").manual_seed(5)
    ids = torch.randint(0, model.config.vocab_size, (b, s), generator=g, device="cuda")
    mask = torch.zeros(b, s, dtype=torch.int32, device="cuda")
    for i, n in enumerate(BERT_PAD_LENGTHS):
        mask[i, :n] = 1
    n0 = attn.flash_fwd.launches
    with torch.no_grad():
        padded, _ = model(ids, attention_mask=mask)
        alone = [model(ids[i:i + 1, :n])[0][0] for i, n in enumerate(BERT_PAD_LENGTHS)]
    if attn.flash_fwd.launches - n0 != BERT_LAYERS * (1 + b):
        fail(f"bert padded check: K1 launched {attn.flash_fwd.launches - n0} times, "
             f"expected {BERT_LAYERS * (1 + b)}")
    logit_err = max(row_rel_err(padded[i, :n], alone[i])
                    for i, n in enumerate(BERT_PAD_LENGTHS))
    del padded, alone

    captured = {}
    orig = bm.flash_attention

    def capture_first(q, k, v, causal=True, segment_ids=None, **kw):
        out = orig(q, k, v, causal=causal, segment_ids=segment_ids, **kw)
        if "q" not in captured:
            captured.update(q=q, k=k, v=v, seg=segment_ids)
            for name, x in (("dq", q), ("dk", k), ("dv", v), ("dout", out)):
                x.register_hook(lambda grad, name=name: captured.__setitem__(name, grad))
        return out

    real = mask.bool()

    def grads(attention):
        model.zero_grad(set_to_none=True)
        bm.flash_attention = attention
        try:
            logits, _ = model(ids, attention_mask=mask)
            loss = torch.nn.functional.cross_entropy(logits[real], ids[real])
            loss.backward()
        finally:
            bm.flash_attention = orig
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()
                if p.grad is not None}

    def plain(q, k, v, causal=True, segment_ids=None, **kw):
        return attn.mha_reference(q, k, v, causal=causal, segment_ids=segment_ids)

    launches = (attn.flash_bwd.launches_dq, attn.flash_bwd.launches_dkv)
    kernel_grads = grads(capture_first)
    if (attn.flash_bwd.launches_dq - launches[0],
            attn.flash_bwd.launches_dkv - launches[1]) != (BERT_LAYERS, BERT_LAYERS):
        fail("bert padded check: K2/K3 did not run once per layer in the backward")
    plain_grads = grads(plain)
    finite = all(torch.isfinite(x).all().item() for x in kernel_grads.values())
    q, k, v, seg = (captured[n] for n in ("q", "k", "v", "seg"))
    scale = q.shape[-1] ** -0.5
    ref_out, ref_lse = attn.flash_fwd_plain(q.float(), k.float(), v.float(), False,
                                            scale, seg)
    ref = attn.flash_bwd_plain(q.float(), k.float(), v.float(), ref_out, ref_lse,
                               captured["dout"].float(), False, scale, seg)
    layer0 = {n: row_rel_err(captured[n], r, floor=FLASH_BWD_ROW_FLOOR)
              for n, r in zip(("dq", "dk", "dv"), ref)}
    top = max(g.norm().item() for g in plain_grads.values())
    zero = [n for n in plain_grads if n.endswith("k_proj.bias")]
    zero_norm = max(max(kernel_grads[n].norm().item(), plain_grads[n].norm().item())
                    for n in zero) / top
    rel = {n: ((kernel_grads[n] - plain_grads[n]).norm()
               / plain_grads[n].norm().clamp_min(1e-30)).item()
           for n in plain_grads if n not in zero}
    worst = max(rel.items(), key=lambda kv: kv[1])
    out = {"B": b, "S": s, "real_lengths": list(BERT_PAD_LENGTHS),
           "logit_row_rel_err": logit_err, "logit_row_tol": BERT_PAD_ROW_TOL,
           "grads_finite": finite, "layer0_bwd_rel_err": layer0,
           "layer0_bwd_tol": FLASH_BWD_REL_TOL,
           "grad_vs_plain_attention_worst": {"param": worst[0], "rel_l2": worst[1]},
           "grad_tol": GRAD_ORACLE_TOL,
           "grad_vs_plain_attention_median": statistics.median(rel.values()),
           "k_proj_bias_grad_norm_over_largest": zero_norm}
    del model, kernel_grads, plain_grads, captured, ref, ref_out
    if not logit_err <= BERT_PAD_ROW_TOL:
        fail(f"bert padded check: real-token logits differ from the unpadded run: {out}")
    if not (finite and max(layer0.values()) <= FLASH_BWD_REL_TOL
            and worst[1] <= GRAD_ORACLE_TOL and zero_norm <= 1e-4):
        fail(f"bert padded check: the backward through the padded model: {out}")
    return out


def phase_bert(torch, attn, card):
    """BERT-base MLM pretraining through the port's ``programs.bert_train``
    (``Rendezvous`` of a dict env + ``run_program``, in process) at its
    full width and defaults: 12 layers x 768, 12 heads of 64, batch 32,
    sequence 512, the default loss path (masked positions through the
    fused CE), AdamW 1e-4, for BERT_STEPS steps with a loss readback per
    step: step ms (median of steps 3 on), sequences/s, MFU from the layer
    shapes (:func:`bert_step_flops`), peak memory, the losses (finite and
    falling on the fixed batch), K1, K2 and K3 launched once per layer
    and step each (counted from 0 around the run; K4/K5 none), and one
    profiled step's device ms by class (:func:`_profile_bert_step`); then
    the padded-model check (:func:`_bert_padded_check`)."""
    from k8s_tpu_torch.launcher.spmd_launcher import Rendezvous, run_program
    from k8s_tpu_torch.models import BertConfig

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rdzv = Rendezvous({
        "KTPU_PROGRAM": "k8s_tpu_torch.programs.bert_train:main",
        "KTPU_PROGRAM_ARGS": f"--batch_size={BERT_BATCH} --steps={BERT_STEPS} "
                             "--log_every=1"})
    if rdzv.device != "cuda":
        fail(f"bert: the rendezvous chose device {rdzv.device!r}")
    attn.flash_fwd.launches = 0
    attn.flash_bwd.launches_dq = attn.flash_bwd.launches_dkv = 0
    attn.decode_attention_update.launches = 0
    attn.decode_attention_update_q8.launches = 0
    t0 = time.perf_counter()
    run = run_program(rdzv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launch_counts(attn)
    peak = torch.cuda.max_memory_allocated()
    want = BERT_LAYERS * BERT_STEPS
    if any(launches[k] != want for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")) \
            or launches["decode_attn"] or launches["decode_attn_q8"]:
        fail(f"bert: kernel launches {launches}, expected {want} each of K1-K3")
    losses = [loss for _, loss in run["losses"]]
    if not (len(losses) == BERT_STEPS and np.all(np.isfinite(losses))
            and losses[-1] < losses[0]):
        fail(f"bert: losses {losses} not finite and falling")
    step_ms = [1e3 * t for t in run["step_s"]]
    med = statistics.median(step_ms[2:])
    cfg = BertConfig.base()
    n_pred = run["batch"]["masked_pos"].shape[1]
    flops = bert_step_flops(cfg, BERT_BATCH, BERT_SEQ, n_pred)
    profile = _profile_bert_step(torch, run["state"], run["step_fn"], run["batch"])
    n_params = sum(p.numel() for p in run["state"].model.parameters())
    del run
    gc.collect()
    torch.cuda.empty_cache()
    padded = _bert_padded_check(torch, attn)
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "bert", "model": "bert-base (12 x 768, 12 heads of 64, "
                                     "intermediate 3072, vocab 30522)",
          "batch": BERT_BATCH, "seq": BERT_SEQ, "n_pred": n_pred,
          "dtype": "bf16 compute, f32 masters, f32 LayerNorm outputs and head",
          "loss_path": "masked positions through the fused LM-head CE",
          "optimizer": "AdamW lr 1e-4, weight decay 1e-4",
          "path": "Rendezvous + run_program(bert_train) (in process)",
          "n_params": n_params, "steps": BERT_STEPS, "run_s": wall,
          "step_ms": step_ms, "step_ms_median_3_on": med,
          "sequences_per_s": BERT_BATCH / (med / 1e3),
          "step_flops": flops, "mfu": flops / (med / 1e3) / PEAK_BF16_FLOPS,
          "flops_count": "2 x tokens x weights per projection, 4 B H S^2 D per "
                         "attention, 2 B n_pred E V for the head; x 3",
          "peak_mem_gb": peak / 1e9, "losses": losses,
          "launches": launches, "launches_per_step": {
              k: launches[k] / BERT_STEPS for k in ("flash_fwd", "flash_bwd_dq",
                                                    "flash_bwd_dkv")},
          "profiled_step": profile, "padded_check": padded,
          "seconds": time.perf_counter() - t_phase, "card": card})
    return launches


def phase_mnist_operator(torch, card, llama_o1):
    """A TpuJob of the port's ``mnist_train`` (one WORKER, one card, 1
    step, as ``bench.py --metric startup`` runs the JAX program's)
    through the port's operator in local mode (``LocalWorld`` with
    subprocess pods) on the card: create -> pod Running -> first step
    (the program's step-1 metrics line) -> ``Succeeded``, beside the
    operator phase's llama child (``llama_o1``)."""
    from k8s_tpu_torch import spec as S
    from k8s_tpu_torch.tools.local_world import LocalWorld

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ktpu-mnist-operator-")
    try:
        world = LocalWorld(subprocess_pods=True, log_dir=tmp, reconcile_interval=0.1)
        with world:
            job = _operator_job("mnist-startup", "--steps=1 --batch_size=8 --log_every=1",
                                obs=False, program="mnist_train")
            run = OperatorRun(world, "mnist-startup", None, tmp, job=job)
            t_step = run.wait_log(lambda t: '"run": "mnist"' in t, "first step",
                                  timeout=MNIST_OPERATOR_DEADLINE_S)
            done, t_done = run.wait_done(timeout=MNIST_OPERATOR_DEADLINE_S)
            t_run = run.first("Pod", run.pod, "Running")
            log = run.log()
            if done.status.state != S.TpuJobState.SUCCEEDED or done.status.gang_restarts:
                fail(f"mnist_operator: {done.status.state} after "
                     f"{done.status.gang_restarts} restarts ({done.status.reason}); "
                     f"log tail {log[-3000:]}")
            line = [json.loads(ln) for ln in log.splitlines() if '"run": "mnist"' in ln]
            if [m["step"] for m in line] != [1] or not np.isfinite(line[0]["loss"]):
                fail(f"mnist_operator: the pod's metrics lines {line}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"create_to_running_s": t_run - run.t_create,
           "running_to_first_step_s": t_step - t_run,
           "first_step_to_succeeded_s": t_done - t_step,
           "create_to_first_step_s": t_step - run.t_create,
           "create_to_succeeded_s": t_done - run.t_create}
    emit({"phase": "mnist_operator", "program": "k8s_tpu_torch.programs.mnist_train",
          "steps": 1, "batch": 8, "state": done.status.state, "metrics": line[0],
          **out,
          "llama_child_create_to_first_step_s": (llama_o1 or {}).get(
              "create_to_first_step_s"),
          "seconds": time.perf_counter() - t_phase, "card": card})
    return out


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


def segment_rows_of(rows, kernel: str, keys) -> list:
    """The ``flash_segments`` rows as a kernel's entry of the ``kernels``
    line: each case's shape and ``keys`` (the timed ones' times)."""
    shape = ("case", "B", "S", "Hq", "Hkv", "D", "causal", "segment_ids")
    return [{k: r[k] for k in shape + tuple(keys) if k in r} for r in rows]


def ring_rows_of(rows, keys) -> list:
    """The ``ring`` phase's variant rows as a kernel's entry of the
    ``kernels`` line: each variant's shape and ``keys``."""
    shape = ("variant", "causal", "kv_row", "B", "S_local", "visible_pairs_per_head")
    return [{k: r[k] for k in shape + tuple(keys) if k in r} for r in rows]


def main() -> None:
    import torch

    # ``--only=launcher`` / ``--only=operator`` / ``--only=operator_rest``
    # / ``--only=sched`` / ``--only=elastic`` / ``--only=resnet`` /
    # ``--only=bert`` / ``--only=ring`` / ``--only=serving``: the build and
    # that phase alone (a debugging aid; it ends with a ``partial`` line,
    # not the ``ok`` one)
    only = [a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--only=")]

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

    if only == ["launcher"]:
        restored, _ = phase_launcher(torch, attn, card, None)
        emit({"partial": only, "launches_restored_serving": restored})
        return
    if only == ["operator"]:
        # the operator phase alone (a debugging aid, as above)
        emit({"partial": only,
              "launches_operator_pods": phase_operator(torch, card, None)[0]})
        return
    if only == ["operator_rest"]:
        emit({"partial": only, "launches_operator_rest_pods":
              phase_operator_rest(torch, card, None, None)})
        return
    if only == ["sched"]:
        emit({"partial": only, "launches_sched_pods": phase_sched(torch, card)[0]})
        return
    if only == ["elastic"]:
        emit({"partial": only, "launches_elastic_pods":
              phase_elastic(torch, card, None)})
        return
    if only == ["resnet"]:
        # the ResNet-50 and MNIST-operator phases alone (a debugging aid)
        emit({"partial": only, "launches_resnet": phase_resnet(torch, attn, card),
              "mnist_operator": phase_mnist_operator(torch, card, None)})
        return
    if only == ["ring"]:
        # the sequence-parallel phase alone (a debugging aid, as above)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        launches, _ = phase_ring(torch, attn, card, gen)
        emit({"partial": only, "launches_ring": launches})
        return
    if only == ["bert"]:
        # the segment-id / head-dim-64 kernel checks and the BERT phase
        # alone (a debugging aid, as above)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        attn.poison_shared_memory(torch.device("cuda"), attn.flash_smem_bytes("fwd", 1))
        phase_flash_segments(torch, attn, gen)
        emit({"partial": only, "launches_bert": phase_bert(torch, attn, card)})
        return
    if only == ["serving"]:
        # the bf16 and int8 serving phases, the prefix cache and
        # speculative decode included (a debugging aid, as above)
        serving, features, new_s = phase_serving(torch, attn, card)
        serving_int8, features8, new8_s = phase_serving_int8(torch, attn, card)
        emit({"partial": only, "launches_serving": serving,
              "launches_serving_int8": serving_int8,
              "launches_features": {**features, **features8},
              "features_seconds": new_s + new8_s})
        return
    if only == ["train"]:
        # the training phases alone (a debugging aid, as above)
        attn.poison_shared_memory(torch.device("cuda"), attn.flash_smem_bytes("fwd", 1))
        train, _, dp = phase_train(torch, attn, card)
        train_fsdp, fsdp = phase_train_fsdp(torch, attn, card, dp)
        emit({"partial": only, "launches_train_fsdp": train_fsdp,
              "launches_train_fsdp_tp": phase_train_fsdp_tp(torch, attn, card, dp, fsdp)})
        return
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # ROADMAP C4: the first K1 launch meets shared memory full of NaN
    # words (the first check runs tile config 1), not what the build or
    # an earlier process left there
    poison = attn.poison_shared_memory(torch.device("cuda"),
                                       attn.flash_smem_bytes("fwd", 1))
    emit({"smem_poison": {"bytes_per_block": poison,
                          "before": "the first K1 check (B 1, S 16, config 1)"}})
    k1 = timed("flash", phase_flash, torch, attn, _kernels, gen)
    bwd = timed("flash_bwd", phase_flash_bwd, torch, attn, _kernels, gen)
    head_split = timed("flash_head_split", phase_flash_head_split, torch, attn, gen)
    segments = timed("flash_segments", phase_flash_segments, torch, attn, gen)
    ring, ring_variants = timed("ring", phase_ring, torch, attn, card, gen)
    k4 = timed("decode", phase_decode, torch, attn, _kernels, gen)
    k5 = timed("decode_q8", phase_decode_q8, torch, attn, _kernels, gen)
    serving, features, features_s = timed("serving", phase_serving, torch, attn, card)
    train, tracer_ms, dp = timed("train", phase_train, torch, attn, card)
    train_fsdp, fsdp = timed("train_fsdp", phase_train_fsdp, torch, attn, card, dp)
    train_fsdp_tp = timed("train_fsdp_tp", phase_train_fsdp_tp, torch, attn, card, dp,
                          fsdp)
    restored, child_first_step_s = timed("launcher", phase_launcher, torch, attn, card,
                                         tracer_ms)
    operator, o1 = timed("operator", phase_operator, torch, card, child_first_step_s)
    operator_rest = timed("operator_rest", phase_operator_rest, torch, card, o1,
                          child_first_step_s)
    sched, sched_times = timed("sched", phase_sched, torch, card)
    elastic = timed("elastic", phase_elastic, torch, card, sched_times)
    serving_int8, features8, features8_s = timed("serving_int8", phase_serving_int8,
                                                 torch, attn, card)
    features.update(features8)
    resnet = timed("resnet", phase_resnet, torch, attn, card)
    bert = timed("bert", phase_bert, torch, attn, card)
    timed("mnist_operator", phase_mnist_operator, torch, card, o1)
    # where the script's time went: each phase's wall (a serving phase's
    # includes its prefix-cache and speculative-decode lines, whose own
    # seconds are apart), from the build's end
    emit({"phase_seconds": PHASE_SECONDS, "serving_features_seconds": features_s + features8_s,
          "since_build_s": sum(PHASE_SECONDS.values())})
    new_paths = add_launches(*features.values())
    launches = {"flash_fwd": serving["flash_fwd"] + new_paths["flash_fwd"] + train["flash_fwd"]
                + train_fsdp["flash_fwd"] + train_fsdp_tp["flash_fwd"]
                + serving_int8["flash_fwd"] + restored["flash_fwd"] + bert["flash_fwd"]
                + ring["flash_fwd"],
                "decode_attn": serving["decode_attn"] + restored["decode_attn"]
                + new_paths["decode_attn"],
                "decode_attn_q8": serving_int8["decode_attn_q8"] + new_paths["decode_attn_q8"],
                "flash_bwd_dq": train["flash_bwd_dq"] + train_fsdp["flash_bwd_dq"]
                + train_fsdp_tp["flash_bwd_dq"] + bert["flash_bwd_dq"] + ring["flash_bwd_dq"],
                "flash_bwd_dkv": train["flash_bwd_dkv"] + train_fsdp["flash_bwd_dkv"]
                + train_fsdp_tp["flash_bwd_dkv"] + bert["flash_bwd_dkv"]
                + ring["flash_bwd_dkv"]}

    # the errors of each kernel row: the worst over its checks, the
    # segment-id / head-dim-64 ones and the ring's f32 variants included
    ring_bwd = [r for r in ring_variants if "dq_rel_err" in r]
    k1 = dict(k1, max_abs_err=max([k1["max_abs_err"]] + [r["k1_max_abs_err"] for r in
                                                         segments + ring_variants]),
              rel_err=max([k1["rel_err"]] + [r["k1_rel_err"] for r in segments + ring_variants]))
    for kernel, keys in (("flash_bwd_dq", ("dq",)), ("flash_bwd_dkv", ("dk", "dv"))):
        bwd[kernel] = dict(bwd[kernel], max_abs_err=max(
            [bwd[kernel]["max_abs_err"]] + [r[k + "_max_abs_err"] for r in segments + ring_bwd
                                            for k in keys]),
            rel_err=max([bwd[kernel]["rel_err"]] + [r[k + "_rel_err"] for r in segments + ring_bwd
                                                    for k in keys]))

    def entry(name, src, replaces, row):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "launches_serving": serving.get(name, 0),
                "launches_train": train.get(name, 0),
                "launches_train_fsdp": train_fsdp.get(name, 0),
                "launches_train_fsdp_tp": train_fsdp_tp.get(name, 0),
                "launches_serving_int8": serving_int8.get(name, 0),
                # the prefix cache and speculative decode (bf16, int8)
                **{f"launches_{k}": v.get(name, 0) for k, v in features.items()},
                "launches_restored_serving": restored.get(name, 0),
                # counted by the operator phases' pods (processes of their
                # own) and printed in their logs
                "launches_operator_pods": operator.get(name, 0),
                "launches_operator_rest_pods": operator_rest.get(name, 0),
                "launches_sched_pods": sched.get(name, 0),
                "launches_elastic_pods": elastic.get(name, 0),
                # the ResNet-50 path runs none of K1-K5 (0, checked)
                "launches_resnet": resnet.get(name, 0),
                # BERT-base training: K1-K3 once per layer and step
                "launches_bert": bert.get(name, 0),
                # sequence parallelism: the 4-rank ring at S 8192, the
                # 2-layer model through the ring and through flash, and
                # llama_train --strategy=fsdp_tp_sp at world size 1
                "launches_ring": ring.get(name, 0),
                "max_abs_err": row["max_abs_err"], "rel_err": row["rel_err"],
                "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "card": card}

    emit({"kernels": [
        dict(entry("flash_fwd", "k8s_tpu_torch/csrc/flash_fwd.cu",
                   "k8s_tpu/ops/attention.py:185", k1),
             shape="B=1 S=256 Hq=32 Hkv=8 D=128 causal (errors: worst over B=1 S in "
                   "16..2048, B=8 S=2048, the B=2 edges and flash_segments)",
             train_shape_ms=k1["train"]["ms"],
             train_shape_bound_ms=k1["train"]["bound_ms"],
             train_shape_library_ms=k1["train"]["library_ms"],
             train_shape_tflops=k1["train"]["tflops"],
             head_split=[{key: r[key] for key in (
                 "Hq", "Hkv", "tensor", "config", "k1_ms", "k1_bound_ms",
                 "k1_bound_by", "k1_plain_ms", "k1_sdpa_ms", "k1_rel_err", "lse_err")}
                 for r in head_split],
             segments=segment_rows_of(segments, "k1", ("config", "k1_ms", "k1_bound_ms",
                                                       "k1_bound_by", "k1_plain_ms",
                                                       "k1_sdpa_ms", "k1_rel_err",
                                                       "lse_err")),
             launches_out_f32=ring["flash_fwd_out_f32"],
             ring=ring_rows_of(ring_variants, ("k1_ms", "k1_bound_ms", "k1_bound_by",
                                               "k1_plain_ms", "k1_sdpa_ms", "k1_rel_err",
                                               "lse_err"))),
        entry("flash_bwd_dq", "k8s_tpu_torch/csrc/flash_bwd.cu",
              "k8s_tpu/ops/attention.py:354", bwd["flash_bwd_dq"])
        | {"shape": bwd["flash_bwd_dq"]["shape"],
           "note": "plain_ms and library_ms compute dq, dk and dv together",
           "head_split": [{key: r[key] for key in (
               "Hq", "Hkv", "tensor", "k2_ms", "k2_bound_ms", "k2_bound_by",
               "bwd_plain_ms", "bwd_sdpa_ms", "dq_rel_err")} for r in head_split],
           "segments": segment_rows_of(segments, "k2", (
               "k2_ms", "k2_bound_ms", "k2_bound_by", "bwd_plain_ms", "bwd_sdpa_ms",
               "dq_rel_err")),
           "launches_grads_f32": ring["flash_bwd_grads_f32"],
           "ring": ring_rows_of(ring_bwd, ("k2_ms", "k2_bound_ms", "k2_bound_by",
                                           "bwd_plain_ms", "bwd_sdpa_ms", "dq_rel_err"))},
        entry("flash_bwd_dkv", "k8s_tpu_torch/csrc/flash_bwd.cu",
              "k8s_tpu/ops/attention.py:414", bwd["flash_bwd_dkv"])
        | {"shape": bwd["flash_bwd_dkv"]["shape"],
           "note": "plain_ms and library_ms compute dq, dk and dv together",
           "head_split": [{key: r[key] for key in (
               "Hq", "Hkv", "tensor", "k3_ms", "k3_bound_ms", "k3_bound_by",
               "bwd_plain_ms", "bwd_sdpa_ms", "dk_rel_err", "dv_rel_err")}
               for r in head_split],
           "segments": segment_rows_of(segments, "k3", (
               "k3_ms", "k3_bound_ms", "k3_bound_by", "bwd_plain_ms", "bwd_sdpa_ms",
               "dk_rel_err", "dv_rel_err")),
           "launches_grads_f32": ring["flash_bwd_grads_f32"],
           "ring": ring_rows_of(ring_bwd, ("k3_ms", "k3_bound_ms", "k3_bound_by",
                                           "bwd_plain_ms", "bwd_sdpa_ms", "dk_rel_err",
                                           "dv_rel_err"))},
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
