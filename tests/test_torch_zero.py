"""Data parallel, the ZeRO ladder and FSDP of the port across processes
(k8s_tpu_torch/train/trainer_lib.py ``create_sharded_state``), held on
the CPU with gloo.

Two processes are started once for the module (each pays torch's
import) and run every case in the same process group, one after the
other: ``dp`` at ZeRO stages 0, 1, 2 and 3 (stage 3 selecting
``embed_tokens`` and ``lm_head``), and ``fsdp`` at one slice and at two
(HSDP over ``(data, fsdp)``). Each case trains a tiny Llama (2 layers,
width 64, f32 compute) on the global batch of a deterministic stream,
each rank on its rows, and is held against the one-process port step on
the same global batch (itself held against the JAX step by
tests/test_torch_train.py). Tolerances, as in tests/test_zero1.py and
tests/test_zero23.py for a config that computes in f32: the synced
gradient of one step within rtol 1e-6, atol 1e-7 (the same mean gradient
summed in another order), the parameters after it within lr / 100 (Adam
maps a gradient entry near its eps to about lr times its sign), and a
5-step loss trajectory within rtol 5e-4, atol 5e-5.

Each case also reports its per-rank bytes (the moments of every
shardable leaf 1/DP at stage >= 1; the selected parameters 1/DP at stage
3), its collectives of one step by phase, counted by wrapping
``torch.distributed`` (no all-gather inside the backward at stages
1-3, docs/PERF.md "ZeRO-2/3"), and the ``_unhealthy_state`` verdict of
every rank after a step whose loss one rank alone poisoned (the
nan-grad chaos arm's ``chaos_scale``).

Then ``python -m k8s_tpu_torch.launcher.spmd_launcher`` in two processes
runs ``llama_train --strategy=fsdp`` tiny: exit 0 on both, the same
losses on both ranks, the loss falling. ``configure_platform``'s card
choice is held with a stubbed card count.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
TRAJECTORY = dict(rtol=5e-4, atol=5e-5)

CASES = [
    # name, strategy, zero_stage, num_slices, zero3_leaves
    ("dp-zero0", "dp", 0, 1, ""),
    ("dp-zero1", "dp", 1, 1, ""),
    ("dp-zero2", "dp", 2, 1, ""),
    ("dp-zero3", "dp", 3, 1, "embed_tokens,lm_head"),
    ("fsdp", "fsdp", 0, 1, ""),
    ("hsdp", "fsdp", 0, 2, ""),
]

CHILD = r"""
import json, sys
import torch, torch.distributed as dist
# tiny shapes: one thread per rank beats two ranks fighting over every core
torch.set_num_threads(1)
rank, port, cases = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
from k8s_tpu_torch.data import learnable_token_batches
from k8s_tpu_torch.models import LlamaConfig, LlamaForCausalLM, init_params
from k8s_tpu_torch.parallel import LogicalRules, MeshConfig, build_mesh
from k8s_tpu_torch.programs import llama_train
from k8s_tpu_torch.train import (create_sharded_state, create_train_state,
    make_batch_sharder, make_train_step, state_tree)

CFG = LlamaConfig.tiny(num_layers=2, hidden_size=64, intermediate_size=128,
                       num_heads=4, num_kv_heads=2, head_dim=16,
                       vocab_size=256, dtype=torch.float32)
B, S, STEPS, LR = 4, 16, 5, 1e-3
stream = learnable_token_batches(B, S, CFG.vocab_size, seed=5)
BATCHES = [{k: torch.from_numpy(v) for k, v in next(stream).items()}
           for _ in range(STEPS)]

def loss_fn(state, b):
    loss = llama_train.lm_loss(state.model, b["input_ids"])
    return llama_train._chaos_scaled(loss, b), {}

def fresh_model():
    m = LlamaForCausalLM(CFG, device="cpu")
    m.load_params(init_params(CFG, 0, "cpu", dtype=torch.float32))
    return m

def whole_params(state):
    return {k[len("params/"):]: (v.full_tensor() if hasattr(v, "full_tensor") else v).clone()
            for k, v in state_tree(state).items() if k.startswith("params/")}

# the one-process port step on the global batch
ref = create_train_state(fresh_model(), LR)
ref_step = make_train_step(loss_fn, health=True)
ref_losses, ref_one = [], None
for i, b in enumerate(BATCHES):
    ref_losses.append(float(ref_step(ref, b)[1]["loss"]))
    if i == 0:
        ref_one = whole_params(ref)
        ref_grads = {n: p.grad.clone() for n, p in ref.model.named_parameters()}

def grad_err(state):
    # each optimizer parameter's synced gradient against the same slice
    # of the one-process gradient: (all within tolerance, worst abs err)
    lay = state.layout
    piece = {id(z.piece): z for z in lay.leaves}
    name = {id(p): n for n, p in state.model.named_parameters()}
    ok, worst = True, 0.0
    for q in lay.optimizer_params(state.params()):
        z = piece.get(id(q))
        g = q.grad.full_tensor() if hasattr(q.grad, "full_tensor") else q.grad
        want = ref_grads[z.name if z else name[id(q)]]
        if z is not None:
            n = z.shape[z.dim] // 2
            want = want.narrow(z.dim, dist.get_rank() * n, n)
        ok = ok and torch.allclose(g, want, rtol=1e-6, atol=1e-7)
        worst = max(worst, float((g - want).abs().max()))
    return ok, worst

KINDS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")
calls, phase = [], ["other"]
for kind in KINDS:
    def wrapped(*a, _f=getattr(dist, kind), _k=kind, **kw):
        calls.append((_k, phase[0]))
        return _f(*a, **kw)
    setattr(dist, kind, wrapped)
backward = torch.Tensor.backward
def counted_backward(self, *a, **kw):
    phase[0] = "backward"
    try:
        return backward(self, *a, **kw)
    finally:
        phase[0] = "other"
torch.Tensor.backward = counted_backward

def local(t):
    return t.to_local() if hasattr(t, "to_local") else t

out = {}
for name, strategy, stage, slices, leaves in cases:
    if strategy == "dp":
        mesh = build_mesh(MeshConfig(data=-1), "cpu")
    else:
        mesh = build_mesh(MeshConfig(data=slices, fsdp=2 // slices), "cpu")
    rules = LogicalRules(LogicalRules.DP if strategy == "dp" else LogicalRules.FSDP)
    state = create_sharded_state(fresh_model(), LR, mesh, rules, zero_stage=stage,
                                 zero3_leaves=[s for s in leaves.split(",") if s])
    step = make_train_step(loss_fn, health=True)
    shard = make_batch_sharder(mesh)
    losses, counted = [], None
    for i, b in enumerate(BATCHES):
        calls.clear()
        _, metrics = step(state, shard(b))
        losses.append(float(metrics["loss"]))
        if i == 0:
            one_ok, one_err = grad_err(state)
            got = whole_params(state)
            param_ok = all(torch.allclose(got[k], ref_one[k], rtol=0, atol=LR * 1e-2)
                           for k in ref_one)
            param_err = max(float((got[k] - ref_one[k]).abs().max()) for k in ref_one)
        if i == 1:
            counted = {}
            for kind, ph in calls:
                counted[f"{kind}:{ph}"] = counted.get(f"{kind}:{ph}", 0) + 1
    tree = state_tree(state)
    moments = [k for k, v in tree.items() if k.endswith("/exp_avg")]
    sharded_moments = {k: local(tree[k]).numel() / tree[k].numel()
                       for k in moments if tree[k].ndim >= 2}
    param_frac = {k: local(v).numel() / v.numel() for k, v in tree.items()
                  if k.startswith("params/")}
    clean = llama_train._unhealthy_state(True, metrics)
    poison = {**shard(BATCHES[0]),
              "chaos_scale": torch.tensor(0.0 if rank == 1 else 1.0)}
    _, bad = step(state, poison)
    out[name] = {"losses": losses, "ref_losses": ref_losses, "one_ok": one_ok,
                 "one_err": one_err, "param_ok": param_ok, "param_err": param_err,
                 "collectives": counted,
                 "moment_frac": sharded_moments, "param_frac": param_frac,
                 "verdict_clean": clean,
                 "verdict_poisoned": llama_train._unhealthy_state(True, bad),
                 "backend": dist.get_backend()}
    if state.layout is not None:
        state.layout.close()
print(json.dumps({"rank": rank, "cases": out}))
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env():
    # the repo conftest's KTPU_* keys (8 CPU devices) are not the
    # children's contract
    env = {k: v for k, v in os.environ.items() if not k.startswith("KTPU_")}
    env["PYTHONPATH"] = str(REPO)
    return env


@pytest.fixture(scope="module")
def ranks():
    """Both ranks' results of every case, from one start of 2 processes."""
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(r), port, json.dumps(CASES)],
        cwd=REPO, env=_child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-4000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [o["cases"] for o in sorted(outs, key=lambda o: o["rank"])]


NAMES = [c[0] for c in CASES]


@pytest.mark.parametrize("name", NAMES)
def test_one_step_matches_the_one_process_step(ranks, name):
    """The synced gradient of one step (each rank's shard of it) within
    rtol 1e-6, atol 1e-7 of the one-process gradient on the same global
    batch, and the parameters after the update within lr / 100: Adam
    maps a gradient entry near its eps (1e-8) to an update of about lr
    times its sign, so a rounding-level change of such an entry moves
    the parameter by a share of lr."""
    for rank in ranks:
        res = rank[name]
        assert res["backend"] == "gloo"
        assert res["one_ok"], f"{name}: gradient max abs diff {res['one_err']}"
        assert res["param_ok"], f"{name}: parameter max abs diff {res['param_err']}"


@pytest.mark.parametrize("name", NAMES)
def test_five_step_losses_match_and_agree_across_ranks(ranks, name):
    import numpy as np

    r0, r1 = ranks[0][name], ranks[1][name]
    assert r0["losses"] == r1["losses"]  # the gang's loss, on every rank
    np.testing.assert_allclose(r0["losses"], r0["ref_losses"], **TRAJECTORY)
    assert r0["losses"][-1] < r0["losses"][0]


@pytest.mark.parametrize("name", NAMES)
def test_per_rank_bytes(ranks, name):
    strategy, stage = {c[0]: (c[1], c[2]) for c in CASES}[name]
    for rank in ranks:
        res = rank[name]
        moments = set(res["moment_frac"].values())
        params = res["param_frac"]
        if strategy == "dp" and stage == 0:
            assert moments == {1.0} and set(params.values()) == {1.0}
        elif strategy == "dp":
            # every rank-2 leaf of the tiny config divides DP 2
            assert moments == {0.5}
            sliced = {k for k, v in params.items() if v == 0.5}
            assert sliced == ({"params/embed_tokens", "params/lm_head"}
                              if stage == 3 else set())
        elif name == "fsdp":
            assert moments == {0.5} and set(params.values()) == {0.5}
        else:  # HSDP over (data 2, fsdp 1): replicas of whole shards
            assert moments == {1.0} and set(params.values()) == {1.0}


@pytest.mark.parametrize("name", ["dp-zero0", "dp-zero1", "dp-zero2", "dp-zero3"])
def test_collectives_per_step(ranks, name):
    """One step's collectives by phase. Every stage: one all-reduce of
    the unsliced gradients (a flat bucket: the tiny model's fit one; at
    stage 0 every gradient), and one more of the loss with the shards'
    health sums. Stages 1-3: no all-gather inside the backward; each
    sliced leaf's gradient is reduce-scattered into its piece, at stage 1
    after the backward, at stages 2-3 inside it; 1-2 all-gather every
    slice after the update, 3 gathers its selected leaves in the forward
    instead (the forward is outside the backward here, so both count as
    "other")."""
    got = ranks[0][name]["collectives"]
    assert ranks[1][name]["collectives"] == got
    sliced = 2 * 7 + 2  # the rank-2 leaves
    stage = int(name[-1])
    assert got.get("all_gather_into_tensor:backward", 0) == 0
    if stage == 0:
        assert got == {"all_reduce:other": 2}
        return
    ag = got.get("all_gather_into_tensor:other", 0)
    rs = got.get("reduce_scatter_tensor:backward", 0)
    rs_after = got.get("reduce_scatter_tensor:other", 0)
    ar = got.get("all_reduce:other", 0)
    assert (ag, rs, rs_after, ar) == (sliced, sliced if stage >= 2 else 0,
                                      sliced if stage == 1 else 0, 2)


@pytest.mark.parametrize("name", NAMES)
def test_every_rank_reaches_the_same_unhealthy_verdict(ranks, name):
    for rank in ranks:
        assert rank[name]["verdict_clean"] is False
        assert rank[name]["verdict_poisoned"] is True


LAUNCHER_PROGRAM = r'''
import json
from k8s_tpu_torch.programs import llama_train

def main(rdzv):
    out = llama_train.main(rdzv)
    print(json.dumps({"rank_losses": rdzv.process_id,
                      "first": out["first_loss"], "final": out["final_loss"]}),
          flush=True)
'''


def test_launcher_two_processes_train_fsdp(tmp_path):
    (tmp_path / "rank_losses.py").write_text(LAUNCHER_PROGRAM)
    port = _free_port()
    procs = []
    for r in (0, 1):
        env = _child_env()
        env.update(
            PYTHONPATH=f"{REPO}{os.pathsep}{tmp_path}", OMP_NUM_THREADS="1",
            KTPU_FORCE_PLATFORM="cpu", KTPU_PROCESS_ID=str(r),
            KTPU_NUM_PROCESSES="2", KTPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            KTPU_PROGRAM="rank_losses:main",
            KTPU_PROGRAM_ARGS="--strategy=fsdp --model=tiny --batch_size=4 "
                              "--seq_len=16 --steps=6 --lr=3e-3 "
                              "--data=learnable --log_every=3")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "k8s_tpu_torch.launcher.spmd_launcher"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    lines = [[json.loads(x) for x in o.splitlines() if x.startswith("{")]
             for o in outs]
    mesh = next(e for e in lines[0] if e.get("event") == "mesh")
    assert mesh["shape"]["fsdp"] == 2 and mesh["dp"] == 1
    res = [next(e for e in ln if "rank_losses" in e) for ln in lines]
    assert res[0]["first"] == res[1]["first"]
    assert res[0]["final"] == res[1]["final"] < res[0]["first"]
    assert not [e for e in lines[1] if e.get("event") == "mesh"]


def test_configure_platform_picks_the_local_rank_card(monkeypatch):
    import torch

    from k8s_tpu_torch.launcher import spmd_launcher as launcher

    chosen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    launcher.configure_platform({"LOCAL_RANK": "2", "KTPU_PROCESS_ID": "7"})
    launcher.configure_platform({"KTPU_PROCESS_ID": "7"})  # 7 mod 4
    assert chosen == [2, 3]
    with pytest.raises(RuntimeError, match="names no card"):
        launcher.configure_platform({"LOCAL_RANK": "4"})
    assert chosen == [2, 3]
