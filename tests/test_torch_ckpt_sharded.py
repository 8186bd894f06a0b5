"""Sharded training state through both checkpoint tiers of the port
(k8s_tpu_torch/ckpt/local.py, ckpt/planner.py, train/checkpoint.py) on
the CPU with gloo.

Two processes are started once for the module. Each builds a tiny Llama
state (2 layers, width 64, f32) sharded over the two ranks — ``fsdp``
(FSDP2 ``DTensor`` s) and ``dp`` at ZeRO stage 3 (``embed_tokens`` and
``lm_head`` sliced, every moment sliced) — trains it two steps and
force-saves it through the multi-tier manager (the local tier on a
shared root, then DCP, every rank its shards). Then each rank scribbles
over its state and restores it, once from the local tier alone and once
from DCP alone, into the same layout: every leaf must come back
bit-equal, every shard's crc (read back from the state) must equal the
manifest's, and the restored step must be the saved one (0 lost steps).

Across layouts on the local tier: the stage-3 checkpoint restores into
a stage-0 template (each whole leaf tiled from both hosts' slices by
``union_covering_plan``) and a stage-0 checkpoint into a stage-3
template (each slice cut from a whole stored shard by
``covering_plan``), bit-equal to the whole values. In this process, the
two-rank DCP checkpoint of the ``fsdp`` state loads into one process's
replicated template — serving's restore. A ``gpu`` test saves and
restores a world-size-1 ``fsdp`` state on the card.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

CHILD = r"""
import json, os, sys, types
import torch, torch.distributed as dist
# tiny shapes: one thread per rank beats two ranks fighting over every core
torch.set_num_threads(1)
rank, port, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
from k8s_tpu_torch.ckpt import LocalTier
from k8s_tpu_torch.ckpt.pipeline import crc32_array, to_numpy
from k8s_tpu_torch.data import learnable_token_batches
from k8s_tpu_torch.models import LlamaConfig, LlamaForCausalLM, init_params
from k8s_tpu_torch.parallel import LogicalRules, MeshConfig, build_mesh
from k8s_tpu_torch.programs import llama_train
from k8s_tpu_torch.programs.common import RunConfig, build_checkpoint_manager
from k8s_tpu_torch.train import (create_sharded_state, init_optimizer_state,
    make_batch_sharder, make_train_step, state_tree)

CFG = LlamaConfig.tiny(num_layers=2, hidden_size=64, intermediate_size=128,
                       num_heads=4, num_kv_heads=2, head_dim=16,
                       vocab_size=256, dtype=torch.float32)
rdzv = types.SimpleNamespace(process_id=rank, num_processes=2)
stream = learnable_token_batches(4, 16, CFG.vocab_size, seed=2)
BATCHES = [{k: torch.from_numpy(v) for k, v in next(stream).items()} for _ in range(2)]

def local(t):
    return t.to_local() if hasattr(t, "to_local") else t

def whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t

def build(strategy, stage, trained):
    mesh = build_mesh(MeshConfig(data=-1) if strategy == "dp"
                      else MeshConfig(data=1, fsdp=2), "cpu")
    rules = LogicalRules(LogicalRules.DP if strategy == "dp" else LogicalRules.FSDP)
    model = LlamaForCausalLM(CFG, device="cpu")
    model.load_params(init_params(CFG, 0, "cpu", dtype=torch.float32))
    state = create_sharded_state(model, 1e-3, mesh, rules, zero_stage=stage,
                                 zero3_leaves=["embed_tokens", "lm_head"])
    init_optimizer_state(state)
    if trained:
        step = make_train_step(lambda s, b: (llama_train.lm_loss(s.model, b["input_ids"]), {}))
        shard = make_batch_sharder(mesh)
        for b in BATCHES:
            step(state, shard(b))
    return state

def manager(local_dir, persist_dir):
    os.environ.pop("KTPU_CKPT_LOCAL_DIR", None)
    os.environ.pop("KTPU_CKPT_DIR", None)
    if local_dir:
        os.environ.update(KTPU_CKPT_LOCAL_DIR=local_dir, KTPU_CKPT_LOCAL_EVERY="1000")
    if persist_dir:
        os.environ["KTPU_CKPT_DIR"] = persist_dir
    cfg = RunConfig()
    cfg.checkpoint_dir = persist_dir
    return build_checkpoint_manager(cfg, rdzv)[0]

def scribble(tree):
    with torch.no_grad():
        for k, v in tree.items():
            if k != "step" and local(v).is_floating_point():
                local(v).fill_(7.0)

out = {}
for name, strategy, stage in (("fsdp", "fsdp", 0), ("zero3", "dp", 3)):
    state = build(strategy, stage, trained=True)
    tree = state_tree(state)
    saved = {k: local(v).clone() for k, v in tree.items()}
    ldir, pdir = os.path.join(root, name + "-local"), os.path.join(root, name + "-dcp")
    mgr = manager(ldir, pdir)
    mgr.save(2, tree, force=True)
    mgr.wait(); mgr.close()
    manifest = LocalTier(ldir, host_id=rank).manifest(2)
    res = {}
    for tier, dirs in (("local", (ldir, "")), ("dcp", ("", pdir))):
        scribble(tree)
        mgr = manager(*dirs)
        restored = mgr.restore(tree)
        step = (mgr.last_restore_plan.step if hasattr(mgr, "last_restore_plan")
                else mgr.latest_step())
        equal = all(torch.equal(local(restored[k]), saved[k]) for k in saved)
        crcs = []
        for path, entry in manifest["leaves"].items():
            for key, shard in entry["shards"].items():
                crcs.append(crc32_array(to_numpy(local(restored[path]).detach()))
                            == shard["crc"])
        res[tier] = {"equal": equal, "step": step, "crc_ok": sum(crcs),
                     "crc_n": len(crcs), "sharded": sum(hasattr(v, "placements")
                                                         for v in tree.values())}
        mgr.close()
    full = {k: whole(v).clone() for k, v in tree.items() if k != "step"}
    if name == "fsdp" and rank == 0:
        torch.save({k[len("params/"):]: v for k, v in full.items()
                    if k.startswith("params/")}, os.path.join(root, "fsdp-full.pt"))
    if name == "zero3":
        # across stages on the local tier: stage 3 -> stage 0 and back
        dense = build("dp", 0, trained=False)
        dtree = state_tree(dense)
        mgr = manager(ldir, "")
        mgr.restore(dtree)
        res["to_stage0"] = all(torch.equal(dtree[k], full[k]) for k in full)
        mgr.close()
        d0 = os.path.join(root, "stage0-local")
        mgr = manager(d0, "")
        mgr.save(2, dtree, force=True)
        mgr.wait(); mgr.close()
        back = build("dp", 3, trained=False)
        btree = state_tree(back)
        mgr = manager(d0, "")
        mgr.restore(btree)
        res["to_stage3"] = all(torch.equal(local(btree[k]), saved[k]) for k in saved)
        mgr.close()
    out[name] = res
print(json.dumps({"rank": rank, "out": out}))
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded")
    env = {k: v for k, v in os.environ.items() if not k.startswith("KTPU_")}
    env["PYTHONPATH"] = str(REPO)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), port, str(root)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
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
    return root, [o["out"] for o in sorted(outs, key=lambda o: o["rank"])]


@pytest.mark.parametrize("case", ["fsdp", "zero3"])
@pytest.mark.parametrize("tier", ["local", "dcp"])
def test_sharded_state_restores_bit_equal(run, case, tier):
    _, ranks = run
    for res in ranks:
        got = res[case][tier]
        assert got["sharded"] > 0
        assert got["equal"] and got["step"] == 2
        assert got["crc_ok"] == got["crc_n"] > 0


@pytest.mark.parametrize("direction", ["to_stage0", "to_stage3"])
def test_stage3_checkpoint_restores_across_zero_stages(run, direction):
    _, ranks = run
    assert all(res["zero3"][direction] for res in ranks)


def test_two_rank_dcp_checkpoint_loads_into_a_replicated_template(run):
    from k8s_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from k8s_tpu_torch.train.checkpoint import CheckpointManager

    root, _ = run
    cfg = LlamaConfig.tiny(num_layers=2, hidden_size=64, intermediate_size=128,
                           num_heads=4, num_kv_heads=2, head_dim=16,
                           vocab_size=256, dtype=torch.float32)
    model = LlamaForCausalLM(cfg, device="cpu")
    template = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    CheckpointManager(str(root / "fsdp-dcp")).restore_params(template, step=2)
    want = torch.load(root / "fsdp-full.pt")
    assert set(template) == set(want)
    for n, t in template.items():
        assert torch.equal(t, want[n]), n


@pytest.mark.gpu
def test_fsdp_world_one_save_and_restore_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: an NCCL group of one process")
    env = {k: v for k, v in os.environ.items() if not k.startswith("KTPU_")}
    env["PYTHONPATH"] = str(REPO)
    code = r"""
import sys, torch
from k8s_tpu_torch.models import LlamaConfig, LlamaForCausalLM, init_params
from k8s_tpu_torch.parallel import LogicalRules, MeshConfig, build_mesh
from k8s_tpu_torch.train import create_sharded_state, init_optimizer_state, state_tree
from k8s_tpu_torch.train.checkpoint import CheckpointManager
import torch.distributed as dist
torch.cuda.set_device(0)
cfg = LlamaConfig.llama3_8b(num_layers=1, hidden_size=512, intermediate_size=1024,
                            num_heads=4, num_kv_heads=2, vocab_size=1024)
model = LlamaForCausalLM(cfg, device="cuda")
model.load_params(init_params(cfg, 0, "cuda", dtype=torch.float32))
mesh = build_mesh(MeshConfig(data=1, fsdp=1), "cuda")
assert dist.get_backend() == "nccl"
state = create_sharded_state(model, 1e-3, mesh, LogicalRules(LogicalRules.FSDP))
init_optimizer_state(state)
tree = state_tree(state)
saved = {k: (v.to_local() if hasattr(v, "to_local") else v).clone() for k, v in tree.items()}
mgr = CheckpointManager(sys.argv[1], process_group=dist.new_group(backend="gloo"))
assert mgr.save(1, tree, force=True)
for v in tree.values():
    if hasattr(v, "to_local"):
        v.to_local().zero_()
mgr.restore(tree, step=1)
assert all(torch.equal((v.to_local() if hasattr(v, "to_local") else v), saved[k])
           for k, v in tree.items())
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]
