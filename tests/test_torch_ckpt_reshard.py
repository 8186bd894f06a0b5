"""Restores across world sizes and strategies through both checkpoint
tiers of the port (k8s_tpu_torch/ckpt/local.py ``overlap_covering_plan``,
ckpt/planner.py, train/checkpoint.py on DCP), on the CPU with gloo — the
restores a resized gang needs (the JAX ``TestLayoutReshard``,
tests/test_ckpt_tiers.py, across data-parallel degrees).

Three training states of a tiny Llama (2 layers, width 64, 8 q / 4 kv
heads, f32), each trained 2 steps from the same init on its own data and
force-saved through the multi-tier manager (the local tier on a shared
root, then DCP):

- ``fsdp_tp`` at 4 ranks, ``llama_train``'s mesh (tensor 4): every
  projection split by columns or rows over 4 ranks;
- ``fsdp`` at 2 ranks: every parameter split by rows over 2;
- one process: whole leaves.

Four gloo processes and two are started once each, together. Each gang
saves its state, then restores the others' into templates of its own:
the 4 ranks restore the ``fsdp_tp`` state into a fresh ``fsdp_tp``
template (every shard's crc, read back from the state, equal to the
manifest's) and into ``fsdp_tp`` at ``MeshConfig(fsdp=2, tensor=2)``,
and the ``fsdp`` and one-process states into both ``fsdp_tp`` layouts;
the 2 ranks restore the ``fsdp_tp`` state into ``fsdp``. This process
restores the ``fsdp_tp`` state into one process. Each restore reads one
tier alone, must restore the saved step (0 steps lost) and give every
leaf bit-equal to the saved whole value. A local-tier restore reads
every stored shard through ``read_shard``'s crc check, so a wrong byte
fails it.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

COMMON = r"""
import os, types
import torch
from k8s_tpu_torch.data import learnable_token_batches
from k8s_tpu_torch.models import LlamaConfig, LlamaForCausalLM, init_params
from k8s_tpu_torch.parallel import LogicalRules, MeshConfig, build_mesh
from k8s_tpu_torch.programs import llama_train
from k8s_tpu_torch.programs.common import RunConfig, build_checkpoint_manager
from k8s_tpu_torch.train import (create_sharded_state, create_train_state,
    init_optimizer_state, make_batch_sharder, make_train_step, state_tree)

CFG = LlamaConfig.tiny(num_layers=2, hidden_size=64, intermediate_size=128,
                       num_heads=8, num_kv_heads=4, head_dim=16,
                       vocab_size=256, dtype=torch.float32)
SAVED_STEP = 2
LAYOUTS = {"fsdp_tp4": ("FSDP_TP", lambda: llama_train.mesh_config_for("fsdp_tp", 4, 1)),
           "fsdp_tp2x2": ("FSDP_TP", lambda: MeshConfig(data=1, fsdp=2, tensor=2)),
           "fsdp2": ("FSDP", lambda: llama_train.mesh_config_for("fsdp", 2, 1))}

def local(t):
    return t.to_local() if hasattr(t, "to_local") else t

def whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t

def build(layout, seed):
    model = LlamaForCausalLM(CFG, device="cpu")
    model.load_params(init_params(CFG, 0, "cpu", dtype=torch.float32))
    if layout == "one":
        state = create_train_state(model, 1e-3)
        shard = lambda b: b
    else:
        rules, mesh_cfg = LAYOUTS[layout]
        mesh = build_mesh(mesh_cfg(), "cpu")
        state = create_sharded_state(model, 1e-3, mesh,
                                     LogicalRules(getattr(LogicalRules, rules)))
        shard = make_batch_sharder(mesh)
    init_optimizer_state(state)
    if seed is not None:
        step = make_train_step(lambda s, b: (llama_train.lm_loss(s.model, b["input_ids"]), {}))
        stream = learnable_token_batches(8, 16, CFG.vocab_size, seed=seed)
        for _ in range(SAVED_STEP):
            step(state, shard({k: torch.from_numpy(v) for k, v in next(stream).items()}))
    return state

def manager(rdzv, local_dir, persist_dir):
    for key in ("KTPU_CKPT_LOCAL_DIR", "KTPU_CKPT_DIR", "KTPU_CKPT_LOCAL_EVERY"):
        os.environ.pop(key, None)
    if local_dir:
        os.environ.update(KTPU_CKPT_LOCAL_DIR=local_dir, KTPU_CKPT_LOCAL_EVERY="1000")
    if persist_dir:
        os.environ["KTPU_CKPT_DIR"] = persist_dir
    cfg = RunConfig()
    cfg.checkpoint_dir = persist_dir
    return build_checkpoint_manager(cfg, rdzv)[0]

def save(rdzv, root, name, state):
    tree = state_tree(state)
    mgr = manager(rdzv, os.path.join(root, name + "-local"), os.path.join(root, name + "-dcp"))
    mgr.save(SAVED_STEP, tree, force=True)
    mgr.wait(); mgr.close()
    full = {k: whole(v).clone() for k, v in tree.items()}
    return tree, full

def restore(rdzv, root, name, tier, tree):
    dirs = ((os.path.join(root, name + "-local"), "") if tier == "local"
            else ("", os.path.join(root, name + "-dcp")))
    mgr = manager(rdzv, *dirs)
    restored = mgr.restore(tree)
    plan = getattr(mgr, "last_restore_plan", None)
    step = plan.step if plan is not None else mgr.latest_step()
    source = plan.source if plan is not None else "persistent"
    mgr.close()
    return restored is not None, step, source

def equal_to(tree, full):
    return all(torch.equal(whole(tree[k]), full[k]) for k in full)
"""

CHILD = COMMON + r"""
import json, sys, time
import torch.distributed as dist
from k8s_tpu_torch.ckpt import LocalTier
from k8s_tpu_torch.ckpt.pipeline import crc32_array, to_numpy
torch.set_num_threads(1)
rank, world, port, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
rdzv = types.SimpleNamespace(process_id=rank, num_processes=world)
own, own_seed, wait_for = (("fsdp_tp4", 11, ("fsdp2", "one")) if world == 4
                           else ("fsdp2", 12, ("fsdp_tp4",)))
state = build(own, own_seed)
tree, full = save(rdzv, root, own, state)
if rank == 0:
    torch.save(full, os.path.join(root, own + "-full.pt"))
dist.barrier()
if rank == 0:
    open(os.path.join(root, own + ".done"), "w").close()
out = {}
if world == 4:
    # the same layout, a fresh template: each shard's crc is the manifest's
    manifest = LocalTier(os.path.join(root, own + "-local"), host_id=rank).manifest(SAVED_STEP)
    for tier in ("local", "dcp"):
        fresh = state_tree(build(own, None))
        ok, step, source = restore(rdzv, root, own, tier, fresh)
        crcs = [crc32_array(to_numpy(local(fresh[path]).detach())) == sh["crc"]
                for path, entry in manifest["leaves"].items()
                for sh in entry["shards"].values()]
        out[f"{own}->{own}:{tier}"] = {"ok": ok, "step": step, "source": source,
                                       "equal": equal_to(fresh, full),
                                       "crc_ok": sum(crcs), "crc_n": len(crcs)}
deadline = time.time() + 240
while not all(os.path.exists(os.path.join(root, n + ".done")) for n in wait_for):
    if time.time() > deadline:
        raise SystemExit(f"no checkpoint from {wait_for}")
    time.sleep(0.2)
targets = ("fsdp_tp4", "fsdp_tp2x2") if world == 4 else ("fsdp2",)
for src in (("fsdp_tp4", "fsdp2", "one") if world == 4 else ("fsdp_tp4",)):
    want = torch.load(os.path.join(root, src + "-full.pt"))
    for dst in targets:
        if src == dst:
            continue
        for tier in ("local", "dcp"):
            fresh = state_tree(build(dst, None))
            ok, step, source = restore(rdzv, root, src, tier, fresh)
            out[f"{src}->{dst}:{tier}"] = {"ok": ok, "step": step, "source": source,
                                           "equal": equal_to(fresh, want)}
print(json.dumps({"rank": rank, "out": out}))
dist.destroy_process_group()
"""

ONE_SAVE = COMMON + r"""
import sys
root = sys.argv[1]
rdzv = types.SimpleNamespace(process_id=0, num_processes=1)
tree, full = save(rdzv, root, "one", build("one", 13))
torch.save(full, os.path.join(root, "one-full.pt"))
open(os.path.join(root, "one.done"), "w").close()
"""

ONE_RESTORE = COMMON + r"""
import json, sys
root = sys.argv[1]
rdzv = types.SimpleNamespace(process_id=0, num_processes=1)
want = torch.load(os.path.join(root, "fsdp_tp4-full.pt"))
out = {}
for tier in ("local", "dcp"):
    fresh = state_tree(build("one", None))
    ok, step, source = restore(rdzv, root, "fsdp_tp4", tier, fresh)
    out[f"fsdp_tp4->one:{tier}"] = {"ok": ok, "step": step, "source": source,
                                    "equal": equal_to(fresh, want)}
print(json.dumps(out))
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("KTPU_")}
    env["PYTHONPATH"] = str(REPO)
    return env


def _run(code, *args):
    res = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


@pytest.fixture(scope="module")
def restores(tmp_path_factory):
    """``{"src->dst:tier": result}`` over every restore, from one start of
    a one-process saver, 4 and 2 gloo processes, and a one-process
    restorer."""
    root = str(tmp_path_factory.mktemp("reshard"))
    gangs = {}
    ports = {w: str(_free_port()) for w in (4, 2)}
    for w in (4, 2):
        gangs[w] = [subprocess.Popen(
            [sys.executable, "-c", CHILD, str(r), str(w), ports[w], root],
            cwd=REPO, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(w)]
    out = {}
    try:
        _run(ONE_SAVE, root)
        for w, procs in gangs.items():
            for p in procs:
                o, err = p.communicate(timeout=300)
                assert p.returncode == 0, err[-4000:]
                res = json.loads(o.strip().splitlines()[-1])
                for key, val in res["out"].items():
                    out.setdefault(key, []).append(val)
    finally:
        for procs in gangs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
    for key, val in json.loads(_run(ONE_RESTORE, root).strip().splitlines()[-1]).items():
        out[key] = [val]
    return out


CROSS = [f"{src}->{dst}" for src, dst in (
    ("fsdp_tp4", "fsdp2"), ("fsdp_tp4", "one"), ("fsdp_tp4", "fsdp_tp2x2"),
    ("fsdp2", "fsdp_tp4"), ("fsdp2", "fsdp_tp2x2"),
    ("one", "fsdp_tp4"), ("one", "fsdp_tp2x2"))]


@pytest.mark.parametrize("tier", ["local", "dcp"])
@pytest.mark.parametrize("case", CROSS)
def test_restores_bit_equal_across_world_sizes_and_strategies(restores, case, tier):
    ranks = restores[f"{case}:{tier}"]
    want_ranks = {"fsdp2": 2, "one": 1}.get(case.split("->")[1], 4)
    assert len(ranks) == want_ranks
    for res in ranks:
        assert res["ok"] and res["step"] == 2  # 0 steps lost
        assert res["equal"]
        assert res["source"] in (("local", "local+peer") if tier == "local"
                                 else ("persistent",))


@pytest.mark.parametrize("tier", ["local", "dcp"])
def test_fsdp_tp_state_restores_into_its_own_layout_with_every_crc(restores, tier):
    ranks = restores[f"fsdp_tp4->fsdp_tp4:{tier}"]
    assert len(ranks) == 4
    for res in ranks:
        assert res["ok"] and res["step"] == 2 and res["equal"]
        assert res["crc_ok"] == res["crc_n"] > 0


def test_an_overlap_plan_tiles_column_blocks_into_a_row_block():
    """The geometry an fsdp_tp (tensor 4) checkpoint read back by an fsdp
    rank needs: no stored [8, 4] column block lies inside the wanted
    [4, 16] row block, but their intersections tile it."""
    import numpy as np

    from k8s_tpu_torch.ckpt import local as tlocal

    full = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    stored = {tlocal.index_key((slice(0, 8), slice(4 * c, 4 * c + 4)), (8, 16)): c
              for c in range(4)}
    want = tlocal.index_key((slice(4, 8), slice(0, 16)), (8, 16))
    sources = [(h, {k}) for k, h in stored.items()]
    assert tlocal.union_covering_plan(want, sources) is None
    plan = tlocal.overlap_covering_plan(want, sources)
    assert sorted(h for _, h in plan) == [0, 1, 2, 3]

    def load(k):
        return np.ascontiguousarray(full[tlocal.parse_index_key(k)])

    got = tlocal.compose_shard(want, [k for k, _ in plan], load)
    assert np.array_equal(got, full[4:8])
    # a gap is no cover
    assert tlocal.overlap_covering_plan(want, sources[:3]) is None
