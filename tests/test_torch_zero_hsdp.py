"""ZeRO on the HSDP mesh (k8s_tpu_torch/train/trainer_lib.py
``create_sharded_state`` at ``fsdp``/``fsdp_tp`` with ``data`` > 1 and a
ZeRO stage), held on the CPU with gloo against the one-process port step
and the JAX package's layout rule.

One gang of 4 processes is started once for the module and runs every
case in the same process group: ``fsdp`` on ``data`` 2 × ``fsdp`` 2 at
ZeRO stages 1, 2 and 3 (stage 3 selecting ``embed_tokens`` and
``lm_head``, which FSDP2's root unit holds, and again selecting
``q_proj`` and ``down_proj``, which the blocks' units hold), and
``fsdp_tp`` on ``data`` 2 × ``tensor`` 2 at stage 1.
Each case trains a tiny Llama (2 layers, width 64, 8 q / 4 kv heads,
f32) on its rows of the global batch of a deterministic stream. The
tolerances are tests/test_torch_zero.py's for a config that computes in
f32: the synced gradient of one step within rtol 1e-6, atol 1e-7 (under
``fsdp_tp`` rtol 1e-6 plus 5e-6 of the leaf's largest entry, as
tests/test_torch_tp.py states: the split sums move every activation by
about 1e-6), the parameters after it within lr / 100 (lr / 20 under
``fsdp_tp``), the gradient norm of the health block within rtol 1e-5,
and a 5-step loss trajectory within rtol 5e-4, atol 5e-5.

Each case also reports:

- its pieces' placements, which must equal the JAX
  ``zero1_partition_spec`` (``k8s_tpu/parallel/sharding.py``) of the same
  leaf placement on the same mesh shape, and the ``DTensor`` placements
  its checkpoint view carries;
- its per-rank bytes: every rank-2 leaf's moments 1/4 of the leaf (1/2
  of the rank's FSDP2 shard), the rank-1 norms' 1/2 (the JAX rule leaves
  them unsharded over ``data``), and at stage 3 the selected parameters
  1/4;
- its collectives of one step by phase (``torch.distributed`` wrapped)
  and by kind in ``tensor_parallel.COLLECTIVES``: stage 1 reduce-scatters
  each sliced leaf's gradient after the backward, stages 2-3 inside it,
  one bucketed all-reduce of the norms' gradients, one all-gather per
  sliced leaf.

Then a stage-1 state trained on ``data`` 2 × ``fsdp`` 2 is saved through
both checkpoint tiers and restored into ``data`` 1 × ``fsdp`` 4, and the
reverse, every leaf equal to the saved whole value.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
TRAJECTORY = dict(rtol=5e-4, atol=5e-5)
WORLD = 4

CASES = [
    # name, strategy, zero_stage, mesh (data, fsdp, tensor), zero3_leaves
    ("hsdp-zero1", "fsdp", 1, (2, 2, 1), ""),
    ("hsdp-zero2", "fsdp", 2, (2, 2, 1), ""),
    ("hsdp-zero3", "fsdp", 3, (2, 2, 1), "embed_tokens,lm_head"),
    ("hsdp-blocks-zero3", "fsdp", 3, (2, 2, 1), "q_proj,down_proj"),
    ("hsdp-tp-zero1", "fsdp_tp", 1, (2, 1, 2), ""),
]

CHILD = r"""
import json, os, sys, types
import torch, torch.distributed as dist
torch.set_num_threads(1)
rank, port, root, cases = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                           json.loads(sys.argv[4]))
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=4)
from k8s_tpu_torch.data import learnable_token_batches
from k8s_tpu_torch.models import LlamaConfig, LlamaForCausalLM, init_params
from k8s_tpu_torch.parallel import LogicalRules, MeshConfig, build_mesh
from k8s_tpu_torch.parallel import tensor_parallel as tp
from k8s_tpu_torch.programs import llama_train
from k8s_tpu_torch.programs.common import RunConfig, build_checkpoint_manager
from k8s_tpu_torch.train import (create_sharded_state, create_train_state,
    init_optimizer_state, make_batch_sharder, make_train_step, state_tree)

CFG = LlamaConfig.tiny(num_layers=2, hidden_size=64, intermediate_size=128,
                       num_heads=8, num_kv_heads=4, head_dim=16,
                       vocab_size=256, dtype=torch.float32)
B, S, STEPS, LR = 8, 16, 5, 1e-3
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

def whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t

def local(t):
    return t.to_local() if hasattr(t, "to_local") else t

def whole_params(state):
    return {k[len("params/"):]: whole(v).clone()
            for k, v in state_tree(state).items() if k.startswith("params/")}

ref = create_train_state(fresh_model(), LR)
ref_step = make_train_step(loss_fn, health=True)
ref_losses = []
for i, b in enumerate(BATCHES):
    _, m = ref_step(ref, b)
    ref_losses.append(float(m["loss"]))
    if i == 0:
        ref_one = whole_params(ref)
        ref_norm = float(m["grad_norm"])
        ref_grads = {n: p.grad.clone() for n, p in ref.model.named_parameters()}

def grad_err(state, tensor):
    # each optimizer parameter's synced gradient against the same block
    # of the one-process gradient: (all within tolerance, worst abs err)
    from k8s_tpu_torch.parallel.sharding import local_index
    lay = state.layout
    piece = {id(z.piece): z for z in lay.leaves}
    name = {id(p): n for n, p in state.model.named_parameters()}
    ok, worst = True, 0.0
    for q in lay.optimizer_params(state.params()):
        z = piece.get(id(q))
        g = local(q.grad)
        want = ref_grads[z.name if z else name[id(q)]]
        idx = (local_index(lay.leaf_tensor(z, z.piece.detach())) if z
               else local_index(q))
        want = want[idx]
        atol = 1e-7 + (5e-6 * float(want.abs().max()) if tensor else 0.0)
        ok = ok and torch.allclose(g, want, rtol=1e-6, atol=atol)
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

def sharded_state(strategy, stage, mesh_cfg, leaves=()):
    mesh = build_mesh(mesh_cfg, "cpu")
    rules = LogicalRules(LogicalRules.FSDP if strategy == "fsdp"
                         else LogicalRules.FSDP_TP)
    st = create_sharded_state(fresh_model(), LR, mesh, rules,
                              zero_stage=stage, zero3_leaves=list(leaves))
    return st, make_batch_sharder(mesh)

out = {}
for name, strategy, stage, (d, f, t), leaves in cases:
    state, shard = sharded_state(strategy, stage,
                                 MeshConfig(data=d, fsdp=f, tensor=t),
                                 [s for s in leaves.split(",") if s])
    step = make_train_step(loss_fn, health=True)
    losses = []
    for i, b in enumerate(BATCHES):
        calls.clear()
        tp.reset_counts()
        _, metrics = step(state, shard(b))
        losses.append(float(metrics["loss"]))
        if i == 0:
            one_ok, one_err = grad_err(state, t > 1)
            norm = float(metrics["grad_norm"])
            got = whole_params(state)
            tol = LR * (5e-2 if t > 1 else 1e-2)
            param_ok = all(torch.allclose(got[k], ref_one[k], rtol=0, atol=tol)
                           for k in ref_one)
            param_err = max(float((got[k] - ref_one[k]).abs().max())
                            for k in ref_one)
        if i == 1:
            counted = {}
            for kind, ph in calls:
                counted[f"{kind}:{ph}"] = counted.get(f"{kind}:{ph}", 0) + 1
            kinds = {k: v for k, v in tp.COLLECTIVES.items()
                     if k.startswith("data_")}
    tree = state_tree(state)
    lay = state.layout
    out[name] = {
        "losses": losses, "ref_losses": ref_losses, "one_ok": one_ok,
        "one_err": one_err, "param_ok": param_ok, "param_err": param_err,
        "grad_norm": norm, "ref_grad_norm": ref_norm,
        "collectives": counted, "kinds": kinds,
        "zspec": {z.name: [list(e) if isinstance(e, tuple) else e
                           for e in z.zspec] for z in lay.leaves},
        "zplace": {z.name: [str(p) for p in
                            tree[f"opt/{z.name}/exp_avg"].placements]
                   for z in lay.leaves},
        "stage3": sorted(z.name for z in lay.leaves if z.stage3),
        "moment_frac": {k: local(v).numel() / v.numel()
                        for k, v in tree.items() if k.endswith("/exp_avg")},
        "param_frac": {k: local(v).numel() / v.numel()
                       for k, v in tree.items() if k.startswith("params/")},
        "shapes": {n: list(p.shape) for n, p in
                   fresh_model().named_parameters()},
        "verdict_clean": llama_train._unhealthy_state(True, metrics),
    }
    lay.close()

# -- save at one data size, restore at the other ---------------------------

def manager(local_dir, persist_dir):
    for key in ("KTPU_CKPT_LOCAL_DIR", "KTPU_CKPT_DIR", "KTPU_CKPT_LOCAL_EVERY"):
        os.environ.pop(key, None)
    if local_dir:
        os.environ.update(KTPU_CKPT_LOCAL_DIR=local_dir,
                          KTPU_CKPT_LOCAL_EVERY="1000")
    if persist_dir:
        os.environ["KTPU_CKPT_DIR"] = persist_dir
    cfg = RunConfig()
    cfg.checkpoint_dir = persist_dir
    rdzv = types.SimpleNamespace(process_id=rank, num_processes=4)
    return build_checkpoint_manager(cfg, rdzv)[0]

LAYOUTS = {"data2": MeshConfig(data=2, fsdp=2), "data1": MeshConfig(data=1, fsdp=4)}
SAVED = 2
restores = {}
for src, dst in (("data2", "data1"), ("data1", "data2")):
    state, shard = sharded_state("fsdp", 1, LAYOUTS[src])
    init_optimizer_state(state)
    step = make_train_step(loss_fn)
    for b in BATCHES[:SAVED]:
        step(state, shard(b))
    tree = state_tree(state)
    full = {k: whole(v).clone() for k, v in tree.items()}
    dirs = {"local": (os.path.join(root, src + "-local"), ""),
            "dcp": ("", os.path.join(root, src + "-dcp"))}
    mgr = manager(dirs["local"][0], dirs["dcp"][1])
    mgr.save(SAVED, tree, force=True)
    mgr.wait(); mgr.close()
    state.layout.close()
    dist.barrier()
    for tier, (ld, pd) in dirs.items():
        fresh, _ = sharded_state("fsdp", 1, LAYOUTS[dst])
        init_optimizer_state(fresh)
        ftree = state_tree(fresh)
        mgr = manager(ld, pd)
        got = mgr.restore(ftree)
        plan = getattr(mgr, "last_restore_plan", None)
        mgr.close()
        from k8s_tpu_torch.train import load_state_tree
        if got is not None:
            load_state_tree(fresh, got if isinstance(got, dict) else ftree)
        after = state_tree(fresh)
        restores[f"{src}->{dst}:{tier}"] = {
            "ok": got is not None,
            "step": plan.step if plan is not None else mgr.latest_step(),
            "equal": all(torch.equal(whole(after[k]), full[k]) for k in full),
            "dtensor_moments": sum(hasattr(v, "placements") and
                                   k.endswith("exp_avg") for k, v in after.items()),
        }
        fresh.layout.close()
print(json.dumps({"rank": rank, "cases": out, "restores": restores}))
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("KTPU_")}
    env["PYTHONPATH"] = str(REPO)
    return env


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Every rank's results, from one start of 4 processes."""
    root = str(tmp_path_factory.mktemp("zero_hsdp"))
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(r), port, root, json.dumps(CASES)],
        cwd=REPO, env=_child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-4000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return sorted(outs, key=lambda o: o["rank"])


NAMES = [c[0] for c in CASES]


@pytest.mark.parametrize("name", NAMES)
def test_one_step_matches_the_one_process_step(gang, name):
    for rank in gang:
        res = rank["cases"][name]
        assert res["one_ok"], f"{name}: gradient max abs diff {res['one_err']}"
        assert res["param_ok"], f"{name}: parameter max abs diff {res['param_err']}"
        np.testing.assert_allclose(res["grad_norm"], res["ref_grad_norm"],
                                   rtol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_five_step_losses_match_and_agree_across_ranks(gang, name):
    losses = [rank["cases"][name]["losses"] for rank in gang]
    assert all(x == losses[0] for x in losses)
    np.testing.assert_allclose(losses[0], gang[0]["cases"][name]["ref_losses"],
                               **TRAJECTORY)
    assert losses[0][-1] < losses[0][0]
    assert all(r["cases"][name]["verdict_clean"] is False for r in gang)


def _port_placement(name, strategy):
    from k8s_tpu_torch.parallel.sharding import LogicalRules, param_placement

    table = LogicalRules.FSDP if strategy == "fsdp" else LogicalRules.FSDP_TP
    return param_placement(name, LogicalRules(table))


@pytest.mark.parametrize("name", NAMES)
def test_placements_are_the_jax_zero1_partition_spec(gang, name):
    """Every rank-2 leaf is sliced, at the JAX rule's placement of the
    same leaf placement on the same mesh shape, and its moments'
    checkpoint view carries that placement (the ``(fsdp, tensor, data)``
    mesh, each axis a ``Shard`` of its dimension)."""
    from jax.sharding import PartitionSpec as P

    from k8s_tpu.parallel.sharding import zero1_partition_spec as jax_zero1
    from k8s_tpu_torch.parallel.sharding import shard_dim

    _, strategy, _, (d, f, t), _ = next(c for c in CASES if c[0] == name)
    sizes = {"data": d, "fsdp": f, "stage": 1, "expert": 1, "seq": 1,
             "tensor": t}
    mesh = type("Mesh", (), {"shape": sizes})()
    res = gang[0]["cases"][name]
    ranks2 = {n for n, shape in res["shapes"].items() if len(shape) >= 2}
    assert set(res["zspec"]) == ranks2
    for leaf, got in res["zspec"].items():
        placement = _port_placement(leaf, strategy)
        want = jax_zero1(P(*placement), res["shapes"][leaf], mesh)
        want = tuple(tuple(e) if isinstance(e, tuple) else e for e in want)
        got = tuple(tuple(e) if isinstance(e, list) else e for e in got)
        assert got == want, leaf
        expect = [f"S({shard_dim(got, a)})"
                  if shard_dim(got, a) is not None else "R"
                  for a in ("fsdp", "tensor", "data")]
        assert res["zplace"][leaf] == expect, leaf
    for rank in gang[1:]:
        assert rank["cases"][name]["zspec"] == res["zspec"]


@pytest.mark.parametrize("name", NAMES)
def test_moment_and_parameter_bytes_per_rank(gang, name):
    stage = int(name[-1])
    leaves = [s for s in next(c for c in CASES if c[0] == name)[4].split(",")
              if s]
    for rank in gang:
        res = rank["cases"][name]
        for key, frac in res["moment_frac"].items():
            leaf = key[len("opt/"):-len("/exp_avg")]
            rank2 = len(res["shapes"][leaf]) >= 2
            # rank-2: 1/4 (data x fsdp, or data x tensor); the norms
            # follow their FSDP2 (or tensor-replicated) shard
            want = 0.25 if rank2 else (0.5 if "tp" not in name else 1.0)
            assert frac == want, (key, frac)
        sel = {f"params/{n}" for n in res["stage3"]}
        assert sel == ({f"params/{n}" for n, shape in res["shapes"].items()
                        if len(shape) >= 2 and any(s in n for s in leaves)}
                       if stage == 3 else set())
        assert len(sel) == (2 if "blocks" not in name else 4) * (stage == 3)
        for key, frac in res["param_frac"].items():
            if key in sel:
                assert frac == 0.25, key
            else:
                assert frac in (0.5, 1.0), key


@pytest.mark.parametrize("name", NAMES)
def test_collectives_over_data_per_step(gang, name):
    """The ``data`` collectives of one step, by kind and by phase: one
    reduce-scatter and one all-gather per sliced leaf (stage 1 after the
    backward, stages 2-3 inside it; stage 3 gathers its selected leaves
    in the forward), one bucketed all-reduce of the unsliced gradients,
    and one all-reduce of the loss with the health sums."""
    stage = int(name[-1])
    res = gang[0]["cases"][name]
    sliced = len(res["zspec"])
    assert res["kinds"] == {"data_reduce_scatter": sliced,
                            "data_all_gather": sliced,
                            "data_all_reduce": 1}
    got = res["collectives"]
    rs_backward = got.get("reduce_scatter_tensor:backward", 0)
    rs_other = got.get("reduce_scatter_tensor:other", 0)
    # (FSDP2's own collectives over fsdp do not call the wrapped
    # functions, so these are the data axis's alone)
    if stage == 1:
        assert (rs_other, rs_backward) == (sliced, 0)
    else:
        assert (rs_other, rs_backward) == (0, sliced)
    assert got.get("all_gather_into_tensor:backward", 0) == 0
    for rank in gang[1:]:
        assert rank["cases"][name]["kinds"] == res["kinds"]


@pytest.mark.parametrize("case", ["data2->data1", "data1->data2"])
@pytest.mark.parametrize("tier", ["local", "dcp"])
def test_stage1_state_restores_across_data_sizes(gang, case, tier):
    """A stage-1 state saved at one data size restores at the other from
    one tier alone, at the saved step, every leaf equal to the saved
    whole value; the moments stay ``DTensor`` shards."""
    for rank in gang:
        res = rank["restores"][f"{case}:{tier}"]
        assert res["ok"] and res["step"] == 2, res
        assert res["equal"], res
        assert res["dtensor_moments"] > 0
