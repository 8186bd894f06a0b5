"""Tensor parallelism of the port (k8s_tpu_torch/parallel/tensor_parallel.py,
the ``FSDP_TP`` rules, ``ops/attention.py`` ``flash_attention_sharded``,
the vocab-parallel ``fused_lm_head_cross_entropy`` and embedding lookup,
``train/trainer_lib.py`` under ``FSDP_TP``, ``llama_train
--strategy=fsdp_tp``) held on the CPU against the JAX package and the
one-process port step.

In this process: every parameter's ``TP`` and ``FSDP_TP`` placement
against the JAX rules applied by flax to the JAX llama's logical axes,
and the ``fsdp_tp`` mesh against the JAX program's ``_mesh_for`` on the
conftest's forced CPU devices.

Two groups of gloo processes, 2 ranks and 4, are started once each for
the module and run every case in turn:

- the head split: each rank's ``flash_attention_sharded`` output on its
  block, reassembled, against the JAX ``flash_attention_sharded`` (its
  Pallas kernel in interpret mode) at ``MeshConfig(fsdp=2, tensor=2)``
  and ``MeshConfig(tensor=4)``, f32, within 2e-5 absolute; and the JAX
  divisibility error for heads the tensor axis does not divide, from
  the function and from ``create_sharded_state``;
- the vocab-parallel fused CE and embedding at tensor 2 and 4 against
  the one-process port and the JAX mesh-free fused CE, within
  tests/test_torch_fused_ce.py's f32 tolerances (rtol 2e-5, atol 1e-6);
  the embedding's output and gradient bit-equal (one rank contributes
  each row);
- the train step, a tiny Llama (2 layers, width 64, 8 q / 4 kv heads of
  16, MLP 128, vocab 256, f32, ``flash`` remat) held against the
  one-process port step on the same global batch, as
  tests/test_torch_zero.py holds ``fsdp``: ``llama_train``'s ``fsdp_tp``
  mesh at 2 ranks (tensor 2) and at 4 (tensor 4; and 2 slices: data 2 x
  tensor 2), and ``create_sharded_state`` at ``MeshConfig(fsdp=2,
  tensor=2)``. Gradients of one step within rtol 1e-6 and an atol of
  5e-6 of each leaf's largest entry, parameters after it within lr / 20
  (test_torch_zero holds fsdp at atol 1e-7 and lr / 100; GRAD_SCALE_ATOL
  says why the split sums need more), 5-step losses at test_torch_zero's
  rtol 5e-4 / atol 5e-5; the grad norm within rtol 1e-6 and the
  nan-grad verdict equal on every rank; and one step's tensor-axis
  collectives counted by kind against
  ``tensor_parallel.expected_per_step``.

Then ``python -m k8s_tpu_torch.launcher.spmd_launcher`` in two
processes runs ``llama_train --strategy=fsdp_tp`` tiny. (K1-K3 at the
per-rank head counts of tensor 2 and 4 on the card: the ``gpu`` test
``test_flash_kernels_at_tensor_parallel_head_counts_on_card`` of
tests/test_torch_kernels.py, a file without JAX.)
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from k8s_tpu.models import LlamaConfig as JaxConfig
from k8s_tpu.models import LlamaForCausalLM as JaxLlama
from k8s_tpu.ops.attention import flash_attention_sharded as jax_flash_sharded
from k8s_tpu.ops.fused_ce import fused_lm_head_cross_entropy as jax_fused_ce
from k8s_tpu.parallel import mesh as jmesh
from k8s_tpu.parallel import sharding as jsharding
from k8s_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from k8s_tpu_torch.parallel import sharding as tsharding
from k8s_tpu_torch.parallel import tensor_parallel as ttp
from k8s_tpu_torch.programs import llama_train

REPO = pathlib.Path(__file__).resolve().parent.parent
F32 = dict(rtol=2e-5, atol=1e-6)  # tests/test_torch_fused_ce.py's
TRAJECTORY = dict(rtol=5e-4, atol=5e-5)
FLASH_ATOL = 2e-5
# head split inputs: B 2, S 32, 8 q / 4 kv heads of 16
FLASH_SHAPE = (2, 32, 8, 4, 16)
FLASH_MESHES = {"fsdp2xtp2": dict(fsdp=2, tensor=2), "tp4": dict(tensor=4)}
# vocab-parallel CE inputs (the vocab divides 2 and 4), and its cases
CE_SHAPE = dict(b=2, s=9, e=24, v=96)
CE_CASES = [(False, 0.0), (True, 1e-4)]  # (mask, z_loss)
STEP_CASES = {2: ["tp2"], 4: ["tp4", "dp2xtp2", "fsdp2xtp2"]}
LAYERS = 2
# test_torch_zero holds fsdp's gradients at rtol 1e-6 / atol 1e-7 and
# its parameters after one AdamW update at lr / 100. Tensor parallelism
# sums each row-parallel output over the ranks' partial products, in
# another order than one process's product, and every activation and
# gradient downstream moves by ~1e-6 of its scale: worst 1.4e-6 of a
# leaf's largest gradient entry here (the embedding's reaches 0.83). So
# gradients are held at rtol 1e-6 with an atol of 5e-6 times the leaf's
# largest entry. AdamW's first update is lr g / (|g| + eps): an entry
# with |g| near eps (1e-8) moves by up to lr dg / eps, and those ~1e-13
# changes move such parameters by up to lr / 70 here (lr / 500 for
# fsdp), so parameters are held at lr / 20.
GRAD_SCALE_ATOL = 5e-6
PARAM_LR_SHARE = 1 / 20

CHILD = r"""
import json, sys
import numpy as np
import torch, torch.distributed as dist
# tiny shapes: one thread per rank beats the ranks fighting over every core
torch.set_num_threads(1)
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
spec = json.loads(sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
from k8s_tpu_torch.data import learnable_token_batches
from k8s_tpu_torch.models import LlamaConfig, LlamaForCausalLM, init_params
from k8s_tpu_torch.ops.attention import flash_attention_sharded
from k8s_tpu_torch.ops.fused_ce import fused_lm_head_cross_entropy
from k8s_tpu_torch.parallel import LogicalRules, MeshConfig, build_mesh
from k8s_tpu_torch.parallel import tensor_parallel as tp
from k8s_tpu_torch.parallel.mesh import mesh_shape
from k8s_tpu_torch.parallel.sharding import sharded_embedding_lookup
from k8s_tpu_torch.programs import llama_train
from k8s_tpu_torch.train import (create_sharded_state, create_train_state,
    make_batch_sharder, make_train_step, state_tree)

out = {"backend": dist.get_backend()}

def coords(mesh):
    sizes = mesh_shape(mesh)
    c = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    return sizes, c["data"] * sizes["fsdp"] + c["fsdp"], c["tensor"]

# -- the head split -------------------------------------------------------
if world == 4:
    b, s, hq, hkv, d = spec["flash_shape"]
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
               for h in (hq, hkv, hkv))
    out["flash"] = {}
    for name, cfg in spec["flash_meshes"].items():
        mesh = build_mesh(MeshConfig(data=1, **cfg), "cpu")
        sizes, bi, ti = coords(mesh)
        nb, nq, nk = b // (sizes["data"] * sizes["fsdp"]), hq // sizes["tensor"], hkv // sizes["tensor"]
        blk = lambda x, n: x[bi * nb:(bi + 1) * nb, :, ti * n:(ti + 1) * n]
        o = flash_attention_sharded(blk(q, nq), blk(k, nk), blk(v, nk), mesh)
        out["flash"][name] = {"batch": bi, "head": ti, "out": o.tolist()}
        if name == "tp4":
            try:
                flash_attention_sharded(blk(q, nq), blk(k, nk), blk(v, nk), mesh,
                                        global_heads=(6, 2))
                out["flash_error"] = None
            except ValueError as e:
                out["flash_error"] = str(e)
            # the same error when the layout meets such a model
            bad = LlamaConfig.tiny(num_layers=1, hidden_size=64, num_heads=6,
                                   num_kv_heads=2, head_dim=16, dtype=torch.float32)
            try:
                create_sharded_state(LlamaForCausalLM(bad, device="cpu"), 1e-3, mesh,
                                     LogicalRules(LogicalRules.FSDP_TP))
                out["layout_error"] = None
            except ValueError as e:
                out["layout_error"] = str(e)

# -- the vocab-parallel CE and embedding at tensor = world -------------------
mesh = build_mesh(MeshConfig(data=1, tensor=world), "cpu")
axis = tp.TensorAxis.of(mesh)
c = spec["ce_shape"]
rng = np.random.RandomState(7)
x = {"hidden": rng.standard_normal((c["b"], c["s"], c["e"])).astype(np.float32),
     "kernel": (rng.standard_normal((c["e"], c["v"])) * 0.3).astype(np.float32),
     "labels": rng.randint(0, c["v"], (c["b"], c["s"])).astype(np.int64),
     "mask": (rng.rand(c["b"], c["s"]) > 0.3).astype(np.int32)}
cols = axis.shard_range(c["v"], "vocab")
out["ce"] = []
for use_mask, z in spec["ce_cases"]:
    res = {}
    for label, sharded in (("tp", True), ("one", False)):
        h = torch.from_numpy(x["hidden"]).requires_grad_()
        w = torch.from_numpy(x["kernel"])
        w = (w[:, cols.start:cols.stop] if sharded else w).clone().requires_grad_()
        loss = fused_lm_head_cross_entropy(
            h, w, torch.from_numpy(x["labels"]),
            mask=torch.from_numpy(x["mask"]) if use_mask else None, z_loss=z,
            target_chunk=16, mesh=mesh if sharded else None)
        loss.backward()
        wg = w.grad if sharded else w.grad[:, cols.start:cols.stop]
        res[label] = {"loss": loss.item(), "hidden_grad": h.grad.tolist(),
                      "kernel_grad": wg.tolist()}
    out["ce"].append(res)
table = torch.from_numpy(rng.standard_normal((c["v"], c["e"])).astype(np.float32))
ids = torch.from_numpy(x["labels"])
g = torch.from_numpy(rng.standard_normal((c["b"], c["s"], c["e"])).astype(np.float32))
local = table[cols.start:cols.stop].clone().requires_grad_()
whole = table.clone().requires_grad_()
e_tp = tp.vocab_parallel_embedding_lookup(local, ids, axis, torch.float32)
e_one = sharded_embedding_lookup(whole, ids, torch.float32)
(e_tp * g).sum().backward()
(e_one * g).sum().backward()
out["embed"] = {"out_equal": torch.equal(e_tp, e_one),
                "grad_equal": torch.equal(local.grad, whole.grad[cols.start:cols.stop])}

# -- the train step ---------------------------------------------------------
CFG = LlamaConfig.tiny(num_layers=spec["layers"], hidden_size=64,
                       intermediate_size=128, num_heads=8, num_kv_heads=4,
                       head_dim=16, vocab_size=256, dtype=torch.float32,
                       remat=True, remat_policy="flash")
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

ref = create_train_state(fresh_model(), LR)
ref_step = make_train_step(loss_fn, health=True)
ref_losses = []
for i, b in enumerate(BATCHES):
    _, m = ref_step(ref, b)
    ref_losses.append(float(m["loss"]))
    if i == 0:
        ref_norm = float(m["grad_norm"])
        ref_one = {n: p.detach().clone() for n, p in ref.model.named_parameters()}
        ref_grads = {n: p.grad.clone() for n, p in ref.model.named_parameters()}

KINDS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")
calls, tensor_group = [], [None]
for kind in KINDS:
    def wrapped(*a, _f=getattr(dist, kind), _k=kind, **kw):
        grp = kw.get("group")
        calls.append((_k, "tensor" if grp is not None and grp is tensor_group[0]
                      else "other"))
        return _f(*a, **kw)
    setattr(dist, kind, wrapped)

def mesh_of(name):
    if name == "fsdp2xtp2":
        return build_mesh(MeshConfig(data=1, fsdp=2, tensor=2), "cpu")
    return llama_train._mesh_for("fsdp_tp", 2 if name == "dp2xtp2" else 1, "cpu")

out["steps"] = {}
for name in spec["steps"]:
    mesh = mesh_of(name)
    tensor_group[0] = mesh["tensor"].get_group()
    state = create_sharded_state(fresh_model(), LR, mesh,
                                 LogicalRules(LogicalRules.FSDP_TP))
    step = make_train_step(loss_fn, health=True)
    shard = make_batch_sharder(mesh)
    losses, counted, model_counts = [], None, None
    for i, b in enumerate(BATCHES):
        calls.clear()
        tp.reset_counts()
        _, metrics = step(state, shard(b))
        losses.append(float(metrics["loss"]))
        if i == 0:
            norm = float(metrics["grad_norm"])
            grads = {n: whole(p.grad) for n, p in state.model.named_parameters()}
            got = {n: whole(p).detach() for n, p in state.model.named_parameters()}
            one_err = {n: float((grads[n] - ref_grads[n]).abs().max()
                                / ref_grads[n].abs().max()) for n in grads}
            one_ok = all(torch.allclose(grads[n], ref_grads[n], rtol=1e-6,
                                        atol=spec["grad_scale_atol"] * float(ref_grads[n].abs().max()))
                         for n in grads)
            param_err = max(float((got[n] - ref_one[n]).abs().max()) for n in got)
            param_ok = param_err <= LR * spec["param_lr_share"]
        if i == 1:
            counted = {}
            for kind, ax in calls:
                counted[f"{kind}:{ax}"] = counted.get(f"{kind}:{ax}", 0) + 1
            model_counts = dict(tp.COLLECTIVES)
    clean = llama_train._unhealthy_state(True, metrics)
    poison = {**shard(BATCHES[0]),
              "chaos_scale": torch.tensor(0.0 if rank == 1 else 1.0)}
    _, bad = step(state, poison)
    tree = state_tree(state)
    out["steps"][name] = {
        "mesh": mesh_shape(mesh), "losses": losses, "ref_losses": ref_losses,
        "one_ok": one_ok, "one_err": one_err, "param_ok": param_ok,
        "param_err": param_err, "grad_norm": norm, "ref_grad_norm": ref_norm,
        "collectives": counted, "model_counts": model_counts,
        "verdict_clean": clean,
        "verdict_poisoned": llama_train._unhealthy_state(True, bad),
        "placements": {k: [repr(p) for p in v.placements] for k, v in tree.items()
                       if k.startswith("params/") and hasattr(v, "placements")}}
# the unfused loss: each rank's logit columns gathered whole
if world == 2:
    mesh = mesh_of("tp2")
    state = create_sharded_state(fresh_model(), LR, mesh,
                                 LogicalRules(LogicalRules.FSDP_TP))
    ids = BATCHES[0]["input_ids"]
    tp.reset_counts()
    loss = llama_train.lm_loss(state.model, ids, fused_ce=False)
    loss.backward()
    ref_model = fresh_model()
    ref_loss = llama_train.lm_loss(ref_model, ids, fused_ce=False)
    ref_loss.backward()
    want = dict(ref_model.named_parameters())
    out["unfused"] = {
        "loss": loss.item(), "ref_loss": ref_loss.item(),
        "logits_gathers": tp.COLLECTIVES.get("logits"),
        "grad_ok": all(torch.allclose(
            whole(p.grad), want[n].grad, rtol=1e-6,
            atol=spec["grad_scale_atol"] * float(want[n].grad.abs().max()))
            for n, p in state.model.named_parameters())}
print(json.dumps({"rank": rank, "out": out}))
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


def _start(world):
    spec = {"flash_shape": FLASH_SHAPE, "flash_meshes": FLASH_MESHES,
            "ce_shape": CE_SHAPE, "ce_cases": CE_CASES,
            "steps": STEP_CASES[world], "layers": LAYERS,
            "grad_scale_atol": GRAD_SCALE_ATOL, "param_lr_share": PARAM_LR_SHARE}
    port = str(_free_port())
    return [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(r), str(world), port, json.dumps(spec)],
        cwd=REPO, env=_child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


@pytest.fixture(scope="module")
def gangs():
    """Every rank's results, from one start each of 2 and 4 processes
    (both started together)."""
    procs = {w: _start(w) for w in (2, 4)}
    res = {}
    try:
        for w, ps in procs.items():
            outs = []
            for p in ps:
                o, err = p.communicate(timeout=300)
                assert p.returncode == 0, err[-4000:]
                outs.append(json.loads(o.strip().splitlines()[-1]))
            res[w] = [o["out"] for o in sorted(outs, key=lambda o: o["rank"])]
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
    return res


# ---------------------------------------------------------------------------
# placements and the mesh (this process)
# ---------------------------------------------------------------------------


def _port_dims(name, ndim):
    """For a JAX kernel, the port dimension each JAX dimension lands in
    (the port flattens ``[E, H, D]`` to ``[E, H*D]`` and ``o_proj``'s
    ``[H, D, E]`` to ``[H*D, E]``)."""
    if name.endswith("o_proj"):
        return (0, 0, 1)
    if name.endswith(("q_proj", "k_proj", "v_proj")):
        return (0, 1, 1)
    return tuple(range(ndim))


@pytest.mark.parametrize("table", ["TP", "FSDP_TP"])
def test_placement_of_every_parameter_matches_the_jax_rules(table):
    """Each port parameter's placement (mesh axes per port dimension)
    equals the JAX rules' ``PartitionSpec`` on the JAX llama's logical
    axes, each JAX dimension's axes carried to the port dimension it
    flattens into."""
    jcfg = JaxConfig.tiny(dtype=jnp.float32, scan_layers=False, num_layers=2)
    abstract = jax.eval_shape(lambda: JaxLlama(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    logical = nn.get_partition_spec(abstract)["params"]
    rules = jsharding.LogicalRules(getattr(jsharding.LogicalRules, table)).to_flax()

    def want_of(name, spec):
        axes = tuple(nn.logical_to_mesh_axes(tuple(spec), rules))
        port = [None] * (2 if len(axes) > 1 else 1)
        for jdim, ax in enumerate(axes):
            if ax is not None:
                pdim = _port_dims(name, len(axes))[jdim]
                assert port[pdim] is None, (name, axes)
                port[pdim] = ax
        return tuple(port)

    want = {"embed_tokens": want_of("embed_tokens", logical["embed_tokens"]["embedding"]),
            "lm_head": want_of("lm_head", logical["lm_head"]["kernel"]),
            "final_norm.weight": want_of("final_norm", logical["final_norm"]["weight"])}
    for i in range(jcfg.num_layers):
        layer = logical[f"layer_{i}"]
        for sub, names in (("attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
                           ("mlp", ("gate_proj", "up_proj", "down_proj"))):
            for n in names:
                want[f"layers.{i}.{sub}.{n}"] = want_of(n, layer[sub][n]["kernel"])
        for n in ("input_norm", "post_attn_norm"):
            want[f"layers.{i}.{n}.weight"] = want_of(n, layer[n]["weight"])
    trules = tsharding.LogicalRules(getattr(tsharding.LogicalRules, table))
    port = LlamaForCausalLM(LlamaConfig.tiny(num_layers=2), device="cpu")
    got = {n: tsharding.param_placement(n, trules) for n, _ in port.named_parameters()}
    assert got == want
    if table == "FSDP_TP":
        assert got["layers.0.attn.o_proj"] == ("tensor", "fsdp")
        assert got["layers.0.mlp.down_proj"] == ("tensor", "fsdp")
        assert got["embed_tokens"] == ("tensor", "fsdp")
        assert got["lm_head"] == ("fsdp", "tensor")
    for name in ("batch", "length"):
        assert trules[name] == jsharding.LogicalRules(
            getattr(jsharding.LogicalRules, table))._rules.get(name)


def test_fsdp_tp_sp_table_is_the_jax_one():
    assert tsharding.LogicalRules.FSDP_TP_SP == jsharding.LogicalRules.FSDP_TP_SP


@pytest.mark.parametrize("n,slices", [(1, 1), (2, 1), (4, 1), (8, 1),
                                      (2, 2), (4, 2), (8, 2)])
def test_fsdp_tp_mesh_matches_the_jax_mesh_for(n, slices, monkeypatch):
    from k8s_tpu.programs import llama_train as jtrain

    monkeypatch.setattr(jtrain, "build_mesh", lambda cfg: jmesh.build_mesh(
        cfg, devices=jax.devices()[:n]))
    want = dict(jtrain._mesh_for("fsdp_tp", n, slices).shape)
    got = llama_train.mesh_config_for("fsdp_tp", n, slices).resolved(n)
    assert dict(zip(jmesh.AXES, got.shape)) == want


# ---------------------------------------------------------------------------
# the gangs
# ---------------------------------------------------------------------------


def _flash_inputs():
    b, s, hq, hkv, d = FLASH_SHAPE
    rng = np.random.RandomState(0)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("name", list(FLASH_MESHES))
def test_head_split_matches_the_jax_sharded_flash(gangs, name):
    """Each rank's block, put back at its batch rows and heads, equals
    the JAX ``flash_attention_sharded`` (Pallas kernel, interpret mode)
    on the same mesh, within 2e-5 absolute (f32)."""
    q, k, v = _flash_inputs()
    cfg = FLASH_MESHES[name]
    shape = (1, cfg.get("fsdp", 1), 1, 1, 1, cfg["tensor"])
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), jmesh.AXES)
    want = np.asarray(jax_flash_sharded(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), mesh, use_pallas=True,
                                        interpret=True))
    got = np.full_like(want, np.nan)
    for rank in gangs[4]:
        blk = np.asarray(rank["flash"][name]["out"], np.float32)
        nb, nh = blk.shape[0], blk.shape[2]
        bi, hi = rank["flash"][name]["batch"], rank["flash"][name]["head"]
        got[bi * nb:(bi + 1) * nb, :, hi * nh:(hi + 1) * nh] = blk
    np.testing.assert_allclose(got, want, rtol=0, atol=FLASH_ATOL)


def test_head_split_raises_the_jax_divisibility_error(gangs):
    q, k, v = (jnp.zeros((2, 32, h, 16)) for h in (6, 2, 2))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 1, 1, 1, 1, 4), jmesh.AXES)
    with pytest.raises(ValueError) as jerr:
        jax_flash_sharded(q, k, v, mesh)
    for rank in gangs[4]:
        assert rank["flash_error"] == str(jerr.value)
        assert rank["layout_error"] == str(jerr.value)


def _ce_inputs():
    c = CE_SHAPE
    rng = np.random.RandomState(7)
    return {"hidden": rng.standard_normal((c["b"], c["s"], c["e"])).astype(np.float32),
            "kernel": (rng.standard_normal((c["e"], c["v"])) * 0.3).astype(np.float32),
            "labels": rng.randint(0, c["v"], (c["b"], c["s"])).astype(np.int64),
            "mask": (rng.rand(c["b"], c["s"]) > 0.3).astype(np.int32)}


@pytest.mark.parametrize("case", range(len(CE_CASES)))
@pytest.mark.parametrize("world", [2, 4])
def test_vocab_parallel_ce_matches_one_process_and_jax(gangs, world, case):
    """The loss on every rank, the ``hidden`` gradient on every rank and
    each rank's ``lm_head`` column gradient equal the one-process port
    and the JAX mesh-free fused CE (f32, rtol 2e-5 / atol 1e-6)."""
    use_mask, z = CE_CASES[case]
    x = _ce_inputs()

    def f(hidden, kernel):
        return jax_fused_ce(hidden, kernel, jnp.asarray(x["labels"], jnp.int32),
                            mask=jnp.asarray(x["mask"]) if use_mask else None,
                            z_loss=z, target_chunk=16, compute_dtype=jnp.float32)

    jval, (jdh, jdw) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(x["hidden"]), jnp.asarray(x["kernel"]))
    per = CE_SHAPE["v"] // world
    for r, rank in enumerate(gangs[world]):
        got, one = rank["ce"][case]["tp"], rank["ce"][case]["one"]
        cols = slice(r * per, (r + 1) * per)
        for want_loss, want_dh, want_dw in (
                (one["loss"], one["hidden_grad"], one["kernel_grad"]),
                (float(jval), np.asarray(jdh), np.asarray(jdw)[:, cols])):
            np.testing.assert_allclose(got["loss"], want_loss, **F32)
            np.testing.assert_allclose(np.asarray(got["hidden_grad"]), want_dh,
                                       err_msg="hidden", **F32)
            np.testing.assert_allclose(np.asarray(got["kernel_grad"]), want_dw,
                                       err_msg="kernel", **F32)


@pytest.mark.parametrize("world", [2, 4])
def test_vocab_parallel_embedding_is_bit_equal(gangs, world):
    for rank in gangs[world]:
        assert rank["embed"] == {"out_equal": True, "grad_equal": True}


STEP_NAMES = [(w, n) for w, names in STEP_CASES.items() for n in names]
MESHES = {"tp2": dict(tensor=2), "tp4": dict(tensor=4),
          "dp2xtp2": dict(data=2, tensor=2), "fsdp2xtp2": dict(fsdp=2, tensor=2)}


@pytest.mark.parametrize("world,name", STEP_NAMES)
def test_one_step_matches_the_one_process_step(gangs, world, name):
    """The gradient of one step, every parameter gathered whole, within
    rtol 1e-6 and an atol of 5e-6 of the leaf's largest entry of the
    one-process gradient, and the parameters after the update within
    lr / 20 (GRAD_SCALE_ATOL, PARAM_LR_SHARE: why not test_torch_zero's)."""
    for rank in gangs[world]:
        res = rank["steps"][name]
        assert rank["backend"] == "gloo"
        want = {a: 1 for a in ("data", "fsdp", "stage", "expert", "seq", "tensor")}
        assert res["mesh"] == {**want, **MESHES[name]}
        assert res["one_ok"], f"{name}: gradient max abs diff {res['one_err']}"
        assert res["param_ok"], f"{name}: parameter max abs diff {res['param_err']}"


@pytest.mark.parametrize("world,name", STEP_NAMES)
def test_five_step_losses_match_and_agree_across_ranks(gangs, world, name):
    ranks = [r["steps"][name] for r in gangs[world]]
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]  # the gang's loss
    np.testing.assert_allclose(ranks[0]["losses"], ranks[0]["ref_losses"],
                               **TRAJECTORY)
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]


@pytest.mark.parametrize("world,name", STEP_NAMES)
def test_grad_norm_and_nan_verdict_agree_with_the_one_process_step(gangs, world,
                                                                   name):
    """Every shard counted once: a norm scale replicated over ``tensor``
    adds its sums once, not t times."""
    norms = {r["steps"][name]["grad_norm"] for r in gangs[world]}
    assert len(norms) == 1
    np.testing.assert_allclose(norms.pop(), gangs[world][0]["steps"][name][
        "ref_grad_norm"], rtol=1e-6)
    for rank in gangs[world]:
        assert rank["steps"][name]["verdict_clean"] is False
        assert rank["steps"][name]["verdict_poisoned"] is True


@pytest.mark.parametrize("world,name", STEP_NAMES)
def test_placements_compose_fsdp_and_tensor(gangs, world, name):
    """FSDP2 over ``fsdp`` (``(data, fsdp)`` under HSDP) composes with
    the tensor split into one ``DTensor`` per leaf."""
    pl = gangs[world][0]["steps"][name]["placements"]
    hsdp = MESHES[name].get("data", 1) > 1
    lead = ["Replicate()"] if hsdp else []
    assert pl["params/layers.0.attn.q_proj"] == lead + ["Shard(dim=0)", "Shard(dim=1)"]
    assert pl["params/layers.0.attn.o_proj"] == lead + ["Shard(dim=1)", "Shard(dim=0)"]
    assert pl["params/embed_tokens"] == lead + ["Shard(dim=1)", "Shard(dim=0)"]
    assert pl["params/lm_head"] == lead + ["Shard(dim=0)", "Shard(dim=1)"]
    assert pl["params/final_norm.weight"] == lead + ["Shard(dim=0)", "Replicate()"]


@pytest.mark.parametrize("world,name", STEP_NAMES)
def test_tensor_collectives_per_step(gangs, world, name):
    """One step's tensor-axis collectives: per block 2 all-reduces of the
    row-parallel outputs forward, 2 of the column-parallel inputs'
    gradients backward, and the attention's forward one again when the
    remat recompute re-runs the block in the backward (it stops at the
    block's last saved tensor, the MLP's down product's input, so the
    MLP's all-reduce is not repeated); for the head 1 all-reduce of the
    embedding, the loss's 1 all-gather forward and 1 all-reduce of its
    hidden gradient. Nothing else runs over ``tensor`` (FSDP2's
    collectives and the step's loss all-reduce run on other groups)."""
    want = ttp.expected_per_step(LAYERS, recompute=True)
    assert want == {"reduce": 3 * LAYERS, "copy": 2 * LAYERS, "embed": 1,
                    "ce_forward": 1, "ce_backward": 1}
    for rank in gangs[world]:
        res = rank["steps"][name]
        assert res["model_counts"] == want
        got = res["collectives"]
        assert got["all_reduce:tensor"] == want["reduce"] + want["copy"] + \
            want["embed"] + want["ce_backward"]
        assert got["all_gather_into_tensor:tensor"] == want["ce_forward"]
        assert not {k for k in got if k.endswith(":tensor")} - {
            "all_reduce:tensor", "all_gather_into_tensor:tensor"}


def test_unfused_loss_gathers_the_vocab_parallel_logits(gangs):
    """``--fused_ce=0`` under ``fsdp_tp``: the head's column blocks
    gathered into the whole f32 logits (one all-gather), the loss and
    every gradient as the one-process model's (tolerances as the
    step's)."""
    for rank in gangs[2]:
        res = rank["unfused"]
        np.testing.assert_allclose(res["loss"], res["ref_loss"], rtol=1e-6)
        assert res["logits_gathers"] == 1
        assert res["grad_ok"]


LAUNCHER_PROGRAM = r'''
import json
from k8s_tpu_torch.programs import llama_train

def main(rdzv):
    out = llama_train.main(rdzv)
    print(json.dumps({"rank_losses": rdzv.process_id,
                      "first": out["first_loss"], "final": out["final_loss"]}),
          flush=True)
'''


def test_launcher_two_processes_train_fsdp_tp(tmp_path):
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
            KTPU_PROGRAM_ARGS="--strategy=fsdp_tp --model=tiny --batch_size=4 "
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
    assert mesh["shape"]["tensor"] == 2 and mesh["shape"]["fsdp"] == 1
    assert mesh["dp"] == 1
    res = [next(e for e in ln if "rank_losses" in e) for ln in lines]
    assert res[0]["first"] == res[1]["first"]
    assert res[0]["final"] == res[1]["final"] < res[0]["first"]
