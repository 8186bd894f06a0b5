"""Sequence parallelism in training (``llama_train --strategy=fsdp_tp_sp``:
the ``FSDP_TP_SP`` rules, ``create_sharded_state`` with a ``seq`` axis,
the model's chunk at its global positions, ring and Ulysses attention
over ``seq``, the global-mean loss) held on the CPU against the
one-process port step and the JAX program's mesh.

In this process: ``mesh_config_for("fsdp_tp_sp", n, 1)`` against the JAX
program's ``_mesh_for`` on the conftest's forced CPU devices.

Two groups of gloo processes, 2 ranks and 4, are started once each for
the module (together) and run every case in turn: a tiny Llama (2
layers, width 64, 8 q / 4 kv heads of 16, MLP 128, vocab 256, f32,
``flash`` remat) trained 5 steps on the same global batches (B 8, S 64)
as the one-process port step —

- ``seq2``: ``create_sharded_state`` at ``MeshConfig(seq=2)`` (2 ranks),
  ring attention;
- ``sp4``: ``llama_train``'s ``fsdp_tp_sp`` mesh at 4 ranks (tensor 2 x
  seq 2), ring attention, the program's ``lm_loss``;
- ``sp4_packed``: the same with two packed documents per row, the
  boundary at 33 of 64 (inside the first chunk's neighbour, not on a
  chunk edge; tests/test_dataplane.py's packed-docs ring test), the
  loss masking each cross-document prediction;
- ``sp4_ulysses``: the same mesh with ``attention="ulysses"``;
- ``fsdp2_sp4``: ``MeshConfig(fsdp=2, seq=2)`` (4 ranks), ring attention:
  FSDP2's mean over ``fsdp`` and then the sum over ``seq`` of each
  rank's FSDP2 shard, which holds only if ``seq`` peers hold the same
  shard (the fsdp x seq part of the program's 8-rank fsdp 2 x tensor 2
  x seq 2 mesh).

Each holds one step's gradients (every parameter gathered whole) within
test_torch_tp.py's tolerances (rtol 1e-6 and 5e-6 of the leaf's largest
entry: the chunks' sums run in another order than one process's) and
the parameters after it within lr / 20, the 5-step losses at
test_torch_zero's rtol 5e-4 / atol 5e-5, the losses equal on every rank,
and one step's gradient all-reduces over ``seq`` counted.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from k8s_tpu.parallel import mesh as jmesh
from k8s_tpu_torch.programs import llama_train

REPO = pathlib.Path(__file__).resolve().parent.parent
TRAJECTORY = dict(rtol=5e-4, atol=5e-5)
GRAD_SCALE_ATOL = 5e-6  # tests/test_torch_tp.py's
PARAM_LR_SHARE = 1 / 20
CASES = {2: ["seq2"], 4: ["sp4", "sp4_packed", "sp4_ulysses", "fsdp2_sp4"]}
PACKED_BOUNDARY = 33

CHILD = r"""
import json, sys
import torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
spec = json.loads(sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
import dataclasses
from k8s_tpu_torch.data import learnable_token_batches
from k8s_tpu_torch.models import LlamaConfig, LlamaForCausalLM, init_params
from k8s_tpu_torch.parallel import LogicalRules, MeshConfig, build_mesh
from k8s_tpu_torch.parallel import tensor_parallel as tp
from k8s_tpu_torch.parallel.mesh import mesh_shape
from k8s_tpu_torch.parallel.sharding import sequence_chunk
from k8s_tpu_torch.programs import llama_train
from k8s_tpu_torch.train import (create_sharded_state, create_train_state,
    cross_entropy_loss, make_batch_sharder, make_train_step, sequence_mean)

CFG = LlamaConfig.tiny(num_layers=2, hidden_size=64, intermediate_size=128,
                       num_heads=8, num_kv_heads=4, head_dim=16, vocab_size=256,
                       dtype=torch.float32, remat=True, remat_policy="flash")
B, S, STEPS, LR = 8, 64, 5, 1e-3
stream = learnable_token_batches(B, S, CFG.vocab_size, seed=5)
BATCHES = [{k: torch.from_numpy(v) for k, v in next(stream).items()}
           for _ in range(STEPS)]
SEG = torch.where(torch.arange(S) < spec["boundary"], 1, 2)[None].repeat(B, 1)

def lm_loss_fn(state, b):
    return llama_train.lm_loss(state.model, b["input_ids"]), {}

def packed_loss_fn(state, b):
    # the next-token loss of packed documents: each cross-document
    # prediction dropped (the JAX packed-docs ring test's loss)
    model, ids, seg = state.model, b["input_ids"], b["segment_ids"]
    seq = model.seq
    n, r = (seq.size, seq.rank) if seq is not None else (1, 0)
    chunk, seg_c = sequence_chunk(ids, n, r), sequence_chunk(seg, n, r)
    labels = sequence_chunk(ids, n, r, shift=1)
    seg_next = sequence_chunk(seg, n, r, shift=1)
    logits = model(chunk, segment_ids=seg_c)[:, :labels.shape[1]]
    mask = seg_c[:, :labels.shape[1]] == seg_next
    mean = cross_entropy_loss(logits, labels, mask=mask)
    return (mean if seq is None else sequence_mean(mean, mask.sum(), seq)), {}

def fresh_model(attention="flash"):
    m = LlamaForCausalLM(dataclasses.replace(CFG, attention=attention), device="cpu")
    m.load_params(init_params(CFG, 0, "cpu", dtype=torch.float32))
    return m

def whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t

def reference(loss_fn, packed):
    state = create_train_state(fresh_model(), LR)
    step = make_train_step(loss_fn)
    losses = []
    for i, b in enumerate(BATCHES):
        if packed:
            b = dict(b, segment_ids=SEG)
        _, m = step(state, b)
        losses.append(float(m["loss"]))
        if i == 0:
            params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
            grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    return losses, params, grads

REFS = {}
out = {"backend": dist.get_backend(), "cases": {}}
for name in spec["cases"]:
    packed = name.endswith("packed")
    loss_fn = packed_loss_fn if packed else lm_loss_fn
    if packed not in REFS:
        REFS[packed] = reference(loss_fn, packed)
    ref_losses, ref_params, ref_grads = REFS[packed]
    if name == "seq2":
        mesh = build_mesh(MeshConfig(data=1, seq=2), "cpu")
    elif name == "fsdp2_sp4":
        mesh = build_mesh(MeshConfig(data=1, fsdp=2, seq=2), "cpu")
    else:
        mesh = llama_train._mesh_for("fsdp_tp_sp", 1, "cpu")
    attention = "ulysses" if name.endswith("ulysses") else "ring"
    state = create_sharded_state(fresh_model(attention), LR, mesh,
                                 LogicalRules(LogicalRules.FSDP_TP_SP))
    step = make_train_step(loss_fn)
    shard = make_batch_sharder(mesh)
    losses = []
    for i, b in enumerate(BATCHES):
        if packed:
            b = dict(b, segment_ids=SEG)
        tp.reset_counts()
        _, metrics = step(state, shard(b))
        losses.append(float(metrics["loss"]))
        if i == 0:
            counts = dict(tp.COLLECTIVES)
            grads = {n: whole(p.grad) for n, p in state.model.named_parameters()}
            got = {n: whole(p).detach() for n, p in state.model.named_parameters()}
            grad_err = {n: float((grads[n] - ref_grads[n]).abs().max()
                                 / ref_grads[n].abs().max()) for n in grads}
            grad_ok = all(torch.allclose(
                grads[n], ref_grads[n], rtol=1e-6,
                atol=spec["grad_scale_atol"] * float(ref_grads[n].abs().max()))
                for n in grads)
            param_err = max(float((got[n] - ref_params[n]).abs().max()) for n in got)
    out["cases"][name] = {
        "mesh": mesh_shape(mesh), "losses": losses, "ref_losses": ref_losses,
        "grad_ok": grad_ok, "grad_err": grad_err,
        "param_ok": param_err <= LR * spec["param_lr_share"], "param_err": param_err,
        "seq": [state.model.seq.size, state.model.seq.rank],
        "attention": state.model.config.attention,
        "seq_all_reduce": counts.get("seq_all_reduce", 0)}
print(json.dumps({"rank": rank, "out": out}))
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(world):
    spec = {"cases": CASES[world], "boundary": PACKED_BOUNDARY,
            "grad_scale_atol": GRAD_SCALE_ATOL, "param_lr_share": PARAM_LR_SHARE}
    # the repo conftest's KTPU_* keys (8 CPU devices) are not the
    # children's contract
    env = {k: v for k, v in os.environ.items() if not k.startswith("KTPU_")}
    env["PYTHONPATH"] = str(REPO)
    port = str(_free_port())
    return [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(r), str(world), port, json.dumps(spec)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]


@pytest.fixture(scope="module")
def gangs():
    """Every rank's results, from one start each of 2 and 4 processes
    (both started together)."""
    procs = {w: _start(w) for w in CASES}
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


@pytest.mark.parametrize("n", [2, 4, 8])
def test_fsdp_tp_sp_mesh_matches_the_jax_mesh_for(n, monkeypatch):
    from k8s_tpu.programs import llama_train as jtrain

    monkeypatch.setattr(jtrain, "build_mesh", lambda cfg: jmesh.build_mesh(
        cfg, devices=jax.devices()[:n]))
    want = dict(jtrain._mesh_for("fsdp_tp_sp", n, 1).shape)
    got = llama_train.mesh_config_for("fsdp_tp_sp", n, 1).resolved(n)
    assert dict(zip(jmesh.AXES, got.shape)) == want
    assert want["seq"] == (2 if n % 4 == 0 else 1)


CASE_NAMES = [(w, n) for w, names in CASES.items() for n in names]
MESHES = {"seq2": dict(seq=2), "sp4": dict(seq=2, tensor=2),
          "sp4_packed": dict(seq=2, tensor=2), "sp4_ulysses": dict(seq=2, tensor=2),
          "fsdp2_sp4": dict(fsdp=2, seq=2)}


@pytest.mark.parametrize("world,name", CASE_NAMES)
def test_one_step_matches_the_one_process_step(gangs, world, name):
    """One step's gradients, every parameter gathered whole, and the
    parameters after the update against the one-process port step on the
    whole sequences; each rank its chunk at its global positions, the
    ring (or Ulysses) attention's the chunks' keys."""
    for r, rank in enumerate(gangs[world]):
        res = rank["cases"][name]
        assert rank["backend"] == "gloo"
        want = {a: 1 for a in ("data", "fsdp", "stage", "expert", "seq", "tensor")}
        assert res["mesh"] == {**want, **MESHES[name]}
        assert res["attention"] == ("ulysses" if name.endswith("ulysses") else "ring")
        assert res["seq"][0] == 2
        assert res["grad_ok"], f"{name}: gradient max rel diff {res['grad_err']}"
        assert res["param_ok"], f"{name}: parameter max abs diff {res['param_err']}"
        # the chunks' gradients summed over seq: one bucket (< 256 MB)
        assert res["seq_all_reduce"] == 1


@pytest.mark.parametrize("world,name", CASE_NAMES)
def test_five_step_losses_match_and_agree_across_ranks(gangs, world, name):
    """The loss is the global mean of the per-token losses (the chunks
    count differently: the last one has no label for its final position,
    and a packed boundary drops one more) on every rank."""
    ranks = [r["cases"][name] for r in gangs[world]]
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], ranks[0]["ref_losses"],
                               **TRAJECTORY)
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]
    # each seq pair holds the chunks of one sequence: ranks 0 and 1 of it
    assert sorted(r["seq"][1] for r in ranks) == sorted(list(range(2)) * (world // 2))
