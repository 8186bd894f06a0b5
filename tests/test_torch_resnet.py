"""The port's ResNet (k8s_tpu_torch/models/resnet.py) and its training
step, held to the flax model of ``k8s_tpu/models/resnet.py`` on the same
numpy inputs and weights (``resnet_params_from_jax``).

The tiny ResNet (stages (1, 1), 8 filters, 10 classes) at batch 4, at
32² and 64² (both stride-2 SAME cases pad (0, 1): 16 -> 8 and 32 -> 16
at the 3x3/s2 convolution and the max pool), in an f32 config (``dtype``
and ``norm_dtype`` f32) and the default bf16 one. The weights are flax's
init plus 0.05 x unit noise on every leaf (so the third BN's zero scale
and the biases are live), the batch stats random (mean 0.1 x noise, var
1 + 0.2 x |noise|), so eval mode differs from train mode. Checked:
training-mode logits and the running stats after that forward,
eval-mode logits, every gradient of one step, and two steps of
``optax.sgd(0.1, momentum=0.9, nesterov=True)`` (parameters, running
stats, the second step's loss) against ``torch.optim.SGD`` through
``make_train_step``.

Tolerances:

- f32: logits 1e-4 (absolute, logits of O(1)); running stats 1e-5;
  gradients rtol 1e-4 with atol 1e-4 of the tensor's largest entry (the
  same f32 sums in another order; the atol covers entries whose sums
  cancel); parameters after two steps 1e-5 (lr 0.1 x the gradient's
  error); losses 1e-5.
- bf16 (convolutions in bf16, BN statistics in f32, BN output bf16):
  logits 3e-2 of the largest logit (at least 1): the activations round
  to bf16 at every layer, and the two backends' bf16 convolutions round
  their f32 sums at other points; running stats 2e-2; losses 1e-2.
  Gradients and the parameters after two steps against flax's bf16
  ones within three times flax's own bf16 error (flax's bf16 result
  against its f32 one on the same inputs: up to 0.3 relative L2 for an
  early BN's bias gradient, whose sum cancels) plus a floor (1e-2
  relative L2; 1e-4): two independent bf16 roundings of one f32 result
  lie up to about twice that error apart (2.2x seen).
  ``chip_smoke.py`` holds the card to the CPU with the same logit and
  running-stat limits.

Also: the space-to-depth stem, its odd-size error and the unknown-stem
error (as tests/test_dataplane.py does for the JAX model), ResNet-50's
parameter count against flax's, XLA's SAME split, the checkpoint tree
(BN buffers and momentum) through the persistent tier, the eval step,
the refusals (ZeRO with SGD; synchronized BN under fsdp), and two gloo ranks with synchronized BN, each
with half the batch, against the flax step on the whole batch (f32
limits; the same running stats on both ranks).
"""

import functools
import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_tpu.models import ResNet as JaxResNet
from k8s_tpu.models import ResNet50 as JaxResNet50
from k8s_tpu.train import cross_entropy_loss as jax_ce
from k8s_tpu_torch.models import ResNet, ResNet50, resnet_params_from_jax
from k8s_tpu_torch.models.resnet import same_pads
from k8s_tpu_torch.train import (
    create_train_state,
    cross_entropy_loss,
    init_optimizer_state,
    load_state_tree,
    make_eval_step,
    make_train_step,
    sgd,
    state_tree,
)

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
B, CLASSES, LR = 4, 10, 0.1
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {
    "f32": dict(logits=1e-4, stats=1e-5, grad_rtol=1e-4, grad_atol=1e-4,
                params=1e-5, loss=1e-5),
    "bf16": dict(logits=3e-2, stats=2e-2, noise_factor=3.0, grad_floor=1e-2,
                 params_floor=1e-4, loss=1e-2),
}
CASES = [("f32", 32), ("f32", 64), ("bf16", 32), ("bf16", 64)]


def _perturbed(tree, rng, fn):
    return {k: _perturbed(v, rng, fn) if isinstance(v, dict) else fn(np.asarray(v), rng)
            for k, v in tree.items()}


def _setup(size, dt, stem="conv7", seed=0):
    """The flax model, its perturbed params and batch stats, a batch."""
    jdt = DTYPES[dt][0]
    jm = JaxResNet(stage_sizes=(1, 1), num_classes=CLASSES, num_filters=8,
                   dtype=jdt, norm_dtype=jdt, stem=stem)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, size, size, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, (B,)).astype(np.int32)
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False)
    params = _perturbed(v["params"], rng, lambda a, r: (
        a + 0.05 * r.standard_normal(a.shape)).astype(np.float32))
    stats = _perturbed(v["batch_stats"], rng, lambda a, r: (
        0.1 * r.standard_normal(a.shape) if a.min() == 0 and a.max() == 0
        else 1.0 + 0.2 * np.abs(r.standard_normal(a.shape))).astype(np.float32))
    return jm, params, stats, x, y


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _port_model(params, stats, dt, stem="conv7"):
    tdt = DTYPES[dt][1]
    m = ResNet(stage_sizes=(1, 1), num_classes=CLASSES, num_filters=8,
               dtype=tdt, norm_dtype=tdt, stem=stem, device="cpu")
    m.load_state_dict(resnet_params_from_jax(params, stats))
    return m


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _loss_fn(state, b):
    return cross_entropy_loss(state.model(b["images"]), b["labels"]), {}


@functools.lru_cache(maxsize=None)
def _run(dt, size, stem="conv7"):
    """Both sides' forwards and two SGD-Nesterov steps, once per config."""
    jm, params, stats, x, y = _setup(size, dt, stem)

    def loss(p, s):
        logits, mut = jm.apply({"params": p, "batch_stats": s}, jnp.asarray(x),
                               train=True, mutable=["batch_stats"])
        return jax_ce(logits, jnp.asarray(y)), (logits, mut["batch_stats"])

    grad_fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
    opt = optax.sgd(LR, momentum=0.9, nesterov=True)
    jp, js, jopt = params, stats, opt.init(params)
    jax_steps = []
    for _ in range(2):
        (l, (logits, new_s)), g = grad_fn(jp, js)
        upd, jopt = opt.update(g, jopt, jp)
        jax_steps.append({"loss": float(l), "logits": np.asarray(logits, np.float32),
                          "stats": _np_tree(new_s), "grads": _np_tree(g)})
        jp, js = optax.apply_updates(jp, upd), new_s
    jax_eval = np.asarray(jm.apply({"params": params, "batch_stats": stats},
                                   jnp.asarray(x), train=False), np.float32)

    model = _port_model(params, stats, dt, stem)
    with torch.no_grad():
        model.eval()
        port_eval = model(_nchw(x)).numpy()
        model.train()
    state = create_train_state(model, functools.partial(sgd, lr=LR))
    step = make_train_step(_loss_fn)
    batch = {"images": _nchw(x), "labels": torch.from_numpy(y)}
    port_steps = []
    for i in range(2):
        if i == 0:
            with torch.no_grad():
                logits = model(_nchw(x)).numpy()
            # that forward moved the running stats: put them back
            model.load_state_dict(resnet_params_from_jax(params, stats))
        _, metrics = step(state, batch)
        port_steps.append({
            "loss": float(metrics["loss"]),
            "stats": {k: v.clone() for k, v in model.state_dict().items()
                      if k.endswith((".mean", ".var"))},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()}})
        if i == 0:
            port_steps[0]["logits"] = logits
    return {"jax": jax_steps, "jax_params": _np_tree(jp), "jax_stats": _np_tree(js),
            "jax_eval": jax_eval, "port": port_steps, "port_eval": port_eval,
            "model": model, "stats0": stats}


def _max_err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("dt,size", CASES)
def test_train_logits_and_running_stats_match_flax(dt, size):
    r, tol = _run(dt, size), TOL[dt]
    ref = r["jax"][0]["logits"]
    scale = 1.0 if dt == "f32" else max(1.0, float(np.abs(ref).max()))
    assert _max_err(r["port"][0]["logits"], ref) <= tol["logits"] * scale
    want = {k: v for k, v in resnet_params_from_jax(
        _zero_params(r["jax_params"]), r["jax"][0]["stats"]).items()
        if k.endswith((".mean", ".var"))}
    got = r["port"][0]["stats"]
    assert set(got) == set(want)
    for k in want:
        assert _max_err(got[k], want[k]) <= tol["stats"], k


def _zero_params(params):
    return jax.tree_util.tree_map(np.zeros_like, params)


@pytest.mark.parametrize("dt,size", CASES)
def test_eval_logits_use_the_running_averages(dt, size):
    r, tol = _run(dt, size), TOL[dt]
    ref = r["jax_eval"]
    scale = 1.0 if dt == "f32" else max(1.0, float(np.abs(ref).max()))
    assert _max_err(r["port_eval"], ref) <= tol["logits"] * scale
    # eval mode is not train mode: the perturbed running stats matter
    assert _max_err(ref, r["jax"][0]["logits"]) > 10 * tol["logits"] * scale


@pytest.mark.parametrize("dt,size", CASES)
def test_gradients_match_flax(dt, size):
    r, tol = _run(dt, size), TOL[dt]
    zero = _zero_params_stats(r["stats0"])
    want = resnet_params_from_jax(r["jax"][0]["grads"], zero)
    f32 = resnet_params_from_jax(_run("f32", size)["jax"][0]["grads"], zero)
    got = r["port"][0]["grads"]
    # conv_init, bn_init, 2 blocks of 4 convolutions and 4 BNs, the head
    assert set(got) <= set(want) and len(got) == 1 + 2 + 2 * (4 + 4 * 2) + 2
    for n, g in got.items():
        w = want[n].float()
        if dt == "f32":
            atol = tol["grad_atol"] * float(w.abs().max()) + 1e-12
            assert torch.allclose(g, w, rtol=tol["grad_rtol"], atol=atol), n
        else:
            rel = float((g.float() - w).norm() / w.norm().clamp_min(1e-30))
            noise = float((w - f32[n]).norm() / f32[n].norm().clamp_min(1e-30))
            assert rel <= tol["noise_factor"] * noise + tol["grad_floor"], (n, rel, noise)


def _zero_params_stats(stats):
    return jax.tree_util.tree_map(np.zeros_like, stats)


@pytest.mark.parametrize("dt,size", CASES)
def test_two_sgd_nesterov_steps_match_optax(dt, size):
    r, tol = _run(dt, size), TOL[dt]
    assert abs(r["port"][1]["loss"] - r["jax"][1]["loss"]) <= tol["loss"] * max(
        1.0, abs(r["jax"][1]["loss"]))
    want = resnet_params_from_jax(r["jax_params"], r["jax_stats"])
    if dt == "bf16":
        rf = _run("f32", size)
        f32 = resnet_params_from_jax(rf["jax_params"], rf["jax_stats"])
    got = r["model"].state_dict()
    for k, w in want.items():
        if k.endswith((".mean", ".var")):
            lim = tol["stats"]
        elif dt == "f32":
            lim = tol["params"]
        else:
            lim = tol["noise_factor"] * _max_err(w, f32[k]) + tol["params_floor"]
        assert _max_err(got[k], w) <= lim, k


def test_space_to_depth_stem_matches_flax():
    r, tol = _run("f32", 32, "space_to_depth"), TOL["f32"]
    assert tuple(r["model"].conv_init.weight.shape) == (8, 12, 4, 4)
    assert _max_err(r["port"][0]["logits"], r["jax"][0]["logits"]) <= tol["logits"]
    assert _max_err(r["port_eval"], r["jax_eval"]) <= tol["logits"]
    want = resnet_params_from_jax(r["jax"][0]["grads"], _zero_params_stats(r["stats0"]))
    for n, g in r["port"][0]["grads"].items():
        w = want[n].float()
        assert torch.allclose(g, w, rtol=tol["grad_rtol"],
                              atol=tol["grad_atol"] * float(w.abs().max()) + 1e-12), n


def test_space_to_depth_rejects_odd_size():
    m = ResNet(stage_sizes=(1, 1), num_classes=10, num_filters=8,
               stem="space_to_depth", device="cpu")
    with pytest.raises(ValueError, match="even H and W"):
        m(torch.zeros(2, 3, 33, 33))


def test_unknown_stem_rejected():
    with pytest.raises(ValueError, match="unknown stem"):
        ResNet(stage_sizes=(1, 1), num_classes=10, num_filters=8, stem="s2d",
               device="cpu")


def test_resnet50_has_flax_parameter_shapes():
    x = jnp.zeros((1, 64, 64, 3))
    v = jax.eval_shape(lambda: JaxResNet50(num_classes=1000).init(
        jax.random.PRNGKey(0), x, train=False))
    shapes = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), v)
    want = resnet_params_from_jax(shapes["params"], shapes["batch_stats"])
    m = ResNet50(num_classes=1000, device="cpu")
    got = m.state_dict()
    assert set(got) == set(want)
    assert all(tuple(got[k].shape) == tuple(want[k].shape) for k in want)
    assert sum(p.numel() for p in m.parameters()) == 25_557_032


@pytest.mark.parametrize("size,k,s,want", [
    (32, 3, 2, (0, 1)), (33, 3, 2, (1, 1)), (16, 1, 2, (0, 0)),
    (64, 3, 1, (1, 1)), (8, 3, 2, (0, 1)), (7, 7, 2, (3, 3)), (224, 7, 2, (2, 3))])
def test_same_pads_match_xla(size, k, s, want):
    assert same_pads(size, k, s) == want
    lo, hi = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
    assert (lo, hi) == want


def test_checkpoint_carries_batch_stats_and_momentum(tmp_path):
    from k8s_tpu_torch.train.checkpoint import CheckpointManager

    _, params, stats, x, y = _setup(32, "f32")
    batch = {"images": _nchw(x), "labels": torch.from_numpy(y)}

    def fresh():
        st = create_train_state(_port_model(params, stats, "f32"),
                                functools.partial(sgd, lr=LR))
        init_optimizer_state(st)
        return st

    state, step = fresh(), make_train_step(_loss_fn)
    step(state, batch)
    tree = state_tree(state)
    bufs = {k for k in tree if k.startswith("batch_stats/")}
    moms = {k for k in tree if k.endswith("/momentum_buffer")}
    assert bufs == {f"batch_stats/{n}" for n, _ in state.model.named_buffers()}
    # mean and var of bn_init and of 2 blocks x 4 BNs
    assert len(bufs) == 2 * 9 and len(moms) == len(state.params())
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(1, tree)
    other = fresh()
    load_state_tree(other, mgr.restore(state_tree(other)))
    assert other.step == 1
    for k, v in state_tree(other).items():
        assert torch.equal(v, tree[k]), k
    # the restored state steps on bit-equal to the unbroken one
    _, m1 = step(state, batch)
    _, m2 = step(other, batch)
    assert float(m1["loss"]) == float(m2["loss"])


def test_eval_step_keeps_the_running_stats():
    _, params, stats, x, y = _setup(32, "f32")
    state = create_train_state(_port_model(params, stats, "f32"),
                               functools.partial(sgd, lr=LR))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}

    def eval_fn(state, b):
        logits = state.model(b["images"])
        top1 = (logits.argmax(-1) == b["labels"].long()).float().mean()
        return cross_entropy_loss(logits, b["labels"]), {"top1": top1,
                                                         "batch_stats": 0}

    m = make_eval_step(eval_fn)(state, {"images": _nchw(x),
                                        "labels": torch.from_numpy(y)})
    assert set(m) == {"loss", "top1"} and state.model.training
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert abs(float(m["loss"]) - float(cross_entropy_loss(
        torch.tensor(_run("f32", 32)["jax_eval"]), torch.from_numpy(y)))) < 1e-5


def test_sharded_state_refuses_zero_with_sgd_and_bn_under_fsdp():
    from k8s_tpu_torch.parallel import LogicalRules
    from k8s_tpu_torch.train import create_sharded_state

    model = ResNet(stage_sizes=(1, 1), num_classes=10, num_filters=8, device="cpu")
    with pytest.raises(ValueError, match="AdamW"):
        create_sharded_state(model, functools.partial(sgd, lr=LR), mesh=None,
                             rules=LogicalRules(LogicalRules.DP), zero_stage=1)
    from k8s_tpu_torch.parallel import MeshConfig, build_mesh

    mesh = build_mesh(MeshConfig(data=1), "cpu")
    with pytest.raises(NotImplementedError, match="under dp only"):
        create_sharded_state(model, functools.partial(sgd, lr=LR), mesh,
                             LogicalRules(LogicalRules.FSDP))


# ---------------------------------------------------------------------------
# two gloo ranks with synchronized BN
# ---------------------------------------------------------------------------

CHILD = r"""
import functools, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, port, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
from k8s_tpu_torch.models import ResNet
from k8s_tpu_torch.parallel import LogicalRules, MeshConfig, build_mesh
from k8s_tpu_torch.train import (create_sharded_state, cross_entropy_loss,
    make_batch_sharder, make_train_step, sgd)

model = ResNet(stage_sizes=(1, 1), num_classes=10, num_filters=8,
               dtype=torch.float32, norm_dtype=torch.float32, device="cpu")
model.load_state_dict(torch.load(f"{tmp}/weights.pt"))
mesh = build_mesh(MeshConfig(data=2), "cpu")
state = create_sharded_state(model, functools.partial(sgd, lr=0.1), mesh,
                             LogicalRules(LogicalRules.DP))
data = np.load(f"{tmp}/batch.npz")
batch = make_batch_sharder(mesh)({"images": data["x"], "labels": data["y"]})
batch = {"images": torch.from_numpy(batch["images"]).permute(0, 3, 1, 2),
         "labels": torch.from_numpy(batch["labels"])}
def loss_fn(state, b):
    return cross_entropy_loss(state.model(b["images"]), b["labels"]), {}
_, metrics = make_train_step(loss_fn)(state, batch)
torch.save({"loss": float(metrics["loss"]),
            "grads": {n: p.grad for n, p in model.named_parameters()},
            "state": model.state_dict()}, f"{tmp}/rank{rank}.pt")
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def test_two_gloo_ranks_with_sync_bn_equal_the_flax_step_on_the_whole_batch(tmp_path):
    jm, params, stats, x, y = _setup(32, "f32", seed=4)
    torch.save(resnet_params_from_jax(params, stats), tmp_path / "weights.pt")
    np.savez(tmp_path / "batch.npz", x=x, y=y)
    env = {k: v for k, v in os.environ.items() if not k.startswith("KTPU_")}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), port, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]

    def loss(p, s):
        logits, mut = jm.apply({"params": p, "batch_stats": s}, jnp.asarray(x),
                               train=True, mutable=["batch_stats"])
        return jax_ce(logits, jnp.asarray(y)), mut["batch_stats"]

    # the flax step while the ranks run
    (l, new_s), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params, stats)
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-3000:]
    upd, _ = optax.sgd(LR, momentum=0.9, nesterov=True).update(
        g, optax.sgd(LR, momentum=0.9, nesterov=True).init(params), params)
    want = resnet_params_from_jax(_np_tree(optax.apply_updates(params, upd)),
                                  _np_tree(new_s))
    want_g = resnet_params_from_jax(_np_tree(g), _zero_params_stats(stats))
    tol = TOL["f32"]
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for r in ranks:
        assert abs(r["loss"] - float(l)) <= tol["loss"]
        for n, gr in r["grads"].items():
            w = want_g[n].float()
            assert torch.allclose(gr, w, rtol=tol["grad_rtol"],
                                  atol=tol["grad_atol"] * float(w.abs().max()) + 1e-12), n
        for k, w in want.items():
            lim = tol["stats"] if k.endswith((".mean", ".var")) else tol["params"]
            assert _max_err(r["state"][k], w) <= lim, k
    for k, v in ranks[0]["state"].items():
        if k.endswith((".mean", ".var")):
            assert torch.equal(v, ranks[1]["state"][k]), k
