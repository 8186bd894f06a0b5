"""The port's MNIST CNN (k8s_tpu_torch/models/mnist.py) and
``programs.mnist_train`` held to the JAX package on the CPU.

- The forward against flax's ``MnistCNN`` on the same numpy batch and
  weights (``mnist_params_from_jax``): in bf16 (the default) within 2e-2
  of the largest logit, at least 1 (the activations round to bf16 at
  every layer; both sides round their f32 sums at other points); in f32
  within 1e-5.
- One step through ``make_train_step`` on the f32 model against
  ``jax.value_and_grad``: the loss and the accuracy within 1e-6, every
  gradient within rtol 1e-4 and atol 1e-4 of the tensor's largest entry
  (the same f32 sums in another order). Then the program's optimizer
  (AdamW 1e-3, weight decay 1e-4) on flax's gradient against
  ``optax.adamw(1e-3)``: rtol 1e-5, atol 1e-7 (the same update; sqrt
  and division round differently; fed the same gradient, because Adam
  maps a gradient entry near its eps to about lr times its sign, so a
  last-bit difference there moves the parameter by up to lr / 2), and
  far from ``optax.adamw(1e-3, weight_decay=0.1)``'s (the port's Llama
  default).
- ``mnist_train`` in process: its optimizer and the metrics it logs.
- A TpuJob of two CPU WORKER pods running ``mnist_train`` through
  ``kubectl_local create`` to ``Succeeded``; the lead's log holds the
  gang's loss and accuracy.
"""

import contextlib
import functools
import io
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from k8s_tpu.models import MnistCNN as JaxMnist
from k8s_tpu.train import cross_entropy_loss as jax_ce
from k8s_tpu_torch.models import MnistCNN, mnist_params_from_jax
from k8s_tpu_torch.train import (
    adamw,
    create_train_state,
    cross_entropy_loss,
    make_train_step,
)

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
LR = 1e-3


def _setup(dtype, seed=0, batch=8):
    jm = JaxMnist(dtype=dtype)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, (batch,)).astype(np.int32)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    return jm, params, x, y


def _port(params, dtype):
    m = MnistCNN(dtype=dtype, device="cpu")
    m.load_state_dict(mnist_params_from_jax(params))
    return m


@pytest.mark.parametrize("jdt,tdt,tol", [
    (jnp.bfloat16, torch.bfloat16, 2e-2), (jnp.float32, torch.float32, 1e-5)])
def test_forward_matches_flax(jdt, tdt, tol):
    jm, params, x, y = _setup(jdt)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    out = _port(params, tdt)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert out.dtype == torch.float32 and tuple(out.shape) == (8, 10)
    scale = max(1.0, float(np.abs(ref).max())) if tdt == torch.bfloat16 else 1.0
    assert float(np.abs(out.detach().numpy() - ref).max()) <= tol * scale


def _loss_fn(state, b):
    logits = state.model(b["images"].permute(0, 3, 1, 2))
    acc = (logits.argmax(-1) == b["labels"].long()).float().mean()
    return cross_entropy_loss(logits, b["labels"]), {"accuracy": acc}


def test_one_adamw_step_matches_optax_adamw_defaults():
    jm, params, x, y = _setup(jnp.float32, seed=3)

    def loss(p):
        logits = jm.apply({"params": p}, jnp.asarray(x))
        acc = jnp.mean((jnp.argmax(logits, -1) == jnp.asarray(y)).astype(jnp.float32))
        return jax_ce(logits, jnp.asarray(y)), acc

    (l, acc), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)

    def stepped(opt):
        @jax.jit
        def step(p, g):
            upd, _ = opt.update(g, opt.init(p), p)
            return optax.apply_updates(p, upd)

        return mnist_params_from_jax(jax.tree_util.tree_map(np.asarray, step(params, g)))

    want, decay_01 = stepped(optax.adamw(LR)), stepped(optax.adamw(LR, weight_decay=0.1))
    opt = functools.partial(adamw, lr=LR, weight_decay=1e-4)
    model = _port(params, torch.float32)
    _, metrics = make_train_step(_loss_fn)(
        create_train_state(model, opt),
        {"images": torch.from_numpy(x), "labels": torch.from_numpy(y)})
    assert abs(float(metrics["loss"]) - float(l)) <= 1e-6
    assert abs(float(metrics["accuracy"]) - float(acc)) <= 1e-6
    grads = mnist_params_from_jax(jax.tree_util.tree_map(np.asarray, g))
    for n, p in model.named_parameters():
        w = grads[n]
        assert torch.allclose(p.grad, w, rtol=1e-4,
                              atol=1e-4 * float(w.abs().max()) + 1e-12), n
    # the optimizer alone, fed flax's gradient
    model = _port(params, torch.float32)
    state = create_train_state(model, opt)
    for n, p in model.named_parameters():
        p.grad = grads[n].clone()
    state.optimizer.step()
    got = model.state_dict()
    for k, w in want.items():
        assert torch.allclose(got[k], w, rtol=1e-5, atol=1e-7), k
    # the decay is optax's default 1e-4, not the Llama trainer's 0.1
    assert not all(torch.allclose(got[k], decay_01[k], rtol=1e-5, atol=1e-7)
                   for k in want)


def test_mnist_train_program_uses_adamw_1e3_with_decay_1e4():
    from k8s_tpu_torch.programs import mnist_train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = mnist_train.main(types.SimpleNamespace(
            process_id=0, num_processes=1,
            program_args="--device=cpu --steps=4 --batch_size=8 --log_every=2"))
    group = summary["state"].optimizer.param_groups[0]
    assert isinstance(summary["state"].optimizer, torch.optim.AdamW)
    assert (group["lr"], group["weight_decay"], group["eps"]) == (1e-3, 1e-4, 1e-8)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    assert [(e["run"], e["step"]) for e in lines] == [("mnist", 2), ("mnist", 4)]
    assert all(np.isfinite(e["loss"]) and 0 <= e["accuracy"] <= 1 for e in lines)
    assert [s for s, _ in summary["logged"]] == [2, 4]


def test_mnist_job_through_kubectl_local_succeeds(tmp_path, capsys):
    """The port's manifest with its gpu block taken out and the CPU asked
    for: two WORKER pods, data parallel over gloo."""
    from k8s_tpu_torch.tools import kubectl_local

    doc = yaml.safe_load((REPO / "k8s_tpu_torch" / "examples" / "gpu_job_mnist.yaml")
                         .read_text())
    del doc["spec"]["gpu"], doc["spec"]["tensorboard"]
    doc["metadata"]["name"] = "mnist-cpu"
    rs = doc["spec"]["replicaSpecs"][0]
    rs["replicas"] = 2
    c = rs["template"]["spec"]["containers"][0]
    c["env"] += [{"name": k, "value": v} for k, v in (
        ("KTPU_FORCE_PLATFORM", "cpu"), ("KTPU_NUM_CPU_DEVICES", "1"),
        ("OMP_NUM_THREADS", "1"),
        ("KTPU_PROGRAM_ARGS", "--steps=3 --batch_size=8 --log_every=1"))]
    path = tmp_path / "mnist.json"
    path.write_text(json.dumps(doc))
    state = str(tmp_path / "state")
    assert kubectl_local.main(["--state-dir", state, "create", "-f", str(path),
                               "--timeout", "240"]) == 0
    assert "state=Succeeded" in capsys.readouterr().out
    assert kubectl_local.main(["--state-dir", state, "logs", "mnist-cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"run": "mnist"')]
    assert [e["step"] for e in lines] == [1, 2, 3], lines
    assert all(np.isfinite(e["loss"]) and 0 <= e["accuracy"] <= 1 for e in lines)
