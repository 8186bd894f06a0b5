"""PyTorch port of the fused LM-head cross-entropy and the token CE loss
(k8s_tpu_torch/ops/fused_ce.py, k8s_tpu_torch/train), held to the JAX
package on the same numpy inputs.

- ``fused_lm_head_cross_entropy``: value and gradients in ``hidden``,
  ``kernel`` and ``bias`` against the JAX function, with a vocab that
  does not divide into chunks (a padded last chunk on the JAX side), a
  mask and z_loss. f32 compares at rtol 2e-5 / atol 1e-6: the same math
  in another summation order (chunked logsumexp, f32 products). With a
  bf16 head (``compute_dtype``) the products are the same bf16 values
  accumulated in f32 on both sides, so the loss agrees to 1e-5
  relative; gradients are rounded to bf16 at different places by the
  two autodiffs (2e-2 relative, a few bf16 ulps).
- ``cross_entropy_loss`` against the JAX one, and the fused loss
  against it on materialized logits.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.ops.fused_ce import fused_lm_head_cross_entropy as jax_fused_ce
from k8s_tpu.train.trainer_lib import cross_entropy_loss as jax_ce
from k8s_tpu_torch.ops.fused_ce import fused_lm_head_cross_entropy
from k8s_tpu_torch.train import cross_entropy_loss

torch.set_num_threads(2)

F32 = dict(rtol=2e-5, atol=1e-6)


def _inputs(seed, b=2, s=9, e=24, v=103):
    rng = np.random.RandomState(seed)
    return dict(
        hidden=rng.standard_normal((b, s, e)).astype(np.float32),
        kernel=(rng.standard_normal((e, v)) * 0.3).astype(np.float32),
        bias=(rng.standard_normal((v,)) * 0.1).astype(np.float32),
        labels=rng.randint(0, v, (b, s)).astype(np.int32),
        mask=(rng.rand(b, s) > 0.3).astype(np.int32),
    )


def _jax_value_and_grads(x, use_mask, use_bias, z_loss, target_chunk, cdt):
    def f(hidden, kernel, bias):
        return jax_fused_ce(
            hidden, kernel, jnp.asarray(x["labels"]),
            mask=jnp.asarray(x["mask"]) if use_mask else None,
            z_loss=z_loss, target_chunk=target_chunk,
            bias=bias if use_bias else None, compute_dtype=cdt)

    val, grads = jax.value_and_grad(f, argnums=(0, 1, 2))(
        jnp.asarray(x["hidden"]), jnp.asarray(x["kernel"]),
        jnp.asarray(x["bias"]))
    return float(val), [np.asarray(g, np.float32) for g in grads]


def _port_value_and_grads(x, use_mask, use_bias, z_loss, target_chunk, cdt):
    hidden, kernel, bias = (torch.from_numpy(x[k]).requires_grad_()
                            for k in ("hidden", "kernel", "bias"))
    loss = fused_lm_head_cross_entropy(
        hidden, kernel, torch.from_numpy(x["labels"]),
        mask=torch.from_numpy(x["mask"]) if use_mask else None,
        z_loss=z_loss, target_chunk=target_chunk,
        bias=bias if use_bias else None, compute_dtype=cdt)
    loss.backward()
    grads = [hidden.grad.numpy(), kernel.grad.numpy(),
             bias.grad.numpy() if use_bias else np.zeros_like(x["bias"])]
    return loss.item(), grads


@pytest.mark.parametrize("v,target_chunk", [(103, 32), (96, 32), (103, 4096)])
@pytest.mark.parametrize("use_mask,use_bias,z_loss", [
    (False, False, 0.0), (True, True, 1e-2), (True, False, 1e-4)])
def test_fused_ce_matches_jax_f32(v, target_chunk, use_mask, use_bias, z_loss):
    """103 over chunks of <= 32: 4 chunks of 26, the last padded by one
    column on the JAX side (masked to -inf) and 25 wide here; 96: whole
    chunks; 4096: one chunk."""
    x = _inputs(v, v=v)
    want_val, want = _jax_value_and_grads(x, use_mask, use_bias, z_loss,
                                          target_chunk, jnp.float32)
    got_val, got = _port_value_and_grads(x, use_mask, use_bias, z_loss,
                                         target_chunk, torch.float32)
    np.testing.assert_allclose(got_val, want_val, **F32)
    for name, a, b in zip(("hidden", "kernel", "bias"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **F32)


def test_fused_ce_bf16_head_matches_jax():
    x = _inputs(5, v=103)
    x["hidden"] = np.asarray(jnp.asarray(x["hidden"], jnp.bfloat16), np.float32)
    want_val, want = _jax_value_and_grads(x, True, True, 1e-4, 32,
                                          jnp.bfloat16)
    got_val, got = _port_value_and_grads(x, True, True, 1e-4, 32,
                                         torch.bfloat16)
    np.testing.assert_allclose(got_val, want_val, rtol=1e-5)
    for name, a, b in zip(("hidden", "kernel", "bias"), got, want):
        scale = np.abs(b).max()
        np.testing.assert_allclose(a, b, atol=2e-2 * scale, err_msg=name)


def test_fused_ce_equals_unfused_loss():
    """The fused loss and its gradients equal cross_entropy_loss over the
    materialized f32 logits (the same function, chunked)."""
    x = _inputs(11, v=103)
    h1, k1 = (torch.from_numpy(x[n]).requires_grad_() for n in ("hidden", "kernel"))
    h2, k2 = (torch.from_numpy(x[n]).requires_grad_() for n in ("hidden", "kernel"))
    labels, mask = torch.from_numpy(x["labels"]), torch.from_numpy(x["mask"])
    fused = fused_lm_head_cross_entropy(h1, k1, labels, mask=mask,
                                        z_loss=1e-3, target_chunk=16)
    plain = cross_entropy_loss(h2 @ k2, labels, mask=mask, z_loss=1e-3)
    fused.backward()
    plain.backward()
    np.testing.assert_allclose(fused.item(), plain.item(), **F32)
    np.testing.assert_allclose(h1.grad.numpy(), h2.grad.numpy(), **F32)
    np.testing.assert_allclose(k1.grad.numpy(), k2.grad.numpy(), **F32)


@pytest.mark.parametrize("use_mask,z_loss", [(False, 0.0), (True, 1e-4)])
def test_cross_entropy_loss_matches_jax(use_mask, z_loss):
    rng = np.random.RandomState(3)
    logits = (rng.standard_normal((2, 7, 50)) * 3).astype(np.float32)
    labels = rng.randint(0, 50, (2, 7)).astype(np.int32)
    mask = (rng.rand(2, 7) > 0.5).astype(np.int32)
    want = jax_ce(jnp.asarray(logits), jnp.asarray(labels),
                  jnp.asarray(mask) if use_mask else None, z_loss)
    got = cross_entropy_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels),
                             torch.from_numpy(mask) if use_mask else None,
                             z_loss)
    np.testing.assert_allclose(got.item(), float(want), **F32)


def test_fused_ce_refuses_a_mesh_and_misaligned_shapes():
    """A mesh whose tensor axis does not divide the vocab raises before
    any collective (tests/test_torch_tp.py runs the vocab-parallel path
    across ranks): stand-ins for a DTensor head, which states its global
    vocab, and for a mesh with a tensor axis of 4."""
    x = _inputs(1)
    hidden, kernel = torch.from_numpy(x["hidden"]), torch.from_numpy(x["kernel"])
    labels = torch.from_numpy(x["labels"])
    mesh = types.SimpleNamespace(
        mesh_dim_names=("data", "fsdp", "stage", "expert", "seq", "tensor"),
        mesh=np.zeros((1, 1, 1, 1, 1, 4)))
    head = types.SimpleNamespace(shape=kernel.shape, to_local=lambda: kernel)
    with pytest.raises(ValueError, match="vocab 103 is not divisible by the "
                                         "tensor axis size 4"):
        fused_lm_head_cross_entropy(hidden, head, labels, mesh=mesh)
    with pytest.raises(ValueError, match="line up"):
        fused_lm_head_cross_entropy(hidden, kernel, labels[:, :-1])
