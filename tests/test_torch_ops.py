"""PyTorch port of the serving ops (k8s_tpu_torch/ops), held to the JAX
package on the same numpy inputs.

- The flash forward's plain version (what the port runs for a CPU
  tensor) against the JAX Pallas kernel in interpret mode, with lse.
- The ragged decode update's plain version against the JAX Pallas
  kernel in interpret mode: output, appended rows, untouched rest.
- rms_norm and RoPE against JAX.

f32 cases compare at atol/rtol 1e-5 (the same math in another
summation order); bf16 cases at 2e-2 absolute (one bf16 ulp of outputs
of magnitude ~2-4 is ~1.6e-2). The CUDA kernels themselves are held
to the same plain versions on the card by tests/test_torch_kernels.py
and chip_smoke.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.models.llama import _rope as jax_rope
from k8s_tpu.ops import attention as jattn
from k8s_tpu.ops.norms import rms_norm as jax_rms_norm
from k8s_tpu_torch.models.llama import _rope
from k8s_tpu_torch.ops import attention as tattn
from k8s_tpu_torch.ops.norms import rms_norm

torch.set_num_threads(2)

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_ATOL = 2e-2


def _inputs(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrs, dtype):
    """Same values as (jax, torch) arrays of ``dtype`` ("f32"/"bf16")."""
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_fwd_matches_jax_pallas_interpret(causal, dtype):
    """GQA 4/2 heads, 2x2 block grid on the JAX side (cross-block
    online-softmax rescale exercised), output and lse."""
    b, s, hq, hkv, d = 2, 64, 4, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _both(
        _inputs(0, (b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)), dtype)
    scale = 1.0 / math.sqrt(d)
    j_out, j_lse = jattn._flash_forward(
        jq, jk, jv, causal, scale, 32, 32, interpret=True,
        with_residuals=True)
    t_out, t_lse = tattn.flash_fwd(tq, tk, tv, causal, scale, with_lse=True)
    assert t_out.dtype == tq.dtype and t_lse.dtype == torch.float32
    if dtype == "f32":
        np.testing.assert_allclose(_np(t_out), _np(j_out), **F32_TOL)
        np.testing.assert_allclose(
            t_lse.numpy(), np.asarray(j_lse).reshape(b, hq, s), **F32_TOL)
    else:
        np.testing.assert_allclose(_np(t_out), _np(j_out), atol=BF16_ATOL)
        np.testing.assert_allclose(
            t_lse.numpy(), np.asarray(j_lse).reshape(b, hq, s), atol=1e-2)
    assert tattn.flash_fwd.launches == 0  # CPU tensors never launch


@pytest.mark.parametrize("causal", [True, False])
def test_mha_reference_and_gate_match_jax(causal):
    """mha_reference (incl. causal sq < sk with the tril(k=sk-sq)
    diagonal and segment ids) and flash_attention's CPU gate."""
    b, sq, sk, hq, hkv, d = 2, 8, 12, 6, 2, 16
    (jq, jk, jv), (tq, tk, tv) = _both(
        _inputs(1, (b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d)), "f32")
    np.testing.assert_allclose(
        tattn.mha_reference(tq, tk, tv, causal).numpy(),
        np.asarray(jattn.mha_reference(jq, jk, jv, causal)), **F32_TOL)
    seg = np.array([[0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 2]] * 2, np.int32)
    j_ref = jattn.mha_reference(jk.repeat(3, axis=2), jk, jv, causal,
                                segment_ids=jnp.asarray(seg))
    t_ref = tattn.mha_reference(tk.repeat_interleave(3, dim=2), tk, tv,
                                causal, segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(t_ref.numpy(), np.asarray(j_ref), **F32_TOL)
    if not causal:  # the gate takes the reference path on the CPU
        np.testing.assert_allclose(
            tattn.flash_attention(tq, tk, tv, causal=False).numpy(),
            np.asarray(jattn.flash_attention(jq, jk, jv, causal=False)),
            **F32_TOL)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tattn.flash_attention(tq[:, :, :5], tk, tv)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_update_matches_jax_pallas_interpret(dtype):
    """Ragged pos including 0 and S-1: the output, the row appended at
    pos[b] in place, and every other cache row untouched."""
    b, hq, hkv, s, d = 3, 8, 2, 32, 32
    (jq, jkn, jvn, jkc, jvc), (tq, tkn, tvn, tkc, tvc) = _both(
        _inputs(2, (b, hq, d), (b, hkv, d), (b, hkv, d), (b, hkv, s, d),
                (b, hkv, s, d)), dtype)
    kc0, vc0 = tkc.clone(), tvc.clone()
    pos = np.array([0, 13, s - 1], np.int32)
    j_out, j_k, j_v = jattn.decode_attention_update(
        jq, jkn, jvn, jkc, jvc, jnp.asarray(pos), interpret=True)
    t_out, t_k, t_v = tattn.decode_attention_update(
        tq, tkn, tvn, tkc, tvc, torch.from_numpy(pos))
    assert t_k is tkc and t_v is tvc  # in place
    tol = F32_TOL if dtype == "f32" else dict(atol=BF16_ATOL)
    np.testing.assert_allclose(_np(t_out), _np(j_out), **tol)
    np.testing.assert_array_equal(_np(tkc), _np(j_k))
    np.testing.assert_array_equal(_np(tvc), _np(j_v))
    want_k, want_v = kc0.clone(), vc0.clone()
    want_k[torch.arange(b), :, torch.from_numpy(pos).long()] = tkn
    want_v[torch.arange(b), :, torch.from_numpy(pos).long()] = tvn
    assert torch.equal(tkc, want_k) and torch.equal(tvc, want_v)


def test_decode_update_scalar_pos_and_bad_shape():
    (tq, tkn, tvn, tkc, tvc) = [torch.from_numpy(a) for a in _inputs(
        3, (2, 4, 16), (2, 2, 16), (2, 2, 16), (2, 2, 8, 16), (2, 2, 8, 16))]
    out5, _, _ = tattn.decode_attention_update(
        tq, tkn, tvn, tkc.clone(), tvc.clone(), 5)
    vec, _, _ = tattn.decode_attention_update(
        tq, tkn, tvn, tkc.clone(), tvc.clone(), torch.tensor([5, 5]))
    assert torch.equal(out5, vec)
    with pytest.raises(ValueError, match="scalar or"):
        tattn.decode_attention_update(tq, tkn, tvn, tkc, tvc,
                                      torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_matches_jax(dtype):
    (jx, jw), (tx, tw) = _both(_inputs(4, (3, 5, 64), (64,)), dtype)
    j = jax_rms_norm(jx, jw.astype(jnp.float32), 1e-5)
    t = rms_norm(tx, tw.float(), 1e-5)
    assert t.dtype == tx.dtype
    tol = F32_TOL if dtype == "f32" else dict(atol=BF16_ATOL)
    np.testing.assert_allclose(_np(t), _np(j), **tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rope_matches_jax(dtype):
    """Half-split rotation, f32 angles, theta 500000, ragged positions
    up to 2047 (the serving cache depth)."""
    (jx,), (tx,) = _both(_inputs(5, (2, 3, 4, 128)), dtype)
    pos = np.array([[0, 1, 2], [1000, 2046, 2047]], np.int32)
    j = jax_rope(jx, jnp.asarray(pos), 500000.0)
    t = _rope(tx, torch.from_numpy(pos), 500000.0)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "f32" else dict(atol=BF16_ATOL)
    np.testing.assert_allclose(_np(t), _np(j), **tol)
