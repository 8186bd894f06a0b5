"""Segment ids in the flash kernels' plain versions and in the port's
flash op, held to the JAX package on the CPU.

The kernels themselves run only on the card (tests/test_torch_kernels.py
``test_flash_kernels_segment_ids_and_d64_on_card`` and chip_smoke.py hold
them against these plain versions there; tests/test_torch_flash_fwd.py
and test_torch_flash_bwd.py emulate their tile algorithms with the mask).
Here, on the same numpy inputs (bf16 values held in f32):

- ``flash_fwd_plain`` / ``flash_bwd_plain`` with segment ids against the
  Pallas ``_flash_forward`` / ``_flash_backward`` run with
  ``interpret=True`` (one block per sequence, S 128), at head dim 64
  (non-causal, BERT's padding mask, Hq = Hkv) and 128 (causal, packed
  documents, 2 query heads per kv head): out and lse 2e-5 absolute, the
  gradients 2e-5 absolute (both are exact f32 attention; they agree to
  ~1e-6);
- the port's autograd op (``flash_attention_kernel``, whose CPU path runs
  the plain versions through ``torch.library``) with segment ids: out and
  the gradients of a random cotangent against ``jax.vjp`` of the JAX
  ``flash_attention`` in interpret mode (2e-5), also under the Llama's
  ``flash`` remat policy (the op's outputs saved, its segment ids kept
  for the backward), and the gate's plain route (``flash_attention`` on
  CPU tensors, ``mha_reference``) against the same;
- pad rows see pad keys (id 0 == 0), as in the JAX reference, and a
  key of another segment moves nothing: its value changed, every output
  row of the other segments stays bit-equal.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from k8s_tpu.ops import attention as jattn
from k8s_tpu_torch.models.llama import _remat_policy
from k8s_tpu_torch.ops import attention as tattn

ATOL = 2e-5
S = 128


def _bf16_inputs(seed, b, s, hq, hkv, d):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
            .bfloat16().float()
            for sh in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d))]


def _segments(kind, b, s, seed):
    """[B, S] int32: ``pad`` a padding mask (1 real, 0 pad; real lengths
    drawn from 16..S), ``packed`` 3 documents per row (ids 1..3, each at
    least 16 tokens) with a padded tail (0)."""
    rng = np.random.RandomState(seed)
    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        if kind == "pad":
            seg[i, :rng.randint(16, s + 1)] = 1
        else:
            cuts = np.sort(rng.choice(np.arange(1, s // 16), 3, replace=False)) * 16
            start = 0
            for j, end in enumerate(cuts):
                seg[i, start:end] = j + 1
                start = end
    return seg


CASES = {
    # BERT-base's regime: head dim 64, one q head per kv head, non-causal
    "d64_pad": dict(d=64, hq=2, hkv=2, causal=False, kind="pad"),
    # packed documents under the causal mask, GQA
    "d128_packed_causal": dict(d=128, hq=4, hkv=2, causal=True, kind="packed"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_versions_match_pallas_with_segment_ids(case):
    c = CASES[case]
    b, d = 2, c["d"]
    scale = 1.0 / math.sqrt(d)
    q, k, v, do = _bf16_inputs(d, b, S, c["hq"], c["hkv"], d)
    seg = _segments(c["kind"], b, S, d)
    jq, jk, jv, jdo = (jnp.asarray(x.numpy()) for x in (q, k, v, do))
    jseg = jnp.asarray(seg)
    j_out, j_lse = jattn._flash_forward(
        jq, jk, jv, c["causal"], scale, S, S, interpret=True,
        with_residuals=True, segment_ids=jseg)
    j_dd = jattn.compute_dd(j_out, jdo)
    j_grads = jattn._flash_backward(jq, jk, jv, j_dd, j_lse, jdo, c["causal"],
                                    scale, S, S, interpret=True, segment_ids=jseg)
    tseg = torch.from_numpy(seg)
    out, lse = tattn.flash_fwd_plain(q, k, v, c["causal"], scale, tseg)
    np.testing.assert_allclose(out.numpy(), np.array(j_out), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.array(j_lse).reshape(b, c["hq"], S),
                               atol=ATOL)
    # the CPU wrappers run the same plain versions
    w_out, w_lse = tattn.flash_fwd(q, k, v, c["causal"], scale, with_lse=True,
                                   segment_ids=tseg)
    assert torch.equal(w_out, out) and torch.equal(w_lse, lse)
    grads = tattn.flash_bwd(q, k, v, out, lse, do, c["causal"], scale,
                            segment_ids=tseg)
    for name, x, y in zip(("dq", "dk", "dv"), grads, j_grads):
        np.testing.assert_allclose(x.numpy(), np.array(y), atol=ATOL, err_msg=name)
    # without the mask the results differ: the comparison is not vacuous
    free, _ = tattn.flash_fwd_plain(q, k, v, c["causal"], scale)
    assert (free - out).abs().max().item() > 100 * ATOL


@functools.lru_cache(maxsize=None)
def _case_vjp(case):
    """The inputs of ``case`` and the JAX side's out and gradients (once
    per case: the three routes share them)."""
    c = CASES[case]
    b, d = 2, c["d"]
    scale = 1.0 / math.sqrt(d)
    q, k, v, do = _bf16_inputs(d + 1, b, S, c["hq"], c["hkv"], d)
    seg = _segments(c["kind"], b, S, d + 1)
    return (q, k, v, do, seg, scale) + _jax_vjp(q, k, v, do, seg, c["causal"], scale)


def _jax_vjp(q, k, v, do, seg, causal, scale):
    """out and (dq, dk, dv) of the JAX flash_attention in interpret mode."""
    jseg = jnp.asarray(seg)

    def f(q, k, v):
        return jattn.flash_attention(q, k, v, causal=causal, scale=scale,
                                     interpret=True, segment_ids=jseg)

    out, vjp = jax.vjp(f, *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    return np.array(out), [np.array(g) for g in vjp(jnp.asarray(do.numpy()))]


@pytest.mark.parametrize("route", ["op", "op_flash_remat", "gate"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_op_with_segment_ids_matches_jax_vjp(case, route):
    """The autograd op (its segment ids a non-differentiable input saved
    for the backward), the op under the ``flash`` remat policy, and the
    CPU gate (mha_reference under autograd) against ``jax.vjp``."""
    c = CASES[case]
    q, k, v, do, seg, scale, j_out, j_grads = _case_vjp(case)
    tseg = torch.from_numpy(seg)
    qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
    if route == "gate":
        out = tattn.flash_attention(qa, ka, va, causal=c["causal"], scale=scale,
                                    segment_ids=tseg)
    elif route == "op":
        out = tattn.flash_attention_kernel(qa, ka, va, c["causal"], scale, tseg)
    else:
        out = checkpoint(
            lambda q, k, v: tattn.flash_attention_kernel(q, k, v, c["causal"],
                                                         scale, tseg) * 1.0,
            qa, ka, va, use_reentrant=False, context_fn=_remat_policy("flash"))
    out.backward(do)
    np.testing.assert_allclose(out.detach().numpy(), j_out, atol=ATOL)
    for name, x, y in zip(("dq", "dk", "dv"), (qa.grad, ka.grad, va.grad), j_grads):
        np.testing.assert_allclose(x.numpy(), y, atol=ATOL, err_msg=name)


def test_pad_rows_see_pad_keys_and_segments_do_not_leak():
    """JAX's mask: query i sees key j iff their ids are equal, so a pad
    row (id 0) attends over the pad keys; and changing a key of one
    segment leaves every row of the other segments bit-equal."""
    b, d = 1, 64
    scale = d ** -0.5
    q, k, v, _ = _bf16_inputs(7, b, S, 2, 2, d)
    seg = torch.zeros(b, S, dtype=torch.int32)
    seg[:, :90] = 1  # 90 real tokens, 38 pad
    out, _ = tattn.flash_fwd_plain(q, k, v, False, scale, seg)
    pad_only, _ = tattn.flash_fwd_plain(q[:, 90:], k[:, 90:], v[:, 90:], False, scale)
    np.testing.assert_allclose(out[:, 90:].numpy(), pad_only.numpy(), atol=ATOL)
    v2 = v.clone()
    v2[:, 100] += 10.0  # a pad key's value
    out2, _ = tattn.flash_fwd_plain(q, k, v2, False, scale, seg)
    assert torch.equal(out2[:, :90], out[:, :90])
    assert not torch.equal(out2[:, 90:], out[:, 90:])


@pytest.mark.parametrize("s", [5, 128, 777])
def test_segment_rows_as_the_kernels_read_them(s):
    """The wrappers hand the kernels int32 rows, contiguous, their stride
    padded to a multiple of 4 (TMA's 16-byte rule), from any integer
    tensor — a non-contiguous int64 view too; a shape that is not [B, S]
    of q, or Sq != Sk, raises."""
    q = torch.zeros(3, s, 2, 64)
    ids = torch.arange(3 * s).reshape(s, 3).t()  # int64, not contiguous
    rows = tattn._segment_rows(ids, q, s)
    assert rows.dtype == torch.int32 and rows.is_contiguous()
    assert rows.shape == (3, tattn._tma_row_stride(s)) and rows.shape[1] % 4 == 0
    assert torch.equal(rows[:, :s], ids.to(torch.int32))
    assert tattn._segment_rows(None, q, s) is None
    for bad, sk in ((ids[:, :-1], s), (ids, s + 1)):
        with pytest.raises(ValueError, match="segment_ids"):
            tattn._segment_rows(bad, q, sk)
