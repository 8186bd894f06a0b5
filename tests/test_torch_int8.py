"""PyTorch port of int8 serving (k8s_tpu_torch: the int8 KV cache and
weight-only int8), held to the JAX package on the same numpy-seeded
inputs.

- ``quantize_kv_rows`` and ``quantize_params_for_serving`` (through
  ``params_from_jax``, scanned and unrolled trees): BIT-exact with the
  JAX package as it runs them — the KV quantizer under jit, where XLA
  compiles ``amax / 127.0`` as a multiply by the f32 reciprocal, the
  offline weight quantizer eagerly, where it is an IEEE divide.
- The int8-KV decode kernel's plain version against the Pallas kernel
  in interpret mode: the appended int8 rows and scales bit-exact, every
  other row untouched, ``out`` within one bf16 rounding step.
- Model logits and caches in f32, against the JAX model under jit (how
  it serves), for ``quant="int8_serving"`` and
  ``kv_quant="int8"`` (fresh prefill, continuation chunk, single-token
  steps; ragged and scalar index regimes) at tiny head dims, where both
  packages take the plain fallback, and at head_dim 128 in bf16, where
  the JAX side is pointed at its kernel (interpret mode) and the port
  takes the kernel's plain version.
- The engine's tokens against the port's own ``generate`` with int8
  weights and with the int8 KV cache.
"""

import dataclasses
import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.models import LlamaConfig as JaxConfig
from k8s_tpu.models import LlamaForCausalLM as JaxLlama
from k8s_tpu.models import unroll_params_for_decode
from k8s_tpu.ops import attention as jattn
from k8s_tpu.ops.quant import quantize_params_for_serving as jax_quantize
from k8s_tpu_torch.models import (
    KVCache,
    LlamaConfig,
    LlamaForCausalLM,
    generate,
    params_from_jax,
)
from k8s_tpu_torch.ops import attention as tattn
from k8s_tpu_torch.ops.quant import quantize_params_for_serving
from k8s_tpu_torch.serving import ContinuousBatchingEngine

from llm_fixtures import trained_tiny

torch.set_num_threads(2)

# f32 models: the same math in another summation order (1e-4, as in
# test_torch_llama). An int8 rounding is discontinuous, so an f32 ulp
# upstream may move a quantized value across a rounding boundary: int8
# cache values are compared up to one step, in at most 0.1% of them.
F32_TOL = dict(atol=1e-4, rtol=1e-4)
F32_FLIPS = (1, 1e-3)  # (int8 steps, share of the values)
# bf16 activations (head_dim 128): bf16 rounding, as in test_torch_llama.
# There k and v themselves differ by a bf16 step (2^-8 relative) in many
# elements (two in a few, after two layers), and such a step crosses an
# int8 boundary (amax / 127 apart) with probability ~|x| 2^-8 / (amax /
# 127): up to one value in ten differs by an int8 step or two.
# The logits then also see those cache values one or two int8 steps
# apart: 5e-2 rather than the 3e-2 of the bf16 cache.
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
BF16_FLIPS = (2, 0.2)
# the decode kernels' out: f32 math on identical int8 rows, scales and
# bf16 inputs, rounded to bf16 on each side — at most one bf16 step
# (2^-8 relative) apart for values of size ~1
OUT_TOL = dict(atol=1e-2, rtol=1e-2)


def _bf16_pair(a: np.ndarray):
    """One f32 numpy array as the same bf16 values in both frameworks."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).bfloat16()


def test_quantize_kv_rows_bit_exact():
    """Against the JAX quantizer as compiled (jit): run eagerly, JAX
    divides amax by 127 instead and 4-5% of its scales sit one ulp off
    its own compiled ones."""
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 3, 40, 128) * rng.rand(2, 3, 40, 1) * 4).astype(np.float32)
    x[0, 1, 5] = 0.0                                   # all zero: the clamp
    x[1, 2, 7] = rng.randn(128).astype(np.float32) * 1e-9  # under the clamp
    jx, tx = _bf16_pair(x)
    jq, js = jax.jit(jattn.quantize_kv_rows)(jx)
    tq, ts = tattn.quantize_kv_rows(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (2, 3, 40)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert not tq[0, 1, 5].any()
    assert ts[0, 1, 5].item() == np.float32(1e-6) * np.float32(1 / 127)


@pytest.mark.parametrize("pos", [33, [0, 63]])
def test_q8_decode_plain_matches_jax_kernel(pos):
    """K5's plain version against ``decode_attention_update_q8(...,
    interpret=True)`` at B 2, Hq 8, Hkv 2, D 128, S 64: the same int8
    rows and scales after the append, and ``out`` within OUT_TOL."""
    b, hq, hkv, d, s = 2, 8, 2, 128, 64
    rng = np.random.RandomState(1)
    (jq, tq), (jkn, tkn), (jvn, tvn), (jk, tk), (jv, tv) = (
        _bf16_pair(rng.randn(*sh).astype(np.float32)) for sh in
        ((b, hq, d), (b, hkv, d), (b, hkv, d), (b, hkv, s, d), (b, hkv, s, d)))
    quantize = jax.jit(jattn.quantize_kv_rows)  # bit-exact with the port's
    jkc, jks = quantize(jk)
    jvc, jvs = quantize(jv)
    tkc, tks = tattn.quantize_kv_rows(tk)
    tvc, tvs = tattn.quantize_kv_rows(tv)
    before = [t.clone() for t in (tkc, tvc, tks, tvs)]
    out, k2, v2, ks2, vs2 = jattn.decode_attention_update_q8(
        jq, jkn, jvn, jkc, jvc, jks[:, :, None], jvs[:, :, None], pos,
        interpret=True)
    n0 = tattn.decode_attention_update_q8.launches
    got = tattn.decode_attention_update_q8(tq, tkn, tvn, tkc, tvc, tks, tvs, pos)
    assert tattn.decode_attention_update_q8.launches == n0  # CPU: plain only
    assert all(g is t for g, t in zip(got[1:], (tkc, tvc, tks, tvs)))  # in place
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(out, np.float32), **OUT_TOL)
    for t, j in zip(got[1:], (k2, v2, ks2[:, :, 0], vs2[:, :, 0])):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    rows = np.broadcast_to(np.asarray(pos), (b,))
    for t, old in zip(got[1:], before):  # only row pos[b] of each b moved
        keep = torch.ones(b, s, dtype=torch.bool)
        keep[torch.arange(b), torch.from_numpy(rows.copy()).long()] = False
        assert torch.equal(t.transpose(1, 2)[keep], old.transpose(1, 2)[keep])


def _init_scanned(jcfg, seed=0):
    model = JaxLlama(dataclasses.replace(jcfg, decode=False, scan_layers=True,
                                         quant="none", kv_quant="none"))
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    return nn.unbox(params["params"])


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("layout", ["scanned", "unrolled"])
def test_quantize_params_for_serving_matches_jax(layout):
    """The port's quantizer on the converted bf16 weights equals the JAX
    package's on the tree, converted: int8 kernels and f32 scales
    bit-exact (``load_decode_params`` casts to bf16 first, as here)."""
    jcfg = JaxConfig.tiny()
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                    _init_scanned(jcfg))
    if layout == "unrolled":
        params = unroll_params_for_decode(params, jcfg.num_layers)
    want = params_from_jax(_numpy(jax_quantize(params)))
    got = quantize_params_for_serving(params_from_jax(_numpy(params)))
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    e, h, d = jcfg.hidden_size, jcfg.num_heads, jcfg.head_dim
    assert got["layers.1.attn.q_proj.kernel_q"].shape == (e, h * d)
    assert got["layers.1.attn.q_proj.scale"].shape == (h * d,)
    assert got["layers.0.attn.o_proj.kernel_q"].shape == (h * d, e)
    assert got["lm_head.kernel_q"].dtype == torch.int8
    assert got["embed_tokens"].dtype == torch.bfloat16  # passes through
    model = LlamaForCausalLM(LlamaConfig.tiny(decode=True,
                                              quant="int8_serving"), "cpu")
    model.load_params(got)  # names and shapes line up with the modules


def _port_config(jcfg, **kw) -> LlamaConfig:
    dtype = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[jcfg.dtype]
    base = dict(
        vocab_size=jcfg.vocab_size, hidden_size=jcfg.hidden_size,
        intermediate_size=jcfg.intermediate_size, num_layers=jcfg.num_layers,
        num_heads=jcfg.num_heads, num_kv_heads=jcfg.num_kv_heads,
        head_dim=jcfg.head_dim, max_seq_len=jcfg.max_seq_len,
        rope_theta=jcfg.rope_theta, rms_eps=jcfg.rms_eps, dtype=dtype,
        decode=True, ragged_decode=jcfg.ragged_decode, quant=jcfg.quant,
        kv_quant=jcfg.kv_quant)
    base.update(kw)
    return LlamaConfig(**base)


def _run_decode_parity(jcfg, tol, flips):
    """Fresh-cache prefill, a warm continuation chunk, then two single
    steps (ragged depths, or the shared index): logits and every cache
    tensor against the JAX decode model."""
    params = unroll_params_for_decode(_init_scanned(jcfg), jcfg.num_layers)
    if jcfg.quant == "int8_serving":
        params = jax_quantize(params)
    jm = JaxLlama(jcfg)
    japply = jax.jit(functools.partial(jm.apply, mutable=["cache"]))
    tm = LlamaForCausalLM(_port_config(jcfg), device="cpu")
    tm.load_params(params_from_jax(_numpy(params)))
    rng = np.random.RandomState(0)
    b, q8 = 2, jcfg.kv_quant == "int8"

    def check(ids, pos, jcache, tcache):
        variables = {"params": params}
        if jcache is not None:
            variables["cache"] = jcache
        jl, mut = japply(variables, jnp.asarray(ids),
                         positions=jnp.asarray(pos))
        tl, tcache = tm(torch.from_numpy(ids).long(),
                        positions=torch.from_numpy(pos), cache=tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        for i in range(jcfg.num_layers):
            jc = mut["cache"][f"layer_{i}"]["attn"]
            pairs = [(tcache.keys[i], jc["cached_key"]),
                     (tcache.values[i], jc["cached_value"])]
            if q8:
                for t, j in pairs:
                    diff = np.abs(t.numpy().astype(np.int32)
                                  - np.asarray(j, np.int32))
                    assert diff.max() <= flips[0] and (diff > 0).mean() < flips[1]
                np.testing.assert_allclose(tcache.key_scales[i].numpy(),
                                           np.asarray(jc["key_scale"])[:, :, 0], **tol)
                np.testing.assert_allclose(tcache.value_scales[i].numpy(),
                                           np.asarray(jc["value_scale"])[:, :, 0], **tol)
            else:
                for t, j in pairs:
                    np.testing.assert_allclose(t.float().numpy(),
                                               np.asarray(j, np.float32), **tol)
        return mut["cache"], tcache

    ids = rng.randint(0, 512, (b, 8)).astype(np.int32)
    pos = np.broadcast_to(np.arange(8), (b, 8)).astype(np.int32)
    jc, tc = check(ids, pos, None, None)
    assert isinstance(tc, KVCache) and (tc.key_scales is not None) == q8
    ids = rng.randint(0, 512, (b, 4)).astype(np.int32)
    jc, tc = check(ids, (8 + np.arange(4))[None].repeat(b, 0).astype(np.int32),
                   jc, tc)
    steps = ([[12], [3]], [[13], [31]]) if jcfg.ragged_decode else (
        [[12], [12]], [[13], [13]])
    for step_pos in steps:
        ids = rng.randint(0, 512, (b, 1)).astype(np.int32)
        jc, tc = check(ids, np.array(step_pos, np.int32), jc, tc)


@pytest.mark.parametrize("quant,kv_quant,ragged", [
    ("int8_serving", "none", True),
    ("none", "int8", True),
    ("none", "int8", False),  # the scalar cache_index regime
])
def test_int8_decode_logits_match_jax(quant, kv_quant, ragged):
    """Tiny f32 model (head_dim 32): both packages take the plain path
    for every call — the quantized prefill write, the dequantized cache
    for continuation chunks and single steps (the new row quantized
    first), the int8 projections and lm_head."""
    jcfg = JaxConfig.tiny(decode=True, ragged_decode=ragged, dtype=jnp.float32,
                          scan_layers=False, max_seq_len=32, quant=quant,
                          kv_quant=kv_quant)
    _run_decode_parity(jcfg, F32_TOL, F32_FLIPS)


def test_int8_kv_kernel_route_at_head_dim_128(monkeypatch):
    """head_dim 128, 4 q heads per kv head, bf16: the port's gate sends
    decode steps to K5 (its plain version on the CPU, the new token's
    term exact), so the JAX side is pointed at its own K5 in interpret
    mode — its CPU gate would take the fallback, which quantizes the new
    token first and differs by design."""
    from k8s_tpu.models import llama as jllama

    monkeypatch.setattr(jllama, "_use_pallas_decode", lambda *a, **k: True)
    monkeypatch.setattr(jattn, "decode_attention_update_q8", functools.partial(
        jattn.decode_attention_update_q8, interpret=True))
    jcfg = JaxConfig.tiny(decode=True, ragged_decode=True, dtype=jnp.bfloat16,
                          scan_layers=False, max_seq_len=32, head_dim=128,
                          num_heads=8, num_kv_heads=2, kv_quant="int8")
    n0 = tattn.decode_attention_update_q8.launches
    _run_decode_parity(jcfg, BF16_TOL, BF16_FLIPS)
    assert tattn.decode_attention_update_q8.launches == n0


def _fixture_model(cfg, params, **kw) -> LlamaForCausalLM:
    pcfg = LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_layers=cfg.num_layers,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, max_seq_len=64, rope_theta=cfg.rope_theta,
        rms_eps=cfg.rms_eps, dtype=torch.bfloat16, decode=True, **kw)
    model = LlamaForCausalLM(pcfg, device="cpu")
    model.load_params(params)
    return model


@pytest.mark.parametrize("quant,kv_quant", [("int8_serving", "none"),
                                            ("none", "int8"),
                                            ("int8_serving", "int8")])
def test_engine_matches_port_generate_int8(quant, kv_quant):
    """The engine's tokens equal a solo ``generate`` of the same int8
    model (the counterparts of the JAX engine's int8 tests): the int8
    lm_head of the prefill insert, the scale-carrying slot views, the
    int8-KV decode steps at ragged depths."""
    cfg, jparams = trained_tiny()
    params = params_from_jax(_numpy(jparams))
    if quant == "int8_serving":
        params = quantize_params_for_serving(params)
    kw = dict(quant=quant, kv_quant=kv_quant)
    engine_model = _fixture_model(cfg, params, ragged_decode=True, **kw)
    oracle = _fixture_model(cfg, params, **kw)
    eng = ContinuousBatchingEngine(engine_model, max_slots=2, decode_chunk=4,
                                   prompt_buckets=(4, 8))
    prompts = [np.array([2, 3, 5, 7], np.int32), np.array([11, 4, 9], np.int32),
               np.array([1, 8, 27, 64, 125, 216, 343], np.int32)]
    rids = [eng.submit(p, 6) for p in prompts]
    out = eng.run()
    for rid, p in zip(rids, prompts):
        ref = generate(oracle, torch.from_numpy(p).long()[None], 6)[0]
        assert np.array_equal(out[rid], ref.numpy()), (out[rid], ref)


def test_int8_config_validation_and_cache_layout():
    with pytest.raises(ValueError, match="kv_quant"):
        LlamaConfig.tiny(decode=True, kv_quant="fp8")
    with pytest.raises(ValueError, match="unknown quant"):
        LlamaConfig.tiny(decode=True, quant="int4")
    with pytest.raises(ValueError, match="decode=True"):
        LlamaConfig.tiny(quant="int8_serving")
    cfg = LlamaConfig.tiny(decode=True, kv_quant="int8")
    cache = KVCache.zeros(cfg, 3, device="cpu")
    assert cache.keys[0].dtype == torch.int8
    assert cache.key_scales[1].shape == (3, cfg.num_kv_heads, cfg.max_seq_len)
    view = cache.slot(1)
    view.key_scales[0][0, :, :4] = 2.0
    assert (cache.key_scales[0][1, :, :4] == 2.0).all()  # a view
    small = KVCache.zeros(cfg, 1, 16, device="cpu")
    small.keys[0].fill_(7)
    small.value_scales[1].fill_(0.5)
    cache.copy_rows_(small, 2, 8)
    assert (cache.keys[0][2, :, :8] == 7).all() and not cache.keys[0][2, :, 8:].any()
    assert (cache.value_scales[1][2, :, :8] == 0.5).all()
    assert KVCache.zeros(LlamaConfig.tiny(decode=True), 1, device="cpu").key_scales is None
