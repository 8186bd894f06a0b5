"""PyTorch port of the Llama decode path (k8s_tpu_torch/models), held to
the JAX package on the same weights.

- ``params_from_jax`` reads both flax layouts (scanned ``layers/block``
  and unrolled ``layer_{i}``) into identical port weights.
- Decode-model logits and cache rows against the JAX decode model in
  f32 (atol/rtol 1e-4: the same math in another summation order over a
  2-layer model) for a fresh-cache prefill, a warm-cache continuation
  chunk and single-token ragged steps — through the plain attention
  path (head_dim 32) and through the decode kernel's plain version
  (head_dim 128 with 4 q heads per kv head, bf16 cache; 3e-2 there).
- ``generate`` tokens identical to JAX ``generate`` on the trained
  fixture (random-init logits are near-ties, trained ones are not).
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.models import LlamaConfig as JaxConfig
from k8s_tpu.models import LlamaForCausalLM as JaxLlama
from k8s_tpu.models import generate as jax_generate
from k8s_tpu.models import unroll_params_for_decode
from k8s_tpu_torch.models import (
    KVCache,
    LlamaConfig,
    LlamaForCausalLM,
    generate,
    init_params,
    params_from_jax,
)

from llm_fixtures import trained_tiny

torch.set_num_threads(2)

F32_TOL = dict(atol=1e-4, rtol=1e-4)


def _port_config(jcfg, **kw) -> LlamaConfig:
    dtype = {jnp.float32: torch.float32,
             jnp.bfloat16: torch.bfloat16}[jcfg.dtype]
    base = dict(
        vocab_size=jcfg.vocab_size, hidden_size=jcfg.hidden_size,
        intermediate_size=jcfg.intermediate_size,
        num_layers=jcfg.num_layers, num_heads=jcfg.num_heads,
        num_kv_heads=jcfg.num_kv_heads, head_dim=jcfg.head_dim,
        max_seq_len=jcfg.max_seq_len, rope_theta=jcfg.rope_theta,
        rms_eps=jcfg.rms_eps, dtype=dtype, decode=True,
        ragged_decode=jcfg.ragged_decode)
    base.update(kw)
    return LlamaConfig(**base)


def _init_scanned(jcfg, seed=0):
    model = JaxLlama(dataclasses.replace(jcfg, decode=False,
                                         scan_layers=True))
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    return nn.unbox(params["params"])


def _port(jcfg, np_params, **kw) -> LlamaForCausalLM:
    model = LlamaForCausalLM(_port_config(jcfg, **kw), device="cpu")
    model.load_params(params_from_jax(np_params))
    return model


def test_params_from_jax_scanned_and_unrolled_layouts():
    jcfg = JaxConfig.tiny(dtype=jnp.float32)
    scanned = jax.tree_util.tree_map(np.asarray, _init_scanned(jcfg))
    unrolled = jax.tree_util.tree_map(
        np.asarray, unroll_params_for_decode(scanned, jcfg.num_layers))
    a, b = params_from_jax(scanned), params_from_jax(unrolled)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    e, h, kv, d = 128, 4, 2, 32
    assert a["layers.1.attn.q_proj"].shape == (e, h * d)
    assert a["layers.1.attn.k_proj"].shape == (e, kv * d)
    assert a["layers.0.attn.o_proj"].shape == (h * d, e)
    assert a["lm_head"].shape == (e, 512)
    np.testing.assert_array_equal(
        a["layers.1.attn.o_proj"].numpy(),
        unrolled["layer_1"]["attn"]["o_proj"]["kernel"].reshape(h * d, e))
    # bf16 trees keep their bits
    bf = jax.tree_util.tree_map(
        lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), scanned)
    c = params_from_jax(bf)
    assert c["embed_tokens"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        c["embed_tokens"].float().numpy(),
        np.asarray(bf["embed_tokens"]["embedding"], np.float32))
    model = LlamaForCausalLM(_port_config(jcfg), device="cpu")
    model.load_params(a)  # names and shapes line up with the module
    with pytest.raises(ValueError, match="missing"):
        model.load_params({k: v for k, v in a.items() if k != "lm_head"})


@pytest.mark.parametrize("head_dim,num_heads,dtype,tol", [
    (32, 4, jnp.float32, F32_TOL),
    # head_dim 128, 4 q heads per kv head, bf16: the kernels' config,
    # so decode steps take the decode kernel's gate (its plain version
    # on the CPU); bf16 activations, so a bf16 tolerance
    (128, 8, jnp.bfloat16, dict(atol=3e-2, rtol=3e-2)),
])
def test_decode_logits_match_jax(head_dim, num_heads, dtype, tol):
    """Fresh-cache prefill (flash path), a warm-cache continuation chunk
    at per-row offsets, then single-token steps at RAGGED positions:
    logits and every cache row agree with the JAX decode model."""
    jcfg = JaxConfig.tiny(decode=True, ragged_decode=True, dtype=dtype,
                          scan_layers=False, max_seq_len=32,
                          head_dim=head_dim, num_heads=num_heads, num_kv_heads=2)
    params = unroll_params_for_decode(_init_scanned(jcfg), jcfg.num_layers)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    jm, tm = JaxLlama(jcfg), _port(jcfg, np_params)
    rng = np.random.RandomState(0)

    def check(ids, pos, jcache, tcache):
        variables = {"params": params}
        if jcache is not None:
            variables["cache"] = jcache
        jl, mut = jm.apply(variables, jnp.asarray(ids),
                           positions=jnp.asarray(pos), mutable=["cache"])
        tl, tcache = tm(torch.from_numpy(ids).long(),
                        positions=torch.from_numpy(pos), cache=tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        for i in range(jcfg.num_layers):
            jc = mut["cache"][f"layer_{i}"]["attn"]
            np.testing.assert_allclose(
                tcache.keys[i].float().numpy(),
                np.asarray(jc["cached_key"], np.float32), **tol)
            np.testing.assert_allclose(
                tcache.values[i].float().numpy(),
                np.asarray(jc["cached_value"], np.float32), **tol)
        return mut["cache"], tcache

    b = 2
    ids = rng.randint(0, 512, (b, 8)).astype(np.int32)
    pos = np.broadcast_to(np.arange(8), (b, 8)).astype(np.int32)
    jc, tc = check(ids, pos, None, None)
    assert isinstance(tc, KVCache) and not tc.fresh
    ids = rng.randint(0, 512, (b, 4)).astype(np.int32)
    jc, tc = check(ids, (8 + np.arange(4))[None].repeat(b, 0).astype(np.int32),
                   jc, tc)
    for step_pos in ([[12], [3]], [[13], [31]]):
        ids = rng.randint(0, 512, (b, 1)).astype(np.int32)
        jc, tc = check(ids, np.array(step_pos, np.int32), jc, tc)


def test_generate_matches_jax_on_trained_fixture():
    """Greedy tokens identical to the JAX package's generate, in the
    fixture's bf16 compute, for one-shot and chunked prefill. Prompts
    follow the fixture's training rule; even so its partly-trained
    logits reach a near-tie (gap < bf16 rounding) within 20 tokens for
    some starts (21 and 48 of the nine surveyed), so these are starts
    whose streams keep real margins."""
    cfg, params = trained_tiny()
    np_params = jax.tree_util.tree_map(np.asarray, params)
    jcfg = dataclasses.replace(cfg, decode=True, max_seq_len=64)
    jm, tm = JaxLlama(jcfg), _port(jcfg, np_params)
    steps = np.arange(11)
    prompt = np.stack([(s * (steps + 1) * 3 + 7 * steps) % 512
                       for s in (5, 40, 79, 300)]).astype(np.int32)
    want = np.asarray(jax_generate(jm, params, jnp.asarray(prompt), 20))
    got = generate(tm, torch.from_numpy(prompt).long(), 20)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    chunked = generate(tm, torch.from_numpy(prompt).long(), 20,
                       prefill_chunk=4)
    np.testing.assert_array_equal(chunked.numpy(), want)
    assert generate(tm, torch.from_numpy(prompt).long(), 0).shape == (4, 0)
    with pytest.raises(ValueError, match="exceeds"):
        generate(tm, torch.from_numpy(prompt).long(), 60)


def test_init_params_seeded_and_shaped():
    cfg = LlamaConfig.tiny(dtype=torch.float32, decode=True)
    a = init_params(cfg, seed=3, device="cpu")
    b = init_params(cfg, seed=3, device="cpu", dtype=torch.bfloat16)
    assert torch.equal(a["lm_head"].bfloat16(), b["lm_head"])
    std = a["layers.0.attn.q_proj"].std().item()
    assert abs(std - cfg.hidden_size ** -0.5) < 0.01  # lecun-normal scale
    assert a["layers.0.attn.q_proj"].abs().max() < 2.5 * std / 0.8796 + 1e-6
    assert abs(a["embed_tokens"].std().item() - 0.02) < 1e-3
    assert torch.equal(a["final_norm.weight"], torch.ones(cfg.hidden_size))
    c = init_params(cfg, seed=4, device="cpu")
    assert not torch.equal(a["lm_head"], c["lm_head"])
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_params(a)
    logits, _ = model(torch.zeros(1, 4, dtype=torch.long))
    assert logits.shape == (1, 4, 512) and torch.isfinite(logits).all()


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(LlamaConfig.tiny(), seed=0)


def test_kv_cache_zeros_defaults_to_the_card():
    """KVCache.zeros is an entry point: it runs on the card unless the
    caller asks for the CPU, so without a card its default raises."""
    cfg = LlamaConfig.tiny(decode=True)
    cache = KVCache.zeros(cfg, 1, device="cpu")
    assert cache.keys[0].shape == (1, cfg.num_kv_heads, cfg.max_seq_len,
                                   cfg.head_dim)
    assert cache.keys[0].device.type == "cpu" and len(cache.values) == 2
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KVCache.zeros(cfg, 1)
