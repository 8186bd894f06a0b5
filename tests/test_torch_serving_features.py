"""The serving engine's prefix cache, self-speculative decode and KV wire
(k8s_tpu_torch/serving), held to the JAX package on the trained tiny
fixture.

Every request's greedy tokens must be IDENTICAL to the JAX engine built
with the same arguments (and to JAX ``generate``), with equal counters:
prompts follow the fixture's training rule, so each argmax has a real
logit margin and bf16 rounding differences between the two frameworks
(~1e-2) do not decide one. The tiny head dim has no decode kernel, so
both packages run plain attention on the CPU. The wire's bodies must be
byte-equal to the JAX package's; a prefix snapshot moves between the
two packages' engines in both directions.
"""

import dataclasses
import json
import threading
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.models import LlamaConfig as JaxConfig
from k8s_tpu.models import LlamaForCausalLM as JaxLlama
from k8s_tpu.models import generate as jax_generate
from k8s_tpu.models import unroll_params_for_decode
from k8s_tpu.serving import ContinuousBatchingEngine as JaxEngine
from k8s_tpu.serving import kv_transfer as jax_wire
from k8s_tpu.serving.engine import _ngram_draft as jax_ngram_draft
from k8s_tpu_torch.controller import metrics as port_metrics
from k8s_tpu_torch.models import KVCache, LlamaConfig, LlamaForCausalLM, params_from_jax
from k8s_tpu_torch.serving import ContinuousBatchingEngine, ServingFrontend
from k8s_tpu_torch.serving import kv_transfer as wire
from k8s_tpu_torch.serving.engine import _ngram_draft, jax_cache_leaves

from llm_fixtures import trained_tiny

torch.set_num_threads(2)

MAX_SEQ = 64
BUCKETS = (4, 8, 16, 32)
# engine arguments both packages get: 2 slots, 4-step chunks, chunk
# buckets 4 and 8, a prefix of 9 tokens rounded DOWN to the grid: 8
ENGINE = dict(max_slots=2, decode_chunk=4, prompt_buckets=BUCKETS,
              prefill_chunk=8)
PREFIX = 8


def _port_model(cfg, params, **kw):
    pcfg = LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_layers=cfg.num_layers,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, max_seq_len=MAX_SEQ,
        rope_theta=cfg.rope_theta, rms_eps=cfg.rms_eps,
        dtype=torch.bfloat16, decode=True, ragged_decode=True, **kw)
    model = LlamaForCausalLM(pcfg, device="cpu")
    model.load_params(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return model


@pytest.fixture(scope="module")
def fx():
    """The port's models and the JAX ones in the JAX serving program's
    unrolled layout (``scan_layers=False``: one ``layer_<i>`` module per
    layer, the cache tree a snapshot's leaves follow)."""
    cfg, params = trained_tiny()
    cfg = dataclasses.replace(cfg, scan_layers=False)
    params = unroll_params_for_decode(params, cfg.num_layers)
    ns = types.SimpleNamespace(params=params, cfg=cfg)
    ns.port = _port_model(cfg, params)
    ns.port_q8 = _port_model(cfg, params, kv_quant="int8")
    dec = dict(decode=True, max_seq_len=MAX_SEQ)
    ns.jax = JaxLlama(dataclasses.replace(cfg, ragged_decode=True, **dec))
    ns.jax_q8 = JaxLlama(dataclasses.replace(cfg, ragged_decode=True,
                                             kv_quant="int8", **dec))
    ns.oracle = JaxLlama(dataclasses.replace(cfg, **dec))
    return ns


def _rule_prompt(start: int, n: int) -> np.ndarray:
    """A prompt following the fixture's training rule (llm_fixtures):
    prompts of one ``start`` share their leading tokens, so two lengths
    of one start are two prompts with a common prefix. The starts used
    are ones whose plain greedy streams agree between the two packages at
    every length 3-16 and 40 (bf16 cache: 5, 12, 31, 55, 101, 203, 250,
    333; int8 cache: 12, 21, 40, 77, 250, 333): on some others the
    fixture's top two logits sit within bf16 rounding of each other."""
    steps = np.arange(n)
    return ((start * (steps + 1) * 3 + 7 * steps) % 512).astype(np.int32)


def _serve(eng, prompts, news, sequential=True):
    """Tokens of every request; ``sequential``: one request at a time, so
    each sees the prefix cache its predecessors left."""
    if sequential:
        out = []
        for p, n in zip(prompts, news):
            rid = eng.submit(p, n)
            out.append(eng.run()[rid])
    else:
        rids = [eng.submit(p, n) for p, n in zip(prompts, news)]
        res = eng.run()
        out = [res[r] for r in rids]
    stats = dict(eng.stats)
    eng.close()
    return out, stats


def _both(fx, prompts, news, q8=False, sequential=True, **kw):
    """The same requests through the port's engine and the JAX engine
    built with the same arguments."""
    port = ContinuousBatchingEngine(fx.port_q8 if q8 else fx.port, **ENGINE, **kw)
    jeng = JaxEngine(fx.jax_q8 if q8 else fx.jax, fx.params, **ENGINE, **kw)
    return (_serve(port, prompts, news, sequential),
            _serve(jeng, prompts, news, sequential))


def _generate(fx, prompt, n):
    return np.asarray(jax_generate(fx.oracle, fx.params,
                                   jnp.asarray(prompt)[None], n))[0]


def _assert_same(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        assert np.array_equal(x, y), (i, x, y)


PREFIX_STATS = ("prefix_captures", "prefix_hits", "prefix_misses",
                "prefix_tokens_saved", "prefill_tokens", "prefix_cache_bytes")
SPEC_STATS = ("spec_decode_rounds", "spec_decode_drafted", "spec_decode_accepted",
              "spec_decode_fallbacks")

# --- the shared-prefix cache -------------------------------------------


def test_prefix_reuse_matches_jax_engine_and_generate(fx):
    """Prefix A is captured, hit twice in a row, then prefix B (another
    start) takes the same stage of the working cache before A is hit
    again: an aliased snapshot (the capture or the hit sharing storage
    with the working cache, which chunks write in place) would hand the
    last hit B's rows."""
    a = [_rule_prompt(5, n) for n in (11, 13, 10)]
    b = _rule_prompt(12, 12)
    prompts, news = a + [b, _rule_prompt(5, 14)], [6, 5, 7, 4, 6]
    (port, pstats), (jout, jstats) = _both(fx, prompts, news,
                                           prefix_cache_tokens=PREFIX + 1)
    _assert_same(port, jout)
    # the last hit (the one an aliased snapshot would corrupt)
    assert np.array_equal(port[-1], _generate(fx, prompts[-1], news[-1]))
    assert {k: pstats[k] for k in PREFIX_STATS} == \
        {k: jstats[k] for k in PREFIX_STATS}
    assert (pstats["prefix_captures"], pstats["prefix_hits"],
            pstats["prefix_tokens_saved"]) == (2, 3, 3 * PREFIX)
    base, bstats = _serve(ContinuousBatchingEngine(fx.port, **ENGINE),
                          prompts, news)
    _assert_same(port, base)
    assert pstats["prefill_tokens"] < bstats["prefill_tokens"]
    assert bstats["prefix_cache_bytes"] == 0
    # two snapshots of stage 8: 2 layers x (k, v) x [1, 2, 8, 32] bf16
    assert pstats["prefix_cache_bytes"] == 2 * (2 * 2 * 2 * 8 * 32 * 2)


def test_prefix_lru_eviction_and_bytes(fx):
    """Three prefixes through an LRU of two, each visited twice: the
    revisits hit, the bytes count exactly the two snapshots held."""
    prompts = [_rule_prompt(s, n) for s in (31, 101, 203) for n in (12, 10)]
    news = [3] * len(prompts)
    (port, pstats), (jout, jstats) = _both(
        fx, prompts, news, prefix_cache_tokens=PREFIX, prefix_cache_max=2)
    _assert_same(port, jout)
    assert {k: pstats[k] for k in PREFIX_STATS} == \
        {k: jstats[k] for k in PREFIX_STATS}
    assert (pstats["prefix_captures"], pstats["prefix_hits"]) == (3, 3)
    eng = ContinuousBatchingEngine(fx.port, **ENGINE, prefix_cache_tokens=PREFIX,
                                   prefix_cache_max=2)
    _serve(eng, prompts, news)
    assert len(eng._prefix_cache) == 2 and len(set(eng._prefix_bytes.values())) == 1
    assert eng.stats["prefix_cache_bytes"] == sum(eng._prefix_bytes.values()) > 0


def test_prefix_bypass_short_prompt_and_one_shot_path(fx):
    eng = ContinuousBatchingEngine(fx.port, **ENGINE, prefix_cache_tokens=PREFIX)
    out, stats = _serve(eng, [_rule_prompt(12, 6)], [3])  # 6 <= prefix 8
    assert len(out[0]) == 3
    assert stats["prefix_captures"] == stats["prefix_misses"] == 0
    assert eng.prefix_digest(_rule_prompt(12, 6)) is None
    legacy = ContinuousBatchingEngine(fx.port, **ENGINE, chunked_prefill=False,
                                      prefix_cache_tokens=PREFIX)
    assert legacy._prefix_len == 0
    out, stats = _serve(legacy, [_rule_prompt(12, 11)], [3])
    plain, _ = _serve(ContinuousBatchingEngine(fx.port, **ENGINE),
                      [_rule_prompt(12, 11)], [3])
    assert np.array_equal(out[0], plain[0])
    assert stats["prefix_captures"] == stats["prefix_misses"] == 0


def test_int8_kv_prefix_and_spec_decode_match_jax_engine(fx):
    """An int8 cache under both features in one engine: the snapshot
    carries the f32 row scales (counted in the bytes), the hit and the
    verify rounds' tokens and every counter equal the JAX int8 engine's."""
    prompts = [_rule_prompt(250, n) for n in (12, 14)]
    (port, pstats), (jout, jstats) = _both(
        fx, prompts, [8, 8], q8=True, prefix_cache_tokens=PREFIX,
        spec_decode_k=3)
    _assert_same(port, jout)
    keys = PREFIX_STATS + SPEC_STATS
    assert {k: pstats[k] for k in keys} == {k: jstats[k] for k in keys}
    assert pstats["prefix_hits"] == 1 and pstats["spec_decode_rounds"] > 0
    # int8 rows [1, 2, 8, 32] and f32 scales [1, 2, 8], for k and v, x2
    assert pstats["prefix_cache_bytes"] == 2 * 2 * (2 * 8 * 32 + 2 * 8 * 4)


# --- self-speculative decode -------------------------------------------


SPEC_PROMPTS = [(5, 3), (12, 9), (55, 13), (101, 16)]
SPEC_NEWS = [6, 4, 8, 5]


@pytest.fixture(scope="module")
def spec_plain(fx):
    """The spec prompts through the port's plain engine."""
    return _serve(ContinuousBatchingEngine(fx.port, **ENGINE),
                  [_rule_prompt(s, n) for s, n in SPEC_PROMPTS], SPEC_NEWS,
                  sequential=False)[0]


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_spec_decode_matches_jax_engine_and_plain(fx, spec_plain, k):
    """Every draft length gives the plain engine's tokens. The JAX engine
    is held beside it at the shortest and the longest draft (each length
    is one more XLA compile of its verify step; 2 and 3 take no branch of
    the round that 1 and 4 do not), tokens and counters."""
    prompts = [_rule_prompt(s, n) for s, n in SPEC_PROMPTS]
    if k in (1, 4):
        (port, pstats), (jout, jstats) = _both(fx, prompts, SPEC_NEWS,
                                               sequential=False, spec_decode_k=k)
        _assert_same(port, jout)
        assert {n: pstats[n] for n in SPEC_STATS} == {n: jstats[n] for n in SPEC_STATS}
    else:
        port, pstats = _serve(ContinuousBatchingEngine(fx.port, **ENGINE, spec_decode_k=k),
                              prompts, SPEC_NEWS, sequential=False)
    _assert_same(port, spec_plain)
    assert pstats["spec_decode_rounds"] > 0


def test_spec_decode_near_cache_end_falls_back(fx):
    """8 + 56 = 64 = max_seq: the last rounds have no room for K + 1
    verify rows, so the pump runs plain chunks instead, counted."""
    (port, pstats), (jout, jstats) = _both(fx, [_rule_prompt(203, 8)], [56],
                                           spec_decode_k=4)
    _assert_same(port, jout)
    assert len(port[0]) == 56
    assert pstats["spec_decode_fallbacks"] == jstats["spec_decode_fallbacks"] > 0


def test_spec_decode_slot_reuse_across_batches(fx):
    """More requests than slots, staggered budgets: a freed slot's stale
    verify rows must not leak into its next occupant's stream."""
    prompts = [_rule_prompt(s, 3 + i) for i, s in enumerate((5, 12, 31, 101, 203, 5))]
    news = [2, 7, 3, 9, 1, 6]
    (port, _), (jout, _) = _both(fx, prompts, news, sequential=False,
                                 spec_decode_k=4)
    _assert_same(port, jout)


def test_ngram_draft_matches_jax():
    ctx = np.array([5, 6, 7, 5, 6], np.int32)
    assert list(_ngram_draft(ctx, 3, 2)) == [7, 5, 6]
    assert _ngram_draft(np.array([1, 2], np.int32), 3, 2).size == 0
    rng = np.random.RandomState(4)
    for _ in range(200):
        ctx = rng.randint(0, 6, size=rng.randint(1, 40)).astype(np.int32)
        k, n = int(rng.randint(1, 6)), int(rng.randint(1, 4))
        assert np.array_equal(_ngram_draft(ctx, k, n), jax_ngram_draft(ctx, k, n))


def test_spec_decode_refuses_sampling(fx):
    with pytest.raises(ValueError, match="temperature=0"):
        ContinuousBatchingEngine(fx.port, **ENGINE, spec_decode_k=2,
                                 temperature=0.7)


# --- the wire ------------------------------------------------------------


def _wire_leaves():
    rng = np.random.RandomState(2)
    f32 = rng.randn(3, 5, 7).astype(np.float32)
    i8 = rng.randint(-127, 128, (2, 300, 1000)).astype(np.int8)  # > 1 MiB
    bf = np.asarray(jnp.asarray(rng.randn(2, 3, 4, 5), jnp.bfloat16))
    return [bf, i8, f32]


def test_wire_bytes_equal_jax_and_cross_unpack():
    meta = {"kind": "prefix", "stage": 8, "tokens": [1, 2, 3]}
    leaves = _wire_leaves()
    body = jax_wire.pack_kv(meta, leaves)
    assert wire.pack_kv(meta, leaves) == body            # numpy leaves
    assert wire.pack_kv(meta, [wire.as_torch(x) for x in leaves]) == body
    m, got = wire.unpack_kv(body)
    assert m["tokens"] == [1, 2, 3] and got[0].dtype == torch.bfloat16
    for g, x in zip(got, leaves):
        assert wire.pack_kv({}, [g]) == jax_wire.pack_kv({}, [x])
    jm, jgot = jax_wire.unpack_kv(wire.pack_kv(meta, got))
    assert jm == m
    for j, x in zip(jgot, leaves):
        assert j.dtype == x.dtype and np.array_equal(j.view(np.uint8),
                                                     x.view(np.uint8))
    assert wire.pack_kv(meta, []) == jax_wire.pack_kv(meta, [])


@pytest.mark.parametrize("fault", ["flip", "truncate", "trailing"])
def test_wire_faults_raise(fault):
    body = bytearray(wire.pack_kv({"stage": 8}, _wire_leaves()))
    if fault == "flip":
        body[-5] ^= 0x40
    elif fault == "truncate":
        body = body[:len(body) // 2]
    else:
        body += bytes(9)
    with pytest.raises(ValueError, match="kv transfer"):
        wire.unpack_kv(bytes(body))


# --- moving a prefix between the packages ------------------------------


def test_prefix_moves_jax_to_port_and_port_to_jax(fx):
    """A JAX engine's captured prefix, exported, packed and installed
    into a port engine: the port's first request is a hit with the JAX
    engine's tokens. Then the same from the port to JAX."""
    p0, p1 = _rule_prompt(101, 12), _rule_prompt(101, 10)
    kw = dict(ENGINE, prefix_cache_tokens=PREFIX)
    for src_kind in ("jax", "port"):
        src = (JaxEngine(fx.jax, fx.params, **kw) if src_kind == "jax"
               else ContinuousBatchingEngine(fx.port, **kw))
        dst = (ContinuousBatchingEngine(fx.port, **kw) if src_kind == "jax"
               else JaxEngine(fx.jax, fx.params, **kw))
        src.submit(p0, 4)
        src.run()
        digest = src.prefix_digest(p1)
        assert src.prefix_keys() == [digest] and src.has_prefix(digest)
        packed = src.export_prefix(digest)
        body = (jax_wire if src_kind == "jax" else wire).pack_kv(*packed)
        meta, leaves = (wire if src_kind == "jax" else jax_wire).unpack_kv(body)
        dst.install_prefix(meta, leaves)
        assert dst.stats["prefix_installs"] == 1 and dst.has_prefix(digest)
        want, _ = _serve(src, [p1], [6])
        got, stats = _serve(dst, [p1], [6])
        assert stats["prefix_hits"] == 1 and stats["prefix_misses"] == 0
        assert np.array_equal(got[0], want[0]), (src_kind, got, want)
    with pytest.raises(ValueError, match="prefix import"):
        ContinuousBatchingEngine(fx.port, **kw).install_prefix(
            meta, leaves[:-1])


def test_install_refuses_another_stage(fx):
    """A snapshot whose leaves all fit its stage, but a stage larger than
    the one this engine captures at (8): its hit would carry 16 or 64
    rows into the 8- or 16-row working cache of the next chunk, on the
    pump thread. It is refused on the caller's thread instead, and the
    engine serves on; an engine with the cache off refuses any snapshot."""
    eng = ContinuousBatchingEngine(fx.port, **ENGINE, prefix_cache_tokens=PREFIX)
    tokens = _rule_prompt(31, PREFIX).tolist()
    for stage in (16, MAX_SEQ):
        snap = KVCache.zeros(fx.port.config, 1, stage, "cpu", fresh=False)
        with pytest.raises(ValueError, match="stage"):
            eng.install_prefix({"kind": "prefix", "stage": stage, "tokens": tokens},
                               jax_cache_leaves(snap))
    out, stats = _serve(eng, [_rule_prompt(31, 12)], [3])
    assert len(out[0]) == 3
    assert (stats["prefix_installs"], stats["prefix_misses"]) == (0, 1)
    off = ContinuousBatchingEngine(fx.port, **ENGINE)
    with pytest.raises(ValueError, match="prefix import"):
        off.install_prefix({"kind": "prefix", "stage": 8, "tokens": []}, [])
    off.close()


def test_twelve_layer_leaf_order_and_scale_shape():
    """12 layers (the 2-layer fixture cannot tell string order from
    numeric order) with an int8 cache (its scales): every leaf of a JAX
    stage cache, filled with a value naming its layer and kind, lands in
    the port's cache tensor of that layer and kind, and the port's
    export gives the JAX order, shapes and bytes back."""
    jcfg = JaxConfig.tiny(decode=True, ragged_decode=True, num_layers=12,
                          max_seq_len=32, kv_quant="int8", scan_layers=False)
    jmodel = JaxLlama(jcfg)
    ids = jnp.zeros((1, 4), jnp.int32)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), ids, positions=ids))
    kinds = ("cached_key", "cached_value", "key_scale", "value_scale")
    leaves, names = [], []
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["cache"])[0]:
        layer, kind = int(path[0].key.split("_")[1]), path[-1].key
        shape = (1,) + leaf.shape[1:-1] + (8,) if "scale" in kind else \
            (1,) + leaf.shape[1:2] + (8,) + leaf.shape[3:]
        leaves.append(np.full(shape, 10 * layer + kinds.index(kind), leaf.dtype))
        names.append((layer, kind))
    assert [n[0] for n in names[::4]] == [0, 1, 10, 11, 2, 3, 4, 5, 6, 7, 8, 9]
    assert leaves[2].shape == (1, jcfg.num_kv_heads, 1, 8)
    pcfg = LlamaConfig.tiny(decode=True, ragged_decode=True, num_layers=12,
                            max_seq_len=32, kv_quant="int8")
    eng = ContinuousBatchingEngine(LlamaForCausalLM(pcfg, device="cpu"),
                                   max_slots=1, prompt_buckets=(4, 8, 16),
                                   prefill_chunk=8, prefix_cache_tokens=8)
    meta = {"kind": "prefix", "stage": 8, "tokens": list(range(8))}
    eng.install_prefix(*wire.unpack_kv(jax_wire.pack_kv(meta, leaves)))
    _, snap = eng._prefix_cache[np.arange(8, dtype=np.int32).tobytes()]
    for layer in range(12):
        for kind, t in zip(kinds, (snap.keys, snap.values, snap.key_scales,
                                   snap.value_scales)):
            assert (t[layer] == 10 * layer + kinds.index(kind)).all(), (layer, kind)
    exported = eng.export_prefix(eng.prefix_keys()[0])
    assert jax_wire.pack_kv(*exported) == jax_wire.pack_kv(meta, leaves)
    assert [tuple(t.shape) for t in jax_cache_leaves(snap)] == \
        [x.shape for x in leaves]
    eng.close()


# --- the front-end and the program ---------------------------------------


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _series(text: str, name: str) -> float:
    line = next(ln for ln in text.splitlines() if ln.startswith(name + " "))
    return float(line.split()[1])


def test_frontend_metrics_prefix_route_and_healthz(fx):
    """A front-end over an engine with both features, two requests over
    HTTP: /metrics carries the new gauges with the stats' values, GET
    /v1/prefix/<digest> a body both packages unpack (404 for a digest not
    held), /healthz the prefix length knob and the new counters."""
    eng = ContinuousBatchingEngine(fx.port, **ENGINE, prefix_cache_tokens=PREFIX,
                                   spec_decode_k=2)
    fe = ServingFrontend(eng, port=0)
    stop = threading.Event()
    pump = threading.Thread(target=fe.serve, args=(stop.is_set,))
    pump.start()
    try:
        prompts = [_rule_prompt(55, n) for n in (12, 11)]
        plain, _ = _serve(ContinuousBatchingEngine(fx.port, **ENGINE), prompts,
                          [6, 6])
        for p, want in zip(prompts, plain):
            req = urllib.request.Request(
                f"http://127.0.0.1:{fe.port}/v1/generate",
                data=json.dumps({"prompt": p.tolist(),
                                 "max_new_tokens": 6}).encode())
            with urllib.request.urlopen(req, timeout=60) as r:
                assert np.array_equal(json.loads(r.read())["tokens"], want)
        code, ctype, text = _get(fe.port, "/metrics")
        assert code == 200 and ctype.startswith("text/plain")
        text = text.decode()
        stats = eng.stats
        assert stats["prefix_hits"] == 1 and stats["spec_decode_rounds"] > 0
        for name, key in (("ktpu_serving_prefix_cache_bytes", "prefix_cache_bytes"),
                          ("ktpu_serving_spec_decode_rounds", "spec_decode_rounds"),
                          ("ktpu_serving_spec_decode_drafted", "spec_decode_drafted"),
                          ("ktpu_serving_spec_decode_accepted",
                           "spec_decode_accepted")):
            assert _series(text, name) == stats[key], name
        digest = eng.prefix_digest(_rule_prompt(55, 12))
        code, ctype, body = _get(fe.port, f"/v1/prefix/{digest}")
        assert code == 200 and ctype == "application/octet-stream"
        meta, leaves = wire.unpack_kv(body)
        jmeta, jleaves = jax_wire.unpack_kv(body)
        assert meta == jmeta and meta["tokens"] == _rule_prompt(55, PREFIX).tolist()
        assert len(leaves) == len(jleaves) == 2 * fx.cfg.num_layers
        assert _get(fe.port, "/v1/prefix/" + "0" * 64)[0] == 404
        code, _, health = _get(fe.port, "/healthz")
        health = json.loads(health)
        assert health["scheduler"]["prefix_cache_tokens"] == PREFIX
        assert health["stats"]["prefix_captures"] == 1
        assert _get(fe.port, "/v1/kv/x")[0] == 404  # the next slice's
    finally:
        stop.set()
        pump.join(timeout=60)
    assert not pump.is_alive()
    assert port_metrics.SERVING_PREFIX_CACHE_BYTES is not None


def test_program_flags_reach_the_engine(monkeypatch, capsys):
    from k8s_tpu_torch.programs import serving as prog

    monkeypatch.setenv("KTPU_PREEMPT_REQUESTED", "1")
    monkeypatch.setenv("KTPU_PREEMPT_AWARE", "0")
    monkeypatch.setenv("KTPU_SERVING_SPEC_DECODE", "3")
    prog.main(types.SimpleNamespace(
        program_args="--device=cpu --max_seq_len=64 --max_slots=2 "
                     "--host=127.0.0.1 --prefix_cache_tokens=16 "
                     "--prefix_cache_max=4"))
    ready = next(e for e in (json.loads(ln) for ln in
                             capsys.readouterr().out.splitlines()
                             if ln.startswith("{"))
                 if e.get("event") == "serving_ready")
    assert (ready["prefix_cache_tokens"], ready["prefix_cache_max"],
            ready["spec_decode_tokens"]) == (16, 4, 3)


@pytest.mark.parametrize("flag", ["--role=prefill", "--migration=1"])
def test_program_still_refuses_role_and_migration(flag):
    from k8s_tpu_torch.programs import serving as prog

    with pytest.raises(NotImplementedError, match="A15"):
        prog.main(types.SimpleNamespace(program_args=f"--device=cpu {flag}"))
