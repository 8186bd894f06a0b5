"""The port's pipelined pump (k8s_tpu_torch/serving/engine.py) on the
CPU, held to the JAX engine on the trained tiny fixture.

``pipeline_depth`` chunks stay in flight; harvester threads fetch the
packed arrays and attribution runs in dispatch order through the
slot→request snapshot taken at dispatch. Pipelining must not change a
token: the port at depths 1, 2 and 3 and the JAX engine at depth 2 give
every request the same tokens. The rest of the file injects what the
CPU does not do by itself: slow or failing fetches, out-of-order
harvests, slots refilled while a chunk is in flight, abandoned engines.
"""

import dataclasses
import gc
import itertools
import json
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from k8s_tpu.models import LlamaForCausalLM as JaxLlama
from k8s_tpu.serving import ContinuousBatchingEngine as JaxEngine
from k8s_tpu_torch.models import LlamaConfig, LlamaForCausalLM, params_from_jax
from k8s_tpu_torch.serving import ContinuousBatchingEngine
from k8s_tpu_torch.serving import engine as engine_mod

from llm_fixtures import trained_tiny

torch.set_num_threads(2)

MAX_SEQ = 64
BUCKETS = (4, 8, 16, 32)
# mixed lengths (one-shot and chunked prefill), budgets that end inside
# and on chunk boundaries, more requests than slots
LENS = [3, 8, 13, 30, 6, 21, 5]
NEW = [9, 1, 12, 10, 16, 7, 4]


def _rule_prompt(start: int, n: int) -> np.ndarray:
    """A prompt following the fixture's training rule: real logit
    margins, so bf16 rounding across frameworks decides no argmax."""
    steps = np.arange(n)
    return ((start * (steps + 1) * 3 + 7 * steps) % 512).astype(np.int32)


PROMPTS = [_rule_prompt(17 + 31 * i, n) for i, n in enumerate(LENS)]


@pytest.fixture(scope="module")
def fixture():
    cfg, params = trained_tiny()
    np_params = jax.tree_util.tree_map(np.asarray, params)
    pcfg = LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_layers=cfg.num_layers,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, max_seq_len=MAX_SEQ,
        rope_theta=cfg.rope_theta, rms_eps=cfg.rms_eps,
        dtype=torch.bfloat16, decode=True, ragged_decode=True)
    model = LlamaForCausalLM(pcfg, device="cpu")
    model.load_params(params_from_jax(np_params))
    j_ragged = JaxLlama(dataclasses.replace(
        cfg, decode=True, ragged_decode=True, max_seq_len=MAX_SEQ))
    jeng = JaxEngine(j_ragged, params, max_slots=2, decode_chunk=4,
                     prompt_buckets=BUCKETS, prefill_chunk=8,
                     pipeline_depth=2)
    try:
        jrids = [jeng.submit(p, n) for p, n in zip(PROMPTS, NEW)]
        jout = jeng.run()
    finally:
        jeng.close()
    return model, [jout[r] for r in jrids]


def _engine(model, **kw):
    base = dict(max_slots=2, decode_chunk=4, prompt_buckets=BUCKETS,
                prefill_chunk=8)
    base.update(kw)
    return ContinuousBatchingEngine(model, **base)


def _serve(eng, prompts=PROMPTS, new=NEW):
    rids = [eng.submit(p, n) for p, n in zip(prompts, new)]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_tokens_match_across_depths_and_the_jax_engine(fixture, depth):
    """Every request's greedy tokens at pipeline_depth 1, 2 and 3 equal
    the JAX engine's at pipeline_depth 2 (so depth 1's equal depth
    2's), with the harvesters' reorder buffer drained at the end."""
    model, want = fixture
    eng = _engine(model, pipeline_depth=depth)
    try:
        got = _serve(eng)
        assert eng.pipeline_depth == depth
        assert eng._unattributed == 0 and not eng._ready_held
        assert eng.stats["chunks"] == eng._seq == eng._attr_seq
        assert eng.stats["graph_replays"] == eng.stats["graph_captures"] == 0
    finally:
        eng.close()
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), (i, g, w)


def test_default_depth_is_two_and_depth_is_clamped(fixture):
    model = fixture[0]
    for kw, depth in (({}, 2), ({"pipeline_depth": 0}, 1),
                      ({"pipeline_depth": -3}, 1)):
        eng = _engine(model, **kw)
        assert eng.pipeline_depth == depth
        eng.close()


def _slow_fetch(monkeypatch, delays):
    """Make every harvester fetch sleep ``delays(i)`` seconds, i the
    fetch's call index; returns the call indices in completion order."""
    done, counter, lock = [], itertools.count(), threading.Lock()
    real = engine_mod._HostCopy.fetch

    def fetch(self):
        with lock:
            i = next(counter)
        time.sleep(delays(i))
        out = real(self)
        with lock:
            done.append(i)
        return out

    monkeypatch.setattr(engine_mod._HostCopy, "fetch", fetch)
    return done


def test_refilled_slot_is_attributed_through_the_dispatch_snapshot(
        fixture, monkeypatch):
    """One slot, depth 2, slow fetches: a chunk is dispatched while the
    request it ends is still unattributed, the slot is refilled before
    that chunk is attributed, and its results go by the snapshot (the
    finished request, skipped) — not to the slot's new occupant, which
    the chunk's inactive row would otherwise end with no tokens."""
    model, want = fixture
    _slow_fetch(monkeypatch, lambda i: 0.2)
    eng = _engine(model, max_slots=1, pipeline_depth=2)
    stale = []
    real = eng._next_ready

    def spy(block):
        item = real(block)
        if item is not None:
            now = [r.rid if r is not None else None for r in eng._slot_req]
            stale.extend(s for s, n in zip(item[2], now)
                         if None not in (s, n) and s != n)
        return item

    eng._next_ready = spy
    try:
        got = _serve(eng)
    finally:
        eng.close()
    assert stale, "no slot was refilled between dispatch and attribution"
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), (i, g, w)


def test_out_of_order_harvests_attribute_in_dispatch_order(
        fixture, monkeypatch):
    """The first fetch sleeps while later ones return at once, so a
    later chunk is harvested first; attribution still runs in dispatch
    order (the reorder buffer holds the early arrival) and no token
    moves."""
    model, want = fixture
    done = _slow_fetch(monkeypatch, lambda i: 1.0 if i == 0 else 0.0)
    eng = _engine(model, pipeline_depth=2)
    order, held = [], []
    real = eng._next_ready

    def spy(block):
        item = real(block)
        if item is not None:
            order.append(eng._attr_seq - 1)
            held.append(len(eng._ready_held))
        return item

    eng._next_ready = spy
    try:
        got = _serve(eng)
    finally:
        eng.close()
    assert done.index(0) > 0, f"fetch 0 finished first: {done}"
    assert max(held) > 0  # an early arrival waited in the buffer
    assert order == list(range(len(order)))
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), (i, g, w)


def test_failed_fetch_raises_from_step_without_hanging(fixture, monkeypatch):
    """A fetch that raises (as a CUDA error surfaces at the wait) reaches
    the pump as an error item: step() raises RuntimeError naming the
    chunk, chained to the cause, instead of waiting forever."""
    model = fixture[0]
    real = engine_mod._HostCopy.fetch
    calls = itertools.count()

    def fetch(self):
        if next(calls) >= 1:
            raise ValueError("device fault")
        return real(self)

    monkeypatch.setattr(engine_mod._HostCopy, "fetch", fetch)
    eng = _engine(model, pipeline_depth=2)
    caught = []

    def pump():
        try:
            _serve(eng)
        except RuntimeError as e:
            caught.append(e)

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    t.join(timeout=60)
    eng.close()
    assert not t.is_alive(), "the pump hung on a failed fetch"
    assert len(caught) == 1
    assert "failed on device" in str(caught[0])
    assert isinstance(caught[0].__cause__, ValueError)
    assert all(not h.is_alive() for h in eng._harvesters)


def test_close_joins_harvesters_and_abandoned_engines_stop_theirs(fixture):
    """close() stops and joins every harvester; an engine dropped
    without close() is collectible (the threads hold only its queues)
    and its threads exit."""
    model, want = fixture
    eng = _engine(model)
    assert all(h.is_alive() for h in eng._harvesters)
    got = _serve(eng, PROMPTS[:2], NEW[:2])
    eng.close()
    assert all(not h.is_alive() for h in eng._harvesters)
    assert np.array_equal(got[0], want[0])

    eng = _engine(model)
    _serve(eng, PROMPTS[:1], NEW[:1])
    threads = list(eng._harvesters)
    del eng
    gc.collect()
    for h in threads:
        h.join(timeout=10)
    assert all(not h.is_alive() for h in threads)


def test_token_times_one_entry_per_attribution_that_delivers(fixture):
    """token_times holds (time, n) for each chunk attribution that gave
    the request tokens: with 4-step chunks a 9-token request gets its
    prefill token and 4 from the first chunk, then 4; a 3-token one all
    3 at once. The optimistic extra chunk (depth 2) adds no entry."""
    model, want = fixture
    eng = _engine(model, pipeline_depth=2)
    try:
        rids = [eng.submit(PROMPTS[0], 9), eng.submit(PROMPTS[4], 3)]
        while eng.step():
            pass
        done = eng.pop_finished()
    finally:
        eng.close()
    long, short = done[rids[0]], done[rids[1]]
    assert [n for _, n in long.token_times] == [5, 4]
    assert [n for _, n in short.token_times] == [3]
    for r in (long, short):
        times = [t for t, _ in r.token_times]
        assert times == sorted(times)
        assert r.first_token_at == times[0] and r.finished_at >= times[-1]
        assert sum(n for _, n in r.token_times) == len(r.tokens)
    assert np.array_equal(long.tokens, want[0])


@pytest.mark.parametrize("depth", [1, 2])
def test_program_main_cpu_pipeline_depth(monkeypatch, capsys, depth):
    """programs.serving.main --pipeline_depth=N --device=cpu: the engine
    takes the depth, serving_ready reports it, and the server drains."""
    from k8s_tpu_torch.programs import serving as prog

    monkeypatch.setenv("KTPU_PREEMPT_REQUESTED", "1")
    monkeypatch.setenv("KTPU_PREEMPT_AWARE", "0")
    prog.main(types.SimpleNamespace(
        program_args=f"--device=cpu --max_seq_len=64 --max_slots=2 "
                     f"--host=127.0.0.1 --pipeline_depth={depth}"))
    events = [json.loads(line)
              for line in capsys.readouterr().out.splitlines()
              if line.startswith("{")]
    ready = next(e for e in events if e.get("event") == "serving_ready")
    assert ready["pipeline_depth"] == depth and ready["device"] == "cpu"
    assert any(e.get("event") == "serving_drained" for e in events)
