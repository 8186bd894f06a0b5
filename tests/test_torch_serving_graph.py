"""The serving engine's compiled decode chunk: one CUDA graph per engine.

On a card the engine's first chunk runs eagerly, the second captures
the chunk as a ``torch.cuda.CUDAGraph`` over the engine's fixed state
and cache tensors, and every later chunk replays it. Tests marked
``gpu`` hold a replayed chunk to an eager one from a clone of the same
state, bit for bit (packed output, state, cache rows and int8 scales),
and a replayed speculative-decode verify forward to an eager one, check
that replays at temperature > 0 draw fresh tokens and that a failed
capture raises with no eager fallback; without a card they skip.
The rest runs here: the CPU engine never captures, its packed copy and
the harvester's error path.

This file imports no JAX, so it runs on a card machine too:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serving_graph.py -q
"""

import queue

import numpy as np
import pytest
import torch

from chip_smoke import fill_engine_state, graph_draws_fresh, graph_vs_eager
from k8s_tpu_torch.models import LlamaConfig
from k8s_tpu_torch.programs.llama_generate import load_decode_params
from k8s_tpu_torch.serving import ContinuousBatchingEngine
from k8s_tpu_torch.serving import engine as engine_mod

# the smallest config the kernels serve: head_dim 128, 4 q heads per kv head
SMALL = dict(vocab_size=512, hidden_size=512, intermediate_size=1024,
             num_layers=2, num_heads=8, num_kv_heads=2, head_dim=128,
             max_seq_len=512, decode=True, ragged_decode=True)
DEPTHS = [5, 130, 300, 477]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph and the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(device, q8: bool):
    cfg = LlamaConfig(**SMALL, kv_quant="int8" if q8 else "none")
    return load_decode_params(cfg, "", seed=0, device=device,
                              quant="int8_serving" if q8 else "")


def _cpu_engine(**kw):
    cfg = LlamaConfig.tiny(max_seq_len=64, dtype=torch.bfloat16, decode=True,
                           ragged_decode=True)
    model = load_decode_params(cfg, "", seed=0, device="cpu")
    return ContinuousBatchingEngine(model, max_slots=2, decode_chunk=4,
                                    prompt_buckets=(8, 16), **kw)


def test_cpu_engine_runs_every_chunk_eagerly():
    """The CPU has no graph: no capture, no replay, no pinned buffers,
    and every chunk still reaches the host through the harvesters."""
    eng = _cpu_engine()
    try:
        rids = [eng.submit(np.arange(1, 6, dtype=np.int32), 9),
                eng.submit(np.arange(7, 10, dtype=np.int32), 3)]
        out = eng.run()
    finally:
        eng.close()
    assert [len(out[r]) for r in rids] == [9, 3]
    assert eng._graph is None and not eng._warmed and not eng._host_bufs
    assert eng.stats["graph_captures"] == eng.stats["graph_replays"] == 0
    assert eng.stats["chunks"] >= 3 and eng.graph_launches is None


def test_cpu_host_copy_is_a_snapshot():
    """On the CPU the copy is a clone: a later write into the packed
    tensor (as the graph's next replay would make) does not reach it."""
    packed = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    handle = engine_mod._HostCopy(packed)
    packed.zero_()
    got = handle.fetch()
    assert isinstance(got, np.ndarray)
    assert np.array_equal(got, np.arange(12).reshape(3, 4))


def test_harvest_loop_ships_errors_and_stops_on_none():
    """A harvester turns a failing fetch into an error item (the pump
    re-raises it) and keeps serving; None stops it."""

    class Bad:
        def fetch(self):
            raise OSError("lost")

    class Good:
        def fetch(self):
            return np.ones(2)

    fetchq, readyq = queue.Queue(), queue.Queue()
    for i, h in enumerate((Bad(), Good())):
        fetchq.put((i, h, {}, [None], 0.0))
    fetchq.put(None)
    engine_mod._harvest_loop(fetchq, readyq)  # returns at the None
    first, second = readyq.get_nowait(), readyq.get_nowait()
    assert first[0] == 0 and isinstance(first[1], OSError)
    assert second[0] == 1 and np.array_equal(second[1], np.ones(2))


@pytest.mark.gpu
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
def test_replayed_chunk_is_bit_equal_to_an_eager_chunk(cuda, q8):
    """From the same state and cache, one replay of the engine's graph
    and one eager chunk give the same packed array, state, cache rows
    and (int8) scales, bit for bit; the capture recorded the decode
    kernel's launches (2 layers x 4 steps)."""
    model = _model(cuda, q8)
    eng = ContinuousBatchingEngine(model, max_slots=len(DEPTHS), decode_chunk=4)
    try:
        fill_engine_state(torch, eng, DEPTHS, seed=1)
        diff = graph_vs_eager(torch, eng)
        assert not any(diff.values()), diff
        name, other = ("decode_attn_q8", "decode_attn") if q8 else \
            ("decode_attn", "decode_attn_q8")
        assert eng.graph_launches[name] == 2 * 4
        assert eng.graph_launches[other] == 0
        assert eng.stats["graph_captures"] == 1
    finally:
        eng.close()


@pytest.mark.gpu
def test_sampling_replays_draw_fresh_tokens(cuda):
    """At temperature 1 two replays from the same state draw different
    tokens: the graph advances the engine's generator."""
    eng = ContinuousBatchingEngine(_model(cuda, False), max_slots=len(DEPTHS),
                                   decode_chunk=4, temperature=1.0, seed=2)
    try:
        fill_engine_state(torch, eng, DEPTHS, seed=1)
        assert graph_draws_fresh(torch, eng) > 0
    finally:
        eng.close()


@pytest.mark.gpu
def test_failed_capture_raises_without_eager_fallback(cuda, monkeypatch):
    """A chunk that syncs the host cannot be captured: step() raises,
    the engine holds no graph and runs no eager chunk in its place."""
    eng = ContinuousBatchingEngine(_model(cuda, False), max_slots=2, decode_chunk=4,
                                   prompt_buckets=(16, 32))
    real = ContinuousBatchingEngine._decode_state
    calls = []

    def syncing(self):
        calls.append(torch.cuda.is_current_stream_capturing())
        packed = real(self)
        packed.sum().item()  # a host read: illegal while capturing
        return packed

    monkeypatch.setattr(ContinuousBatchingEngine, "_decode_state", syncing)
    stream = torch.cuda.current_stream()
    try:
        eng.submit(np.arange(1, 10, dtype=np.int32), 40)
        with pytest.raises(RuntimeError):
            for _ in range(10):
                eng.step()
        assert eng._graph is None and eng.stats["graph_replays"] == 0
        assert calls == [False, True]  # the eager first chunk, the capture
        assert torch.cuda.current_stream() == stream  # not left on the capture's
    finally:
        monkeypatch.undo()
        torch.cuda.synchronize()
        eng.close()


@pytest.mark.gpu
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
def test_replayed_verify_is_bit_equal_to_an_eager_verify(cuda, q8):
    """Self-speculative decode's verify forward: the engine's first round
    runs eagerly, the second captures it and replays. From the same
    cache, a replay and an eager forward over the same drafts give the
    same greedy tokens and the same written cache rows (and int8
    scales), bit for bit."""
    from k8s_tpu_torch.serving.engine import _verify_chunk

    eng = ContinuousBatchingEngine(_model(cuda, q8), max_slots=len(DEPTHS),
                                   decode_chunk=4, spec_decode_k=3)
    try:
        fill_engine_state(torch, eng, DEPTHS, seed=3)
        rng = np.random.RandomState(0)
        x = rng.randint(0, SMALL["vocab_size"], size=(len(DEPTHS), 4)).astype(np.int64)
        pos = (np.asarray(DEPTHS, np.int64)[:, None] + np.arange(4)).astype(np.int64)
        eng._verify(x, pos)  # the eager first round
        assert eng._vgraph is None
        x2 = rng.randint(0, SMALL["vocab_size"], size=x.shape).astype(np.int64)
        ref = eng._cache.clone()
        want = _verify_chunk(eng.model, ref, torch.from_numpy(x2).to(cuda),
                             torch.from_numpy(pos).to(cuda)).cpu().numpy()
        got = eng._verify(x2, pos)  # the capture, then its first replay
        assert eng._vgraph is not None
        assert np.array_equal(got, want)
        for a, b in zip(eng._cache._tensors(), ref._tensors()):
            assert torch.equal(a, b)
    finally:
        eng.close()
