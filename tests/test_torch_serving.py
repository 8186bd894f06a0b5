"""PyTorch port of the serving path (k8s_tpu_torch/serving), held to the
JAX package on the trained tiny fixture.

Greedy tokens of every request served by the port's continuous-batching
engine — single-chunk and multi-chunk prompts, EOS and budget ends, more
requests than slots — must be IDENTICAL to the JAX package's solo
``generate`` and to the JAX engine on the same weights. Trained weights
have real logit margins, so bf16 rounding differences between the two
frameworks do not flip argmaxes (random-init logits are near-ties).
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

from k8s_tpu.models import LlamaForCausalLM as JaxLlama, generate as jax_generate
from k8s_tpu.serving import ContinuousBatchingEngine as JaxEngine
from k8s_tpu_torch.models import LlamaConfig, LlamaForCausalLM, params_from_jax
from k8s_tpu_torch.serving import ContinuousBatchingEngine, ServingFrontend

from llm_fixtures import trained_tiny

torch.set_num_threads(2)

MAX_SEQ = 64
BUCKETS = (4, 8, 16, 32)


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
    j_oracle = JaxLlama(dataclasses.replace(cfg, decode=True,
                                            max_seq_len=MAX_SEQ))
    j_ragged = JaxLlama(dataclasses.replace(
        cfg, decode=True, ragged_decode=True, max_seq_len=MAX_SEQ))
    return model, j_oracle, j_ragged, params


def _rule_prompt(start: int, n: int) -> np.ndarray:
    """A prompt following the fixture's training rule (llm_fixtures), so
    every greedy step has a real logit margin: cross-framework bf16
    rounding (~1e-2) must not decide an argmax. Random token prompts
    are off-distribution and can sit on near-ties."""
    steps = np.arange(n)
    return ((start * (steps + 1) * 3 + 7 * steps) % 512).astype(np.int32)


def _jax_solo(j_oracle, params, prompt, n):
    return np.asarray(jax_generate(j_oracle, params,
                                   jnp.asarray(prompt)[None], n))[0]


def test_engine_tokens_match_jax_generate_and_jax_engine(fixture):
    """Mixed lengths over 2 slots with prefill_chunk=8: prompts <= 8
    take the one-shot flash insert, longer ones the staged chunked path
    (crossing working-cache stages); one request ends on its 1-token
    budget and the EOS id cuts others short."""
    model, j_oracle, j_ragged, params = fixture
    lens = [3, 8, 13, 30, 6, 21]
    new = [9, 1, 12, 10, 16, 7]
    prompts = [_rule_prompt(17 + 31 * i, n) for i, n in enumerate(lens)]
    solo = [_jax_solo(j_oracle, params, p, n) for p, n in zip(prompts, new)]
    # an EOS id that first appears mid-stream in request 4's output
    eos = next(int(t) for i, t in enumerate(solo[4])
               if i >= 2 and t not in solo[4][:i])
    want = [r[:list(r).index(eos) + 1] if eos in r else r for r in solo]

    eng = ContinuousBatchingEngine(
        model, max_slots=2, decode_chunk=4, prompt_buckets=BUCKETS,
        prefill_chunk=8, eos_id=eos)
    rids = [eng.submit(p, n) for p, n in zip(prompts, new)]
    out = eng.run()
    for i, rid in enumerate(rids):
        assert np.array_equal(out[rid], want[i]), (i, out[rid], want[i])
    assert eng.stats["prefills"] == len(prompts)
    assert eng.stats["prefill_chunks"] > len(prompts)  # chunked path ran

    jeng = JaxEngine(j_ragged, params, max_slots=2, decode_chunk=4,
                     prompt_buckets=BUCKETS, prefill_chunk=8, eos_id=eos)
    try:
        jrids = [jeng.submit(p, n) for p, n in zip(prompts, new)]
        jout = jeng.run()
    finally:
        jeng.close()
    for rid, jrid in zip(rids, jrids):
        assert np.array_equal(out[rid], jout[jrid]), (out[rid], jout[jrid])


def test_legacy_one_shot_engine_and_validation(fixture):
    """chunked_prefill=False prefills whole prompts one-shot (largest
    bucket caps the prompt); intake validation matches the JAX engine."""
    model, j_oracle, _, params = fixture
    eng = ContinuousBatchingEngine(model, max_slots=2, decode_chunk=3,
                                   prompt_buckets=BUCKETS,
                                   chunked_prefill=False)
    prompts = [_rule_prompt(5, 3), _rule_prompt(40, 17), _rule_prompt(9, 1)]
    rids = [eng.submit(p, 5) for p in prompts]
    out = eng.run()
    for rid, p in zip(rids, prompts):
        assert np.array_equal(out[rid], _jax_solo(j_oracle, params, p, 5))
    with pytest.raises(ValueError, match="empty"):
        eng.submit(np.zeros(0, np.int32), 4)
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit(np.zeros(8, np.int32), MAX_SEQ)
    with pytest.raises(ValueError, match="largest bucket"):
        eng.submit(np.zeros(33, np.int32), 4)
    with pytest.raises(ValueError, match="token ids"):
        eng.submit(np.array([512], np.int32), 4)
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(np.array([3], np.int32), 1)
    with pytest.raises(RuntimeError, match="closed"):
        eng.step()


def _post(port, payload, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_frontend_http_generate_healthz_and_drain(fixture):
    """Concurrent HTTP clients against a ServingFrontend on port 0:
    oracle tokens with per-request timing, /healthz reflecting the
    served work, 400 on a malformed body, /metrics served, 404 on
    unported routes, and a drain that closes the engine."""
    model, j_oracle, _, params = fixture
    eng = ContinuousBatchingEngine(model, max_slots=2, decode_chunk=4,
                                   prompt_buckets=BUCKETS, prefill_chunk=8)
    fe = ServingFrontend(eng, port=0)
    stop = threading.Event()
    pump = threading.Thread(target=fe.serve, args=(stop.is_set,))
    pump.start()
    try:
        prompts = [_rule_prompt(s, n) for s, n in ((3, 4), (77, 12), (200, 7))]
        results = [None] * 3

        def client(i):
            results[i] = _post(fe.port, {
                "prompt": [int(t) for t in prompts[i]],
                "max_new_tokens": 6})

        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
            assert not c.is_alive()
        for i, (code, body) in enumerate(results):
            assert code == 200, body
            assert np.array_equal(np.asarray(body["tokens"], np.int32),
                                  _jax_solo(j_oracle, params, prompts[i], 6))
            assert body["ttft_s"] >= 0 and body["itl_ms"] >= 0
            assert body["trace_id"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{fe.port}/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["served"] == 3, health
        assert health["stats"]["prefills"] == 3
        code, _ = _post(fe.port, {"prompt": "nope"})
        assert code == 400
        with urllib.request.urlopen(
                f"http://127.0.0.1:{fe.port}/metrics", timeout=10) as r:
            assert r.status == 200
            assert b"ktpu_serving_prefix_cache_bytes 0" in r.read()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(
                f"http://127.0.0.1:{fe.port}/v1/kv/x", timeout=10)
        assert e.value.code == 404
    finally:
        stop.set()
        pump.join(timeout=60)
    assert not pump.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(np.array([3], np.int32), 1)


def test_frontend_backpressure_429(fixture):
    """max_queue_depth: a request arriving with the queue at the
    threshold is refused at once with 429 + Retry-After."""
    model = fixture[0]
    eng = ContinuousBatchingEngine(model, max_slots=1, decode_chunk=2,
                                   prompt_buckets=BUCKETS)
    fe = ServingFrontend(eng, port=0, max_queue_depth=1, retry_after_s=2)
    fe._http_thread.start()
    try:
        eng.submit(np.array([1, 2], np.int32), 2)  # queue depth 1, no pump
        req = urllib.request.Request(
            f"http://127.0.0.1:{fe.port}/v1/generate",
            data=json.dumps({"prompt": [3], "max_new_tokens": 1}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 429
        assert e.value.headers["Retry-After"] == "2"
        assert fe.rejected == 1
    finally:
        fe.drain()


def test_program_main_cpu_emits_ready_and_drains(monkeypatch, capsys,
                                                 tmp_path):
    """programs.serving.main with --device=cpu: builds the tiny model,
    prints serving_ready, and (preemption already requested) drains."""
    from k8s_tpu_torch.programs import serving as prog

    monkeypatch.setenv("KTPU_PREEMPT_REQUESTED", "1")
    monkeypatch.setenv("KTPU_PREEMPT_AWARE", "0")
    for flags, quant, kv_quant in (
            ("", "none", "none"),
            ("--quant=int8_serving --kv_quant=int8", "int8_serving", "int8")):
        rdzv = types.SimpleNamespace(
            program_args="--device=cpu --max_seq_len=64 --max_slots=2 "
                         f"--host=127.0.0.1 {flags}")
        prog.main(rdzv)
        events = [json.loads(line)
                  for line in capsys.readouterr().out.splitlines()
                  if line.startswith("{")]
        ready = next(e for e in events if e.get("event") == "serving_ready")
        assert ready["port"] > 0 and ready["device"] == "cpu"
        assert ready["prompt_buckets"] == [16, 32]
        assert (ready["quant"], ready["kv_quant"]) == (quant, kv_quant)
        assert any(e.get("event") == "serving_drained" for e in events)
    # a checkpoint dir with no committed step: the server must fail, not
    # serve random weights
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        prog.main(types.SimpleNamespace(
            program_args=f"--device=cpu --checkpoint_dir={tmp_path}"))


def test_llama_generate_main_cpu(capsys):
    """programs.llama_generate.main with --device=cpu: random tiny
    weights, one JSON line per generation round — bf16, and with int8
    weights and an int8 KV cache."""
    from k8s_tpu_torch.programs import llama_generate as prog

    for flags in ("", "--kv_quant=int8 --quant=int8_serving"):
        prog.main(types.SimpleNamespace(
            program_args="--device=cpu --batch_size=2 --prompt_len=5 "
                         f"--new_tokens=3 --steps=2 {flags}"))
        lines = [json.loads(line)
                 for line in capsys.readouterr().out.splitlines()
                 if line.startswith("{")]
        assert [ln["step"] for ln in lines] == [1, 2]
        assert all(ln["tokens_per_sec"] > 0 and ln["device"] == "cpu"
                   for ln in lines)
    with pytest.raises(ValueError, match="kv_quant"):
        prog.main(types.SimpleNamespace(
            program_args="--device=cpu --kv_quant=fp8"))
    with pytest.raises(ValueError, match="unknown quant"):
        prog.main(types.SimpleNamespace(
            program_args="--device=cpu --quant=int8"))
