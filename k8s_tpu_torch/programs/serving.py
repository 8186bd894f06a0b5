"""Continuous-batching LLM serving as a workload (port of
``k8s_tpu/programs/serving.py``), on one device.

Run config (``KTPU_PROGRAM_ARGS``), the JAX program's keys:
  --model=tiny|llama3-8b    model size (default llama3-8b on cuda, tiny
                            on cpu: tiny's head_dim has no CUDA kernel)
  --checkpoint_dir=...      serve the trained weights of a persistent
                            (DCP) checkpoint of llama_train (empty or
                            missing: FileNotFoundError)
  --max_seq_len=N           KV-cache depth per slot (default 256)
  --max_slots=N             static decode batch width (default 8)
  --decode_chunk=N          decode steps per host fetch (default 32)
  --pipeline_depth=N        decode chunks in flight ahead of their
                            attribution (default 2; 1 waits for each)
  --chunked_prefill=0|1     token-budget chunked prefill (default 1)
  --prefill_chunk=N         max padded tokens per prefill chunk (256)
  --max_tokens_per_round=N  per-round token budget (default:
                            prefill_chunk + max_slots*decode_chunk)
  --prompt_buckets=a,b,c    static prefill lengths (default: powers of
                            two < max_seq_len starting at 16)
  --temperature=F           0 = greedy (default)
  --eos_id=N                stop token (default: none)
  --port=N                  HTTP port; 0 binds an ephemeral one (the
                            default, unless KTPU_SERVING_ADVERTISE names
                            one); printed in the serving_ready event
  --host=ADDR               bind address (default 0.0.0.0)
  --max_queue_depth=N       backpressure threshold for HTTP 429
                            (default KTPU_SERVING_MAX_QUEUE or 0 = off)
  --seed=N                  weight-init seed (default 0)
  --layers=N                layer count (default: the model's)
  --device=cuda|cpu         default: the rendezvous' ``device`` (cuda
                            unless KTPU_FORCE_PLATFORM=cpu); raises
                            without a card
  --quant=int8_serving      weight-only int8
  --kv_quant=int8           int8 KV cache
  --prefix_cache_tokens=N   shared-prefix KV reuse: cache the working-
                            cache KV of each distinct N-token prompt
                            prefix, skipping its re-prefill on repeat
                            (default KTPU_SERVING_PREFIX_TOKENS or 0)
  --prefix_cache_max=N      prefix LRU capacity (default 8)
  --spec_decode_tokens=K    self-speculative decode with up to K n-gram
                            drafts per round, temperature 0 only
                            (default KTPU_SERVING_SPEC_DECODE or 0)
On a card the engine replays its decode chunk as a CUDA graph after
the first (eager) chunk. The disaggregation role (``--role``,
KTPU_SERVING_ROLE) and live migration (``--migration``,
KTPU_SERVING_MIGRATION) raise when set: they come with A15's next slice.

Lifecycle events (JSON lines): ``serving_ready`` once the server
accepts traffic, ``serving_drained`` after a SIGTERM-triggered drain.
"""

from __future__ import annotations

import json
import os

from k8s_tpu_torch.programs.common import (
    mark_preempt_aware,
    parse_run_config,
    preempt_requested,
)
from k8s_tpu_torch.programs.llama_generate import (
    decode_model_config,
    default_model,
    load_decode_params,
)
from k8s_tpu_torch.serving import ContinuousBatchingEngine, ServingFrontend

# options of the JAX server this port does not have yet: (arg, env,
# value meaning "off")
_UNPORTED = (
    ("role", "KTPU_SERVING_ROLE", ""),
    ("migration", "KTPU_SERVING_MIGRATION", "0"),
)


def main(rdzv) -> None:
    cfg = parse_run_config(rdzv, {"steps": 0, "batch_size": 8})
    extra = cfg.extra or {}
    for key, env, off in _UNPORTED:
        val = extra.get(key, os.environ.get(env, off) if env else off)
        if val != off:
            raise NotImplementedError(
                f"{key}={val!r} is not ported to k8s_tpu_torch yet "
                "(ROADMAP A15: the disaggregation and migration slice)")
    device = extra.get("device", getattr(rdzv, "device", "cuda"))
    model_name = extra.get("model", default_model(device))
    max_seq = int(extra.get("max_seq_len", "256"))
    max_slots = int(extra.get("max_slots", "8"))
    decode_chunk = int(extra.get("decode_chunk", "32"))
    pipeline_depth = int(extra.get("pipeline_depth", "2"))
    chunked_prefill = bool(int(extra.get("chunked_prefill", "1")))
    prefill_chunk = int(extra.get("prefill_chunk", "256"))
    max_tokens_per_round = (int(extra["max_tokens_per_round"])
                            if "max_tokens_per_round" in extra else None)
    temperature = float(extra.get("temperature", "0"))
    eos_id = int(extra["eos_id"]) if "eos_id" in extra else None
    advertise = os.environ.get("KTPU_SERVING_ADVERTISE", "")
    adv_port = 0
    if advertise and ":" in advertise:
        try:
            adv_port = int(advertise.rsplit(":", 1)[1])
        except ValueError:
            adv_port = 0
    port = int(extra.get("port", str(adv_port)))
    max_queue_depth = int(extra.get(
        "max_queue_depth", os.environ.get("KTPU_SERVING_MAX_QUEUE", "0")))
    prefix_cache_tokens = int(extra.get(
        "prefix_cache_tokens",
        os.environ.get("KTPU_SERVING_PREFIX_TOKENS", "0")))
    prefix_cache_max = int(extra.get("prefix_cache_max", "8"))
    spec_decode_k = int(extra.get(
        "spec_decode_tokens", os.environ.get("KTPU_SERVING_SPEC_DECODE", "0")))
    host = extra.get("host", "0.0.0.0")
    if "prompt_buckets" in extra:
        buckets = [int(b) for b in extra["prompt_buckets"].split(",")]
    else:
        buckets = [b for b in (16, 32, 64, 128, 256, 512, 1024, 2048,
                               4096, 8192) if b < max_seq]
    if not buckets:
        raise ValueError(
            f"no prompt buckets fit max_seq_len={max_seq}: pass "
            "--prompt_buckets with at least one length < max_seq_len")

    quant = extra.get("quant", "")
    lcfg = decode_model_config(model_name, max_seq, extra, ragged=True)
    model = load_decode_params(lcfg, cfg.checkpoint_dir,
                               seed=int(extra.get("seed", "0")),
                               device=device, quant=quant)
    engine = ContinuousBatchingEngine(
        model, max_slots=max_slots, temperature=temperature, eos_id=eos_id,
        decode_chunk=decode_chunk, prompt_buckets=buckets,
        chunked_prefill=chunked_prefill, prefill_chunk=prefill_chunk,
        max_tokens_per_round=max_tokens_per_round,
        pipeline_depth=pipeline_depth,
        prefix_cache_tokens=prefix_cache_tokens,
        prefix_cache_max=prefix_cache_max, spec_decode_k=spec_decode_k)
    frontend = ServingFrontend(engine, host=host, port=port,
                               max_queue_depth=max_queue_depth)
    # use the SIGTERM grace period to drain instead of dying mid-request
    mark_preempt_aware()
    replica = os.environ.get("KTPU_SERVING_REPLICA", "")
    print(json.dumps({
        "event": "serving_ready", "port": frontend.port,
        "pid": os.getpid(),
        "replica": int(replica) if replica else None,
        "model": model_name, "device": str(model.device),
        "max_slots": max_slots, "decode_chunk": decode_chunk,
        "pipeline_depth": engine.pipeline_depth,
        "prompt_buckets": buckets, "chunked_prefill": chunked_prefill,
        "prefill_chunk": engine.prefill_chunk,
        "max_tokens_per_round": engine.max_tokens_per_round,
        "max_queue_depth": max_queue_depth,
        "prefix_cache_tokens": prefix_cache_tokens,
        "prefix_cache_max": engine.prefix_cache_max, "role": "",
        "spec_decode_tokens": engine.spec_decode_k,
        "quant": quant or "none", "kv_quant": lcfg.kv_quant,
        "restored": bool(cfg.checkpoint_dir),
    }), flush=True)
    frontend.serve(should_stop=preempt_requested)
    print(json.dumps({
        "event": "serving_drained", "served": frontend.served,
    }), flush=True)
