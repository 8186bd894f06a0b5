"""Llama autoregressive generation as a workload (port of
``k8s_tpu/programs/llama_generate.py``), on one device.

Run config (``KTPU_PROGRAM_ARGS``):
  --model=tiny|llama3-8b   model size (default llama3-8b on cuda, tiny
                           on cpu: tiny's head_dim has no CUDA kernel)
  --batch_size=N           prompts per round (default 8)
  --prompt_len=N           synthetic prompt length (default 32)
  --new_tokens=N           tokens to decode per round (default 64)
  --temperature=F          0 = greedy (default)
  --steps=N                generation rounds (default 3)
  --seed=N                 weight-init seed (default 0)
  --device=cuda|cpu        default: the rendezvous' ``device`` (cuda
                           unless KTPU_FORCE_PLATFORM=cpu); raises
                           without a card
  --quant=int8_serving     weight-only int8 (projections, MLP, lm_head)
  --kv_quant=int8          int8 KV cache with per-row scales

Weights are random from ``--seed`` and cast to bf16 (then quantized with
``--quant=int8_serving``); restoring a checkpoint comes in a later
slice, so a non-empty ``checkpoint_dir`` raises. Prints one JSON line
per round with tokens/sec.
"""

from __future__ import annotations

import dataclasses
import json
import time

import torch

from k8s_tpu_torch import resolve_device
from k8s_tpu_torch.models import LlamaConfig, LlamaForCausalLM, generate
from k8s_tpu_torch.models.convert import init_params
from k8s_tpu_torch.ops.quant import quantize_params_for_serving
from k8s_tpu_torch.programs.common import parse_run_config


def default_model(device: str) -> str:
    """The model a program serves when ``--model`` is not given: tiny on
    the CPU, Llama-3-8B on the card (the CUDA kernels are built for its
    head layout and refuse tiny's)."""
    return "tiny" if torch.device(device).type == "cpu" else "llama3-8b"


def decode_model_config(model_name: str, max_seq: int, extra: dict,
                        ragged: bool = False) -> LlamaConfig:
    """Decode-mode (``decode=True``) LlamaConfig from program args —
    shared between batch generation (this program) and the
    continuous-batching server.
    ``ragged=True`` enables per-row cache depths (the engine's slot
    contract); ``--kv_quant`` picks the cache (``none`` bf16, ``int8``).
    The port serves the unrolled layout."""
    common = dict(ragged_decode=ragged, decode=True,
                  kv_quant=extra.get("kv_quant", "none"))
    if model_name == "llama3-8b":
        return LlamaConfig.llama3_8b(max_seq_len=max_seq, **common)
    # the JAX package's tiny serving layout (llama_train's head layout)
    return LlamaConfig.tiny(max_seq_len=max(max_seq, 128), num_heads=8,
                            num_kv_heads=4, head_dim=16, **common)


def load_decode_params(lcfg: LlamaConfig, checkpoint_dir: str = "",
                       seed: int = 0, device="cuda",
                       quant: str = "") -> LlamaForCausalLM:
    """A decode model on ONE device with random weights from ``seed``,
    every f32 parameter cast to bf16 (decode re-reads every weight each
    step, so f32 masters would double its bandwidth-bound time). With
    ``quant="int8_serving"`` the model is built in that layout and each
    projection is quantized where it lies, one tensor at a time, so an
    8B load peaks near the bf16 weights plus one f32 tensor."""
    if checkpoint_dir:
        raise NotImplementedError(
            f"checkpoint_dir={checkpoint_dir!r}: checkpoint restore is not "
            "ported yet; serve random weights with an empty checkpoint_dir")
    if quant not in ("", "none", "int8_serving"):
        raise ValueError(f"unknown quant {quant!r}; expected "
                         "'int8_serving' or none")
    dev = resolve_device(device)
    params = init_params(lcfg, seed, dev, dtype=torch.bfloat16)
    if quant == "int8_serving":
        lcfg = dataclasses.replace(lcfg, quant="int8_serving")
        for name in list(params):  # each bf16 weight freed as it goes
            params.update(quantize_params_for_serving({name: params.pop(name)}))
    model = LlamaForCausalLM(lcfg, device=dev)
    model.load_params(params)
    return model


def main(rdzv) -> None:
    cfg = parse_run_config(rdzv, {"steps": 3, "batch_size": 8})
    extra = cfg.extra or {}
    device = extra.get("device", getattr(rdzv, "device", "cuda"))
    model_name = extra.get("model", default_model(device))
    prompt_len = int(extra.get("prompt_len", "32"))
    new_tokens = int(extra.get("new_tokens", "64"))
    temperature = float(extra.get("temperature", "0"))
    lcfg = decode_model_config(model_name, prompt_len + new_tokens, extra)
    model = load_decode_params(
        lcfg, cfg.checkpoint_dir, seed=int(extra.get("seed", "0")),
        device=device, quant=extra.get("quant", ""))
    gen = torch.Generator(device=model.device)
    gen.manual_seed(1)
    prompt = torch.randint(0, lcfg.vocab_size, (cfg.batch_size, prompt_len),
                           generator=gen, device=model.device)
    # warm round (allocator, kernel build); timing starts after it
    generate(model, prompt, new_tokens, temperature=temperature,
             generator=gen)
    for step in range(1, cfg.steps + 1):
        t0 = time.perf_counter()
        toks = generate(model, prompt, new_tokens, temperature=temperature,
                        generator=gen)
        int(toks[0, -1])  # host readback: waits for the device
        dt = time.perf_counter() - t0
        print(json.dumps({
            "run": f"llama-generate-{model_name}", "step": step,
            "device": str(model.device),
            "tokens_per_sec": round(cfg.batch_size * new_tokens / dt, 1),
        }), flush=True)
