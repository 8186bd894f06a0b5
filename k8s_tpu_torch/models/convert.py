"""Weights for the port's Llama: conversion from a flax param tree, and
random initialization from a seed.

Both return a ``{name: tensor}`` dict keyed like
``LlamaForCausalLM.named_parameters()``, for
:meth:`~k8s_tpu_torch.models.llama.LlamaForCausalLM.load_params`.
Projection weights keep the JAX package's ``[in, out]`` orientation,
with DenseGeneral's head axes flattened: q/k/v ``[E, H, D] -> [E, H*D]``,
o_proj ``[H, D, E] -> [H*D, E]``, MLP ``[E, F]``/``[F, E]`` and the
lm_head ``[E, V]`` as they are. An int8 serving tree's ``{kernel_q,
scale}`` pairs become ``<name>.kernel_q`` (flattened alike) and
``<name>.scale`` (flattened to ``[out]``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping

import numpy as np
import torch

from k8s_tpu_torch import resolve_device
from k8s_tpu_torch.models.llama import LlamaConfig


def _to_torch(x) -> torch.Tensor:
    """numpy (or array-like) -> a CPU tensor owning its memory; bfloat16
    arrays (numpy's ml_dtypes extension type) keep their bits."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _layer_trees(tree: Mapping) -> List[Mapping]:
    """Per-layer subtrees of a scanned (``layers/block/...``, layer axis
    0) or unrolled (``layer_{i}``) flax param tree."""
    if "layers" in tree:
        block = tree["layers"]["block"]

        def index(sub, i):
            if isinstance(sub, Mapping):
                return {k: index(v, i) for k, v in sub.items()}
            return np.asarray(sub)[i]

        n = np.asarray(block["input_norm"]["weight"]).shape[0]
        return [index(block, i) for i in range(n)]
    n = sum(1 for k in tree if k.startswith("layer_"))
    return [tree[f"layer_{i}"] for i in range(n)]


def _dense(name: str, sub: Mapping, n_in: int) -> Dict[str, torch.Tensor]:
    """One projection's weights under the port's ``name``: a bf16/f32
    ``kernel`` flattened to ``[in, out]`` over its first ``n_in`` axes,
    or an int8 serving subtree (``quantize_params_for_serving``) as
    ``<name>.kernel_q`` flattened alike and ``<name>.scale`` flattened to
    ``[out]``."""
    def flat(w):
        return w.reshape(math.prod(w.shape[:n_in]), -1)

    if "kernel_q" in sub:
        return {name + ".kernel_q": flat(_to_torch(sub["kernel_q"])),
                name + ".scale": _to_torch(sub["scale"]).reshape(-1)}
    return {name: flat(_to_torch(sub["kernel"]))}


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``LlamaForCausalLM`` param tree of numpy arrays (unboxed,
    scanned or unrolled, bf16/f32 or the ``quant="int8_serving"`` layout)
    -> the port's weight dict, dtypes unchanged."""
    out = {
        "embed_tokens": _to_torch(tree["embed_tokens"]["embedding"]),
        "final_norm.weight": _to_torch(tree["final_norm"]["weight"]),
        **_dense("lm_head", tree["lm_head"], 1),
    }
    for i, layer in enumerate(_layer_trees(tree)):
        p = f"layers.{i}."
        attn, mlp = layer["attn"], layer["mlp"]
        for name in ("q_proj", "k_proj", "v_proj"):  # [E, H, D]
            out.update(_dense(p + "attn." + name, attn[name], 1))
        out.update(_dense(p + "attn.o_proj", attn["o_proj"], 2))  # [H, D, E]
        for name in ("gate_proj", "up_proj", "down_proj"):
            out.update(_dense(p + "mlp." + name, mlp[name], 1))
        out[p + "input_norm.weight"] = _to_torch(layer["input_norm"]["weight"])
        out[p + "post_attn_norm.weight"] = _to_torch(
            layer["post_attn_norm"]["weight"])
    return out


def init_params(cfg: LlamaConfig, seed: int = 0, device="cuda",
                dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Random weights on ``device`` from a ``torch.Generator`` seeded with
    ``seed``: flax's inits (lecun-normal — a normal truncated at two
    standard deviations, scaled by sqrt(1 / fan_in) / 0.8796 — for the
    projections and lm_head, normal(0.02) for the embedding, ones for
    the norms), not flax's bits. Each tensor is drawn in f32 and stored
    in ``dtype``, one at a time, so an 8B init peaks at one f32 tensor
    above the ``dtype`` weights."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    e, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    hd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def lecun(fan_in: int, *shape):
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                    generator=gen)
        return w.to(dtype)

    def ones(n: int):
        return torch.ones(n, dtype=dtype, device=dev)

    emb = torch.empty((v, e), dtype=torch.float32, device=dev)
    out = {"embed_tokens": emb.normal_(0.0, 0.02, generator=gen).to(dtype)}
    del emb
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        out[p + "input_norm.weight"] = ones(e)
        out[p + "attn.q_proj"] = lecun(e, e, hd)
        out[p + "attn.k_proj"] = lecun(e, e, kvd)
        out[p + "attn.v_proj"] = lecun(e, e, kvd)
        out[p + "attn.o_proj"] = lecun(hd, hd, e)
        out[p + "post_attn_norm.weight"] = ones(e)
        out[p + "mlp.gate_proj"] = lecun(e, e, f)
        out[p + "mlp.up_proj"] = lecun(e, e, f)
        out[p + "mlp.down_proj"] = lecun(f, f, e)
    out["final_norm.weight"] = ones(e)
    out["lm_head"] = lecun(e, e, v)
    return out
