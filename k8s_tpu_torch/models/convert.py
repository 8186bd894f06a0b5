"""Weights for the port's models: conversion from flax trees (the Llama,
the ResNet with its batch stats, the MNIST CNN, BERT), and the Llama's
random initialization from a seed.

The Llama's two return a ``{name: tensor}`` dict keyed like
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


def param_shapes(cfg: LlamaConfig) -> Dict[str, tuple]:
    """``{name: shape}`` of a (training-layout, unquantized) Llama's
    weights, keyed like ``named_parameters()``, in the order
    :func:`init_params` draws them."""
    e, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    hd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    out = {"embed_tokens": (v, e)}
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        out[p + "input_norm.weight"] = (e,)
        out[p + "attn.q_proj"] = (e, hd)
        out[p + "attn.k_proj"] = (e, kvd)
        out[p + "attn.v_proj"] = (e, kvd)
        out[p + "attn.o_proj"] = (hd, e)
        out[p + "post_attn_norm.weight"] = (e,)
        out[p + "mlp.gate_proj"] = (e, f)
        out[p + "mlp.up_proj"] = (e, f)
        out[p + "mlp.down_proj"] = (f, e)
    out["final_norm.weight"] = (e,)
    out["lm_head"] = (e, v)
    return out


def init_params(cfg: LlamaConfig, seed: int = 0, device="cuda",
                dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Random weights on ``device`` from a ``torch.Generator`` seeded with
    ``seed``: flax's inits (lecun-normal — a normal truncated at two
    standard deviations, scaled by sqrt(1 / fan_in) / 0.8796 — for the
    projections and lm_head, normal(0.02) for the embedding, ones for
    the norms), not flax's bits. Each tensor is drawn in f32 and stored
    in ``dtype``, one at a time, in :func:`param_shapes`' order, so an
    8B init peaks at one f32 tensor above the ``dtype`` weights."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("norm.weight"):
            out[name] = torch.ones(shape, dtype=dtype, device=dev)
            continue
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        if name == "embed_tokens":
            w.normal_(0.0, 0.02, generator=gen)
        else:  # lecun-normal over the input axis
            std = math.sqrt(1.0 / shape[0]) / 0.87962566103423978
            torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                        generator=gen)
        out[name] = w.to(dtype)
        del w
    return out


def _conv_weight(kernel) -> torch.Tensor:
    """A flax HWIO conv kernel as an OIHW tensor."""
    return _to_torch(np.asarray(kernel).transpose(3, 2, 0, 1))


def _bn(out: Dict[str, torch.Tensor], name: str, params: Mapping,
        stats: Mapping) -> None:
    out[name + ".scale"] = _to_torch(params["scale"])
    out[name + ".bias"] = _to_torch(params["bias"])
    out[name + ".mean"] = _to_torch(stats["mean"])
    out[name + ".var"] = _to_torch(stats["var"])


def _linear(out: Dict[str, torch.Tensor], name: str, params: Mapping) -> None:
    """A flax Dense ``(in, out)`` kernel as a ``[out, in]`` weight, and
    its bias."""
    out[name + ".weight"] = _to_torch(np.asarray(params["kernel"]).T)
    out[name + ".bias"] = _to_torch(params["bias"])


def resnet_params_from_jax(params: Mapping,
                           batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``ResNet``'s ``params`` and ``batch_stats`` trees (numpy)
    -> the port's ``ResNet`` state dict (parameters and BN buffers), for
    ``load_state_dict``: ``conv_init``, ``bn_init``,
    ``BottleneckBlock_<i>/{Conv_0..2, BatchNorm_0..2, conv_proj,
    norm_proj}`` and ``head`` become ``conv_init``, ``bn_init``,
    ``blocks.<i>.{conv_0..2, bn_0..2, conv_proj, norm_proj}`` and
    ``head``; HWIO kernels become OIHW."""
    out = {"conv_init.weight": _conv_weight(params["conv_init"]["kernel"])}
    _bn(out, "bn_init", params["bn_init"], batch_stats["bn_init"])
    n = sum(1 for k in params if k.startswith("BottleneckBlock_"))
    for i in range(n):
        p, s = params[f"BottleneckBlock_{i}"], batch_stats[f"BottleneckBlock_{i}"]
        pre = f"blocks.{i}."
        for j in range(3):
            out[pre + f"conv_{j}.weight"] = _conv_weight(p[f"Conv_{j}"]["kernel"])
            _bn(out, pre + f"bn_{j}", p[f"BatchNorm_{j}"], s[f"BatchNorm_{j}"])
        if "conv_proj" in p:
            out[pre + "conv_proj.weight"] = _conv_weight(p["conv_proj"]["kernel"])
            _bn(out, pre + "norm_proj", p["norm_proj"], s["norm_proj"])
    _linear(out, "head", params["head"])
    return out


def mnist_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``MnistCNN``'s ``params`` tree (numpy) -> the port's state
    dict: ``Conv_0``/``Conv_1`` (HWIO -> OIHW) and ``Dense_0``/``Dense_1``
    (``(in, out)`` -> ``[out, in]``; the port flattens in flax's (h, w,
    c) order, so ``Dense_0``'s rows need no permutation)."""
    out = {}
    for j in range(2):
        conv = params[f"Conv_{j}"]
        out[f"conv_{j}.weight"] = _conv_weight(conv["kernel"])
        out[f"conv_{j}.bias"] = _to_torch(conv["bias"])
        _linear(out, f"dense_{j}", params[f"Dense_{j}"])
    return out


def bert_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``BertForPretraining``'s ``params`` tree (numpy, unboxed) ->
    the port's ``{name: tensor}`` dict for
    :meth:`~k8s_tpu_torch.models.bert.BertForPretraining.load_params`,
    f32: the embeddings' ``embedding`` tables (``type_embed`` only when
    the flax model was initialized with token types), the LayerNorms'
    ``scale``/``bias``, and each Dense's ``kernel`` flattened to ``[in,
    out]`` over its input axes with its ``bias`` flattened to ``[out]``
    (q/k/v ``[E, H, D]`` -> ``[E, H*D]``, ``qkv_proj`` ``[E, 3, H, D]`` ->
    ``[E, 3*H*D]``, ``o_proj`` ``[H, D, E]`` -> ``[H*D, E]``). The same
    map carries a gradient tree of the flax model."""
    def dense(name: str, sub: Mapping, n_in: int) -> None:
        k = _to_torch(sub["kernel"])
        out[name + ".kernel"] = k.reshape(math.prod(k.shape[:n_in]), -1)
        out[name + ".bias"] = _to_torch(sub["bias"]).reshape(-1)

    def norm(name: str, sub: Mapping) -> None:
        out[name + ".scale"] = _to_torch(sub["scale"])
        out[name + ".bias"] = _to_torch(sub["bias"])

    out: Dict[str, torch.Tensor] = {}
    for name in ("tok_embed", "pos_embed", "type_embed"):
        if name in params:
            out[name] = _to_torch(params[name]["embedding"])
    norm("ln_embed", params["ln_embed"])
    n = sum(1 for k in params if k.startswith("layer_"))
    for i in range(n):
        layer, pre = params[f"layer_{i}"], f"layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "qkv_proj"):
            if name in layer:
                dense(pre + name, layer[name], 1)
        dense(pre + "o_proj", layer["o_proj"], 2)
        dense(pre + "fc_in", layer["fc_in"], 1)
        dense(pre + "fc_out", layer["fc_out"], 1)
        norm(pre + "ln_attn", layer["ln_attn"])
        norm(pre + "ln_mlp", layer["ln_mlp"])
    for name in ("mlm_head", "nsp_head", "mlm_transform", "pooler"):
        if name in params:
            dense(name, params[name], 1)
    if "mlm_transform_ln" in params:
        norm("mlm_transform_ln", params["mlm_transform_ln"])
    return out
