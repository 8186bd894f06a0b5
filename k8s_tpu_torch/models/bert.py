"""BERT encoder with MLM/NSP pretraining heads (port of
``k8s_tpu/models/bert.py``), the benchmark's BERT-base workload.

The flax model's numerics, in PyTorch:

- **Embeddings.** ``tok_embed`` (normal(0.02)), ``pos_embed`` and
  ``type_embed`` (flax's default embedding init, normal(1/sqrt(E))) are
  f32 masters gathered in ``dtype`` (bf16), as flax's ``nn.Embed(dtype=
  bf16)`` casts its table before the lookup: tok + pos (+ type) adds in
  bf16, then ``ln_embed``.
- **LayerNorm** (:func:`~k8s_tpu_torch.ops.norms.layer_norm`): flax's f32
  statistics, eps 1e-12, the output f32 — so the residual stream is f32
  after the first LN, and every bf16 projection casts its input — or
  bf16 with ``bf16_norms``.
- **Projections** are flax ``DenseGeneral(dtype=bf16)`` s: an ``[in,
  out]`` f32 kernel (normal(0.02)) and a zero bias, both cast to bf16
  with the input for the product. q/k/v ``[E, H, D]`` are held flattened
  ``[E, H*D]`` (``fused_qkv``: one ``[E, 3*H*D]`` in (3, H, D) order),
  ``o_proj`` ``[H, D, E]`` as ``[H*D, E]``.
- **Attention** is bidirectional (``causal=False``) through
  :func:`~k8s_tpu_torch.ops.attention.flash_attention`: on the card K1
  forward and K2/K3 backward at head dim 64; the padding mask
  ``attention_mask`` (1 real, 0 pad) rides the kernels' segment ids, so
  pad keys are invisible to real queries and pad rows are garbage the
  loss must drop. A head dim that is not a multiple of 64 (``tiny``'s 32)
  takes the plain attention by shape, as the JAX gate sends it to XLA.
- **Post-LN layers**: ``x = ln_attn(x + o_proj(attn))``, then the MLP
  ``fc_in`` → GELU (tanh unless ``use_exact_gelu``) → ``fc_out`` and
  ``x = ln_mlp(x + y)``.
- **Heads** run in f32: ``mlm_head`` ``[E, V]`` + bias over every position
  and ``nsp_head`` ``[E, 2]`` + bias on position 0; with ``hf_head`` the
  MLM transform (Dense + exact GELU + LayerNorm, before the decoder) and
  the tanh pooler before ``nsp_head`` (the Dense layers' kernels
  lecun-normal, as flax's ``nn.Dense``). ``return_hidden`` returns
  ``(hidden, nsp_logits)`` — the (transformed) hidden states to feed the
  fused LM-head CE with ``mlm_head``'s kernel and bias.

Parameters are drawn from the model's own generator, seeded with
``seed`` (flax's inits, not flax's bits); nothing draws from the default
generator. :func:`~k8s_tpu_torch.models.convert.bert_params_from_jax`
carries a flax tree across (:meth:`BertForPretraining.load_params`).
Parameter names: ``tok_embed``, ``pos_embed``, ``type_embed``,
``ln_embed.{scale,bias}``, ``layers.<i>.{q_proj,k_proj,v_proj |
qkv_proj, o_proj, fc_in, fc_out}.{kernel,bias}``,
``layers.<i>.{ln_attn,ln_mlp}.{scale,bias}``, ``mlm_head.{kernel,bias}``,
``nsp_head.{kernel,bias}``, and with ``hf_head``
``mlm_transform.{kernel,bias}``, ``mlm_transform_ln.{scale,bias}``,
``pooler.{kernel,bias}``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from k8s_tpu_torch import resolve_device
from k8s_tpu_torch.models.resnet import lecun_normal_
from k8s_tpu_torch.ops.attention import flash_attention
from k8s_tpu_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """The JAX ``BertConfig``'s fields and defaults (BERT-base)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    # HuggingFace-compatible heads: the MLM transform before the decoder
    # and the tanh pooler before the NSP head
    hf_head: bool = False
    # the encoder's GELU: None derives it from hf_head (exact erf GELU for
    # HF weights, else the tanh approximation)
    exact_gelu: Optional[bool] = None
    # W8A8 int8 encoder matmuls: not ported (ROADMAP A10)
    quant: str = "none"
    # LayerNorm outputs in bf16 instead of f32 (statistics in f32)
    bf16_norms: bool = False
    # one [E, 3, H, D] qkv projection instead of three [E, H, D] ones
    fused_qkv: bool = False
    # the training mesh (parallel.mesh.build_mesh); a tensor axis above 1
    # is not ported (ROADMAP A16)
    mesh: Optional[object] = dataclasses.field(default=None, hash=False,
                                               compare=False)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def use_exact_gelu(self) -> bool:
        return self.hf_head if self.exact_gelu is None else self.exact_gelu

    @staticmethod
    def base(**kw) -> "BertConfig":
        return BertConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        base = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                    num_layers=2, num_heads=4, max_seq_len=128)
        base.update(kw)
        return BertConfig(**base)


def check_bert_config(cfg: BertConfig) -> None:
    """Raise for what the port does not run: int8 matmuls (ROADMAP A10)
    and a mesh whose tensor axis splits the heads (ROADMAP A16)."""
    if cfg.quant != "none":
        raise NotImplementedError(
            f"BertConfig.quant={cfg.quant!r}: int8 training matmuls are not "
            "ported to k8s_tpu_torch yet (ROADMAP A10)")
    if cfg.mesh is not None:
        from k8s_tpu_torch.parallel.mesh import mesh_shape

        if mesh_shape(cfg.mesh).get("tensor", 1) > 1:
            raise NotImplementedError(
                "BERT's tensor-parallel path (tp_layout with tensor > 1) is "
                "not ported to k8s_tpu_torch yet (ROADMAP A16)")


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``'s parameters (``scale`` ones, ``bias``
    zeros, f32) and numerics (:func:`layer_norm`), output in ``dtype``."""

    def __init__(self, features: int, eps: float, dtype: torch.dtype, device):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.eps, self.dtype)


class Dense(nn.Module):
    """A flax ``DenseGeneral``/``Dense`` with an f32 ``[in, out]`` kernel
    and bias, computed in ``dtype``: input, kernel and bias cast to it,
    one product plus bias."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(n_in, n_out, device=device))
        self.bias = nn.Parameter(torch.zeros(n_out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.kernel.to(dt).t(), self.bias.to(dt))


def _gelu(x: torch.Tensor, exact: bool) -> torch.Tensor:
    return F.gelu(x, approximate="none" if exact else "tanh")


class BertLayer(nn.Module):
    """One post-LN encoder layer (the JAX ``BertLayer``)."""

    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        self.cfg = cfg
        e, hd, dt = cfg.hidden_size, cfg.num_heads * cfg.head_dim, cfg.dtype
        ln_dtype = dt if cfg.bf16_norms else torch.float32
        if cfg.fused_qkv:
            self.qkv_proj = Dense(e, 3 * hd, dt, device)
        else:
            self.q_proj = Dense(e, hd, dt, device)
            self.k_proj = Dense(e, hd, dt, device)
            self.v_proj = Dense(e, hd, dt, device)
        self.o_proj = Dense(hd, e, dt, device)
        self.ln_attn = LayerNorm(e, cfg.layer_norm_eps, ln_dtype, device)
        self.fc_in = Dense(e, cfg.intermediate_size, dt, device)
        self.fc_out = Dense(cfg.intermediate_size, e, dt, device)
        self.ln_mlp = LayerNorm(e, cfg.layer_norm_eps, ln_dtype, device)

    def forward(self, x: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        h, d = cfg.num_heads, cfg.head_dim
        if cfg.fused_qkv:
            qkv = self.qkv_proj(x).view(b, s, 3, h, d)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q = self.q_proj(x).view(b, s, h, d)
            k = self.k_proj(x).view(b, s, h, d)
            v = self.v_proj(x).view(b, s, h, d)
        # the padding mask rides the kernels' segment-id masking
        attn = flash_attention(q, k, v, causal=False, segment_ids=attention_mask)
        x = self.ln_attn(x + self.o_proj(attn.reshape(b, s, h * d)))
        y = _gelu(self.fc_in(x), cfg.use_exact_gelu)
        return self.ln_mlp(x + self.fc_out(y))


class BertForPretraining(nn.Module):
    """BERT with its pretraining heads on ``device`` (default
    ``"cuda"``; raises without a card unless ``device="cpu"``), random
    weights from ``seed``. ``forward(input_ids, token_type_ids=None,
    attention_mask=None, return_hidden=False)`` returns ``(mlm_logits
    [B, S, V] f32, nsp_logits [B, 2] f32)``, or with ``return_hidden``
    ``(hidden [B, S, E], nsp_logits)``."""

    def __init__(self, config: BertConfig, device="cuda", seed: int = 0):
        super().__init__()
        check_bert_config(config)
        cfg = self.config = config
        dev = self.device = resolve_device(device)
        e = cfg.hidden_size
        f32 = dict(dtype=torch.float32, device=dev)
        ln_dtype = cfg.dtype if cfg.bf16_norms else torch.float32
        self.tok_embed = nn.Parameter(torch.empty(cfg.vocab_size, e, **f32))
        self.pos_embed = nn.Parameter(torch.empty(cfg.max_seq_len, e, **f32))
        self.type_embed = nn.Parameter(torch.empty(cfg.type_vocab_size, e, **f32))
        self.ln_embed = LayerNorm(e, cfg.layer_norm_eps, ln_dtype, dev)
        self.layers = nn.ModuleList(BertLayer(cfg, dev)
                                    for _ in range(cfg.num_layers))
        if cfg.hf_head:
            self.mlm_transform = Dense(e, e, torch.float32, dev)
            self.mlm_transform_ln = LayerNorm(e, cfg.layer_norm_eps,
                                              torch.float32, dev)
            self.pooler = Dense(e, e, torch.float32, dev)
        self.mlm_head = Dense(e, cfg.vocab_size, torch.float32, dev)
        self.nsp_head = Dense(e, 2, torch.float32, dev)
        self.reset_parameters(seed)

    def reset_parameters(self, seed: int = 0) -> None:
        """Every weight from a generator seeded with ``seed``, with flax's
        inits: normal(0.02) for the token embedding and the DenseGeneral
        kernels (layers, ``mlm_head``), normal(1/sqrt(E)) for the position
        and type embeddings, lecun-normal for the ``nn.Dense`` kernels
        (``nsp_head``, ``mlm_transform``, ``pooler``); zero biases, unit
        LayerNorm scales."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        e = self.config.hidden_size
        lecun = {"nsp_head", "mlm_transform", "pooler"}
        with torch.no_grad():
            self.tok_embed.normal_(0.0, 0.02, generator=gen)
            self.pos_embed.normal_(0.0, 1.0 / math.sqrt(e), generator=gen)
            self.type_embed.normal_(0.0, 1.0 / math.sqrt(e), generator=gen)
            for name, mod in self.named_modules():
                if isinstance(mod, Dense):
                    if name in lecun:
                        lecun_normal_(mod.kernel, mod.kernel.shape[0], gen)
                    else:
                        mod.kernel.normal_(0.0, 0.02, generator=gen)
                    mod.bias.zero_()
                elif isinstance(mod, LayerNorm):
                    mod.scale.fill_(1.0)
                    mod.bias.zero_()

    def load_params(self, params) -> None:
        """Adopt a ``{name: tensor}`` dict keyed like ``named_parameters()``
        (:func:`~k8s_tpu_torch.models.convert.bert_params_from_jax`): each
        tensor is copied into its parameter (f32, this model's device). A
        flax model initialized without token types has no ``type_embed``;
        the model then keeps its own."""
        own = dict(self.named_parameters())
        if "type_embed" not in params:
            own.pop("type_embed")
        if set(own) != set(params):
            raise ValueError(
                f"param names differ: missing {sorted(set(own) - set(params))}"
                f", unexpected {sorted(set(params) - set(own))}")
        with torch.no_grad():
            for name, p in own.items():
                src = params[name]
                if tuple(src.shape) != tuple(p.shape):
                    raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                     f"{tuple(p.shape)}")
                p.copy_(src.to(device=p.device, dtype=p.dtype))

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                return_hidden: bool = False):
        cfg = self.config
        dt = cfg.dtype
        s = input_ids.shape[1]
        x = F.embedding(input_ids.long(), self.tok_embed.to(dt))
        x = x + self.pos_embed[:s].to(dt)
        if token_type_ids is not None:
            x = x + F.embedding(token_type_ids.long(), self.type_embed.to(dt))
        x = self.ln_embed(x)
        for layer in self.layers:
            x = layer(x, attention_mask)
        if cfg.hf_head:
            # the MLM transform runs before the decoder; return_hidden
            # hands back the transformed states
            t = self.mlm_transform_ln(F.gelu(self.mlm_transform(x)))
            pooled = torch.tanh(self.pooler(x[:, 0]))
            nsp_logits = self.nsp_head(pooled)
            if return_hidden:
                return t, nsp_logits
            return self.mlm_head(t), nsp_logits
        nsp_logits = self.nsp_head(x[:, 0])
        if return_hidden:
            return x, nsp_logits
        return self.mlm_head(x), nsp_logits
