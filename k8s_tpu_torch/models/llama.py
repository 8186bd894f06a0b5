"""Llama decoder (port of ``k8s_tpu/models/llama.py``): the serving
path (``decode=True``) and the training forward (``decode=False``, the
default, as in the JAX package).

RMSNorm in f32, half-split rotary embeddings with f32 angles, grouped-
query attention, SwiGLU MLP, compute in ``config.dtype`` and the lm_head
in f32 — the layer loop is always unrolled.

Parameters are held in ``config.weight_dtype``: f32 master weights for
training (the JAX ``param_dtype=jnp.float32``), cast to ``config.dtype``
at use, and ``config.dtype`` itself for serving (a decode step re-reads
every weight, so f32 copies would double its bandwidth-bound time);
norms and the lm_head stay f32 in both. Training parameters require
grad; serving ones do not.

**Training** (``decode=False``): every layer runs causal self-attention
through :func:`k8s_tpu_torch.ops.attention.flash_attention` (on the card
the flash kernels forward and backward), optionally under per-block
activation checkpointing (``remat``, non-reentrant
``torch.utils.checkpoint``) with the JAX package's policies
(:func:`_remat_policy`). ``forward(..., return_hidden=True)`` returns the
final-norm hidden states, the input of
:func:`k8s_tpu_torch.ops.fused_ce.fused_lm_head_cross_entropy`.

**Serving** (``decode=True``): the cache is an explicit :class:`KVCache`
object instead of flax's "cache" variable collection. Attention has the
JAX package's regimes:

- a FRESH cache (no forward has written it yet) with ``s > 1`` is a
  first prefill at offset 0: K/V rows ``[0, s)`` are written and the
  prompt's causal self-attention runs through the flash kernel;
- ``s == 1`` is one decode step through the ragged decode kernel, which
  appends the new row IN PLACE (on the CPU, its plain version when the
  config is one the kernel is built for);
- anything else (a warm-cache continuation chunk, or a CPU decode step
  at another shape) writes its rows and attends against the whole cache
  with a per-row position mask (:func:`_cached_attention`, plain
  PyTorch, as the JAX package leaves it to XLA).

With ``kv_quant="int8"`` the cache is int8 with per-row f32 scales: every
write stores quantized rows (:func:`~k8s_tpu_torch.ops.attention.
quantize_kv_rows`), the one-shot prefill still attends the exact k/v, a
decode step goes through the int8-KV decode kernel (the new token's term
exact), and the other paths attend the cache dequantized to
``config.dtype``. With ``quant="int8_serving"`` every projection, MLP
kernel and the lm_head are int8 with per-column scales
(:mod:`k8s_tpu_torch.ops.quant`).

On the card the model runs only configs the kernels are built for
(:func:`check_cuda_config`): it raises at construction rather than run
plain attention there.

The append index is ``positions[:, 0]`` per row with
``ragged_decode=True`` (the continuous-batching engine owns per-slot
depths), else the cache's scalar ``index``. Every cache write is in
place on the tensors the caller passed, so a slot view of a bigger
cache is written through.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from k8s_tpu_torch import resolve_device
from k8s_tpu_torch.ops.attention import (
    DECODE_GROUPS,
    FLASH_OP,
    KERNEL_HEAD_DIMS,
    NEG_INF,
    decode_attention_update,
    decode_attention_update_q8,
    flash_attention,
    quantize_kv_rows,
)
from k8s_tpu_torch.ops.norms import rms_norm
from k8s_tpu_torch.ops.quant import Int8ServingDense, quantize_rows
from k8s_tpu_torch.parallel.sharding import sharded_embedding_lookup


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # RAGGED decode (continuous batching): every batch row sits at its
    # own cache depth, given by positions[:, 0]; the cache then carries
    # no index. A warm-cache call with s > 1 is a chunked-prefill
    # continuation appended at each row's own offset.
    ragged_decode: bool = False
    # per-block activation checkpointing in training, with one of the
    # JAX package's policies (_remat_policy): "nothing_saveable" (the
    # default) recomputes the whole block in the backward; "flash" keeps
    # only the flash op's out and lse, so the attention forward runs
    # once per step
    remat: bool = True
    remat_policy: str = "nothing_saveable"
    # autoregressive decoding against a KVCache (the serving path); the
    # training forward otherwise
    decode: bool = False
    # "int8_serving": weight-only int8 for decode — every projection,
    # MLP kernel and the lm_head stored int8 with per-column f32 scales
    # (ops/quant.py); the embedding and the norms stay as they are
    quant: str = "none"
    # "int8": the KV cache STORED int8 with per-row f32 scales (halves
    # the cache bytes a decode step reads); numerics change, opt-in
    kv_quant: str = "none"

    def __post_init__(self):
        if self.quant not in ("none", "int8_serving"):
            raise ValueError(f"unknown quant {self.quant!r}; expected "
                             "'none' or 'int8_serving'")
        if self.kv_quant not in ("none", "int8"):
            raise ValueError(f"unknown kv_quant {self.kv_quant!r}; expected "
                             "'none' or 'int8'")
        if self.quant != "none" and not self.decode:
            raise ValueError("quant='int8_serving' is a serving layout: it "
                             "needs decode=True")

    @property
    def weight_dtype(self) -> torch.dtype:
        """Storage dtype of the projection and embedding weights: f32
        master weights for training, ``dtype`` for decode."""
        return self.dtype if self.decode else torch.float32

    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        base = dict(
            vocab_size=512, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
            max_seq_len=256, remat=False,
        )
        base.update(kw)
        return LlamaConfig(**base)


@torch.library.custom_op("k8s_tpu_torch::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """A named copy of ``x`` that remat policies can save (the JAX
    ``jax.ad_checkpoint.checkpoint_name``): its own op, so the selective
    checkpoint policy sees it. Used only under ``flash_qkv``."""
    return x.clone()


@checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


checkpoint_name.register_autograd(
    lambda ctx, grad: (grad, None), setup_context=lambda ctx, inputs, output: None)

_CHECKPOINT_NAME_OP = torch.ops.k8s_tpu_torch.checkpoint_name.default


def _remat_policy(name: str):
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a JAX remat
    policy name (``nothing_saveable``: none, so the checkpoint keeps only
    the block's inputs). Selective
    checkpointing sees dispatcher-level ops: ``dots`` saves the outputs
    of unbatched matmuls (``aten.mm``), ``flash`` those of the flash op
    (out and lse), ``flash_qkv`` also the post-rope q/k/v. Eager PyTorch
    has no dead-code elimination, so a recompute still re-runs the ops
    upstream of a saved tensor: ``flash_qkv`` trades memory, not time."""
    if name == "nothing_saveable":
        return noop_context_fn
    if name == "dots":
        saved = {torch.ops.aten.mm.default}
    elif name == "flash":
        saved = {FLASH_OP}
    elif name == "flash_qkv":
        saved = {FLASH_OP, _CHECKPOINT_NAME_OP}
    else:
        raise ValueError(
            f"unknown remat_policy {name!r}; expected 'nothing_saveable', "
            "'dots', 'flash', or 'flash_qkv'"
        )

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


class KVCache:
    """Static-shape KV cache: per layer, head-major ``[B, Hkv, S, D]``
    key and value tensors (each (batch, head)'s rows are one contiguous
    ``[S, D]`` slab — the layout the decode kernels stream), in the
    config's dtype, or int8 with ``kv_quant="int8"``: then per layer
    also f32 per-row ``key_scales``/``value_scales`` of shape ``[B, Hkv,
    S]`` (the JAX package keeps ``[B, Hkv, 1, S]``, a Mosaic layout; rows
    are on axis 2 here as in the caches, so every row write and copy
    indexes both alike). ``key_scales`` is None for a bf16 cache.

    ``fresh``: no forward has written this cache yet, so an ``s > 1``
    call is a first prefill at offset 0 (the flax "no cache variables
    yet" state). ``index``: the append index of classic, non-ragged
    decode, advanced by every forward."""

    def __init__(self, keys: List[torch.Tensor], values: List[torch.Tensor],
                 fresh: bool = True,
                 key_scales: Optional[List[torch.Tensor]] = None,
                 value_scales: Optional[List[torch.Tensor]] = None):
        self.keys = keys
        self.values = values
        self.key_scales = key_scales
        self.value_scales = value_scales
        self.fresh = fresh
        self.index = 0

    @classmethod
    def zeros(cls, cfg: LlamaConfig, batch: int, length: Optional[int] = None,
              device="cuda", fresh: bool = True) -> "KVCache":
        dev = resolve_device(device)
        rows = length or cfg.max_seq_len
        shape = (batch, cfg.num_kv_heads, rows, cfg.head_dim)
        q8 = cfg.kv_quant == "int8"
        dtype = torch.int8 if q8 else cfg.dtype

        def mk(shape, dtype):
            return [torch.zeros(shape, dtype=dtype, device=dev)
                    for _ in range(cfg.num_layers)]

        return cls(mk(shape, dtype), mk(shape, dtype), fresh,
                   mk(shape[:3], torch.float32) if q8 else None,
                   mk(shape[:3], torch.float32) if q8 else None)

    def _tensors(self) -> List[torch.Tensor]:
        """Every per-layer tensor, rows on axis 2."""
        out = self.keys + self.values
        if self.key_scales is not None:
            out += self.key_scales + self.value_scales
        return out

    def slot(self, i: int, fresh: bool = False) -> "KVCache":
        """Batch-1 VIEW of row ``i``: writes land in this cache."""
        view = lambda ts: None if ts is None else [t[i:i + 1] for t in ts]  # noqa: E731
        return KVCache(view(self.keys), view(self.values), fresh,
                       view(self.key_scales), view(self.value_scales))

    def copy_rows_(self, src: "KVCache", slot: int, rows: int) -> None:
        """Copy the first ``rows`` rows of batch-1 ``src`` (and their
        scales) into row ``slot`` of this cache, in place (the engine's
        scatter of a prefill working cache into its slot)."""
        for dst_l, src_l in zip(self._tensors(), src._tensors()):
            dst_l[slot, :, :rows].copy_(src_l[0, :, :rows])


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding, [B, S, H, D] layout, f32 rotation
    (half-split: the first and second halves of D form the pairs)."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    angles = positions[..., None].float() * freqs  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _cached_attention(q, k_all, v_all, mask, scale):
    """Attention against the full static cache: q [B, s, Hq, D], k/v
    HEAD-MAJOR [B, Hkv, S, D], mask [B, s, S] bool (True = visible).
    Plain f32 math — continuation chunks and off-kernel decode steps."""
    b, s, hq, d = q.shape
    hkv = k_all.shape[1]
    qf = (q.float() * scale).reshape(b, s, hkv, hq // hkv, d)
    logits = torch.einsum("bqhgd,bhkd->bhgqk", qf, k_all.float())
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bqhgd", probs, v_all.float())
    return out.reshape(b, s, hq, d).to(q.dtype)


def _use_kernel_decode(cfg: LlamaConfig) -> bool:
    """Decode-kernel gate (the JAX ``_use_pallas_decode``), re-derived for
    CUDA: the head dim, group size and dtype the kernel of the config's
    cache is built for — the bf16 decode kernel, or with ``kv_quant=
    "int8"`` the int8-KV one, both instantiated for KERNEL_HEAD_DIMS and
    DECODE_GROUPS with bf16 queries. The JAX gate's VMEM slab budget is
    gone (the kernels stream the cache rows they need), and so are its
    backend test and the int8 cache's ``S % 32`` rule (Mosaic tiling):
    on a CPU tensor the wrapper runs the plain version."""
    return (cfg.head_dim in KERNEL_HEAD_DIMS
            and cfg.num_heads // cfg.num_kv_heads in DECODE_GROUPS
            and cfg.dtype == torch.bfloat16)


def check_cuda_config(cfg: LlamaConfig) -> None:
    """Raise unless the kernels serve ``cfg`` on the card: the flash and
    decode kernels (bf16 or int8 KV) are built for bf16 at head dims
    KERNEL_HEAD_DIMS and group sizes DECODE_GROUPS, and the card runs no
    plain attention in their place."""
    if not _use_kernel_decode(cfg):
        raise ValueError(
            f"no CUDA kernel instance for head_dim={cfg.head_dim}, "
            f"{cfg.num_heads // cfg.num_kv_heads} q heads per kv head, "
            f"{cfg.dtype}: the kernels are built for bfloat16, head_dim in "
            f"{KERNEL_HEAD_DIMS}, groups in {DECODE_GROUPS}; serve this "
            "config with device='cpu' or add a kernel instance")


def _weight(cfg: LlamaConfig, *shape, dtype, device) -> nn.Parameter:
    """A parameter of ``shape``: trainable in a training config."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=not cfg.decode)


def _use(w: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """A weight cast to the compute dtype at use (the same tensor, with
    no dispatch, when it is stored in it, as in serving)."""
    return w if w.dtype == cfg.dtype else w.to(cfg.dtype)


def _projection(cfg: LlamaConfig, n_in: int, n_out: int, device):
    """An ``[in, out]`` projection weight, or with ``quant="int8_serving"``
    an :class:`Int8ServingDense` (parameters ``kernel_q``/``scale``)."""
    if cfg.quant == "int8_serving":
        return Int8ServingDense(n_in, n_out, device, out_dtype=cfg.dtype)
    return _weight(cfg, n_in, n_out, dtype=cfg.weight_dtype, device=device)


def _dense(w, x: torch.Tensor, cfg: LlamaConfig, xq=None) -> torch.Tensor:
    """``x @ w`` in the compute dtype; for an int8 projection its int8
    product, reusing ``xq`` (``quantize_rows(x)``) when given."""
    if isinstance(w, Int8ServingDense):
        return w(x, xq)
    return x @ _use(w, cfg)


def _quantized_input(x: torch.Tensor, cfg: LlamaConfig):
    """The per-row int8 quantization of an input that several int8
    projections share (None when the weights are not int8)."""
    return quantize_rows(x) if cfg.quant == "int8_serving" else None


def _write_rows(dst: torch.Tensor, new: torch.Tensor, cfg: LlamaConfig,
                cur, fresh: bool) -> None:
    """Write a chunk's rows ``new [B, s, Hkv, ...]`` into the cache tensor
    ``dst [B, Hkv, S, ...]`` (rows on axis 2: keys, values or scales) in
    place, in the three index regimes: the shared scalar ``cur`` (classic
    decode), a fresh ragged cache (a first prefill at offset 0), or the
    per-row offsets ``cur [B]`` (ragged decode steps and continuation
    chunks: rows ``[cur_b, cur_b + s)`` of row b)."""
    b, s = new.shape[:2]
    if not cfg.ragged_decode:
        dst[:, :, cur:cur + s] = new.transpose(1, 2)
    elif s > 1 and fresh:
        dst[:, :, :s] = new.transpose(1, 2)
    else:
        rows = cur.long()[:, None] + torch.arange(s, device=new.device)
        bidx = torch.arange(b, device=new.device)[:, None]
        dst[bidx, :, rows] = new.to(dst.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, layer: int, device):
        super().__init__()
        self.cfg, self.layer = cfg, layer
        e, h, kv, d = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim)
        # [in, out] — the JAX DenseGeneral kernel layouts, flattened
        self.q_proj = _projection(cfg, e, h * d, device)
        self.k_proj = _projection(cfg, e, kv * d, device)
        self.v_proj = _projection(cfg, e, kv * d, device)
        self.o_proj = _projection(cfg, h * d, e, device)

    def forward(self, x, positions, cache: Optional[KVCache] = None,
                segment_ids: Optional[torch.Tensor] = None):
        cfg = self.cfg
        b, s, _ = x.shape
        h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        xq = _quantized_input(x, cfg)
        q = _rope(_dense(self.q_proj, x, cfg, xq).view(b, s, h, d), positions,
                  cfg.rope_theta)
        k = _rope(_dense(self.k_proj, x, cfg, xq).view(b, s, kv, d),
                  positions, cfg.rope_theta)
        v = _dense(self.v_proj, x, cfg, xq).view(b, s, kv, d)
        if not cfg.decode:
            if cfg.remat and cfg.remat_policy == "flash_qkv":
                q = checkpoint_name(q, "attn_q")
                k = checkpoint_name(k, "attn_k")
                v = checkpoint_name(v, "attn_v")
            out = flash_attention(q, k, v, causal=True,
                                  segment_ids=segment_ids)
            return _dense(self.o_proj, out.reshape(b, s, h * d), cfg)
        if segment_ids is not None:
            raise NotImplementedError(
                "packed segments are not supported in decode mode")
        layer = self.layer
        ck, cv = cache.keys[layer], cache.values[layer]
        q8 = cache.key_scales is not None
        cur = positions[:, 0] if cfg.ragged_decode else cache.index
        scale = 1.0 / math.sqrt(d)
        if s == 1 and (x.is_cuda or _use_kernel_decode(cfg)):
            if q8:
                out = decode_attention_update_q8(
                    q[:, 0], k[:, 0], v[:, 0], ck, cv, cache.key_scales[layer],
                    cache.value_scales[layer], cur, scale=scale)[0]
            else:
                out, _, _ = decode_attention_update(
                    q[:, 0], k[:, 0].to(ck.dtype), v[:, 0].to(cv.dtype),
                    ck, cv, cur, scale=scale)
            out = out[:, None]  # [B, 1, Hq, D]
        else:
            if q8:
                # quantized rows and their scales: the JAX package's
                # quantize_kv_rows writes
                (kq, ksc), (vq, vsc) = quantize_kv_rows(k), quantize_kv_rows(v)
                writes = ((ck, kq), (cv, vq), (cache.key_scales[layer], ksc),
                          (cache.value_scales[layer], vsc))
            else:
                writes = ((ck, k), (cv, v))
            for dst, new in writes:
                _write_rows(dst, new, cfg, cur, cache.fresh)
            if s > 1 and cache.fresh:
                # one-shot prefill: the prompt IS the whole visible
                # context, so causal self-attention over the new (exact,
                # never quantized) k/v runs through the flash kernel,
                # never over max_seq
                out = flash_attention(q, k, v, causal=True, scale=scale)
            else:
                k_all, v_all = ck, cv
                if q8:  # the cache dequantized to the compute dtype
                    k_all = (ck.float() * cache.key_scales[layer][..., None]
                             ).to(cfg.dtype)
                    v_all = (cv.float() * cache.value_scales[layer][..., None]
                             ).to(cfg.dtype)
                k_pos = torch.arange(ck.shape[2], device=x.device)
                if cfg.ragged_decode:
                    mask = k_pos[None, None, :] <= positions[:, :, None]
                else:
                    q_pos = cur + torch.arange(s, device=x.device)
                    mask = (k_pos[None, :] <= q_pos[:, None]).expand(
                        b, s, ck.shape[2])
                out = _cached_attention(q, k_all, v_all, mask, scale)
        return _dense(self.o_proj, out.reshape(b, s, h * d), cfg)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.cfg = cfg
        e, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _projection(cfg, e, f, device)
        self.up_proj = _projection(cfg, e, f, device)
        self.down_proj = _projection(cfg, f, e, device)

    def forward(self, x):
        cfg = self.cfg
        xq = _quantized_input(x, cfg)
        y = (F.silu(_dense(self.gate_proj, x, cfg, xq))
             * _dense(self.up_proj, x, cfg, xq))
        return _dense(self.down_proj, y, cfg)


class RMSNorm(nn.Module):
    def __init__(self, cfg: LlamaConfig, size: int, device):
        super().__init__()
        self.eps = cfg.rms_eps
        self.weight = nn.Parameter(
            torch.ones(size, dtype=torch.float32, device=device),
            requires_grad=not cfg.decode)

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, layer: int, device):
        super().__init__()
        self.input_norm = RMSNorm(cfg, cfg.hidden_size, device)
        self.attn = LlamaAttention(cfg, layer, device)
        self.post_attn_norm = RMSNorm(cfg, cfg.hidden_size, device)
        self.mlp = LlamaMLP(cfg, device)

    def forward(self, x, positions, cache: Optional[KVCache] = None,
                segment_ids: Optional[torch.Tensor] = None):
        x = x + self.attn(self.input_norm(x), positions, cache, segment_ids)
        return x + self.mlp(self.post_attn_norm(x))


class LlamaForCausalLM(nn.Module):
    """Llama on ``device`` (default ``"cuda"``; raises without a card
    unless ``device="cpu"``, and on the card for a config the kernels
    are not built for): the training forward, or with
    ``config.decode`` the serving path. Weights start uninitialized:
    load them with :meth:`load_params` (from
    :func:`k8s_tpu_torch.models.convert.params_from_jax` or
    :func:`~k8s_tpu_torch.models.convert.init_params`)."""

    def __init__(self, config: LlamaConfig, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        if dev.type == "cuda":
            check_cuda_config(config)
        if config.remat and not config.decode:
            _remat_policy(config.remat_policy)  # an unknown name raises here
        self.config = config
        self.device = dev
        self.embed_tokens = _weight(config, config.vocab_size,
                                    config.hidden_size,
                                    dtype=config.weight_dtype, device=dev)
        self.layers = nn.ModuleList(
            LlamaBlock(config, i, dev) for i in range(config.num_layers))
        self.final_norm = RMSNorm(config, config.hidden_size, dev)
        # the lm_head runs in f32, as in the JAX package: serving keeps an
        # f32 copy of the (bf16) weight instead of upcasting it every
        # step; int8 serving stores it int8 with f32 output
        if config.quant == "int8_serving":
            self.lm_head = Int8ServingDense(config.hidden_size,
                                            config.vocab_size, dev,
                                            out_dtype=torch.float32)
        else:
            self.lm_head = _weight(config, config.hidden_size,
                                   config.vocab_size, dtype=torch.float32,
                                   device=dev)

    def load_params(self, params) -> None:
        """Adopt a ``{name: tensor}`` dict keyed like
        ``named_parameters()``: each tensor moves to this model's device
        and the parameter's dtype and memory layout (no copy when all
        three already match; the int8 kernels are held column-major)."""
        own = dict(self.named_parameters())
        if set(own) != set(params):
            raise ValueError(
                f"param names differ: missing {sorted(set(own) - set(params))}"
                f", unexpected {sorted(set(params) - set(own))}")
        for name, p in own.items():
            src = params[name]
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(p.shape)}")
            src = src.to(device=p.device, dtype=p.dtype)
            if src.stride() != p.stride():
                src = torch.empty_strided(p.shape, p.stride(), dtype=p.dtype,
                                          device=p.device).copy_(src)
            p.data = src

    def new_cache(self, batch: int) -> KVCache:
        return KVCache.zeros(self.config, batch, device=self.device)

    def lm_head_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """f32 logits of ``[*, E]`` hidden rows (the JAX engine's
        ``_lm_head_logits``): an f32 product, or the int8 one."""
        if isinstance(self.lm_head, Int8ServingDense):
            return self.lm_head(hidden.float())
        return hidden.float() @ self.lm_head

    def forward(self, input_ids, positions=None, cache: Optional[KVCache] = None,
                last_logit_only: bool = False, return_hidden: bool = False,
                segment_ids: Optional[torch.Tensor] = None):
        """Decode config: :meth:`decode_forward`. Training config:
        input_ids [B, S] -> logits [B, S or 1, V] f32, or the final-norm
        hidden states [B, S, E] with ``return_hidden`` (the fused-CE
        input). ``segment_ids`` [B, S] masks attention across packed
        documents (CPU only: the kernels raise for them)."""
        if self.config.decode:
            if segment_ids is not None:
                raise NotImplementedError(
                    "packed segments are not supported in decode mode")
            return self.decode_forward(input_ids, positions, cache,
                                       last_logit_only, return_hidden)
        if cache is not None:
            raise ValueError("a KV cache needs LlamaConfig(decode=True)")
        cfg = self.config
        b, s = input_ids.shape
        if positions is None:
            positions = torch.arange(s, device=input_ids.device).expand(b, s)
        x = sharded_embedding_lookup(self.embed_tokens, input_ids, cfg.dtype)
        context_fn = _remat_policy(cfg.remat_policy) if cfg.remat else None
        for block in self.layers:
            if context_fn is None:
                x = block(x, positions, None, segment_ids)
            else:
                x = checkpoint(block, x, positions, None, segment_ids,
                               use_reentrant=False, context_fn=context_fn)
        x = self.final_norm(x)
        if return_hidden:
            return x
        if last_logit_only:
            x = x[:, -1:]
        return self.lm_head_logits(x)

    @torch.no_grad()
    def decode_forward(self, input_ids, positions=None,
                       cache: Optional[KVCache] = None,
                       last_logit_only: bool = False,
                       return_hidden: bool = False):
        """input_ids [B, S] -> ``(logits [B, S or 1, V] f32, cache)``, or
        ``(hidden [B, S, E], cache)`` with ``return_hidden`` (final-norm
        states; the caller runs :meth:`lm_head_logits` on the rows it
        needs). ``cache=None`` starts a fresh cache of max_seq_len rows."""
        cfg = self.config
        b, s = input_ids.shape
        if positions is None:
            positions = torch.arange(s, device=input_ids.device).expand(b, s)
        if cache is None:
            cache = self.new_cache(b)
        x = sharded_embedding_lookup(self.embed_tokens, input_ids, cfg.dtype)
        for block in self.layers:
            x = block(x, positions, cache)
        x = self.final_norm(x)
        cache.fresh = False
        if not cfg.ragged_decode:
            cache.index += s
        if return_hidden:
            return x, cache
        if last_logit_only:
            x = x[:, -1:]
        return self.lm_head_logits(x), cache


def _pick_token(logits_last: torch.Tensor, generator: Optional[torch.Generator],
                temperature: float) -> torch.Tensor:
    """[B, V] logits -> [B] int32 tokens: argmax at temperature 0, else a
    softmax sample drawn from ``generator``."""
    if temperature == 0.0:
        return torch.argmax(logits_last, dim=-1).to(torch.int32)
    probs = torch.softmax(logits_last.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def _prefill(model: LlamaForCausalLM, prompt_ids, generator, temperature,
             chunk: int = 0):
    """Prompt ingestion: the whole prompt in ONE forward (``chunk=0``;
    a fresh cache rides the flash kernel), or in ``chunk``-sized pieces
    through the cache path, the first piece taking the remainder."""
    b, plen = prompt_ids.shape
    if chunk and plen > chunk:
        head = plen % chunk
        sizes = ([head] if head else []) + [chunk] * (plen // chunk)
    else:
        sizes = [plen]
    cache = model.new_cache(b)
    start = 0
    for size in sizes:
        positions = (start + torch.arange(size, device=prompt_ids.device)
                     ).expand(b, size)
        logits, cache = model(prompt_ids[:, start:start + size],
                              positions=positions, cache=cache,
                              last_logit_only=True)
        start += size
    return cache, _pick_token(logits[:, -1], generator, temperature)


def _decode_loop(model: LlamaForCausalLM, cache: KVCache, tok, generator,
                 plen: int, new_tokens: int, temperature: float):
    b = tok.shape[0]
    toks = [tok]
    for pos in range(plen, plen + new_tokens - 1):
        logits, cache = model(
            tok[:, None], cache=cache,
            positions=torch.full((b, 1), pos, dtype=torch.int32,
                                 device=tok.device))
        tok = _pick_token(logits[:, -1], generator, temperature)
        toks.append(tok)
    return torch.stack(toks, dim=1)


def _auto_prefill_chunk(device: torch.device) -> int:
    """One-shot prefill (0) on the card, where the flash kernel runs it;
    on the CPU the plain path would materialize [B, Hq, plen, plen] f32
    scores, so prompts longer than 512 go through the cache in chunks."""
    return 0 if device.type == "cuda" else 512


@torch.no_grad()
def generate(model: LlamaForCausalLM, prompt_ids: torch.Tensor,
             max_new_tokens: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             prefill_chunk: Optional[int] = None) -> torch.Tensor:
    """Autoregressive generation with a static KV cache: prefill (lm_head
    on the last position only), then one token per step. temperature 0 =
    greedy, else softmax sampling from ``generator``. Returns [B,
    max_new_tokens] int32 on the model's device."""
    cfg = model.config
    if not cfg.decode:
        raise ValueError("generate() needs LlamaConfig(decode=True)")
    b, plen = prompt_ids.shape
    prompt_ids = prompt_ids.to(model.device)
    if max_new_tokens <= 0:
        return torch.zeros((b, 0), dtype=torch.int32, device=model.device)
    if plen + max_new_tokens > cfg.max_seq_len:
        raise ValueError(
            f"prompt {plen} + new {max_new_tokens} exceeds cache size "
            f"{cfg.max_seq_len}")
    if prefill_chunk is None:
        prefill_chunk = _auto_prefill_chunk(model.device)
    cache, tok = _prefill(model, prompt_ids, generator, temperature,
                          chunk=prefill_chunk)
    if max_new_tokens == 1:
        return tok[:, None]
    return _decode_loop(model, cache, tok, generator, plen, max_new_tokens,
                        temperature)
