"""Llama decoder for serving (port of the decode path of
``k8s_tpu/models/llama.py``).

RMSNorm in f32, half-split rotary embeddings with f32 angles, grouped-
query attention over a static head-major KV cache, SwiGLU MLP, compute
in ``config.dtype`` and the lm_head in f32 — the layer loop is always
unrolled (the JAX package's serving layout).

The cache is an explicit :class:`KVCache` object instead of flax's
"cache" variable collection. Attention has the JAX package's regimes:

- a FRESH cache (no forward has written it yet) with ``s > 1`` is a
  first prefill at offset 0: K/V rows ``[0, s)`` are written and the
  prompt's causal self-attention runs through the flash kernel
  (:func:`k8s_tpu_torch.ops.attention.flash_attention`);
- ``s == 1`` is one decode step through the ragged decode kernel, which
  appends the new row IN PLACE (on the CPU, its plain version when the
  config is one the kernel is built for);
- anything else (a warm-cache continuation chunk, or a CPU decode step
  at another shape) writes its rows and attends against the whole cache
  with a per-row position mask (:func:`_cached_attention`, plain
  PyTorch, as the JAX package leaves it to XLA).

On the card the model serves only configs the kernels are built for
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
import math
from typing import List, Optional

import torch
from torch import nn
import torch.nn.functional as F

from k8s_tpu_torch import resolve_device
from k8s_tpu_torch.ops.attention import (
    DECODE_GROUPS,
    KERNEL_HEAD_DIMS,
    NEG_INF,
    decode_attention_update,
    flash_attention,
)
from k8s_tpu_torch.ops.norms import rms_norm
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

    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        base = dict(
            vocab_size=512, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
            max_seq_len=256,
        )
        base.update(kw)
        return LlamaConfig(**base)


class KVCache:
    """Static-shape KV cache: per layer, head-major ``[B, Hkv, S, D]``
    key and value tensors (each (batch, head)'s rows are one contiguous
    ``[S, D]`` slab — the layout the decode kernel streams).

    ``fresh``: no forward has written this cache yet, so an ``s > 1``
    call is a first prefill at offset 0 (the flax "no cache variables
    yet" state). ``index``: the append index of classic, non-ragged
    decode, advanced by every forward."""

    def __init__(self, keys: List[torch.Tensor], values: List[torch.Tensor],
                 fresh: bool = True):
        self.keys = keys
        self.values = values
        self.fresh = fresh
        self.index = 0

    @classmethod
    def zeros(cls, cfg: LlamaConfig, batch: int, length: Optional[int] = None,
              device="cpu", fresh: bool = True) -> "KVCache":
        shape = (batch, cfg.num_kv_heads, length or cfg.max_seq_len,
                 cfg.head_dim)
        mk = lambda: torch.zeros(shape, dtype=cfg.dtype, device=device)  # noqa: E731
        return cls([mk() for _ in range(cfg.num_layers)],
                   [mk() for _ in range(cfg.num_layers)], fresh)

    def slot(self, i: int, fresh: bool = False) -> "KVCache":
        """Batch-1 VIEW of row ``i``: writes land in this cache."""
        return KVCache([k[i:i + 1] for k in self.keys],
                       [v[i:i + 1] for v in self.values], fresh)

    def copy_rows_(self, src: "KVCache", slot: int, rows: int) -> None:
        """Copy the first ``rows`` rows of batch-1 ``src`` into row
        ``slot`` of this cache, in place (the engine's scatter of a
        prefill working cache into its slot)."""
        for dst_l, src_l in zip(self.keys + self.values,
                                src.keys + src.values):
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
    """Decode-kernel gate, re-derived for CUDA: the head dim, group size
    and dtype the kernel is built for. The JAX gate's VMEM slab budget
    is gone (the kernel streams the cache rows it needs), and so is its
    backend test: on a CPU tensor the wrapper runs the plain version."""
    return (cfg.head_dim in KERNEL_HEAD_DIMS
            and cfg.num_heads // cfg.num_kv_heads in DECODE_GROUPS
            and cfg.dtype == torch.bfloat16)


def check_cuda_config(cfg: LlamaConfig) -> None:
    """Raise unless both kernels serve ``cfg`` on the card: the flash and
    decode kernels are built for bf16 at head dims KERNEL_HEAD_DIMS and
    group sizes DECODE_GROUPS, and the card runs no plain attention in
    their place."""
    if not _use_kernel_decode(cfg):
        raise ValueError(
            f"no CUDA kernel instance for head_dim={cfg.head_dim}, "
            f"{cfg.num_heads // cfg.num_kv_heads} q heads per kv head, "
            f"{cfg.dtype}: the kernels are built for bfloat16, head_dim in "
            f"{KERNEL_HEAD_DIMS}, groups in {DECODE_GROUPS}; serve this "
            "config with device='cpu' or add a kernel instance")


def _weight(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, layer: int, device):
        super().__init__()
        self.cfg, self.layer = cfg, layer
        e, h, kv, d = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim)
        # [in, out] — the JAX DenseGeneral kernel layouts, flattened
        self.q_proj = _weight(e, h * d, dtype=cfg.dtype, device=device)
        self.k_proj = _weight(e, kv * d, dtype=cfg.dtype, device=device)
        self.v_proj = _weight(e, kv * d, dtype=cfg.dtype, device=device)
        self.o_proj = _weight(h * d, e, dtype=cfg.dtype, device=device)

    def forward(self, x, positions, cache: KVCache):
        cfg = self.cfg
        b, s, _ = x.shape
        h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = _rope((x @ self.q_proj).view(b, s, h, d), positions,
                  cfg.rope_theta)
        k = _rope((x @ self.k_proj).view(b, s, kv, d), positions,
                  cfg.rope_theta)
        v = (x @ self.v_proj).view(b, s, kv, d)
        ck, cv = cache.keys[self.layer], cache.values[self.layer]
        cur = positions[:, 0] if cfg.ragged_decode else cache.index
        scale = 1.0 / math.sqrt(d)
        if s == 1 and (x.is_cuda or _use_kernel_decode(cfg)):
            out, _, _ = decode_attention_update(
                q[:, 0], k[:, 0].to(ck.dtype), v[:, 0].to(cv.dtype),
                ck, cv, cur, scale=scale)
            out = out[:, None]  # [B, 1, Hq, D]
        else:
            if not cfg.ragged_decode:
                ck[:, :, cur:cur + s] = k.transpose(1, 2)
                cv[:, :, cur:cur + s] = v.transpose(1, 2)
            elif s > 1 and cache.fresh:
                ck[:, :, :s] = k.transpose(1, 2)
                cv[:, :, :s] = v.transpose(1, 2)
            else:
                # per-row offsets: rows [cur_b, cur_b + s) of row b
                rows = cur.long()[:, None] + torch.arange(s, device=x.device)
                bidx = torch.arange(b, device=x.device)[:, None]
                ck[bidx, :, rows] = k.to(ck.dtype)  # [B, s, Hkv, D]
                cv[bidx, :, rows] = v.to(cv.dtype)
            if s > 1 and cache.fresh:
                # one-shot prefill: the prompt IS the whole visible
                # context, so causal self-attention over the new k/v
                # runs through the flash kernel, never over max_seq
                out = flash_attention(q, k, v, causal=True, scale=scale)
            else:
                k_pos = torch.arange(ck.shape[2], device=x.device)
                if cfg.ragged_decode:
                    mask = k_pos[None, None, :] <= positions[:, :, None]
                else:
                    q_pos = cur + torch.arange(s, device=x.device)
                    mask = (k_pos[None, :] <= q_pos[:, None]).expand(
                        b, s, ck.shape[2])
                out = _cached_attention(q, ck, cv, mask, scale)
        return out.reshape(b, s, h * d) @ self.o_proj


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        e, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _weight(e, f, dtype=cfg.dtype, device=device)
        self.up_proj = _weight(e, f, dtype=cfg.dtype, device=device)
        self.down_proj = _weight(f, e, dtype=cfg.dtype, device=device)

    def forward(self, x):
        y = F.silu(x @ self.gate_proj) * (x @ self.up_proj)
        return y @ self.down_proj


class RMSNorm(nn.Module):
    def __init__(self, size: int, eps: float, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(size, dtype=torch.float32, device=device),
            requires_grad=False)

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, layer: int, device):
        super().__init__()
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, device)
        self.attn = LlamaAttention(cfg, layer, device)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, device)
        self.mlp = LlamaMLP(cfg, device)

    def forward(self, x, positions, cache: KVCache):
        x = x + self.attn(self.input_norm(x), positions, cache)
        return x + self.mlp(self.post_attn_norm(x))


class LlamaForCausalLM(nn.Module):
    """Decode-mode Llama on ``device`` (default ``"cuda"``; raises without
    a card unless ``device="cpu"``, and on the card for a config the
    kernels are not built for). Weights start uninitialized: load them
    with :meth:`load_params` (from
    :func:`k8s_tpu_torch.models.convert.params_from_jax` or
    :func:`~k8s_tpu_torch.models.convert.init_params`)."""

    def __init__(self, config: LlamaConfig, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        if dev.type == "cuda":
            check_cuda_config(config)
        self.config = config
        self.device = dev
        self.embed_tokens = _weight(config.vocab_size, config.hidden_size,
                                    dtype=config.dtype, device=dev)
        self.layers = nn.ModuleList(
            LlamaBlock(config, i, dev) for i in range(config.num_layers))
        self.final_norm = RMSNorm(config.hidden_size, config.rms_eps, dev)
        # the lm_head runs in f32, as in the JAX package: an f32 copy of
        # the (bf16) weight is kept instead of upcasting it every step
        self.lm_head = _weight(config.hidden_size, config.vocab_size,
                               dtype=torch.float32, device=dev)

    def load_params(self, params) -> None:
        """Adopt a ``{name: tensor}`` dict keyed like
        ``named_parameters()``: each tensor moves to this model's device
        and the parameter's dtype (no copy when both already match)."""
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
            p.data = src.to(device=p.device, dtype=p.dtype)

    def new_cache(self, batch: int) -> KVCache:
        return KVCache.zeros(self.config, batch, device=self.device)

    def lm_head_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return hidden.float() @ self.lm_head

    @torch.no_grad()
    def forward(self, input_ids, positions=None, cache: Optional[KVCache] = None,
                last_logit_only: bool = False, return_hidden: bool = False):
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
