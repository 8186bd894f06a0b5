"""Attention (port of ``k8s_tpu/ops/attention.py``).

Five kernels, each beside its plain PyTorch version:

- :func:`flash_fwd` — blockwise online-softmax attention forward
  (``csrc/flash_fwd.cu``, replacing the Pallas ``_fwd_kernel``: TMA
  loads and ``wgmma`` products, with a tile size chosen per call by
  :func:`_flash_fwd_config`), at head dims 64 and 128, causal or not,
  with optional segment ids (a ``[B, S]`` row for the queries and,
  when it differs, one for the keys: the Pallas ``_segment_mask`` and
  its ``segment_ids_kv``), O in q's dtype or in f32 (``out_f32``). The
  engine's one-shot prefill of a fresh cache, every training forward
  (Llama's and BERT's) and every ring attention step run it.
- :func:`flash_bwd` — the flash backward: dQ (``_bwd_dq_kernel``) and
  dK/dV summed over the GQA group in registers (``_bwd_dkv_kernel``),
  both in ``csrc/flash_bwd.cu`` (TMA loads and ``wgmma`` products, no
  atomics), recomputing P from the forward's logsumexp, with the
  forward's segment ids, the gradients in the inputs' dtypes or in f32
  (``grads_f32``). Every training backward runs them, and every ring
  attention step's backward (:mod:`k8s_tpu_torch.parallel.ring_attention`,
  which merges the f32 partials).
- :func:`decode_attention_update` — ragged single-token decode with the
  in-place cache append (``csrc/decode_attn.cu``, replacing the Pallas
  ``_decode_attn_kernel``): blocks over splits of the cache rows, of a
  length :func:`_decode_split_rows` picks from the cache's shape, then
  a log-sum-exp merge of their partials. Every decode step over a bf16
  cache runs it.
- :func:`decode_attention_update_q8` — the same over an int8 cache with
  per-row f32 scales, quantizing the appended row in the kernel
  (``csrc/decode_attn_q8.cu``, replacing ``_decode_attn_kernel_q8``).
  Every decode step over an int8 cache runs it.

A wrapper runs the plain version only because the tensor it was given
lies on the CPU; for a CUDA tensor it launches the kernel or raises.
Each counts its launches in ``<wrapper>.launches`` (``flash_bwd``
counts the two kernels apart: ``flash_bwd.launches_dq`` and
``flash_bwd.launches_dkv``; a decode wrapper counts one per call, its
split and merge kernels together); the f32-output instances ring
attention launches are also counted apart (``flash_fwd.launches_out_f32``,
``flash_bwd.launches_grads_f32``: one per call, K2 and K3 each once). Every launch runs under a guard
for its tensors' device (:func:`_launch`).

:func:`mha_reference` is the plain attention path the JAX package runs
through XLA, and :func:`flash_attention` the public gate: the plain
path (under autograd) for CPU tensors, the kernels for CUDA tensors —
forward and backward through :func:`flash_attention_kernel`, the
``jax.custom_vjp`` pair ``_flash`` as a ``torch.library`` custom op with
a registered backward. Being one op the dispatcher sees, its outputs
(``out`` and ``lse``) are what the ``flash`` remat policy saves
(:mod:`k8s_tpu_torch.models.llama`). :func:`flash_attention_sharded`
runs it on one rank's block of a batch and heads split over a mesh
(tensor parallelism). Layouts follow the JAX package:
``[B, S, H, D]`` for attention, ``[B, H, D]`` queries over a
head-major ``[B, Hkv, S, D]`` cache for decode, ``[B, Hq, Sq]`` f32 for
lse and D (the JAX ``[B*H, 1, Sq]`` row layout, reshaped).
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Tuple

import torch

from k8s_tpu_torch.ops import _kernels

NEG_INF = -1e30
# head dims the flash kernels (K1-K3) are instantiated for: BERT-base's
# and Llama-3-8B's (add an instance in csrc/ when a ported config needs
# another). :func:`flash_attention` sends a head dim that is not a
# multiple of 64 to :func:`mha_reference`, as the JAX gate does.
KERNEL_HEAD_DIMS = (64, 128)
# head dims and query heads per kv head the decode kernels (K4, K5) are
# instantiated for
DECODE_HEAD_DIMS = (128,)
DECODE_GROUPS = (4,)
# csrc/flash_fwd.cu's two instances: config -> (query rows, keys) per
# block. 0 runs two consumer warpgroups, 1 one.
FLASH_FWD_TILES = {0: (128, 128), 1: (64, 128)}
# 128-row tiles need at least this many blocks, else 64-row tiles
# (twice the blocks) finish first. On an H100 (132 SMs), causal, B 1,
# Hq 32: 64 blocks of 128 rows (S 256) 0.0078 ms against 0.0061 for 128
# of 64; 128 blocks (S 512) 0.0115 against 0.0127 (PERF.md)
FLASH_FWD_MIN_BLOCKS = 128


def _visible(segment_ids, segment_ids_kv):
    """``[B, Sq, Sk]``: query i sees key j iff ``seg_q[i] == seg_kv[j]``
    (``segment_ids_kv`` None: the query row serves both sides), or None
    without ids. ``segment_ids_kv`` alone raises, as the JAX
    ``_flash_forward`` does."""
    if segment_ids is None:
        if segment_ids_kv is not None:
            raise ValueError("segment_ids_kv requires segment_ids")
        return None
    seg = segment_ids.to(torch.int32)
    seg_kv = seg if segment_ids_kv is None else segment_ids_kv.to(torch.int32)
    return seg[:, :, None] == seg_kv[:, None, :]


def _attention_f32(q, k, v, causal: bool, scale: float, segment_ids=None,
                   segment_ids_kv=None):
    """GQA attention in f32: ``(out [B, Sq, Hq, D] f32, lse [B, Hq, Sq])``.
    Causal masking is ``tril(k=sk-sq)``, the JAX reference's diagonal;
    segment ids as :func:`_visible`."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    groups = hq // hkv
    qf = (q.float() * scale).reshape(b, sq, hkv, groups, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(
            diagonal=sk - sq)
        logits = logits.masked_fill(~mask, NEG_INF)
    visible = _visible(segment_ids, segment_ids_kv)  # [B, Sq, Sk]
    if visible is not None:
        logits = logits.masked_fill(~visible[:, None, None], NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)  # [B, Hkv, G, Sq]
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, d), lse.reshape(b, hq, sq)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, scale: Optional[float] = None,
                  segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain attention with GQA broadcast and f32 softmax.
    q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D]; optional segment ids [B, S]
    (self-attention) mask across segment boundaries."""
    hq, hkv = q.shape[2], k.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    out, _ = _attention_f32(q, k, v, causal, scale, segment_ids)
    return out.to(q.dtype)


def flash_fwd_plain(q, k, v, causal: bool, scale: float, segment_ids=None,
                    segment_ids_kv=None, out_f32: bool = False):
    """The flash kernel's plain version: ``(out, lse [B, Hq, Sq] f32)``,
    ``out`` in q's dtype or, with ``out_f32``, in f32. ``segment_ids``
    [B, Sq] (the query rows) and ``segment_ids_kv`` [B, Sk] (the key rows;
    None: the query rows) hide key j from query i when their ids differ
    (the score set to the finite NEG_INF, as in the JAX reference). A row
    with no visible key is garbage by contract; with self-attention ids
    every row sees its own key."""
    out, lse = _attention_f32(q, k, v, causal, scale, segment_ids,
                              segment_ids_kv)
    return (out if out_f32 else out.to(q.dtype)), lse


def _segment_rows(segment_ids, q: torch.Tensor, sk: int) -> Optional[torch.Tensor]:
    """``segment_ids`` as the kernels read them: int32 [B, S] rows on q's
    device, padded to :func:`_tma_row_stride` (a TMA map reads them; None
    stays None). The query rows, or a key-side row of the same shape:
    the kernels take Sq == Sk (ring attention's chunks are equal)."""
    if segment_ids is None:
        return None
    b, sq = q.shape[0], q.shape[1]
    if sq != sk or tuple(segment_ids.shape) != (b, sq) \
            or segment_ids.device != q.device:
        raise ValueError(
            f"segment_ids must be [B, S] = ({b}, {sq}) on {q.device} with "
            f"Sq == Sk (got {tuple(segment_ids.shape)} on "
            f"{segment_ids.device}, Sk={sk})")
    return _tma_rows(segment_ids.to(torch.int32).contiguous())


def _check_bhsd(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: kernel takes bfloat16, got {x.dtype}")
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]) \
            or x.data_ptr() % 16:
        raise ValueError(
            f"{name}: kernel needs unit stride on D, other strides a "
            f"multiple of 8 and 16-byte alignment (strides {x.stride()})")


def _ptr(x: Optional[torch.Tensor]):
    """A tensor's device pointer for a C entry, or NULL for None."""
    return x.data_ptr() if x is not None else None


# the devices whose primary context each host thread has made current
# (:func:`_launch`)
_THREAD = threading.local()
# the flash wrappers' launch counters are bumped from several host
# threads at once (a ring's ranks as threads of one process): an
# unguarded ``+=`` on a function attribute can lose an update
_COUNT_LOCK = threading.Lock()


def _launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Call the C entry ``entry`` of kernel library ``name`` for tensors
    on ``device``: inside a device guard, since a C entry launches on the
    runtime's current device, and with that device's current stream as
    its last argument. Raises if the launch was refused.

    A host thread's first launch on a device first sets the device
    through torch (``cudaSetDevice``, which makes its primary context
    current in the thread). The kernel libraries link the CUDA runtime
    statically, and from a thread that had made no CUDA call through
    torch their launches failed with "invalid argument" on an H100; the
    device guard alone does not set a device that is already current.
    ``chip_smoke.py``'s ring of threads runs the kernels from such
    threads."""
    ready = getattr(_THREAD, "devices", None)
    if ready is None:
        ready = _THREAD.devices = set()
    with torch.cuda.device(device):
        index = device.index if device.index is not None else torch.cuda.current_device()
        if index not in ready:
            torch.cuda.set_device(index)
            ready.add(index)
        code = getattr(_kernels.lib(name), entry)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    _kernels.check(code, name)


def poison_shared_memory(device, smem_bytes: Optional[int] = None) -> int:
    """Fill the shared memory of every SM of CUDA ``device`` with NaN
    words (``csrc/smem_poison.cu``), on its current stream: run just
    before a kernel, a read of a tile before its bytes land then reads
    NaN, not what an earlier launch left (ROADMAP C4). ``smem_bytes``
    is the dynamic shared memory per poison block (a kernel's own size:
    ``flash_smem_bytes``), by default the device's opt-in maximum, which
    covers each SM's whole shared memory. Returns the size used. A check
    kernel, not a port: it counts no launches."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("poison_shared_memory needs a CUDA device")
    if smem_bytes is None:
        with torch.cuda.device(device):
            smem_bytes = _kernels.lib("smem_poison").k8s_smem_poison_max_bytes()
        if smem_bytes <= 0:
            raise RuntimeError("could not read the device's shared-memory limit")
    _launch("smem_poison", "k8s_smem_poison", device, int(smem_bytes))
    return int(smem_bytes)


def flash_smem_bytes(kernel: str, config: int = 0, d: int = 128) -> int:
    """Dynamic shared memory per block of a flash kernel at head dim
    ``d``: ``"fwd"`` (K1, tile ``config``), ``"dq"`` (K2) or ``"dkv"``
    (K3)."""
    if kernel == "fwd":
        return int(_kernels.lib("flash_fwd").k8s_flash_fwd_smem_bytes(config, d))
    return int(_kernels.lib("flash_bwd").k8s_flash_bwd_smem_bytes(
        {"dq": 0, "dkv": 1}[kernel], d))


def _flash_fwd_config(b: int, sq: int, hq: int) -> int:
    """The forward kernel's tile configuration for a call (a key of
    :data:`FLASH_FWD_TILES`): 128-row query tiles when they make enough
    blocks to fill the card, else 64-row tiles. The key length does not
    enter: both stream the same 128-key tiles."""
    blocks = b * hq * -(-sq // FLASH_FWD_TILES[0][0])
    return 0 if blocks >= FLASH_FWD_MIN_BLOCKS else 1


def _segment_pair(segment_ids, segment_ids_kv, q: torch.Tensor, sk: int):
    """The query and key rows as the kernels read them (None for no key
    row: the query row serves both sides)."""
    if segment_ids is None and segment_ids_kv is not None:
        raise ValueError("segment_ids_kv requires segment_ids")
    return (_segment_rows(segment_ids, q, sk),
            _segment_rows(segment_ids_kv, q, sk))


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, scale: float, with_lse: bool = False,
              config: Optional[int] = None,
              segment_ids: Optional[torch.Tensor] = None,
              segment_ids_kv: Optional[torch.Tensor] = None,
              out_f32: bool = False):
    """Flash attention forward. q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D],
    optional ``segment_ids`` [B, Sq] (query i sees key j only when their
    ids are equal) and ``segment_ids_kv`` [B, Sk] (the keys' ids when
    they are not the queries': ring attention's resident chunk); returns
    ``out`` (q's layout, q's dtype or f32 with ``out_f32``), or ``(out,
    lse [B, Hq, Sq] f32)`` with ``with_lse``. On a CUDA tensor this
    launches ``csrc/flash_fwd.cu`` (bf16, D in KERNEL_HEAD_DIMS, causal
    and segment ids only with Sq == Sk, scale > 0) with the tiles of
    ``config`` — None takes :func:`_flash_fwd_config`'s choice; the tests
    and chip_smoke.py's sweep force each — or raises; on a CPU tensor it
    runs the plain version (in f32 when given f32)."""
    if q.device.type == "cpu":
        out, lse = flash_fwd_plain(q, k, v, causal, scale, segment_ids,
                                   segment_ids_kv, out_f32)
        return (out, lse) if with_lse else out
    _check_kernel_shapes("flash_fwd", q, k, v, causal)
    seg, seg_kv = _segment_pair(segment_ids, segment_ids_kv, q, k.shape[1])
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_bhsd(name, x)
    if not scale > 0:
        raise ValueError(f"flash_fwd: the kernel takes scale > 0, got {scale}")
    if config is None:
        config = _flash_fwd_config(b, sq, hq)
    if config not in FLASH_FWD_TILES:
        raise ValueError(f"flash_fwd: config {config} not in {list(FLASH_FWD_TILES)}")
    out = torch.empty((b, sq, hq, d),
                      dtype=torch.float32 if out_f32 else q.dtype,
                      device=q.device)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    _launch("flash_fwd", "k8s_flash_fwd_bf16", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            _ptr(seg), _ptr(seg_kv), _tma_row_stride(sq),
            b, sq, sk, hq, hkv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], float(scale), int(bool(causal)),
            int(bool(out_f32)), config)
    with _COUNT_LOCK:
        flash_fwd.launches += 1
        flash_fwd.launches_out_f32 += bool(out_f32)
    return (out, lse) if with_lse else out


flash_fwd.launches = 0
flash_fwd.launches_out_f32 = 0


def compute_dd(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in f32, ``[B, Hq, Sq]`` (the backward's lse
    layout). Bandwidth-bound and tiny next to the kernels: plain
    PyTorch, as the JAX package leaves it to XLA."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_bwd_plain(q, k, v, out, lse, dout, causal: bool, scale: float,
                    segment_ids=None, segment_ids_kv=None,
                    grads_f32: bool = False):
    """The backward kernels' plain version, from their formulas, in f32:
    P = exp(scale Q K^T - lse), dP = dO V^T, dS = P (dP - D) with D from
    :func:`compute_dd`; dQ = scale dS K, and per kv head dK = scale dS^T Q
    and dV = P^T dO summed over its group of query heads. Returns
    ``(dq, dk, dv)`` in q's, k's and v's dtypes, or all three in f32
    with ``grads_f32``. Causal masking is ``tril(k=sk-sq)``, as in the
    forward; ``segment_ids`` [B, Sq] and ``segment_ids_kv`` [B, Sk] (as
    in :func:`flash_fwd_plain`) zero P where a query's and a key's ids
    differ (the JAX kernels' NEG_INF score, exp(NEG_INF - lse) = 0)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    groups = hq // hkv
    dd = compute_dd(out, dout).reshape(b, hkv, groups, sq)
    qf = q.float().reshape(b, sq, hkv, groups, d)
    dof = dout.float().reshape(b, sq, hkv, groups, d)
    kf, vf = k.float(), v.float()
    s = scale * torch.einsum("bqhgd,bkhd->bhgqk", qf, kf)
    p = torch.exp(s - lse.float().reshape(b, hkv, groups, sq)[..., None])
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(
            diagonal=sk - sq)
        p = p.masked_fill(~mask, 0.0)
    visible = _visible(segment_ids, segment_ids_kv)  # [B, Sq, Sk]
    if visible is not None:
        p = p.masked_fill(~visible[:, None, None], 0.0)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - dd[..., None])
    dq = scale * torch.einsum("bhgqk,bkhd->bqhgd", ds, kf)
    dk = scale * torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    dq = dq.reshape(b, sq, hq, d)
    if grads_f32:
        return dq, dk, dv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_shapes(name: str, q, k, v, causal: bool) -> None:
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name}: q, k, v must be on one CUDA device")
    if d not in KERNEL_HEAD_DIMS or k.shape[-1] != d or v.shape != k.shape:
        raise ValueError(f"{name}: unsupported shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if hq % hkv or (causal and sq != sk):
        raise ValueError(f"{name}: needs Hq % Hkv == 0 and, when causal, "
                         f"Sq == Sk (got Hq={hq} Hkv={hkv} Sq={sq} Sk={sk})")


def _check_rows(name: str, x: torch.Tensor, shape, device) -> None:
    if (tuple(x.shape) != tuple(shape) or x.dtype != torch.float32
            or x.device != device or not x.is_contiguous()):
        raise ValueError(f"{name}: needs a contiguous f32 {tuple(shape)} "
                         f"tensor on {device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def _tma_row_stride(sq: int) -> int:
    """The row stride of the lse and D rows the backward kernels read: Sq
    rounded up to 4 f32, since a TMA tensor map needs its strides in
    multiples of 16 bytes."""
    return -(-sq // 4) * 4


def _tma_rows(x: torch.Tensor) -> torch.Tensor:
    """``x [..., Sq]`` (lse or D ``[B, Hq, Sq]``, segment ids ``[B, Sq]``)
    with its rows padded to :func:`_tma_row_stride` (a copy only when Sq
    is not a multiple of 4; the kernels never read the padding)."""
    pad = _tma_row_stride(x.shape[-1]) - x.shape[-1]
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
              causal: bool, scale: float,
              segment_ids: Optional[torch.Tensor] = None,
              segment_ids_kv: Optional[torch.Tensor] = None,
              grads_f32: bool = False):
    """Flash attention backward: ``(dq, dk, dv)`` in the layouts of q, k
    and v, in their dtypes or, with ``grads_f32``, in f32, from the
    forward's ``out`` and ``lse [B, Hq, Sq]`` and the output gradient
    ``dout`` (with the forward's ``segment_ids`` and ``segment_ids_kv``,
    if any). ``out`` is the one D = rowsum(dO O) is taken from: ring
    attention passes the merged output and lse of the whole ring, not
    this block's. On a CUDA tensor this computes D (:func:`compute_dd`)
    and launches ``csrc/flash_bwd.cu``'s dq and dk/dv kernels (bf16, D in
    KERNEL_HEAD_DIMS, causal and segment ids only with Sq == Sk) or
    raises; on a CPU tensor it runs the plain version."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, out, lse, dout, causal, scale,
                               segment_ids, segment_ids_kv, grads_f32)
    _check_kernel_shapes("flash_bwd", q, k, v, causal)
    seg, seg_kv = _segment_pair(segment_ids, segment_ids_kv, q, k.shape[1])
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if tuple(out.shape) != tuple(q.shape) or tuple(dout.shape) != tuple(q.shape):
        raise ValueError(f"flash_bwd: out{tuple(out.shape)} and "
                         f"dout{tuple(dout.shape)} must match q{tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)):
        _check_bhsd(name, x)
    dd = compute_dd(out, dout)
    _check_rows("flash_bwd: lse", lse, (b, hq, sq), q.device)
    lse, dd, row_stride = _tma_rows(lse), _tma_rows(dd), _tma_row_stride(sq)
    gdt = {"dtype": torch.float32} if grads_f32 else {}
    dq = torch.empty_like(q, **gdt)
    dk = torch.empty_like(k, **gdt)
    dv = torch.empty_like(v, **gdt)
    _launch("flash_bwd", "k8s_flash_bwd_dq_bf16", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dd.data_ptr(), _ptr(seg), _ptr(seg_kv),
            dq.data_ptr(), b, sq, sk, hq, hkv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *dout.stride()[:3], *dq.stride()[:3], row_stride,
            float(scale), int(bool(causal)), int(bool(grads_f32)))
    with _COUNT_LOCK:
        flash_bwd.launches_dq += 1
    _launch("flash_bwd", "k8s_flash_bwd_dkv_bf16", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dd.data_ptr(), _ptr(seg), _ptr(seg_kv),
            dk.data_ptr(), dv.data_ptr(), b, sq, sk, hq, hkv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *dout.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
            row_stride, float(scale), int(bool(causal)), int(bool(grads_f32)))
    with _COUNT_LOCK:
        flash_bwd.launches_dkv += 1
        flash_bwd.launches_grads_f32 += bool(grads_f32)
    return dq, dk, dv


flash_bwd.launches_dq = 0
flash_bwd.launches_dkv = 0
flash_bwd.launches_grads_f32 = 0


@torch.library.custom_op("k8s_tpu_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              segment_ids: Optional[torch.Tensor], causal: bool,
              scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward as one dispatcher-visible op: ``(out, lse)``."""
    return flash_fwd(q, k, v, causal, scale, with_lse=True,
                     segment_ids=segment_ids)


@_flash_op.register_fake
def _(q, k, v, segment_ids, causal, scale):
    b, sq, hq, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((b, hq, sq), dtype=torch.float32))


def _flash_op_setup(ctx, inputs, output):
    q, k, v, segment_ids, causal, scale = inputs
    out, lse = output
    # segment ids are a non-differentiable input, kept for the backward
    ctx.save_for_backward(q, k, v, out, lse, segment_ids)
    ctx.causal, ctx.scale = causal, scale


def _flash_op_backward(ctx, dout, _dlse):
    q, k, v, out, lse, segment_ids = ctx.saved_tensors
    dq, dk, dv = flash_bwd(q, k, v, out, lse, dout.contiguous(), ctx.causal,
                           ctx.scale, segment_ids)
    return dq, dk, dv, None, None, None


_flash_op.register_autograd(_flash_op_backward, setup_context=_flash_op_setup)

#: the op the ``flash`` remat policy saves the outputs of
FLASH_OP = torch.ops.k8s_tpu_torch.flash_attention.default


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool, scale: float,
                           segment_ids: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Differentiable flash attention through the kernels: the forward
    (:func:`flash_fwd`, which also writes lse) and, under autograd,
    :func:`flash_bwd` from the saved q, k, v, ``out``, ``lse`` and
    ``segment_ids``. On CPU tensors both run their plain versions (the
    CPU tests use that)."""
    out, _ = _flash_op(q, k, v, segment_ids, bool(causal), float(scale))
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention, [B, S, H, D] layout, GQA-aware,
    differentiable.

    ``segment_ids`` ([B, S] int, self-attention) mask attention across
    segment boundaries: key j is visible to query i iff their ids match
    (composed with causal). They cover padding (1 real, 0 pad) and packed
    sequences; outputs at rows with no visible key are garbage.

    The gate, re-derived for CUDA from the JAX one: CPU tensors take
    :func:`mha_reference` (under autograd, as the JAX package's off-TPU
    path). On CUDA tensors a head dim that is not a multiple of 64 takes
    :func:`mha_reference` too — the JAX gate's ``d % 64`` sends it to the
    XLA path, off every Pallas kernel — a choice by shape made before any
    launch; every other call takes the kernels:
    :func:`flash_attention_kernel` (K1 forward, K2 and K3 backward) under
    autograd, K1 alone (:func:`flash_fwd`) for inference. They serve bf16
    at a head dim they are built for (KERNEL_HEAD_DIMS), and causal only
    when ``sq == sk`` (their mask has no diagonal offset); anything else
    — another dtype, a multiple of 64 with no instance (192, 256) —
    raises rather than running the plain path there. The TPU's Mosaic
    128-alignment and block-fitting conditions are gone: the kernels mask
    their own ragged tail.
    """
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if segment_ids is not None and sq != sk:
        raise ValueError(
            f"segment_ids requires self-attention lengths, got sq={sq} "
            f"sk={sk}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu" or d % 64:
        return mha_reference(q, k, v, causal, scale, segment_ids=segment_ids)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return flash_attention_kernel(q, k, v, causal, scale, segment_ids)
    # inference: no lse to keep
    return flash_fwd(q, k, v, causal, scale, segment_ids=segment_ids)


def _split_extents(mesh, batch_axes, head_axis) -> Tuple[int, int]:
    """(batch extent, head extent) of ``mesh`` for these axes."""
    from k8s_tpu_torch.parallel.mesh import mesh_shape

    sizes = mesh_shape(mesh)
    batch_shard = 1
    for ax in (batch_axes if isinstance(batch_axes, tuple) else (batch_axes,)):
        batch_shard *= sizes.get(ax, 1)
    return batch_shard, sizes.get(head_axis, 1)


def check_sharded_split(b: int, hq: int, hkv: int, mesh,
                        batch_axes=("data", "fsdp"),
                        head_axis: str = "tensor") -> None:
    """The JAX ``flash_attention_sharded``'s up-front checks on the
    GLOBAL batch and head counts: the batch must divide over
    ``batch_axes`` and both head counts over ``head_axis`` (so every GQA
    group stays whole on one rank), with the JAX messages."""
    batch_shard, head_shard = _split_extents(mesh, batch_axes, head_axis)
    if b % batch_shard:
        raise ValueError(
            f"flash_attention_sharded: batch {b} not divisible by the "
            f"{batch_axes} mesh extent {batch_shard}")
    if hq % head_shard or hkv % head_shard:
        raise ValueError(
            f"flash_attention_sharded: heads {hq}/kv_heads {hkv} not "
            f"divisible by mesh axis '{head_axis}'={head_shard} (cap the "
            "TP degree to the head counts, cf. bert_train.tp_layout)")


def flash_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            mesh, causal: bool = True,
                            scale: Optional[float] = None,
                            segment_ids: Optional[torch.Tensor] = None,
                            batch_axes=("data", "fsdp"),
                            head_axis: str = "tensor",
                            global_heads: Optional[Tuple[int, int]] = None
                            ) -> torch.Tensor:
    """Flash attention on this rank's block of a batch split over
    ``batch_axes`` and heads split over ``head_axis`` — the body of the
    JAX function's ``shard_map``, which in SPMD PyTorch every rank runs
    on what it holds: q ``[B/(data·fsdp), S, Hq/t, D]``, k/v ``[..., Hkv/t,
    D]``, out like q. The split is contiguous, so query head h of a rank
    reads its kv head h // G on the rank, as it would on one device. On
    the card it is :func:`flash_attention` (K1, and K2/K3 under
    autograd) on the local block; sequence stays whole (the ``seq`` axis
    is ring/Ulysses attention's).

    Raises the JAX function's divisibility errors for the global batch
    (the local one times the batch extent) and the global head counts
    ``global_heads`` (default: the local ones times the head extent),
    and :func:`flash_attention`'s own for a local block the kernels do
    not take."""
    batch_shard, head_shard = _split_extents(mesh, batch_axes, head_axis)
    hq, hkv = global_heads if global_heads is not None else (
        q.shape[2] * head_shard, k.shape[2] * head_shard)
    check_sharded_split(q.shape[0] * batch_shard, hq, hkv, mesh, batch_axes,
                        head_axis)
    if (q.shape[2] * head_shard, k.shape[2] * head_shard) != (hq, hkv):
        raise ValueError(
            f"flash_attention_sharded: local heads {q.shape[2]}/"
            f"{k.shape[2]} are not this rank's 1/{head_shard} of {hq}/{hkv}")
    return flash_attention(q, k, v, causal=causal, scale=scale,
                           segment_ids=segment_ids)


# ---------------------------------------------------------------------------
# Fused single-token decode attention (+ in-place KV-cache append)
# ---------------------------------------------------------------------------


# The decode kernels split each (batch, kv head)'s cache rows into
# blocks of one of these lengths, so that the deepest slot no longer sets
# the time alone (csrc/decode_attn.cu, csrc/decode_attn_q8.cu)
DECODE_SPLIT_ROWS = (128, 256, 512, 1024)
# the longest split that still makes this many blocks (b * hkv * splits);
# else the shortest. On an H100 (132 SMs), K4 at B 8, S 2048: C 256 (512
# blocks) 0.0166 ms against 0.0205 for C 128 and 0.0245 for C 512; K5 at
# B 16, S 8192: C 1024 (1024 blocks) 0.090 against 0.105 for C 512
# (PERF.md)
DECODE_MIN_BLOCKS = 512


def _decode_split_rows(b: int, hkv: int, s: int) -> int:
    """The split length C of the decode kernels' grid ``(ceil(s / C), hkv,
    b)``: the longest of :data:`DECODE_SPLIT_ROWS` whose grid has at
    least :data:`DECODE_MIN_BLOCKS` blocks, else the shortest. It reads
    the cache's shape only, never ``pos``, so the step needs no host
    sync and the grid is fixed for a given cache (capturable)."""
    for rows in reversed(DECODE_SPLIT_ROWS):
        if b * hkv * -(-s // rows) >= DECODE_MIN_BLOCKS:
            return rows
    return DECODE_SPLIT_ROWS[0]


def _decode_workspace(q: torch.Tensor, hkv: int, s: int, split_rows):
    """``(C, partial outputs [B, Hkv, splits, G, D] f32, their lse [B, Hkv,
    splits, G] f32)`` for one decode kernel call: C from
    :func:`_decode_split_rows` unless ``split_rows`` forces one."""
    b, hq, d = q.shape
    rows = _decode_split_rows(b, hkv, s) if split_rows is None else split_rows
    if rows not in DECODE_SPLIT_ROWS:
        raise ValueError(f"split_rows {rows} not in {DECODE_SPLIT_ROWS}")
    splits = -(-s // rows)
    part_o = torch.empty((b, hkv, splits, hq // hkv, d), dtype=torch.float32,
                         device=q.device)
    part_lse = torch.empty((b, hkv, splits, hq // hkv), dtype=torch.float32,
                           device=q.device)
    return rows, part_o, part_lse


def _pos_vector(pos, b: int, device) -> torch.Tensor:
    """Normalize a decode append index to a [B] int32 vector on
    ``device``: scalars broadcast (uniform batch), [B] vectors pass
    through (ragged batch — per-row cache depths)."""
    v = torch.as_tensor(pos, dtype=torch.int32, device=device).reshape(-1)
    if v.numel() == 1:
        return v.expand(b).contiguous()
    if v.numel() != b:
        raise ValueError(
            f"pos must be scalar or [batch]={b}, got shape {tuple(v.shape)}")
    return v.contiguous()


def decode_attention_plain(q, k_new, v_new, k_cache, v_cache,
                           pos: torch.Tensor, scale: float) -> torch.Tensor:
    """The decode kernel's plain version (same contract, f32 math):
    attention of the G grouped queries over ``cache[b, :, :pos[b]]`` plus
    the new token, then the new row written at ``pos[b]`` in place."""
    b, hq, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    qf = q.float().reshape(b, hkv, hq // hkv, d) * scale
    s_cache = torch.einsum("bhgd,bhkd->bhgk", qf, k_cache.float())
    visible = torch.arange(s, device=q.device)[None, :] < pos[:, None].long()
    s_cache = s_cache.masked_fill(~visible[:, None, None, :], NEG_INF)
    s_new = (qf * k_new.float()[:, :, None]).sum(-1, keepdim=True)
    m = torch.maximum(s_cache.amax(-1, keepdim=True), s_new)
    p_cache = torch.exp(s_cache - m)
    p_new = torch.exp(s_new - m)
    l = p_cache.sum(-1, keepdim=True) + p_new
    acc = torch.einsum("bhgk,bhkd->bhgd", p_cache, v_cache.float())
    acc = acc + p_new * v_new.float()[:, :, None]
    out = (acc / l).reshape(b, hq, d).to(q.dtype)
    rows = torch.arange(b, device=q.device)
    k_cache[rows, :, pos.long()] = k_new.to(k_cache.dtype)
    v_cache[rows, :, pos.long()] = v_new.to(v_cache.dtype)
    return out


def decode_attention_update(q: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, pos,
                            scale: Optional[float] = None,
                            split_rows: Optional[int] = None):
    """Fused single-token decode attention with IN-PLACE cache append.

    q [B, Hq, D], k_new/v_new [B, Hkv, D], caches head-major [B, Hkv, S,
    D]; ``pos`` a scalar (uniform batch) or a [B] vector (ragged batch:
    row b attends over ``cache[b, :, :pos[b]]`` and appends at
    ``pos[b]``). Returns ``(out [B, Hq, D], k_cache, v_cache)`` — the
    SAME cache tensors, written at row ``pos[b]``. The new token's term
    comes from ``k_new``/``v_new``, so the row being written is never
    read. On a CUDA tensor this launches ``csrc/decode_attn.cu`` (its
    split kernel over blocks of ``split_rows`` cache rows — None takes
    :func:`_decode_split_rows`'s choice — then its merge) or raises; on
    a CPU tensor it runs the plain version."""
    b, hq, d = q.shape
    _, hkv, s, _ = k_cache.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    pos_v = _pos_vector(pos, b, q.device)
    if q.device.type == "cpu":
        out = decode_attention_plain(q, k_new, v_new, k_cache, v_cache,
                                     pos_v, scale)
        return out, k_cache, v_cache
    tensors = (("q", q), ("k_new", k_new), ("v_new", v_new),
               ("k_cache", k_cache), ("v_cache", v_cache))
    for name, x in tensors:
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"decode_attention_update: {name} must be on "
                             f"{q.device}")
        if x.dtype != torch.bfloat16 or not x.is_contiguous():
            raise ValueError(f"decode_attention_update: {name} must be "
                             f"contiguous bfloat16, got {x.dtype}")
    groups = hq // hkv
    if (d not in DECODE_HEAD_DIMS or hq % hkv or groups not in DECODE_GROUPS
            or tuple(k_new.shape) != (b, hkv, d)
            or v_new.shape != k_new.shape or v_cache.shape != k_cache.shape):
        raise ValueError(
            f"decode_attention_update: unsupported shapes q{tuple(q.shape)} "
            f"k_new{tuple(k_new.shape)} cache{tuple(k_cache.shape)}")
    rows, part_o, part_lse = _decode_workspace(q, hkv, s, split_rows)
    out = torch.empty_like(q)
    _launch("decode_attn", "k8s_decode_attn_bf16", q.device,
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), pos_v.data_ptr(),
            part_o.data_ptr(), part_lse.data_ptr(), out.data_ptr(),
            b, hkv, groups, s, d, rows, float(scale))
    decode_attention_update.launches += 1
    return out, k_cache, v_cache


decode_attention_update.launches = 0


# ---------------------------------------------------------------------------
# int8 KV cache: row quantizer and the int8-KV decode step
# ---------------------------------------------------------------------------


# The JAX package writes ``amax / 127.0``; XLA compiles that divide by a
# constant as a multiply by the f32 reciprocal — in every jitted path of
# the package (its engine, its generate) and in its interpreted Pallas
# kernel — while ``x / scale`` stays an IEEE divide. The port computes
# both the way the compiled reference does, so its int8 rows and scales
# are bit-identical to the JAX package's as it serves.
INV_127 = 1.0 / 127.0


def quantize_kv_rows(x: torch.Tensor):
    """Per-row symmetric int8 for KV-cache storage: x [..., D] -> (int8
    [..., D], f32 scales [...]). Bit-exact with the JAX package's
    quantizer as XLA compiles it: f32 amax over D clamped at 1e-6, times
    the f32 reciprocal of 127, then ``x / scale`` (an IEEE divide)
    rounded half to even. The prefill writes use it; the decode kernel
    quantizes its own appends the same way."""
    xf = x.float()
    s8 = xf.abs().amax(dim=-1).clamp_min(1e-6) * INV_127
    return torch.round(xf / s8[..., None]).to(torch.int8), s8


def decode_attention_q8_plain(q, k_new, v_new, k_cache, v_cache, k_scale,
                              v_scale, pos: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """The int8-KV decode kernel's plain version (same contract, f32
    math): scores ``(scale q) . k_int8`` times the row's key scale over
    ``cache[b, :, :pos[b]]``, the new token's term from the exact
    ``k_new``/``v_new``, probs times the row's value scale before the PV
    product; then the new row is quantized (:func:`quantize_kv_rows`) and
    written with its scales at ``pos[b]`` in place."""
    b, hq, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    qf = q.float().reshape(b, hkv, hq // hkv, d) * scale
    s_cache = torch.einsum("bhgd,bhkd->bhgk", qf, k_cache.float())
    s_cache = s_cache * k_scale[:, :, None, :]
    visible = torch.arange(s, device=q.device)[None, :] < pos[:, None].long()
    s_cache = s_cache.masked_fill(~visible[:, None, None, :], NEG_INF)
    s_new = (qf * k_new.float()[:, :, None]).sum(-1, keepdim=True)
    m = torch.maximum(s_cache.amax(-1, keepdim=True), s_new)
    p_cache = torch.exp(s_cache - m)
    p_new = torch.exp(s_new - m)
    l = p_cache.sum(-1, keepdim=True) + p_new
    acc = torch.einsum("bhgk,bhkd->bhgd", p_cache * v_scale[:, :, None, :],
                       v_cache.float())
    acc = acc + p_new * v_new.float()[:, :, None]
    out = (acc / l).reshape(b, hq, d).to(q.dtype)
    rows = torch.arange(b, device=q.device)
    for cache, sc, new in ((k_cache, k_scale, k_new), (v_cache, v_scale, v_new)):
        qrow, srow = quantize_kv_rows(new)
        cache[rows, :, pos.long()] = qrow
        sc[rows, :, pos.long()] = srow
    return out


def decode_attention_update_q8(q: torch.Tensor, k_new: torch.Tensor,
                               v_new: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, k_scale: torch.Tensor,
                               v_scale: torch.Tensor, pos,
                               scale: Optional[float] = None,
                               split_rows: Optional[int] = None):
    """int8-KV fused decode step with IN-PLACE append.

    q [B, Hq, D] and k_new/v_new [B, Hkv, D] bf16; caches int8 [B, Hkv,
    S, D] with per-row f32 scales ``[B, Hkv, S]`` (the JAX package keeps
    ``[B, Hkv, 1, S]``, a Mosaic layout); ``pos`` scalar or [B]. Returns
    ``(out [B, Hq, D], k_cache, v_cache, k_scale, v_scale)`` — the SAME
    tensors, written at row ``pos[b]`` only (the new row quantized:
    amax / 127, round half to even). On a CUDA tensor this launches
    ``csrc/decode_attn_q8.cu`` (split and merge, as
    :func:`decode_attention_update`) or raises; on a CPU tensor it runs
    the plain version."""
    b, hq, d = q.shape
    _, hkv, s, _ = k_cache.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    pos_v = _pos_vector(pos, b, q.device)
    if q.device.type == "cpu":
        out = decode_attention_q8_plain(q, k_new, v_new, k_cache, v_cache,
                                        k_scale, v_scale, pos_v, scale)
        return out, k_cache, v_cache, k_scale, v_scale
    dtypes = (("q", q, torch.bfloat16), ("k_new", k_new, torch.bfloat16),
              ("v_new", v_new, torch.bfloat16), ("k_cache", k_cache, torch.int8),
              ("v_cache", v_cache, torch.int8), ("k_scale", k_scale, torch.float32),
              ("v_scale", v_scale, torch.float32))
    for name, x, dt in dtypes:
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"decode_attention_update_q8: {name} must be on "
                             f"{q.device}")
        if x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"decode_attention_update_q8: {name} must be "
                             f"contiguous {dt}, got {x.dtype}")
    groups = hq // hkv
    if (d not in DECODE_HEAD_DIMS or hq % hkv or groups not in DECODE_GROUPS
            or tuple(k_new.shape) != (b, hkv, d)
            or v_new.shape != k_new.shape or v_cache.shape != k_cache.shape
            or tuple(k_scale.shape) != (b, hkv, s)
            or v_scale.shape != k_scale.shape):
        raise ValueError(
            f"decode_attention_update_q8: unsupported shapes q{tuple(q.shape)} "
            f"k_new{tuple(k_new.shape)} cache{tuple(k_cache.shape)} "
            f"scales{tuple(k_scale.shape)}")
    rows, part_o, part_lse = _decode_workspace(q, hkv, s, split_rows)
    out = torch.empty_like(q)
    _launch("decode_attn_q8", "k8s_decode_attn_q8", q.device,
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), pos_v.data_ptr(), part_o.data_ptr(),
            part_lse.data_ptr(), out.data_ptr(),
            b, hkv, groups, s, d, rows, float(scale))
    decode_attention_update_q8.launches += 1
    return out, k_cache, v_cache, k_scale, v_scale


decode_attention_update_q8.launches = 0
