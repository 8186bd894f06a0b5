"""Continuous-batching serving engine (port of the core of
``k8s_tpu/serving/engine.py``).

Slot-based ragged batching, as in the JAX package:

- ONE static decode batch of ``max_slots`` rows. Every row ("slot")
  holds one in-flight request at its own cache depth; the ragged decode
  kernel appends and attends at a per-row position, so one launch per
  layer serves all slots however ragged they are.
- A free slot is filled by prefill. A prompt that fits one chunk is
  prefilled one-shot straight into its slot's rows of the big cache
  (a fresh batch-1 view, so attention rides the flash kernel). A longer
  prompt prefills in bounded CHUNKS into a staged batch-1 working
  cache and is copied into its slot when the last chunk lands. A token
  budget (``max_tokens_per_round``) caps prefill tokens per round after
  decode rows claim theirs, so a long prompt never parks decode behind
  more than one bounded chunk.
- Decode runs in chunks of K steps. EOS, budget and cache-full
  deactivation happen ON THE DEVICE; the host fetches one packed int32
  array per chunk. On a CUDA device the chunk is ONE CUDA graph per
  engine (the port's counterpart of the JAX package's jit over K
  steps): the engine's first chunk runs eagerly, which builds the
  kernels and creates the libraries' handles and workspaces, then the
  chunk is captured over the engine's fixed state tensors and every
  later chunk replays it. A failed capture or replay raises; nothing
  falls back to the eager chunk on the card. The CPU runs every chunk
  eagerly.
- The pump keeps ``pipeline_depth`` chunks in flight (default 2):
  dispatch enqueues a chunk and a non-blocking copy of its packed
  array into pinned host memory; harvester threads own the only
  blocking wait; attribution runs in dispatch order through the
  slot→request snapshot taken at dispatch, since a slot may have been
  refilled since.

Inactive slots still compute (static shapes): a frozen slot decodes at
``min(length, max_seq - 1)`` and writes its garbage row there, masked
until the slot's next occupant overwrites it. Every cache write is in
place on the engine's one cache tensor per layer. With an int8 KV cache
(``kv_quant="int8"``) the big cache and every staged working cache
carry their per-row scales (:class:`~k8s_tpu_torch.models.KVCache`),
and the slot views and the working-cache copy take them along, as the
JAX engine's scale leaves are scattered with the rows.

Prefill stays eager, on the stream the chunks run on, so it is ordered
after the chunks in flight and writes the same state and cache tensors
in place.

Two single-replica features ride on chunked prefill and the warm-cache
continuation path, as in the JAX engine:

- The shared-prefix cache (``prefix_cache_tokens``): the staged working
  cache at a prompt's prefix boundary is cloned into an LRU keyed by the
  prefix's exact tokens; a later prompt with that prefix seeds the
  working cache with a copy and resumes chunking at the boundary. The
  snapshots move between replicas (either package's) through
  :meth:`ContinuousBatchingEngine.export_prefix` /
  :meth:`~ContinuousBatchingEngine.install_prefix` and the wire of
  :mod:`k8s_tpu_torch.serving.kv_transfer`, in the JAX cache tree's leaf
  order and shapes.
- Self-speculative decode (``spec_decode_k``, greedy only): an n-gram
  drafter proposes up to K tokens per slot and ONE forward over ``[B,
  K+1]`` verifies them (on the card a CUDA graph of that forward after
  the first round); the pump then runs one synchronous round at a time,
  and a slot within K + 1 rows of the cache end makes the round a plain
  decode chunk (the decode chunk's graph replay on the card).

The disaggregation and migration entry points (``submit_prefill``,
``submit_with_kv``, ``export_slot``) come in a later slice. Oracle for
correctness: each request's tokens equal a solo
:func:`k8s_tpu_torch.models.generate` run (and the JAX engine's) with the
same weights.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import itertools
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from k8s_tpu_torch.models.llama import KVCache, LlamaForCausalLM, _pick_token
from k8s_tpu_torch.ops import attention as _attention
from k8s_tpu_torch.serving.kv_transfer import as_torch


@dataclasses.dataclass
class Request:
    """One generation request. ``tokens`` accumulates the output
    (first token from prefill + decoded tokens, prompt excluded)."""

    rid: int
    prompt: np.ndarray  # [plen] int32
    max_new_tokens: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    submitted_at: float = 0.0    # time.perf_counter at submit()
    finished_at: float = 0.0     # ... at attribution of the last token
    first_token_at: float = 0.0  # ... at attribution of the first token
    # ... when the scheduler picked this request up (left the admission
    # queue): splits TTFT into engine-queue vs prefill
    prefill_start_at: float = 0.0
    prefill_done: int = 0        # real prompt tokens prefilled so far
    # (attribution time, tokens attributed) per chunk that delivered
    # tokens: the raw material of TTFT and inter-token percentiles
    token_times: List = dataclasses.field(default_factory=list)


def _next_chunk(chunk_buckets: Sequence[int], offset: int, plen: int,
                allowed: int, max_seq: int):
    """Plan ONE prefill chunk for a prompt with ``offset`` tokens
    already written: returns ``(bucket, take, final)`` or None when no
    chunk fits the ``allowed`` token budget this round.

    Invariants (validated at engine init): every bucket is a multiple
    of the smallest bucket g, and ``max_seq % g == 0`` for admissible
    prompts — so an in-range bucket always exists once ``allowed >= g``,
    and a chunk's write ``offset + bucket`` never exceeds ``max_seq``.

    Intermediate chunks are always FULL (take == bucket): the working
    cache's write offset then equals the count of real tokens, and
    only the final chunk pads (pad rows land above the prompt where
    they stay masked until decode overwrites them)."""
    r = plen - offset
    fin = [b for b in chunk_buckets
           if r <= b <= allowed and offset + b <= max_seq]
    if fin:
        return min(fin), r, True
    full = [b for b in chunk_buckets
            if b <= min(allowed, r) and offset + b <= max_seq]
    if not full:
        return None
    return max(full), max(full), False


@torch.no_grad()
def _prefill_insert(model: LlamaForCausalLM, cache: KVCache, slot: int,
                    prompt_pb: torch.Tensor, plen: int, generator,
                    temperature: float) -> torch.Tensor:
    """Batch-1 one-shot prefill of a padded prompt straight into rows
    ``[0, plen_b)`` of ``slot`` (a fresh view of the big cache: flash
    attention over the prompt). Returns the first token (a device
    scalar). Pads sit after the real tokens, so causal attention keeps
    them out of the real rows; the head runs on row ``plen - 1`` only."""
    plen_b = prompt_pb.shape[1]
    positions = torch.arange(plen_b, device=prompt_pb.device)[None]
    hidden, _ = model(prompt_pb, positions=positions,
                      cache=cache.slot(slot, fresh=True), return_hidden=True)
    logits = model.lm_head_logits(hidden[0, plen - 1][None])
    return _pick_token(logits, generator, temperature)[0]


@torch.no_grad()
def _prefill_chunk(model: LlamaForCausalLM, pcache: KVCache,
                   ids_pb: torch.Tensor, offset: int, last_idx: int,
                   generator, temperature: float,
                   final: bool) -> Optional[torch.Tensor]:
    """One chunked-prefill step into the batch-1 working cache: writes
    rows ``[offset, offset + chunk_b)`` through the model's ragged
    continuation path (the per-row position mask keeps the chunk causal
    against rows < offset; stale rows above stay invisible). Only the
    ``final`` chunk runs the lm_head, on the last REAL token's row."""
    chunk_b = ids_pb.shape[1]
    positions = offset + torch.arange(chunk_b, device=ids_pb.device)[None]
    hidden, _ = model(ids_pb, positions=positions, cache=pcache,
                      return_hidden=True)
    if not final:
        return None
    logits = model.lm_head_logits(hidden[0, last_idx][None])
    return _pick_token(logits, generator, temperature)[0]


@torch.no_grad()
def _decode_chunk(model: LlamaForCausalLM, cache: KVCache, tok, lengths,
                  active, budget, generator, *, n_steps: int,
                  temperature: float, eos_id: Optional[int]):
    """K ragged decode steps. Per step every slot advances iff active;
    EOS/budget/cache-full deactivation happens on the device.

    Returns ``(tok, lengths, active, budget, packed)`` where ``packed``
    is ONE int32 tensor [2K+4, B], the only thing the host fetches:

    - row 0: the chunk's INPUT tokens (how a freshly-prefilled slot's
      first token reaches the host without its own transfer)
    - rows 1..K: emitted tokens per step
    - rows K+1..2K: validity (1 = slot was active at step entry)
    - rows 2K+1..2K+3: final active / budget / lengths"""
    max_seq = model.config.max_seq_len
    tok_in = tok
    toks, valid = [], []
    for _ in range(n_steps):
        pos = torch.clamp(lengths, max=max_seq - 1)
        logits, _ = model(tok[:, None], positions=pos[:, None], cache=cache)
        nxt = _pick_token(logits[:, -1], generator, temperature)
        emitted_by = active
        nxt = torch.where(active, nxt, tok)  # freeze inactive slots
        budget = torch.where(active, budget - 1, budget)
        lengths = torch.where(active, torch.clamp(lengths + 1, max=max_seq),
                              lengths)
        active = active & (budget > 0) & (lengths < max_seq)
        if eos_id is not None:
            active = active & ~((nxt == eos_id) & emitted_by)
        toks.append(nxt)
        valid.append(emitted_by)
        tok = nxt
    packed = torch.cat([
        tok_in[None], torch.stack(toks), torch.stack(valid).to(torch.int32),
        active.to(torch.int32)[None], budget[None], lengths[None],
    ], dim=0)
    return tok, lengths, active, budget, packed


@torch.no_grad()
def _verify_chunk(model: LlamaForCausalLM, cache: KVCache, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """Self-speculative decode's verify step: ONE ragged forward over
    ``x`` [B, K+1] (per row the last token, then its drafts) at per-row
    positions ``lengths + arange(K+1)``, through the warm-cache
    continuation path (the chunked-prefill machinery): it writes the K+1
    KV rows at each row's own offset and masks causally per row, so the
    greedy tokens [B, K+1] are what sequential decode would emit after
    ``x[:, :j+1]``. Rejected drafts' rows sit above the accepted length,
    hidden by the position mask until decode overwrites them."""
    logits, _ = model(x, positions=positions, cache=cache)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _ngram_draft(ctx: np.ndarray, k: int, n: int) -> np.ndarray:
    """Prompt-lookup drafting: the up-to-``k`` tokens that followed the
    most recent PREVIOUS occurrence of the context's trailing ``n``-gram,
    or an empty draft (the verify step then is one plain greedy step)."""
    size = int(ctx.size)
    if size <= n:
        return ctx[:0]
    tail = ctx[size - n:]
    # one vectorized comparison over every window ending before the tail
    wins = np.lib.stride_tricks.sliding_window_view(ctx, n)[:size - n]
    hits = np.nonzero((wins == tail).all(axis=1))[0]
    if hits.size == 0:
        return ctx[:0]
    s = int(hits[-1])
    return ctx[s + n:s + n + k]


def jax_cache_leaves(cache: KVCache) -> List[torch.Tensor]:
    """Views of ``cache``'s tensors as the JAX engine's cache tree
    flattens: modules in string order (``layer_0, layer_1, layer_10, …,
    layer_2, …``), in each ``cached_key``, ``cached_value``, then with
    an int8 cache ``key_scale``, ``value_scale``; keys and values ``[B,
    Hkv, S, D]`` and scales ``[B, Hkv, 1, S]`` (the port keeps ``[B, Hkv,
    S]``). The wire carries no tree, so an exchanged snapshot must use
    this order and these shapes. Writing into a view writes the cache."""
    out: List[torch.Tensor] = []
    for i in sorted(range(len(cache.keys)), key=lambda i: f"layer_{i}"):
        out += [cache.keys[i], cache.values[i]]
        if cache.key_scales is not None:
            out += [cache.key_scales[i].unsqueeze(2),
                    cache.value_scales[i].unsqueeze(2)]
    return out


# One capture stream per device, shared by every engine on it, as
# torch.cuda.graph keeps one: PyTorch keeps a cuBLAS workspace per
# stream for the life of the process, so a stream per engine would leave
# one behind per engine. The lock keeps two engines from running their
# eager first chunk or capturing on it at once.
_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}
_CAPTURE_LOCK = threading.Lock()


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The capture stream of ``device`` (call with _CAPTURE_LOCK held)."""
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


def _launch_counts() -> Dict[str, int]:
    """The decode path's kernel wrappers' launch counters."""
    return {"flash_fwd": _attention.flash_fwd.launches,
            "decode_attn": _attention.decode_attention_update.launches,
            "decode_attn_q8": _attention.decode_attention_update_q8.launches}


class _HostCopy:
    """A chunk's packed array on its way to the host. On the card: a
    non-blocking copy into a pinned host buffer, then an event recorded
    after it on the current stream; on the CPU a clone. :meth:`fetch`
    is the one blocking wait, and returns the array as numpy."""

    __slots__ = ("buf", "event")

    def __init__(self, packed: torch.Tensor,
                 pinned: Optional[torch.Tensor] = None):
        if pinned is None:
            self.buf, self.event = packed.clone(), None
            return
        self.buf = pinned.copy_(packed, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(packed.device))

    def fetch(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.buf.numpy().copy()


def _harvest_loop(fetchq: "queue.Queue", readyq: "queue.Queue") -> None:
    """Harvester thread: waits for chunks' packed arrays on the host, off
    the dispatch path; attribution stays in the pump thread. A failed
    fetch (a CUDA error surfaces at the wait) is shipped to the pump as
    an error item, since a dead harvester would deadlock the engine."""
    while True:
        item = fetchq.get()
        if item is None:
            return
        seq, handle, fills, snapshot, t0 = item
        try:
            readyq.put((seq, handle.fetch(), fills, snapshot, t0))
        except Exception as e:  # noqa: BLE001 - crossing threads
            readyq.put((seq, e, fills, snapshot, t0))


class ContinuousBatchingEngine:
    """Slot-based continuous batching over a ragged-decode model.

    Parameters mirror the JAX engine's: ``max_slots`` (static decode
    batch width), ``prompt_buckets`` (static prefill lengths; chunk
    shapes are the buckets <= ``prefill_chunk``), ``decode_chunk``
    (decode steps per host fetch and per scheduling round),
    ``chunked_prefill`` (False: legacy one-shot prefill of the whole
    prompt, capped at the largest bucket), ``max_tokens_per_round``
    (default ``prefill_chunk + max_slots * decode_chunk``),
    ``pipeline_depth`` (decode chunks in flight ahead of attribution,
    default 2, at least 1) and ``temperature``/``eos_id``. ``seed``
    seeds the engine's ``torch.Generator`` (sampling only). The engine
    runs on the model's device.

    On a CUDA device a sampling engine (``temperature > 0``) registers
    its generator with the graph, so every replay draws fresh samples.
    ``stats["graph_replays"]`` counts replays and :attr:`graph_launches`
    holds the kernel launches one capture recorded (each replay runs
    them again; the wrappers' counters tick only while capturing).

    ``prefix_cache_tokens`` (> 0, chunked prefill only; 0 = off): cache
    the working-cache KV of each distinct prompt prefix of this many
    tokens (rounded DOWN to the smallest chunk bucket), keyed by its
    exact tokens, in an LRU of ``prefix_cache_max`` snapshots (each a
    stage-sized batch-1 cache, counted in ``stats["prefix_cache_bytes"]``).
    ``spec_decode_k`` (> 0, temperature 0 only): self-speculative decode
    with up to this many n-gram drafts per round (``spec_ngram``, default
    2, the matched suffix length); the pump then runs synchronously, one
    verify round (or one plain chunk near the cache end) per step.

    Thread safety: :meth:`submit`, :meth:`queue_depth`,
    :meth:`pop_finished` and the prefix directory (:meth:`prefix_keys`,
    :meth:`has_prefix`, :meth:`export_prefix`, :meth:`install_prefix`)
    may be called from any thread; :meth:`step` (and :meth:`run`) from
    one pump thread.
    """

    def __init__(
        self,
        model: LlamaForCausalLM,
        *,
        max_slots: int = 8,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
        decode_chunk: int = 32,
        prompt_buckets: Optional[Sequence[int]] = None,
        seed: int = 0,
        chunked_prefill: bool = True,
        prefill_chunk: int = 256,
        max_tokens_per_round: Optional[int] = None,
        pipeline_depth: int = 2,
        prefix_cache_tokens: int = 0,
        prefix_cache_max: int = 8,
        spec_decode_k: int = 0,
        spec_ngram: int = 2,
    ):
        cfg = model.config
        if not (cfg.decode and cfg.ragged_decode):
            raise ValueError(
                "engine needs LlamaConfig(decode=True, ragged_decode=True)")
        self.model = model
        self.device = model.device
        self.max_slots = int(max_slots)
        self.max_seq = int(cfg.max_seq_len)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.decode_chunk = int(decode_chunk)
        # chunks dispatched ahead of the oldest unattributed one: the
        # host's wait for chunk N then overlaps chunk N+1 on the device
        self.pipeline_depth = max(1, int(pipeline_depth))
        if prompt_buckets is None:
            prompt_buckets = [
                b for b in (128, 256, 512, 1024, 2048, 4096, 8192)
                if b < self.max_seq
            ]
        self.prompt_buckets = sorted(int(b) for b in prompt_buckets)
        if not self.prompt_buckets:
            raise ValueError("need at least one prompt bucket < max_seq_len")
        if self.prompt_buckets[-1] >= self.max_seq:
            raise ValueError(
                f"prompt bucket {self.prompt_buckets[-1]} >= max_seq_len "
                f"{self.max_seq}: every bucket must leave room for at "
                "least one generated token")
        self.chunked_prefill = bool(chunked_prefill)
        self._chunk_buckets = [b for b in self.prompt_buckets
                               if b <= int(prefill_chunk)]
        if (self.chunked_prefill and self._chunk_buckets
                and int(prefill_chunk) not in self._chunk_buckets
                and int(prefill_chunk) < self.max_seq):
            # the requested chunk size is itself a chunk shape when it
            # fits the grid; an off-grid request is refused, not clamped
            if int(prefill_chunk) % self._chunk_buckets[0]:
                raise ValueError(
                    f"prefill_chunk {prefill_chunk} is not a multiple "
                    f"of the smallest prompt bucket "
                    f"{self._chunk_buckets[0]}; pick a multiple (or a "
                    "value >= max_seq_len to use the largest bucket)")
            self._chunk_buckets.append(int(prefill_chunk))
        if self.chunked_prefill:
            if not self._chunk_buckets:
                raise ValueError(
                    f"prefill_chunk {prefill_chunk} < smallest prompt "
                    f"bucket {self.prompt_buckets[0]}: no chunk shape "
                    "fits the budget")
            g = self._chunk_buckets[0]
            bad = [b for b in self._chunk_buckets if b % g]
            if bad:
                raise ValueError(
                    f"chunked prefill needs every chunk bucket to be "
                    f"a multiple of the smallest bucket ({g}); "
                    f"offending buckets: {bad}")
            # a prompt whose final PADDED chunk would overhang max_seq
            # is inadmissible (enforced per prompt in submit())
            self._chunk_plen_cap = (self.max_seq // g) * g
        self.prefill_chunk = self._chunk_buckets[-1] \
            if self._chunk_buckets else int(prefill_chunk)
        self.max_tokens_per_round = int(
            max_tokens_per_round
            if max_tokens_per_round is not None
            else self.prefill_chunk + self.max_slots * self.decode_chunk)
        if self.max_tokens_per_round < 1:
            raise ValueError("max_tokens_per_round must be >= 1")
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        # Chunked-prefill working caches, one per STAGE (power-of-two
        # multiples of prefill_chunk, capped at max_seq): a continuation
        # chunk attends against its whole working cache, so staging
        # keeps that at O(chunk * visible prefix). Allocated on first
        # use and reused; stale rows are garbage-tolerant (see the
        # final-chunk copy). At most one prompt is mid-prefill, holding
        # a reserved slot that activates on its final chunk.
        self._pcaches: Dict[int, KVCache] = {}
        self._pstage: Optional[int] = None
        self._prefilling: Optional[Request] = None
        self._prefill_slot: Optional[int] = None
        # Shared-prefix KV reuse: an LRU of working-cache snapshots at the
        # prefix boundary, keyed by the prefix's token bytes. The boundary
        # is on the chunk grid, so a snapshot is a legal continuation
        # offset; a capture forces a chunk boundary there. Off on the
        # legacy one-shot path (no working cache to reuse).
        self.prefix_cache_tokens = int(prefix_cache_tokens)
        self.prefix_cache_max = int(prefix_cache_max)
        self._prefix_len = 0
        if self.chunked_prefill and self.prefix_cache_tokens > 0:
            g0 = self._chunk_buckets[0]
            self._prefix_len = (self.prefix_cache_tokens // g0) * g0
        # key -> (stage, snapshot KVCache: a clone no chunk writes)
        self._prefix_cache: "collections.OrderedDict" = \
            collections.OrderedDict()
        self._prefix_bytes: Dict[bytes, int] = {}  # key -> device bytes
        self._capture_key: Optional[bytes] = None
        # guards the two dicts: the directory runs on handler threads
        # while the pump captures and hits
        self._prefix_lock = threading.Lock()
        # Self-speculative decode: greedy only, since acceptance must be
        # bit-identical to plain decode
        self.spec_decode_k = int(spec_decode_k)
        self.spec_ngram = max(1, int(spec_ngram))
        if self.spec_decode_k > 0 and float(temperature) != 0.0:
            raise ValueError(
                "spec_decode_k requires temperature=0 (greedy): the "
                "accept-prefix rule is only bit-identical to the "
                "plain decode path under argmax")
        # host mirrors of the device scheduling vectors, authoritative in
        # spec-decode mode only (every round is synchronous there)
        self._tok_h = np.zeros(self.max_slots, np.int32)
        self._len_h = np.zeros(self.max_slots, np.int32)
        self._budget_h = np.zeros(self.max_slots, np.int32)
        # slot -> first token (a device scalar) of the admission that just
        # filled it; the spec-mode pump attributes fills inline
        self._fill_toks: Dict[int, torch.Tensor] = {}

        # decode state lives on the device between chunks; the host
        # holds a scheduling VIEW refreshed from each packed fetch. The
        # big cache is zero-filled (the JAX engine's throwaway init
        # apply also leaves a garbage row 0 per slot; both are masked
        # until a slot's first prefill overwrites them).
        self._cache = KVCache.zeros(cfg, self.max_slots, self.max_seq,
                                    self.device, fresh=False)
        self._tok = torch.zeros(self.max_slots, dtype=torch.int32,
                                device=self.device)
        self._lengths = torch.zeros_like(self._tok)
        self._budget = torch.zeros_like(self._tok)
        self._active = torch.zeros(self.max_slots, dtype=torch.bool,
                                   device=self.device)
        self._active_h = np.zeros(self.max_slots, bool)  # host view
        self._slot_req: List[Optional[Request]] = [None] * self.max_slots
        self._queue: collections.deque = collections.deque()
        # submit() -> _reqs (in flight) -> _done on the finishing
        # chunk's attribution -> drained by pop_finished()/run()
        self._reqs: Dict[int, Request] = {}
        self._done: Dict[int, Request] = {}
        self._rid = itertools.count()
        self._closed = False
        # guards submit()'s closed-check + enqueue vs close(), and the
        # _done insert vs pop_finished()'s swap
        self._lock = threading.Lock()
        # The compiled chunk (CUDA only): the first chunk runs eagerly on
        # the capture stream, the second captures the graph; its packed
        # output is overwritten by every replay, so each dispatch copies
        # it out into one of pipeline_depth + 1 pinned host buffers (at
        # most pipeline_depth chunks are unattributed at a dispatch, and
        # a chunk's buffer is read before its attribution)
        cuda = self.device.type == "cuda"
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_packed: Optional[torch.Tensor] = None
        self._warmed = False  # the eager first chunk has run
        self.graph_launches: Optional[Dict[str, int]] = None
        # spec decode's verify forward: eager on the CPU; on a card the
        # first round eager, then one graph over fixed [B, K+1] inputs
        self._vgraph: Optional[torch.cuda.CUDAGraph] = None
        self._vx = self._vpos = self._vout = None
        k = self.decode_chunk
        self._host_bufs = [
            torch.empty((2 * k + 4, self.max_slots), dtype=torch.int32,
                        pin_memory=True)
            for _ in range(self.pipeline_depth + 1)] if cuda else []
        # Dispatched chunks flow pump -> _fetchq -> harvester threads
        # (which own the only blocking device->host waits) -> _readyq ->
        # pump attribution, reordered by sequence number
        self._fetchq: "queue.Queue" = queue.Queue()
        self._readyq: "queue.Queue" = queue.Queue()
        self._unattributed = 0   # dispatched, not yet attributed
        self._seq = 0            # dispatch order
        self._attr_seq = 0       # next chunk to attribute
        self._ready_held: Dict[int, tuple] = {}  # out-of-order buffer
        self._last_attr_t = 0.0  # when the last chunk was attributed
        # the thread target closes over the QUEUES, not self: a bound
        # method would pin the engine (and its device KV cache) for the
        # process lifetime if close() is never called
        self._harvesters = [
            threading.Thread(target=_harvest_loop,
                             args=(self._fetchq, self._readyq),
                             daemon=True, name=f"serving-harvester-{i}")
            for i in range(4)]
        for t in self._harvesters:
            t.start()
        # chunk_s sums each chunk's dispatch-to-attribution latency
        # (chunks overlap); decode_wall_s the wall time in which at least
        # one chunk was in flight
        self.stats = {"prefills": 0, "chunks": 0, "decode_steps": 0,
                      "wasted_slot_steps": 0, "prefill_s": 0.0,
                      "chunk_s": 0.0, "decode_wall_s": 0.0,
                      "prefill_chunks": 0, "prefill_tokens": 0,
                      "queue_depth": 0, "ttft_s_sum": 0.0, "ttft_count": 0,
                      "graph_captures": 0, "graph_replays": 0,
                      "prefix_hits": 0, "prefix_misses": 0,
                      "prefix_captures": 0, "prefix_tokens_saved": 0,
                      "prefix_cache_bytes": 0, "prefix_installs": 0,
                      # rounds run, drafts proposed, drafts accepted,
                      # rounds that fell back to a plain chunk
                      "spec_decode_rounds": 0, "spec_decode_drafted": 0,
                      "spec_decode_accepted": 0,
                      "spec_decode_fallbacks": 0}

    # -- request intake --------------------------------------------------

    def submit(self, prompt, max_new_tokens: int) -> int:
        prompt = self._validate_submit(prompt, max_new_tokens)
        req = Request(next(self._rid), prompt, int(max_new_tokens),
                      submitted_at=time.perf_counter())
        with self._lock:
            if self._closed:
                raise RuntimeError("engine is closed")
            self._reqs[req.rid] = req
            self._queue.append(req)
        return req.rid

    def _validate_submit(self, prompt, max_new_tokens: int) -> np.ndarray:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if not self.chunked_prefill and prompt.size > self.prompt_buckets[-1]:
            raise ValueError(
                f"prompt len {prompt.size} exceeds the largest bucket "
                f"{self.prompt_buckets[-1]}")
        if self.chunked_prefill and prompt.size > self._chunk_plen_cap:
            raise ValueError(
                f"prompt len {prompt.size} exceeds the chunkable cap "
                f"{self._chunk_plen_cap} (max_seq_len {self.max_seq} "
                f"is not a multiple of the smallest chunk bucket "
                f"{self._chunk_buckets[0]})")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt {prompt.size} + new {max_new_tokens} exceeds "
                f"cache size {self.max_seq}")
        vocab = self.model.config.vocab_size
        if prompt.min() < 0 or prompt.max() >= vocab:
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        return prompt

    def queue_depth(self) -> int:
        """LIVE admission-queue depth (accepted, not yet scheduled) —
        a front-end backpressure check reads it between rounds."""
        return len(self._queue)

    # -- scheduling ------------------------------------------------------

    def _bucket_for(self, plen: int) -> int:
        for b in self.prompt_buckets:
            if plen <= b:
                return b
        raise AssertionError  # guarded in submit()

    def _padded(self, tokens: np.ndarray, length: int) -> torch.Tensor:
        ids = np.zeros((1, length), np.int64)
        ids[0, :tokens.size] = tokens
        return torch.from_numpy(ids).to(self.device)

    def _set_slot(self, slot: int, tok_new: torch.Tensor, plen: int,
                  max_new: int) -> None:
        """Activate ``slot`` after its prefill, ON THE DEVICE, including
        the finished-at-first-token check (the host sees the prefill
        token only in the next chunk's packed fetch)."""
        budget0 = max_new - 1
        self._tok[slot] = tok_new
        self._lengths[slot] = plen
        self._budget[slot] = budget0
        if budget0 <= 0:
            self._active[slot] = False
        elif self.eos_id is None:
            self._active[slot] = True
        else:
            self._active[slot] = tok_new != self.eos_id

    def _occupy(self, slot: int, req: Request, fills: Dict[int, int],
                tok_new: torch.Tensor) -> None:
        self.stats["prefills"] += 1
        self._slot_req[slot] = req
        self._active_h[slot] = True  # optimistic; fixed at attribution
        fills[slot] = req.rid
        if self.spec_decode_k > 0:
            self._fill_toks[slot] = tok_new

    def _fill_free_slots(self) -> Dict[int, int]:
        """Legacy one-shot path (``chunked_prefill=False``): prefill a
        queued request into every free slot. Returns {slot: rid}; their
        first tokens surface in the next chunk's packed row 0."""
        fills: Dict[int, int] = {}
        for slot in range(self.max_slots):
            if self._slot_req[slot] is not None or not self._queue:
                continue
            req = self._queue.popleft()
            req.prefill_start_at = time.perf_counter()
            plen = int(req.prompt.size)
            t0 = time.perf_counter()
            tok_new = _prefill_insert(
                self.model, self._cache, slot,
                self._padded(req.prompt, self._bucket_for(plen)), plen,
                self._gen, self.temperature)
            self._set_slot(slot, tok_new, plen, req.max_new_tokens)
            self.stats["prefill_s"] += time.perf_counter() - t0
            req.prefill_done = plen
            self._occupy(slot, req, fills, tok_new)
        return fills

    def _free_slot(self) -> Optional[int]:
        for slot in range(self.max_slots):
            if self._slot_req[slot] is None and slot != self._prefill_slot:
                return slot
        return None

    def _stage_for(self, rows: int) -> int:
        length = self.prefill_chunk
        while length < rows:
            length *= 2
        return min(length, self.max_seq)

    def _stage_cache(self, stage: int) -> KVCache:
        if stage not in self._pcaches:
            self._pcaches[stage] = KVCache.zeros(
                self.model.config, 1, stage, self.device, fresh=False)
        return self._pcaches[stage]

    # -- the shared-prefix cache and its directory -----------------------

    def _prefix_insert(self, key: bytes, stage: int, snap: KVCache) -> None:
        """Put a snapshot into the LRU, evicting the oldest past
        ``prefix_cache_max``, with its device bytes accounted."""
        with self._prefix_lock:
            self._prefix_cache[key] = (stage, snap)
            self._prefix_cache.move_to_end(key)
            self._prefix_bytes[key] = snap.nbytes()
            while len(self._prefix_cache) > self.prefix_cache_max:
                evicted, _ = self._prefix_cache.popitem(last=False)
                self._prefix_bytes.pop(evicted, None)
            self.stats["prefix_cache_bytes"] = sum(self._prefix_bytes.values())

    def _admit_prefix(self, req: Request) -> None:
        """Prefix-cache lookup when ``req`` starts to prefill. A HIT
        copies the snapshot into the stage's working cache (the snapshot
        stays untouched for the next hit: chunks write the working cache
        in place) and marks the prefix's tokens done, so chunking resumes
        at the boundary. A MISS on a prompt long enough arms a capture."""
        self._capture_key = None
        n = self._prefix_len
        if not n or int(req.prompt.size) <= n:
            return
        key = req.prompt[:n].tobytes()
        with self._prefix_lock:
            hit = self._prefix_cache.get(key)
            if hit is not None:
                self._prefix_cache.move_to_end(key)
        if hit is None:
            self.stats["prefix_misses"] += 1
            self._capture_key = key
            return
        stage, snap = hit
        self._stage_cache(stage).copy_rows_(snap, 0, stage)
        self._pstage = stage
        req.prefill_done = n
        self.stats["prefix_hits"] += 1
        self.stats["prefix_tokens_saved"] += n

    def prefix_digest(self, prompt) -> Optional[str]:
        """sha256 hex of the prompt's prefix-cache key, or None when the
        cache is off or the prompt too short to have one: the fleet-wide
        directory key."""
        n = self._prefix_len
        p = np.asarray(prompt, np.int32).reshape(-1)
        if not n or p.size <= n:
            return None
        return hashlib.sha256(p[:n].tobytes()).hexdigest()

    def prefix_keys(self) -> List[str]:
        """Digests of every prefix snapshot held here."""
        with self._prefix_lock:
            keys = list(self._prefix_cache.keys())
        return [hashlib.sha256(k).hexdigest() for k in keys]

    def has_prefix(self, digest: str) -> bool:
        return digest in self.prefix_keys()

    def export_prefix(self, digest: str):
        """``(meta, leaves)`` of the held snapshot whose key hashes to
        ``digest``, or None: ``meta`` is ``{"kind": "prefix", "stage",
        "tokens"}`` (the raw prefix, so an importer derives its own key)
        and the leaves are CPU copies in the JAX cache tree's order and
        shapes (:func:`jax_cache_leaves`)."""
        with self._prefix_lock:
            entry = next(((k, st, snap) for k, (st, snap)
                          in self._prefix_cache.items()
                          if hashlib.sha256(k).hexdigest() == digest), None)
        if entry is None:
            return None
        key, stage, snap = entry
        meta = {"kind": "prefix", "stage": int(stage),
                "tokens": [int(t) for t in np.frombuffer(key, np.int32)]}
        return meta, [t.to("cpu", copy=True) for t in jax_cache_leaves(snap)]

    def install_prefix(self, meta: dict, leaves) -> None:
        """Admit a peer's exported prefix snapshot (either package's:
        leaves in the JAX order and shapes, torch tensors or numpy arrays)
        into the LRU. The prefix length, the stage and every leaf's shape
        and dtype are checked first: a mismatch raises ``ValueError`` on
        the caller's thread. The stage must be the one this engine's own
        capture uses: a larger one would reach the stage-crossing copy of
        the next chunk, which carries ``stage`` rows into a smaller working
        cache, on the pump thread."""
        tokens = [int(t) for t in (meta.get("tokens") or [])]
        if not self._prefix_len or len(tokens) != self._prefix_len:
            raise ValueError(
                f"prefix import: {len(tokens)} tokens != this engine's "
                f"prefix length {self._prefix_len} (configs must match "
                "across the fleet)")
        stage = int(meta["stage"])
        if stage != self._stage_for(self._prefix_len):
            raise ValueError(
                f"prefix import: stage {stage} != this engine's capture stage "
                f"{self._stage_for(self._prefix_len)} (prefill_chunk must "
                "match across the fleet)")
        snap = KVCache.zeros(self.model.config, 1, stage, self.device,
                             fresh=False)
        want = jax_cache_leaves(snap)
        if len(leaves) != len(want):
            raise ValueError(
                f"prefix import: {len(leaves)} leaves != stage cache's "
                f"{len(want)}")
        got = [as_torch(x) for x in leaves]
        for i, (w, g) in enumerate(zip(want, got)):
            if tuple(g.shape) != tuple(w.shape) or g.dtype != w.dtype:
                raise ValueError(
                    f"prefix import: leaf {i} is {g.dtype}{list(g.shape)}, "
                    f"stage {stage} expects {w.dtype}{list(w.shape)}")
        for w, g in zip(want, got):
            w.copy_(g)
        self._prefix_insert(np.asarray(tokens, np.int32).tobytes(), stage, snap)
        self.stats["prefix_installs"] += 1

    def _schedule_prefill(self) -> Dict[int, int]:
        """Token-budget scheduler (chunked_prefill=True): spend this
        round's budget — after decode rows claim ``active *
        decode_chunk`` — on prefill chunks for the oldest admitted
        prompt, admitting the next queued prompt into a free slot
        whenever the current one finishes and budget remains. Returns
        {slot: rid} for slots ACTIVATED this round."""
        fills: Dict[int, int] = {}
        n_active = int(self._active_h.sum())
        remaining = self.max_tokens_per_round - n_active * self.decode_chunk
        if n_active == 0:
            # nothing decoding: no latency to protect, allow a full chunk
            remaining = max(remaining, self.prefill_chunk)
        g = self._chunk_buckets[0]
        while remaining >= g:
            if self._prefilling is None:
                if not self._queue:
                    break
                slot = self._free_slot()
                if slot is None:
                    break
                self._prefilling = self._queue.popleft()
                self._prefilling.prefill_start_at = time.perf_counter()
                self._prefill_slot = slot
                self._admit_prefix(self._prefilling)
            req, slot = self._prefilling, self._prefill_slot
            plan = _next_chunk(self._chunk_buckets, req.prefill_done,
                               int(req.prompt.size), remaining, self.max_seq)
            if (plan is not None and self._capture_key is not None
                    and req.prefill_done < self._prefix_len
                    and req.prefill_done + plan[0] > self._prefix_len):
                # a chunk boundary at the capture point, so the snapshot
                # holds exactly the shared tokens (the boundary is on the
                # chunk grid: a full in-budget bucket exists once
                # remaining >= g)
                fit = [b for b in self._chunk_buckets
                       if req.prefill_done + b <= self._prefix_len
                       and b <= remaining]
                plan = (max(fit), max(fit), False) if fit else None
            if plan is None:
                break
            chunk_b, take, final = plan
            offset = req.prefill_done
            padded = self._padded(req.prompt[offset:offset + take], chunk_b)
            t0 = time.perf_counter()
            if final and offset == 0:
                # single-chunk prompt (the common case): one-shot insert
                # straight into the slot through the flash kernel
                tok_new = _prefill_insert(self.model, self._cache, slot,
                                          padded, take, self._gen,
                                          self.temperature)
            else:
                stage = self._stage_for(offset + chunk_b)
                pcache = self._stage_cache(stage)
                if offset and self._pstage is not None \
                        and stage != self._pstage:
                    # stage crossing: carry the accumulated rows up
                    pcache.copy_rows_(self._pcaches[self._pstage], 0,
                                      self._pstage)
                self._pstage = stage
                tok_new = _prefill_chunk(self.model, pcache, padded, offset,
                                         take - 1, self._gen,
                                         self.temperature, final)
                if final:
                    # copy into the slot, rounded to a chunk multiple.
                    # Rows past the prompt are stale working-cache
                    # garbage, which is safe: a slot row is visible only
                    # at positions <= the slot's length, and decode
                    # overwrites row p before the first read at p
                    rows_b = min(stage, -(-(offset + chunk_b)
                                          // self.prefill_chunk)
                                 * self.prefill_chunk)
                    self._cache.copy_rows_(pcache, slot, rows_b)
            req.prefill_done += take
            remaining -= chunk_b
            self.stats["prefill_chunks"] += 1
            self.stats["prefill_tokens"] += chunk_b
            self.stats["prefill_s"] += time.perf_counter() - t0
            if (self._capture_key is not None
                    and req.prefill_done == self._prefix_len):
                # the working cache holds exactly the shared prefix: a
                # clone goes into the LRU (the next chunk writes the
                # working cache in place)
                self._prefix_insert(self._capture_key, stage, pcache.clone())
                self.stats["prefix_captures"] += 1
                self._capture_key = None
            if final:
                self._set_slot(slot, tok_new, int(req.prompt.size),
                               req.max_new_tokens)
                self._occupy(slot, req, fills, tok_new)
                self._prefilling = None
                self._prefill_slot = None
                self._pstage = None
        return fills

    def prefill_progress(self) -> Dict[int, Dict[str, int]]:
        """{rid: {"done", "total"}} for the prompt mid-prefill, if any."""
        req = self._prefilling
        if req is None:
            return {}
        return {req.rid: {"done": int(req.prefill_done),
                          "total": int(req.prompt.size)}}

    # -- the pump --------------------------------------------------------

    def _decode_state(self) -> torch.Tensor:
        """One eager chunk on the engine's state, written back IN PLACE
        (the graph reads and writes these same tensors); returns packed."""
        tok, lengths, active, budget, packed = _decode_chunk(
            self.model, self._cache, self._tok, self._lengths, self._active,
            self._budget, self._gen, n_steps=self.decode_chunk,
            temperature=self.temperature, eos_id=self.eos_id)
        for dst, src in ((self._tok, tok), (self._lengths, lengths),
                         (self._active, active), (self._budget, budget)):
            dst.copy_(src)
        return packed

    def _capture(self) -> None:
        """Capture one chunk as a CUDA graph on the device's capture
        stream (the stream the eager first chunk warmed). Capturing runs
        nothing: the state is unchanged until the first replay. Raises if
        the capture fails."""
        graph = torch.cuda.CUDAGraph()
        if self.temperature > 0:
            graph.register_generator_state(self._gen)
        prev = torch.cuda.current_stream(self.device)
        with _CAPTURE_LOCK:
            before = _launch_counts()
            try:
                # thread_local: the harvester threads' event waits stay
                # legal while this thread captures
                with torch.cuda.graph(graph, stream=_capture_stream(self.device),
                                      capture_error_mode="thread_local"):
                    packed = self._decode_state()
            finally:
                # a capture that fails leaves torch.cuda.graph's stream
                # context entered: this thread would stay on that stream
                torch.cuda.set_stream(prev)
            after = _launch_counts()
        self.graph_launches = {k: after[k] - before[k] for k in after}
        self._graph, self._graph_packed = graph, packed
        self.stats["graph_captures"] += 1

    def _run_decode(self) -> torch.Tensor:
        """Run one chunk on the engine's state; returns its packed array,
        ready in stream order on the current stream. The CPU runs it
        eagerly; on a card the first chunk runs eagerly on the capture
        stream, the second captures the graph, and that and every later
        chunk replay it."""
        if self.device.type != "cuda":
            return self._decode_state()
        if not self._warmed:
            cur = torch.cuda.current_stream(self.device)
            with _CAPTURE_LOCK:
                side = _capture_stream(self.device)
                side.wait_stream(cur)
                with torch.cuda.stream(side):
                    packed = self._decode_state()
                cur.wait_stream(side)
            packed.record_stream(cur)
            self._warmed = True
            return packed
        if self._graph is None:
            self._capture()
        self._graph.replay()
        self.stats["graph_replays"] += 1
        return self._graph_packed

    def _dispatch_chunk(self, fills: Dict[int, int]) -> None:
        """Enqueue one chunk and the copy of its packed array for the
        harvesters, with the dispatch-time slot→request snapshot."""
        t0 = time.perf_counter()
        packed = self._run_decode()
        pinned = (self._host_bufs[self._seq % len(self._host_bufs)]
                  if self._host_bufs else None)
        handle = _HostCopy(packed, pinned)
        snapshot = [r.rid if r is not None else None
                    for r in self._slot_req]
        self._fetchq.put((self._seq, handle, fills, snapshot, t0))
        self._seq += 1
        self._unattributed += 1
        self.stats["chunks"] += 1
        self.stats["decode_steps"] += self.decode_chunk

    def _next_ready(self, block: bool):
        """Chunk results in DISPATCH order: parallel harvesters finish
        out of order; attribution must not (token order per slot)."""
        while self._attr_seq not in self._ready_held:
            try:
                item = self._readyq.get(block=block)
            except queue.Empty:
                return None
            self._ready_held[item[0]] = item[1:]
        out = self._ready_held.pop(self._attr_seq)
        self._attr_seq += 1
        return out

    def _attribute(self, block: bool) -> bool:
        """Apply one harvested chunk's results via the dispatch-time
        slot→request snapshot — a slot may have been refilled since, so
        the current ``_slot_req`` must not be trusted for old chunks."""
        item = self._next_ready(block)
        if item is None:
            return False
        arr, fills, snapshot, t0 = item
        self._unattributed -= 1
        if isinstance(arr, Exception):
            raise RuntimeError(
                f"decode chunk {self._attr_seq - 1} failed on device") from arr
        K = self.decode_chunk
        tok_in, toks = arr[0], arr[1:K + 1]
        valid = arr[K + 1:2 * K + 1].astype(bool)
        active_out = arr[2 * K + 1].astype(bool)
        if self.spec_decode_k > 0:
            # spec mode runs one chunk at a time: this packed view IS the
            # device state, which the next verify round plans from
            self._tok_h[:] = arr[K]
            self._budget_h[:] = arr[2 * K + 2]
            self._len_h[:] = arr[2 * K + 3]
        now = time.perf_counter()
        self.stats["chunk_s"] += now - t0
        self.stats["decode_wall_s"] += now - max(t0, self._last_attr_t)
        self._last_attr_t = now
        self.stats["wasted_slot_steps"] += int((~valid).sum())
        for slot, rid in enumerate(snapshot):
            if rid is None:
                continue
            # finished requests leave _reqs at attribution (and may be
            # drained entirely); stale snapshot entries for them skip
            req = self._reqs.get(rid)
            if req is None or req.done:
                continue
            n_before = len(req.tokens)
            if fills.get(slot) == rid:
                # the prefill's token rode in as this chunk's input
                req.tokens.append(int(tok_in[slot]))
            req.tokens.extend(int(t) for t in toks[valid[:, slot], slot])
            n_new = len(req.tokens) - n_before
            if n_new:
                if not req.token_times:
                    req.first_token_at = now
                    self.stats["ttft_s_sum"] += now - req.submitted_at
                    self.stats["ttft_count"] += 1
                req.token_times.append((now, n_new))
            if not active_out[slot]:
                req.done = True
                req.finished_at = time.perf_counter()
                # atomic vs pop_finished()'s swap (front-end threads)
                with self._lock:
                    self._done[rid] = self._reqs.pop(rid)
                if self._slot_req[slot] is req:
                    self._slot_req[slot] = None
                    self._active_h[slot] = False
        return True

    # -- self-speculative decode ----------------------------------------

    def _push_state(self) -> None:
        """Host mirrors -> the device state tensors, IN PLACE (the graph
        reads these same tensors; a rebound tensor would be stale to it).
        In spec mode the mirrors are authoritative between rounds."""
        for dst, src in ((self._tok, self._tok_h), (self._lengths, self._len_h),
                         (self._active, self._active_h),
                         (self._budget, self._budget_h)):
            dst.copy_(torch.from_numpy(src))

    def _finish_slot(self, slot: int, req: Request) -> None:
        req.done = True
        req.finished_at = time.perf_counter()
        with self._lock:
            self._done[req.rid] = self._reqs.pop(req.rid, req)
        self._slot_req[slot] = None
        self._active_h[slot] = False

    def _spec_step(self) -> bool:
        """Spec-mode pump round: admissions attribute inline (the host
        mirrors need every first token), then one verify round advances
        every active slot by 1 + its accepted drafts."""
        fills = (self._schedule_prefill() if self.chunked_prefill
                 else self._fill_free_slots())
        self.stats["queue_depth"] = len(self._queue)
        now = time.perf_counter()
        for slot, rid in fills.items():
            req = self._reqs.get(rid)
            tok = int(self._fill_toks.pop(slot))
            if req is None or req.done:
                continue
            req.tokens.append(tok)
            req.first_token_at = now
            req.token_times.append((now, 1))
            self.stats["ttft_s_sum"] += now - req.submitted_at
            self.stats["ttft_count"] += 1
            self._tok_h[slot] = tok
            self._len_h[slot] = req.prefill_done
            self._budget_h[slot] = req.max_new_tokens - 1
            alive = self._budget_h[slot] > 0 and (
                self.eos_id is None or tok != self.eos_id)
            self._active_h[slot] = bool(alive)
            if not alive:
                self._finish_slot(slot, req)
        if self._active_h.any():
            self._spec_round()
        return bool(self._queue or self._prefilling is not None
                    or any(r is not None for r in self._slot_req))

    def _spec_round(self) -> None:
        """Draft K, verify once, accept the matching prefix for every
        active slot. Bit-identical to sequential greedy decode: only
        tokens whose whole input prefix matched the sequential stream are
        kept, plus the bonus correction (itself the sequential next
        token)."""
        k = self.spec_decode_k
        active_idx = [i for i in range(self.max_slots) if self._active_h[i]]
        if any(int(self._len_h[i]) + k + 1 > self.max_seq for i in active_idx):
            # a row this close to the cache end has no room for K + 1
            # verify rows: one plain chunk round instead
            self.stats["spec_decode_fallbacks"] += 1
            self._plain_sync_round()
            return
        x = np.zeros((self.max_slots, k + 1), np.int64)
        pos = np.broadcast_to(np.arange(k + 1, dtype=np.int64),
                              (self.max_slots, k + 1)).copy()
        drafted = 0
        for i in active_idx:
            req = self._slot_req[i]
            ctx = np.concatenate([req.prompt, np.asarray(req.tokens, np.int32)])
            d = _ngram_draft(ctx, k, self.spec_ngram)
            drafted += int(d.size)
            x[i, 0] = self._tok_h[i]
            x[i, 1:1 + d.size] = d
            pos[i] += self._len_h[i]
            # an inactive row writes rows [0, K] of its slot, which the
            # next occupant's prefill or decode overwrites before a read
        self._push_state()
        t = self._verify(x, pos)
        now = time.perf_counter()
        self.stats["spec_decode_rounds"] += 1
        self.stats["spec_decode_drafted"] += drafted
        self.stats["chunks"] += 1
        self.stats["decode_steps"] += 1
        for i in active_idx:
            req = self._slot_req[i]
            # draft j survives iff it equals the greedy token after the
            # (accepted) prefix before it
            a = 0
            while a < k and x[i, a + 1] == t[i, a]:
                a += 1
            emitted = [int(v) for v in x[i, 1:a + 1]] + [int(t[i, a])]
            emitted = emitted[:min(len(emitted), int(self._budget_h[i]))]
            if self.eos_id is not None and self.eos_id in emitted:
                emitted = emitted[:emitted.index(self.eos_id) + 1]
            if not emitted:
                continue
            # the first `a` emitted tokens are accepted drafts; the bonus
            # is not counted
            self.stats["spec_decode_accepted"] += min(len(emitted), a)
            req.tokens.extend(emitted)
            req.token_times.append((now, len(emitted)))
            self._budget_h[i] -= len(emitted)
            self._tok_h[i] = emitted[-1]
            # the newest token's row is at L + len(emitted) whether the
            # bonus was kept or cut; a cut one's row is rewritten at the
            # same position by the next feed
            self._len_h[i] += len(emitted)
            hit_eos = self.eos_id is not None and emitted[-1] == self.eos_id
            alive = (self._budget_h[i] > 0 and not hit_eos
                     and self._len_h[i] < self.max_seq)
            self._active_h[i] = bool(alive)
            if not alive:
                self._finish_slot(i, req)

    def _verify(self, x: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """The verify forward's greedy tokens ``[B, K+1]`` on the host
        for the drafts ``x`` at positions ``pos``. The CPU runs it
        eagerly; on a card the first round runs eagerly on the capture
        stream, the second captures the forward as a CUDA graph over
        fixed input tensors (the cache written in place, as by the decode
        chunk's graph), and that and every later round replay it: an
        eager round is host-bound (~1.6k small launches)."""
        if self.device.type != "cuda":
            return _verify_chunk(self.model, self._cache, torch.from_numpy(x),
                                 torch.from_numpy(pos)).numpy()
        if self._vx is None:  # the first round: eager
            self._vx = torch.from_numpy(x).to(self.device)
            self._vpos = torch.from_numpy(pos).to(self.device)
            cur = torch.cuda.current_stream(self.device)
            with _CAPTURE_LOCK:
                side = _capture_stream(self.device)
                side.wait_stream(cur)
                with torch.cuda.stream(side):
                    out = _verify_chunk(self.model, self._cache, self._vx,
                                        self._vpos)
                cur.wait_stream(side)
            return out.cpu().numpy()
        if self._vgraph is None:
            self._capture_verify()
        self._vx.copy_(torch.from_numpy(x))
        self._vpos.copy_(torch.from_numpy(pos))
        self._vgraph.replay()
        return self._vout.cpu().numpy()

    def _capture_verify(self) -> None:
        """Capture the verify forward over ``_vx``/``_vpos`` on the
        device's capture stream; capturing runs nothing. Raises if the
        capture fails (no eager fallback)."""
        graph = torch.cuda.CUDAGraph()
        prev = torch.cuda.current_stream(self.device)
        with _CAPTURE_LOCK:
            try:
                with torch.cuda.graph(graph, stream=_capture_stream(self.device),
                                      capture_error_mode="thread_local"):
                    out = _verify_chunk(self.model, self._cache, self._vx,
                                        self._vpos)
            finally:
                torch.cuda.set_stream(prev)
        self._vgraph, self._vout = graph, out

    def _plain_sync_round(self) -> None:
        """One plain decode chunk (the graph replay on the card),
        dispatched and attributed in place: the spec pump's end-of-cache
        round. Its packed fetch refreshes the host mirrors."""
        self._push_state()
        self._dispatch_chunk({})
        while self._unattributed:
            self._attribute(block=True)

    def step(self) -> bool:
        """One pump round: attribute whatever the harvesters finished,
        wait while ``pipeline_depth`` chunks are unattributed, schedule
        prefill, dispatch a chunk (or, with nothing to decode, drain
        one). In spec-decode mode one synchronous verify round instead.
        Returns True while work remains."""
        if self._closed:
            raise RuntimeError("engine is closed")
        if self.spec_decode_k > 0:
            return self._spec_step()
        while self._attribute(block=False):
            pass
        if self._unattributed >= self.pipeline_depth:
            self._attribute(block=True)
        fills = (self._schedule_prefill() if self.chunked_prefill
                 else self._fill_free_slots())
        self.stats["queue_depth"] = len(self._queue)
        if fills or self._active_h.any():
            self._dispatch_chunk(fills)
        elif self._unattributed:
            self._attribute(block=True)
        return bool(self._queue or self._unattributed
                    or self._prefilling is not None
                    or any(r is not None for r in self._slot_req))

    def pop_finished(self) -> Dict[int, Request]:
        """Drain and return every finished-but-uncollected request;
        once popped, the engine keeps no reference to it."""
        with self._lock:
            done, self._done = self._done, {}
        return done

    def run(self) -> Dict[int, np.ndarray]:
        """Drain the queue; returns {rid: tokens [n] int32} for every
        request finished since the last drain (prompt excluded)."""
        while self.step():
            pass
        return {rid: np.asarray(r.tokens, np.int32)
                for rid, r in self.pop_finished().items()}

    def close(self) -> None:
        """Stop the harvester threads; later submit()/step() calls raise.
        Also runs from ``__del__``: the threads hold only the queues, so
        an abandoned engine is collectible, and collection stops them."""
        with self._lock:
            self._closed = True
        for _ in self._harvesters:
            self._fetchq.put(None)
        for t in self._harvesters:
            if t is not threading.current_thread():
                t.join(timeout=5)

    def __del__(self):  # best effort; close() is the API
        try:
            for _ in self._harvesters:
                self._fetchq.put(None)
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
