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
  array per chunk.

Inactive slots still compute (static shapes): a frozen slot decodes at
``min(length, max_seq - 1)`` and writes its garbage row there, masked
until the slot's next occupant overwrites it. Every cache write is in
place on the engine's one cache tensor per layer. With an int8 KV cache
(``kv_quant="int8"``) the big cache and every staged working cache
carry their per-row scales (:class:`~k8s_tpu_torch.models.KVCache`),
and the slot views and the working-cache copy take them along, as the
JAX engine's scale leaves are scattered with the rows.

This port runs the pump synchronously (pipeline depth 1, no harvester
threads); the prefix cache, speculative decode, the disaggregation and
migration entry points come in later slices. Oracle for correctness:
each request's tokens equal a solo :func:`k8s_tpu_torch.models.generate`
run (and the JAX engine's) with the same weights.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from k8s_tpu_torch.models.llama import KVCache, LlamaForCausalLM, _pick_token


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


class ContinuousBatchingEngine:
    """Slot-based continuous batching over a ragged-decode model.

    Parameters mirror the JAX engine's: ``max_slots`` (static decode
    batch width), ``prompt_buckets`` (static prefill lengths; chunk
    shapes are the buckets <= ``prefill_chunk``), ``decode_chunk``
    (decode steps per host fetch and per scheduling round),
    ``chunked_prefill`` (False: legacy one-shot prefill of the whole
    prompt, capped at the largest bucket), ``max_tokens_per_round``
    (default ``prefill_chunk + max_slots * decode_chunk``) and
    ``temperature``/``eos_id``. ``seed`` seeds the engine's
    ``torch.Generator`` (sampling only). The engine runs on the model's
    device.

    Thread safety: :meth:`submit`, :meth:`queue_depth` and
    :meth:`pop_finished` may be called from any thread; :meth:`step`
    (and :meth:`run`) from one pump thread.
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
        self.stats = {"prefills": 0, "chunks": 0, "decode_steps": 0,
                      "wasted_slot_steps": 0, "prefill_s": 0.0,
                      "chunk_s": 0.0, "prefill_chunks": 0,
                      "prefill_tokens": 0, "queue_depth": 0,
                      "ttft_s_sum": 0.0, "ttft_count": 0}

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

    def _occupy(self, slot: int, req: Request, fills: Dict[int, int]) -> None:
        self.stats["prefills"] += 1
        self._slot_req[slot] = req
        self._active_h[slot] = True  # optimistic; fixed at attribution
        fills[slot] = req.rid

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
            self._occupy(slot, req, fills)
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
            req, slot = self._prefilling, self._prefill_slot
            plan = _next_chunk(self._chunk_buckets, req.prefill_done,
                               int(req.prompt.size), remaining, self.max_seq)
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
            if final:
                self._set_slot(slot, tok_new, int(req.prompt.size),
                               req.max_new_tokens)
                self._occupy(slot, req, fills)
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

    def _run_chunk(self, fills: Dict[int, int]) -> None:
        """One decode chunk, then its packed fetch and the attribution of
        its tokens to the requests in the slots."""
        t0 = time.perf_counter()
        (self._tok, self._lengths, self._active, self._budget,
         packed) = _decode_chunk(
            self.model, self._cache, self._tok, self._lengths, self._active,
            self._budget, self._gen, n_steps=self.decode_chunk,
            temperature=self.temperature, eos_id=self.eos_id)
        arr = packed.cpu().numpy()  # the chunk's one host fetch
        self.stats["chunks"] += 1
        self.stats["decode_steps"] += self.decode_chunk
        self.stats["chunk_s"] += time.perf_counter() - t0
        K = self.decode_chunk
        tok_in, toks = arr[0], arr[1:K + 1]
        valid = arr[K + 1:2 * K + 1].astype(bool)
        active_out = arr[2 * K + 1].astype(bool)
        self.stats["wasted_slot_steps"] += int((~valid).sum())
        now = time.perf_counter()
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            n_before = len(req.tokens)
            if fills.get(slot) == req.rid:
                # the prefill's token rode in as this chunk's input
                req.tokens.append(int(tok_in[slot]))
            req.tokens.extend(int(t) for t in toks[valid[:, slot], slot])
            if len(req.tokens) > n_before and not req.first_token_at:
                req.first_token_at = now
                self.stats["ttft_s_sum"] += now - req.submitted_at
                self.stats["ttft_count"] += 1
            if not active_out[slot]:
                req.done = True
                req.finished_at = time.perf_counter()
                with self._lock:
                    self._done[req.rid] = self._reqs.pop(req.rid)
                self._slot_req[slot] = None
                self._active_h[slot] = False

    def step(self) -> bool:
        """One pump round: schedule prefill, then one decode chunk with
        its attribution. Returns True while work remains."""
        if self._closed:
            raise RuntimeError("engine is closed")
        fills = (self._schedule_prefill() if self.chunked_prefill
                 else self._fill_free_slots())
        self.stats["queue_depth"] = len(self._queue)
        if fills or self._active_h.any():
            self._run_chunk(fills)
        return bool(self._queue or self._prefilling is not None
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
        """Refuse further submit()/step() calls."""
        with self._lock:
            self._closed = True
