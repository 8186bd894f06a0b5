"""HTTP front-end for the continuous-batching engine (the port's own
copy of ``ServingFrontend`` from ``k8s_tpu/serving/server.py``).

Split of responsibilities, single-threaded where it matters:

- HTTP handler threads (stdlib ``ThreadingHTTPServer``) only call
  ``engine.submit`` (thread-safe) and wait on a per-request event.
- The PUMP runs in the caller's thread (:meth:`serve`): it alone calls
  ``engine.step``/``pop_finished`` and resolves waiters as requests
  finish.
- Drain: when ``should_stop()`` turns true (SIGTERM on job delete), the
  front-end stops accepting (503), pumps until every in-flight request
  finished, releases any stragglers and closes the engine.

API (JSON over HTTP, token ids in and out):

- ``POST /v1/generate`` ``{"prompt": [int, ...], "max_new_tokens": N}``
  -> ``{"tokens", "latency_s", "ttft_s", "itl_ms", "trace_id",
  "spans"}``; 429 + ``Retry-After`` when the engine queue is at
  ``max_queue_depth`` (> 0), 400 on a bad request, 503 while draining.
- ``GET /healthz`` -> engine stats (the prefix cache's and speculative
  decode's counters among them), queue depth, prefill progress, the
  scheduler's knobs (``prefix_cache_tokens`` among them) and, on a card,
  the ``hbm`` block.
- ``GET /metrics`` -> the Prometheus text of the process registry
  (:mod:`k8s_tpu_torch.controller.metrics`), its ``ktpu_serving_*``
  gauges refreshed from the engine's stats first.
- ``GET /v1/prefix/<digest>`` -> 200 with the held prefix snapshot as a
  :func:`~k8s_tpu_torch.serving.kv_transfer.pack_kv` body
  (``application/octet-stream``), or 404 for a digest this replica does
  not hold: the fetch side of the fleet's prefix directory.

Every other route answers 404: the disaggregation and migration routes
of the JAX front-end (``/v1/prefill``, ``/v1/decode``, ``/v1/kv``,
``/v1/migrate``, ``/v1/mirror``, ``/v1/drain_migrate``) come with a
later slice of the port.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict

import numpy as np

from k8s_tpu_torch.serving import kv_transfer


class Overloaded(RuntimeError):
    """The engine's live queue depth is at ``max_queue_depth``: mapped to
    HTTP 429 + ``Retry-After``, immediately, so a router in front of
    this replica sees the saturation instead of an unbounded queue."""


class _Result:
    """One finished request's tokens + timing, resolved to a waiter."""

    __slots__ = ("tokens", "ttft_s", "itl_ms", "spans")

    def __init__(self, tokens, ttft_s: float, itl_ms: float, spans):
        self.tokens = tokens
        self.ttft_s = ttft_s
        self.itl_ms = itl_ms
        # engine_queue_s + prefill_s == ttft_s (same timestamps);
        # decode_s is the stream after the first token
        self.spans = spans


class ServingFrontend:
    """Bind an HTTP server to ``engine``; :meth:`serve` pumps until
    ``should_stop()`` goes true, then drains. ``port=0`` binds an
    ephemeral port (read :attr:`port`)."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 request_timeout: float = 300.0, max_queue_depth: int = 0,
                 retry_after_s: float = 1.0):
        self.engine = engine
        self.request_timeout = float(request_timeout)
        self.max_queue_depth = int(max_queue_depth)
        self.retry_after_s = float(retry_after_s)
        self._lock = threading.Lock()
        self._waiters: Dict[int, threading.Event] = {}
        self._results: Dict[int, object] = {}
        self._work = threading.Event()   # poked by submissions
        self._draining = False
        self.served = 0      # results DELIVERED to a waiter
        self.abandoned = 0   # finished after the waiter timed out
        self.rejected = 0    # refused by backpressure (429s)
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: D102 - quiet logs
                pass

            def _json(self, code: int, payload: dict, headers=None):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _bytes(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 - stdlib naming
                if self.path == "/metrics":
                    from k8s_tpu_torch.controller import metrics as M

                    frontend._export_gauges()
                    return self._bytes(
                        200, M.REGISTRY.expose().encode("utf-8"),
                        "text/plain; version=0.0.4; charset=utf-8")
                if self.path.startswith("/v1/prefix/"):
                    packed = frontend.engine.export_prefix(
                        self.path[len("/v1/prefix/"):])
                    if packed is None:
                        return self._json(404, {"error": "prefix not held"})
                    return self._bytes(200, kv_transfer.pack_kv(*packed),
                                       "application/octet-stream")
                if self.path != "/healthz":
                    return self._json(404, {"error": "not found"})
                return self._json(200, frontend.health())

            def do_POST(self):  # noqa: N802
                if self.path != "/v1/generate":
                    return self._json(404, {"error": "not found"})
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n))
                    prompt = np.asarray(req["prompt"], np.int32)
                    max_new = int(req.get("max_new_tokens", 16))
                except (ValueError, TypeError, KeyError) as e:
                    return self._json(400, {"error": f"bad request: {e}"})
                trace_id = (self.headers.get("X-KTPU-Trace-Id", "")
                            or "req-" + uuid.uuid4().hex[:12])
                t0 = time.perf_counter()
                try:
                    result = frontend.submit_and_wait(prompt, max_new)
                except Overloaded as e:
                    return self._json(
                        429, {"error": str(e)},
                        headers={"Retry-After": f"{frontend.retry_after_s:g}"})
                except ValueError as e:     # engine validation
                    return self._json(400, {"error": str(e)})
                except TimeoutError as e:
                    return self._json(504, {"error": str(e)})
                except RuntimeError as e:   # draining/closed
                    return self._json(503, {"error": str(e)})
                return self._json(200, {
                    "tokens": [int(t) for t in result.tokens],
                    "latency_s": round(time.perf_counter() - t0, 4),
                    "ttft_s": round(result.ttft_s, 4),
                    "itl_ms": round(result.itl_ms, 3),
                    "trace_id": trace_id,
                    "spans": {k: round(v, 4) for k, v in result.spans.items()},
                })

        class Server(ThreadingHTTPServer):
            daemon_threads = True
            # the stock backlog of 5 drops SYNs under a burst of
            # concurrent clients (1 s retransmit latency cliffs)
            request_queue_size = 128

        self._server = Server((host, port), Handler)
        self.host = host
        self.port = int(self._server.server_address[1])
        self._http_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="serving-http")

    # -- handler-thread side ---------------------------------------------

    def _export_gauges(self):
        """Set the process registry's serving gauges from the engine's
        stats (on every /healthz and /metrics read, so a scrape sees the
        current values); returns the ``hbm`` block, or None off a card."""
        from k8s_tpu_torch.controller import metrics as M
        from k8s_tpu_torch.obs.health import hbm_block

        stats = self.engine.stats
        M.SERVING_PREFIX_CACHE_BYTES.set(float(stats["prefix_cache_bytes"]))
        if stats["spec_decode_rounds"]:
            M.SERVING_SPEC_DECODE_ROUNDS.set(float(stats["spec_decode_rounds"]))
            M.SERVING_SPEC_DECODE_DRAFTED.set(
                float(stats["spec_decode_drafted"]))
            M.SERVING_SPEC_DECODE_ACCEPTED.set(
                float(stats["spec_decode_accepted"]))
        return hbm_block(task="serving")

    def health(self) -> dict:
        eng = self.engine
        with self._lock:
            in_flight = len(self._waiters)
        hbm = self._export_gauges()
        return {
            "ok": not self._draining,
            **({"hbm": hbm} if hbm else {}),
            "draining": self._draining,
            "in_flight": in_flight,
            "served": self.served,
            "abandoned": self.abandoned,
            "rejected": self.rejected,
            "queue_depth": eng.queue_depth(),
            "prefill_progress": {
                str(rid): p for rid, p in eng.prefill_progress().items()},
            "scheduler": {
                "chunked_prefill": eng.chunked_prefill,
                "decode_chunk": eng.decode_chunk,
                "pipeline_depth": eng.pipeline_depth,
                "prefill_chunk": eng.prefill_chunk,
                "max_tokens_per_round": eng.max_tokens_per_round,
                "max_queue_depth": self.max_queue_depth,
                "prefix_cache_tokens": eng.prefix_cache_tokens,
            },
            "stats": {k: round(v, 4) if isinstance(v, float) else v
                      for k, v in eng.stats.items()},
        }

    def submit_and_wait(self, prompt, max_new_tokens: int) -> _Result:
        """Submit one request and block until its tokens are ready.
        Raises RuntimeError while draining (503), :class:`Overloaded`
        at the queue-depth threshold (429), TimeoutError (504)."""
        with self._lock:
            if self._draining:
                raise RuntimeError("draining: not accepting new requests")
            if self.max_queue_depth > 0 \
                    and self.engine.queue_depth() >= self.max_queue_depth:
                self.rejected += 1
                raise Overloaded(
                    f"engine queue depth {self.engine.queue_depth()} >= "
                    f"max_queue_depth {self.max_queue_depth}")
            rid = self.engine.submit(prompt, max_new_tokens)
            ev = threading.Event()
            self._waiters[rid] = ev
        self._work.set()
        if not ev.wait(self.request_timeout):
            with self._lock:
                self._waiters.pop(rid, None)
                self._results.pop(rid, None)
            raise TimeoutError(f"request {rid} timed out")
        with self._lock:
            result = self._results.pop(rid)
        if isinstance(result, Exception):
            raise result
        return result

    # -- pump side ---------------------------------------------------------

    def _resolve_finished(self) -> None:
        done = self.engine.pop_finished()
        if not done:
            return
        with self._lock:
            for rid, req in done.items():
                ev = self._waiters.pop(rid, None)
                if ev is None:
                    # the client timed out and left: drop the tokens
                    self.abandoned += 1
                    continue
                self.served += 1
                n = len(req.tokens)
                first, sub = req.first_token_at, req.submitted_at
                ttft = max(0.0, first - sub)
                decode_s = max(0.0, req.finished_at - first)
                itl_ms = 1e3 * decode_s / (n - 1) if n > 1 else 0.0
                ps = req.prefill_start_at
                self._results[rid] = _Result(
                    np.asarray(req.tokens, np.int32), ttft, itl_ms,
                    spans={"engine_queue_s": max(0.0, ps - sub),
                           "prefill_s": max(0.0, first - ps),
                           "decode_s": decode_s})
                ev.set()

    def serve(self, should_stop) -> None:
        """Run the pump until ``should_stop()`` — then drain and close.
        Returns only when the engine is fully drained."""
        self._http_thread.start()
        try:
            while not should_stop():
                busy = self.engine.step()
                self._resolve_finished()
                if not busy:
                    # idle: wait for a submission, 50 ms at most so a
                    # stop signal is seen promptly
                    self._work.wait(0.05)
                    self._work.clear()
        finally:
            self.drain()

    def drain(self) -> None:
        """Stop intake, finish in-flight requests, close the engine.
        Idempotent; releases every still-parked waiter (503) even if
        the drain pump raises."""
        with self._lock:
            if self._draining:
                return
            self._draining = True
        self._server.shutdown()
        try:
            while self.engine.step():
                self._resolve_finished()
            self._resolve_finished()
        finally:
            with self._lock:
                for rid, ev in list(self._waiters.items()):
                    self._results[rid] = RuntimeError(
                        "server draining before request finished")
                    ev.set()
                self._waiters.clear()
            self.engine.close()
            self._server.server_close()
