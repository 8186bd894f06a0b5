"""Shared replica-status poller: one connection-reusing component for
the whole controller, replacing the fresh ``threading.Thread`` +
``urllib.request.urlopen`` spawned per replica per reconcile tick
(``trainer/training.py`` pre-refactor) — at O(1000) jobs that was
thousands of thread creations and TCP handshakes per sweep.

(The port's copy of ``k8s_tpu/controller/poller.py``.)

Design (docs/SCHEDULER.md "Event-driven core"):

- **Connection reuse**: one persistent ``http.client.HTTPConnection``
  per ``(host, port)`` endpoint, re-dialed only on error. A worker's
  obs endpoint is scraped over the same socket tick after tick.
- **Per-endpoint batching**: URLs in one sweep are grouped by
  endpoint; each endpoint's requests run sequentially on its one
  connection while distinct endpoints fan out across a *shared*
  bounded executor — parallelism across hosts, zero per-tick thread
  churn.
- **Accounting**: every request increments
  ``ktpu_controller_http_calls_total`` (by component), the satellite
  counter the idle-scaling regression test asserts on.

Process-global singleton via :func:`shared_poller` — every
TrainingJob's default HTTP fetch path routes through it, threaded and
event-driven modes alike.
"""

from __future__ import annotations

import json
import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from http.client import HTTPConnection
from typing import Dict, List, Optional, Tuple
from urllib.parse import urlsplit

log = logging.getLogger(__name__)

DEFAULT_POOL_WORKERS = 16


class _Endpoint:
    """One (host, port) with a persistent connection + its own lock
    (requests to the same endpoint serialize — that IS the batching)."""

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self.lock = threading.Lock()
        self.conn: Optional[HTTPConnection] = None

    def get_json(self, path: str, timeout: float) -> Optional[dict]:
        with self.lock:
            for attempt in (0, 1):
                try:
                    if self.conn is None:
                        self.conn = HTTPConnection(
                            self.host, self.port, timeout=timeout)
                    self.conn.request("GET", path)
                    resp = self.conn.getresponse()
                    body = resp.read()
                    if resp.status != 200:
                        return None
                    return json.loads(body)
                except Exception:
                    # stale keep-alive, connect refusal, bad JSON:
                    # drop the socket; retry once with a fresh dial,
                    # then report a miss
                    try:
                        if self.conn is not None:
                            self.conn.close()
                    except Exception:
                        pass
                    self.conn = None
                    if attempt:
                        return None
        return None

    def close(self) -> None:
        with self.lock:
            if self.conn is not None:
                try:
                    self.conn.close()
                except Exception:
                    pass
                self.conn = None


class SharedStatusPoller:
    """Fetch many JSON status endpoints in one batched, connection-
    reusing sweep on a shared bounded executor."""

    def __init__(self, workers: int = DEFAULT_POOL_WORKERS):
        self._workers = max(1, int(workers))
        self._executor: Optional[ThreadPoolExecutor] = None
        self._endpoints: Dict[Tuple[str, int], _Endpoint] = {}
        self._lock = threading.Lock()

    def _pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=self._workers,
                    thread_name_prefix="status-poller")
            return self._executor

    def _endpoint(self, host: str, port: int) -> _Endpoint:
        with self._lock:
            ep = self._endpoints.get((host, port))
            if ep is None:
                ep = self._endpoints[(host, port)] = _Endpoint(host, port)
            return ep

    def fetch_json_many(self, urls: Dict[int, str], timeout: float = 2.0,
                        component: str = "obs",
                        ) -> Dict[int, dict]:
        """GET every URL (key → url) and return key → parsed JSON for
        the ones that answered. Per-host failures are misses, never
        errors — a host that answers nothing is the gang-restart
        path's problem, not this one's."""
        from k8s_tpu_torch.controller import metrics

        if not urls:
            return {}
        # group by endpoint: same-endpoint requests batch on one
        # connection; distinct endpoints fan out on the shared pool
        by_ep: Dict[Tuple[str, int], List[Tuple[int, str]]] = {}
        for key, url in urls.items():
            parts = urlsplit(url)
            host = parts.hostname or ""
            port = parts.port or 80
            path = parts.path or "/"
            if parts.query:
                path += "?" + parts.query
            by_ep.setdefault((host, port), []).append((key, path))
        metrics.CONTROLLER_HTTP_CALLS.inc(
            {"component": component}, by=float(len(urls)))
        out: Dict[int, dict] = {}
        out_lock = threading.Lock()

        def sweep(hp: Tuple[str, int],
                  reqs: List[Tuple[int, str]]) -> None:
            ep = self._endpoint(*hp)
            for key, path in reqs:
                payload = ep.get_json(path, timeout)
                if payload is not None:
                    with out_lock:
                        out[key] = payload

        if len(by_ep) == 1:
            ((hp, reqs),) = by_ep.items()
            sweep(hp, reqs)
            return out
        futures = [self._pool().submit(sweep, hp, reqs)
                   for hp, reqs in by_ep.items()]
        for f in futures:
            try:
                f.result(timeout=timeout + 3.0)
            except Exception:
                pass
        return out

    def close(self) -> None:
        with self._lock:
            endpoints = list(self._endpoints.values())
            self._endpoints.clear()
            executor, self._executor = self._executor, None
        for ep in endpoints:
            ep.close()
        if executor is not None:
            executor.shutdown(wait=False)


_shared: Optional[SharedStatusPoller] = None
_shared_lock = threading.Lock()


def shared_poller() -> SharedStatusPoller:
    global _shared
    with _shared_lock:
        if _shared is None:
            _shared = SharedStatusPoller()
        return _shared
