"""Pushed obs heartbeats — the worker half of the event-driven obs path
(the port's copy of ``k8s_tpu/obs/push.py``).

The polling design had the controller sweep every worker's
``/healthz`` each reconcile tick: O(jobs × hosts) HTTP round trips per
interval whether anything changed or not. The event-driven control
plane inverts the hot path: each worker POSTs its own heartbeat to the
operator
(``POST /v1/heartbeat/<ns>/<name>/<host>`` on the operator health
server), the controller caches it and kicks the owning job's reconcile
key — so a heartbeat costs one inbound request and zero polling.

Opt-in by env: the operator deployment sets ``KTPU_OPERATOR_HEALTH``
(``<operator-svc-dns>:<health-port>``); the trainer turns that into a
per-host ``KTPU_OBS_PUSH_URL`` on gang workers with an
``observability`` block, and :func:`maybe_start_pusher` (called from
``start_obs_server``) starts the push thread. Unset ⇒ nothing runs and
the controller falls back to its shared-poller pull.

Best-effort by design: a push failure is logged at debug and retried
next interval — the controller's pull path and resync backstop cover a
worker that can never reach the operator, so the trainer must never
block or crash on this thread's behalf.
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import threading
from typing import Callable, Optional
from urllib.parse import urlsplit

log = logging.getLogger(__name__)

PUSH_URL_ENV = "KTPU_OBS_PUSH_URL"
PUSH_INTERVAL_ENV = "KTPU_OBS_PUSH_INTERVAL"
DEFAULT_INTERVAL = 5.0


class HeartbeatPusher:
    """Daemon thread POSTing ``stats_fn()`` to ``url`` every
    ``interval`` seconds over one persistent connection (re-dialed on
    error — the operator restarting must not strand the pusher)."""

    def __init__(self, url: str, stats_fn: Callable[[], dict],
                 interval: float = DEFAULT_INTERVAL):
        self.url = url
        self.stats_fn = stats_fn
        self.interval = max(0.5, interval)
        u = urlsplit(url)
        self._host = u.hostname or "localhost"
        self._port = u.port or 80
        self._path = u.path or "/"
        self._conn: Optional[http.client.HTTPConnection] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.pushed = 0  # successful POSTs (tests assert on it)

    def start(self) -> "HeartbeatPusher":
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="obs-push")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        if self._conn is not None:
            try:
                self._conn.close()
            except Exception:
                pass
            self._conn = None

    def push_once(self) -> bool:
        """One POST; True on 2xx. Public so tests (and a final flush at
        teardown) can push synchronously."""
        try:
            body = json.dumps(self.stats_fn() or {}, default=str)
        except Exception as e:  # stats bug must not kill the thread
            log.debug("heartbeat push: stats_fn failed: %s", e)
            return False
        for attempt in (0, 1):  # retry once on a stale kept-alive conn
            try:
                if self._conn is None:
                    self._conn = http.client.HTTPConnection(
                        self._host, self._port, timeout=2.0)
                self._conn.request(
                    "POST", self._path, body=body,
                    headers={"Content-Type": "application/json"})
                resp = self._conn.getresponse()
                resp.read()
                if 200 <= resp.status < 300:
                    self.pushed += 1
                    return True
                return False  # 404: operator has no sink / unknown job
            except Exception as e:
                try:
                    if self._conn is not None:
                        self._conn.close()
                except Exception:
                    pass
                self._conn = None
                if attempt == 1:
                    log.debug("heartbeat push to %s failed: %s",
                              self.url, e)
        return False

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.push_once()


def maybe_start_pusher(stats_fn) -> Optional[HeartbeatPusher]:
    """Start a pusher iff ``KTPU_OBS_PUSH_URL`` is set (the trainer
    only sets it when the operator advertised its health endpoint)."""
    url = os.environ.get(PUSH_URL_ENV, "")
    if not url:
        return None
    try:
        interval = float(os.environ.get(PUSH_INTERVAL_ENV,
                                        DEFAULT_INTERVAL))
    except ValueError:
        interval = DEFAULT_INTERVAL
    return HeartbeatPusher(url, stats_fn, interval=interval).start()
