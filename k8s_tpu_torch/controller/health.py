"""The per-host obs HTTP endpoint (the port's copy of
``k8s_tpu/controller/health.py``: same routes, bodies and 404s).

Routes:
  ``/healthz``  -> 200 ``ok`` while the process is live (503 after
                   ``HealthServer.set_unhealthy()``); with a
                   ``stats_provider`` a JSON body ``{"ok": ..., <stats>}``
                   (the trainer's step heartbeat and ``hbm`` block).
  ``/metrics``  -> Prometheus text exposition from the process-global
                   :data:`k8s_tpu_torch.controller.metrics.REGISTRY`.
  ``/debug/flightrecorder``
                -> the attached flight recorder's ring of recent spans/
                   events (404 when none attached).
  ``/debug/profile?seconds=N``
                -> run the attached profiler hook for N seconds (a
                   bounded torch.profiler session into the flight-recorder
                   dir on trainer obs endpoints; 404 when no hook) and
                   return its JSON result.
  ``POST /v1/heartbeat/<ns>/<name>/<host>``
                -> pushed obs heartbeat: the JSON body goes to the
                   attached ``heartbeat_sink``; 404 when no sink or
                   unknown job.
"""

from __future__ import annotations

import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from k8s_tpu_torch.controller import metrics

log = logging.getLogger(__name__)


class _Handler(BaseHTTPRequestHandler):
    server: "_Server"

    def do_GET(self):  # noqa: N802 (http.server API)
        if self.path in ("/healthz", "/", "/readyz"):
            healthy = self.server.owner.healthy
            provider = self.server.owner.stats_provider
            if provider is not None:
                # stats-enriched healthz (the serving-server idiom):
                # liveness verdict + a JSON block of component stats,
                # e.g. the trainer's step heartbeat
                import json

                try:
                    # default=str: numpy scalars out of a training loop
                    # must not break serialization; the whole pipeline
                    # stays inside the guard — an unserializable stats
                    # dict must never break the LIVENESS probe either
                    body = json.dumps(
                        {"ok": healthy, **(provider() or {})},
                        default=str).encode() + b"\n"
                except Exception as e:  # stats must never break liveness
                    body = json.dumps(
                        {"ok": healthy, "stats_error": str(e)}
                    ).encode() + b"\n"
                ctype = "application/json"
            else:
                body = b"ok\n" if healthy else b"unhealthy\n"
                ctype = "text/plain; charset=utf-8"
            self.send_response(200 if healthy else 503)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/metrics":
            body = self.server.owner.registry.expose().encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path.split("?", 1)[0] == "/debug/profile":
            import json
            from urllib.parse import parse_qs, urlsplit

            hook = self.server.owner.profiler
            if hook is None:
                self.send_response(404)
                self.end_headers()
                return
            try:
                q = parse_qs(urlsplit(self.path).query)
                seconds = float((q.get("seconds") or ["2"])[0])
            except ValueError:
                seconds = 2.0
            # the hook blocks this handler thread for the capture
            # window (ThreadingHTTPServer — probes/scrapes unaffected)
            # and never raises (capture_profile's contract)
            try:
                result = hook(seconds)
            except Exception as e:  # a hook bug must not kill the probe
                result = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            body = json.dumps(result, default=str).encode() + b"\n"
            self.send_response(200 if result.get("ok") else 503)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/debug/flightrecorder":
            import json

            rec = self.server.owner.flight_recorder
            if rec is None:
                self.send_response(404)
                self.end_headers()
                return
            body = json.dumps(
                {"entries": rec.snapshot()}, default=str
            ).encode() + b"\n"
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self.send_response(404)
            self.end_headers()

    def do_POST(self):  # noqa: N802 (http.server API)
        parts = self.path.strip("/").split("/")
        # /v1/heartbeat/<ns>/<name>/<host>
        if len(parts) == 5 and parts[:2] == ["v1", "heartbeat"]:
            import json

            sink = self.server.owner.heartbeat_sink
            if sink is None:
                self.send_response(404)
                self.end_headers()
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                host = int(parts[4])
                ok = bool(sink(parts[2], parts[3], host, payload))
            except Exception as e:  # malformed push must not 500-loop
                log.debug("heartbeat push rejected: %s", e)
                ok = False
            self.send_response(204 if ok else 404)
            self.end_headers()
        else:
            self.send_response(404)
            self.end_headers()

    def log_message(self, fmt, *args):  # kubelet probes every few seconds
        log.debug("health: " + fmt, *args)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    owner: "HealthServer"
    # the stock listen backlog of 5 drops SYNs when a liveness probe, a
    # Prometheus scrape, a straggler-aggregation poll, and a flight-
    # recorder pull land together — each drop costs a 1s TCP retransmit
    request_queue_size = 128


class HealthServer:
    """Tiny embedded HTTP server for liveness + /metrics.

    ``port=0`` binds an ephemeral port (tests); the bound port is
    available as :attr:`port` after :meth:`start`.
    """

    def __init__(self, port: int, registry: Optional[metrics.Registry] = None,
                 host: str = "0.0.0.0", stats_provider=None,
                 flight_recorder=None, profiler=None):
        self.registry = registry or metrics.REGISTRY
        self.healthy = True
        # optional callable returning a dict merged into the /healthz
        # body (checkpoint goodput, scheduler stats, ...); None keeps
        # the plain "ok" contract
        self.stats_provider = stats_provider
        # optional k8s_tpu_torch.obs.trace.FlightRecorder served live at
        # /debug/flightrecorder (the on-disk dump covers the dead-pod
        # case; this route covers the live one)
        self.flight_recorder = flight_recorder
        # optional callable(seconds) -> dict behind /debug/profile —
        # the on-demand torch.profiler capture on trainer obs endpoints
        # (k8s_tpu_torch.obs.health.capture_profile); None keeps the
        # route 404
        self.profiler = profiler
        # optional callable(ns, name, host, payload) -> bool behind
        # POST /v1/heartbeat/... — Controller.ingest_heartbeat when the
        # operator wires it; None keeps the route 404
        self.heartbeat_sink = None
        self._server = _Server((host, port), _Handler)
        self._server.owner = self
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HealthServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="ktpu-health"
        )
        self._thread.start()
        log.info("health endpoint listening on :%d (/healthz, /metrics)", self.port)
        return self

    def set_unhealthy(self) -> None:
        self.healthy = False

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
