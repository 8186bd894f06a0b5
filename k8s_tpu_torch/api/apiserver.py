"""A minimal local Kubernetes apiserver speaking the real wire format
(the port's copy of ``k8s_tpu/api/apiserver.py``).

HTTP/JSON façade over :class:`k8s_tpu_torch.api.cluster.InMemoryCluster`, with
real apiserver semantics for everything the control plane relies on:

- CRUD on the group/version/plural paths (core ``/api/v1``, batch, apps,
  apiextensions, and the TpuJob CRD group) with ``metav1.Status`` error
  bodies (404 NotFound, 409 AlreadyExists / Conflict, 410 Gone)
- optimistic concurrency: a PUT carrying ``metadata.resourceVersion``
  must match or gets 409 Conflict; a PUT without it is an unconditional
  update (exactly the real apiserver contract the leader-election CAS
  depends on)
- list responses as ``{Kind}List`` with a list ``resourceVersion``
- streaming watches: ``?watch=true&resourceVersion=N`` returns
  newline-delimited ``{"type": ..., "object": ...}`` frames; a
  too-old RV yields an ``ERROR`` frame carrying a 410 Status, which is
  how a real apiserver reports watch staleness mid-stream
- ``DELETE`` on a collection with ``labelSelector`` = DeleteCollection

The reference could only test against a live GKE cluster (SURVEY §4:
"no multi-node simulator or fake backend"); this server is the missing
piece that lets the REST client backend
(:mod:`k8s_tpu_torch.api.restcluster`) and therefore the whole operator be
contract-tested against real wire semantics without a cluster. It is
also a usable dev apiserver: ``python -m k8s_tpu_torch.api.apiserver --port
8001`` serves an empty cluster that the operator (with
``KTPU_APISERVER_URL``) and ``tools/kubectl_local.py`` can share.
With ``--with-kubelet`` it is a single-node dev cluster: the port's
:class:`~k8s_tpu_torch.runtime.kubelet.LocalKubelet` runs the pods a
remote operator materializes, as subprocesses, and plays the node's GPU
device plugin (cards through ``CUDA_VISIBLE_DEVICES``; it forces no
platform).
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from k8s_tpu_torch.api import errors, wire
from k8s_tpu_torch.api.cluster import InMemoryCluster

log = logging.getLogger(__name__)


class _Request:
    """Parsed path + query of one API request."""

    def __init__(self, kind: str, namespace: Optional[str], name: Optional[str],
                 query: Dict[str, str], is_crd_registry: bool = False,
                 subresource: Optional[str] = None):
        self.kind = kind
        self.namespace = namespace
        self.name = name
        self.query = query
        self.is_crd_registry = is_crd_registry
        self.subresource = subresource


def _parse_path(path: str) -> Optional[_Request]:
    parsed = urllib.parse.urlsplit(path)
    query = {k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()}
    parts = [p for p in parsed.path.split("/") if p]
    # CRD registry: /apis/apiextensions.k8s.io/v1/customresourcedefinitions[/name]
    if parts[:3] == ["apis", "apiextensions.k8s.io", "v1"] and len(parts) >= 4 \
            and parts[3] == "customresourcedefinitions":
        return _Request("CustomResourceDefinition", None,
                        parts[4] if len(parts) > 4 else None, query,
                        is_crd_registry=True)
    if len(parts) >= 2 and parts[0] == "api":
        prefix, rest = f"/api/{parts[1]}", parts[2:]
    elif len(parts) >= 3 and parts[0] == "apis":
        prefix, rest = f"/apis/{parts[1]}/{parts[2]}", parts[3:]
    else:
        return None
    namespace: Optional[str] = None
    if len(rest) >= 2 and rest[0] == "namespaces":
        namespace, rest = rest[1], rest[2:]
    if not rest:
        return None
    kind = wire.PLURALS.get((prefix, rest[0]))
    if kind is None:
        return None
    name = rest[1] if len(rest) > 1 else None
    # subresources: /api/v1/namespaces/{ns}/pods/{name}/log
    sub = rest[2] if len(rest) > 2 else None
    return _Request(kind, namespace, name, query, subresource=sub)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: "_Server"

    # ------------------------------------------------------------- plumbing

    @property
    def cluster(self) -> InMemoryCluster:
        return self.server.cluster

    def _send_json(self, code: int, body: Dict[str, Any]) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_status(self, code: int, reason: str, message: str) -> None:
        self._send_json(code, wire.status_body(code, reason, message))

    def _read_body(self) -> Dict[str, Any]:
        n = int(self.headers.get("Content-Length", "0") or 0)
        return json.loads(self.rfile.read(n) or b"{}")

    def log_message(self, fmt, *args):
        log.debug("apiserver: " + fmt, *args)

    def _check_auth(self) -> bool:
        """Bearer-token check (when the server was given tokens) —
        simulates bound-SA-token expiry so the client's re-read-on-401
        path is contract-testable."""
        tokens = self.server.valid_tokens
        if tokens is None:
            return True
        auth = self.headers.get("Authorization", "")
        tok = auth[7:] if auth.startswith("Bearer ") else ""
        if tok in tokens:
            return True
        # drain any body so the keep-alive connection stays in sync
        n = int(self.headers.get("Content-Length", "0") or 0)
        if n:
            self.rfile.read(n)
        self._send_status(401, "Unauthorized", "invalid or expired token")
        return False

    def _send_api_error(self, e: Exception) -> None:
        """Catch-all (round-2 advisor): every backend failure becomes a
        structured metav1.Status, never a dropped keep-alive connection
        that the client can only report as a transport error."""
        if isinstance(e, errors.ApiError):
            reason = type(e).__name__.removesuffix("Error") or "InternalError"
            self._send_status(getattr(e, "code", 500) or 500, reason, str(e))
        else:
            self._send_status(500, "InternalError", f"{type(e).__name__}: {e}")

    def _paginate(self, items, query):
        """Serve ``limit``/``continue`` chunking (client-go style): the
        continue token is an opaque base64 offset. Real-apiserver
        caveat applies here too: pagination under concurrent writes is
        only self-consistent per page."""
        import base64

        try:
            limit = int(query.get("limit", "0") or 0)
        except ValueError:
            limit = 0
        offset = 0
        if query.get("continue"):
            try:
                offset = int(json.loads(
                    base64.b64decode(query["continue"]).decode())["offset"])
            except Exception:
                raise errors.InvalidError("malformed continue token")
        if not limit or offset + limit >= len(items):
            return items[offset:], None
        token = base64.b64encode(
            json.dumps({"offset": offset + limit}).encode()).decode()
        return items[offset:offset + limit], token

    def _req(self) -> Optional[_Request]:
        r = _parse_path(self.path)
        if r is None:
            self._send_status(404, "NotFound", f"no such path {self.path}")
            return None
        verb = self.command
        if verb == "GET" and r.name is None:
            verb = "WATCH" if r.query.get("watch") in ("true", "1") else "LIST"
        with self.server.stats_lock:
            self.server.stats[(verb, r.kind)] = \
                self.server.stats.get((verb, r.kind), 0) + 1
        return r

    # ------------------------------------------------------------ verbs

    def do_GET(self):  # noqa: N802
        if not self._check_auth():
            return
        r = self._req()
        if r is None:
            return
        if not r.is_crd_registry and r.name is None and \
                r.query.get("watch") in ("true", "1"):
            # dispatched OUTSIDE the catch-all: once the stream's 200 +
            # chunked headers are out, a Status body cannot be injected
            # — _serve_watch owns its error handling end to end
            return self._serve_watch(r)
        try:
            if r.is_crd_registry:
                return self._get_crd(r)
            if r.kind == "Pod" and r.subresource == "log":
                return self._serve_pod_log(r)
            if r.name is not None:
                obj = self.cluster.get(r.kind, r.namespace or "default", r.name)
                return self._send_json(200, wire.stamp_type_meta(r.kind, obj))
            sel = (wire.parse_label_selector(r.query["labelSelector"])
                   if "labelSelector" in r.query else None)
            items = self.cluster.list(r.kind, r.namespace, sel)
            items, cont = self._paginate(items, r.query)
            meta: Dict[str, Any] = {
                "resourceVersion": str(self.cluster.resource_version)}
            if cont:
                meta["continue"] = cont
            return self._send_json(200, {
                "kind": f"{r.kind}List",
                "apiVersion": wire.ROUTES[r.kind].api_version,
                "metadata": meta,
                "items": [wire.stamp_type_meta(r.kind, o) for o in items],
            })
        except errors.NotFoundError as e:
            self._send_status(404, "NotFound", str(e))
        except errors.OutdatedVersionError as e:
            self._send_status(410, "Gone", str(e))
        except Exception as e:  # noqa: BLE001 - wire boundary
            self._send_api_error(e)

    def do_POST(self):  # noqa: N802
        if not self._check_auth():
            return
        body = self._read_body()  # drain before any error response —
        # leftover body bytes would desync a keep-alive connection
        r = self._req()
        if r is None:
            return
        try:
            if r.is_crd_registry:
                name = body.get("metadata", {}).get("name", "")
                self.cluster.create_crd(name, body.get("spec", {}))
                return self._send_json(201, self._crd_object(name))
            body.setdefault("metadata", {}).setdefault(
                "namespace", r.namespace or "default")
            created = self.cluster.create(r.kind, body)
            return self._send_json(201, wire.stamp_type_meta(r.kind, created))
        except errors.AlreadyExistsError as e:
            self._send_status(409, "AlreadyExists", str(e))
        except Exception as e:  # noqa: BLE001 - wire boundary
            self._send_api_error(e)

    def do_PUT(self):  # noqa: N802
        if not self._check_auth():
            return
        body = self._read_body()  # drain before any error response
        r = self._req()
        if r is None:
            return
        body.setdefault("metadata", {}).setdefault(
            "namespace", r.namespace or "default")
        # real apiserver contract: RV in the payload => CAS, absent => last
        # write wins. The leader-election lock rides on the CAS branch.
        check = bool(body.get("metadata", {}).get("resourceVersion"))
        try:
            updated = self.cluster.update(r.kind, body, check_version=check)
            return self._send_json(200, wire.stamp_type_meta(r.kind, updated))
        except errors.NotFoundError as e:
            self._send_status(404, "NotFound", str(e))
        except errors.ConflictError as e:
            self._send_status(409, "Conflict", str(e))
        except Exception as e:  # noqa: BLE001 - wire boundary
            self._send_api_error(e)

    def do_DELETE(self):  # noqa: N802
        if not self._check_auth():
            return
        r = self._req()
        if r is None:
            return
        try:
            if r.name is not None:
                self.cluster.delete(r.kind, r.namespace or "default", r.name)
                return self._send_json(200, {
                    "kind": "Status", "apiVersion": "v1", "status": "Success",
                })
            sel = (wire.parse_label_selector(r.query["labelSelector"])
                   if "labelSelector" in r.query else {})
            victims = self.cluster.list(r.kind, r.namespace or "default", sel)
            self.cluster.delete_collection(r.kind, r.namespace or "default", sel)
            return self._send_json(200, {
                "kind": f"{r.kind}List",
                "apiVersion": wire.ROUTES[r.kind].api_version,
                "metadata": {},
                "items": victims,
            })
        except errors.NotFoundError as e:
            self._send_status(404, "NotFound", str(e))
        except Exception as e:  # noqa: BLE001 - wire boundary
            self._send_api_error(e)

    def _serve_pod_log(self, r: _Request) -> None:
        """``GET .../pods/{name}/log`` — the kubectl-logs subresource.
        Real clusters proxy this to the kubelet; here the kubelet's
        ``--log-dir`` is local to the apiserver process (the
        ``--with-kubelet`` dev-cluster shape), so the file is served
        directly. ``?tailLines=N`` supported. Text/plain body like the
        real thing, not JSON."""
        import os as _os

        log_dir = self.server.log_dir
        if not log_dir:
            return self._send_status(
                404, "NotFound",
                "pod logs not available: this apiserver has no --log-dir "
                "(run with --with-kubelet, or read the kubelet's log dir "
                "directly)")
        # the pod must exist (or have existed: its log outlives it —
        # serve the file regardless, like kubectl logs on a crashed pod)
        path = _os.path.join(log_dir, f"{r.name}.log")
        if not _os.path.exists(path):
            return self._send_status(
                404, "NotFound", f"no log for pod {r.namespace}/{r.name}")
        with open(path, "rb") as f:
            data = f.read()
        tail = r.query.get("tailLines")
        if tail is not None:
            try:
                n = int(tail)
                lines = data.splitlines(keepends=True)
                # real-apiserver semantics: 0 → nothing; negatives are
                # meaningless and also yield nothing (never a head-drop)
                data = b"".join(lines[-n:]) if n > 0 else b""
            except ValueError:
                pass
        self.send_response(200)
        self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    # ------------------------------------------------------------ CRDs

    def _crd_object(self, name: str) -> Dict[str, Any]:
        crd = self.cluster.get_crd(name)
        established = "True" if crd.get("established") else "False"
        return {
            "apiVersion": "apiextensions.k8s.io/v1",
            "kind": "CustomResourceDefinition",
            "metadata": {"name": name},
            "spec": crd.get("spec", {}),
            "status": {"conditions": [
                {"type": "Established", "status": established},
            ]},
        }

    def _get_crd(self, r: _Request) -> None:
        if r.name is None:
            self._send_status(405, "MethodNotAllowed", "list CRDs unsupported")
            return
        try:
            self._send_json(200, self._crd_object(r.name))
        except errors.NotFoundError as e:
            self._send_status(404, "NotFound", str(e))

    # ------------------------------------------------------------ watch

    def _serve_watch(self, r: _Request) -> None:
        try:
            rv = r.query.get("resourceVersion")
            timeout_s = float(r.query.get("timeoutSeconds", "0") or 0)
            start_rv = int(rv) if rv not in (None, "", "0") else None
        except ValueError:
            return self._send_status(400, "BadRequest",
                                     "bad resourceVersion/timeoutSeconds")
        try:
            watcher = self.cluster.watch(r.kind, r.namespace, start_rv)
        except errors.OutdatedVersionError as e:
            # real apiserver behavior: the stream opens, then reports
            # staleness as an ERROR frame carrying a 410 Status
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            self._write_chunk(json.dumps({
                "type": "ERROR",
                "object": wire.status_body(410, "Gone", str(e)),
            }) + "\n")
            self._write_chunk("")
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        deadline = time.monotonic() + timeout_s if timeout_s else None
        bookmarks = r.query.get("allowWatchBookmarks") in ("true", "1")
        last_bookmark = time.monotonic()
        try:
            while not self.server.stopping:
                ev = watcher.next(timeout=0.2)
                if ev is None:
                    # a vanished client is only noticed at the next event
                    # write; clients bound the stream with timeoutSeconds
                    # (and re-dial) exactly like a real watch
                    if deadline is not None and time.monotonic() > deadline:
                        break
                    if bookmarks and time.monotonic() - last_bookmark > 1.0:
                        # idle progress marker: lets a quiet kind's
                        # watcher re-dial from a fresh RV instead of an
                        # ancient one that would 410 (real apiserver
                        # sends these ~per minute; 1s here so tests see
                        # them quickly)
                        last_bookmark = time.monotonic()
                        self._write_chunk(json.dumps({
                            "type": "BOOKMARK",
                            "object": {
                                "kind": r.kind,
                                "apiVersion": wire.ROUTES[r.kind].api_version,
                                "metadata": {"resourceVersion": str(
                                    self.cluster.resource_version)},
                            },
                        }) + "\n")
                    continue
                frame = {
                    "type": ev.type,
                    "object": wire.stamp_type_meta(ev.kind, dict(ev.object)),
                }
                self._write_chunk(json.dumps(frame) + "\n")
        except Exception as e:  # noqa: BLE001 - headers already sent:
            # nothing structured can be written anymore; drop the
            # connection cleanly and let the client re-dial (its EOF
            # path). Pipe/reset errors are the normal client-vanished
            # case, anything else gets logged.
            if not isinstance(e, (BrokenPipeError, ConnectionResetError)):
                log.warning("watch %s: stream aborted: %s", r.kind, e)
        finally:
            watcher.stop()
        try:
            self._write_chunk("")
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _write_chunk(self, s: str) -> None:
        data = s.encode()
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    cluster: InMemoryCluster
    stopping = False
    # O(100) clients (operators, kubelets, user pollers) may connect in
    # one burst; the socketserver default backlog of 5 RSTs the rest
    request_queue_size = 256

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        # request bill per (verb, kind) — lets scale tests assert the
        # operator's request RATE, not just its outcomes
        self.stats: Dict[Tuple[str, str], int] = {}
        self.stats_lock = threading.Lock()
        # None = no auth; a set = every request must bear one of these
        # tokens (simulates bound-SA-token expiry for contract tests)
        self.valid_tokens = None
        # kubelet log dir for the pods/{name}/log subresource (the
        # --with-kubelet dev-cluster shape); None = logs unavailable
        self.log_dir = None


class LocalApiServer:
    """Embeddable apiserver: ``LocalApiServer().start().url`` -> serve a
    (possibly shared) InMemoryCluster over the real wire format."""

    def __init__(self, cluster: Optional[InMemoryCluster] = None, port: int = 0,
                 host: str = "127.0.0.1", auth_tokens=None,
                 log_dir: Optional[str] = None):
        self.cluster = cluster or InMemoryCluster()
        self._server = _Server((host, port), _Handler)
        self._server.cluster = self.cluster
        self._server.log_dir = log_dir
        if auth_tokens is not None:
            self._server.valid_tokens = set(auth_tokens)
        self.host = host
        self.port = self._server.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._thread: Optional[threading.Thread] = None

    @property
    def stats(self) -> Dict[Tuple[str, str], int]:
        with self._server.stats_lock:
            return dict(self._server.stats)

    def set_auth_tokens(self, tokens) -> None:
        """Rotate the accepted token set (simulates SA-token expiry)."""
        self._server.valid_tokens = set(tokens) if tokens is not None else None

    def start(self) -> "LocalApiServer":
        # a short poll, so that stop() returns within 50 ms
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True, name="ktpu-apiserver")
        self._thread.start()
        log.info("local apiserver on %s", self.url)
        return self

    def stop(self) -> None:
        self._server.stopping = True
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def main(argv=None) -> int:
    import os
    import signal
    import tempfile

    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(prog="ktpu-apiserver")
    p.add_argument("--port", type=int, default=8001,
                   help="listen port (0 = an ephemeral port, printed)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--with-kubelet", action="store_true",
                   help="also run a node agent against this server, so "
                        "pods created by a remote operator actually run "
                        "as subprocesses (dev 'single-node cluster')")
    p.add_argument("--log-dir", default=os.path.join(
        tempfile.gettempdir(), "ktpu-logs"), help="pod logs")
    args = p.parse_args(argv)
    stop = threading.Event()
    # SIGTERM stops the node agent too, so no pod outlives the server
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    srv = LocalApiServer(
        port=args.port, host=args.host,
        log_dir=args.log_dir if args.with_kubelet else None,
    ).start()
    kubelet = None
    if args.with_kubelet:
        from k8s_tpu_torch.api.client import KubeClient
        from k8s_tpu_torch.runtime.kubelet import LocalKubelet, SubprocessExecutor

        kubelet = LocalKubelet(KubeClient(srv.cluster),
                               SubprocessExecutor(log_dir=args.log_dir))
        kubelet.start()
    print(f"serving on {srv.url} (ctrl-c to stop)"
          + (" with node agent" if kubelet else ""), flush=True)
    try:
        while not stop.is_set():
            stop.wait(0.5)
    finally:
        if kubelet is not None:
            kubelet.stop()
        srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
