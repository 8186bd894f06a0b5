"""Peer-shard transport: how a restarted host reads OTHER hosts' local
tiers (port of ``k8s_tpu/ckpt/peer.py``, the same wire).

A replaced pod has an empty local disk; under data-parallel replication
its shards still exist byte-identical on peers' local tiers. The
restore planner sources missing shards through one of two transports:

- :class:`FilesystemPeerTransport` — peers' ``host-*`` dirs on a shared
  filesystem root.
- :class:`RestPeerTransport` + :class:`PeerShardServer` — every host
  serves its local tier over HTTP (``/v1/ckpt/steps``,
  ``/v1/ckpt/manifest/<step>``, ``/v1/ckpt/shard/<step>?leaf=&key=``,
  ``metav1.Status``-shaped error bodies, kept-alive connections per
  peer per restore worker); restarted pods fetch from the endpoints in
  ``KTPU_CKPT_PEERS``. A port host and a JAX host speak the same wire.

Both expose ``steps()``, ``manifest(step)`` and ``fetch(step, leaf,
key)``, and both report per-peer failures as *misses*, never
exceptions: a dead peer must degrade the restore to the persistent
tier, not wedge it.
"""

from __future__ import annotations

import http.client
import io
import json
import logging
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np

from k8s_tpu_torch.ckpt.local import LocalTier

log = logging.getLogger(__name__)

DEFAULT_TIMEOUT = 10.0


class FilesystemPeerTransport:
    """Read peers' local tiers straight off a shared filesystem root."""

    def __init__(self, root: str, self_host: int):
        self._tier = LocalTier(root, host_id=self_host)
        self.self_host = self_host

    def peers(self) -> List[int]:
        import os

        try:
            names = os.listdir(self._tier.root)
        except OSError:
            return []
        out = []
        for n in names:
            if n.startswith("host-"):
                try:
                    hid = int(n[len("host-"):])
                except ValueError:
                    continue
                if hid != self.self_host:
                    out.append(hid)
        return sorted(out)

    def steps(self) -> Dict[int, List[int]]:
        """Committed steps per peer host."""
        return {h: self._tier.committed_steps(host_id=h) for h in self.peers()}

    def progress(self) -> int:
        """Max recorded train progress across peers (see
        LocalTier.note_progress) — -1 when nobody recorded any."""
        import os

        best = -1
        for h in self.peers():
            hdir = os.path.join(self._tier.root, f"host-{h}")
            try:
                with open(os.path.join(hdir, "progress.json")) as f:
                    best = max(best, int(json.load(f)["step"]))
            except (OSError, ValueError, KeyError):
                continue
        return best

    def manifest(self, step: int, host: int) -> Optional[dict]:
        return self._tier.manifest(step, host_id=host)

    def fetch(self, step: int, leaf: str, key: str,
              host: int) -> Optional[np.ndarray]:
        return self._tier.read_shard(step, leaf, key, host_id=host)


# ---------------------------------------------------------------------------
# REST wire
# ---------------------------------------------------------------------------


class _ShardHandler(BaseHTTPRequestHandler):
    server: "_ShardServer"

    # keep-alive: a parallel restore fetches hundreds of shards from
    # the same few peers — HTTP/1.1 persistent connections turn that
    # into one TCP setup per (peer, client thread) instead of one per
    # shard. Every response already carries Content-Length, which is
    # what makes 1.1 keep-alive legal here.
    protocol_version = "HTTP/1.1"

    def do_GET(self):  # noqa: N802 (http.server API)
        tier: LocalTier = self.server.tier
        parsed = urllib.parse.urlsplit(self.path)
        parts = [p for p in parsed.path.split("/") if p]
        try:
            # /v1/ckpt/steps
            if parts == ["v1", "ckpt", "steps"]:
                return self._json(200, {
                    "host": tier.host_id,
                    "steps": tier.committed_steps(),
                    "progress": tier.progress(),
                })
            # /v1/ckpt/manifest/<step>
            if parts[:3] == ["v1", "ckpt", "manifest"] and len(parts) == 4:
                man = tier.manifest(int(parts[3]))
                if man is None:
                    return self._status(404, "NotFound",
                                        f"step {parts[3]} not committed")
                return self._json(200, man)
            # /v1/ckpt/shard/<step>?leaf=<path>&key=<index>
            if parts[:3] == ["v1", "ckpt", "shard"] and len(parts) == 4:
                q = {k: v[0] for k, v in
                     urllib.parse.parse_qs(parsed.query).items()}
                arr = tier.read_shard(int(parts[3]), q.get("leaf", ""),
                                      q.get("key", ""))
                if arr is None:
                    return self._status(
                        404, "NotFound",
                        f"shard {q.get('leaf')}[{q.get('key')}] "
                        f"@ step {parts[3]} missing or corrupt")
                buf = io.BytesIO()
                np.save(buf, arr)
                body = buf.getvalue()
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            return self._status(404, "NotFound", f"no route {parsed.path}")
        except BrokenPipeError:
            pass
        except Exception as e:  # a bad request must not kill the server
            # headers/partial body may already be on the wire: a 500
            # appended behind them would desynchronize a kept-alive
            # client — close this connection instead of reusing it
            self.close_connection = True
            try:
                self._status(500, "InternalError", str(e))
            except Exception:
                pass

    def _json(self, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _status(self, code: int, reason: str, message: str) -> None:
        # metav1.Status-shaped failure body — same vocabulary as the
        # local apiserver (api/wire.py:status_body)
        self._json(code, {
            "kind": "Status", "apiVersion": "v1", "status": "Failure",
            "reason": reason, "message": message, "code": code,
        })

    def log_message(self, fmt, *args):
        log.debug("peer-shard: " + fmt, *args)


class _ShardServer(ThreadingHTTPServer):
    daemon_threads = True
    tier: LocalTier


class PeerShardServer:
    """Serves one host's local tier over HTTP. ``port=0`` binds an
    ephemeral port (tests); the bound port is :attr:`port` after
    :meth:`start`."""

    def __init__(self, tier: LocalTier, port: int = 0,
                 host: str = "0.0.0.0"):
        self.tier = tier
        self._server = _ShardServer((host, port), _ShardHandler)
        self._server.tier = tier
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> "PeerShardServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"ckpt-peer-{self.tier.host_id}",
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


class RestPeerTransport:
    """Fetch peers' shards over the REST wire. ``endpoints`` maps host
    id -> base URL (from ``KTPU_CKPT_PEERS``:
    ``"0=http://svc-0:port,1=http://svc-1:port"``). Every failure is a
    miss; a peer that errors is skipped until the next :meth:`reset`
    (one timeout per dead peer per restore, not one per shard — the
    planner resets at the top of every plan).

    Connections are **kept alive** per (peer, calling thread): a
    parallel restore pulls hundreds of shards from the same few peers,
    and a fresh TCP connection per shard is both slow (handshake per
    fetch) and a SYN-backlog hazard under fan-out.
    Thread-local pooling makes the transport safe under the restore
    pipeline's worker pool with zero locking on the hot path; error
    bodies are always drained so a 404 miss never poisons the reused
    socket. A stale kept-alive socket (peer restarted, idle close) is
    retried ONCE on a fresh connection before the peer is declared
    dead — refused connections and timeouts fail immediately as
    before. Sockets die with their threads (the pool is per-restore)."""

    # stale-socket error classes worth one fresh-connection retry; a
    # refused connect or a timeout means the peer itself is the problem
    _RETRY_ERRORS = (http.client.BadStatusLine,
                     http.client.CannotSendRequest,
                     http.client.ResponseNotReady,
                     ConnectionResetError, BrokenPipeError)

    def __init__(self, endpoints: Dict[int, str], self_host: int,
                 timeout: float = DEFAULT_TIMEOUT):
        self.endpoints = {
            int(h): u.rstrip("/") for h, u in endpoints.items()
            if int(h) != self_host
        }
        self.self_host = self_host
        self.timeout = timeout
        self._dead: set = set()
        self._local = threading.local()  # per-thread {host: connection}
        self.reused_connections = 0  # requests served over a kept socket
        self._reused_lock = threading.Lock()  # counted from pool workers

    def reset(self) -> None:
        """Forget blacklisted peers (a recovered peer must be reachable
        again on the next restore)."""
        self._dead.clear()

    # -------------------------------------------------- connection pool

    def _conns(self) -> Dict[int, http.client.HTTPConnection]:
        conns = getattr(self._local, "conns", None)
        if conns is None:
            conns = self._local.conns = {}
        return conns

    def _conn(self, host: int) -> Optional[http.client.HTTPConnection]:
        conns = self._conns()
        c = conns.get(host)
        if c is None:
            parsed = urllib.parse.urlsplit(self.endpoints[host])
            if not parsed.hostname:
                return None
            if parsed.scheme == "https":
                c = http.client.HTTPSConnection(
                    parsed.hostname, parsed.port, timeout=self.timeout)
            else:
                c = http.client.HTTPConnection(
                    parsed.hostname, parsed.port or 80,
                    timeout=self.timeout)
            conns[host] = c
        return c

    def _base_path(self, host: int) -> str:
        """Any path prefix baked into the endpoint URL (a peer behind
        a routing proxy) — prepended to every request path, as the old
        urlopen(url + path) client did."""
        return urllib.parse.urlsplit(self.endpoints[host]).path

    def _drop_conn(self, host: int) -> None:
        c = self._conns().pop(host, None)
        if c is not None:
            try:
                c.close()
            except Exception:
                pass

    @classmethod
    def from_env_value(cls, raw: str, self_host: int,
                       timeout: float = DEFAULT_TIMEOUT
                       ) -> "RestPeerTransport":
        eps: Dict[int, str] = {}
        for part in (raw or "").split(","):
            part = part.strip()
            if not part or "=" not in part:
                continue
            hid, _, url = part.partition("=")
            try:
                eps[int(hid)] = url
            except ValueError:
                continue
        return cls(eps, self_host, timeout=timeout)

    def _get(self, host: int, path: str) -> Optional[bytes]:
        if host in self._dead or host not in self.endpoints:
            return None
        for attempt in (0, 1):
            conn = self._conn(host)
            if conn is None:
                return None
            reused = conn.sock is not None
            try:
                conn.request("GET", self._base_path(host) + path)
                resp = conn.getresponse()
                # ALWAYS drain the body — an unread error body on a
                # kept-alive socket would desynchronize every later
                # request on it
                body = resp.read()
                if reused:
                    with self._reused_lock:
                        self.reused_connections += 1
                if resp.status == 200:
                    return body
                if resp.status == 404:
                    return None  # an honest miss, peer is alive
                self._dead.add(host)
                self._drop_conn(host)
                return None
            except Exception as e:
                self._drop_conn(host)
                if attempt == 0 and reused \
                        and isinstance(e, self._RETRY_ERRORS):
                    continue  # stale kept-alive socket: one fresh retry
                log.warning("peer-shard host %d unreachable (%s); "
                            "skipping for this restore", host, e)
                self._dead.add(host)
                return None
        return None

    def peers(self) -> List[int]:
        return sorted(self.endpoints)

    def steps(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for h in self.peers():
            raw = self._get(h, "/v1/ckpt/steps")
            if raw is None:
                continue
            try:
                out[h] = list(json.loads(raw)["steps"])
            except (ValueError, KeyError):
                continue
        return out

    def progress(self) -> int:
        best = -1
        for h in self.peers():
            raw = self._get(h, "/v1/ckpt/steps")
            if raw is None:
                continue
            try:
                best = max(best, int(json.loads(raw).get("progress", -1)))
            except ValueError:
                continue
        return best

    def manifest(self, step: int, host: int) -> Optional[dict]:
        raw = self._get(host, f"/v1/ckpt/manifest/{step}")
        if raw is None:
            return None
        try:
            return json.loads(raw)
        except ValueError:
            return None

    def fetch(self, step: int, leaf: str, key: str,
              host: int) -> Optional[np.ndarray]:
        q = urllib.parse.urlencode({"leaf": leaf, "key": key})
        raw = self._get(host, f"/v1/ckpt/shard/{step}?{q}")
        if raw is None:
            return None
        try:
            return np.load(io.BytesIO(raw))
        except (ValueError, OSError):
            return None
