"""REST backend for the control plane: drives a real Kubernetes
apiserver (or :mod:`k8s_tpu_torch.api.apiserver` speaking the same wire
format) through the exact interface :class:`InMemoryCluster` exposes, so
``Controller``/``TrainingJob``/``LeaderElector`` run unmodified against
either backend.
(The port's copy of ``k8s_tpu/api/restcluster.py``.)

This is the analogue of the reference's client-go plumbing
(``pkg/util/k8sutil/k8sutil.go:45-65`` bootstrap,
``tf_job_client.go:56-86`` CRD REST client with its raw-HTTP watch), in
plain stdlib HTTP — the environment ships no ``kubernetes`` package,
and the surface we need (CRUD + label-selector list/delete-collection +
streaming watch with 410 recovery) is small enough to own.

Semantics mapping:

- errors: 404 -> NotFoundError, 409 reason AlreadyExists ->
  AlreadyExistsError, 409 reason Conflict -> ConflictError, 410 ->
  OutdatedVersionError
- ``update(check_version=False)`` strips ``metadata.resourceVersion``
  (unconditional update); ``check_version=True`` sends it, making the
  apiserver CAS — the leader-election lock uses this branch, so
  election inherits the *real* resourceVersion semantics
- ``watch()`` holds a streaming GET; on EOF it re-dials from the last
  seen RV (the reference's watch re-dial, ``controller.go:292-376``); a
  410 — as a status or an in-stream ERROR frame — surfaces as
  ``OutdatedVersionError`` from ``next()``/iteration so the controller
  relists
"""

from __future__ import annotations

import json
import logging
import os
import queue
import ssl
import threading
import time
from typing import Any, Dict, List, Optional


from k8s_tpu_torch.api import errors, wire
from k8s_tpu_torch.api.cluster import WatchEvent
from k8s_tpu_torch.robustness.backoff import Backoff, BackoffPolicy

log = logging.getLogger(__name__)

# Watch re-dial schedule: clean EOFs re-dial immediately (note_success),
# stream errors space out 1s → 30s with jitter.
WATCH_REDIAL_POLICY = BackoffPolicy(
    base=1.0, factor=2.0, cap=30.0, jitter=0.5, reset_after=60.0
)


def _raise_for_status(code: int, body: bytes,
                      retry_after: Optional[str] = None) -> None:
    try:
        status = json.loads(body or b"{}")
    except ValueError:
        status = {}
    message = status.get("message", body.decode(errors="replace")[:200])
    reason = status.get("reason", "")
    if code == 401:
        raise errors.UnauthorizedError(message)
    if code == 403:
        raise errors.ForbiddenError(message)
    if code == 404:
        raise errors.NotFoundError(message)
    if code == 409:
        if reason == "Conflict":
            raise errors.ConflictError(message)
        raise errors.AlreadyExistsError(message)
    if code == 410:
        raise errors.OutdatedVersionError(message)
    if code == 422:
        raise errors.InvalidError(message)
    if code == 429:
        try:
            after = float(retry_after) if retry_after else 1.0
        except ValueError:
            after = 1.0
        raise errors.TooManyRequestsError(message, retry_after=after)
    raise errors.ApiError(f"HTTP {code}: {message}")


class FileTokenSource:
    """Bound serviceaccount tokens rotate (~1h on real clusters); the
    reference's client-go re-read them transparently
    (``tf_job_client.go:56-86`` via rest.InClusterConfig). This source
    re-reads the mounted token file with a short TTL cache, and
    ``force=True`` (the 401-retry path) bypasses the cache."""

    def __init__(self, path: str, ttl: float = 60.0):
        self.path = path
        self.ttl = ttl
        self._cached: Optional[str] = None
        self._read_at = 0.0
        self._lock = threading.Lock()

    def __call__(self, force: bool = False) -> Optional[str]:
        with self._lock:
            now = time.monotonic()
            if force or self._cached is None or now - self._read_at > self.ttl:
                try:
                    with open(self.path) as f:
                        self._cached = f.read().strip()
                except OSError:
                    pass  # keep the stale token; better than none
                self._read_at = now
            return self._cached


class RestWatcher:
    """Watcher-compatible streaming watch over HTTP.

    A reader thread converts wire frames into :class:`WatchEvent`s; EOF
    re-dials from the last seen resourceVersion; 410 staleness is queued
    as a sentinel and raised from :meth:`next` as OutdatedVersionError.
    """

    _STALE = object()

    def __init__(self, cluster: "RestCluster", kind: str,
                 namespace: Optional[str], resource_version: Optional[int]):
        self._cluster = cluster
        self.kind = kind
        self.namespace = namespace
        self._rv = resource_version
        self.q: "queue.Queue[Any]" = queue.Queue()
        self.closed = False
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"rest-watch-{kind}"
        )
        self._thread.start()

    # -- reader side ----------------------------------------------------

    def _run(self) -> None:
        # unified policy: clean EOF re-dials immediately; errors back off
        bo = Backoff(WATCH_REDIAL_POLICY)
        while not self.closed:
            if bo.remaining() > 0:
                time.sleep(bo.remaining())
                if self.closed:
                    return
            try:
                self._stream_once()
                bo.note_success()
            except errors.OutdatedVersionError:
                self.q.put(self._STALE)
                return
            except Exception as e:
                if self.closed:
                    return
                delay = bo.note_failure()
                log.debug("watch %s: stream error, re-dial in %.1fs: %s",
                          self.kind, delay, e)
            # EOF / server timeout: re-dial from last seen RV

    def _stream_once(self) -> None:
        params = {"watch": "true", "timeoutSeconds": "300",
                  # BOOKMARK frames advance our re-dial RV on quiet
                  # kinds, so an EOF re-dial doesn't start from an RV
                  # old enough to 410
                  "allowWatchBookmarks": "true"}
        if self._rv is not None:
            params["resourceVersion"] = str(self._rv)
        resp = self._cluster._open(
            "GET", wire.ROUTES[self.kind].collection_path(self.namespace),
            params=params, stream=True,
        )
        with resp:
            for line in resp:
                if self.closed:
                    return
                line = line.strip()
                if not line:
                    continue
                frame = json.loads(line)
                if frame.get("type") == "ERROR":
                    code = (frame.get("object") or {}).get("code")
                    if code == 410:
                        raise errors.OutdatedVersionError(
                            (frame.get("object") or {}).get("message", "gone")
                        )
                    log.warning("watch %s: ERROR frame: %s", self.kind, frame)
                    continue
                obj = frame.get("object") or {}
                rv = (obj.get("metadata") or {}).get("resourceVersion")
                if rv is not None:
                    try:
                        self._rv = int(rv)
                    except ValueError:
                        pass
                if frame.get("type") == "BOOKMARK":
                    # progress marker only — consumed here (rv noted
                    # above), never surfaced as an object event
                    continue
                self.q.put(WatchEvent(frame["type"], self.kind, obj))

    # -- consumer side (Watcher interface) ------------------------------

    def stop(self) -> None:
        self.closed = True
        self.q.put(None)

    def _item(self, item: Any) -> Optional[WatchEvent]:
        if item is self._STALE:
            raise errors.OutdatedVersionError("watch resourceVersion too old")
        return item

    def __iter__(self):
        while True:
            ev = self._item(self.q.get())
            if ev is None:
                return
            yield ev

    def next(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        try:
            return self._item(self.q.get(timeout=timeout))
        except queue.Empty:
            return None


class RestCluster:
    """The InMemoryCluster method surface, over HTTP."""

    # paged LISTs: a real apiserver truncates large collections unless
    # the client follows metadata.continue; client-go defaults 500
    LIST_PAGE_LIMIT = 500
    # 429 (API priority & fairness) retry budget
    MAX_THROTTLE_RETRIES = 3

    def __init__(self, base_url: str, token=None,
                 ssl_context: Optional[ssl.SSLContext] = None,
                 timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        # `token` is a str (static) or a callable(force: bool) -> str
        # (rotating source, e.g. FileTokenSource for bound SA tokens)
        if token is None or callable(token):
            self._token_source = token
        else:
            self._token_source = lambda force=False: token
        self._ctx = ssl_context
        self._timeout = timeout
        self._last_rv = 0
        self._local = threading.local()  # per-thread keep-alive conn
        import urllib.parse

        # a base-URL path prefix (proxied clusters, kubectl proxy
        # sub-paths) must prefix every request target
        self._path_prefix = urllib.parse.urlsplit(self.base_url).path.rstrip("/")
        # kubelet-simulator hooks don't exist on a real cluster; the
        # attribute exists so local-mode code can feature-test it
        self.hooks: List[Any] = []

    # ------------------------------------------------------------ http

    def _new_conn(self, timeout: float):
        import http.client
        import urllib.parse

        parsed = urllib.parse.urlsplit(self.base_url)
        if parsed.scheme == "https":
            return http.client.HTTPSConnection(
                parsed.hostname, parsed.port or 443,
                context=self._ctx, timeout=timeout,
            )
        return http.client.HTTPConnection(
            parsed.hostname, parsed.port or 80, timeout=timeout,
        )

    def _open(self, method: str, path: str, body: Optional[Dict[str, Any]] = None,
              params: Optional[Dict[str, str]] = None, stream: bool = False):
        """One HTTP exchange over a THREAD-LOCAL persistent connection
        (keep-alive): stdlib urllib opens a fresh TCP connection per
        request, which capped the controller at ~40 reconcilers before
        request latency starved the reconcile loop. A stale keep-alive
        (server closed between requests) is retried once on a fresh
        connection; streams get their own connection since the watch
        holds it open indefinitely."""
        import http.client

        q = wire.encode_query(params or {})
        target = self._path_prefix + path + ("?" + q if q else "")
        data = json.dumps(body).encode() if body is not None else None

        def headers_for(force_token: bool) -> Dict[str, str]:
            h = {"Accept": "application/json"}
            if data is not None:
                h["Content-Type"] = "application/json"
            if self._token_source is not None:
                tok = self._token_source(force=force_token)
                if tok:
                    h["Authorization"] = f"Bearer {tok}"
            return h

        # streams still need a read timeout: a connection dropped without
        # FIN/RST would otherwise hang the watch thread forever. Slightly
        # above the 300s server-side watch bound so normal timeouts win.
        timeout = 330.0 if stream else self._timeout
        if stream:
            conn = self._new_conn(timeout)  # dedicated: held open by watch
        else:
            conn = getattr(self._local, "conn", None)
            if conn is None:
                conn = self._new_conn(timeout)
                self._local.conn = conn
        conn_retried = auth_retried = False
        force_token = False
        while True:
            try:
                conn.request(method, target, body=data,
                             headers=headers_for(force_token))
                resp = conn.getresponse()
            except (OSError, http.client.HTTPException):
                # OSError covers Connection*/BrokenPipe/timeouts/DNS
                conn.close()
                conn = self._new_conn(timeout)
                if not stream:
                    self._local.conn = conn
                # POST is not idempotent: a create may have committed
                # before the connection died — surface the error rather
                # than re-send and manufacture an AlreadyExists.
                # NOTE a retried PUT can also observe its OWN committed
                # first attempt: a CAS PUT (election renew) that died
                # mid-response gets 409 Conflict from its own write. The
                # elector treats that as indeterminate and re-reads the
                # lock before conceding (election.py) — same behavior
                # class as client-go's retry semantics.
                if conn_retried or method == "POST":
                    raise
                conn_retried = True
                continue
            if resp.status == 401 and not auth_retried and \
                    self._token_source is not None:
                # bound SA token rotated underneath us: re-read the
                # source (force) and retry once
                resp.read()
                auth_retried = True
                force_token = True
                continue
            break
        if resp.status >= 400:
            body_bytes = resp.read()  # drains; connection stays reusable
            _raise_for_status(resp.status, body_bytes,
                              retry_after=resp.headers.get("Retry-After"))
        return resp

    def _call(self, method: str, path: str, body: Optional[Dict[str, Any]] = None,
              params: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
        for attempt in range(self.MAX_THROTTLE_RETRIES + 1):
            try:
                with self._open(method, path, body, params) as resp:
                    out = json.loads(resp.read() or b"{}")
                self._note_rv(out)
                return out
            except errors.TooManyRequestsError as e:
                # APF throttling: honor Retry-After (bounded), retry
                if attempt >= self.MAX_THROTTLE_RETRIES:
                    raise
                time.sleep(min(e.retry_after, 10.0))

    def _note_rv(self, obj: Dict[str, Any]) -> None:
        rv = (obj.get("metadata") or {}).get("resourceVersion")
        if rv:
            try:
                self._last_rv = max(self._last_rv, int(rv))
            except ValueError:
                pass

    @property
    def resource_version(self) -> int:
        """Highest RV observed in any response — the 'watch from now'
        anchor the controller uses after a relist."""
        return self._last_rv

    # ------------------------------------------------------------ CRUD

    def create(self, kind: str, obj: Dict[str, Any]) -> Dict[str, Any]:
        ns = obj.get("metadata", {}).get("namespace", "default")
        return self._call("POST", wire.ROUTES[kind].collection_path(ns), body=obj)

    def get(self, kind: str, namespace: str, name: str) -> Dict[str, Any]:
        return self._call("GET", wire.ROUTES[kind].object_path(namespace, name))

    def update(self, kind: str, obj: Dict[str, Any],
               check_version: bool = False) -> Dict[str, Any]:
        import copy

        obj = copy.deepcopy(obj)
        m = obj.setdefault("metadata", {})
        ns, name = m.get("namespace", "default"), m.get("name")
        if not check_version:
            m.pop("resourceVersion", None)  # unconditional update
        return self._call("PUT", wire.ROUTES[kind].object_path(ns, name), body=obj)

    def delete(self, kind: str, namespace: str, name: str, cascade: bool = True) -> None:
        # cascade rides on ownerReferences: a real cluster's GC controller
        # reaps dependents, our local apiserver's store does the same
        self._call("DELETE", wire.ROUTES[kind].object_path(namespace, name))

    def list(self, kind: str, namespace: Optional[str] = None,
             label_selector: Optional[Dict[str, str]] = None) -> List[Dict[str, Any]]:
        """Paged list: follows ``metadata.continue`` so collections
        larger than one server page (e.g. the Pods of a v5p-128 job)
        aren't silently truncated — client-go chunking semantics."""
        return self.list_with_rv(kind, namespace, label_selector)[0]

    def list_with_rv(self, kind: str, namespace: Optional[str] = None,
                     label_selector: Optional[Dict[str, str]] = None):
        """List + the list's OWN ``metadata.resourceVersion`` — the only
        correct anchor for a reflector's subsequent watch. Anchoring on
        the client-wide ``resource_version`` high-water mark instead
        would skip any event committed (by another thread on this
        shared client) between the LIST snapshot and the watch start."""
        params: Dict[str, str] = {"limit": str(self.LIST_PAGE_LIMIT)}
        if label_selector:
            params["labelSelector"] = wire.format_label_selector(label_selector)
        items: List[Dict[str, Any]] = []
        list_rv = 0
        while True:
            out = self._call("GET", wire.ROUTES[kind].collection_path(namespace),
                             params=params)
            items.extend(out.get("items", []))
            if not list_rv:
                try:
                    list_rv = int((out.get("metadata") or {})
                                  .get("resourceVersion", 0))
                except (TypeError, ValueError):
                    list_rv = 0
            cont = (out.get("metadata") or {}).get("continue")
            if not cont:
                return items, list_rv
            params["continue"] = cont

    def delete_collection(self, kind: str, namespace: str,
                          label_selector: Dict[str, str]) -> int:
        params = {"labelSelector": wire.format_label_selector(label_selector)}
        out = self._call("DELETE", wire.ROUTES[kind].collection_path(namespace),
                         params=params)
        return len(out.get("items", []))

    # ------------------------------------------------------------ logs

    def pod_log(self, namespace: str, name: str,
                tail_lines: Optional[int] = None) -> str:
        """``GET .../pods/{name}/log`` (text/plain subresource) — the
        kubectl-logs flow. 404s map to NotFoundError like any GET."""
        params: Dict[str, str] = {}
        if tail_lines is not None:
            params["tailLines"] = str(tail_lines)
        path = wire.ROUTES["Pod"].object_path(namespace, name) + "/log"
        with self._open("GET", path, params=params) as resp:
            return resp.read().decode(errors="replace")

    # ------------------------------------------------------------ watch

    def watch(self, kind: str, namespace: Optional[str] = None,
              resource_version: Optional[int] = None) -> RestWatcher:
        return RestWatcher(self, kind, namespace, resource_version)

    # ------------------------------------------------------------ CRDs

    def create_crd(self, name: str, spec: Dict[str, Any]) -> None:
        self._call("POST", wire.CRD_ROUTE.collection_path(None),
                   body={"metadata": {"name": name}, "spec": spec})

    def get_crd(self, name: str) -> Dict[str, Any]:
        obj = self._call("GET", wire.CRD_ROUTE.object_path(None, name))
        conditions = (obj.get("status") or {}).get("conditions") or []
        established = any(
            c.get("type") == "Established" and c.get("status") == "True"
            for c in conditions
        )
        return {"name": name, "spec": obj.get("spec", {}),
                "established": established}


# ---------------------------------------------------------------- bootstrap

IN_CLUSTER_TOKEN = "/var/run/secrets/kubernetes.io/serviceaccount/token"
IN_CLUSTER_CA = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"


def in_cluster_config() -> Optional[RestCluster]:
    """Pod-environment bootstrap (reference InClusterConfig branch,
    ``k8sutil.go:45-65``): KUBERNETES_SERVICE_HOST/PORT + mounted
    serviceaccount token/CA. The token is a rotating
    :class:`FileTokenSource`, not a one-shot read — bound SA tokens
    expire (~1h) and kubelet refreshes the mounted file; a long-running
    operator must pick the refresh up (round 2 read it once and would
    have gone permanently 401)."""
    host = os.environ.get("KUBERNETES_SERVICE_HOST")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    if not host or not os.path.exists(IN_CLUSTER_TOKEN):
        return None
    ctx = ssl.create_default_context(
        cafile=IN_CLUSTER_CA if os.path.exists(IN_CLUSTER_CA) else None
    )
    return RestCluster(f"https://{host}:{port}",
                       token=FileTokenSource(IN_CLUSTER_TOKEN),
                       ssl_context=ctx)


def kubeconfig_config(path: str) -> RestCluster:
    """KUBECONFIG bootstrap: current-context server + user credentials
    (token or client cert/key), CA or insecure-skip-tls-verify.

    Credential hygiene (round-2 advisor finding): the CA loads from
    memory (``cadata``), and inline client cert/key material only ever
    touches disk as a 0600 tempfile that is unlinked before this
    function returns — nothing outlives the call, let alone the
    process."""
    import base64
    import tempfile

    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    ctx_name = cfg.get("current-context")
    contexts = {c["name"]: c["context"] for c in cfg.get("contexts", [])}
    if ctx_name not in contexts:
        raise errors.ApiError(f"kubeconfig {path}: no current-context")
    context = contexts[ctx_name]
    clusters = {c["name"]: c["cluster"] for c in cfg.get("clusters", [])}
    users = {u["name"]: u.get("user", {}) for u in cfg.get("users", [])}
    cluster = clusters[context["cluster"]]
    user = users.get(context.get("user", ""), {})

    server = cluster["server"]
    ssl_ctx: Optional[ssl.SSLContext] = None
    if server.startswith("https"):
        if cluster.get("insecure-skip-tls-verify"):
            ssl_ctx = ssl._create_unverified_context()  # user asked for it
        else:
            cadata = None
            if cluster.get("certificate-authority-data"):
                cadata = base64.b64decode(
                    cluster["certificate-authority-data"]).decode()
            ssl_ctx = ssl.create_default_context(
                cafile=cluster.get("certificate-authority"), cadata=cadata)
        certfile, keyfile = user.get("client-certificate"), user.get("client-key")
        tmp_paths: List[str] = []
        try:
            if not certfile and user.get("client-certificate-data"):
                for field, suffix in (("client-certificate-data", ".crt"),
                                      ("client-key-data", ".key")):
                    fd, tmp_path = tempfile.mkstemp(suffix=suffix)
                    tmp_paths.append(tmp_path)
                    os.fchmod(fd, 0o600)
                    with os.fdopen(fd, "wb") as tf:
                        tf.write(base64.b64decode(user[field]))
                    if suffix == ".crt":
                        certfile = tmp_path
                    else:
                        keyfile = tmp_path
            if certfile:
                ssl_ctx.load_cert_chain(certfile, keyfile)
        finally:
            for p in tmp_paths:
                try:
                    os.unlink(p)
                except OSError:
                    pass
    log.warning("kubeconfig bootstrap: operator will drive REAL cluster %s "
                "(context %s)", server, ctx_name)
    return RestCluster(server, token=user.get("token"), ssl_context=ssl_ctx)
