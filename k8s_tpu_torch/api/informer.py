"""Watch-fed shared object cache — the informer the reference never had.

(The port's copy of ``k8s_tpu/api/informer.py``.)

The reference's hot loop polled the apiserver every 8s with
O(replicas) round-trips per job (``pkg/trainer/replicas.go:432-467``:
a batch-Job GET plus a Pod LIST per replica index), which SURVEY §7.2
hard part #4 flags as the design that "won't scale to 128-host
slices; use informers + pod-condition aggregation". This module is
that informer: the operator opens ONE watch stream per kind, keeps a
local cache of every object it manages, and the reconcilers read the
cache — steady-state reconcile makes **zero** apiserver calls.

Two feed mechanisms, chosen per backend:

- :class:`k8s_tpu_torch.api.cluster.InMemoryCluster` fires its ``hooks``
  synchronously inside the commit, so the cache is updated *before*
  the mutating call returns — a perfectly fresh cache for tests and
  single-host local mode.
- Any other backend (:class:`k8s_tpu_torch.api.restcluster.RestCluster`
  against a real apiserver or the local wire-format one) gets a
  watch thread per kind: LIST to prime the cache, stream from the
  list's resourceVersion, relist on 410 Gone — client-go reflector
  semantics (the reference got these for free from client-go; we own
  them).

Cache readers must tolerate eventual consistency on the REST path:
an object the reconciler just deleted may still be cached for a few
milliseconds. The trainer handles that with delete tombstones
(``trainer/replicas.py``) — the informer itself stays a dumb mirror.
"""

from __future__ import annotations

import copy
import logging
import threading
from typing import Any, Dict, List, Optional, Tuple

from k8s_tpu_torch.api import errors
from k8s_tpu_torch.api.cluster import InMemoryCluster, WatchEvent, _matches
from k8s_tpu_torch.robustness.backoff import Backoff, BackoffPolicy

log = logging.getLogger(__name__)

DEFAULT_KINDS = ("Job", "Pod", "Service", "ConfigMap", "Deployment")

# Reflector resync schedule: list/watch failures and 410 relists space
# out 0.5s → 15s (jittered) instead of hammering a browned-out apiserver.
RESYNC_POLICY = BackoffPolicy(
    base=0.5, factor=2.0, cap=15.0, jitter=0.5, reset_after=60.0
)


class _KindCache:
    """Mirror of one kind: ``(namespace, name) -> object dict``."""

    def __init__(self, kind: str):
        self.kind = kind
        self.lock = threading.RLock()
        self.objects: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self.synced = threading.Event()

    @staticmethod
    def _rv(obj: Dict[str, Any]) -> int:
        try:
            return int((obj.get("metadata") or {}).get("resourceVersion", 0))
        except (TypeError, ValueError):
            return 0

    @staticmethod
    def _materially_equal(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
        """Equal modulo resourceVersion — a write that only bumped the
        rv carries no information a reconciler could act on, and event
        listeners must not be kicked for it."""
        am = dict(a.get("metadata") or {})
        bm = dict(b.get("metadata") or {})
        am.pop("resourceVersion", None)
        bm.pop("resourceVersion", None)
        return am == bm and {k: v for k, v in a.items()
                             if k != "metadata"} == \
            {k: v for k, v in b.items() if k != "metadata"}

    def apply(self, ev: WatchEvent) -> bool:
        """Apply one event; True iff the cache *materially* changed
        (the listener-notification gate)."""
        key = (ev.namespace or "default", ev.name)
        with self.lock:
            if ev.type == "DELETED":
                return self.objects.pop(key, None) is not None
            if ev.type in ("ADDED", "MODIFIED"):
                cur = self.objects.get(key)
                # never regress to an older copy (initial-list overlap)
                if cur is None or self._rv(ev.object) >= self._rv(cur):
                    changed = (cur is None
                               or not self._materially_equal(
                                   cur, ev.object))
                    self.objects[key] = copy.deepcopy(ev.object)
                    return changed
        return False

    def replace(self, items: List[Dict[str, Any]]) -> None:
        """Relist: the list snapshot becomes the whole cache (objects
        deleted while the watch was down must vanish)."""
        fresh = {
            ((o.get("metadata") or {}).get("namespace", "default"),
             (o.get("metadata") or {}).get("name", "")): copy.deepcopy(o)
            for o in items
        }
        with self.lock:
            self.objects = fresh

    def get(self, namespace: str, name: str) -> Optional[Dict[str, Any]]:
        with self.lock:
            obj = self.objects.get((namespace, name))
            return copy.deepcopy(obj) if obj is not None else None

    def list(self, namespace: Optional[str],
             selector: Optional[Dict[str, str]]) -> List[Dict[str, Any]]:
        with self.lock:
            out = []
            for (ns, _), obj in sorted(self.objects.items()):
                if namespace is not None and ns != namespace:
                    continue
                if selector and not _matches(
                    (obj.get("metadata") or {}).get("labels", {}) or {}, selector
                ):
                    continue
                out.append(copy.deepcopy(obj))
            return out


class Informer:
    """Shared watch-fed cache over the kinds the trainer manages."""

    def __init__(self, cluster, kinds=DEFAULT_KINDS, namespace: Optional[str] = None):
        self.cluster = cluster
        self.namespace = namespace
        self.caches: Dict[str, _KindCache] = {k: _KindCache(k) for k in kinds}
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._hook = None
        self._started = False
        # event listeners (the event-driven control plane's feed,
        # docs/SCHEDULER.md "Event-driven core"): called with each
        # WatchEvent that MATERIALLY changed the cache, plus a
        # synthetic type="RESYNC" event after every reflector relist
        # (anything could have changed while the watch was down).
        # Listeners must be cheap and never raise.
        self._listeners: List = []

    def add_listener(self, fn) -> None:
        self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        if fn in self._listeners:
            self._listeners.remove(fn)

    def _notify(self, ev: WatchEvent) -> None:
        for fn in list(self._listeners):
            try:
                fn(ev)
            except Exception as e:  # a listener bug must not stall the feed
                log.error("informer listener failed on %s %s/%s: %s",
                          ev.type, ev.kind, ev.name, e)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "Informer":
        if self._started:
            return self
        self._started = True
        if isinstance(self.cluster, InMemoryCluster):
            # synchronous feed: the cache commits inside the cluster's
            # own commit, so readers never observe staleness. Events
            # fired while we prime from list() are BUFFERED and
            # replayed after: applying them live could interleave a
            # DELETED before its object's stale listed copy, leaving a
            # phantom entry with no further event to evict it.
            state = {"priming": True, "buffer": []}

            def hook(ev: WatchEvent) -> None:
                if ev.kind not in self.caches or (
                    self.namespace is not None and ev.namespace != self.namespace
                ):
                    return
                if state["priming"]:
                    state["buffer"].append(ev)
                    return
                if self.caches[ev.kind].apply(ev):
                    self._notify(ev)

            self._hook = hook
            self.cluster.hooks.append(hook)
            for kind, cache in self.caches.items():
                for obj in self.cluster.list(kind, self.namespace):
                    cache.apply(WatchEvent("ADDED", kind, obj))
            # drain + flip under the cluster's commit lock (hooks fire
            # while it is held, so no event can race the flip)
            with self.cluster._lock:
                for ev in state["buffer"]:
                    self.caches[ev.kind].apply(ev)
                state["priming"] = False
            for cache in self.caches.values():
                cache.synced.set()
            return self
        for kind in self.caches:
            t = threading.Thread(
                target=self._reflect, args=(kind,), daemon=True,
                name=f"informer-{kind.lower()}",
            )
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._hook is not None and self._hook in getattr(self.cluster, "hooks", []):
            self.cluster.hooks.remove(self._hook)
        for t in self._threads:
            t.join(timeout=5)

    def wait_for_sync(self, timeout: float = 30.0) -> bool:
        import time

        end = time.monotonic() + timeout
        for cache in self.caches.values():
            remaining = end - time.monotonic()
            if remaining <= 0 or not cache.synced.wait(remaining):
                return False
        return True

    @property
    def synced(self) -> bool:
        return all(c.synced.is_set() for c in self.caches.values())

    # ------------------------------------------------------------ reflector

    def _reflect(self, kind: str) -> None:
        """client-go reflector loop: list → watch(rv) → apply; relist on
        410; re-dial on stream errors (the RestWatcher already re-dials
        EOFs internally — only staleness surfaces here)."""
        cache = self.caches[kind]
        bo = Backoff(RESYNC_POLICY)  # unified resync/relist schedule
        while not self._stop.is_set():
            if bo.wait(self._stop):
                return
            try:
                lister = getattr(self.cluster, "list_with_rv", None)
                if lister is not None:
                    # the LIST's own resourceVersion is the watch
                    # anchor; the client-wide high-water mark can be
                    # AHEAD of this snapshot (other threads share the
                    # client) and would skip events committed between
                    items, rv = lister(kind, self.namespace)
                else:
                    items = self.cluster.list(kind, self.namespace)
                    rv = self.cluster.resource_version
                cache.replace(items)
                cache.synced.set()
                # anything may have changed while the watch was down —
                # one synthetic event lets listeners resync themselves
                # (the controller re-kicks every job key on it)
                self._notify(WatchEvent("RESYNC", kind, {
                    "metadata": {"name": "", "namespace": ""}}))
                watcher = self.cluster.watch(kind, self.namespace, rv)
            except Exception as e:
                delay = bo.note_failure()
                log.warning("informer %s: list/watch failed (%s); retry in %.1fs",
                            kind, e, delay)
                continue
            bo.note_success()
            try:
                while not self._stop.is_set():
                    ev = watcher.next(timeout=0.2)
                    if ev is None:
                        continue
                    if cache.apply(ev):
                        self._notify(ev)
            except errors.OutdatedVersionError:
                # a 410 storm (chaos watch-drop, compacted history)
                # relists through the same backoff as any other failure
                delay = bo.note_failure()
                log.info("informer %s: watch outdated; relisting in %.1fs",
                         kind, delay)
            except Exception as e:
                delay = bo.note_failure()
                log.warning("informer %s: watch error (%s); relisting in %.1fs",
                            kind, e, delay)
            finally:
                try:
                    watcher.stop()
                except Exception:
                    pass

    # ------------------------------------------------------------ readers

    def get(self, kind: str, namespace: str, name: str) -> Optional[Dict[str, Any]]:
        return self.caches[kind].get(namespace, name)

    def list(self, kind: str, namespace: Optional[str] = None,
             label_selector: Optional[Dict[str, str]] = None) -> List[Dict[str, Any]]:
        return self.caches[kind].list(namespace, label_selector)
