"""In-memory Kubernetes-like API server.

(The port's copy of ``k8s_tpu/api/cluster.py``.)

The reference draws its test boundary at the K8s API and uses
client-go's ``fake.NewSimpleClientset`` (SURVEY §4); its fakes can't
simulate watches or DeleteCollection, so delete paths were only covered
by cloud e2e (``replicas_test.go:174-181``). This store is a superset:

- optimistic concurrency via monotonic ``resourceVersion``
- streaming watches with bounded history and 410-Gone semantics
  (so the controller's relist/recovery path is exercisable in-process)
- label-selector list/delete-collection
- cascading owner-reference GC (the reference delegates this to the
  real cluster's GC — ``tf_job.go:40-52`` + README:36-39)

It backs both unit tests and the single-host "local mode" runtime where
the operator + kubelet simulator run in one process
(:mod:`k8s_tpu_torch.runtime.kubelet`).
"""

from __future__ import annotations

import queue
import threading
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from k8s_tpu_torch.api import errors


@dataclass
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED | ERROR
    kind: str
    object: Dict[str, Any]

    @property
    def name(self) -> str:
        return self.object.get("metadata", {}).get("name", "")

    @property
    def namespace(self) -> str:
        return self.object.get("metadata", {}).get("namespace", "")


Key = Tuple[str, str, str]  # (kind, namespace, name)

_WATCH_HISTORY = 1024


def _meta(obj: Dict[str, Any]) -> Dict[str, Any]:
    return obj.setdefault("metadata", {})


def _matches(labels: Dict[str, str], selector: Dict[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())


class Watcher:
    """One watch subscription: an iterator over WatchEvents."""

    def __init__(self, cluster: "InMemoryCluster", kind: str, namespace: Optional[str]):
        self.q: "queue.Queue[Optional[WatchEvent]]" = queue.Queue()
        self._cluster = cluster
        self.kind = kind
        self.namespace = namespace
        self.closed = False

    def stop(self) -> None:
        self.closed = True
        self.q.put(None)

    def __iter__(self) -> Iterator[WatchEvent]:
        while True:
            ev = self.q.get()
            if ev is None:
                return
            yield ev

    def next(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        try:
            return self.q.get(timeout=timeout)
        except queue.Empty:
            return None


class InMemoryCluster:
    """Thread-safe in-memory object store with K8s API semantics."""

    def __init__(self):
        self._lock = threading.RLock()
        self._objects: Dict[Key, Dict[str, Any]] = {}
        self._rv = 0
        self._history: List[Tuple[int, WatchEvent]] = []
        self._watchers: List[Watcher] = []
        self._crds: Dict[str, Dict[str, Any]] = {}
        # hooks fired synchronously after commit (used by kubelet sim)
        self.hooks: List[Callable[[WatchEvent], None]] = []

    # ------------------------------------------------------------------ core

    def _next_rv(self) -> int:
        self._rv += 1
        return self._rv

    def _emit(self, ev_type: str, kind: str, obj: Dict[str, Any]) -> None:
        ev = WatchEvent(ev_type, kind, obj)
        self._history.append((self._rv, ev))
        if len(self._history) > _WATCH_HISTORY:
            self._history = self._history[-_WATCH_HISTORY:]
        for w in list(self._watchers):
            if w.closed:
                self._watchers.remove(w)
                continue
            if w.kind == kind and (w.namespace is None or w.namespace == ev.namespace):
                w.q.put(ev)
        for h in list(self.hooks):
            h(ev)

    @property
    def resource_version(self) -> int:
        with self._lock:
            return self._rv

    # ------------------------------------------------------------------ CRUD

    def create(self, kind: str, obj: Dict[str, Any]) -> Dict[str, Any]:
        import copy

        obj = copy.deepcopy(obj)
        with self._lock:
            m = _meta(obj)
            ns, name = m.get("namespace", "default"), m.get("name")
            if not name:
                raise errors.ApiError("object has no metadata.name")
            m.setdefault("namespace", ns)
            key = (kind, ns, name)
            if key in self._objects:
                raise errors.AlreadyExistsError(f"{kind} {ns}/{name} already exists")
            if not m.get("uid"):
                m["uid"] = str(uuid.uuid4())
            m["resourceVersion"] = str(self._next_rv())
            self._objects[key] = obj
            self._emit("ADDED", kind, copy.deepcopy(obj))
            return copy.deepcopy(obj)

    def get(self, kind: str, namespace: str, name: str) -> Dict[str, Any]:
        import copy

        with self._lock:
            key = (kind, namespace, name)
            if key not in self._objects:
                raise errors.NotFoundError(f"{kind} {namespace}/{name} not found")
            return copy.deepcopy(self._objects[key])

    def update(self, kind: str, obj: Dict[str, Any], check_version: bool = False) -> Dict[str, Any]:
        import copy

        obj = copy.deepcopy(obj)
        with self._lock:
            m = _meta(obj)
            ns, name = m.get("namespace", "default"), m.get("name")
            key = (kind, ns, name)
            if key not in self._objects:
                raise errors.NotFoundError(f"{kind} {ns}/{name} not found")
            current = self._objects[key]
            if check_version and m.get("resourceVersion") != current["metadata"]["resourceVersion"]:
                raise errors.ConflictError(
                    f"{kind} {ns}/{name}: resourceVersion conflict "
                    f"({m.get('resourceVersion')} != {current['metadata']['resourceVersion']})"
                )
            m["uid"] = current["metadata"].get("uid", m.get("uid"))
            m["resourceVersion"] = str(self._next_rv())
            self._objects[key] = obj
            self._emit("MODIFIED", kind, copy.deepcopy(obj))
            return copy.deepcopy(obj)

    def delete(self, kind: str, namespace: str, name: str, cascade: bool = True) -> None:
        with self._lock:
            import copy

            key = (kind, namespace, name)
            if key not in self._objects:
                raise errors.NotFoundError(f"{kind} {namespace}/{name} not found")
            obj = self._objects.pop(key)
            self._next_rv()
            self._emit("DELETED", kind, copy.deepcopy(obj))
            if cascade:
                self._gc_orphans(obj["metadata"].get("uid"))

    def _gc_orphans(self, owner_uid: Optional[str]) -> None:
        """Cascading owner-ref GC (what a real cluster's GC controller
        does with the owner refs from ``TpuJob.as_owner``)."""
        if not owner_uid:
            return
        doomed = []
        for key, obj in self._objects.items():
            for ref in obj["metadata"].get("ownerReferences", []) or []:
                if ref.get("uid") == owner_uid:
                    doomed.append(key)
                    break
        for kind, ns, name in doomed:
            try:
                self.delete(kind, ns, name, cascade=True)
            except errors.NotFoundError:
                pass

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[Dict[str, Any]]:
        import copy

        with self._lock:
            out = []
            for (k, ns, _), obj in sorted(self._objects.items()):
                if k != kind:
                    continue
                if namespace is not None and ns != namespace:
                    continue
                if label_selector and not _matches(
                    obj["metadata"].get("labels", {}) or {}, label_selector
                ):
                    continue
                out.append(copy.deepcopy(obj))
            return out

    def delete_collection(
        self, kind: str, namespace: str, label_selector: Dict[str, str]
    ) -> int:
        """Label-selector bulk delete — the API the reference uses for
        Jobs+Pods teardown (``replicas.go:299-356``) and whose fake
        couldn't simulate it."""
        with self._lock:
            victims = self.list(kind, namespace, label_selector)
            for obj in victims:
                try:
                    self.delete(kind, namespace, obj["metadata"]["name"])
                except errors.NotFoundError:
                    pass
            return len(victims)

    # ------------------------------------------------------------------ watch

    def watch(
        self,
        kind: str,
        namespace: Optional[str] = None,
        resource_version: Optional[int] = None,
    ) -> Watcher:
        """Streaming watch. ``resource_version=None`` → from now.
        An RV older than the history window raises OutdatedVersionError
        (410 Gone) so callers must relist — same contract the reference
        handles at ``controller.go:331-344``."""
        with self._lock:
            w = Watcher(self, kind, namespace)
            if resource_version is not None:
                # every rv increment has exactly one history entry, so a
                # trimmed history window means events in
                # (resource_version, oldest) are unrecoverable → 410.
                oldest = self._history[0][0] if self._history else self._rv + 1
                if resource_version + 1 < oldest and resource_version < self._rv:
                    raise errors.OutdatedVersionError(str(resource_version))
                for rv, ev in self._history:
                    if rv > resource_version and ev.kind == kind and (
                        namespace is None or ev.namespace == namespace
                    ):
                        w.q.put(ev)
            self._watchers.append(w)
            return w

    # ------------------------------------------------------------------ CRDs

    def create_crd(self, name: str, spec: Dict[str, Any]) -> None:
        """Register a CRD; immediately Established (the reference polls
        500ms/60s for the Established condition, ``controller.go:234-286``)."""
        with self._lock:
            if name in self._crds:
                raise errors.AlreadyExistsError(name)
            self._crds[name] = {"name": name, "spec": spec, "established": True}

    def get_crd(self, name: str) -> Dict[str, Any]:
        with self._lock:
            if name not in self._crds:
                raise errors.NotFoundError(name)
            return dict(self._crds[name])
