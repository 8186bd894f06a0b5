"""Typed client facade over a cluster backend.

(The port's copy of ``k8s_tpu/api/client.py``.)

Analogue of the client-go surface the reference trainer uses
(CoreV1 Services/Pods/ConfigMaps, BatchV1 Jobs, ExtensionsV1beta1
Deployments — ``pkg/trainer/replicas.go``, ``tensorboard.go``) plus
``GetClusterConfig`` bootstrap (``pkg/util/k8sutil/k8sutil.go:45-65``).

Two backends: :class:`k8s_tpu_torch.api.cluster.InMemoryCluster` (tests +
single-host local mode) and — when the ``kubernetes`` package is
importable in a real deployment — a thin adapter with the same method
set. The control plane only ever sees this interface.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Type, TypeVar

from k8s_tpu_torch.api import errors
from k8s_tpu_torch.api.cluster import InMemoryCluster, Watcher
from k8s_tpu_torch.api.objects import (
    ConfigMap,
    Deployment,
    Event,
    Job,
    K8sObject,
    Pod,
    Service,
)

T = TypeVar("T", bound=K8sObject)


class _TypedResource:
    """CRUD for one kind, converting between dataclasses and the dict
    store. ``cluster`` is any backend with the InMemoryCluster method
    surface (in-memory or a REST backend (ROADMAP A12.2))."""

    def __init__(self, cluster, kind: str, cls: Type[T]):
        self._cluster = cluster
        self.kind = kind
        self.cls = cls

    def create(self, obj: T) -> T:
        return self.cls.from_dict(self._cluster.create(self.kind, obj.to_dict()))

    def get(self, namespace: str, name: str) -> T:
        return self.cls.from_dict(self._cluster.get(self.kind, namespace, name))

    def update(self, obj: T) -> T:
        return self.cls.from_dict(self._cluster.update(self.kind, obj.to_dict()))

    def delete(self, namespace: str, name: str) -> None:
        self._cluster.delete(self.kind, namespace, name)

    def list(
        self,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[T]:
        return [
            self.cls.from_dict(d)
            for d in self._cluster.list(self.kind, namespace, label_selector)
        ]

    def delete_collection(self, namespace: str, label_selector: Dict[str, str]) -> int:
        return self._cluster.delete_collection(self.kind, namespace, label_selector)

    def watch(
        self, namespace: Optional[str] = None, resource_version: Optional[int] = None
    ) -> Watcher:
        return self._cluster.watch(self.kind, namespace, resource_version)


class KubeClient:
    """The one client object threaded through controller/trainer."""

    def __init__(self, cluster=None):
        # in-memory by default; any backend with the same method surface
        # (RestCluster against a real apiserver) drops in unchanged
        self.cluster = cluster if cluster is not None else InMemoryCluster()
        # a watch-fed object cache (k8s_tpu_torch.api.informer.Informer) the
        # operator attaches via start_informer(); when present and
        # synced, trainer reads go through it instead of the apiserver
        self.informer = None
        self.pods = _TypedResource(self.cluster, "Pod", Pod)
        self.services = _TypedResource(self.cluster, "Service", Service)
        self.jobs = _TypedResource(self.cluster, "Job", Job)
        self.config_maps = _TypedResource(self.cluster, "ConfigMap", ConfigMap)
        self.deployments = _TypedResource(self.cluster, "Deployment", Deployment)
        self.events = _TypedResource(self.cluster, "Event", Event)

    def start_informer(self, namespace=None, wait: bool = True):
        """Attach and start a watch-fed cache (idempotent). The operator
        calls this once at startup; local tools that do one-shot CRUD
        never need it."""
        if self.informer is None:
            from k8s_tpu_torch.api.informer import Informer

            self.informer = Informer(self.cluster, namespace=namespace).start()
            if wait:
                self.informer.wait_for_sync()
        return self.informer

    def stop_informer(self) -> None:
        if self.informer is not None:
            self.informer.stop()
            self.informer = None

    # -- events (the reference used a FakeRecorder, main.go:133 — a gap
    # SURVEY §5 says to close with real K8s Events) ----------------------

    def record_event(
        self,
        namespace: str,
        involved: Dict[str, str],
        reason: str,
        message: str,
        etype: str = "Normal",
    ) -> None:
        ev = Event(reason=reason, message=message, type=etype, involved_object=involved)
        ev.metadata.namespace = namespace
        ev.metadata.name = f"{involved.get('name','obj')}.{self.cluster.resource_version}"
        try:
            self.events.create(ev)
        except errors.AlreadyExistsError:
            pass


REST_BACKEND_ITEM = "A12.2 (the REST backend and leader election)"


def get_cluster_client(kubeconfig: Optional[str] = None) -> KubeClient:
    """Bootstrap helper (reference GetClusterConfig, k8sutil.go:45-65).
    The port runs the operator on the in-memory cluster only: an
    apiserver named by ``KTPU_APISERVER_URL``, ``kubeconfig`` or
    ``KUBECONFIG`` raises, since the REST backend is not ported yet."""
    import os

    if (os.environ.get("KTPU_APISERVER_URL") or kubeconfig
            or os.environ.get("KUBECONFIG")):
        raise NotImplementedError(
            "a remote apiserver is not ported to k8s_tpu_torch yet "
            f"(ROADMAP {REST_BACKEND_ITEM}); run the operator with --local")
    return KubeClient()
