"""Kubernetes wire-format vocabulary shared by the REST client backend
(:mod:`k8s_tpu_torch.api.restcluster`) and the local apiserver
(:mod:`k8s_tpu_torch.api.apiserver`).
(The port's copy of ``k8s_tpu/api/wire.py``.)

Covers exactly the API surface the control plane uses — the same set the
reference drives through client-go (``pkg/trainer/replicas.go``,
``tensorboard.go``) plus its raw-REST CRD client
(``pkg/util/k8sutil/tf_job_client.go:56-86``):

- core/v1 Pods, Services, ConfigMaps, Events, Endpoints (election lock)
- batch/v1 Jobs
- apps/v1 Deployments
- apiextensions.k8s.io/v1 CustomResourceDefinitions
- the TpuJob custom resource under ``/apis/tpu.k8s.io/v1alpha1``
"""

from __future__ import annotations

import urllib.parse
from typing import Any, Dict, Optional, Tuple

from k8s_tpu_torch.spec import CRD_GROUP, CRD_KIND, CRD_KIND_PLURAL, CRD_VERSION


class Route:
    """One kind's REST coordinates."""

    def __init__(self, kind: str, api_version: str, plural: str, namespaced: bool = True):
        self.kind = kind
        self.api_version = api_version  # "v1" or "group/version"
        self.plural = plural
        self.namespaced = namespaced

    @property
    def prefix(self) -> str:
        # core group lives under /api/v1, everything else under /apis/g/v
        return f"/api/{self.api_version}" if "/" not in self.api_version else f"/apis/{self.api_version}"

    def collection_path(self, namespace: Optional[str]) -> str:
        if self.namespaced and namespace is not None:
            return f"{self.prefix}/namespaces/{namespace}/{self.plural}"
        return f"{self.prefix}/{self.plural}"

    def object_path(self, namespace: Optional[str], name: str) -> str:
        return f"{self.collection_path(namespace)}/{name}"


ROUTES: Dict[str, Route] = {
    "Pod": Route("Pod", "v1", "pods"),
    "Service": Route("Service", "v1", "services"),
    "ConfigMap": Route("ConfigMap", "v1", "configmaps"),
    "Event": Route("Event", "v1", "events"),
    "Endpoints": Route("Endpoints", "v1", "endpoints"),
    "Job": Route("Job", "batch/v1", "jobs"),
    "Deployment": Route("Deployment", "apps/v1", "deployments"),
    CRD_KIND: Route(CRD_KIND, f"{CRD_GROUP}/{CRD_VERSION}", CRD_KIND_PLURAL),
}

CRD_ROUTE = Route(
    "CustomResourceDefinition",
    "apiextensions.k8s.io/v1",
    "customresourcedefinitions",
    namespaced=False,
)

# plural (within its prefix) -> kind, for server-side path dispatch
PLURALS: Dict[Tuple[str, str], str] = {
    (r.prefix, r.plural): k for k, r in ROUTES.items()
}


def status_body(code: int, reason: str, message: str) -> Dict[str, Any]:
    """A ``metav1.Status`` failure body."""
    return {
        "kind": "Status",
        "apiVersion": "v1",
        "status": "Failure",
        "message": message,
        "reason": reason,
        "code": code,
    }


def format_label_selector(selector: Dict[str, str]) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(selector.items()))


def parse_label_selector(raw: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"unsupported label selector term {part!r}")
        k, _, v = part.partition("=")
        out[k.strip()] = v.strip().strip('"')
    return out


def encode_query(params: Dict[str, str]) -> str:
    return urllib.parse.urlencode(params) if params else ""


def stamp_type_meta(kind: str, obj: Dict[str, Any]) -> Dict[str, Any]:
    """Fill apiVersion/kind on the way out, the way a real apiserver does."""
    r = ROUTES.get(kind)
    if r is not None:
        obj.setdefault("apiVersion", r.api_version)
        obj.setdefault("kind", kind)
    return obj
