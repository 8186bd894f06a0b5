"""TpuJob CRD client.

(The port's copy of ``k8s_tpu/api/crd_client.py``.)

Analogue of reference ``pkg/util/k8sutil/tf_job_client.go``: the
``TfJobClient`` interface {Get, Create, Delete, List, Update, Watch}
(:31-49) against ``/apis/tensorflow.org/v1alpha1``. The reference's
Watch is a raw HTTP GET workaround (:82-86); ours is a first-class
watch stream from the cluster store.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from k8s_tpu_torch.api.cluster import Watcher
from k8s_tpu_torch.spec import CRD_KIND, CRD_GROUP, CRD_VERSION, TpuJob, crd_name


class TpuJobClient:
    """CRUD + watch for TpuJob custom resources. ``cluster`` is any
    backend with the InMemoryCluster method surface (in-memory, or
    a REST backend (ROADMAP A12.2) against a real
    apiserver — the reference's raw-REST client analogue)."""

    def __init__(self, cluster):
        self._cluster = cluster

    def create_crd_definition(self) -> None:
        self._cluster.create_crd(
            crd_name(),
            {
                "group": CRD_GROUP,
                "version": CRD_VERSION,
                "scope": "Namespaced",
                "names": {"kind": CRD_KIND, "plural": "tpujobs"},
            },
        )

    def crd_established(self) -> bool:
        from k8s_tpu_torch.api import errors

        try:
            return bool(self._cluster.get_crd(crd_name()).get("established"))
        except errors.NotFoundError:
            return False

    def create(self, job: TpuJob) -> TpuJob:
        return TpuJob.from_dict(self._cluster.create(CRD_KIND, job.to_dict()))

    def get(self, namespace: str, name: str) -> TpuJob:
        return TpuJob.from_dict(self._cluster.get(CRD_KIND, namespace, name))

    def update(self, job: TpuJob) -> TpuJob:
        return TpuJob.from_dict(self._cluster.update(CRD_KIND, job.to_dict()))

    def delete(self, namespace: str, name: str) -> None:
        self._cluster.delete(CRD_KIND, namespace, name)

    def list(self, namespace: Optional[str] = None) -> List[TpuJob]:
        return [TpuJob.from_dict(d) for d in self._cluster.list(CRD_KIND, namespace)]

    def watch(
        self, namespace: Optional[str] = None, resource_version: Optional[int] = None
    ) -> Watcher:
        return self._cluster.watch(CRD_KIND, namespace, resource_version)
