"""TensorBoard auxiliary replica set.

(The port's copy of ``k8s_tpu/trainer/tensorboard.py``.)

Analogue of reference ``pkg/trainer/tensorboard.go``: a 1-replica
Deployment + Service port 80→6006 (:19,40-112), command
``tensorboard --logdir <LogDir> --host 0.0.0.0`` on the job image
(:140-177), user Volumes/VolumeMounts/ServiceType passthrough
(tf_job.go:107-113), name ``"%.40s-tensorboard-<rid>"`` (:188-194).
"""

from __future__ import annotations

from typing import Optional

from k8s_tpu_torch.api import errors
from k8s_tpu_torch.api.client import KubeClient
from k8s_tpu_torch.api.objects import (
    Container,
    ContainerPort,
    Deployment,
    DeploymentSpec,
    ObjectMeta,
    PodSpec,
    PodTemplateSpec,
    Service,
    ServicePort,
    ServiceSpec,
)
from k8s_tpu_torch.trainer import labels as L
from k8s_tpu_torch.trainer.labels import KubernetesLabels

TB_PORT = 6006
TB_JOB_TYPE = "TENSORBOARD"


def init_tensorboard(client: KubeClient, job) -> Optional["TensorBoardReplicaSet"]:
    if job.job.spec.tensorboard is None:
        return None
    return TensorBoardReplicaSet(client, job)


class TensorBoardReplicaSet:
    def __init__(self, client: KubeClient, job):
        self.client = client
        self.job = job

    @property
    def namespace(self) -> str:
        return self.job.job.metadata.namespace

    @property
    def spec(self):
        return self.job.job.spec.tensorboard

    def name(self) -> str:
        base = self.job.job.metadata.name[:40]
        return f"{base}-tensorboard-{self.job.job.spec.runtime_id}"

    def labels(self) -> KubernetesLabels:
        return KubernetesLabels(
            {
                L.GROUP_LABEL: "",
                L.JOB_TYPE_LABEL: TB_JOB_TYPE,
                L.RUNTIME_ID_LABEL: self.job.job.spec.runtime_id,
                L.JOB_NAME_LABEL: self.job.job.metadata.name,
            }
        )

    def create(self) -> None:
        # informer-backed existence check: steady-state reconcile ticks
        # must not POST (the AlreadyExists round-trip is still O(1) per
        # tick, but with the cache it is zero)
        inf = getattr(self.client, "informer", None)
        if inf is not None and inf.synced and \
                inf.get("Deployment", self.namespace, self.name()) is not None and \
                inf.get("Service", self.namespace, self.name()) is not None:
            return
        owner = [self.job.job.as_owner()]
        container = Container(
            name="tensorboard",
            image=self.job.job.spec.image,
            command=[
                "tensorboard",
                "--logdir",
                self.spec.log_dir,
                "--host",
                "0.0.0.0",
            ],
            ports=[ContainerPort(container_port=TB_PORT, name="tb-port")],
            volume_mounts=[m.deepcopy() for m in self.spec.volume_mounts],
        )
        dep = Deployment(
            metadata=ObjectMeta(
                name=self.name(),
                namespace=self.namespace,
                labels=dict(self.labels()),
                owner_references=owner,
            ),
            spec=DeploymentSpec(
                replicas=1,
                selector={"matchLabels": dict(self.labels())},
                template=PodTemplateSpec(
                    metadata=ObjectMeta(labels=dict(self.labels())),
                    spec=PodSpec(
                        containers=[container],
                        volumes=[v.deepcopy() for v in self.spec.volumes],
                        restart_policy="Always",
                    ),
                ),
            ),
        )
        svc = Service(
            metadata=ObjectMeta(
                name=self.name(),
                namespace=self.namespace,
                labels=dict(self.labels()),
                owner_references=owner,
            ),
            spec=ServiceSpec(
                selector=dict(self.labels()),
                ports=[ServicePort(name="tb-port", port=80, target_port=TB_PORT)],
                type=self.spec.service_type,
            ),
        )
        for create in (lambda: self.client.deployments.create(dep), lambda: self.client.services.create(svc)):
            try:
                create()
            except errors.AlreadyExistsError:
                pass

    def delete(self) -> None:
        for f in (
            lambda: self.client.deployments.delete(self.namespace, self.name()),
            lambda: self.client.services.delete(self.namespace, self.name()),
        ):
            try:
                f()
            except errors.NotFoundError:
                pass
