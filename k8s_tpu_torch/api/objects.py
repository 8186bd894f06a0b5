"""Typed, lightweight Kubernetes object model.

(The port's copy of ``k8s_tpu/api/objects.py``.)

The reference operator uses k8s.io/client-go structs (Pod, Service,
batch/v1 Job, ConfigMap, Deployment) throughout ``pkg/trainer``. This
module provides the same vocabulary as Python dataclasses with
camelCase JSON round-tripping, so the control plane can run against
either a real apiserver (via the ``kubernetes`` client, when present)
or the in-memory cluster used for tests and local single-host mode
(see :mod:`k8s_tpu_torch.api.cluster`).

Only the fields the framework actually reads/writes are modeled; any
unknown fields survive round-trips via ``extra``.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


def _camel(name: str) -> str:
    parts = name.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


class K8sObject:
    """Base: camelCase dict serde + deep copy for dataclass trees."""

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for f in dataclasses.fields(self):  # type: ignore[arg-type]
            if f.name == "extra":
                continue
            v = getattr(self, f.name)
            if v is None or v == [] or v == {} or v == "":
                continue
            key = f.metadata.get("json", _camel(f.name))
            out[key] = _ser(v)
        extra = getattr(self, "extra", None)
        if extra:
            for k, v in extra.items():
                out.setdefault(k, v)
        return out

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]):
        if d is None:
            return None
        kwargs: Dict[str, Any] = {}
        consumed = set()
        for f in dataclasses.fields(cls):  # type: ignore[arg-type]
            if f.name == "extra":
                continue
            key = f.metadata.get("json", _camel(f.name))
            if key not in d:
                continue
            consumed.add(key)
            kwargs[f.name] = _de(f.type, d[key])
        obj = cls(**kwargs)  # type: ignore[call-arg]
        if hasattr(obj, "extra"):
            obj.extra = {k: copy.deepcopy(v) for k, v in d.items() if k not in consumed}
        return obj

    def deepcopy(self):
        """JSON-free deep copy (cf. reference ``tf_job.go:387-398`` which
        round-trips through JSON to deep-copy)."""
        return copy.deepcopy(self)


def _ser(v: Any) -> Any:
    if isinstance(v, K8sObject):
        return v.to_dict()
    if isinstance(v, list):
        return [_ser(x) for x in v]
    if isinstance(v, dict):
        return {k: _ser(x) for k, x in v.items()}
    return v


_TYPE_REGISTRY: Dict[str, type] = {}


def register_type(cls):
    """Register a K8sObject subclass for typed deserialization (used by
    the spec layer's CRD classes as well as the builtins below)."""
    _TYPE_REGISTRY[cls.__name__] = cls
    return cls


_register = register_type


def _de(tp: Any, v: Any) -> Any:
    """Best-effort typed deserialization driven by the annotation string."""
    if v is None:
        return None
    t = tp if isinstance(tp, str) else getattr(tp, "__name__", str(tp))
    while t.startswith("Optional[") and t.endswith("]"):
        t = t[len("Optional[") : -1]
    if t.startswith("List[") and t.endswith("]"):
        inner = t[5:-1]
        return [_de(inner, x) for x in v] if isinstance(v, list) else v
    if t.startswith("Dict["):
        return dict(v) if isinstance(v, dict) else v
    cls = _TYPE_REGISTRY.get(t)
    if cls is not None and isinstance(v, dict):
        return cls.from_dict(v)
    return v


# ---------------------------------------------------------------------------
# Meta
# ---------------------------------------------------------------------------


@_register
@dataclass
class OwnerReference(K8sObject):
    api_version: str = ""
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: bool = True
    block_owner_deletion: bool = True
    extra: Dict[str, Any] = field(default_factory=dict)


@_register
@dataclass
class ObjectMeta(K8sObject):
    name: str = ""
    namespace: str = ""
    uid: str = ""
    resource_version: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    owner_references: List[OwnerReference] = field(default_factory=list)
    creation_timestamp: Optional[float] = None
    deletion_timestamp: Optional[float] = None
    extra: Dict[str, Any] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Pod building blocks
# ---------------------------------------------------------------------------


@_register
@dataclass
class EnvVar(K8sObject):
    name: str = ""
    value: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)


@_register
@dataclass
class VolumeMount(K8sObject):
    name: str = ""
    mount_path: str = ""
    read_only: bool = False
    extra: Dict[str, Any] = field(default_factory=dict)


@_register
@dataclass
class HostPathVolumeSource(K8sObject):
    path: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)


@_register
@dataclass
class ConfigMapVolumeSource(K8sObject):
    name: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)


@_register
@dataclass
class Volume(K8sObject):
    name: str = ""
    host_path: Optional[HostPathVolumeSource] = None
    config_map: Optional[ConfigMapVolumeSource] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@_register
@dataclass
class ResourceRequirements(K8sObject):
    limits: Dict[str, Any] = field(default_factory=dict)
    requests: Dict[str, Any] = field(default_factory=dict)
    extra: Dict[str, Any] = field(default_factory=dict)


@_register
@dataclass
class ContainerPort(K8sObject):
    container_port: int = 0
    name: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)


@_register
@dataclass
class Container(K8sObject):
    name: str = ""
    image: str = ""
    command: List[str] = field(default_factory=list)
    args: List[str] = field(default_factory=list)
    env: List[EnvVar] = field(default_factory=list)
    ports: List[ContainerPort] = field(default_factory=list)
    volume_mounts: List[VolumeMount] = field(default_factory=list)
    resources: Optional[ResourceRequirements] = None
    working_dir: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)

    def env_dict(self) -> Dict[str, str]:
        return {e.name: e.value for e in self.env}

    def set_env(self, name: str, value: str) -> None:
        for e in self.env:
            if e.name == name:
                e.value = value
                return
        self.env.append(EnvVar(name=name, value=value))


@_register
@dataclass
class PodSpec(K8sObject):
    containers: List[Container] = field(default_factory=list)
    volumes: List[Volume] = field(default_factory=list)
    restart_policy: str = ""
    node_selector: Dict[str, str] = field(default_factory=dict)
    subdomain: str = ""
    host_network: bool = False
    scheduler_name: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)


@_register
@dataclass
class PodTemplateSpec(K8sObject):
    metadata: Optional[ObjectMeta] = None
    spec: Optional[PodSpec] = None
    extra: Dict[str, Any] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Pod status (for exit-code policy — reference replicas.go:359-492)
# ---------------------------------------------------------------------------


@_register
@dataclass
class ContainerStateTerminated(K8sObject):
    exit_code: int = 0
    reason: str = ""
    message: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)


@_register
@dataclass
class ContainerState(K8sObject):
    running: Optional[Dict[str, Any]] = None
    waiting: Optional[Dict[str, Any]] = None
    terminated: Optional[ContainerStateTerminated] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@_register
@dataclass
class ContainerStatus(K8sObject):
    name: str = ""
    state: Optional[ContainerState] = None
    last_state: Optional[ContainerState] = field(default=None, metadata={"json": "lastState"})
    restart_count: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)


@_register
@dataclass
class PodStatus(K8sObject):
    phase: str = ""  # Pending|Running|Succeeded|Failed|Unknown
    container_statuses: List[ContainerStatus] = field(default_factory=list)
    pod_ip: str = field(default="", metadata={"json": "podIP"})
    start_time: Optional[float] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@_register
@dataclass
class Pod(K8sObject):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: Optional[PodSpec] = None
    status: PodStatus = field(default_factory=PodStatus)
    extra: Dict[str, Any] = field(default_factory=dict)

    kind = "Pod"
    api_version = "v1"


# ---------------------------------------------------------------------------
# Service
# ---------------------------------------------------------------------------


@_register
@dataclass
class ServicePort(K8sObject):
    name: str = ""
    port: int = 0
    target_port: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)


@_register
@dataclass
class ServiceSpec(K8sObject):
    selector: Dict[str, str] = field(default_factory=dict)
    ports: List[ServicePort] = field(default_factory=list)
    cluster_ip: str = field(default="", metadata={"json": "clusterIP"})
    type: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)


@_register
@dataclass
class Service(K8sObject):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ServiceSpec = field(default_factory=ServiceSpec)
    extra: Dict[str, Any] = field(default_factory=dict)

    kind = "Service"
    api_version = "v1"


# ---------------------------------------------------------------------------
# batch/v1 Job
# ---------------------------------------------------------------------------


@_register
@dataclass
class JobStatus(K8sObject):
    active: int = 0
    succeeded: int = 0
    failed: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)


@_register
@dataclass
class JobSpec(K8sObject):
    completions: Optional[int] = None
    parallelism: Optional[int] = None
    template: Optional[PodTemplateSpec] = None
    backoff_limit: Optional[int] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@_register
@dataclass
class Job(K8sObject):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: JobSpec = field(default_factory=JobSpec)
    status: JobStatus = field(default_factory=JobStatus)
    extra: Dict[str, Any] = field(default_factory=dict)

    kind = "Job"
    api_version = "batch/v1"


# ---------------------------------------------------------------------------
# ConfigMap / Deployment / Event
# ---------------------------------------------------------------------------


@_register
@dataclass
class ConfigMap(K8sObject):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: Dict[str, str] = field(default_factory=dict)
    extra: Dict[str, Any] = field(default_factory=dict)

    kind = "ConfigMap"
    api_version = "v1"


@_register
@dataclass
class DeploymentSpec(K8sObject):
    replicas: int = 1
    selector: Dict[str, Any] = field(default_factory=dict)
    template: Optional[PodTemplateSpec] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@_register
@dataclass
class Deployment(K8sObject):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: DeploymentSpec = field(default_factory=DeploymentSpec)
    extra: Dict[str, Any] = field(default_factory=dict)

    kind = "Deployment"
    api_version = "apps/v1"


@_register
@dataclass
class Event(K8sObject):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    reason: str = ""
    message: str = ""
    type: str = "Normal"
    involved_object: Dict[str, str] = field(default_factory=dict)
    extra: Dict[str, Any] = field(default_factory=dict)

    kind = "Event"
    api_version = "v1"
