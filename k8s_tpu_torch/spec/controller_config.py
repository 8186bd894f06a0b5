"""Operator controller config (the port's copy of
``k8s_tpu/spec/controller_config.py``).

Analogue of reference ``pkg/spec/controller.go`` (``ControllerConfig``
with the ``accelerators:`` map and ``grpcServerFilePath``). The map
stays keyed on resource-limit names (``nvidia.com/gpu`` on GPU nodes,
the reference's own pattern), and the gRPC-server source path becomes
the port's SPMD launcher module, shipped to default-launcher workers.

The cluster scheduler (``fleet``) and the native supervisor are later
slices: :meth:`ControllerConfig.check_ported` refuses them when the
controller starts.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

from k8s_tpu_torch.api.objects import K8sObject, register_type


@register_type
@dataclass
class AcceleratorVolume(K8sObject):
    name: str = ""
    host_path: str = ""
    mount_path: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)


@register_type
@dataclass
class EnvironmentVariableConfig(K8sObject):
    name: str = ""
    value: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)


@register_type
@dataclass
class AcceleratorConfig(K8sObject):
    volumes: List[AcceleratorVolume] = field(default_factory=list)
    env_vars: List[EnvironmentVariableConfig] = field(default_factory=list)
    extra: Dict[str, Any] = field(default_factory=dict)


@register_type
@dataclass
class ControllerConfig(K8sObject):
    accelerators: Dict[str, AcceleratorConfig] = field(default_factory=dict)
    # Python module executed by default-launcher workers (analogue of
    # GrpcServerFilePath, reference controller.go:9-16 + replicas.go:126-150).
    launcher_module: str = "k8s_tpu_torch.launcher.spmd_launcher"
    # The native C++ supervisor (native/ktpu_runtime.cc) and the
    # cluster scheduler's fleet (accelerator type → slices; non-empty
    # turns the scheduler on) are later slices of the port: set, they
    # are refused when the controller starts (check_ported).
    use_native_supervisor: bool = False
    fleet: Dict[str, Any] = field(default_factory=dict)
    # O(100) reconciler hygiene: bound CONCURRENT reconcile ticks
    # across all TrainingJob threads with a shared worker-pool
    # semaphore. 0 (default) = unbounded, today's behavior at small N.
    # LEGACY-mode only (eventDriven: false) — the event-driven core's
    # worker pool subsumes it.
    max_concurrent_reconciles: int = 0
    # Event-driven control plane (docs/SCHEDULER.md "Event-driven
    # core"): ON (default) = one shared coalescing work queue drained
    # by reconcileWorkers threads, reconciles fire on watch/informer
    # events + rate-limited requeues, and quiescent jobs cost nothing
    # between resyncs. OFF = one thread per job ticking every
    # reconcile_interval (the pre-O(1000) behavior).
    event_driven: bool = True
    reconcile_workers: int = 4
    # Slow backstop: a quiescent job with no periodic polling needs
    # (no serving/observability/elastic spec) is still reconciled at
    # least this often, catching anything an event ever missed.
    resync_seconds: float = 300.0
    extra: Dict[str, Any] = field(default_factory=dict)

    def check_ported(self) -> None:
        """Raise for the options of later slices of the port, each with
        its ROADMAP item: the cluster scheduler (a non-empty ``fleet``)
        and the native supervisor."""
        if self.fleet:
            raise NotImplementedError(
                "controller config fleet: the cluster scheduler is not "
                "ported to k8s_tpu_torch yet (ROADMAP A12.3)")
        if self.use_native_supervisor:
            raise NotImplementedError(
                "controller config useNativeSupervisor: the native "
                "supervisor is not ported to k8s_tpu_torch yet "
                "(ROADMAP A12.7)")

    @classmethod
    def from_yaml(cls, text: str) -> "ControllerConfig":
        import yaml

        raw = yaml.safe_load(text) or {}
        accels = {
            name: AcceleratorConfig.from_dict(cfg)
            for name, cfg in (raw.get("accelerators") or {}).items()
        }
        return cls(
            accelerators=accels,
            launcher_module=raw.get("launcherModule", cls.launcher_module),
            use_native_supervisor=raw.get("useNativeSupervisor", False),
            fleet=dict(raw.get("fleet") or {}),
            max_concurrent_reconciles=int(
                raw.get("maxConcurrentReconciles", 0)),
            event_driven=bool(raw.get("eventDriven", True)),
            reconcile_workers=int(raw.get("reconcileWorkers", 4)),
            resync_seconds=float(raw.get("resyncSeconds", 300.0)),
        )
