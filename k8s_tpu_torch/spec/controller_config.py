"""Operator controller config (the port's copy of
``k8s_tpu/spec/controller_config.py``).

Analogue of reference ``pkg/spec/controller.go`` (``ControllerConfig``
with the ``accelerators:`` map and ``grpcServerFilePath``). The map
stays keyed on resource-limit names (``nvidia.com/gpu`` on GPU nodes,
the reference's own pattern), and the gRPC-server source path becomes
the port's SPMD launcher module, shipped to default-launcher workers.

A non-empty ``fleet`` turns the cluster scheduler on
(:mod:`k8s_tpu_torch.sched`): its keys are the port's accelerators
(``spec/topology.py``: ``h100-80gb``, ``h100-80gb-x1``) and its values
count NODES of that shape, where the JAX package's count TPU slices; a
TPU accelerator key is refused by naming the GPU ones. The native
supervisor is a later slice: :meth:`ControllerConfig.check_ported`
refuses it when the controller starts.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

from k8s_tpu_torch.api.objects import K8sObject, register_type
from k8s_tpu_torch.spec import topology as topo

SCHEDULER_POLICIES = ("fifo-reserve", "backfill", "backfill+pack")


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
    # The native C++ supervisor (native/ktpu_runtime.cc) is a later
    # slice of the port: set, it is refused when the controller starts
    # (check_ported).
    use_native_supervisor: bool = False
    # Cluster scheduler (docs/SCHEDULER.md): the GPU fleet this
    # operator owns, accelerator → number of NODES of that shape.
    # NON-EMPTY turns the scheduler ON: jobs enter a Queued phase and a
    # reconciler only spawns on admission. Empty (default) preserves
    # per-job placement exactly as before. A fleet entry may also be a
    # topology block — `{leafSwitches: P, nodesPerSwitch: S}` — which
    # names the pool's P×S node positions under P leaf switches
    # (capacity P×S) and turns on placement scoring for it;
    # `fleet_topology` carries the parsed shapes, `fleet` always holds
    # the plain counts.
    fleet: Dict[str, int] = field(default_factory=dict)
    # accelerator → (leafSwitches, nodesPerSwitch) for fleet entries
    # that declared a topology block.
    fleet_topology: Dict[str, Any] = field(default_factory=dict)
    # Placement/backfill policy: "fifo-reserve" (default — the absolute
    # head-of-line reservation), "backfill" (EASY-style conservative
    # backfill into reservation gaps), or "backfill+pack" (backfill +
    # the topology-aware placement scorer on pools that declare a
    # topology block).
    scheduler_policy: str = "fifo-reserve"
    # Per-queue admission quota in CARDS (spec.scheduling.queue →
    # cards); a queue missing from the map is unlimited.
    scheduler_quotas: Dict[str, int] = field(default_factory=dict)
    # Re-admission hold-off after a preemption (no-flap window for the
    # victim's flush + teardown to land).
    scheduler_cooldown_seconds: float = 5.0
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
        its ROADMAP item (the native supervisor), and for a fleet key
        that is not one of the port's accelerators."""
        for accel in self.fleet:
            check_fleet_key(accel)
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
        fleet: Dict[str, int] = {}
        fleet_topology: Dict[str, Any] = {}
        for k, v in (raw.get("fleet") or {}).items():
            check_fleet_key(str(k))
            if isinstance(v, dict):
                if "pods" in v or "slicesPerPod" in v:
                    raise ValueError(
                        f"fleet.{k}: a GPU pool's topology block is "
                        f"{{leafSwitches: P, nodesPerSwitch: S}} (TPU "
                        f"pods/slicesPerPod map to leaf switches/nodes), "
                        f"got {v!r}")
                switches = int(v.get("leafSwitches", 1))
                per = int(v.get("nodesPerSwitch", 0))
                if switches <= 0 or per <= 0:
                    raise ValueError(
                        f"fleet.{k}: topology block needs positive "
                        f"leafSwitches and nodesPerSwitch, got {v!r}")
                fleet[str(k)] = switches * per
                fleet_topology[str(k)] = (switches, per)
            else:
                fleet[str(k)] = int(v)
        policy = str(raw.get("schedulerPolicy", "fifo-reserve"))
        if policy not in SCHEDULER_POLICIES:
            raise ValueError(
                f"schedulerPolicy {policy!r} is not one of "
                f"fifo-reserve | backfill | backfill+pack")
        return cls(
            accelerators=accels,
            launcher_module=raw.get("launcherModule", cls.launcher_module),
            use_native_supervisor=raw.get("useNativeSupervisor", False),
            fleet=fleet,
            fleet_topology=fleet_topology,
            scheduler_policy=policy,
            scheduler_quotas={
                str(k): int(v)
                for k, v in (raw.get("schedulerQuotas") or {}).items()},
            scheduler_cooldown_seconds=float(
                raw.get("schedulerCooldownSeconds", 5.0)),
            max_concurrent_reconciles=int(
                raw.get("maxConcurrentReconciles", 0)),
            event_driven=bool(raw.get("eventDriven", True)),
            reconcile_workers=int(raw.get("reconcileWorkers", 4)),
            resync_seconds=float(raw.get("resyncSeconds", 300.0)),
        )


def check_fleet_key(accelerator: str) -> None:
    """A fleet counts nodes of one of the port's GPU accelerators; a TPU
    slice type (or any other name) is refused by naming them."""
    if topo.lookup(accelerator) is None:
        raise ValueError(
            f"fleet: {accelerator!r} is not a GPU accelerator of the port; "
            f"a fleet counts nodes of one of {sorted(topo.KNOWN_ACCELERATORS)}")
