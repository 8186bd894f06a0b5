"""TpuJob CRD schema for GPU jobs: types, validation, defaulting,
accelerator config (the port's counterpart of ``k8s_tpu/spec/tpu_job.py``).

The CRD keeps its group, version and kind, so one manifest format
serves both packages. Following reference ``pkg/spec/tf_job.go``:

- Replica roles are ``COORDINATOR`` / ``WORKER`` (reference:
  MASTER/PS/WORKER, ``tf_job.go:76-80``); no parameter server.
  ``MASTER`` is accepted as an input alias for COORDINATOR.
- A ``gpu:`` block (accelerator, card count) takes the place of the
  JAX package's ``tpu:`` block, which validation refuses by name. One
  pod runs one card, so the worker count is the card count, and the
  nodes it spans follow from the accelerator's cards per node.
- ``configure_accelerators`` keeps the reference's config-driven path
  (resource-limit names → volumes/env, ``tf_job.go:179-233``) and, for
  a ``gpu:`` block, sets ``nvidia.com/gpu`` limits and requests of one
  card per worker pod and the GPU feature discovery node selectors.
- Defaulting supplies the port's SPMD launcher command where the
  reference supplied a default gRPC parameter-server template
  (``tf_job.go:236-301`` + ``setDefaultPSPodTemplateSpec``).
- Admission refuses, by ROADMAP item, what this slice of the port does
  not run: serving fleets, elastic resize, and the ``llama_train``
  options its program refuses (:func:`check_program_options`).
- Phase/State/condition machinery matches the reference semantics
  (phases ``tf_job.go:303-312``, states ``tf_job.go:338-345``,
  10-deep condition ring ``tf_job.go:485-490``, per-replica state
  histogram ``tf_job.go:376-383``, ``AsOwner`` ``tf_job.go:40-52``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from k8s_tpu_torch.api.objects import register_type
from k8s_tpu_torch.api.objects import (
    Container,
    EnvVar,
    HostPathVolumeSource,
    K8sObject,
    ObjectMeta,
    OwnerReference,
    PodSpec,
    PodTemplateSpec,
    ResourceRequirements,
    Volume,
    VolumeMount,
)
from k8s_tpu_torch.spec import topology as topo
from k8s_tpu_torch.spec.controller_config import AcceleratorConfig

# CRD identity (reference tf_job.go:15-27)
CRD_KIND = "TpuJob"
CRD_KIND_PLURAL = "tpujobs"
CRD_GROUP = "tpu.k8s.io"
CRD_VERSION = "v1alpha1"
APP_LABEL = "tpu-job"

# Defaults (reference TfPort=2222, Replicas=1 — tf_job.go:24-27)
DEFAULT_PORT = 2222
DEFAULT_REPLICAS = 1

# Replica roles
COORDINATOR = "COORDINATOR"
WORKER = "WORKER"
TENSORBOARD = "TENSORBOARD"
# Serving-fleet front door of the JAX package's operator: refused here
# with the serving block (ROADMAP A12.5)
ROUTER = "ROUTER"
_ROLE_ALIASES = {"MASTER": COORDINATOR, "CHIEF": COORDINATOR}
VALID_REPLICA_TYPES = (COORDINATOR, WORKER)

# The one container the operator owns env-injection for (reference:
# container named "tensorflow" — tf_job.go:84-88,126-176). The port's
# manifests keep the JAX package's name for it, so one manifest runs
# under either operator.
CONTAINER_NAME = "jax"
DEFAULT_IMAGE = "ghcr.io/k8s-tpu/torch-cuda:latest"

# GPU resource/selector vocabulary: the device plugin's resource and the
# node labels of NVIDIA GPU feature discovery
GPU_RESOURCE = "nvidia.com/gpu"
GPU_PRODUCT_LABEL = "nvidia.com/gpu.product"
GPU_COUNT_LABEL = "nvidia.com/gpu.count"
# cards per worker pod: one process per card
CARDS_PER_POD = 1
# the worker env of a GPU gang: the card inside the pod (the device
# plugin exposes the pod's one card as index 0) and NCCL's error
# handling, so a rank whose peer died aborts its collective (a signal
# exit, 128-255: retryable) instead of waiting forever
GPU_WORKER_ENV = {
    "LOCAL_RANK": "0",
    "LOCAL_WORLD_SIZE": str(CARDS_PER_POD),
    "TORCH_NCCL_ASYNC_ERROR_HANDLING": "1",
    "NCCL_DEBUG": "WARN",
}


def crd_name() -> str:
    return f"{CRD_KIND_PLURAL}.{CRD_GROUP}"


class ValidationError(ValueError):
    """Raised by TpuJobSpec.validate (reference Validate() errors)."""


class NotPortedError(ValidationError, NotImplementedError):
    """A feature of the JAX package's operator or programs that a later
    slice of the port brings; the message names its ROADMAP item."""


# features refused in this slice, with the ROADMAP item of each
SERVING_ITEM = "A12.5 (the serving fleet, router and autoscaler, with A15)"
ELASTIC_ITEM = "A12.4 (elastic resize)"
# llama_train options of the JAX program that the port's program refuses
# (k8s_tpu_torch/programs/llama_train.py _check_unported), mirrored here
# so such a job fails at create instead of as a gang of permanent exits
_UNPORTED_STRATEGIES = {
    "fsdp_tp_sp": "A7 (sequence parallel)",
    "pp": "A8 (pipeline parallel)",
    "pp_fsdp": "A8 (pipeline parallel)",
}
_UNPORTED_OPTIONS = (
    ("num_experts", ("0",), "A9 (the MoE model)"),
    ("quant", ("none", ""), "A10 (int8 training matmuls)"),
)


# ---------------------------------------------------------------------------
# Spec types
# ---------------------------------------------------------------------------


@register_type
@dataclass
class GpuSpec(K8sObject):
    """The GPU request, in place of the JAX package's ``tpu:`` block.
    ``accelerator`` names a node shape of :mod:`k8s_tpu_torch.spec.topology`;
    ``numCards`` is the job's card count, defaulted and checked as the
    TPU block's ``numSlices`` is. One worker pod runs one card."""

    accelerator: str = ""
    num_cards: int = 1
    extra: Dict[str, Any] = field(default_factory=dict)

    def topology(self) -> Optional[topo.GpuTopology]:
        return topo.lookup(self.accelerator) if self.accelerator else None

    def nodes(self) -> int:
        """Nodes the job spans (the ``data`` axis of an HSDP mesh)."""
        t = self.topology()
        return t.nodes(self.num_cards) if t is not None else 1


@register_type
@dataclass
class TpuReplicaSpec(K8sObject):
    """One replica group (reference ``TfReplicaSpec``, tf_job.go:92-106).

    ``replicas=None`` means "derive": 1 for COORDINATOR, and the card
    count for WORKER when a gpu block is present (one pod per card; the
    gang is all-or-nothing, SURVEY §7.2).
    ``is_default_launcher`` marks templates synthesized by defaulting
    (analogue of ``IsDefaultPS``, tf_job.go:105).
    """

    replicas: Optional[int] = None
    template: Optional[PodTemplateSpec] = None
    port: Optional[int] = field(default=None, metadata={"json": "port"})
    replica_type: str = field(default="", metadata={"json": "tpuReplicaType"})
    is_default_launcher: bool = False
    extra: Dict[str, Any] = field(default_factory=dict)


@register_type
@dataclass
class TensorBoardSpec(K8sObject):
    """Reference ``TensorBoardSpec`` (tf_job.go:107-113), unchanged in
    shape: logDir + volume passthrough + service type."""

    log_dir: str = ""
    volumes: List[Volume] = field(default_factory=list)
    volume_mounts: List[VolumeMount] = field(default_factory=list)
    service_type: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)


@register_type
@dataclass
class ChiefSpec(K8sObject):
    replica_name: str = ""
    replica_index: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)


@register_type
@dataclass
class TerminationPolicySpec(K8sObject):
    """Reference ``TerminationPolicySpec`` (tf_job.go:115-123): the
    chief's exit decides the job."""

    chief: Optional[ChiefSpec] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@register_type
@dataclass
class RestartBackoffSpec(K8sObject):
    """Per-job gang-restart backoff schedule (CrashLoopBackOff-style).

    Consecutive gang restarts are spaced ``baseSeconds * factor**n``
    apart (capped at ``capSeconds``, jittered by ``jitter``); a stable
    run of ``resetAfterSeconds`` clears the streak. Routed through
    :class:`k8s_tpu_torch.robustness.backoff.Backoff` — the same policy every
    other retry site in the operator uses."""

    base_seconds: float = 10.0
    factor: float = 2.0
    cap_seconds: float = 300.0
    jitter: float = 0.5
    reset_after_seconds: float = 600.0
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_policy(self):
        from k8s_tpu_torch.robustness.backoff import BackoffPolicy

        return BackoffPolicy(
            base=self.base_seconds,
            factor=self.factor,
            cap=self.cap_seconds,
            jitter=self.jitter,
            reset_after=self.reset_after_seconds,
        )

    def validate(self) -> None:
        try:
            self.to_policy().validate()
        except ValueError as e:
            raise ValidationError(f"restartBackoff: {e}") from e


@register_type
@dataclass
class CheckpointPolicySpec(K8sObject):
    """Multi-tier checkpoint policy (docs/CHECKPOINT.md).

    ``localDir`` names a node-local path (emptyDir / local SSD) for the
    cheap frequent tier — per-host sharded snapshots every
    ``localIntervalSteps`` with a two-phase commit marker.
    ``persistentDir`` is the durable orbax store, demoted to every
    ``persistentIntervalSteps``. ``peerFetch`` lets a replaced pod pull
    its missing local shards from a data-parallel peer before falling
    back to the persistent tier; ``peerPort`` > 0 additionally serves
    each host's local tier over the REST shard wire on that port (0 =
    shared-filesystem peers only). ``restoreParallel`` is the restore
    pipeline's shard-fetch pool width (1 = serial, byte-identical
    results either way) and ``restoreInflightMb`` caps the host bytes
    of fetched-but-not-yet-device-resident shards, so a multi-GB
    restore streams instead of ballooning host RAM (docs/CHECKPOINT.md
    "Restore critical path"). ``saveConcurrency`` is the save
    pipeline's device→host snapshot-pool width (1 = serial copies,
    byte-identical committed output either way) and ``saveBufferBytes``
    caps the host bytes staged between the snapshot and the background
    writer (0 = uncapped; docs/CHECKPOINT.md "Save critical path").
    The whole block flows operator → kubelet env (``KTPU_CKPT_*``) →
    launcher → training program."""

    local_dir: str = ""
    local_interval_steps: int = 0
    local_max_to_keep: int = 2
    persistent_dir: str = ""
    persistent_interval_steps: int = 0
    peer_fetch: bool = True
    peer_port: int = 0
    restore_parallel: int = 8
    restore_inflight_mb: int = 1024
    save_concurrency: int = 8
    save_buffer_bytes: int = 1 << 30
    extra: Dict[str, Any] = field(default_factory=dict)

    def validate(self) -> None:
        if self.local_interval_steps < 0 or self.persistent_interval_steps < 0:
            raise ValidationError(
                "checkpointPolicy: interval steps must be >= 0")
        if self.local_dir and self.local_interval_steps == 0:
            raise ValidationError(
                "checkpointPolicy: localDir set but localIntervalSteps is 0 "
                "(the local tier would never write)")
        if self.local_interval_steps > 0 and not self.local_dir:
            raise ValidationError(
                "checkpointPolicy: localIntervalSteps set without localDir")
        if self.local_max_to_keep < 1:
            raise ValidationError(
                "checkpointPolicy: localMaxToKeep must be >= 1")
        if self.peer_port < 0 or self.peer_port > 65535:
            raise ValidationError("checkpointPolicy: peerPort out of range")
        if self.restore_parallel < 1:
            raise ValidationError(
                "checkpointPolicy: restoreParallel must be >= 1")
        if self.restore_inflight_mb < 0:
            raise ValidationError(
                "checkpointPolicy: restoreInflightMb must be >= 0 "
                "(0 disables the in-flight-bytes cap)")
        if self.save_concurrency < 1:
            raise ValidationError(
                "checkpointPolicy: saveConcurrency must be >= 1")
        if self.save_buffer_bytes < 0:
            raise ValidationError(
                "checkpointPolicy: saveBufferBytes must be >= 0 "
                "(0 disables the staged-bytes cap)")
        if (
            self.persistent_interval_steps > 0
            and self.local_interval_steps > self.persistent_interval_steps
        ):
            raise ValidationError(
                "checkpointPolicy: localIntervalSteps must not exceed "
                "persistentIntervalSteps (the local tier is the FREQUENT one)")

    def to_env(self) -> Dict[str, str]:
        """The launcher/program contract (consumed by
        ``k8s_tpu_torch.ckpt.manager.CheckpointPolicy.from_env``)."""
        env: Dict[str, str] = {}
        if self.local_dir:
            env["KTPU_CKPT_LOCAL_DIR"] = self.local_dir
            env["KTPU_CKPT_LOCAL_EVERY"] = str(self.local_interval_steps)
            env["KTPU_CKPT_LOCAL_KEEP"] = str(self.local_max_to_keep)
        if self.persistent_dir:
            env["KTPU_CKPT_DIR"] = self.persistent_dir
            env["KTPU_CKPT_PERSIST_EVERY"] = str(
                self.persistent_interval_steps)
        env["KTPU_CKPT_PEER_FETCH"] = "1" if self.peer_fetch else "0"
        if self.peer_port:
            env["KTPU_CKPT_PEER_PORT"] = str(self.peer_port)
        env["KTPU_CKPT_RESTORE_PARALLEL"] = str(self.restore_parallel)
        env["KTPU_CKPT_RESTORE_INFLIGHT_MB"] = str(self.restore_inflight_mb)
        env["KTPU_CKPT_SAVE_CONCURRENCY"] = str(self.save_concurrency)
        env["KTPU_CKPT_SAVE_BUFFER_BYTES"] = str(self.save_buffer_bytes)
        return env


@register_type
@dataclass
class TrainingSpec(K8sObject):
    """Trainer-mode knobs (docs/PERF.md) the operator turns into env
    the launcher and training programs consume — the same spec→env→
    program contract as ``checkpointPolicy``.

    ``zeroStage`` selects the cumulative ZeRO ladder (0 = replicated
    update, 1 = optimizer state sharded across the data-parallel mesh
    axis, 2 = additionally the f32 grad-accumulation carry and reduced
    grads — no replicated f32 gradient tree, 3 = additionally the
    largest param leaves themselves, gathered just-in-time in the
    forward). Stage 3 needs a selection: ``zero3MinLeafSize`` (element
    count threshold) and/or ``zero3Leaves`` (param-path substrings,
    e.g. ``["embedding", "lm_head"]``). The legacy ``zero1: true``
    bool normalizes to ``zeroStage: 1`` in ``set_defaults`` (and any
    ``zeroStage >= 1`` sets ``zero1`` back for old consumers).
    ``latencyHiding`` is the JAX package's XLA latency-hiding
    scheduler; the port's ``llama_train`` has no counterpart yet, so
    admission refuses it (ROADMAP A13).
    ``compileCacheDir`` (``KTPU_COMPILE_CACHE_DIR``) names a persistent
    compilation cache, as in the JAX package's contract."""

    zero1: bool = False
    zero_stage: int = 0
    zero3_min_leaf_size: int = 0
    zero3_leaves: List[str] = field(default_factory=list)
    latency_hiding: bool = False
    compile_cache_dir: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)

    def resolved_zero_stage(self) -> int:
        """The effective stage whether or not set_defaults ran: an
        explicit ``zeroStage`` wins, the legacy bool alone means 1."""
        if self.zero_stage:
            return self.zero_stage
        return 1 if self.zero1 else 0

    def set_defaults(self) -> None:
        # legacy zero1 ↔ zeroStage normalization, both directions: old
        # manifests keep working, old consumers of .zero1 keep seeing
        # True for every sharded-update stage
        self.zero_stage = self.resolved_zero_stage()
        if self.zero_stage >= 1:
            self.zero1 = True

    def validate(self) -> None:
        for name in ("zero1", "latency_hiding"):
            if not isinstance(getattr(self, name), bool):
                raise ValidationError(f"training: {name} must be a boolean")
        if not isinstance(self.zero_stage, int) or isinstance(
                self.zero_stage, bool) or not 0 <= self.zero_stage <= 3:
            raise ValidationError(
                f"training: zeroStage must be an integer 0..3 "
                f"(got {self.zero_stage!r})")
        if not isinstance(self.zero3_min_leaf_size, int) or isinstance(
                self.zero3_min_leaf_size, bool) or self.zero3_min_leaf_size < 0:
            raise ValidationError(
                "training: zero3MinLeafSize must be a non-negative integer")
        if not isinstance(self.zero3_leaves, list) or any(
                not isinstance(x, str) or not x for x in self.zero3_leaves):
            raise ValidationError(
                "training: zero3Leaves must be a list of non-empty "
                "param-path substrings")
        if self.resolved_zero_stage() == 3 and not (
                self.zero3_min_leaf_size or self.zero3_leaves):
            raise ValidationError(
                "training: zeroStage 3 requires a leaf selection — set "
                "zero3MinLeafSize and/or zero3Leaves (which params to "
                "shard is a deliberate choice, not a default)")
        if not isinstance(self.compile_cache_dir, str):
            raise ValidationError(
                "training: compileCacheDir must be a string path")

    def to_env(self) -> Dict[str, str]:
        """The launcher/program contract (``KTPU_ZERO_STAGE`` +
        legacy ``KTPU_ZERO1`` read by ``programs.llama_train`` via the
        launcher ``Rendezvous``; ``KTPU_LATENCY_HIDING`` and
        ``KTPU_COMPILE_CACHE_DIR`` by the launcher's
        ``configure_platform`` pre-init hook)."""
        env: Dict[str, str] = {}
        stage = self.resolved_zero_stage()
        if stage:
            env["KTPU_ZERO_STAGE"] = str(stage)
            env["KTPU_ZERO1"] = "1"  # pre-zeroStage programs
        if self.zero3_min_leaf_size:
            env["KTPU_ZERO3_MIN_LEAF_SIZE"] = str(self.zero3_min_leaf_size)
        if self.zero3_leaves:
            env["KTPU_ZERO3_LEAVES"] = ",".join(self.zero3_leaves)
        if self.latency_hiding:
            env["KTPU_LATENCY_HIDING"] = "1"
        if self.compile_cache_dir:
            env["KTPU_COMPILE_CACHE_DIR"] = self.compile_cache_dir
        return env


@register_type
@dataclass
class SchedulingSpec(K8sObject):
    """Cluster-scheduler block (docs/SCHEDULER.md): how this job bids
    in the resource market the operator runs when the controller config
    declares a ``fleet:``.

    ``priority``: higher admits first; a strictly-higher-priority job
    that cannot fit may preempt lower-priority preemptible jobs (the
    victim is driven through the checkpoint-safe preempt flush and
    re-queued — it loses steps, never its checkpoint).
    ``queue``: the quota bucket this job's chips are metered against
    (controller-config ``schedulerQuotas``); DNS-label-shaped.
    ``preemptible: false`` exempts the job from victim selection — it
    can still be queued behind capacity, it just never loses a slice
    it holds.
    ``runtimeEstimateSeconds`` (0 = undeclared) is the operator's
    expected runtime, the currency of conservative backfill
    (docs/SCHEDULER.md "Placement"): declaring one lets THIS job slot
    into a head-of-line reservation gap, and lets jobs queued behind
    this one backfill around it while it runs. Advisory only — a job
    is never killed for outliving its estimate.

    The block round-trips through the operator env like
    ``checkpointPolicy`` (``KTPU_SCHED_*``), so a program can see the
    terms it runs under (e.g. preemptible jobs checkpointing more
    aggressively)."""

    priority: int = 0
    queue: str = "default"
    preemptible: bool = True
    runtime_estimate_seconds: float = 0.0
    extra: Dict[str, Any] = field(default_factory=dict)

    def validate(self) -> None:
        if not isinstance(self.priority, int) or isinstance(
                self.priority, bool):
            raise ValidationError("scheduling: priority must be an integer")
        if abs(self.priority) > 1_000_000:
            raise ValidationError(
                "scheduling: priority must be within ±1000000")
        import re

        if not re.fullmatch(r"[a-z0-9]([a-z0-9-]*[a-z0-9])?",
                            self.queue or ""):
            raise ValidationError(
                f"scheduling: queue {self.queue!r} must be a DNS label "
                "(lowercase alphanumerics and '-')")
        if not isinstance(self.preemptible, bool):
            raise ValidationError(
                "scheduling: preemptible must be a boolean")
        est = self.runtime_estimate_seconds
        if (isinstance(est, bool)
                or not isinstance(est, (int, float))
                or est != est or est < 0):
            raise ValidationError(
                "scheduling: runtimeEstimateSeconds must be a "
                "non-negative number of seconds (0 = undeclared)")
        if est > 365 * 24 * 3600:
            raise ValidationError(
                "scheduling: runtimeEstimateSeconds over a year is "
                "surely a unit mistake")

    def to_env(self) -> Dict[str, str]:
        """The launcher/program contract, mirroring checkpointPolicy."""
        env = {
            "KTPU_SCHED_QUEUE": self.queue,
            "KTPU_SCHED_PRIORITY": str(self.priority),
            "KTPU_SCHED_PREEMPTIBLE": "1" if self.preemptible else "0",
        }
        if self.runtime_estimate_seconds > 0:
            # only when declared: undeclared must look identical to the
            # pre-backfill contract
            env["KTPU_SCHED_RUNTIME_ESTIMATE_S"] = str(
                self.runtime_estimate_seconds)
        return env


@register_type
@dataclass
class ObservabilitySpec(K8sObject):
    """Tracing + telemetry block (docs/OBSERVABILITY.md). The operator
    always stamps jobs with a trace id (``KTPU_TRACE_ID``); this block
    turns on the rest:

    ``obsPort`` > 0 gives every gang WORKER a per-host observability
    endpoint on that port (step heartbeats in the ``/healthz`` stats
    block, ``/metrics``, ``/debug/flightrecorder``), declared on the
    per-index Service and advertised via ``KTPU_OBS_ADVERTISE`` —
    the reconciler then aggregates per-host step/phase skew from it
    and raises ``StragglerDetected`` when one host diverges.

    ``flightRecorderDir`` names a node-local path (emptyDir / local
    SSD) where each host's flight recorder re-dumps its span ring
    every ~0.5s and force-dumps on SIGTERM/crash — the post-mortem
    that survives the pod.

    ``stragglerThreshold``/``stragglerSteps``: a host is flagged when
    its step time >= threshold x its peers' median for that many
    consecutive fresh observations (hysteresis both ways — see
    ``k8s_tpu_torch.obs.straggler``).

    ``trace: false`` disables span recording entirely (``KTPU_TRACE=0``
    in the pod env); the measured overhead of enabled spans is < 1% of
    step time (guarded by the llama_bench smoke test).

    ``onDivergence`` closes the numerics loop (docs/OBSERVABILITY.md,
    "Training health"): when the reconciler's health monitor trips
    ``TrainingDiverged`` (non-finite loss/grads on the gang heartbeat),
    ``restart`` tears the gang down and restores from the last
    *healthy* checkpoint (the restore ceiling is threaded into the
    multi-tier planner so a NaN step is never the restore target;
    counts against ``maxGangRestarts``), ``halt`` fails the job and
    frees the slice (a diverged run burning its reservation is the
    failure mode this exists for), ``none`` (default) raises the
    condition + Warning Event only.

    ``memoryPressureFraction``: a ``MemoryPressure`` Warning Event is
    raised when any host's HBM peak crosses this fraction of device
    capacity (heartbeats carry ``jax`` ``memory_stats()`` gauges —
    the pre-OOM warning shot).

    ``stragglerProfileSeconds`` > 0 makes the operator auto-capture a
    profiler trace (``GET /debug/profile``) from the straggler it
    names, so the ``StragglerDetected`` Event points at evidence in
    ``flightRecorderDir`` instead of a bare pod name (0 = off)."""

    obs_port: int = 0
    flight_recorder_dir: str = ""
    flight_recorder_capacity: int = 256
    straggler_threshold: float = 1.5
    straggler_steps: int = 3
    trace: bool = True
    on_divergence: str = "none"
    memory_pressure_fraction: float = 0.9
    straggler_profile_seconds: float = 2.0
    extra: Dict[str, Any] = field(default_factory=dict)

    def validate(self) -> None:
        if not 0 <= self.obs_port <= 65535:
            raise ValidationError(
                f"observability: obsPort out of range: {self.obs_port}")
        if self.flight_recorder_capacity < 1:
            raise ValidationError(
                "observability: flightRecorderCapacity must be >= 1")
        if self.straggler_threshold <= 1.0:
            raise ValidationError(
                "observability: stragglerThreshold must be > 1.0 (it "
                "multiplies the peer-median step time)")
        if self.straggler_steps < 1:
            raise ValidationError(
                "observability: stragglerSteps must be >= 1")
        if not isinstance(self.trace, bool):
            raise ValidationError("observability: trace must be a boolean")
        if self.on_divergence not in ("none", "restart", "halt"):
            raise ValidationError(
                f"observability: onDivergence must be one of "
                f"none|restart|halt, got {self.on_divergence!r}")
        if not 0.0 < self.memory_pressure_fraction <= 1.0:
            raise ValidationError(
                "observability: memoryPressureFraction must be in (0, 1]")
        if self.straggler_profile_seconds < 0:
            raise ValidationError(
                "observability: stragglerProfileSeconds must be >= 0")

    def to_env(self) -> Dict[str, str]:
        """The launcher/program contract (``KTPU_TRACE``/
        ``KTPU_FLIGHT_*`` consumed by ``k8s_tpu_torch.obs.trace.Tracer
        .from_env``; ``KTPU_OBS_ADVERTISE`` is added per-index by
        ``trainer/replicas.py`` since it embeds the Service name)."""
        env: Dict[str, str] = {}
        if not self.trace:
            env["KTPU_TRACE"] = "0"
        # capacity applies to the IN-MEMORY ring too (the live
        # /debug/flightrecorder route works without a dump dir), so it
        # must not be gated on flightRecorderDir
        env["KTPU_FLIGHT_CAPACITY"] = str(self.flight_recorder_capacity)
        if self.flight_recorder_dir:
            env["KTPU_FLIGHT_DIR"] = self.flight_recorder_dir
        return env


@register_type
@dataclass
class TpuJobSpec(K8sObject):
    runtime_id: str = field(default="", metadata={"json": "RuntimeId"})
    tensorboard: Optional[TensorBoardSpec] = None
    replica_specs: List[TpuReplicaSpec] = field(default_factory=list)
    image: str = field(default="", metadata={"json": "jaxImage"})
    termination_policy: Optional[TerminationPolicySpec] = None
    # the card request (None → whatever the templates' resource limits
    # ask for, through the controller config's accelerators map)
    gpu: Optional[GpuSpec] = None
    # Gang recovery budget: how many whole-gang restarts the reconciler
    # may perform before declaring the job Failed. One rank's death
    # leaves its peers in dead collectives, so every process of the gang
    # restarts together (the reference restarted replicas one by one,
    # replicas.go:216-229).
    max_gang_restarts: int = 3
    # Inter-restart spacing for the gang budget above: without it a
    # crash-looping image burns the whole budget in seconds (restart
    # storm). None → defaulted in set_defaults().
    restart_backoff: Optional[RestartBackoffSpec] = None
    # Multi-tier checkpointing: local snapshots + demoted durable saves
    # + peer-shard restore. None → the job checkpoints however its
    # program args say (or not at all).
    checkpoint_policy: Optional[CheckpointPolicySpec] = None
    # Trainer-mode knobs: the ZeRO ladder, the compile cache. None →
    # program defaults.
    training: Optional[TrainingSpec] = None
    # Tracing + telemetry: per-host obs endpoint, flight recorder,
    # straggler detection. None → trace id stamping only.
    observability: Optional[ObservabilitySpec] = None
    # Cluster-scheduler terms, passed to the programs as KTPU_SCHED_*
    # (the scheduler itself is a later slice, ROADMAP A12.3).
    scheduling: Optional[SchedulingSpec] = None
    # the JAX package's tpu:, serving: and elastic: blocks land here
    # when a manifest carries them; validation refuses each by name
    extra: Dict[str, Any] = field(default_factory=dict)

    # -- normalization ------------------------------------------------------

    def _normalize_types(self) -> None:
        for r in self.replica_specs:
            rt = (r.replica_type or "").upper()
            r.replica_type = _ROLE_ALIASES.get(rt, rt)

    # -- refusals of this slice --------------------------------------------

    def check_ported(self) -> None:
        """Raise :class:`NotPortedError` for the blocks of the JAX
        package's CRD that this slice does not run, each with its
        ROADMAP item, and for a ``tpu:`` block, naming the ``gpu:``
        block that replaces it."""
        if "serving" in self.extra or any(
                r.replica_type == ROUTER for r in self.replica_specs):
            what = ("serving.disaggregation" if isinstance(
                self.extra.get("serving"), dict) and "disaggregation"
                in self.extra["serving"] else "serving")
            raise NotPortedError(
                f"spec.{what}: serving replicas are not ported to the "
                f"k8s_tpu_torch operator yet (ROADMAP {SERVING_ITEM})")
        if "elastic" in self.extra:
            raise NotPortedError(
                "spec.elastic: gang resize is not ported to the "
                f"k8s_tpu_torch operator yet (ROADMAP {ELASTIC_ITEM})")
        if "tpu" in self.extra:
            raise ValidationError(
                "the tpu: block requests TPU slices; a k8s_tpu_torch job "
                "asks for cards with a gpu: block instead "
                "(gpu: {accelerator: h100-80gb, numCards: N}; accelerators: "
                f"{sorted(topo.KNOWN_ACCELERATORS)})")

    # -- validation (reference Validate(), tf_job.go:126-176) --------------

    def validate(self) -> None:
        self._normalize_types()
        self.check_ported()
        for r in self.replica_specs:
            if r.template is None and r.replica_type != WORKER:
                raise ValidationError(f"replica {r.replica_type or '<unset>'} is missing a template")
            if r.replica_type == COORDINATOR and r.replicas != 1:
                raise ValidationError("the COORDINATOR must have replicas = 1")
            if r.port is None:
                raise ValidationError("replicaSpec.port can't be None")
            if r.replica_type not in VALID_REPLICA_TYPES:
                raise ValidationError(
                    f"replicaSpec.replicaType is {r.replica_type!r} but must be one of "
                    f"{list(VALID_REPLICA_TYPES)}"
                )
            if r.template is not None:
                spec = r.template.spec
                names = [c.name for c in (spec.containers if spec else [])]
                if CONTAINER_NAME not in names:
                    raise ValidationError(
                        f"replica type {r.replica_type} is missing a container named "
                        f"{CONTAINER_NAME!r}"
                    )
        if self.termination_policy is not None:
            chief = self.termination_policy.chief
            if chief is None:
                raise ValidationError("invalid termination policy, chief cannot be None")
            if chief.replica_name != COORDINATOR or chief.replica_index != 0:
                raise ValidationError(
                    "invalid termination policy, chief should have "
                    f"replicaName={COORDINATOR} and index=0"
                )
        if self.max_gang_restarts < 0:
            raise ValidationError("maxGangRestarts must be >= 0")
        if self.restart_backoff is not None:
            self.restart_backoff.validate()
        if self.checkpoint_policy is not None:
            self.checkpoint_policy.validate()
        if self.training is not None:
            self.training.validate()
        if self.scheduling is not None:
            self.scheduling.validate()
        if self.observability is not None:
            self.observability.validate()
        if self.gpu is not None and self.gpu.accelerator:
            if self.gpu.topology() is None:
                raise ValidationError(
                    f"unknown gpu.accelerator {self.gpu.accelerator!r}; "
                    f"known: {sorted(topo.KNOWN_ACCELERATORS)}")
            if self.gpu.num_cards < 1:
                raise ValidationError("gpu.numCards must be >= 1")
            t = self.gpu.topology()
            if self.gpu.num_cards > t.cards_per_node and \
                    self.gpu.num_cards % t.cards_per_node:
                raise ValidationError(
                    f"gpu.numCards {self.gpu.num_cards} spans several "
                    f"{self.gpu.accelerator} nodes of {t.cards_per_node} "
                    "cards: a multi-node job takes whole nodes")
            for r in self.replica_specs:
                if r.replica_type == WORKER and r.replicas is not None \
                        and r.replicas != self.gpu.num_cards:
                    raise ValidationError(
                        f"WORKER replicas must equal gpu.numCards = "
                        f"{self.gpu.num_cards} (one pod per card; got "
                        f"{r.replicas})")
        self.check_program_options()

    def num_nodes(self) -> int:
        """Nodes the gang spans: the ``data`` axis of the programs' HSDP
        mesh (1 without a gpu block)."""
        return self.gpu.nodes() if self.gpu is not None else 1

    def check_program_options(self) -> None:
        """Admission mirror of ``llama_train``'s refusals (the port's
        ``programs/llama_train.py`` ``_check_unported``): for a WORKER
        that runs ``llama_train``, the strategies, options and the ZeRO
        stage on an HSDP mesh that a later slice brings raise
        :class:`NotPortedError` here, at create."""
        w = self.replica_spec(WORKER)
        if w is None or w.template is None or w.template.spec is None:
            return
        for c in w.template.spec.containers:
            if c.name != CONTAINER_NAME:
                continue
            env = c.env_dict()
            if not env.get("KTPU_PROGRAM", "").split(":")[0].endswith(
                    "programs.llama_train"):
                return
            flags = program_flags(env.get("KTPU_PROGRAM_ARGS", ""))
            strategy = flags.get("strategy", "fsdp")
            if strategy in _UNPORTED_STRATEGIES:
                raise NotPortedError(
                    f"llama_train strategy={strategy!r} is not ported to "
                    f"k8s_tpu_torch yet (ROADMAP "
                    f"{_UNPORTED_STRATEGIES[strategy]})")
            for key, off, item in _UNPORTED_OPTIONS:
                val = flags.get(key, off[0])
                if val not in off:
                    raise NotPortedError(
                        f"llama_train {key}={val!r} is not ported to "
                        f"k8s_tpu_torch yet (ROADMAP {item})")
            latency = flags.get("latency_hiding", "1" if (
                self.training is not None and self.training.latency_hiding)
                else "0")
            if latency not in ("0", "false", ""):
                raise NotPortedError(
                    "training.latencyHiding is not ported to k8s_tpu_torch "
                    "yet (ROADMAP A13: XLA's latency-hiding scheduler has no "
                    "counterpart yet)")
            stage = (self.training.resolved_zero_stage()
                     if self.training is not None else 0)
            if "zero_stage" in flags:
                stage = int(flags["zero_stage"])
            elif flags.get("zero1") in ("1", "true"):
                stage = max(stage, 1)
            nodes = self.num_nodes()
            if strategy != "dp" and stage >= 1 and nodes > 1:
                raise NotPortedError(
                    f"training.zeroStage {stage} with {nodes} nodes (the "
                    f"data axis of an HSDP mesh) under strategy="
                    f"{strategy!r} is not ported to k8s_tpu_torch yet "
                    "(ROADMAP A5.4)")
            return

    # -- defaulting (reference SetDefaults(), tf_job.go:236-301) ------------

    def set_defaults(self) -> None:
        if not self.image:
            self.image = DEFAULT_IMAGE
        self._normalize_types()
        if self.gpu is not None and self.gpu.num_cards < 1:
            self.gpu.num_cards = 1
        for r in self.replica_specs:
            if r.port is None:
                r.port = DEFAULT_PORT
            if not r.replica_type:
                r.replica_type = COORDINATOR
            if r.replicas is None:
                if r.replica_type == WORKER and self.gpu is not None and self.gpu.topology():
                    r.replicas = self.gpu.num_cards
                else:
                    r.replicas = DEFAULT_REPLICAS
            # Default SPMD-launcher template for template-less WORKERs —
            # the analogue of the reference's default PS template
            # (tf_job.go:286-301): run the port's launcher against the
            # job-level image.
            if r.template is None and r.replica_type == WORKER:
                r.template = _default_launcher_template(self.image)
                r.is_default_launcher = True
        if self.termination_policy is None:
            self.termination_policy = TerminationPolicySpec(
                chief=ChiefSpec(replica_name=COORDINATOR, replica_index=0)
            )
        if self.restart_backoff is None:
            self.restart_backoff = RestartBackoffSpec()
        if self.scheduling is not None and not self.scheduling.queue:
            self.scheduling.queue = "default"
        if self.training is not None:
            self.training.set_defaults()

    # -- accelerator config (reference ConfigureAccelerators, tf_job.go:179-233)

    def configure_accelerators(self, accelerators: Dict[str, AcceleratorConfig]) -> None:
        """Two paths:

        1. *Config-driven* (the reference's): for each container named
           ``jax``, match resource limit/request names (``nvidia.com/gpu``)
           against the controller-config ``accelerators`` map and append
           its volumes/mounts/env.
        2. *GPU block*: when the job has a ``gpu:`` block, every WORKER
           pod asks for its one card (``nvidia.com/gpu`` limit and
           request) on a node of the accelerator's product and card
           count (the GPU feature discovery labels).
        """
        for r in self.replica_specs:
            if r.template is None:
                raise ValidationError(f"replica {r.replica_type} is missing a template")
            spec = r.template.spec
            if spec is None:
                continue
            if self.gpu is not None and self.gpu.accelerator and r.replica_type == WORKER:
                self._configure_gpu(spec)
            for c in spec.containers:
                if c.name != CONTAINER_NAME:
                    continue
                matched: Dict[str, AcceleratorConfig] = {}
                res = c.resources or ResourceRequirements()
                for resource_list in (res.limits, res.requests):
                    for name in resource_list:
                        if name in accelerators:
                            matched[name] = accelerators[name]
                for config in matched.values():
                    for v in config.volumes:
                        spec.volumes.append(
                            Volume(name=v.name, host_path=HostPathVolumeSource(path=v.host_path))
                        )
                        c.volume_mounts.append(VolumeMount(name=v.name, mount_path=v.mount_path))
                    for e in config.env_vars:
                        c.env.append(EnvVar(name=e.name, value=e.value))
                break

    def _configure_gpu(self, spec: PodSpec) -> None:
        t = self.gpu.topology()
        if t is None:
            return
        spec.node_selector.setdefault(GPU_PRODUCT_LABEL, t.product)
        spec.node_selector.setdefault(GPU_COUNT_LABEL, str(t.cards_per_node))
        for c in spec.containers:
            if c.name != CONTAINER_NAME:
                continue
            if c.resources is None:
                c.resources = ResourceRequirements()
            c.resources.limits.setdefault(GPU_RESOURCE, CARDS_PER_POD)
            c.resources.requests.setdefault(GPU_RESOURCE, CARDS_PER_POD)

    # -- helpers ------------------------------------------------------------

    def replica_spec(self, replica_type: str) -> Optional[TpuReplicaSpec]:
        for r in self.replica_specs:
            if r.replica_type == replica_type:
                return r
        return None

    def num_processes(self) -> int:
        """Total SPMD processes = worker pods (coordinator is control-only
        unless it is the sole replica)."""
        w = self.replica_spec(WORKER)
        if w is not None and w.replicas:
            return w.replicas
        return 1


def program_flags(args: str) -> Dict[str, str]:
    """The ``--key=value`` tokens of ``KTPU_PROGRAM_ARGS`` as the port's
    programs read them (``programs/common.py`` ``parse_run_config``:
    shell-split, ``-`` in keys read as ``_``, other tokens ignored)."""
    import shlex

    flags: Dict[str, str] = {}
    for tok in shlex.split(args or ""):
        if tok.startswith("--") and "=" in tok:
            key, _, val = tok[2:].partition("=")
            flags[key.replace("-", "_")] = val
    return flags


def _default_launcher_template(image: str) -> PodTemplateSpec:
    """Default worker runs the port's SPMD launcher (analogue of the
    default-PS template, reference tf_job.go:286-301 — it joins the
    process group over NCCL, or gloo on the CPU, and runs the program
    named by the TpuJob)."""
    return PodTemplateSpec(
        spec=PodSpec(
            containers=[
                Container(
                    image=image,
                    name=CONTAINER_NAME,
                    command=["python", "-m", "k8s_tpu_torch.launcher.spmd_launcher"],
                )
            ],
            restart_policy="OnFailure",
        )
    )


# ---------------------------------------------------------------------------
# Status types (reference tf_job.go:303-383, 347-365)
# ---------------------------------------------------------------------------


class TpuJobPhase:
    NONE = ""
    # Gated by the cluster scheduler (docs/SCHEDULER.md): the job is
    # accepted but holds no resources — no reconciler runs until the
    # scheduler admits it. Also the phase a preemption victim returns
    # to after its checkpoint flush + teardown.
    QUEUED = "Queued"
    CREATING = "Creating"
    RUNNING = "Running"
    CLEANUP = "CleanUp"
    FAILED = "Failed"
    DONE = "Done"


class TpuJobState:
    UNKNOWN = "Unknown"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"


class ReplicaState:
    UNKNOWN = "Unknown"
    STARTING = "Starting"
    RUNNING = "Running"
    FAILED = "Failed"
    SUCCEEDED = "Succeeded"


@register_type
@dataclass
class TpuJobCondition(K8sObject):
    type: str = ""
    reason: str = ""
    transition_time: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)


@register_type
@dataclass
class ReplicaStatus(K8sObject):
    replica_type: str = field(default="", metadata={"json": "tpu_replica_type"})
    state: str = ReplicaState.UNKNOWN
    replicas_states: Dict[str, int] = field(default_factory=dict)
    extra: Dict[str, Any] = field(default_factory=dict)


@register_type
@dataclass
class TpuJobStatus(K8sObject):
    phase: str = TpuJobPhase.NONE
    reason: str = ""
    control_paused: bool = False
    conditions: List[TpuJobCondition] = field(default_factory=list)
    state: str = TpuJobState.UNKNOWN
    replica_statuses: List[ReplicaStatus] = field(default_factory=list)
    gang_restarts: int = 0  # whole-gang restarts performed so far
    extra: Dict[str, Any] = field(default_factory=dict)

    def is_failed(self) -> bool:
        return self.state == TpuJobState.FAILED

    def append_condition(self, ctype: str, reason: str = "") -> None:
        """10-deep condition ring (reference tf_job.go:485-490)."""
        self.conditions.append(
            TpuJobCondition(
                type=ctype,
                reason=reason,
                transition_time=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            )
        )
        if len(self.conditions) > 10:
            self.conditions = self.conditions[1:]

    def set_ready_condition(self) -> None:
        if self.conditions and self.conditions[-1].type == "Ready":
            return
        self.append_condition("Ready")


# ---------------------------------------------------------------------------
# The TpuJob object
# ---------------------------------------------------------------------------


@register_type
@dataclass
class TpuJob(K8sObject):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: TpuJobSpec = field(default_factory=TpuJobSpec)
    status: TpuJobStatus = field(default_factory=TpuJobStatus)
    extra: Dict[str, Any] = field(default_factory=dict)

    kind = CRD_KIND
    api_version = f"{CRD_GROUP}/{CRD_VERSION}"

    def as_owner(self) -> OwnerReference:
        """Reference ``AsOwner()`` (tf_job.go:40-52): everything the
        reconciler creates carries this owner-ref so K8s GC reaps it."""
        return OwnerReference(
            api_version=self.api_version,
            kind=self.kind,
            name=self.metadata.name,
            uid=self.metadata.uid,
            controller=True,
            block_owner_deletion=True,
        )

    def to_dict(self) -> Dict[str, Any]:
        d = super().to_dict()
        d.setdefault("apiVersion", self.api_version)
        d.setdefault("kind", self.kind)
        return d

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"
