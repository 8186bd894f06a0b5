"""Spec / types layer of the operator: the TpuJob CRD schema for GPU
jobs, validation, defaulting, accelerators (the port's counterpart of
``k8s_tpu/spec``).

Analogue of reference ``pkg/spec/`` (``tf_job.go``, ``controller.go``,
``register.go``, ``tf_job_list.go``).
"""

from k8s_tpu_torch.spec.topology import GpuTopology, KNOWN_ACCELERATORS  # noqa: F401
from k8s_tpu_torch.spec.tpu_job import (  # noqa: F401
    CRD_GROUP,
    CRD_KIND,
    CRD_KIND_PLURAL,
    CRD_VERSION,
    APP_LABEL,
    DEFAULT_PORT,
    COORDINATOR,
    WORKER,
    TENSORBOARD,
    ROUTER,
    CONTAINER_NAME,
    DEFAULT_IMAGE,
    DEFAULT_REPLICAS,
    GPU_RESOURCE,
    GPU_PRODUCT_LABEL,
    GPU_COUNT_LABEL,
    GPU_WORKER_ENV,
    VALID_REPLICA_TYPES,
    CheckpointPolicySpec,
    ChiefSpec,
    GpuSpec,
    NotPortedError,
    ObservabilitySpec,
    ReplicaState,
    ReplicaStatus,
    RestartBackoffSpec,
    SchedulingSpec,
    TensorBoardSpec,
    TerminationPolicySpec,
    TrainingSpec,
    TpuJob,
    TpuJobCondition,
    TpuJobPhase,
    TpuJobSpec,
    TpuJobState,
    TpuJobStatus,
    TpuReplicaSpec,
    ValidationError,
    crd_name,
    program_flags,
)
from k8s_tpu_torch.spec.controller_config import (  # noqa: F401
    AcceleratorConfig,
    AcceleratorVolume,
    ControllerConfig,
    EnvironmentVariableConfig,
)
