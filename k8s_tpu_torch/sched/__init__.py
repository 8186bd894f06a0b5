"""Cluster-scale scheduler (the port's copy of ``k8s_tpu/sched``;
docs/SCHEDULER.md).

The layer the Controller consults before any reconciler materializes
resources: a node inventory derived from the controller-config
accelerator fleet (:mod:`k8s_tpu_torch.sched.inventory`, which maps
the JAX package's slices to GPU nodes and its chips to cards) —
optionally with named nodes under leaf switches and a pure placement
scorer — and a pure, clock-injected decision core
(:mod:`k8s_tpu_torch.sched.scheduler`) implementing per-queue quota
admission, priority ordering, gang bin-packing onto nodes,
checkpoint-cost-aware preemption, and EASY-style conservative backfill
behind the head-of-line reservation.
"""

from k8s_tpu_torch.sched.inventory import (  # noqa: F401
    Footprint,
    OversubscriptionError,
    PoolTopology,
    SliceAssignment,
    SliceInventory,
    footprint_of,
    plan_placement,
)
from k8s_tpu_torch.sched.scheduler import (  # noqa: F401
    ClusterScheduler,
    JobRequest,
    Preemption,
    StarvationError,
    TickResult,
)
