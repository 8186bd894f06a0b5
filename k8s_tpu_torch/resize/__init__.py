"""Elastic gang resize (the port's counterpart of ``k8s_tpu/resize``,
docs/ELASTIC.md), counted in GPU nodes.

The layer between "a pod died permanently" and "training continues at
DP−1": a pure, clock-injected decision core
(:mod:`k8s_tpu_torch.resize.elastic`) the reconciler feeds with the
observe→act signals — per-host heartbeat freshness (dead-host
detection), the scheduler inventory's attainable-node view (shrink
when a node is gone for good), and the capacity-return tick (grow
back when the fleet frees nodes). Verdicts are data; the operator
acts on them by driving the ``Resizing`` TpuJob transition
(flush-teardown → re-plan the restore at the new DP degree → re-admit
the reshaped footprint through the scheduler ledger).
"""

from k8s_tpu_torch.resize.elastic import (  # noqa: F401
    ElasticResizer,
    ResizeVerdict,
)
