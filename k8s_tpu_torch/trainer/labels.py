"""Label vocabulary + selector helper.

(The port's copy of ``k8s_tpu/trainer/labels.py``.)

Analogue of reference ``pkg/trainer/labels.go`` (``ToSelector``:12-19)
with the label keys of ``replicas.go:91-99,153-154`` renamed for the
TPU group: ``tpu.k8s.io``, ``job_type``, ``runtime_id``,
``tpu_job_name``, ``task_index``.
"""

from __future__ import annotations

from typing import Dict

GROUP_LABEL = "tpu.k8s.io"
JOB_TYPE_LABEL = "job_type"
RUNTIME_ID_LABEL = "runtime_id"
JOB_NAME_LABEL = "tpu_job_name"
TASK_INDEX_LABEL = "task_index"
SLICE_ID_LABEL = "slice_id"


class KubernetesLabels(dict):
    """A str→str label map with a deterministic selector string form."""

    def to_selector(self) -> str:
        return ",".join(f"{k}={v}" for k, v in sorted(self.items()))
