"""Python TpuJob client (the port's copy of ``k8s_tpu/client/job_client.py``).

Analogue of reference ``py/tf_job_client.py``: ``create_tf_job`` via
the custom-objects API (:18-40) and the ``wait_for_job`` poll loop with
timeout + status callback (:43-96) — here against the framework's CRD
client (the in-memory local mode, or the REST backend against an API
server).
PyYAML is imported only to parse a manifest, so the client runs where
jobs are built as objects.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

from k8s_tpu_torch.api.crd_client import TpuJobClient
from k8s_tpu_torch.spec import TpuJob, TpuJobPhase

log = logging.getLogger(__name__)

DEFAULT_TIMEOUT = 300.0  # reference py/tf_job_client.py:64 (5 min)
DEFAULT_POLL = 1.0


def load_tpu_job_yaml(text: str) -> TpuJob:
    """Parse a TpuJob manifest (the kubectl-facing YAML schema; a JSON
    manifest, which is YAML too, parses without PyYAML)."""
    import json

    try:
        doc = json.loads(text)
    except ValueError:
        import yaml

        doc = yaml.safe_load(text)
    if not isinstance(doc, dict):
        raise ValueError("manifest must be a mapping")
    kind = doc.get("kind")
    if kind and kind != "TpuJob":
        raise ValueError(f"manifest kind is {kind!r}, want TpuJob")
    return TpuJob.from_dict(doc)


class TpuJobApi:
    """Thin convenience wrapper for scripts and test harnesses."""

    def __init__(self, crd_client: TpuJobClient):
        self.client = crd_client

    def create(self, job: TpuJob) -> TpuJob:
        created = self.client.create(job)
        log.info("created TpuJob %s", created.key)
        return created

    def create_from_yaml(self, text: str) -> TpuJob:
        return self.create(load_tpu_job_yaml(text))

    def get(self, namespace: str, name: str) -> TpuJob:
        return self.client.get(namespace, name)

    def delete(self, namespace: str, name: str) -> None:
        self.client.delete(namespace, name)

    def wait_for_job(
        self,
        namespace: str,
        name: str,
        timeout: float = DEFAULT_TIMEOUT,
        polling_interval: float = DEFAULT_POLL,
        status_callback: Optional[Callable[[TpuJob], None]] = None,
    ) -> TpuJob:
        """Poll until the job reaches a terminal phase (reference
        wait_for_job semantics: TimeoutError past the budget)."""
        deadline = time.monotonic() + timeout
        while True:
            job = self.client.get(namespace, name)
            if status_callback is not None:
                status_callback(job)
            if job.status.phase in (TpuJobPhase.DONE, TpuJobPhase.FAILED):
                return job
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"timeout waiting for TpuJob {namespace}/{name}; "
                    f"phase={job.status.phase!r}"
                )
            time.sleep(polling_interval)
