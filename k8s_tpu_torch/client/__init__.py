"""Python TpuJob client of the port (reference ``py/tf_job_client.py``)."""

from k8s_tpu_torch.client.job_client import TpuJobApi, load_tpu_job_yaml  # noqa: F401
