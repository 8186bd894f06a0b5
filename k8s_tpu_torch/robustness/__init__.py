"""Retry policy of the port (copy of ``k8s_tpu/robustness``'s backoff)."""

from k8s_tpu_torch.robustness.backoff import (  # noqa: F401
    Backoff,
    BackoffPolicy,
    retry_call,
)
