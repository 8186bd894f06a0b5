"""Input data of the port (port of ``k8s_tpu/data``)."""

from k8s_tpu_torch.data.synthetic import (  # noqa: F401
    learnable_token_batches,
    synthetic_token_batches,
)
