"""Input data of the port (port of ``k8s_tpu/data``): synthetic batches
here; the record files (``records``), their native loader
(``native_loader``) and the device prefetch (``prefetch``) are imported
from their modules."""

from k8s_tpu_torch.data.synthetic import (  # noqa: F401
    learnable_token_batches,
    synthetic_image_batches,
    synthetic_mnist,
    synthetic_token_batches,
)
