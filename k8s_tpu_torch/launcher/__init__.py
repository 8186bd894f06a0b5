"""The SPMD launcher of the port (:mod:`.spmd_launcher`), run as
``python -m k8s_tpu_torch.launcher.spmd_launcher``, or shipped to
default-launcher workers through a ConfigMap (:func:`launcher_source`)."""

from __future__ import annotations

import inspect


def launcher_source(config=None) -> str:
    """Source text of the standalone launcher, for the default-launcher
    ConfigMap (the analogue of reading ``GrpcServerFilePath``,
    reference ``replicas.go:126-150``)."""
    from k8s_tpu_torch.launcher import spmd_launcher

    return inspect.getsource(spmd_launcher)
