"""The SPMD launcher of the port (:mod:`.spmd_launcher`), run as
``python -m k8s_tpu_torch.launcher.spmd_launcher``."""
