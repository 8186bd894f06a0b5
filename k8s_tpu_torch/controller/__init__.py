"""The program-side pieces of ``k8s_tpu/controller`` the port needs: the
metrics registry (:mod:`.metrics`) and the per-host obs HTTP endpoint
(:mod:`.health`). Both are stdlib only."""
