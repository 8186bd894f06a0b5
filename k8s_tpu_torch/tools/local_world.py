"""LocalWorld: a complete single-host control+data plane in one object
(the port's copy of ``k8s_tpu/tools/local_world.py``).

Bundles the in-memory cluster, CRD client, controller, and kubelet —
the "ephemeral cluster per CI run" of the reference's test infra
(SURVEY §4 tier 3), collapsed to one process with real subprocess
execution when requested. Subprocess pods run on the node's cards: the
world forces no platform, and a caller that wants CPU pods passes
``extra_env={"KTPU_FORCE_PLATFORM": "cpu"}``. A job with an obs port
gets its heartbeats from the loopback ports the kubelet's resolver gave
its workers' Services (there is no Service DNS here).
"""

from __future__ import annotations

from typing import Dict, Optional

from k8s_tpu_torch.api.client import KubeClient
from k8s_tpu_torch.api.cluster import InMemoryCluster
from k8s_tpu_torch.api.crd_client import TpuJobClient
from k8s_tpu_torch.client.job_client import TpuJobApi
from k8s_tpu_torch.controller.controller import Controller
from k8s_tpu_torch.controller.poller import shared_poller
from k8s_tpu_torch.runtime.kubelet import LocalKubelet, SimulatedExecutor, SubprocessExecutor
from k8s_tpu_torch.spec import ControllerConfig


class LocalWorld:
    def __init__(
        self,
        subprocess_pods: bool = False,
        log_dir: Optional[str] = None,
        config: Optional[ControllerConfig] = None,
        reconcile_interval: float = 0.1,
        executor=None,
        extra_env: Optional[Dict[str, str]] = None,
        cards=None,
    ):
        self.cluster = InMemoryCluster()
        self.client = KubeClient(self.cluster)
        self.job_client = TpuJobClient(self.cluster)
        self.api = TpuJobApi(self.job_client)
        self.controller = Controller(
            self.client,
            self.job_client,
            config or ControllerConfig(),
            reconcile_interval=reconcile_interval,
        )
        if executor is None:
            if subprocess_pods:
                executor = SubprocessExecutor(log_dir=log_dir,
                                              extra_env=extra_env)
            else:
                executor = SimulatedExecutor(exit_code=0)
        self.kubelet = LocalKubelet(self.client, executor, cards=cards)
        self.controller.worker_stats_fetcher_factory = self._stats_fetcher

    def _stats_fetcher(self, tj):
        """The obs tick's heartbeat source for ``tj``: GET each worker's
        obs endpoint on its resolved loopback port; None for a job
        without an obs port (its reconciler then polls nothing)."""
        obs = tj.job.spec.observability
        if obs is None or not obs.obs_port:
            return None

        def fetch():
            wset = tj._worker_set()
            if wset is None:
                return None
            urls = {
                i: "http://127.0.0.1:%d/healthz" % self.kubelet.resolver.port_for(
                    wset.job_name(i), obs.obs_port)
                for i in range(wset.spec.replicas or 0)
            }
            payloads = shared_poller().fetch_json_many(
                urls, timeout=2.0, component="obs")
            out = {}
            for i, payload in payloads.items():
                hb = tj._graft_ckpt(payload)
                if hb is not None:
                    out[i] = hb
            return out or None

        return fetch

    def start(self) -> "LocalWorld":
        self.kubelet.start()
        self.controller.start()
        return self

    def stop(self) -> None:
        self.controller.stop()
        self.kubelet.stop()

    def __enter__(self) -> "LocalWorld":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
