"""Operator process entrypoint (the port's counterpart of
``k8s_tpu/operator.py``).

Analogue of reference ``cmd/tf_operator/main.go``: flag parsing
(:48-54), YAML ControllerConfig loading (:68-84), the
``MY_POD_NAMESPACE``/``MY_POD_NAME`` env contract (:89-96), leader
election with 15s/5s/3s lease timing (:40-46,125-148), and the run
loop (:153-169), with the liveness + ``/metrics`` endpoint on
``--health-port``.

- Without ``--local`` the operator talks to an apiserver (resolved by
  :func:`~k8s_tpu_torch.api.client.get_cluster_client`:
  ``KTPU_APISERVER_URL``, ``--kubeconfig``/``KUBECONFIG``, the in-cluster
  service account, else in memory) and reconciles only while it holds
  the ``tpu-operator`` lock; the pods run on the cluster's nodes (e.g.
  ``python -m k8s_tpu_torch.api.apiserver --with-kubelet``).
- ``--local`` runs the controller and the in-process kubelet
  (subprocess pods on this node's cards) on the in-memory cluster, as
  one single-node control+data plane; its elector wins the lock at once.

Refused, each with its ROADMAP item: ``--chaos-level`` (A12.6), and,
through :meth:`ControllerConfig.check_ported`, ``useNativeSupervisor``
(A12.7).
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import tempfile
import threading

from k8s_tpu_torch import version
from k8s_tpu_torch.api.client import KubeClient, get_cluster_client
from k8s_tpu_torch.api.crd_client import TpuJobClient
from k8s_tpu_torch.api.election import LeaderElector
from k8s_tpu_torch.controller.controller import Controller
from k8s_tpu_torch.spec import ControllerConfig

log = logging.getLogger("k8s_tpu_torch.operator")

LEASE_DURATION = 15.0  # reference main.go:42-44
RENEW_DEADLINE = 5.0
RETRY_PERIOD = 3.0


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="tpu-operator")
    p.add_argument("--controller-config-file", default="",
                   help="YAML ControllerConfig (accelerators map, launcher module)")
    p.add_argument("--chaos-level", type=int, default=-1,
                   help="chaos matrix profile (-1 disables; the chaos "
                        "monkey is not ported yet)")
    p.add_argument("--health-port", type=int, default=8080,
                   help="liveness + /metrics listener. -1 disables, "
                        "0 = ephemeral port")
    p.add_argument("--namespace", default=None)
    p.add_argument("--kubeconfig", default=None,
                   help="kubeconfig path for out-of-cluster runs; default: "
                        "KTPU_APISERVER_URL / KUBECONFIG env, in-cluster "
                        "serviceaccount, then local in-memory mode")
    p.add_argument("--log-dir", default=os.path.join(
        tempfile.gettempdir(), "ktpu-logs"), help="pod logs")
    p.add_argument("--local", action="store_true",
                   help="single-host mode: in-memory cluster + local kubelet")
    p.add_argument("--version", action="store_true")
    return p.parse_args(argv)


def load_config(path: str) -> ControllerConfig:
    if not path:
        return ControllerConfig()
    with open(path) as f:
        return ControllerConfig.from_yaml(f.read())


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s] %(message)s",
    )
    args = parse_args(argv)
    if args.version:
        print(f"tpu-operator {version.VERSION} (git {version.GIT_SHA})")
        return 0
    if args.chaos_level >= 0:
        raise NotImplementedError(
            "--chaos-level: the chaos monkey is not ported to "
            "k8s_tpu_torch yet (ROADMAP A12.6)")

    config = load_config(args.controller_config_file)
    config.check_ported()

    # first, so that a SIGTERM at any point of the start-up is a clean stop
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())

    # env contract (reference main.go:89-96)
    namespace = os.environ.get("MY_POD_NAMESPACE", "default" if args.local else "")
    name = os.environ.get("MY_POD_NAME", f"tpu-operator-{os.getpid()}" if args.local else "")
    if not namespace or not name:
        log.error("MY_POD_NAMESPACE and MY_POD_NAME must be set")
        return 1

    # --local forces the in-memory backend: the in-process kubelet hangs
    # off its synchronous hooks, which no remote apiserver can provide
    client = KubeClient() if args.local else get_cluster_client(args.kubeconfig)
    job_client = TpuJobClient(client.cluster)

    health = None
    if args.health_port >= 0:
        from k8s_tpu_torch.controller.health import HealthServer

        health = HealthServer(args.health_port).start()

    kubelet = None
    if args.local:
        from k8s_tpu_torch.runtime.kubelet import LocalKubelet, SubprocessExecutor

        kubelet = LocalKubelet(client, SubprocessExecutor(log_dir=args.log_dir))
        kubelet.start()

    elector = LeaderElector(
        client.cluster,
        namespace,
        "tpu-operator",
        identity=name,
        lease_duration=LEASE_DURATION,
        renew_deadline=RENEW_DEADLINE,
        retry_period=RETRY_PERIOD,
    )

    def on_started_leading(lost: threading.Event):
        controller = Controller(client, job_client, config, args.namespace)
        if health is not None:
            # pushed obs heartbeats (POST /v1/heartbeat/...) route to
            # the owning reconciler instead of waiting for a poll
            health.heartbeat_sink = controller.ingest_heartbeat
        controller.start()
        log.info("operator %s/%s running (%s)", namespace, name,
                 "local mode" if args.local else "leading")
        try:
            while not stop.is_set() and not lost.is_set():
                stop.wait(0.5)
        finally:
            controller.stop()

    def on_stopped_leading():
        # Reference main.go Fatalf-exits here; the liveness endpoint
        # flips too, so the kubelet restarts us even if shutdown wedges.
        log.info("leader election lost")
        if health is not None:
            health.set_unhealthy()

    log.info("operator %s/%s waiting for the lock", namespace, name)
    try:
        elector.run(on_started_leading, on_stopped_leading, stop=stop)
    finally:
        if kubelet is not None:
            kubelet.stop()
        if health is not None:
            health.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
