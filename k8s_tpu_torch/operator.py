"""Operator process entrypoint (the port's counterpart of
``k8s_tpu/operator.py``), on the in-memory cluster.

Analogue of reference ``cmd/tf_operator/main.go``: flag parsing
(:48-54), YAML ControllerConfig loading (:68-84), the
``MY_POD_NAMESPACE``/``MY_POD_NAME`` env contract (:89-96) and the run
loop (:153-169). ``python -m k8s_tpu_torch.operator --local`` runs the
controller and the in-process kubelet (subprocess pods on this node's
cards) as one single-node control+data plane, with the liveness +
``/metrics`` endpoint on ``--health-port``.

Refused, each with its ROADMAP item: a remote apiserver and leader
election (without ``--local``; A12.2), ``--chaos-level`` (A12.6), and,
through :meth:`ControllerConfig.check_ported`, a config that declares a
scheduler ``fleet`` (A12.3) or ``useNativeSupervisor`` (A12.7).
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
from k8s_tpu_torch.api.client import REST_BACKEND_ITEM, KubeClient
from k8s_tpu_torch.api.crd_client import TpuJobClient
from k8s_tpu_torch.controller.controller import Controller
from k8s_tpu_torch.spec import ControllerConfig

log = logging.getLogger("k8s_tpu_torch.operator")


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
    if not args.local:
        raise NotImplementedError(
            "the operator against a remote apiserver, with leader "
            "election, is not ported to k8s_tpu_torch yet (ROADMAP "
            f"{REST_BACKEND_ITEM}); run it with --local")
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
    namespace = os.environ.get("MY_POD_NAMESPACE", "default")
    name = os.environ.get("MY_POD_NAME", f"tpu-operator-{os.getpid()}")

    client = KubeClient()
    job_client = TpuJobClient(client.cluster)

    health = None
    if args.health_port >= 0:
        from k8s_tpu_torch.controller.health import HealthServer

        health = HealthServer(args.health_port).start()

    from k8s_tpu_torch.runtime.kubelet import LocalKubelet, SubprocessExecutor

    kubelet = LocalKubelet(client, SubprocessExecutor(log_dir=args.log_dir))
    kubelet.start()

    controller = Controller(client, job_client, config, args.namespace)
    if health is not None:
        # pushed obs heartbeats (POST /v1/heartbeat/...) route to the
        # owning reconciler instead of waiting for a poll
        health.heartbeat_sink = controller.ingest_heartbeat
    controller.start()
    log.info("operator %s/%s running (local mode)", namespace, name)
    try:
        while not stop.is_set():
            stop.wait(0.5)
    finally:
        controller.stop()
        kubelet.stop()
        if health is not None:
            health.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
