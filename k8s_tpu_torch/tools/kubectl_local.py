"""kubectl-style CLI of the port's operator, in local mode (the port's
counterpart of ``k8s_tpu/tools/kubectl_local.py``).

The reference's user surface is ``kubectl create -f tf_job.yaml``
(README quickstart). Here every verb runs without a cluster:

- ``validate -f job.yaml`` checks a manifest offline (defaults, then
  validation — including the refusals of features the port does not
  run yet, each with its ROADMAP item);
- ``create -f job.yaml`` runs the job to its end in a
  :class:`~k8s_tpu_torch.tools.local_world.LocalWorld` that lives for
  the command (subprocess pods on this machine's cards, or simulated
  pods with ``--simulate``), then records the finished job, its Events
  and its pods' logs under ``--state-dir``;
- ``get``, ``describe``, ``logs`` and ``delete`` read (or remove) those
  records.

``--server`` (a remote apiserver) is the REST backend, not ported yet
(ROADMAP A12.2).

    python -m k8s_tpu_torch.tools.kubectl_local create \\
        -f k8s_tpu_torch/examples/gpu_job_cpu_tiny.yaml
    python -m k8s_tpu_torch.tools.kubectl_local describe llama-tiny-cpu
    python -m k8s_tpu_torch.tools.kubectl_local logs llama-tiny-cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from k8s_tpu_torch import spec as S
from k8s_tpu_torch.api.client import REST_BACKEND_ITEM
from k8s_tpu_torch.client.job_client import load_tpu_job_yaml
from k8s_tpu_torch.tools.local_world import LocalWorld
from k8s_tpu_torch.trainer import labels as L

DEFAULT_STATE_DIR = os.path.join(tempfile.gettempdir(), "ktpu-local")
_RESOURCE_WORDS = ("tpujobs", "tpujob", "tj")


def cmd_validate(args) -> int:
    with open(args.file) as f:
        job = load_tpu_job_yaml(f.read())
    job.spec.set_defaults()
    try:
        job.spec.validate()
    except S.ValidationError as e:
        print(f"INVALID: {e}")
        return 1
    print(f"valid TpuJob {job.metadata.name or '<unnamed>'}")
    for r in job.spec.replica_specs:
        print(f"  {r.replica_type}: replicas={r.replicas} port={r.port}")
    if job.spec.gpu is not None and job.spec.gpu.accelerator:
        t = job.spec.gpu.topology()
        print(
            f"  gpu: {job.spec.gpu.accelerator} × {job.spec.gpu.num_cards} "
            f"card(s) on {job.spec.gpu.nodes()} node(s) of "
            f"{t.cards_per_node}"
        )
    return 0


def _record_path(state_dir: str, namespace: str, name: str) -> str:
    return os.path.join(state_dir, namespace, f"{name}.json")


def _save_record(world: LocalWorld, state_dir: str, log_dir: str,
                 namespace: str, name: str) -> None:
    """The finished job, its Events and its pods (phase, exit code,
    restarts, log file) — what the read verbs show."""
    job = world.job_client.get(namespace, name)
    events = [
        {"type": e.type, "reason": e.reason, "message": e.message}
        for e in world.client.events.list(namespace)
        if (e.involved_object or {}).get("name") == name
    ]
    pods = []
    for p in world.client.pods.list(namespace):
        labels = p.metadata.labels or {}
        if labels.get(L.JOB_NAME_LABEL) != name:
            continue
        term = None
        for cs in p.status.container_statuses:
            if cs.state is not None and cs.state.terminated is not None:
                term = cs.state.terminated
        pods.append({
            "name": p.metadata.name,
            "replica_type": labels.get(L.JOB_TYPE_LABEL, ""),
            "index": int(labels.get(L.TASK_INDEX_LABEL, "0") or 0),
            "phase": p.status.phase,
            "exit_code": term.exit_code if term is not None else None,
            "log": os.path.join(log_dir, f"{p.metadata.name}.log"),
        })
    path = _record_path(state_dir, namespace, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"job": job.to_dict(), "events": events, "pods": pods},
                  f, indent=1, sort_keys=True)


def cmd_create(args) -> int:
    with open(args.file) as f:
        text = f.read()
    log_dir = args.log_dir or os.path.join(args.state_dir, "logs")
    # pods are deleted with their gang at the end; keep them until the
    # record is written
    with LocalWorld(subprocess_pods=not args.simulate,
                    log_dir=log_dir) as world:
        job = world.api.create_from_yaml(text)
        ns = job.metadata.namespace or "default"
        print(f"tpujob.tpu.k8s.io/{job.metadata.name} created")
        final = world.api.wait_for_job(
            ns, job.metadata.name, timeout=args.timeout,
            status_callback=lambda j: print(
                f"  phase={j.status.phase or 'None'} state={j.status.state}"),
        )
        _save_record(world, args.state_dir, log_dir, ns, job.metadata.name)
    print(f"final: phase={final.status.phase} state={final.status.state}"
          + (f" reason={final.status.reason}" if final.status.reason else ""))
    return 0 if final.status.state == S.TpuJobState.SUCCEEDED else 1


def _name_of(args) -> str:
    """kubectl grammar: an optional resource word, then the name."""
    if args.resource in _RESOURCE_WORDS:
        return args.name
    return args.name if args.name is not None else args.resource


def _load(state_dir: str, namespace: str, name: str):
    path = _record_path(state_dir, namespace, name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def cmd_get(args) -> int:
    name = _name_of(args)
    ns_dir = os.path.join(args.state_dir, args.namespace)
    names = [name] if name else sorted(
        f[:-5] for f in (os.listdir(ns_dir) if os.path.isdir(ns_dir) else [])
        if f.endswith(".json"))
    print(f"{'NAME':24} {'PHASE':10} {'STATE':10} {'RESTARTS':8}")
    for n in names:
        rec = _load(args.state_dir, args.namespace, n)
        if rec is None:
            print(f"TpuJob {args.namespace}/{n} not found")
            return 1
        st = S.TpuJob.from_dict(rec["job"]).status
        print(f"{n:24} {st.phase or 'None':10} {st.state or '-':10} "
              f"{st.gang_restarts:<8}")
    return 0


def cmd_describe(args) -> int:
    """`kubectl describe`-style detail: spec summary, status, the
    condition ring, replica-state histograms, pods and Events."""
    name = _name_of(args)
    if not name:
        print("usage: describe [tpujobs] <name>")
        return 1
    rec = _load(args.state_dir, args.namespace, name)
    if rec is None:
        print(f"TpuJob {args.namespace}/{name} not found")
        return 1
    j = S.TpuJob.from_dict(rec["job"])
    print(f"Name:       {j.metadata.name}")
    print(f"Namespace:  {j.metadata.namespace}")
    print(f"RuntimeId:  {j.spec.runtime_id or '<unassigned>'}")
    if j.spec.gpu is not None and j.spec.gpu.accelerator:
        print(f"GPU:        {j.spec.gpu.accelerator} × "
              f"{j.spec.gpu.num_cards} card(s)")
    print("Replicas:")
    for r in j.spec.replica_specs:
        print(f"  {r.replica_type}: replicas={r.replicas} port={r.port}")
    s = j.status
    print(f"Phase:      {s.phase or 'None'}")
    print(f"State:      {s.state or '-'}")
    if s.reason:
        print(f"Reason:     {s.reason}")
    print(f"GangRestarts: {s.gang_restarts}/{j.spec.max_gang_restarts}")
    if s.replica_statuses:
        print("ReplicaStatuses:")
        for rs in s.replica_statuses:
            hist = " ".join(f"{k}={v}" for k, v in
                            sorted(rs.replicas_states.items()))
            print(f"  {rs.replica_type}: {rs.state}  [{hist}]")
    if s.conditions:
        print("Conditions:")
        for c in s.conditions:
            print(f"  {c.type}: {c.reason}")
    if rec["pods"]:
        print("Pods:")
        for p in sorted(rec["pods"], key=lambda p: p["name"]):
            print(f"  {p['name']}: {p['phase']} exit={p['exit_code']}")
    if rec["events"]:
        print("Events:")
        for e in rec["events"][-15:]:
            print(f"  {e['type']:8} {e['reason']:20} {e['message']}")
    return 0


def cmd_logs(args) -> int:
    """`kubectl logs`-style: an exact pod name, or a TpuJob name (its
    WORKER pod ``--index``, the newest restart)."""
    rec = _load(args.state_dir, args.namespace, args.name)
    if rec is not None:
        pods = sorted((p for p in rec["pods"]
                       if p["replica_type"] == S.WORKER
                       and p["index"] == args.index), key=lambda p: p["name"])
        path = pods[-1]["log"] if pods else None
    else:
        path = None
        ns_dir = os.path.join(args.state_dir, args.namespace)
        for f in (os.listdir(ns_dir) if os.path.isdir(ns_dir) else []):
            if not f.endswith(".json"):
                continue
            r = _load(args.state_dir, args.namespace, f[:-5])
            path = next((p["log"] for p in r["pods"]
                         if p["name"] == args.name), path)
    if path is None or not os.path.exists(path):
        print(f"no pod log or TpuJob pods named {args.name!r}")
        return 1
    with open(path, errors="replace") as f:
        lines = f.readlines()
    print(f"# logs of {os.path.basename(path)[:-4]}", flush=True)
    sys.stdout.write("".join(lines[-args.tail:] if args.tail else lines))
    return 0


def cmd_delete(args) -> int:
    path = _record_path(args.state_dir, args.namespace, args.name)
    if not os.path.exists(path):
        print(f"TpuJob {args.namespace}/{args.name} not found")
        return 1
    os.remove(path)
    print(f"tpujob.tpu.k8s.io/{args.name} deleted")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ktpu")
    p.add_argument("--state-dir", default=DEFAULT_STATE_DIR,
                   help="where create records finished jobs for the "
                        "read verbs")
    p.add_argument("--server", default=os.environ.get(
        "KTPU_APISERVER_URL", ""), help=argparse.SUPPRESS)
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("create", help="run a TpuJob to its end locally")
    c.add_argument("-f", "--file", required=True)
    c.add_argument("--timeout", type=float, default=600.0)
    c.add_argument("--simulate", action="store_true", help="simulated pods")
    c.add_argument("--log-dir", default="",
                   help="pod logs (default: <state-dir>/logs)")
    v = sub.add_parser("validate", help="validate a TpuJob manifest")
    v.add_argument("-f", "--file", required=True)
    for verb in ("get", "describe"):
        g = sub.add_parser(verb, help=f"{verb} recorded TpuJobs")
        g.add_argument("resource", nargs="?", default=None,
                       help="kubectl-style resource word (tpujobs) or a job name")
        g.add_argument("name", nargs="?", default=None)
        g.add_argument("-n", "--namespace", default="default")
    lg = sub.add_parser("logs", help="pod logs (pod name or TpuJob name)")
    lg.add_argument("name")
    lg.add_argument("-n", "--namespace", default="default")
    lg.add_argument("--tail", type=int, default=None,
                    help="last N lines only")
    lg.add_argument("--index", type=int, default=0,
                    help="which WORKER's pod when given a TpuJob name")
    d = sub.add_parser("delete", help="delete a recorded TpuJob")
    d.add_argument("name")
    d.add_argument("-n", "--namespace", default="default")
    args = p.parse_args(argv)
    if args.server:
        raise NotImplementedError(
            "--server: a remote apiserver is not ported to k8s_tpu_torch "
            f"yet (ROADMAP {REST_BACKEND_ITEM})")
    return {"create": cmd_create, "validate": cmd_validate,
            "get": cmd_get, "delete": cmd_delete,
            "describe": cmd_describe, "logs": cmd_logs}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
