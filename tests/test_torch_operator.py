"""The port's operator state machine and device plugin
(``k8s_tpu_torch/trainer/training.py``, ``controller/``,
``runtime/kubelet.py``), held to the JAX package's control plane.

- State machine: the port's and the JAX ``LocalWorld`` with a
  ``SimulatedExecutor`` give the same sequence of phases, states,
  conditions (type and reason) and gang restarts, the same final replica
  statuses and the same deleted objects, for four runs — success, a
  permanent exit, a retryable exit within ``maxGangRestarts`` and one
  beyond it. Exact equality.
- Setup refuses a program the port does not have, with its ROADMAP item.
- Device plugin: the kubelet hands out disjoint ``CUDA_VISIBLE_DEVICES``
  from a fake card list, keeps a pod that asks for more cards than are
  free ``Pending`` until they are released (and one that asks for more
  than the node has forever), gives a pod without a card request an
  empty ``CUDA_VISIBLE_DEVICES``, and sets no CPU env unless asked.
- Local mode's tools: ``kubectl_local`` creates a job and its read verbs
  show what it recorded; ``python -m k8s_tpu_torch.operator --local``
  starts and exits 0 on SIGTERM.
"""

import pathlib
import re
import signal
import threading
import time

import pytest

from k8s_tpu.runtime.kubelet import SimulatedExecutor as JSimulated
from k8s_tpu.tools.local_world import LocalWorld as JWorld
from k8s_tpu import spec as JS
from k8s_tpu_torch import spec as PS
from k8s_tpu_torch.api.client import KubeClient
from k8s_tpu_torch.api.objects import (Container, Job, JobSpec, ObjectMeta,
                                       PodSpec, PodTemplateSpec,
                                       ResourceRequirements)
from k8s_tpu_torch.runtime.kubelet import (CARDS_ANNOTATION, LocalKubelet,
                                           node_cards)
from k8s_tpu_torch.runtime.kubelet import SimulatedExecutor as PSimulated
from k8s_tpu_torch.runtime.kubelet import SubprocessExecutor
from k8s_tpu_torch.tools.local_world import LocalWorld as PWorld

DEADLINE_S = 20.0
POD_S = 0.3  # every simulated pod runs this long
# ... and the peer of a failing worker this much longer, so that every
# terminal verdict sees it still running (the runs are deterministic)
PEER_EXTRA_S = 1.2


def _job_doc(name, max_restarts):
    return {
        "apiVersion": "tpu.k8s.io/v1alpha1", "kind": "TpuJob",
        "metadata": {"name": name, "namespace": "default"},
        "spec": {
            "RuntimeId": "rt01",
            "maxGangRestarts": max_restarts,
            "replicaSpecs": [{
                "tpuReplicaType": "WORKER", "replicas": 2,
                "template": {"spec": {"containers": [
                    {"name": "jax", "image": "img", "command": ["true"]}]}},
            }],
        },
    }


def _script(kind):
    """Exit code per pod: attempts are counted per batch Job across the
    gang's incarnations (a gang restart recreates the same names)."""
    attempts = {}
    lock = threading.Lock()

    def fn(pod):
        base = pod.metadata.name.rsplit("-pod-", 1)[0]
        with lock:
            attempts[base] = attempts.get(base, 0) + 1
            n = attempts[base]
        worker0 = base.endswith("-worker-rt01-0")
        if kind == "success":
            return 0
        if not worker0:
            time.sleep(PEER_EXTRA_S)
            return 0
        if kind == "permanent":
            return 1
        if kind == "retryable_within":
            return 137 if n == 1 else 0
        return 137  # retryable_beyond: every attempt
    return fn


RUNS = {
    "success": 1,
    "permanent": 1,
    "retryable_within": 2,
    "retryable_beyond": 1,
}


def _run(world_cls, executor_cls, spec_mod, kind):
    """Create the job, wait for its end, delete it, wait for the GC; the
    recorded status sequence and deletions."""
    world = world_cls(executor=executor_cls(fn=_script(kind), delay=POD_S),
                      reconcile_interval=0.02)
    seq, deleted = [], []

    def hook(ev):
        if ev.kind == "TpuJob" and ev.type in ("ADDED", "MODIFIED"):
            st = ev.object.get("status") or {}
            rec = (st.get("phase", ""), st.get("state", ""),
                   st.get("gangRestarts", 0),
                   tuple((c.get("type"), c.get("reason", ""))
                         for c in st.get("conditions", [])))
            if not seq or seq[-1] != rec:
                seq.append(rec)
        elif ev.type == "DELETED":
            deleted.append((ev.kind, ev.name))

    world.cluster.hooks.append(hook)
    with world:
        job = spec_mod.TpuJob.from_dict(_job_doc(f"sm-{kind.replace('_', '-')}",
                                                 RUNS[kind]))
        world.api.create(job)
        final = world.api.wait_for_job("default", job.metadata.name,
                                       timeout=DEADLINE_S, polling_interval=0.02)
        replica_statuses = final.to_dict()["status"].get("replicaStatuses")
        world.api.delete("default", job.metadata.name)
        deadline = time.monotonic() + DEADLINE_S
        while time.monotonic() < deadline and (
                world.client.jobs.list("default")
                or world.client.services.list("default")):
            time.sleep(0.02)
        assert not world.client.jobs.list("default")
    return seq, sorted(deleted), replica_statuses


@pytest.mark.parametrize("kind", sorted(RUNS))
def test_state_machine_matches_the_jax_local_world(kind):
    jax = _run(JWorld, JSimulated, JS, kind)
    port = _run(PWorld, PSimulated, PS, kind)
    assert port == jax
    seq, deleted, _ = port
    phases = [(p, s) for p, s, _, _ in seq]
    final_phase, final_state, restarts, conditions = seq[-1]
    assert ("Running", "Running") in phases
    want = {"success": ("Succeeded", 0), "permanent": ("Failed", 0),
            "retryable_within": ("Succeeded", 1),
            "retryable_beyond": ("Failed", 1)}[kind]
    assert (final_phase, final_state, restarts) == ("Done",) + want
    assert [t for t, _ in conditions].count("GangRestart") == want[1]
    # a gang restart deletes both workers' batch Jobs once more than the
    # final GC does
    jobs_deleted = [n for k, n in deleted if k == "Job"]
    assert len(jobs_deleted) == 2 * (1 + want[1])


def test_setup_fails_a_program_the_port_does_not_have():
    with PWorld(executor=PSimulated(exit_code=0), reconcile_interval=0.02) as w:
        doc = _job_doc("unported", 1)
        c = doc["spec"]["replicaSpecs"][0]["template"]["spec"]["containers"][0]
        c["env"] = [{"name": "KTPU_PROGRAM",
                     "value": "k8s_tpu.programs.mnist_train:main"}]
        w.api.create(PS.TpuJob.from_dict(doc))
        final = w.api.wait_for_job("default", "unported", timeout=DEADLINE_S,
                                   polling_interval=0.02)
    assert final.status.phase == PS.TpuJobPhase.FAILED
    assert "k8s_tpu_torch.programs.mnist_train" in final.status.reason
    assert "ROADMAP A9" in final.status.reason
    assert not w.client.jobs.list("default")  # nothing was materialized


# -- the device plugin ---------------------------------------------------------


class _Holding:
    """Executor that records each pod's env and holds the pod until
    released."""

    def __init__(self):
        self.env = {}
        self.release = {}
        self.lock = threading.Lock()

    def execute(self, pod, env, stop):
        name = pod.metadata.name.rsplit("-pod-", 1)[0]
        ev = threading.Event()
        with self.lock:
            self.env[name] = dict(env)
            self.release[name] = ev
        while not (ev.is_set() or stop.is_set()):
            time.sleep(0.01)
        return 0

    def wait_started(self, name, timeout=DEADLINE_S):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self.lock:
                if name in self.env:
                    return self.env[name]
            time.sleep(0.01)
        raise AssertionError(f"{name} never started")


def _batch_job(name, cards):
    res = (ResourceRequirements(limits={PS.GPU_RESOURCE: cards},
                                requests={PS.GPU_RESOURCE: cards})
           if cards else None)
    return Job(metadata=ObjectMeta(name=name, namespace="default"),
               spec=JobSpec(template=PodTemplateSpec(spec=PodSpec(containers=[
                   Container(name="jax", image="img", command=["true"],
                             resources=res)]))))


def _pod_phase(client, job_name):
    pods = [p for p in client.pods.list("default")
            if p.metadata.name.startswith(job_name + "-pod-")]
    return pods[0].status.phase if pods else None


def _wait(pred, timeout=DEADLINE_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError("condition not reached")


def test_device_plugin_assigns_disjoint_cards_and_keeps_pods_pending():
    client = KubeClient()
    ex = _Holding()
    kubelet = LocalKubelet(client, ex, cards=["0", "1", "2"])
    kubelet.start()
    try:
        client.jobs.create(_batch_job("a", 1))
        client.jobs.create(_batch_job("b", 1))
        env_a, env_b = ex.wait_started("a"), ex.wait_started("b")
        got = {env_a["CUDA_VISIBLE_DEVICES"], env_b["CUDA_VISIBLE_DEVICES"]}
        assert len(got) == 2 and got <= {"0", "1", "2"}
        # 2 cards wanted, 1 free: Pending with no container status
        client.jobs.create(_batch_job("c", 2))
        _wait(lambda: _pod_phase(client, "c") == "Pending")
        time.sleep(0.2)
        assert "c" not in ex.env and _pod_phase(client, "c") == "Pending"
        pod_c = client.pods.get("default", "c-pod-0")
        assert pod_c.status.container_statuses == []
        # more than the node has: Pending for good
        client.jobs.create(_batch_job("d", 4))
        _wait(lambda: _pod_phase(client, "d") == "Pending")
        # no card asked: none visible, and runs at once
        client.jobs.create(_batch_job("e", 0))
        assert ex.wait_started("e")["CUDA_VISIBLE_DEVICES"] == ""
        # a's card comes back: c runs on the two free cards
        ex.release["a"].set()
        env_c = ex.wait_started("c")
        cards_c = env_c["CUDA_VISIBLE_DEVICES"].split(",")
        assert len(cards_c) == 2
        assert not set(cards_c) & {env_b["CUDA_VISIBLE_DEVICES"]}
        _wait(lambda: _pod_phase(client, "c") == "Running")
        pod_c = client.pods.get("default", "c-pod-0")
        assert pod_c.metadata.annotations[CARDS_ANNOTATION] == env_c["CUDA_VISIBLE_DEVICES"]
        assert _pod_phase(client, "d") == "Pending" and "d" not in ex.env
        # the kubelet forces no platform
        for env in ex.env.values():
            assert "KTPU_FORCE_PLATFORM" not in env
    finally:
        kubelet.stop()
    assert "d" not in ex.env  # stopped while pending: never ran


def test_node_cards_and_the_platform_env():
    assert node_cards({"CUDA_VISIBLE_DEVICES": "2, 3"}) == ["2", "3"]
    assert node_cards({"CUDA_VISIBLE_DEVICES": ""}) == []
    # subprocess pods get the caller's env only when asked
    assert PWorld(subprocess_pods=True).kubelet.executor.extra_env == {}
    cpu = {"KTPU_FORCE_PLATFORM": "cpu"}
    w = PWorld(subprocess_pods=True, extra_env=cpu)
    assert isinstance(w.kubelet.executor, SubprocessExecutor)
    assert w.kubelet.executor.extra_env == cpu


# -- the command-line tools in local mode ----------------------------------------


def test_kubectl_local_verbs_read_what_create_recorded(tmp_path, capsys):
    from k8s_tpu_torch.tools import kubectl_local

    state = str(tmp_path / "state")
    manifest = str(pathlib.Path(__file__).resolve().parent.parent
                   / "k8s_tpu_torch" / "examples" / "gpu_job_cpu_tiny.yaml")
    run = lambda *argv: kubectl_local.main(["--state-dir", state, *argv])
    assert run("create", "-f", manifest, "--simulate", "--timeout", "20") == 0
    out = capsys.readouterr().out
    assert "final: phase=Done state=Succeeded" in out
    assert run("get") == 0
    assert re.search(r"llama-tiny-cpu\s+Done\s+Succeeded\s+0", capsys.readouterr().out)
    assert run("describe", "tpujobs", "llama-tiny-cpu") == 0
    out = capsys.readouterr().out
    assert "State:      Succeeded" in out and "-worker-" in out and "Finished" in out
    # simulated pods write no log
    assert run("logs", "llama-tiny-cpu") == 1
    assert run("delete", "llama-tiny-cpu") == 0
    assert run("get", "llama-tiny-cpu") == 1


def test_operator_local_mode_starts_and_stops_on_sigterm():
    import subprocess
    import sys

    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_tpu_torch.operator", "--local",
         "--health-port", "-1"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + DEADLINE_S
        lines = []
        while time.monotonic() < deadline:
            lines.append(proc.stdout.readline())
            if "running (local mode)" in lines[-1]:
                break
        else:
            raise AssertionError(f"operator never started: {lines}")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=DEADLINE_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
