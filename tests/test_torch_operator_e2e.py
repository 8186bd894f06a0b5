"""The port's operator end to end on the CPU: a ``LocalWorld`` with
subprocess pods runs ``k8s_tpu_torch/examples/gpu_job_cpu_tiny.yaml`` —
two WORKER pods of ``python -m k8s_tpu_torch.launcher.spmd_launcher``,
``llama_train`` on the tiny model over gloo for 4 steps.

- The job ends ``Succeeded`` with no gang restart, and each pod ran its
  4 steps.
- A worker's process SIGTERMed after its first step exits 143 (the
  launcher's preemption exit); that retryable exit restarts the whole
  gang, and the job ends ``Succeeded`` with one gang restart.

The CPU is asked for explicitly (the world's ``extra_env`` and the
manifest's env); the world itself forces no platform. Every wait has its
own deadline.
"""

import json
import os
import pathlib
import signal
import time

import pytest
import yaml

from k8s_tpu_torch import spec as PS
from k8s_tpu_torch.tools.local_world import LocalWorld

REPO = pathlib.Path(__file__).resolve().parent.parent
MANIFEST = REPO / "k8s_tpu_torch" / "examples" / "gpu_job_cpu_tiny.yaml"
JOB_DEADLINE_S = 60.0
STEP_DEADLINE_S = 30.0
CPU_ENV = {"KTPU_FORCE_PLATFORM": "cpu", "KTPU_NUM_CPU_DEVICES": "1",
           "OMP_NUM_THREADS": "1"}


def _job(name, extra_args=""):
    doc = yaml.safe_load(MANIFEST.read_text())
    doc["metadata"]["name"] = name
    c = doc["spec"]["replicaSpecs"][0]["template"]["spec"]["containers"][0]
    for e in c["env"]:
        if e["name"] == "KTPU_PROGRAM_ARGS":
            e["value"] = f"{e['value']} {extra_args}".strip()
    return PS.TpuJob.from_dict(doc)


def _steps(log_path):
    if not os.path.exists(log_path):
        return []
    out = []
    for line in open(log_path, errors="replace"):
        if line.startswith('{"event": "step_phases"'):
            out.append(json.loads(line)["step"])
    return out


@pytest.fixture
def world(tmp_path):
    w = LocalWorld(subprocess_pods=True, log_dir=str(tmp_path),
                   extra_env=CPU_ENV, reconcile_interval=0.05)
    with w:
        yield w, tmp_path


def test_two_cpu_workers_run_llama_train_to_succeeded(world):
    w, logs = world
    job = w.api.create(_job("e2e-ok"))
    final = w.api.wait_for_job("default", "e2e-ok", timeout=JOB_DEADLINE_S,
                               polling_interval=0.1)
    assert final.status.state == PS.TpuJobState.SUCCEEDED, final.status.reason
    assert final.status.gang_restarts == 0
    rid = final.spec.runtime_id
    # the lead (process 0) prints the program's events
    lead = logs / f"e2e-ok-worker-{rid}-0-pod-0.log"
    assert _steps(lead) == [1, 2, 3, 4], lead.read_text()[-2000:]
    # ... and the K1-K3 launch counts (none on the CPU)
    assert 'kernel launches {"steps": 4, "flash_fwd": 0' in lead.read_text()
    for i in range(2):
        pod = w.client.pods.get("default", f"e2e-ok-worker-{rid}-{i}-pod-0")
        assert pod.status.phase == "Succeeded"
        assert pod.status.container_statuses[0].state.terminated.exit_code == 0
        assert "Traceback" not in (logs / f"{pod.metadata.name}.log").read_text()
    assert job.metadata.name == "e2e-ok"


def test_sigterm_after_first_step_restarts_the_gang_once(world):
    w, logs = world
    w.api.create(_job("e2e-term", "--step_sleep=0.5"))
    deadline = time.monotonic() + STEP_DEADLINE_S
    pod = None
    while time.monotonic() < deadline:
        job = w.api.get("default", "e2e-term")
        rid = job.spec.runtime_id
        if rid:
            pod = f"e2e-term-worker-{rid}-0-pod-0"  # the lead
            if _steps(logs / f"{pod}.log"):
                break
        time.sleep(0.05)
    else:
        raise AssertionError("the lead never finished its first step")
    proc = w.kubelet.executor.procs[pod]
    proc.send_signal(signal.SIGTERM)
    final = w.api.wait_for_job("default", "e2e-term", timeout=JOB_DEADLINE_S,
                               polling_interval=0.1)
    assert proc.wait(timeout=STEP_DEADLINE_S) == 143
    assert final.status.state == PS.TpuJobState.SUCCEEDED, final.status.reason
    assert final.status.gang_restarts == 1
    assert [c.type for c in final.status.conditions].count("GangRestart") == 1
    assert "preempt_requested" in (logs / f"{pod}.log").read_text()
    # the restarted gang (the same pod names, new batch Jobs) ran its 4
    # steps into the same log
    steps = _steps(logs / f"{pod}.log")
    assert steps[-4:] == [1, 2, 3, 4] and len(steps) > 4, steps
