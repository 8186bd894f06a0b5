"""The port's cluster scheduler end to end on the CPU: two tiny
``llama_train`` jobs (subprocess pods of the port's launcher, gloo) of
one card each contend for a one-card fleet (``h100-80gb-x1: 1``) under
the scheduler-running controller of a ``LocalWorld`` whose kubelet has
one card. The CPU is asked for explicitly (the pods' env).

- The low-priority job trains with the local checkpoint tier every
  ``LOCAL_EVERY`` steps and an obs heartbeat, so the scheduler prices
  its eviction (steps since its last save, > 0 mid-interval).
- A high-priority job arrives: the scheduler preempts the victim. Its
  pod is SIGTERMed, the launcher's preemption exit flushes the local
  tier at the current step and exits 143, and the job parks in
  ``Queued`` with a ``Preempted`` condition naming the preemptor.
- The preemptor runs to ``Succeeded`` on the card; the victim is
  re-admitted after its cooldown, restores FROM ITS FLUSHED STEP
  (strictly newer than any periodic save), trains to the end and
  succeeds with 0 gang restarts. The inventory's high-water mark is one
  node: the card was never held twice.
"""

import json
import os
import time

from k8s_tpu_torch import spec as PS
from k8s_tpu_torch.api.objects import Container, EnvVar, PodSpec, PodTemplateSpec
from k8s_tpu_torch.ckpt import LocalTier
from k8s_tpu_torch.controller import metrics as M
from k8s_tpu_torch.tools.local_world import LocalWorld

OBS_PORT = 8790
LOCAL_EVERY = 5
VICTIM_STEPS = 14  # one periodic save (step 5): any flush is newer
DEADLINE_S = 180.0  # each wait; a loaded machine is several times slower
CPU_ENV = [("KTPU_FORCE_PLATFORM", "cpu"), ("KTPU_NUM_CPU_DEVICES", "1"),
           ("OMP_NUM_THREADS", "1")]


def _job(name, priority, steps, tmp_path, checkpoint=False, step_sleep=0.25):
    j = PS.TpuJob()
    j.metadata.name = name
    j.metadata.namespace = "default"
    j.spec.gpu = PS.GpuSpec(accelerator="h100-80gb-x1", num_cards=1)
    j.spec.scheduling = PS.SchedulingSpec(priority=priority)
    args = (f"--model=tiny --strategy=fsdp --batch_size=4 --seq_len=16 "
            f"--steps={steps} --log_every=1 --step_sleep={step_sleep}")
    j.spec.replica_specs = [PS.TpuReplicaSpec(
        replica_type="WORKER",
        template=PodTemplateSpec(spec=PodSpec(containers=[Container(
            name="jax", image="local",
            command=["python", "-m", "k8s_tpu_torch.launcher.spmd_launcher"],
            env=[EnvVar(name=k, value=v) for k, v in CPU_ENV] + [
                EnvVar(name="KTPU_PROGRAM",
                       value="k8s_tpu_torch.programs.llama_train:main"),
                EnvVar(name="KTPU_PROGRAM_ARGS", value=args)])])))]
    if checkpoint:
        j.spec.checkpoint_policy = PS.CheckpointPolicySpec(
            local_dir=str(tmp_path / f"{name}-local"),
            local_interval_steps=LOCAL_EVERY)
        j.spec.observability = PS.ObservabilitySpec(obs_port=OBS_PORT)
    return j


def _events(path, name):
    if not os.path.exists(path):
        return []
    out = []
    for line in open(path, errors="replace"):
        if line.startswith(f'{{"event": "{name}"'):
            out.append(json.loads(line))
    return out


def _wait(pred, what, logs):
    deadline = time.monotonic() + DEADLINE_S
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}:\n" + "\n".join(
        f"--- {p} ---\n{open(logs / p, errors='replace').read()[-3000:]}"
        for p in sorted(os.listdir(logs))))


def test_two_jobs_contend_preempt_flush_resume(tmp_path):
    logs = tmp_path / "logs"
    config = PS.ControllerConfig(fleet={"h100-80gb-x1": 1},
                                 scheduler_cooldown_seconds=1.0)
    pre_preempted = M.SCHED_PREEMPTED.get({"queue": "default"})
    with LocalWorld(subprocess_pods=True, log_dir=str(logs), config=config,
                    reconcile_interval=0.1, cards=1) as w:
        jc, controller = w.job_client, w.controller
        # -- the low-priority job owns the card ---------------------------------
        # 0.5 s a step: steps 6-13 leave the preemption 4 s to land
        jc.create(_job("lowpri", 0, VICTIM_STEPS, tmp_path, checkpoint=True,
                       step_sleep=0.5))
        low_tj = _wait(lambda: controller.jobs.get("default/lowpri"),
                       "lowpri admitted", logs)
        rid = _wait(lambda: jc.get("default", "lowpri").spec.runtime_id,
                    "lowpri runtime id", logs)
        low_pod = f"lowpri-worker-{rid}-0-pod-0"
        low_log = logs / f"{low_pod}.log"

        def mid_interval():
            # just past the first periodic save, with a priced eviction
            # cost off the live heartbeat
            stats = low_tj._last_worker_stats or {}
            step = max([int(h.get("step", 0) or 0) for h in stats.values()] + [0])
            assert not low_tj.finished, "lowpri finished before contention"
            return step > LOCAL_EVERY and low_tj.preemption_cost() > 0

        _wait(mid_interval, "lowpri mid-interval with a priced cost", logs)
        proc = w.kubelet.executor.procs[low_pod]

        # -- the high-priority arrival preempts ---------------------------------
        jc.create(_job("highpri", 10, 4, tmp_path))
        low = _wait(lambda: (lambda j: j if j.status.phase == PS.TpuJobPhase.QUEUED
                             else None)(jc.get("default", "lowpri")),
                    "lowpri re-queued", logs)
        cond = next(c for c in low.status.conditions if c.type == "Preempted")
        assert "default/highpri" in cond.reason
        evs = {e.reason for e in w.client.events.list("default")}
        assert {"Preempted", "Preempting", "Queued", "Admitted"} <= evs
        assert M.SCHED_PREEMPTED.get({"queue": "default"}) == pre_preempted + 1
        lost = M.SCHED_PREEMPT_LOST_STEPS.get({"job": "default/lowpri"})
        assert 0 < lost <= LOCAL_EVERY, lost
        # the launcher's own preemption exit (not a death by signal)
        assert proc.wait(timeout=DEADLINE_S) == 143
        flushes = _events(low_log, "preempt_checkpoint")
        assert _events(low_log, "preempt_requested") and flushes, open(low_log).read()
        flush_step = flushes[-1]["step"]
        assert LOCAL_EVERY < flush_step < VICTIM_STEPS, flush_step
        # the periodic save and, strictly newer, the flush
        assert LocalTier(str(tmp_path / "lowpri-local"),
                         host_id=0).committed_steps() == [LOCAL_EVERY, flush_step]

        # -- the preemptor runs on the card, then the victim resumes ------------
        high = controller.wait_for_job("default", "highpri", timeout=DEADLINE_S)
        assert high.status.state == PS.TpuJobState.SUCCEEDED, high.status.reason
        low = controller.wait_for_job("default", "lowpri", timeout=DEADLINE_S)
        assert low.status.state == PS.TpuJobState.SUCCEEDED, low.status.reason
        assert low.status.gang_restarts == 0  # preemption is policy, not a fault
        assert [c.type for c in low.status.conditions].count("Admitted") == 2
        restores = _events(low_log, "ckpt_restore")
        assert restores and restores[0]["step"] == flush_step, (restores, flush_step)
        steps = [e["step"] for e in _events(low_log, "step_phases")]
        assert steps[-1] == VICTIM_STEPS and steps.count(flush_step + 1) == 1, steps

        # -- the ledger: one node, never held twice ------------------------------
        inv = controller.scheduler.inventory
        assert inv.max_used["h100-80gb-x1"] == 1
        assert inv.used("h100-80gb-x1") == 0
    # the kubelet's device plugin got its one card back
    assert w.kubelet.devices.free() == ["0"]
