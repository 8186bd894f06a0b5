"""The port's elastic resize end to end on the CPU (the counterpart of
``tests/test_e2e_resize.py``): a 2-node gang of tiny ``llama_train``
pods (subprocesses of the port's launcher on gloo, one card each on the
one-card ``h100-80gb-x1`` nodes, the CPU asked for in the pods' env)
under the scheduler-running controller of a ``LocalWorld``. It trains
``--strategy=fsdp`` at ``training.zeroStage: 1``, so the mesh is data 2 ×
fsdp 1 with the Adam moments sliced over ``data`` (ZeRO on the HSDP
mesh), with the local checkpoint tier every ``LOCAL_EVERY`` steps on a
shared root (the peers' tiers are read from it) and an obs heartbeat.

- Permanent loss: worker 1 is SIGKILLed and its node leaves the fleet
  (``set_capacity`` 1). The operator shrinks the gang to dp 1; the lone
  worker restores from its own tier plus its peer's shards, losing no
  more than the local interval, and trains on.
- The node returns: after the grow hold the gang grows back to dp 2 and
  restores at the dp-1 incarnation's teardown flush step; the fresh
  worker 1 reads the shards it lacks from its peer's tier.
- The job ends ``Succeeded``. ``GangResized`` names both directions, the
  ``mesh`` events' ``dp`` goes 2 → 1 → 2, and the inventory's
  high-water mark equals the fleet: no node was charged twice.

Every wait has its own deadline.
"""

import json
import os
import signal
import time

from k8s_tpu_torch import spec as PS
from k8s_tpu_torch.api.objects import Container, EnvVar, PodSpec, PodTemplateSpec
from k8s_tpu_torch.obs.events import events_of
from k8s_tpu_torch.tools.local_world import LocalWorld

OBS_PORT = 8790
LOCAL_EVERY = 5  # the local checkpoint interval: the shrink's loss bound
STEPS = 30
DEADLINE_S = 120.0  # each wait; a loaded machine is several times slower
CPU_ENV = [("KTPU_FORCE_PLATFORM", "cpu"), ("KTPU_NUM_CPU_DEVICES", "1"),
           ("OMP_NUM_THREADS", "1")]


def _job(tmp_path):
    j = PS.TpuJob()
    j.metadata.name = "resz"
    j.metadata.namespace = "default"
    j.spec.max_gang_restarts = 4
    j.spec.gpu = PS.GpuSpec(accelerator="h100-80gb-x1", num_cards=2)
    j.spec.training = PS.TrainingSpec(zero_stage=1)
    j.spec.elastic = PS.ElasticSpec(
        min_dp_degree=1, max_dp_degree=2, grow_hold_seconds=0.5,
        cooldown_seconds=0.5,
        dead_after_seconds=60.0)  # the inventory trigger drives this test
    j.spec.scheduling = PS.SchedulingSpec(priority=0)
    # the local tier alone: the grown gang restores through the union of
    # the survivor's tier and its peer's, not from a durable copy
    j.spec.checkpoint_policy = PS.CheckpointPolicySpec(
        local_dir=str(tmp_path / "local"), local_interval_steps=LOCAL_EVERY)
    j.spec.observability = PS.ObservabilitySpec(obs_port=OBS_PORT)
    args = (f"--model=tiny --strategy=fsdp --batch_size=4 --seq_len=16 "
            f"--steps={STEPS} --log_every=1 --step_sleep=0.2")
    j.spec.replica_specs = [PS.TpuReplicaSpec(
        replica_type="WORKER",
        template=PodTemplateSpec(spec=PodSpec(containers=[Container(
            name="jax", image="local",
            command=["python", "-m", "k8s_tpu_torch.launcher.spmd_launcher"],
            env=[EnvVar(name=k, value=v) for k, v in CPU_ENV] + [
                EnvVar(name="KTPU_PROGRAM",
                       value="k8s_tpu_torch.programs.llama_train:main"),
                EnvVar(name="KTPU_PROGRAM_ARGS", value=args)])])))]
    return j


def _log(logs, rid, idx):
    """Every incarnation of worker ``idx``'s pod log, oldest first."""
    prefix = f"resz-worker-{rid}-{idx}-pod-"
    names = sorted((n for n in os.listdir(logs) if n.startswith(prefix)),
                   key=lambda n: int(n[len(prefix):].split(".")[0]))
    return "\n".join(open(logs / n, errors="replace").read() for n in names)


def _all_logs(logs):
    return "\n".join(f"--- {n} ---\n{open(logs / n, errors='replace').read()[-3000:]}"
                     for n in sorted(os.listdir(logs)))


def _wait(pred, what, logs):
    deadline = time.monotonic() + DEADLINE_S
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}:\n" + _all_logs(logs))


def test_permanent_loss_resize_shrink_grow_succeed(tmp_path):
    logs = tmp_path / "logs"
    config = PS.ControllerConfig(fleet={"h100-80gb-x1": 2},
                                 scheduler_cooldown_seconds=0.5)
    with LocalWorld(subprocess_pods=True, log_dir=str(logs), config=config,
                    reconcile_interval=0.2, cards=2) as w:
        jc, controller = w.job_client, w.controller
        jc.create(_job(tmp_path))
        tj = _wait(lambda: controller.jobs.get("default/resz"), "admitted", logs)
        rid = _wait(lambda: jc.get("default", "resz").spec.runtime_id,
                    "runtime id", logs)
        inv = controller.scheduler.inventory

        # -- dp 2 trains past a local save ------------------------------------
        def step_seen():
            stats = tj._last_worker_stats or {}
            return max([int(h.get("step", 0) or 0) for h in stats.values()] + [0])

        _wait(lambda: step_seen() >= LOCAL_EVERY + 3, "dp 2 past a save", logs)
        seen = step_seen()
        mesh = events_of(_log(logs, rid, 0), "mesh")
        assert mesh and mesh[0]["dp"] == 2 and mesh[0]["zero_stage"] == 1, mesh

        # -- permanent loss: worker 1 dies and its node leaves the fleet ------
        proc = w.kubelet.executor.procs[f"resz-worker-{rid}-1-pod-0"]
        os.kill(proc.pid, signal.SIGKILL)
        inv.set_capacity("h100-80gb-x1", 1)
        job = _wait(lambda: (lambda j: j if j.status.dp_degree == 1 else None)(
            jc.get("default", "resz")), "shrink to dp 1", logs)
        assert any(c.type == "GangResized" and "DP=2 -> DP=1" in c.reason
                   for c in job.status.conditions), job.status.to_dict()
        assert inv.used("h100-80gb-x1") == 1

        # the dp-1 incarnation restores from the local evidence
        restore = _wait(lambda: events_of(_log(logs, rid, 0), "ckpt_restore"),
                        "restore after the shrink", logs)[0]
        assert restore["step"] >= seen - LOCAL_EVERY - 1, (restore, seen)
        assert 0 <= restore["lost_steps"] <= LOCAL_EVERY + 2, restore
        assert restore["source"] in ("local", "local+peer"), restore
        mesh = _wait(lambda: (lambda m: m if len(m) >= 2 else None)(
            events_of(_log(logs, rid, 0), "mesh")), "dp 1 mesh", logs)
        assert mesh[1]["dp"] == 1, mesh
        target = restore["step"] + 3
        _wait(lambda: f'"step": {target}' in _log(logs, rid, 0),
              "dp 1 progress", logs)

        # -- the node returns: grow back to dp 2 ---------------------------------
        inv.set_capacity("h100-80gb-x1", 2)
        job = _wait(lambda: (lambda j: j if j.status.dp_degree == 2 else None)(
            jc.get("default", "resz")), "grow to dp 2", logs)
        assert any(c.type == "GangResized" and "DP=1 -> DP=2" in c.reason
                   for c in job.status.conditions), job.status.to_dict()

        # -- Succeeded at full width ---------------------------------------------
        job = controller.wait_for_job("default", "resz", timeout=DEADLINE_S)
        assert job.status.state == PS.TpuJobState.SUCCEEDED, (
            json.dumps(job.status.to_dict(), indent=1) + _all_logs(logs))
        log0 = _log(logs, rid, 0)
        assert f'"step": {STEPS}' in log0

        # the grow's restore point is the dp-1 teardown flush
        flushes = events_of(log0, "preempt_checkpoint")
        restores = events_of(log0, "ckpt_restore")
        assert flushes, log0
        assert restores[-1]["step"] == flushes[-1]["step"], (flushes, restores)
        # the grown worker 1 restored the same step, reading its peer's
        # shards (its own tier stopped at the kill)
        r1 = events_of(_log(logs, rid, 1), "ckpt_restore")
        assert r1 and r1[-1]["step"] == restores[-1]["step"], r1
        assert r1[-1]["peer_shards"] > 0 or r1[-1]["source"] == "local+peer", r1

        assert [e["dp"] for e in events_of(log0, "mesh")] == [2, 1, 2]
        messages = [e.message for e in w.client.events.list("default")
                    if e.reason == "GangResized"]
        assert any("DP=2 -> DP=1" in m for m in messages), messages
        assert any("DP=1 -> DP=2" in m for m in messages), messages
        assert job.status.gang_restarts == 2

        # -- the ledger: two nodes, never held twice ---------------------------
        assert inv.max_used["h100-80gb-x1"] == 2
        assert inv.used("h100-80gb-x1") == 0
    assert sorted(w.kubelet.devices.free()) == ["0", "1"]
