"""The port's elastic gang resize (``k8s_tpu_torch/resize``, the
``elastic:`` spec block, the reconciler's resize arms and the
controller's ledger hooks), held to the JAX package's, which imports no
JAX on these paths. One TPU slice maps to one GPU node: the one-chip
``cpu-1`` slice is the one-card ``h100-80gb-x1`` node, a slice's hosts
are a node's cards (one worker pod per card). Tolerance: exact equality
of every verdict, target, reason (with "slice" read as "node"), dead-host
set, trigger and restore ceiling.

- The JAX decision matrix (``tests/test_resize.py``
  ``TestElasticResizer``) runs twice: once against the port's
  ``ElasticResizer`` alone, and once through a twin that feeds every
  observation to the JAX and the port resizer on one fake clock and
  asserts their verdicts equal.
- ``TestLedgerRecharge`` and ``TestElasticSpec`` run against the port
  (a ``gpu:`` block where the JAX cases build a ``tpu:`` one); the
  spec's validation and env round trip are also compared with the JAX
  ``ElasticSpec`` case by case.
- Controller level, on the port's controller and kubelet with puppet
  pods: shrink → grow → ``Succeeded``, the budget-exhaustion failure and
  the in-place restart when capacity is intact. Every window runs on a
  fake clock that the test advances, and every wait has its own
  deadline, so no case waits out a fixed timer.
"""

import math
import threading
import time

import pytest

from k8s_tpu import spec as JS
from k8s_tpu.resize import ElasticResizer as JaxResizer
from k8s_tpu_torch import spec as PS
from k8s_tpu_torch.resize import ElasticResizer as PortResizer
from torch_port_cases import port_variant

_resize = port_variant("test_resize.py", replace={'"cpu-1"': '"h100-80gb-x1"'})


def _gpu_elastic_job_spec(num_slices=2, min_dp=1, max_dp=0,
                          accel="h100-80gb-x1", replicas=None, **elastic_kw):
    """The JAX ``elastic_job_spec`` with a ``gpu:`` block of one card per
    node where it has a ``tpu:`` block of one-host slices."""
    return PS.TpuJobSpec(
        gpu=PS.GpuSpec(accelerator=accel, num_cards=num_slices),
        replica_specs=[PS.TpuReplicaSpec(replica_type="WORKER",
                                         replicas=replicas)],
        elastic=PS.ElasticSpec(min_dp_degree=min_dp,
                               max_dp_degree=max_dp, **elastic_kw),
    )


_resize.elastic_job_spec = _gpu_elastic_job_spec


def test_the_cases_run_against_the_port():
    assert _resize.ElasticResizer is PortResizer
    assert _resize.S is PS
    assert _resize.Controller.__module__ == "k8s_tpu_torch.controller.controller"


# -- the decision matrix, on the port alone and in lockstep with JAX ------------

TestElasticResizer = _resize.TestElasticResizer
TestLedgerRecharge = _resize.TestLedgerRecharge

_twin = port_variant("test_resize.py", replace={'"cpu-1"': '"h100-80gb-x1"'})
TWIN_VERDICTS = []


def _same_verdict(j, p):
    assert p.action == j.action
    assert p.target_dp == j.target_dp
    assert p.reason == j.reason.replace("slice", "node")
    assert p.restore_ceiling == j.restore_ceiling
    assert p.dead_hosts == j.dead_hosts
    assert p.trigger == j.trigger


class _TwinResizer:
    """Both packages' resizers on one clock: every call goes to both,
    every verdict is compared, and the port's is returned."""

    def __init__(self, *args, **kwargs):
        errors = []
        for cls in (JaxResizer, PortResizer):
            try:
                cls(*args, **kwargs)
                errors.append(None)
            except ValueError as e:
                errors.append(type(e))
        assert errors[0] == errors[1]
        self.jax = JaxResizer(*args, **kwargs)
        self.port = PortResizer(*args, **kwargs)

    def note_resized(self, new_dp):
        self.jax.note_resized(new_dp)
        self.port.note_resized(new_dp)

    def observe(self, **kw):
        j, p = self.jax.observe(**kw), self.port.observe(**kw)
        _same_verdict(j, p)
        TWIN_VERDICTS.append(p.action)
        return p


_twin.ElasticResizer = _TwinResizer


class TestElasticResizerLockstep(_twin.TestElasticResizer):
    """The JAX matrix through :class:`_TwinResizer`."""


def test_lockstep_covers_every_action():
    """The matrix, replayed through the twin, reaches every action."""
    TWIN_VERDICTS.clear()
    case = TestElasticResizerLockstep()
    for name in dir(case):
        if name.startswith("test_"):
            getattr(case, name)()
    assert {"shrink", "grow", "exhausted", None} <= set(TWIN_VERDICTS)


# -- the spec ------------------------------------------------------------------


class TestElasticSpec(_resize.TestElasticSpec):
    def test_validation_matrix(self):
        """The JAX matrix, with the port's refusals of the blocks it
        lacks: elastic without a ``gpu:`` block, and with a serving
        block (which lands in ``extra``)."""
        spec = _gpu_elastic_job_spec
        for bad in (spec(min_dp=-1), spec(min_dp=3, max_dp=2),
                    spec(num_slices=1, min_dp=2, max_dp=4),
                    spec(num_slices=4, min_dp=1, max_dp=2),
                    PS.TpuJobSpec(replica_specs=[PS.TpuReplicaSpec(
                        replica_type="WORKER", replicas=1)],
                        elastic=PS.ElasticSpec())):
            bad.set_defaults()
            with pytest.raises(PS.ValidationError):
                bad.validate()
        zero = spec(min_dp=0, max_dp=0)
        zero.set_defaults()
        zero.validate()
        assert zero.elastic.min_dp_degree == 1
        serving = PS.TpuJobSpec.from_dict({
            "gpu": {"accelerator": "h100-80gb-x1"},
            "serving": {"replicas": 1},
            "replicaSpecs": [{"tpuReplicaType": "WORKER", "replicas": 1}],
            "elastic": {}})
        serving.set_defaults()
        with pytest.raises(PS.ValidationError, match="training-gang feature"):
            serving.validate()
        for bad in (PS.ElasticSpec(dead_after_seconds=-1.0),
                    PS.ElasticSpec(resize_on_permanent_loss="yes"),
                    PS.ElasticSpec(min_dp_degree=True)):
            with pytest.raises(PS.ValidationError):
                bad.validate()

    def test_worker_replicas_must_be_whole_slice_multiples(self):
        """Whole nodes: an 8-card node's elastic range [1, 2] allows 8
        or 16 workers, and a card count that is not a whole number of
        nodes is refused; without elastic the exact rule is unchanged."""
        for ok in (8, 16):
            s = _gpu_elastic_job_spec(num_slices=16, max_dp=2,
                                      accel="h100-80gb", replicas=ok)
            s.set_defaults()
            s.validate()
        for bad in (_gpu_elastic_job_spec(num_slices=16, max_dp=2,
                                          accel="h100-80gb", replicas=12),
                    _gpu_elastic_job_spec(num_slices=4, max_dp=2,
                                          accel="h100-80gb")):
            bad.set_defaults()
            with pytest.raises(PS.ValidationError):
                bad.validate()
        fixed = PS.TpuJobSpec(
            gpu=PS.GpuSpec(accelerator="h100-80gb-x1", num_cards=2),
            replica_specs=[PS.TpuReplicaSpec(replica_type="WORKER",
                                             replicas=1)])
        fixed.set_defaults()
        with pytest.raises(PS.ValidationError):
            fixed.validate()

    def test_example_yaml_elastic_block(self):
        from k8s_tpu_torch.tools.kubectl_local import load_tpu_job_yaml

        path = (_resize.__file__.rsplit("/tests/", 1)[0]
                + "/k8s_tpu_torch/examples/gpu_job_elastic.yaml")
        with open(path) as f:
            job = load_tpu_job_yaml(f.read())
        job.spec.set_defaults()
        job.spec.validate()
        el = job.spec.elastic
        assert (el.min_dp_degree, el.max_dp_degree,
                el.resize_on_permanent_loss) == (1, 2, True)
        assert job.spec.training.zero_stage == 1
        assert job.spec.num_nodes() == 2


ELASTIC_CASES = [
    {}, {"min_dp_degree": 2, "max_dp_degree": 4}, {"min_dp_degree": 0},
    {"min_dp_degree": -1}, {"min_dp_degree": 3, "max_dp_degree": 2},
    {"min_dp_degree": True}, {"max_dp_degree": 1.5},
    {"resize_on_permanent_loss": "yes"},
    {"resize_on_permanent_loss": False, "max_dp_degree": 3},
    {"dead_after_seconds": -1.0}, {"grow_hold_seconds": "x"},
    {"cooldown_seconds": 0.0},
]


@pytest.mark.parametrize("kw", ELASTIC_CASES, ids=str)
def test_elastic_spec_validates_and_round_trips_as_jax(kw):
    outcome = []
    for mod in (JS, PS):
        el = mod.ElasticSpec(**kw)
        try:
            el.validate()
            outcome.append("ok")
        except mod.ValidationError as e:
            outcome.append(str(e))
    assert outcome[0] == outcome[1]
    if outcome[0] == "ok":
        env = PS.ElasticSpec(**kw).to_env()
        assert env == JS.ElasticSpec(**kw).to_env()
        assert (PS.ElasticSpec.from_env(env).to_dict()
                == JS.ElasticSpec.from_env(env).to_dict())
        assert PS.ElasticSpec(**kw).bounds(3) == JS.ElasticSpec(**kw).bounds(3)


@pytest.mark.parametrize("nodes,lo,hi", [(2, 1, 0), (2, 1, 2), (1, 1, 3),
                                         (3, 2, 4), (1, 2, 4), (4, 1, 2)])
def test_node_bounds_are_the_slice_bounds(nodes, lo, hi):
    """The port's range check on a ``gpu:`` block of ``nodes`` one-card
    nodes decides as the JAX one on as many one-host slices."""
    outcome = []
    for mod, spec in ((JS, JS.TpuJobSpec(
            tpu=JS.TpuSpec(accelerator="cpu-1", num_slices=nodes),
            replica_specs=[JS.TpuReplicaSpec(replica_type="WORKER")],
            elastic=JS.ElasticSpec(min_dp_degree=lo, max_dp_degree=hi))),
            (PS, _gpu_elastic_job_spec(num_slices=nodes, min_dp=lo,
                                       max_dp=hi))):
        spec.set_defaults()
        try:
            spec.validate()
            outcome.append((spec.elastic.min_dp_degree,
                            spec.elastic.max_dp_degree,
                            spec.replica_specs[0].replicas))
        except mod.ValidationError:
            outcome.append("refused")
    assert outcome[0] == outcome[1]


# -- controller level: shrink → grow → Succeeded, on a fake clock ---------------


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t
        self.lock = threading.Lock()

    def __call__(self):
        with self.lock:
            return self.t

    def advance(self, d):
        with self.lock:
            self.t += d


def wait_for(fn, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = fn()
        if v:
            return v
        time.sleep(0.02)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


@pytest.fixture
def world(monkeypatch):
    """The JAX ``make_resize_world`` on the port: two one-card nodes,
    puppet pods, a kubelet with cards to hand out, and every reconciler
    on one fake clock."""
    from k8s_tpu_torch.controller import controller as ctl_mod
    from k8s_tpu_torch.runtime.kubelet import LocalKubelet
    from k8s_tpu_torch.trainer.training import TrainingJob

    clock = FakeClock()

    class FakeClockJob(TrainingJob):
        def __init__(self, *a, **kw):
            kw.setdefault("clock", clock)
            super().__init__(*a, **kw)

    monkeypatch.setattr(ctl_mod, "TrainingJob", FakeClockJob)
    ex = _resize.PuppetExecutor()
    client, jc, controller, kubelet = _resize.make_resize_world(ex)
    # the heartbeat sweep can be held off, so a case decides which path
    # sees a loss first: the obs tick or the degraded-gang pre-check
    beats = {"on": True}
    factory = controller.worker_stats_fetcher_factory

    def gated_factory(tj):
        fetch = factory(tj)
        return lambda: fetch() if beats["on"] else None

    controller.worker_stats_fetcher_factory = gated_factory
    kubelet = LocalKubelet(client, ex, cards=4)
    kubelet.start()
    controller.start()
    try:
        yield clock, ex, client, jc, controller, beats
    finally:
        controller.stop()
        kubelet.stop()


def _job(name, max_gang_restarts=4):
    j = PS.TpuJob()
    j.metadata.name = name
    j.metadata.namespace = "default"
    # fake-clock windows: the test advances past each one
    j.spec = _gpu_elastic_job_spec(
        num_slices=2, min_dp=1, max_dp=2, grow_hold_seconds=5.0,
        cooldown_seconds=3.0, dead_after_seconds=600.0)
    j.spec.max_gang_restarts = max_gang_restarts
    j.spec.scheduling = PS.SchedulingSpec(priority=0)
    return j


def _running(jc, ex, name):
    """The job's runtime id once it is RUNNING with both pods live."""
    wait_for(lambda: jc.get("default", name).status.phase
             == PS.TpuJobPhase.RUNNING, 20, f"{name} running")
    rid = jc.get("default", name).spec.runtime_id
    wait_for(lambda: ex.live_count(f"{name}-worker-{rid}-") == 2, 20,
             f"{name}'s two pods live")
    return rid


def _workers(client, prefix):
    return sorted(x.metadata.name for x in client.jobs.list("default")
                  if x.metadata.name.startswith(prefix))


def test_controller_shrink_then_grow_then_succeed(world):
    from k8s_tpu_torch.controller import metrics as M

    clock, ex, client, jc, controller, beats = world
    labels = {"job": "default:el"}
    pre = {d: M.RESIZE_TOTAL.get({**labels, "direction": d})
           for d in ("shrink", "grow")}
    jc.create(_job("el"))
    rid = _running(jc, ex, "el")
    inv = controller.scheduler.inventory
    assert inv.used("h100-80gb-x1") == 2
    # services over the whole maxDpDegree range, the elastic env on pods
    w0 = client.jobs.get("default", f"el-worker-{rid}-0")
    env = w0.spec.template.spec.containers[0].env_dict()
    assert (env["KTPU_ELASTIC_MIN_DP"], env["KTPU_ELASTIC_MAX_DP"],
            env["KTPU_ELASTIC_RESIZE"]) == ("1", "2", "1")
    assert env["GROUP_WORLD_SIZE"] == "2"

    # ---- permanent loss: a node leaves the fleet, its worker dies -----
    # (no heartbeats: the degraded-gang pre-check decides the shrink)
    beats["on"] = False
    inv.set_capacity("h100-80gb-x1", 1)
    assert ex.finish(f"el-worker-{rid}-1", 137) == 1
    job = wait_for(lambda: (lambda j: j if j.status.dp_degree == 1 else None)(
        jc.get("default", "el")), 20, "shrink to dp 1")
    assert any(c.type == "GangResized" and "DP=2 -> DP=1" in c.reason
               for c in job.status.conditions)
    wait_for(lambda: inv.used("h100-80gb-x1") == 1, 20, "ledger shrink")
    assert controller.scheduler.running_request(
        "default/el").footprint.slices == 1
    wait_for(lambda: _workers(client, f"el-worker-{rid}-")
             == [f"el-worker-{rid}-0"], 20, "one worker")
    w0 = wait_for(lambda: ex.live_count(f"el-worker-{rid}-0") == 1
                  and client.jobs.get("default", f"el-worker-{rid}-0"),
                  20, "recreated worker 0 live")
    env = w0.spec.template.spec.containers[0].env_dict()
    assert env["KTPU_NUM_PROCESSES"] == "1" and "GROUP_WORLD_SIZE" not in env
    assert client.services.get("default", f"el-worker-{rid}-1") is not None
    assert M.RESIZE_TOTAL.get({**labels, "direction": "shrink"}) \
        == pre["shrink"] + 1
    assert M.RESIZE_DP.get(labels) == 1.0

    # ---- capacity returns: the grow waits out its hold, then grows ----
    # (the obs tick's resizer decides it)
    beats["on"] = True
    tj = controller.jobs["default/el"]
    inv.set_capacity("h100-80gb-x1", 2)
    time.sleep(0.3)  # several reconcile ticks inside the cooldown
    assert tj._resizer._grow_since is None
    assert "cooldown" in tj._resizer.observe(
        dp=1, hosts=1, attainable=2).reason
    clock.advance(3.5)  # past the cooldown: the grow hold arms
    wait_for(lambda: tj._resizer._grow_since is not None, 20,
             "grow hold armed")
    time.sleep(0.3)  # several reconcile ticks inside the hold
    assert jc.get("default", "el").status.dp_degree == 1
    clock.advance(5.5)  # past the hold
    job = wait_for(lambda: (lambda j: j if j.status.dp_degree == 2 else None)(
        jc.get("default", "el")), 20, "grow to dp 2")
    assert any(c.type == "GangResized" and "DP=1 -> DP=2" in c.reason
               for c in job.status.conditions)
    wait_for(lambda: inv.used("h100-80gb-x1") == 2, 20, "ledger grow")
    wait_for(lambda: ex.live_count(f"el-worker-{rid}-") == 2, 20,
             "two live pods after the grow")
    assert M.RESIZE_TOTAL.get({**labels, "direction": "grow"}) \
        == pre["grow"] + 1
    events = [e.message for e in client.events.list("default")
              if e.reason == "GangResized"]
    assert any("DP=2 -> DP=1" in m for m in events)
    assert any("DP=1 -> DP=2" in m for m in events)

    # ---- run to completion ---------------------------------------------
    assert ex.finish(f"el-worker-{rid}-", 0) == 2
    job = controller.wait_for_job("default", "el", timeout=20)
    assert job.status.state == PS.TpuJobState.SUCCEEDED
    assert job.status.gang_restarts == 2  # both resizes budget-counted
    # no node charged twice across the cycle
    assert inv.max_used["h100-80gb-x1"] == 2
    assert inv.used("h100-80gb-x1") == 0


def test_controller_budget_exhaustion_fails_job(world):
    clock, ex, client, jc, controller, beats = world
    jc.create(_job("broke", max_gang_restarts=0))
    rid = _running(jc, ex, "broke")
    beats["on"] = False
    controller.scheduler.inventory.set_capacity("h100-80gb-x1", 1)
    assert ex.finish(f"broke-worker-{rid}-1", 137) == 1
    job = wait_for(lambda: (lambda j: j if j.status.phase in (
        PS.TpuJobPhase.DONE, PS.TpuJobPhase.FAILED) else None)(
        jc.get("default", "broke")), 20, "job failed")
    assert job.status.state == PS.TpuJobState.FAILED
    assert "resize" in (job.status.reason or "").lower()
    wait_for(lambda: controller.scheduler.inventory.used("h100-80gb-x1") == 0,
             20, "nodes freed")


def test_controller_capacity_intact_keeps_restore_in_place(world):
    clock, ex, client, jc, controller, beats = world
    jc.create(_job("crash"))
    rid = _running(jc, ex, "crash")
    assert ex.finish(f"crash-worker-{rid}-1", 137) == 1  # capacity intact
    job = wait_for(lambda: (lambda j: j if j.status.gang_restarts >= 1
                            else None)(jc.get("default", "crash")),
                   20, "gang restart")
    assert job.status.dp_degree == 0
    assert not any(c.type == "GangResized" for c in job.status.conditions)
    assert any(c.type == "GangRestart" for c in job.status.conditions)
    wait_for(lambda: ex.live_count(f"crash-worker-{rid}-") == 2, 20,
             "restarted gang live")
    assert ex.finish(f"crash-worker-{rid}-", 0) == 2
    job = controller.wait_for_job("default", "crash", timeout=20)
    assert job.status.state == PS.TpuJobState.SUCCEEDED


def test_request_priced_at_the_resized_width():
    """``_request_for`` charges a resized gang at ``status.dp_degree``
    nodes of its own cards-per-node, as the JAX ``_dp_footprint``."""
    from k8s_tpu_torch.controller.controller import _dp_footprint
    from k8s_tpu_torch.sched import Footprint, footprint_of

    j = PS.TpuJob()
    j.metadata.name, j.metadata.namespace = "w", "default"
    j.spec = _gpu_elastic_job_spec(num_slices=16, max_dp=2,
                                   accel="h100-80gb")
    j.spec.set_defaults()
    assert footprint_of(j.spec) == Footprint("h100-80gb", slices=2, chips=16)
    assert _dp_footprint(footprint_of(j.spec), 1) == Footprint(
        "h100-80gb", slices=1, chips=8)
    assert math.isclose(_dp_footprint(Footprint("h100-80gb", 2, 16), 2).chips, 16)


def test_resize_carries_the_ceiling_and_adoption_keeps_the_width():
    """One resize verdict acted on by a reconciler: the gang is torn
    down, ``status.dp_degree`` and the ``Resizing`` phase are set, the
    resize is budget-counted, the recreated gang is one node wide with
    the verdict's restore ceiling in ``KTPU_CKPT_RESTORE_MAX_STEP``; a
    fresh reconciler of the persisted job (adoption, re-admission)
    materializes the resized width, not the gpu block's."""
    from k8s_tpu_torch.api.client import KubeClient
    from k8s_tpu_torch.api.cluster import InMemoryCluster
    from k8s_tpu_torch.api.crd_client import TpuJobClient
    from k8s_tpu_torch.resize import ResizeVerdict
    from k8s_tpu_torch.trainer.training import TrainingJob

    cluster = InMemoryCluster()
    client, jc = KubeClient(cluster), TpuJobClient(cluster)
    j = _job("ceil")
    j.spec.checkpoint_policy = PS.CheckpointPolicySpec(
        local_dir="/scratch/ckpt", local_interval_steps=5)
    j = jc.create(j)
    config = PS.ControllerConfig()
    tj = TrainingJob(client, jc, j)
    tj.setup(config)
    tj.create_resources(config)
    rid = j.spec.runtime_id
    assert _workers(client, f"ceil-worker-{rid}-") == [
        f"ceil-worker-{rid}-0", f"ceil-worker-{rid}-1"]
    verdict = ResizeVerdict(action="shrink", target_dp=1, reason="node lost",
                            restore_ceiling=7, trigger="inventory")
    assert tj._act_on_resize(verdict) == "resizing"
    assert (tj.status.dp_degree, tj.status.phase, tj.status.gang_restarts) \
        == (1, PS.TpuJobPhase.RESIZING, 1)
    assert "DP=2 -> DP=1: node lost" in tj.status.conditions[-1].reason
    tj.update_crd_status()
    tj.create_resources(config)
    assert _workers(client, f"ceil-worker-{rid}-") == [f"ceil-worker-{rid}-0"]
    env = client.jobs.get("default", f"ceil-worker-{rid}-0").spec.template \
        .spec.containers[0].env_dict()
    assert env["KTPU_CKPT_RESTORE_MAX_STEP"] == "7"
    assert env["KTPU_NUM_PROCESSES"] == "1"
    # adoption: a new reconciler of the stored job keeps dp 1
    stored = jc.get("default", "ceil")
    assert stored.status.dp_degree == 1
    adopted = TrainingJob(client, jc, stored)
    adopted.setup(config)
    assert adopted.current_dp() == 1
    assert adopted._worker_set().spec.replicas == 1
    assert adopted._worker_set().rendezvous(0).num_slices == 1
