"""The port's cluster scheduler (``k8s_tpu_torch/sched``, the controller's
queue and preemption paths), held to the JAX package's, which imports
no JAX. A TPU slice maps to one GPU node with the same chip count (its
chips to that node's cards); tolerance: exact equality of verdicts.

- The JAX package's decision matrix (``tests/test_sched.py``: the
  ledger, the decision table, the 100-job scale run; and
  ``tests/test_placement.py``: the placement scorer, the named-node
  ledger, backfill, the shrink race) runs unchanged against the port's
  ``sched`` modules, on a fake clock.
- The same seeded streams of submits, ticks, finishes, capacity changes
  and clock steps drive both schedulers, the port's with each TPU pool
  renamed to a GPU pool of as many cards per node: every tick admits,
  preempts (victim and cost), reserves, backfills and blocks (by
  category) alike, with equal ledgers and high-water marks, under
  ``fifo-reserve``, ``backfill`` and ``backfill+pack``, quotas and
  cooldowns; a ``StarvationError`` would have to come at the same tick.
- The JAX controller-integration cases (queued gating, the preempt
  flow, deleting a queued victim, 100 jobs under a quota) run against
  the port's controller, with the one-card ``h100-80gb-x1`` node for
  the one-chip ``cpu-1`` slice and a ``gpu:`` block for the ``tpu:``
  one.
- Footprints of ``gpu:`` blocks are ``GpuTopology.nodes(numCards)``
  whole nodes at their cards; the fleet config refuses TPU keys.
"""

import numpy as np
import pytest

from k8s_tpu import sched as jax_sched
from k8s_tpu_torch import sched as port_sched
from k8s_tpu_torch import spec as PS
from k8s_tpu_torch.spec import topology as ptopo
from torch_port_cases import port_variant

# -- the JAX decision matrix, on the port's scheduler --------------------------

_dec = port_variant("test_sched.py", only=("k8s_tpu.sched",))
TestSliceInventory = _dec.TestSliceInventory
TestDecisionTable = _dec.TestDecisionTable
TestSchedulerScale100 = _dec.TestSchedulerScale100

# the port names a block under one leaf switch where JAX names an ICI block
_placement = port_variant("test_placement.py", only=("k8s_tpu.sched",),
                          replace={'"ici-contiguous"': '"one-switch"'})
TestPlanPlacement = _placement.TestPlanPlacement
TestInventoryPlacement = _placement.TestInventoryPlacement
TestBackfill = _placement.TestBackfill
TestShrinkRace = _placement.TestShrinkRace

# -- the JAX controller cases, on the port's controller ------------------------

_ctl = port_variant("test_sched.py", replace={'"cpu-1"': '"h100-80gb-x1"'})


def _gpu_sched_job(name, priority=0, queue="default", preemptible=True,
                   accel="h100-80gb-x1"):
    """The JAX ``sched_job`` with a one-card ``gpu:`` block where it has
    a one-chip ``tpu:`` block."""
    j = PS.TpuJob()
    j.metadata.name = name
    j.metadata.namespace = "default"
    j.spec.gpu = PS.GpuSpec(accelerator=accel, num_cards=1)
    j.spec.replica_specs = [PS.TpuReplicaSpec(replica_type="WORKER", replicas=None)]
    j.spec.scheduling = PS.SchedulingSpec(
        priority=priority, queue=queue, preemptible=preemptible)
    return j


_jax_make_sched_world = _ctl.make_sched_world


def _make_sched_world(*args, **kwargs):
    """The JAX ``make_sched_world`` with a kubelet that hands out 16
    cards (the device plugin; a pod of ``nvidia.com/gpu: 1`` waits
    Pending on a node without one)."""
    from k8s_tpu_torch.runtime.kubelet import LocalKubelet

    client, jc, controller, kubelet = _jax_make_sched_world(*args, **kwargs)
    return client, jc, controller, LocalKubelet(client, kubelet.executor, cards=16)


_ctl.sched_job = _gpu_sched_job
_ctl.make_sched_world = _make_sched_world
TestControllerScheduling = _ctl.TestControllerScheduling


def test_the_cases_run_against_the_port():
    assert _dec.ClusterScheduler is port_sched.ClusterScheduler
    assert _placement.SliceInventory is port_sched.SliceInventory
    assert _ctl.Controller.__module__ == "k8s_tpu_torch.controller.controller"
    assert _ctl.S is PS


# -- the same streams through both schedulers ----------------------------------

# TPU pool -> (GPU pool standing for it, chips per slice = cards per node)
NODE_FOR_SLICE = {"v4-8": ("h100-80gb-x4", 4), "v5e-16": ("h100-80gb-x16", 16),
                  "cpu-1": ("h100-80gb-x1", 1), "v4-16": ("h100-80gb", 8)}
_POOLS = sorted(NODE_FOR_SLICE)


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _stream(seed, n_ops=240):
    """A seeded stream of scheduler operations over the TPU pools."""
    rng = np.random.default_rng(seed)
    ops, live = [], 0
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.35:
            pool = _POOLS[int(rng.integers(len(_POOLS)))]
            ops.append(("submit", f"ns/j{live:03d}", int(rng.integers(0, 4)) * 3,
                        ["default", "batch", "prod"][int(rng.integers(3))], pool,
                        int(rng.integers(1, 4)), bool(rng.random() < 0.8),
                        float(rng.choice([0.0, 20.0, 60.0, 200.0]))))
            live += 1
        elif r < 0.65:
            ops.append(("tick",))
        elif r < 0.8:
            ops.append(("finish", int(rng.integers(0, 1 << 30))))
        elif r < 0.9:
            ops.append(("advance", float(rng.choice([0.5, 3.0, 15.0, 60.0]))))
        else:
            pool = _POOLS[int(rng.integers(len(_POOLS)))]
            ops.append(("capacity", pool, int(rng.integers(2, 9))))
    return ops


def _run(m, names, ops, policy, seed):
    """Drive scheduler module ``m`` (pools named by ``names``) through
    ``ops``; the trace of every verdict, in the TPU pools' names."""
    back = {names(p): p for p in _POOLS}
    cap = {names(p): 6 for p in _POOLS}
    topology = ({names("v5e-16"): m.PoolTopology(2, 3)}
                if policy == "backfill+pack" else {})
    clock = FakeClock()
    costs = np.random.default_rng(seed + 1).integers(0, 50, size=4096)
    sched = m.ClusterScheduler(
        m.SliceInventory(cap, topology=topology, packing=policy == "backfill+pack"),
        quotas={"batch": 40}, clock=clock,
        cost_fn=lambda k: int(costs[int(k.split("j")[1])]),
        preemption_cooldown=5.0, backfill=policy != "fifo-reserve")
    chips = {p: NODE_FOR_SLICE[p][1] for p in _POOLS}
    trace = []
    for op in ops:
        if op[0] == "submit":
            _, key, prio, queue, pool, slices, preemptible, est = op
            sched.submit(m.JobRequest(
                key=key, priority=prio, queue=queue, preemptible=preemptible,
                runtime_estimate_s=est,
                footprint=m.Footprint(names(pool), slices, slices * chips[pool])))
        elif op[0] == "tick":
            try:
                r = sched.tick()
            except m.StarvationError as e:
                trace.append(("starvation", str(e)))
                break
            trace.append((
                [a.key for a in r.admitted],
                [(p.victim, p.preemptor, p.cost) for p in r.preempted],
                sorted(r.blocked_category.items()),
                list(r.backfilled),
                {back[a]: sched.inventory.used(a) for a in cap},
                sorted(sched.queue_used_chips().items()),
                sorted((k, a.positions, a.contiguous) for k, a in (
                    (k, sched.inventory.assignment(k)) for k in sched.running_keys())
                    if a is not None)))
        elif op[0] == "finish":
            running = sorted(sched.running_keys())
            if running:
                sched.remove(running[op[1] % len(running)])
        elif op[0] == "advance":
            clock.t += op[1]
        else:
            sched.inventory.set_capacity(names(op[1]), op[2])
    trace.append({back[a]: sched.inventory.max_used.get(a, 0) for a in cap})
    return trace


@pytest.mark.parametrize("policy", ["fifo-reserve", "backfill", "backfill+pack"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_streams_give_the_same_verdicts(policy, seed):
    ops = _stream(seed)
    want = _run(jax_sched, lambda p: p, ops, policy, seed)
    got = _run(port_sched, lambda p: NODE_FOR_SLICE[p][0], ops, policy, seed)
    assert got == want
    ticks = [t for t in want if isinstance(t, tuple) and len(t) == 7]
    # the streams reach the rules: admissions, preemptions, blocks by
    # capacity, cooldown and quota, and the policy's own
    assert sum(len(t[0]) for t in ticks) > 40
    assert any(t[1] for t in ticks)
    cats = {c for t in ticks for _, c in t[2]}
    assert {"capacity", "cooldown", "quota"} <= cats
    if policy == "fifo-reserve":
        assert "reservation" in cats
    else:
        assert "backfill-refused" in cats and any(t[3] for t in ticks)
    assert any(t[6] for t in ticks) == (policy == "backfill+pack")


# -- footprints and the fleet config --------------------------------------------


@pytest.mark.parametrize("accel", sorted(ptopo.KNOWN_ACCELERATORS))
def test_gpu_footprint_is_whole_nodes(accel):
    t = ptopo.lookup(accel)
    for cards in range(1, 25):
        spec = PS.TpuJobSpec(gpu=PS.GpuSpec(accelerator=accel, num_cards=cards))
        fp = port_sched.footprint_of(spec)
        assert (fp.accelerator, fp.slices, fp.chips) == (
            accel, t.nodes(cards), t.nodes(cards) * t.cards_per_node)
        assert not fp.per_replica and not fp.empty
    # a job of fewer cards than a node charges that node, as a whole
    assert port_sched.footprint_of(PS.TpuJobSpec(
        gpu=PS.GpuSpec(accelerator="h100-80gb", num_cards=3))).chips == 8
    assert port_sched.footprint_of(PS.TpuJobSpec()).empty
    assert port_sched.footprint_of(PS.TpuJobSpec(
        gpu=PS.GpuSpec(accelerator="v5e-8", num_cards=8))).empty


def test_fleet_config_counts_gpu_nodes():
    c = PS.ControllerConfig.from_yaml(
        "fleet:\n  h100-80gb-x1: 1\n  h100-80gb: {leafSwitches: 2, nodesPerSwitch: 4}\n"
        "schedulerPolicy: backfill+pack\nschedulerQuotas: {research: 32}\n"
        "schedulerCooldownSeconds: 2.5\n")
    assert c.fleet == {"h100-80gb-x1": 1, "h100-80gb": 8}
    assert c.fleet_topology == {"h100-80gb": (2, 4)}
    assert (c.scheduler_policy, c.scheduler_quotas, c.scheduler_cooldown_seconds) == \
        ("backfill+pack", {"research": 32}, 2.5)
    for bad, word in (("fleet: {v5e-8: 2}", "h100-80gb"),
                      ("fleet: {h100-80gb: {pods: 2, slicesPerPod: 4}}", "leafSwitches"),
                      ("fleet: {h100-80gb: {leafSwitches: 0, nodesPerSwitch: 4}}",
                       "positive"),
                      ("schedulerPolicy: lifo", "fifo-reserve")):
        with pytest.raises(ValueError, match=word):
            PS.ControllerConfig.from_yaml(bad)


def test_example_fleet_config_drives_the_scheduler():
    import pathlib

    from k8s_tpu_torch.api.client import KubeClient
    from k8s_tpu_torch.api.crd_client import TpuJobClient
    from k8s_tpu_torch.controller.controller import Controller

    path = (pathlib.Path(__file__).resolve().parent.parent / "k8s_tpu_torch"
            / "examples" / "controller_config_gpu_fleet.yaml")
    config = PS.ControllerConfig.from_yaml(path.read_text())
    cl = KubeClient()
    c = Controller(cl, TpuJobClient(cl.cluster), config)
    inv = c.scheduler.inventory
    assert inv.capacity("h100-80gb-x1") == 1 and inv.capacity("h100-80gb") == 8
    assert inv.topology("h100-80gb") == port_sched.PoolTopology(2, 4)
    assert c.scheduler.backfill
