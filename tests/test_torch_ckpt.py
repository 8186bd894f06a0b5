"""The port's checkpoint subsystem (``k8s_tpu_torch/ckpt``,
``k8s_tpu_torch/train/checkpoint.py``) held to the JAX package's
(``k8s_tpu/ckpt``) on the same inputs, on the CPU.

- Shard geometry: ``index_key`` … ``compose_shard`` on seeded boxes give
  the JAX functions' results.
- On-disk format, both ways: a step written by the port's ``LocalTier``
  (f32, bf16, int32 and a scalar) is byte-identical, file by file, to
  the JAX tier's of the same values, and each package's ``read_shard``
  reads the other's step bit-equal with the manifest's crcs.
- The restore planner's decision table (``tests/test_ckpt_tiers.py``
  ``TestRestorePlanner``'s cases) on one on-disk root: the port's and
  the JAX planner pick the same ``(source, step)``.
- The multi-tier manager: one call sequence (interval routing, a failed
  local commit, an unhealthy step, a restart) gives both managers the
  same goodput counters and the same ``ckpt_restore`` event.
- The pipelined save: an in-place scribble after ``save()`` returns
  never reaches the disk; the staged-bytes gate holds.
- The REST shard wire, between the port's and the JAX package's peers.
- The persistent tier on DCP: round trip, retention, ``restore_params``,
  the ceiling, an interrupted save.

Equality is exact throughout: the two packages move the same bytes.
"""

import io
import json
import os
import random
import threading
import time
import zlib

import ml_dtypes
import numpy as np
import pytest
import torch

from k8s_tpu.ckpt import local as jlocal
from k8s_tpu.ckpt import manager as jmanager
from k8s_tpu.ckpt import peer as jpeer
from k8s_tpu.ckpt import planner as jplanner
from k8s_tpu_torch.ckpt import local as tlocal
from k8s_tpu_torch.ckpt import manager as tmanager
from k8s_tpu_torch.ckpt import peer as tpeer
from k8s_tpu_torch.ckpt import pipeline as tpipe
from k8s_tpu_torch.ckpt import planner as tplanner
from k8s_tpu_torch.train.checkpoint import CheckpointManager


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    jlocal.arm_partial_commit(0)
    tlocal.arm_partial_commit(0)


@pytest.fixture
def jax_writes_bf16(monkeypatch):
    """The JAX tier's save of a bfloat16 numpy leaf: its crc32_array
    takes a memoryview of the array, which numpy refuses for the
    ml_dtypes type ("cannot include dtype 'E' in a buffer"), so the JAX
    package cannot write such a leaf as it stands (its training state
    is f32). Here its crc is the spelling its own tests hold
    crc32_array to, zlib over ``tobytes()``: the same value, and every
    byte of the files is still the JAX code's."""
    monkeypatch.setattr(
        jlocal, "crc32_array",
        lambda arr: zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF)


def trees(seed: int = 0, scale: float = 1.0):
    """The same state as a numpy tree (the JAX side; bf16 through
    ml_dtypes) and a flat tensor tree (the port): an f32 matrix, a bf16
    matrix from seeded bit patterns, an int32 vector and an int64
    scalar."""
    rng = np.random.RandomState(seed)
    w = (rng.randn(3, 5) * scale).astype(np.float32)
    bits = (rng.randn(4, 6) * scale).astype(np.float32).view(np.uint32)
    b16 = (bits >> 16).astype(np.uint16)  # truncated f32: a bf16 pattern
    count = rng.randint(-1000, 1000, size=7).astype(np.int32)
    step = np.int64(rng.randint(0, 100))
    jtree = {"params/w": w, "params/h": b16.view(ml_dtypes.bfloat16),
             "opt/w/count": count, "step": step}
    ttree = {"params/w": torch.from_numpy(w.copy()),
             "params/h": torch.from_numpy(b16.view(np.int16).copy()).view(torch.bfloat16),
             "opt/w/count": torch.from_numpy(count.copy()),
             "step": torch.tensor(int(step), dtype=torch.int64)}
    return jtree, ttree


def f32_trees(scale: float):
    w = (np.arange(16, dtype=np.float32) * scale).reshape(8, 2)
    b = np.full((4,), 2.0 * scale, np.float32)
    return ({"w": w, "b": b},
            {"w": torch.from_numpy(w.copy()), "b": torch.from_numpy(b.copy())})


def t_template(ttree):
    return {k: torch.zeros_like(v) for k, v in ttree.items()}


def raw(x) -> bytes:
    """The payload bytes of an ndarray or a CPU tensor."""
    if isinstance(x, torch.Tensor):
        return tpipe.to_numpy(x.contiguous()).tobytes()
    return np.ascontiguousarray(x).tobytes()


# -- shard geometry -----------------------------------------------------------


def _random_boxes(rng, shape, n):
    boxes = []
    for _ in range(n):
        box = []
        for d in shape:
            a = rng.randint(0, d)
            b = rng.randint(a + 1, d + 1)
            box.append(slice(a, b))
        boxes.append(tuple(box))
    return boxes


def _tiles(shape, splits):
    """Keys of a regular tiling of ``shape`` into ``splits`` per dim."""
    edges = [np.linspace(0, d, s + 1).astype(int) for d, s in zip(shape, splits)]
    keys = [""]
    for e in edges:
        keys = [f"{k},{a}:{b}" if k else f"{a}:{b}"
                for k in keys for a, b in zip(e[:-1], e[1:])]
    return keys


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_geometry_matches_jax(seed):
    rng = random.Random(seed)
    shape = (rng.randint(2, 9), rng.randint(2, 9))
    for idx in _random_boxes(rng, shape, 6) + [(), (slice(None),) * 2]:
        want_shape = shape if idx else ()
        key = jlocal.index_key(idx, want_shape)
        assert tlocal.index_key(idx, want_shape) == key
        assert tlocal.parse_index_key(key) == jlocal.parse_index_key(key)
    full = tlocal.full_key(shape)
    tiles = _tiles(shape, (2, 2))
    stored_sets = [[full], tiles, tiles[:3],
                   [tlocal.index_key(b, shape) for b in _random_boxes(rng, shape, 4)]]
    wants = [full] + tiles + [tlocal.index_key(b, shape)
                              for b in _random_boxes(rng, shape, 4)]
    payload = np.arange(np.prod(shape), dtype=np.float32).reshape(shape) + seed

    def loader(store):
        def load(key):
            return payload[tlocal.parse_index_key(key)].copy() if key in store else None
        return load

    for stored in stored_sets:
        for want in wants:
            plan = tlocal.covering_plan(want, stored)
            assert plan == jlocal.covering_plan(want, stored), (want, stored)
            if plan is not None:
                got = tlocal.compose_shard(want, plan, loader(stored))
                ref = jlocal.compose_shard(want, plan, loader(stored))
                assert np.array_equal(got, ref)
                assert np.array_equal(got, payload[tlocal.parse_index_key(want)])
            by_source = [(0, stored[:2]), (1, stored[2:])]
            assert tlocal.union_covering_plan(want, by_source) == \
                jlocal.union_covering_plan(want, by_source)


# -- on-disk format, both ways ----------------------------------------------


def _files(step_dir):
    out = {}
    for dirpath, _, names in os.walk(step_dir):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, step_dir)] = f.read()
    return out


def test_local_format_is_byte_identical_both_ways(tmp_path, jax_writes_bf16):
    jtree, ttree = trees(seed=3)
    port = tlocal.LocalTier(str(tmp_path / "port"), host_id=0, sync=True)
    ref = jlocal.LocalTier(str(tmp_path / "jax"), host_id=0, sync=True)
    assert port.save(4, ttree) is True
    assert ref.save(4, jtree) is True
    got, want = _files(port.step_dir(4)), _files(ref.step_dir(4))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    man = port.manifest(4)
    assert man == ref.manifest(4)
    for path in ttree:  # the eager shard enumeration, too
        (k1, a1), = tlocal.local_shards_of(ttree[path]).items()
        (k2, a2), = jlocal.local_shards_of(jtree[path]).items()
        assert k1 == k2 and raw(a1) == raw(a2), path
    assert man["leaves"]["params/h"]["dtype"] == "bfloat16"
    assert man["leaves"]["step"]["shards"].keys() == {"-"}
    # each package reads the other's step, bit-equal, crcs as recorded
    jreader = jlocal.LocalTier(str(tmp_path / "port"), host_id=0)
    treader = tlocal.LocalTier(str(tmp_path / "jax"), host_id=0)
    for path, entry in man["leaves"].items():
        (key, shard), = entry["shards"].items()
        a = jreader.read_shard(4, path, key)
        b = treader.read_shard(4, path, key)
        assert a is not None and b is not None, path
        assert raw(a) == raw(ttree[path]) == raw(b) == raw(jtree[path]), path
        assert tpipe.crc32_array(a) == shard["crc"] == \
            zlib.crc32(raw(jtree[path])) & 0xFFFFFFFF
        back = tpipe.from_numpy(b, ttree[path].dtype)
        assert back.dtype == ttree[path].dtype and torch.equal(back, ttree[path])


def test_local_tier_commit_protocol_matches_jax(tmp_path, jax_writes_bf16):
    """Two-phase commit, partial commit invisible and GC'd, retention,
    corruption caught by the crc — the same observable steps as the
    JAX tier's under the same calls."""
    out = {}
    for name, mod in (("port", tlocal), ("jax", jlocal)):
        root = str(tmp_path / name)
        tier = mod.LocalTier(root, host_id=0, sync=True, max_to_keep=2)
        j2, t2 = trees(2)
        tree = t2 if name == "port" else j2
        steps = []
        tier.save(2, tree)
        mod.arm_partial_commit(1)
        with pytest.raises(OSError):
            tier.save(4, tree)
        steps.append((tier.committed_steps(), os.path.isdir(tier.step_dir(4) + ".pending")))
        for s in (6, 8):
            tier.save(s, tree)
        steps.append((tier.committed_steps(), os.path.isdir(tier.step_dir(4) + ".pending")))
        assert tier.save(8, tree) is False
        victim = mod.LocalTier.corrupt_one_shard(root, random.Random(0))
        bad = [(p, k) for p, e in tier.manifest(8)["leaves"].items()
               for k in e["shards"] if tier.read_shard(8, p, k) is None]
        out[name] = (steps, os.path.relpath(victim, root), bad)
    assert out["port"] == out["jax"]
    assert out["port"][0] == [([2], True), ([6, 8], False)]
    assert len(out["port"][2]) == 1


# -- the restore planner's decision table -----------------------------------


class FakePersistent:
    """The persistent tier's planning surface (latest_step/all_steps)."""

    def __init__(self, steps, with_all_steps=True):
        self._steps = sorted(steps)
        if not with_all_steps:
            self.all_steps = None

    def all_steps(self):
        return list(self._steps)

    def latest_step(self):
        return self._steps[-1] if self._steps else None

    def restore(self, template, step=None):
        return None


def _both_plans(root, jtree, ttree, host=0, persistent=(), peers=False,
                gang=False, max_step=None, consensus=None, all_steps=True):
    out = []
    for mod_local, mod_planner, tree in (
            (jlocal, jplanner, jtree), (tlocal, tplanner, ttree)):
        tier = mod_local.LocalTier(root, host_id=host)
        transport = None
        if peers:
            peer_mod = jpeer if mod_planner is jplanner else tpeer
            transport = peer_mod.FilesystemPeerTransport(root, self_host=host)
        planner = mod_planner.RestorePlanner(
            tier, FakePersistent(persistent, all_steps) if persistent is not None else None,
            transport=transport, gang_consistent=gang, max_step=max_step,
            consensus=consensus)
        tmpl = tree if mod_planner is jplanner else t_template(tree)
        plan = planner.plan(tmpl)
        out.append((plan.source, plan.step, plan.peer_fetches))
    return out


PLANNER_CASES = ["local_newer", "persistent_newer", "nothing", "uncommitted",
                 "replaced_pod_peer", "gang_consistency", "consensus_lowers",
                 "ceiling_local", "ceiling_persistent", "ceiling_no_all_steps"]


@pytest.mark.parametrize("case", PLANNER_CASES)
def test_planner_table_matches_jax(tmp_path, case):
    root = str(tmp_path)
    jtree, ttree = trees(5)
    port0 = tlocal.LocalTier(root, host_id=0, sync=True, max_to_keep=5)
    kw, want = {}, None
    if case == "local_newer":
        port0.save(10, ttree)
        kw, want = dict(persistent=[6]), ("local", 10, 0)
    elif case == "persistent_newer":
        port0.save(4, ttree)
        kw, want = dict(persistent=[8]), ("persistent", 8, 0)
    elif case == "nothing":
        kw, want = dict(persistent=[]), ("none", None, 0)
    elif case == "uncommitted":
        port0.save(6, ttree)
        tlocal.arm_partial_commit(1)
        with pytest.raises(OSError):
            port0.save(8, ttree)
        kw, want = dict(persistent=[]), ("local", 6, 0)
    elif case == "replaced_pod_peer":
        tlocal.LocalTier(root, host_id=1, sync=True).save(12, ttree)
        kw, want = dict(persistent=[], peers=True), ("local+peer", 12, len(ttree))
    elif case == "gang_consistency":
        # host 1 crashed before committing 6; with one device per
        # process every leaf is replicated, so host 0's manifest covers
        # step 6 for the whole gang and host 1 sources it from its peer
        port0.save(4, ttree)
        port0.save(6, ttree)
        tlocal.LocalTier(root, host_id=1, sync=True).save(4, ttree)
        assert _both_plans(root, jtree, ttree, host=0, persistent=[],
                           peers=True, gang=True)[0] == ("local", 6, 0)
        kw, want = dict(host=1, persistent=[], peers=True, gang=True), \
            ("local+peer", 6, len(ttree))
    elif case == "consensus_lowers":
        port0.save(8, ttree)
        port0.save(10, ttree)
        kw, want = dict(persistent=[], consensus=lambda s: min(s, 8)), ("local", 8, 0)
    elif case == "ceiling_local":
        port0.save(6, ttree)
        port0.save(10, ttree)
        kw, want = dict(persistent=[], max_step=7), ("local", 6, 0)
    elif case == "ceiling_persistent":
        kw, want = dict(persistent=[4, 12], max_step=7), ("persistent", 4, 0)
    elif case == "ceiling_no_all_steps":
        kw, want = dict(persistent=[12], max_step=7, all_steps=False), ("none", None, 0)
    jax_plan, port_plan = _both_plans(root, jtree, ttree, **kw)
    assert port_plan == jax_plan == want


def test_corrupt_own_shard_rerouted_to_peer_matches_jax(tmp_path):
    """crc failure at read time reroutes the one bad shard to a peer
    holding the same index; both planners restore the saved values."""
    root = str(tmp_path)
    jtree, ttree = f32_trees(4.0)
    for h in (0, 1):
        tlocal.LocalTier(root, host_id=h, sync=True).save(6, ttree)
    rng = random.Random(1)
    for _ in range(50):
        victim = tlocal.LocalTier.corrupt_one_shard(root, rng)
        if f"host-0{os.sep}" in victim:
            break
    results = []
    for mod_local, mod_planner, mod_peer, tmpl in (
            (jlocal, jplanner, jpeer, {k: np.zeros_like(v) for k, v in jtree.items()}),
            (tlocal, tplanner, tpeer, t_template(ttree))):
        planner = mod_planner.RestorePlanner(
            mod_local.LocalTier(root, host_id=0), FakePersistent([]),
            transport=mod_peer.FilesystemPeerTransport(root, self_host=0))
        restored, plan = planner.restore(tmpl)
        assert restored is not None
        results.append((plan.source, plan.step,
                        {k: raw(v) for k, v in restored.items()}))
    assert results[0] == results[1]
    assert results[1][2] == {k: raw(v) for k, v in ttree.items()}


def test_restore_fills_the_template_in_place(tmp_path):
    """The port's local restore copies into the template's own tensors
    (parameters and moments keep their storage), bf16 bits included."""
    _, ttree = trees(7)
    tier = tlocal.LocalTier(str(tmp_path), host_id=0, sync=True)
    tier.save(3, ttree)
    tmpl = t_template(ttree)
    ptrs = {k: v.data_ptr() for k, v in tmpl.items()}
    restored, plan = tplanner.RestorePlanner(tier, None, parallel=1).restore(tmpl)
    assert restored is tmpl and plan.source == "local"
    assert {k: v.data_ptr() for k, v in tmpl.items()} == ptrs
    assert all(torch.equal(tmpl[k], ttree[k]) for k in ttree)


def test_failed_local_restore_without_persistent_raises(tmp_path):
    """A local restore that dies after writing some leaves in place has
    no pristine template to hand back: without a persistent step to
    restore over it, the port raises rather than report a fresh start."""
    _, ttree = trees(8)
    tier = tlocal.LocalTier(str(tmp_path), host_id=0, sync=True)
    tier.save(3, ttree)
    man = tier.manifest(3)
    last = sorted(man["leaves"])[-1]  # fetched after the others
    os.remove(os.path.join(tier.step_dir(3),
                           man["leaves"][last]["shards"]["-" if last == "step"
                                                         else tlocal.full_key(ttree[last].shape)]["file"]))
    planner = tplanner.RestorePlanner(tier, None, parallel=1)
    read_shard = tier.read_shard

    def read_after_a_write(step, leaf_path, key, host_id=None):
        # the pool fetches ahead of the consumer: hold the lost leaf's
        # read until a leaf has been written, so the restore dies
        # part-way however the threads are scheduled
        deadline = time.monotonic() + 30
        while leaf_path == last and time.monotonic() < deadline and \
                not planner.last_restore_stats.get("leaves_written"):
            time.sleep(0.001)
        return read_shard(step, leaf_path, key, host_id)

    tier.read_shard = read_after_a_write
    with pytest.raises(RuntimeError, match="part-restored"):
        planner.restore(t_template(ttree))


# -- the multi-tier manager ---------------------------------------------------


TIMING_KEYS = {"save_seconds_total", "save_phases_s", "ckpt_overhead_fraction",
               "restore_seconds_total", "restore_phases_s"}


def _drive_manager(mod_manager, mod_local, root, make_tree, capsys):
    """The call sequence: local saves every 2 steps (kept 2), step 4's
    commit fails, step 6 is unhealthy, progress reaches 7; then a
    restart restores and a local-only policy polls preemption."""
    policy = mod_manager.CheckpointPolicy(local_dir=root, local_interval_steps=2)
    mgr = mod_manager.MultiTierCheckpointManager(policy, host_id=0)
    mgr.local.sync = True
    for s in range(1, 8):
        if s == 4:
            mod_local.arm_partial_commit(1)
        mgr.save(s, make_tree(s), unhealthy=(lambda: True) if s == 6 else None)
        mgr.note_step(s)
    first = {k: v for k, v in mgr.goodput().items() if k not in TIMING_KEYS}
    committed = mgr.local.committed_steps()
    mgr.close()
    mgr2 = mod_manager.MultiTierCheckpointManager(policy, host_id=0)
    restored = mgr2.restore(make_tree(0))
    second = {k: v for k, v in mgr2.goodput().items() if k not in TIMING_KEYS}
    os.environ.pop("KTPU_PREEMPT_REQUESTED", None)
    polls = [mgr2.reached_preemption(8)]
    os.environ["KTPU_PREEMPT_REQUESTED"] = "1"
    polls.append(mgr2.reached_preemption(9))
    del os.environ["KTPU_PREEMPT_REQUESTED"]
    mgr2.close()
    events = [json.loads(line) for line in capsys.readouterr().out.splitlines()
              if line.startswith('{"event"')]
    for e in events:
        if e["event"] == "ckpt_restore":
            e.pop("seconds")
            e["phases_s"] = sorted(e["phases_s"])
    return first, committed, second, polls, events, restored


def test_manager_goodput_matches_jax(tmp_path, capsys):
    def jtree(s):
        return f32_trees(float(s))[0]

    def ttree(s):
        return f32_trees(float(s))[1]

    ref = _drive_manager(jmanager, jlocal, str(tmp_path / "jax"), jtree, capsys)
    got = _drive_manager(tmanager, tlocal, str(tmp_path / "port"), ttree, capsys)
    assert got[:5] == ref[:5]
    first, committed, second, polls, events, restored = got
    assert first["local_saves"] == 1 and first["local_save_failures"] == 1
    assert committed == [2]
    assert second["restore_sources"] == {"local": 1} and second["lost_steps_last"] == 5
    assert polls == [False, True]
    assert [e["event"] for e in events] == ["ckpt_skip_unhealthy", "ckpt_restore"]
    assert {k: raw(v) for k, v in restored.items()} == \
        {k: raw(v) for k, v in ttree(2).items()}


# -- the pipelined save -------------------------------------------------------


def test_scribble_after_save_returns_is_invisible(tmp_path):
    """PyTorch updates the state in place: what save() staged before it
    returned, not the live tensors, is what reaches the disk."""
    _, ttree = trees(9)
    expect = {k: v.clone() for k, v in ttree.items()}
    tier = tlocal.LocalTier(str(tmp_path), host_id=0)
    go = threading.Event()
    write_leaf = tier._write_leaf

    def held_write_leaf(*a, **kw):
        go.wait(timeout=10)
        return write_leaf(*a, **kw)

    tier._write_leaf = held_write_leaf
    assert tier.save(3, ttree) is True
    for t in ttree.values():
        t.fill_(-7)  # the next step, in place
    go.set()
    tier.wait()
    man = tier.manifest(3)
    for path, entry in man["leaves"].items():
        (key,) = entry["shards"]
        arr = tier.read_shard(3, path, key)
        assert raw(arr) == raw(expect[path]), path
    assert tier.last_save_stats["bytes"] == sum(
        v.numel() * v.element_size() for v in expect.values())


def test_staged_bytes_gate_bounds_host_ram(tmp_path):
    leaves = {f"l{i}": torch.arange(1024, dtype=torch.float32) + i for i in range(8)}
    cap = 2 * 4096 + 64
    tier = tlocal.LocalTier(str(tmp_path), host_id=0, sync=True, parallel=4,
                            buffer_bytes=cap)
    assert tier.save(2, leaves) is True
    assert tier.last_save_stats["peak_staged_bytes"] <= cap
    assert tier.last_save_stats["gate_waits"] > 0
    free = tlocal.LocalTier(str(tmp_path / "u"), host_id=0, sync=True,
                            parallel=4, buffer_bytes=0)
    assert free.save(2, leaves) is True
    assert free.last_save_stats["peak_staged_bytes"] > cap
    for path, t in leaves.items():
        assert raw(tier.read_shard(2, path, tlocal.full_key(t.shape))) == raw(t)


# -- the REST shard wire -------------------------------------------------------


def test_rest_wire_between_port_and_jax_peers(tmp_path, jax_writes_bf16):
    jtree, ttree = trees(11)
    port_tier = tlocal.LocalTier(str(tmp_path / "p"), host_id=0, sync=True)
    port_tier.save(4, ttree)
    port_tier.note_progress(5)
    jax_tier = jlocal.LocalTier(str(tmp_path / "j"), host_id=0, sync=True)
    jax_tier.save(4, jtree)
    jax_tier.note_progress(5)
    servers = [tpeer.PeerShardServer(port_tier).start(),
               jpeer.PeerShardServer(jax_tier).start()]
    try:
        for srv in servers:
            for transport in (tpeer.RestPeerTransport({0: srv.url}, self_host=1),
                              jpeer.RestPeerTransport({0: srv.url}, self_host=1)):
                assert transport.steps() == {0: [4]}
                assert transport.progress() == 5
                man = transport.manifest(4, 0)
                assert man == port_tier.manifest(4)
                for path, entry in man["leaves"].items():
                    (key,) = entry["shards"]
                    arr = transport.fetch(4, path, key, 0)
                    assert raw(arr) == raw(ttree[path]), path
                assert transport.manifest(99, 0) is None
                assert transport.fetch(4, "params/w", "9:9", 0) is None
    finally:
        for srv in servers:
            srv.stop()
    dead = tpeer.RestPeerTransport({0: "http://127.0.0.1:1"}, self_host=1, timeout=0.5)
    assert dead.steps() == {} and dead.fetch(1, "w", "0:1", 0) is None


# -- the persistent tier (DCP) --------------------------------------------------


def test_dcp_round_trip_retention_ceiling(tmp_path):
    _, ttree = trees(12)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in (2, 4, 6):
        scaled = {k: (v * s if v.is_floating_point() else v + s) for k, v in ttree.items()}
        assert mgr.save(s, scaled) is True
    assert mgr.save(6, ttree) is False  # committed already
    assert mgr.all_steps() == [4, 6] and mgr.latest_step() == 6
    tmpl = t_template(ttree)
    assert mgr.restore(tmpl) is tmpl
    assert all(torch.equal(tmpl[k], (v * 6 if v.is_floating_point() else v + 6))
               for k, v in ttree.items())
    bounded = CheckpointManager(str(tmp_path), max_restore_step=5)
    assert bounded.latest_step() == 4
    bounded.restore(tmpl)
    assert torch.equal(tmpl["params/w"], ttree["params/w"] * 4)
    # an interrupted save (no .metadata) is invisible and rewritten
    os.makedirs(tmp_path / "8")
    assert mgr.all_steps() == [4, 6]
    assert CheckpointManager(str(tmp_path / "empty")).restore(tmpl) is None
    # the interval gate and the unhealthy gate
    every3 = CheckpointManager(str(tmp_path / "i"), save_interval_steps=3)
    assert every3.save(4, ttree) is False and every3.save(6, ttree) is True
    assert every3.save(7, ttree, force=True) is True
    assert every3.save(9, ttree, unhealthy=lambda: True) is False
    assert every3.all_steps() == [6, 7]


def test_dcp_save_retries_injected_faults(tmp_path, monkeypatch):
    """A failed save attempt is retried through the backoff policy
    (arm_save_faults), and a persistent fault surfaces after the last
    attempt."""
    from k8s_tpu_torch.train import checkpoint as tckpt

    monkeypatch.setattr(tckpt, "SAVE_RETRY_POLICY",
                        tckpt.BackoffPolicy(base=0.0, cap=0.0, jitter=0.0))
    _, ttree = trees(14)
    mgr = CheckpointManager(str(tmp_path))
    tckpt.arm_save_faults(2)
    try:
        assert mgr.save(1, ttree) is True
        tckpt.arm_save_faults(tckpt.SAVE_RETRY_ATTEMPTS)
        with pytest.raises(OSError, match="injected"):
            mgr.save(2, ttree)
    finally:
        tckpt.arm_save_faults(0)
    assert mgr.all_steps() == [1]


def test_manager_routes_persistent_saves_through_the_committer(tmp_path):
    """Routed persistent saves hand a staged host copy to the committer
    thread (an in-place update right after never reaches DCP); a force
    save writes both tiers; the restore of a later process prefers the
    persistent tier at an equal step."""
    _, ttree = trees(15)
    policy = tmanager.CheckpointPolicy(
        local_dir=str(tmp_path / "l"), local_interval_steps=3,
        persistent_dir=str(tmp_path / "p"), persistent_interval_steps=2)
    mgr = tmanager.MultiTierCheckpointManager(policy, host_id=0)
    mgr.local.sync = True
    expect = {k: v.clone() for k, v in ttree.items()}
    assert mgr.save(2, ttree) is True  # staged, committed in the background
    for t in ttree.values():
        t.add_(1)
    mgr.wait()
    tmpl = t_template(ttree)
    assert mgr.persistent.restore(tmpl, step=2) is tmpl
    assert all(torch.equal(tmpl[k], expect[k]) for k in expect)
    assert mgr.save(5, ttree, force=True) is True
    mgr.close()
    g = mgr.goodput()
    assert (g["persistent_saves"], g["local_saves"], g["last_saved_step"]) == (2, 1, 5)
    again = tmanager.MultiTierCheckpointManager(policy, host_id=0)
    tmpl = t_template(ttree)
    assert again.restore(tmpl) is tmpl
    assert again.last_restore_plan.source == "persistent"
    assert again.last_restore_plan.step == 5
    assert all(torch.equal(tmpl[k], ttree[k]) for k in ttree)
    again.close()
    assert tpipe.stage_tree(ttree)["params/h"].dtype == torch.bfloat16


def test_dcp_restore_params_reads_only_params_into_bf16(tmp_path):
    """restore_params loads the params/ leaves into the template's
    tensors and dtype (an f32 checkpoint into bf16: the copy rounds,
    as .to(bfloat16) does) and never needs the optimizer leaves."""
    rng = np.random.RandomState(13)
    state = {"step": torch.tensor(3),
             "params/a": torch.from_numpy(rng.randn(4, 8).astype(np.float32)),
             "params/b.weight": torch.from_numpy(rng.randn(8).astype(np.float32)),
             "opt/a/exp_avg": torch.from_numpy(rng.randn(4, 8).astype(np.float32))}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state)
    tmpl = {"a": torch.empty(4, 8, dtype=torch.bfloat16),
            "b.weight": torch.empty(8, dtype=torch.bfloat16)}
    assert mgr.restore_params(tmpl) is tmpl
    assert torch.equal(tmpl["a"], state["params/a"].to(torch.bfloat16))
    assert torch.equal(tmpl["b.weight"], state["params/b.weight"].to(torch.bfloat16))
    assert CheckpointManager(str(tmp_path / "none")).restore_params(tmpl) is None
    with pytest.raises(RuntimeError, match="params/missing"):
        mgr.restore_params({"missing": torch.empty(2)})


def test_crc32_and_npy_vocabulary():
    """crc32_array equals zlib's over the bytes (a bf16 tensor's words
    included) and the npy writer reproduces numpy's file for a
    ml_dtypes bf16 array."""
    bits = np.arange(10, dtype=np.uint16) * 977
    j = bits.view(ml_dtypes.bfloat16)
    t = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    a = tpipe.to_numpy(t)
    assert tpipe.crc32_array(a) == zlib.crc32(j.tobytes()) & 0xFFFFFFFF
    f1, f2 = io.BytesIO(), io.BytesIO()
    np.save(f1, j)
    tlocal._write_npy(f2, a)
    assert f1.getvalue() == f2.getvalue()
    assert tpipe.dtype_name(torch.bfloat16) == str(j.dtype) == "bfloat16"
    assert tpipe.est_leaf_bytes((3, 4), torch.bfloat16) == 24
