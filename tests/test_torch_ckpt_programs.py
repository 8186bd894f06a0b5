"""The checkpoint slice through the port's programs, on the CPU.

- ``llama_train`` (tiny) with the local tier, the SIGTERM flag raised
  after step 5, then restarted: exit 143 with ``preempt_checkpoint`` at
  step 5; the restart restores step 5 from ``local`` with 0 lost steps,
  bit-equal to the state the flush saved, its ``restore_crc`` readback
  equal to the manifest's crcs; it trains on to the end. The JAX
  ``llama_train`` needs a flax with ``flax.linen.spmd._axis_rules``,
  which not every installation has, so its side is the JAX package's
  checkpoint code driven in the JAX program's order
  (``build_checkpoint_manager``, restore, ``maybe_preempt_exit``, routed
  save, ``note_step``, final save) under the same env and fault on a
  numpy state; both print the same events with the same values, and
  the keys match the JAX sources' event literals.
- Two gloo processes: the same preemption verdict at the same step
  (``all_reduce(MAX)``), and a consensus restore step (``all_reduce(MIN)``).
- ``llama_generate --checkpoint_dir`` serves the trained weights: the
  same tokens as the in-memory model; an empty directory raises.
- ``gpu``: the pinned, event-synchronised snapshot of CUDA tensors
  (skips without a card).

JAX is imported inside the tests that compare with it, so the ``gpu``
test runs without it (``--noconftest`` on the card).
"""

import ast
import json
import os
import pathlib
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from k8s_tpu_torch.ckpt import local as tlocal
from k8s_tpu_torch.ckpt.pipeline import crc32_array, to_numpy
from k8s_tpu_torch.train import state_tree

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY = "--device=cpu --model=tiny --batch_size=2 --seq_len=16 --log_every=1 --data=learnable"
STEPS, PREEMPT_AFTER = 8, 5
CKPT_ENV = ("KTPU_CKPT_LOCAL_DIR", "KTPU_CKPT_LOCAL_EVERY", "KTPU_CKPT_LOCAL_KEEP",
            "KTPU_CKPT_DIR", "KTPU_CKPT_PERSIST_EVERY", "KTPU_PREEMPT_REQUESTED",
            "KTPU_PREEMPT_AWARE", "KTPU_CKPT_PEERS", "KTPU_CKPT_PEER_PORT")


def _events(out: str):
    return [json.loads(line) for line in out.splitlines() if line.startswith('{"event"')]


def _set_env(monkeypatch, root):
    for key in CKPT_ENV:
        monkeypatch.delenv(key, raising=False)
    # set (not aware, as unset), so that the undo unsets what the
    # programs' mark_preempt_aware sets
    monkeypatch.setenv("KTPU_PREEMPT_AWARE", "0")
    monkeypatch.setenv("KTPU_CKPT_LOCAL_DIR", str(root))
    monkeypatch.setenv("KTPU_CKPT_LOCAL_EVERY", "2")
    monkeypatch.setenv("KTPU_CKPT_LOCAL_KEEP", "1")


def _flag_after(monkeypatch, common, n: int):
    """The launcher's SIGTERM flag, raised once ``n`` steps completed:
    the per-step poll reads it through ``preempt_requested``."""
    polls = {"n": 0}

    def flag():
        polls["n"] += 1
        return polls["n"] >= n

    monkeypatch.setattr(common, "preempt_requested", flag)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's run: preempted after step 5, then restarted."""
    from k8s_tpu_torch.ckpt import manager as tmanager
    from k8s_tpu_torch.programs import common, llama_train

    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("port-local")
    flushed = {}
    try:
        _set_env(mp, root)
        _flag_after(mp, common, PREEMPT_AFTER)
        save = tmanager.MultiTierCheckpointManager.save

        def recording_save(self, step, state, force=False, unhealthy=None):
            if force:  # the flush: what the state held when it was saved
                flushed.update({k: v.clone() for k, v in state.items()})
            return save(self, step, state, force=force, unhealthy=unhealthy)

        mp.setattr(tmanager.MultiTierCheckpointManager, "save", recording_save)
        out1, code = _capture(lambda: llama_train.main(types.SimpleNamespace(
            process_id=0, num_processes=1,
            program_args=f"{TINY} --steps={STEPS}")))
        mp.undo()
        _set_env(mp, root)
        tier = tlocal.LocalTier(str(root), host_id=0)
        committed = tier.committed_steps()
        manifest = tier.manifest(PREEMPT_AFTER)
        out2, summary = _capture(lambda: llama_train.main(types.SimpleNamespace(
            process_id=0, num_processes=1,
            program_args=f"{TINY} --steps={PREEMPT_AFTER} --restore_crc=1")))
        restored = {k: v.clone() for k, v in state_tree(summary["state"]).items()}
        out3, final = _capture(lambda: llama_train.main(types.SimpleNamespace(
            process_id=0, num_processes=1,
            program_args=f"{TINY} --steps={STEPS}")))
    finally:
        mp.undo()
    return {"exit": code, "out1": out1, "flushed": flushed, "manifest": manifest,
            "committed": committed,
            "out2": out2, "summary": summary, "restored": restored,
            "out3": out3, "final": final, "root": root}


def _capture(fn):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            res = fn()
        except SystemExit as e:
            res = e.code
    return buf.getvalue(), res


def test_preempted_train_flushes_at_the_current_step_and_exits_143(port_run):
    assert port_run["exit"] == 143
    ev = _events(port_run["out1"])
    assert [e for e in ev if e["event"] == "preempt_checkpoint"] == [
        {"event": "preempt_checkpoint", "step": PREEMPT_AFTER}]
    # the exit leaves from inside step 5's span: its step_phases line,
    # printed after the span, never comes
    assert [e["step"] for e in ev if e["event"] == "step_phases"] == \
        list(range(1, PREEMPT_AFTER))
    # local saves at 2 and 4 (one kept), then the flush at 5
    assert port_run["committed"] == [PREEMPT_AFTER]


def test_restart_restores_the_flushed_state_bit_equal(port_run):
    ev = _events(port_run["out2"])
    (rest,) = [e for e in ev if e["event"] == "ckpt_restore"]
    assert (rest["step"], rest["source"], rest["lost_steps"],
            rest["peer_shards"]) == (PREEMPT_AFTER, "local", 0, 0)
    assert [e for e in ev if e["event"] == "restored"] == [
        {"event": "restored", "step": PREEMPT_AFTER}]
    flushed, restored = port_run["flushed"], port_run["restored"]
    assert set(flushed) == set(restored) and len(flushed) > 3
    for key in flushed:
        assert restored[key].dtype == flushed[key].dtype, key
        assert torch.equal(restored[key], flushed[key]), key
    # the crc of every leaf as read back equals the manifest's
    (crc,) = [e for e in ev if e["event"] == "restore_crc"]
    man = port_run["manifest"]["leaves"]
    assert crc["crc"] == {p: next(iter(e["shards"].values()))["crc"]
                          for p, e in man.items()}
    # and then it trains on to the end, with no step replayed
    ev3 = _events(port_run["out3"])
    assert [e["step"] for e in ev3 if e["event"] == "step_phases"] == \
        list(range(PREEMPT_AFTER + 1, STEPS + 1))
    conv = [e for e in ev3 if e["event"] == "convergence"]
    assert len(conv) == 1
    assert port_run["final"]["state"].step == STEPS


def _jax_run(root, monkeypatch):
    """The JAX package's checkpoint code in the JAX llama_train's order,
    on a numpy state of the tiny model's leaves, under the same env and
    the same fault."""
    from k8s_tpu.programs import common as jcommon

    _set_env(monkeypatch, root)
    rdzv = types.SimpleNamespace(process_id=0, num_processes=1, program_args="")

    def run(steps, flag_after):
        polls = {"n": 0}

        def flag():
            polls["n"] += 1
            return polls["n"] >= flag_after

        monkeypatch.setattr(jcommon, "preempt_requested", flag)
        cfg = jcommon.parse_run_config(rdzv, {"steps": steps})
        mgr, _ = jcommon.build_checkpoint_manager(cfg, rdzv)
        state = {"step": np.int64(0), "params/w": np.zeros(4, np.float32)}
        restored = mgr.restore(state)
        if restored is not None:
            state = restored
            print(json.dumps({"event": "restored", "step": int(state["step"])}))
        start = int(state["step"])
        for step in range(start + 1, steps + 1):
            state = {"step": np.int64(step),
                     "params/w": state["params/w"] + np.float32(1)}
            jcommon.maybe_preempt_exit(mgr, rdzv, step, state)
            mgr.save(step, state)
            mgr.note_step(step)
        mgr.save(steps, state, force=True)
        mgr.wait()
        print(json.dumps({"event": "ckpt_goodput", **mgr.goodput()}))
        mgr.close()

    out1, code = _capture(lambda: run(STEPS, PREEMPT_AFTER))
    out2, _ = _capture(lambda: run(STEPS, 10 ** 9))
    return code, _events(out1), _events(out2)


CKPT_EVENTS = ("preempt_checkpoint", "ckpt_restore", "restored", "ckpt_goodput")


def _jax_source_event_keys():
    out = {}
    for rel in ("k8s_tpu/programs/llama_train.py", "k8s_tpu/programs/common.py",
                "k8s_tpu/ckpt/manager.py"):
        for node in ast.walk(ast.parse((REPO / rel).read_text())):
            if not isinstance(node, ast.Dict):
                continue
            consts = {k.value: v for k, v in zip(node.keys, node.values)
                      if isinstance(k, ast.Constant)}
            name = consts.get("event")
            if isinstance(name, ast.Constant):
                out.setdefault(name.value, set()).update(set(consts) - {"event"})
    return out


def test_checkpoint_events_match_the_jax_package(port_run, tmp_path, monkeypatch):
    code, jev1, jev2 = _jax_run(tmp_path, monkeypatch)
    assert code == port_run["exit"] == 143
    pev1 = _events(port_run["out1"])
    pev2 = _events(port_run["out2"]) + _events(port_run["out3"])

    def pick(events, name):
        return [e for e in events if e["event"] == name]

    assert pick(pev1, "preempt_checkpoint") == pick(jev1, "preempt_checkpoint")
    keep = ("event", "step", "source", "peer_shards", "lost_steps")
    (jrest,), prest = pick(jev2, "ckpt_restore"), pick(pev2, "ckpt_restore")[0]
    assert {k: prest[k] for k in keep} == {k: jrest[k] for k in keep}
    assert set(prest) == set(jrest) and set(prest["phases_s"]) == set(jrest["phases_s"])
    assert pick(pev2, "restored")[0] == pick(jev2, "restored")[0]
    jgood, pgood = pick(jev2, "ckpt_goodput")[0], pick(pev2, "ckpt_goodput")[0]
    assert set(pgood) == set(jgood)
    for k in ("restores", "restore_sources", "lost_steps_total", "lost_steps_last"):
        assert pgood[k] == jgood[k], k
    src = _jax_source_event_keys()
    for name in CKPT_EVENTS:
        port_keys = set().union(*(set(e) - {"event"}
                                  for e in pick(pev1 + pev2, name)))
        assert src[name] <= port_keys, name


# -- two processes over gloo --------------------------------------------------


GLOO_CHILD = r"""
import json, os, sys, types
import torch, torch.distributed as dist
rank, port, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
from k8s_tpu_torch.ckpt import LocalTier
from k8s_tpu_torch.programs.common import RunConfig, build_checkpoint_manager
rdzv = types.SimpleNamespace(process_id=rank, num_processes=2)
tree = lambda s: {"step": torch.tensor(s), "w": torch.full((4,), float(s))}
# separate node-local disks, no peer fetch: rank 0 committed 4 and 6,
# rank 1 only 4 (it crashed before 6)
own = os.path.join(root, f"node{rank}")
for s in ([4, 6] if rank == 0 else [4]):
    LocalTier(own, host_id=rank, sync=True).save(s, tree(s))
os.environ.update(KTPU_CKPT_LOCAL_DIR=own, KTPU_CKPT_LOCAL_EVERY="2",
                  KTPU_CKPT_PEER_FETCH="0", KTPU_CKPT_DIR=os.path.join(root, "persist"))
mgr, _ = build_checkpoint_manager(RunConfig(), rdzv)
restored = mgr.restore(tree(0))
verdicts = []
for step in range(1, 5):
    if rank == 1 and step == 3:
        os.environ["KTPU_PREEMPT_REQUESTED"] = "1"
    verdicts.append(mgr.reached_preemption(step))
mgr.save(8, tree(8), force=True)  # both local commits meet at the barrier
mgr.close()
print(json.dumps({"rank": rank, "restored_step": int(restored["step"]),
                  "w": restored["w"].tolist(), "verdicts": verdicts,
                  "source": mgr.last_restore_plan.source,
                  "local_steps": mgr.local.committed_steps()}))
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_agree_on_preemption_and_restore_step(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("KTPU_")}
    env["PYTHONPATH"] = str(REPO)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", GLOO_CHILD, str(r), port,
                               str(tmp_path)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for res in outs:
        # rank 0 planned 6, rank 1 could only plan 4: the MIN consensus
        # lands both on 4
        assert res["restored_step"] == 4 and res["w"] == [4.0] * 4
        assert res["source"] == "local"
        # rank 1's flag at step 3 is every rank's verdict at step 3
        assert res["verdicts"] == [False, False, True, True]
    assert outs[0]["local_steps"][-1] == outs[1]["local_steps"][-1] == 8
    # only process 0 writes the persistent tier
    assert sorted(os.listdir(tmp_path / "persist")) == ["8"]


# -- serving the trained weights ----------------------------------------------


def test_generate_serves_the_trained_params(tmp_path, monkeypatch, capsys):
    from k8s_tpu_torch.models import LlamaForCausalLM, generate
    from k8s_tpu_torch.programs import llama_generate, llama_train, serving

    for key in CKPT_ENV:
        monkeypatch.delenv(key, raising=False)
    # set, so that the test's end unsets what mark_preempt_aware sets
    monkeypatch.setenv("KTPU_PREEMPT_AWARE", "0")
    summary = llama_train.main(types.SimpleNamespace(
        process_id=0, program_args=f"{TINY} --steps=4 --checkpoint_dir={tmp_path}"))
    capsys.readouterr()
    assert sorted(os.listdir(tmp_path)) == ["4"]
    lcfg = llama_generate.decode_model_config("tiny", 32, {})
    restored = llama_generate.load_decode_params(lcfg, str(tmp_path), device="cpu")
    ref = LlamaForCausalLM(lcfg, device="cpu")
    ref.load_params({name: p.detach().to(torch.bfloat16)
                     for name, p in summary["state"].model.named_parameters()})
    for name, p in ref.named_parameters():
        assert torch.equal(dict(restored.named_parameters())[name], p), name
    prompt = torch.randint(0, lcfg.vocab_size, (2, 6),
                           generator=torch.Generator().manual_seed(3))
    assert torch.equal(generate(restored, prompt, 8), generate(ref, prompt, 8))
    # the program: one round from the checkpoint
    llama_generate.main(types.SimpleNamespace(program_args=(
        f"--device=cpu --checkpoint_dir={tmp_path} --batch_size=2 "
        "--prompt_len=5 --new_tokens=3 --steps=1")))
    (line,) = [json.loads(x) for x in capsys.readouterr().out.splitlines()
               if x.startswith("{")]
    assert line["step"] == 1 and line["tokens_per_sec"] > 0
    # the int8 layout quantizes the restored weights
    q8 = llama_generate.load_decode_params(lcfg, str(tmp_path), device="cpu",
                                           quant="int8_serving")
    assert q8.config.quant == "int8_serving"
    empty = tmp_path / "empty"
    empty.mkdir()
    for bad in (empty, tmp_path / "missing"):
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            llama_generate.load_decode_params(lcfg, str(bad), device="cpu")
    # the server reports that it serves restored weights
    monkeypatch.setenv("KTPU_PREEMPT_REQUESTED", "1")
    monkeypatch.setenv("KTPU_PREEMPT_AWARE", "0")
    serving.main(types.SimpleNamespace(program_args=(
        f"--device=cpu --max_seq_len=64 --max_slots=2 --host=127.0.0.1 "
        f"--checkpoint_dir={tmp_path}")))
    ready = [e for e in _events(capsys.readouterr().out) if e["event"] == "serving_ready"]
    assert ready and ready[0]["restored"] is True


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned snapshot path runs only on one")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_snapshot_is_pinned_and_scribble_proof(cuda, tmp_path):
    """A CUDA state saved by the local tier: every copy has landed when
    save() returns (an in-place update right after never reaches the
    disk), the staging buffers are page-locked and reused by the next
    save, and a restore fills the CUDA template bit-equal."""
    from k8s_tpu_torch.ckpt import RestorePlanner
    from k8s_tpu_torch.ckpt.pipeline import stage_tree

    g = torch.Generator(device=cuda).manual_seed(0)
    tree = {"params/w": torch.randn(1024, 1024, generator=g, device=cuda),
            "params/h": torch.randn(512, 256, generator=g, device=cuda).to(torch.bfloat16),
            "step": torch.tensor(3)}
    expect = {k: v.cpu().clone() for k, v in tree.items()}
    tier = tlocal.LocalTier(str(tmp_path), host_id=0, max_to_keep=3)
    try:
        assert tier.save(3, tree) is True
        for t in tree.values():
            t.fill_(-7)  # the next step, in place, on the device
        tier.wait()
        for path, t in expect.items():
            arr = tier.read_shard(3, path, tlocal.full_key(t.shape))
            assert crc32_array(arr) == crc32_array(to_numpy(t)), path
        pinned = tier.buffers.allocated_bytes
        assert pinned == sum(v.numel() * v.element_size() for k, v in expect.items()
                             if k != "step")
        assert tier.save(4, tree) is True
        tier.wait()
        assert tier.buffers.allocated_bytes == pinned  # reused
        tmpl = {k: torch.zeros_like(v) for k, v in tree.items()}
        restored, plan = RestorePlanner(tier, None).restore(tmpl)
        assert plan.step == 4 and restored["params/w"].device.type == "cuda"
        assert all(torch.equal(restored[k].cpu(), tree[k].cpu()) for k in tree)
        staged = stage_tree(tree)
        assert all(v.device.type == "cpu" for v in staged.values())
        assert staged["params/w"].is_pinned()
        assert all(torch.equal(staged[k], tree[k].cpu()) for k in tree)
    finally:
        tier.close()
