"""The port's SPMD launcher and program runtime
(``k8s_tpu_torch/launcher/spmd_launcher.py``, the runtime of
``programs/llama_train.py``), held to the JAX launcher.

- Parity, in process: every attribute of the port's ``Rendezvous``
  equals the JAX one's over env dicts with malformed values, and
  ``is_retryable_error`` gives the JAX verdict on every marker and on
  user errors; the torch classes that mean a peer or the store went
  away are retryable, a CUDA OOM or an unported option permanent.
- The launcher module imports only the stdlib and torch at its top
  (the operator mounts it into images from a ConfigMap).
- Subprocess runs of ``python -m k8s_tpu_torch.launcher.spmd_launcher``
  on the CPU, each under its own timeout: the 2-process gloo mesh
  check, tiny ``llama_train`` with an obs endpoint, SIGTERM mid-run
  (exit 143 and a flight dump), a user error (1), an unreachable
  coordinator (143), and no ``KTPU_FORCE_PLATFORM`` on a card-less
  machine (1: no CPU fallback).
- The events ``llama_train`` prints carry the JAX program's names and
  keys. The JAX program needs a flax with
  ``flax.linen.spmd._axis_rules``, which not every installation has, so
  the schema is pinned below from the JAX sources, and a walk of those
  sources' ``{"event": ...}`` dict literals checks the pin.
"""

import ast
import json
import os
import pathlib
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
import torch
import torch.distributed as dist

from k8s_tpu.launcher import spmd_launcher as jax_launcher
from k8s_tpu.obs.health import HEALTH_KEYS
from k8s_tpu_torch.launcher import spmd_launcher as launcher
from k8s_tpu_torch.obs.events import events_of, parse_events

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY_ARGS = "--model=tiny --batch_size=2 --seq_len=16 --log_every=1"


# -- Rendezvous and exit-code parity ----------------------------------------

RDZV_ENVS = {
    "empty": {},
    "full": {
        "KTPU_COORDINATOR_ADDRESS": "job-worker-0.job:8476",
        "KTPU_PROCESS_ID": "3", "KTPU_NUM_PROCESSES": "4",
        "KTPU_REPLICA_TYPE": "worker", "KTPU_TASK_INDEX": "3",
        "MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "1",
        "KTPU_CLUSTER_SPEC": '{"worker": ["a:1", "b:1"]}',
        "KTPU_PROGRAM": "k8s_tpu_torch.programs.llama_train:main",
        "KTPU_PROGRAM_ARGS": "--model=tiny --steps=4",
        "KTPU_INIT_TIMEOUT": "12.5",
        "KTPU_CKPT_LOCAL_DIR": "/ckpt/local", "KTPU_CKPT_DIR": "gs://b/ckpt",
        "KTPU_CKPT_PEERS": "a:9000,b:9000", "KTPU_CKPT_PEER_PORT": "9000",
        "KTPU_ZERO_STAGE": "3", "KTPU_ZERO3_MIN_LEAF_SIZE": "4096",
        "KTPU_ZERO3_LEAVES": "embed,lm_head,", "KTPU_LATENCY_HIDING": "true",
        "KTPU_COMPILE_CACHE_DIR": "/cache", "KTPU_TRACE_ID": "job-abc",
        "KTPU_OBS_ADVERTISE": "job-worker-3.job:9400",
        "KTPU_FLIGHT_DIR": "/flight", "KTPU_FORCE_PLATFORM": "cpu",
    },
    "malformed_zero_stage_with_zero1": {"KTPU_ZERO_STAGE": "two",
                                        "KTPU_ZERO1": "1"},
    "zero_stage_out_of_range": {"KTPU_ZERO_STAGE": "7"},
    "garbage_cluster_spec": {"KTPU_CLUSTER_SPEC": "{not json"},
    "control_replica": {"KTPU_PROCESS_ID": "-1", "KTPU_REPLICA_TYPE":
                        "coordinator", "KTPU_PROGRAM": "x:y"},
    "garbage_ports_and_sizes": {"KTPU_CKPT_PEER_PORT": "nine",
                                "KTPU_ZERO3_MIN_LEAF_SIZE": "big",
                                "KTPU_ZERO1": "true"},
    "tpu_platform": {"KTPU_FORCE_PLATFORM": "tpu"},
}


@pytest.mark.parametrize("case", sorted(RDZV_ENVS))
def test_rendezvous_matches_jax(case):
    env = RDZV_ENVS[case]
    ours, ref = launcher.Rendezvous(env), jax_launcher.Rendezvous(env)
    mine = vars(ours).copy()
    device = mine.pop("device")
    assert mine == vars(ref)
    assert (ours.is_distributed, ours.is_control_replica) == \
        (ref.is_distributed, ref.is_control_replica)
    assert device == ("cpu" if env.get("KTPU_FORCE_PLATFORM") == "cpu"
                      else "cuda")


MARKER_MESSAGES = [f"RPC failed: {m} while waiting" for m in
                   jax_launcher._RETRYABLE_MARKERS]
USER_ERRORS = [
    ValueError("shape mismatch: (2, 3) vs (3, 2)"),
    AssertionError("loss went up"),
    KeyError("lm_head"),
    RuntimeError("peer review of the timeout setting failed"),
    TypeError("unsupported operand"),
    ZeroDivisionError("division by zero"),
]


@pytest.mark.parametrize(
    "exc", [RuntimeError(m) for m in MARKER_MESSAGES]
    + [ConnectionError("reset"), ConnectionResetError("peer"),
       ConnectionRefusedError("refused"), TimeoutError("slow"),
       BrokenPipeError("pipe")] + USER_ERRORS,
    ids=lambda e: f"{type(e).__name__}:{str(e)[:40]}")
def test_retryable_classification_matches_jax(exc):
    assert launcher._RETRYABLE_MARKERS == jax_launcher._RETRYABLE_MARKERS
    assert launcher.is_retryable_error(exc) == \
        jax_launcher.is_retryable_error(exc)


def test_torch_peer_and_store_errors_retryable():
    """A lost peer or store surfaces in torch as DistNetworkError or
    DistStoreError, with messages that carry no JAX marker: retryable by
    class. The JAX launcher would call them permanent."""
    for cls in (dist.DistNetworkError, dist.DistStoreError):
        e = cls("The client socket has timed out after 2000ms while "
                "trying to connect to (10.0.0.1, 8476).")
        assert launcher.is_retryable_error(e)
        assert not jax_launcher.is_retryable_error(e)


@pytest.mark.parametrize("exc", [
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    NotImplementedError("strategy='fsdp' is not ported to k8s_tpu_torch yet"),
], ids=["cuda_oom", "illegal_address", "unported_option"])
def test_device_and_unported_errors_permanent(exc):
    assert not launcher.is_retryable_error(exc)


def test_launcher_imports_only_stdlib_and_torch_at_top():
    """Module-level imports of the launcher: the stdlib and torch only;
    anything else (the obs package, torch.distributed's store) is
    imported inside a function."""
    tree = ast.parse(pathlib.Path(launcher.__file__).read_text())
    top = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            top |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            top.add((node.module or "").split(".")[0])
    assert "torch" in top
    assert top - {"torch"} <= set(sys.stdlib_module_names), top
    lazy = {n.module for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n not in tree.body}
    assert "k8s_tpu_torch.obs.trace" in lazy


def test_configure_platform_refusals():
    with pytest.raises(ValueError, match="runs on cpu or cuda only"):
        launcher.configure_platform({"KTPU_FORCE_PLATFORM": "tpu"})
    with pytest.raises(ValueError, match="one device"):
        launcher.configure_platform({"KTPU_FORCE_PLATFORM": "cpu",
                                     "KTPU_NUM_CPU_DEVICES": "8"})
    launcher.configure_platform({"KTPU_FORCE_PLATFORM": "cpu",
                                 "KTPU_NUM_CPU_DEVICES": "1",
                                 "KTPU_COMPILE_CACHE_DIR": "/cache"})


def test_run_program_in_process_returns_the_runtime_summary(monkeypatch):
    """run_program over a Rendezvous of a dict env — chip_smoke's
    training phase, here at tiny size on the CPU: the device comes from
    the rendezvous, every step has its step_phases event (compile first,
    step_compute after), and the tracer accounts its overhead."""
    for key in ("KTPU_OBS_ADVERTISE", "KTPU_FLIGHT_DIR", "KTPU_TRACE",
                "KTPU_PROFILE_DIR", "KTPU_TB_LOGDIR"):
        monkeypatch.delenv(key, raising=False)
    rdzv = launcher.Rendezvous({
        "KTPU_FORCE_PLATFORM": "cpu",
        "KTPU_PROGRAM": "k8s_tpu_torch.programs.llama_train:main",
        "KTPU_PROGRAM_ARGS": f"{TINY_ARGS} --steps=3 --data=learnable"})
    run = launcher.run_program(rdzv)
    assert run["state"].model.embed_tokens.device.type == "cpu"
    phases = run["step_phases"]
    assert [p["step"] for p in phases] == [1, 2, 3]
    assert set(phases[0]["phases_ms"]) == {"data_wait", "compile", "host_sync"}
    for p in phases[1:]:
        assert set(p["phases_ms"]) == {"data_wait", "step_compute", "host_sync"}
    assert run["compile_s"] > 0
    assert 0 < run["tracer"].overhead_s < 0.1
    assert run["tracer"].last_step()["step"] == 3


# -- subprocess runs ---------------------------------------------------------


def _env(**kw):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("KTPU_", "MEGASCALE_"))}
    env["PYTHONPATH"] = str(REPO)
    env.update({k: str(v) for k, v in kw.items()})
    return env


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(env, timeout):
    return subprocess.run(
        [sys.executable, "-m", "k8s_tpu_torch.launcher.spmd_launcher"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


class _Launch:
    """The launcher as a child process whose stdout lines are collected
    by a reader thread, so the test can wait for an event with a
    deadline and act while the child runs."""

    def __init__(self, env):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "k8s_tpu_torch.launcher.spmd_launcher"],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        self.lines = []
        self._q = queue.Queue()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self._q.put(line)

    def wait_event(self, name, pred=lambda e: True, timeout=60.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                line = self._q.get(timeout=0.2)
            except queue.Empty:
                if self.proc.poll() is not None and self._q.empty():
                    break
                continue
            self.lines.append(line)
            for e in parse_events(line):
                if e["event"] == name and pred(e):
                    return e
        self.kill()
        pytest.fail(f"no {name} event within {timeout}s; stdout:\n"
                    + "".join(self.lines) + self.proc.stderr.read())

    def finish(self, timeout=60.0):
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.kill()
            raise
        self._reader.join(timeout=5)
        while not self._q.empty():
            self.lines.append(self._q.get())
        return rc, "".join(self.lines), self.proc.stderr.read()

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)


def _get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return json.loads(r.read())


def test_two_process_gloo_mesh_check():
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "k8s_tpu_torch.launcher.spmd_launcher"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(KTPU_FORCE_PLATFORM="cpu", KTPU_PROCESS_ID=rank,
                 KTPU_NUM_PROCESSES=2, KTPU_INIT_TIMEOUT=30,
                 KTPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}"))
        for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=60))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    smoke = events_of(outs[0][0], "smoke_ok")
    assert smoke == [{"event": "smoke_ok", "devices": 2, "processes": 2,
                      "result": 8.0 * 2 * 16 * 0.5 * 4}]
    assert events_of(outs[0][0], "done")
    assert not events_of(outs[1][0], "smoke_ok")  # rank 0 reports


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    """One tiny llama_train through the launcher with an obs endpoint:
    its stdout, exit code, and what /healthz said mid-run."""
    flight = tmp_path_factory.mktemp("flight")
    run = _Launch(_env(
        KTPU_FORCE_PLATFORM="cpu", KTPU_OBS_ADVERTISE="127.0.0.1:0",
        KTPU_FLIGHT_DIR=flight, KTPU_TRACE_ID="trace-launcher-test",
        KTPU_PROGRAM="k8s_tpu_torch.programs.llama_train:main",
        KTPU_PROGRAM_ARGS=f"{TINY_ARGS} --steps=4 --step_sleep=0.5"))
    port = run.wait_event("obs_ready")["port"]
    run.wait_event("step_phases", lambda e: e["step"] >= 1)
    healthz = _get_json(port, "/healthz")
    rc, out, err = run.finish()
    return {"rc": rc, "out": out, "err": err, "healthz": healthz,
            "flight": flight}


def test_llama_train_with_obs_endpoint(train_run):
    assert train_run["rc"] == 0, train_run["err"]
    hz = train_run["healthz"]
    assert hz["ok"] is True
    hb = hz["obs"]
    assert hb["step"] >= 1 and hb["trace_id"] == "trace-launcher-test"
    assert hb["task"] == "worker-0" and hb["host"] == 0
    assert "hbm" not in hb  # the CPU reports no device memory
    assert set(hb["health"]) == {"step", *HEALTH_KEYS}
    out = train_run["out"]
    assert len(events_of(out, "step_phases")) == 4
    assert events_of(out, "done")
    dump = json.loads((train_run["flight"] / "flight-host0.json").read_text())
    assert dump["reason"] == "done"
    assert [e["step"] for e in dump["entries"] if e["kind"] == "step"] == \
        [1, 2, 3, 4]


# JAX llama_train's events (k8s_tpu/programs/llama_train.py: mesh :202,
# compile_phase :440, step_health :477, step_phases :508, convergence
# :549; obs_ready: programs/common.py:275; done:
# launcher/spmd_launcher.py:359), and the MetricLogger line
# (programs/common.py:345). Taken from the source, so the test needs no
# run of the JAX program.
JAX_EVENT_KEYS = {
    "mesh": {"num_slices", "dp", "shape", "zero1", "zero_stage"},
    "obs_ready": {"host", "port"},
    "compile_phase": {"step", "seconds", "cache"},
    "step_health": {"step", *HEALTH_KEYS},
    "step_phases": {"step", "wall_ms", "phases_ms"},
    "convergence": {"first_loss", "final_loss", "ratio"},
    "done": {"elapsed_s"},
}
JAX_LOGGER_KEYS = {"run", "step", "steps_per_sec", "loss"}
JAX_PHASES = {"data_wait", "compile", "step_compute", "host_sync"}


def _jax_source_event_keys():
    """{event name: literal keys} of every ``{"event": "<name>", ...}``
    dict literal in the JAX program, its common module and launcher."""
    out = {}
    for rel in ("k8s_tpu/programs/llama_train.py",
                "k8s_tpu/programs/common.py",
                "k8s_tpu/launcher/spmd_launcher.py"):
        for node in ast.walk(ast.parse((REPO / rel).read_text())):
            if not isinstance(node, ast.Dict):
                continue
            consts = {k.value: v for k, v in zip(node.keys, node.values)
                      if isinstance(k, ast.Constant)}
            name = consts.get("event")
            if isinstance(name, ast.Constant):
                out.setdefault(name.value, set()).update(
                    set(consts) - {"event"})
    return out


def test_llama_train_events_match_jax_schema(train_run):
    src = _jax_source_event_keys()
    for name, keys in JAX_EVENT_KEYS.items():
        # the pin holds the JAX source's literal keys; step_health adds
        # the health block through a ** spread
        assert src[name] <= keys, name
        assert keys - src[name] <= set(HEALTH_KEYS), name
    events = parse_events(train_run["out"], strict=True)
    seen = {}
    for e in events:
        seen.setdefault(e["event"], set()).update(set(e) - {"event"})
    assert seen == JAX_EVENT_KEYS
    for e in events_of(train_run["out"], "step_phases"):
        assert set(e["phases_ms"]) <= JAX_PHASES
    logs = [json.loads(line) for line in train_run["out"].splitlines()
            if line.startswith('{"run"')]
    assert [set(r) for r in logs] == [JAX_LOGGER_KEYS] * 4


def test_sigterm_mid_run_exits_143_with_flight_dump(tmp_path):
    run = _Launch(_env(
        KTPU_FORCE_PLATFORM="cpu", KTPU_FLIGHT_DIR=tmp_path,
        KTPU_TRACE_ID="trace-sigterm",
        KTPU_PROGRAM="k8s_tpu_torch.programs.llama_train:main",
        KTPU_PROGRAM_ARGS=f"{TINY_ARGS} --steps=200 --step_sleep=0.2"))
    run.wait_event("step_phases", lambda e: e["step"] >= 2)
    run.proc.send_signal(signal.SIGTERM)
    rc, out, err = run.finish(timeout=30)
    assert rc == 143, err
    assert events_of(out, "preempt_requested")
    assert not events_of(out, "done")
    dump = json.loads((tmp_path / "flight-host0.json").read_text())
    assert dump["reason"] == "sigterm"
    steps = [e for e in dump["entries"] if e["kind"] == "step"]
    assert [e["step"] for e in steps[:2]] == [1, 2]
    assert {e["trace_id"] for e in steps} == {"trace-sigterm"}


def test_user_error_exits_1():
    res = _run(_env(KTPU_FORCE_PLATFORM="cpu",
                    KTPU_PROGRAM="k8s_tpu_torch.programs.llama_train:main",
                    KTPU_PROGRAM_ARGS=f"{TINY_ARGS} --strategy=pp"),
               timeout=60)
    assert res.returncode == 1, res.stderr
    assert "program failed: strategy='pp' is not ported" in res.stderr


def test_unreachable_coordinator_exits_143():
    res = _run(_env(KTPU_FORCE_PLATFORM="cpu", KTPU_PROCESS_ID=1,
                    KTPU_NUM_PROCESSES=2, KTPU_INIT_TIMEOUT=2,
                    KTPU_COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}"),
               timeout=60)
    assert res.returncode == 143, res.stderr
    assert "distributed init failed (retryable)" in res.stderr


def test_no_platform_without_a_card_exits_1():
    """No KTPU_FORCE_PLATFORM: the launcher needs a card and, on a
    machine without one, exits 1 — it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the launcher would use it")
    res = _run(_env(), timeout=60)
    assert res.returncode == 1
    assert "platform config failed" in res.stderr
    assert "no CUDA device is available" in res.stderr
    assert not events_of(res.stdout, "smoke_ok")
