"""The port's program-side observability (``k8s_tpu_torch/obs``,
``k8s_tpu_torch/controller``, the runtime hooks of
``k8s_tpu_torch/programs/common.py``), held to the JAX package's.

- Tracer and FlightRecorder: the same call sequence under a patched
  clock gives the same heartbeats and the same dump JSON; ``from_env``
  reads the same contract.
- The JAX reconciler's ``StragglerDetector`` and ``HealthMonitor`` give
  the same verdicts for the port's heartbeats as for the JAX tracer's:
  a planted slow host (``KTPU_CHAOS_SLOW_HOST``) and a NaN health block.
- ``hbm_block`` on the same stats list, the ``/metrics`` exposition of
  the same series values, and the ``HealthServer``'s ``/healthz``,
  ``/debug/flightrecorder``, ``/metrics`` and 404 bodies are equal.
- The port's ``HeartbeatPusher`` reaches a JAX ``HealthServer``'s
  ``heartbeat_sink``.
- The nan-grad chaos arm poisons exactly the armed step of the port's
  ``llama_train``, as ``_chaos_scaled`` does in the JAX program.
- The device telemetry on the CPU (no block, an honest empty profile),
  the env-gated loop profile, and ``MetricLogger``'s TensorBoard writer
  (with and without ``torch.utils.tensorboard``, stubbed: the real one
  may import TensorFlow, which takes seconds).
"""

import dataclasses
import http.client
import json
import math
import pathlib
import sys
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.controller import health as jax_health_server
from k8s_tpu.controller import metrics as jax_metrics
from k8s_tpu.obs import events as jax_events
from k8s_tpu.obs import health as jax_health
from k8s_tpu.obs import lint as jax_lint
from k8s_tpu.obs import trace as jax_trace
from k8s_tpu.obs.health import HealthMonitor
from k8s_tpu.obs.straggler import StragglerDetector
from k8s_tpu.programs import llama_train as jax_llama_train
from k8s_tpu_torch.controller import health as health_server
from k8s_tpu_torch.controller import metrics
from k8s_tpu_torch.launcher.spmd_launcher import Rendezvous, run_program
from k8s_tpu_torch.obs import events, health, push, trace
from k8s_tpu_torch.ops import _kernels
from k8s_tpu_torch.programs import common, llama_train


class FakeClock:
    """perf_counter, monotonic, time and sleep on one counter that
    advances 1 ms per read (and by the slept time), so a call sequence
    times the same in any implementation that makes the same calls."""

    def __init__(self):
        self.t = 1000.0

    def read(self):
        self.t += 1e-3
        return self.t

    def sleep(self, s):
        self.t += s


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    for name in ("perf_counter", "monotonic", "time"):
        monkeypatch.setattr(time, name, c.read)
    monkeypatch.setattr(time, "sleep", c.sleep)
    return c


def _drive(mod, dump_path, clock):
    """One call sequence on ``mod``'s Tracer: steps with phases, a
    health note, spans, an event, a heartbeat per step, a final dump."""
    clock.t = 1000.0
    tracer = mod.Tracer(trace_id="job-1", task="worker-0", host=0,
                        recorder=mod.FlightRecorder(capacity=6,
                                                    dump_path=dump_path))
    beats = []
    for step in range(1, 5):
        with tracer.step(step) as st:
            with st.phase("data_wait"):
                pass
            with st.phase("compile" if step == 1 else "step_compute"):
                clock.sleep(0.25)
            with st.phase("host_sync"):
                clock.sleep(0.01)
        if step % 2 == 0:
            tracer.note_health(step, {"loss": 2.0 / step, "grad_norm": 1.5,
                                      "nonfinite_grads": 0.0,
                                      "update_ratio": 1e-3})
        beats.append(tracer.heartbeat())
    tracer.note_span("compile", 0.3, step=1)
    with tracer.span("restore", source="local"):
        clock.sleep(0.1)
    tracer.event("drain", reason="test")
    tracer.flush("done")
    return tracer, beats


def test_tracer_heartbeats_and_dump_match_jax(tmp_path, clock):
    ours, beats = _drive(trace, str(tmp_path / "port.json"), clock)
    ref, ref_beats = _drive(jax_trace, str(tmp_path / "jax.json"), clock)
    assert beats == ref_beats
    assert ours.last_step() == ref.last_step()
    assert ours.overhead_s == ref.overhead_s
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "jax.json").read_text())
    assert trace.GANG_PHASES == jax_trace.GANG_PHASES


@pytest.mark.parametrize("env", [
    {},
    {"KTPU_TRACE": "0"},
    {"KTPU_TRACE_ID": "j-2", "KTPU_FLIGHT_DIR": "/f", "KTPU_FLIGHT_CAPACITY":
     "17", "KTPU_CHAOS_SLOW_HOST": "2:0.5:3"},
    {"KTPU_FLIGHT_CAPACITY": "lots", "KTPU_CHAOS_SLOW_HOST": "2:x"},
    {"KTPU_CHAOS_SLOW_HOST": "1:0.25"},
], ids=["empty", "off", "full", "garbage", "other_host"])
def test_tracer_from_env_matches_jax(env):
    def view(t):
        return (t.trace_id, t.task, t.host, t.enabled, t.recorder.capacity,
                t.recorder.dump_path, t._env_slow_seconds, t._env_slow_steps)

    assert view(trace.Tracer.from_env(env, task="worker-2", host=2)) == \
        view(jax_trace.Tracer.from_env(env, task="worker-2", host=2))


def _gang_heartbeats(mod, clock, slow_spec, nan_step=None):
    """Three hosts stepping in lockstep, host 1 throttled by the
    slow-host chaos arm; per round every host's heartbeat."""
    clock.t = 1000.0
    env = {"KTPU_CHAOS_SLOW_HOST": slow_spec}
    tracers = [mod.Tracer.from_env(env, task=f"worker-{h}", host=h)
               for h in range(3)]
    rounds = []
    for step in range(1, 7):
        for t in tracers:
            with t.step(step) as st:
                with st.phase("data_wait"):
                    clock.sleep(0.02)
                with st.phase("step_compute"):
                    clock.sleep(0.2)
            loss = float("nan") if step == nan_step and t.host == 0 else 3.0 - 0.1 * step
            t.note_health(step, {"loss": loss, "grad_norm": 1.0,
                                 "nonfinite_grads": 0.0, "update_ratio": 1e-3})
        rounds.append({t.host: t.heartbeat() for t in tracers})
    return rounds


def test_straggler_and_health_verdicts_match_jax(clock):
    """The JAX reconciler's detectors judge the port's heartbeats as
    they judge the JAX tracer's: host 1, throttled 0.5 s a step, is the
    straggler; host 0's NaN loss at step 4 is a divergence."""
    ours = _gang_heartbeats(trace, clock, "1:0.5", nan_step=4)
    ref = _gang_heartbeats(jax_trace, clock, "1:0.5", nan_step=4)
    assert json.dumps(ours, sort_keys=True) == json.dumps(ref, sort_keys=True)

    def verdicts(rounds):
        det, mon = StragglerDetector(consecutive=3), HealthMonitor()
        out = []
        for beats in rounds:
            v = det.observe(beats)
            h = mon.observe(beats[0]["health"])
            out.append((dataclasses.asdict(v), json.dumps(
                dataclasses.asdict(h), sort_keys=True)))
        return out

    mine, theirs = verdicts(ours), verdicts(ref)
    assert mine == theirs
    assert [v["new_straggler"] for v, _ in mine] == [None, None, 1, None, None, None]
    health_v = [json.loads(h) for _, h in mine]
    assert [h["new_divergence"] for h in health_v] == \
        [False, False, False, True, False, False]
    assert health_v[3]["first_bad_step"] == 4
    assert health_v[3]["last_healthy_step"] == 3


# -- device telemetry, metrics, the HTTP endpoint ------------------------------

STATS = [
    {"device": 0, "bytes_in_use": 41_000_000_000,
     "peak_bytes_in_use": 62_350_000_000, "bytes_limit": 85_045_000_000},
    {"device": 1, "bytes_in_use": 1_000, "peak_bytes_in_use": 2_000,
     "bytes_limit": 0},
]


def test_hbm_block_and_gauges_match_jax():
    for stats in (STATS, STATS[:1], []):
        assert health.hbm_block(stats, export_gauges=False) == \
            jax_health.hbm_block(stats, export_gauges=False)
    health.hbm_block(STATS, task="parity-task")
    jax_health.hbm_block(STATS, task="parity-task")
    for name in ("OBS_HBM_IN_USE", "OBS_HBM_PEAK", "OBS_HBM_LIMIT"):
        ours, ref = getattr(metrics, name), getattr(jax_metrics, name)
        assert (ours.name, ours.help, ours.type) == (ref.name, ref.help, ref.type)

        def lines(m):
            return [ln for ln in m.expose() if "parity-task" in ln]

        assert lines(ours) == lines(ref) and len(lines(ours)) == 2
    ours, ref = metrics.CKPT_RESTORE_SECONDS, jax_metrics.CKPT_RESTORE_SECONDS
    assert (ours.name, ours.help, ours.type) == (ref.name, ref.help, ref.type)


def test_device_telemetry_on_the_cpu():
    """No CUDA in this process: no device stats, no hbm block (the JAX
    package's CPU contract)."""
    assert not torch.cuda.is_initialized()
    assert health.device_memory_stats() == []
    assert health.hbm_block() is None


def _registry(mod):
    reg = mod.Registry()
    c = reg.counter("ktpu_test_total", "A counter\nwith a newline \\ slash")
    g = reg.gauge("ktpu_test_gauge", "A gauge")
    h = reg.histogram("ktpu_test_seconds", "A histogram", buckets=(0.1, 1.0))
    c.inc({"job": 'a"b\\c\nd'})
    c.inc({"job": "x"}, by=2.5)
    g.set(7.25)
    g.set(-1.0, {"device": "0", "task": "worker-0"})
    for v in (0.05, 0.5, 3.0):
        h.observe(v, {"phase": "compile"})
    h.observe(0.2)
    return reg


def test_metrics_exposition_matches_jax():
    assert _registry(metrics).expose() == _registry(jax_metrics).expose()


def test_port_series_are_documented():
    """Every ktpu_* series the port registers (found as the JAX lint
    finds them, outside the kernels' build directory) is one the JAX
    package's catalogue (docs/OBSERVABILITY.md) documents."""
    pkg = pathlib.Path(jax_lint.DEFAULT_SRC).parent / "k8s_tpu_torch"
    ours = {name for f in pkg.rglob("*.py")
            if not f.is_relative_to(_kernels.BUILD_DIR)
            for name in jax_lint._REGISTER_RE.findall(f.read_text())}
    assert ours == {"ktpu_ckpt_restore_seconds", "ktpu_obs_hbm_bytes_in_use",
                    "ktpu_obs_hbm_bytes_peak", "ktpu_obs_hbm_bytes_limit",
                    # the checkpoint manager's series
                    "ktpu_ckpt_restores_total", "ktpu_ckpt_lost_steps_total",
                    "ktpu_ckpt_lost_steps_per_restart",
                    "ktpu_ckpt_local_saves_total", "ktpu_ckpt_overhead_fraction",
                    "ktpu_ckpt_save_seconds", "ktpu_ckpt_save_skipped_total",
                    # the operator's series (the controller and the reconciler)
                    "ktpu_operator_events_total",
                    "ktpu_operator_jobs_started_total",
                    "ktpu_operator_jobs_terminal_total",
                    "ktpu_operator_reconciles_total", "ktpu_operator_live_jobs",
                    "ktpu_operator_informer_objects",
                    "ktpu_operator_informer_synced",
                    "ktpu_operator_gang_restart_backoff_seconds",
                    "ktpu_operator_gang_restarts_delayed_total",
                    "ktpu_obs_step_skew_seconds", "ktpu_obs_host_step_time_seconds",
                    "ktpu_obs_phase_seconds", "ktpu_obs_stragglers_total",
                    "ktpu_obs_divergence_restarts_total",
                    "ktpu_obs_diverged_steps_total",
                    "ktpu_obs_numerics_warnings_total",
                    "ktpu_obs_memory_pressure_total",
                    "ktpu_controller_reconcile_latency_seconds",
                    "ktpu_controller_workqueue_depth",
                    "ktpu_controller_workqueue_coalesced_total",
                    "ktpu_controller_requeues_total",
                    "ktpu_controller_http_calls_total",
                    "ktpu_controller_heartbeats_pushed_total",
                    # the cluster scheduler's series (sched/, the controller)
                    "ktpu_sched_queue_depth", "ktpu_sched_admitted_total",
                    "ktpu_sched_preempted_total", "ktpu_sched_quota_used_chips",
                    "ktpu_sched_slices_free", "ktpu_sched_preempt_lost_steps_total",
                    "ktpu_sched_tick_seconds", "ktpu_sched_backfill_total",
                    "ktpu_sched_fragmentation", "ktpu_sched_contiguity_hit_rate",
                    "ktpu_sched_kicks_total", "ktpu_sched_kicks_coalesced_total",
                    # the elastic resize's series (the reconciler)
                    "ktpu_resize_total", "ktpu_resize_lost_steps_total",
                    "ktpu_resize_dp_degree",
                    # the serving front-end's gauges
                    "ktpu_serving_prefix_cache_bytes",
                    "ktpu_serving_spec_decode_rounds",
                    "ktpu_serving_spec_decode_drafted",
                    "ktpu_serving_spec_decode_accepted"}
    assert ours <= jax_lint.documented_series()


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def _server(mod, trace_mod, metrics_mod, **kw):
    rec = trace_mod.FlightRecorder(capacity=4)
    for i in range(6):
        rec.record({"kind": "step", "step": i, "wall_s": 0.5})
    srv = mod.HealthServer(port=0, host="127.0.0.1",
                           registry=_registry(metrics_mod),
                           flight_recorder=rec, **kw)
    return srv.start()


@pytest.mark.parametrize("stats", [None, {"obs": {"step": 3, "nan": float("nan")}}],
                         ids=["plain", "stats"])
def test_health_server_bodies_match_jax(stats):
    provider = (lambda: stats) if stats is not None else None
    ours = _server(health_server, trace, metrics, stats_provider=provider)
    ref = _server(jax_health_server, jax_trace, jax_metrics,
                  stats_provider=provider)
    try:
        for method, path in [("GET", "/healthz"), ("GET", "/readyz"),
                             ("GET", "/metrics"),
                             ("GET", "/debug/flightrecorder"),
                             ("GET", "/debug/profile?seconds=1"),
                             ("GET", "/nope"),
                             ("POST", "/v1/heartbeat/ns/job/0"),
                             ("POST", "/v1/other")]:
            got = _request(ours.port, method, path, b"{}")
            assert got == _request(ref.port, method, path, b"{}"), path
        ours.set_unhealthy()
        ref.set_unhealthy()
        assert _request(ours.port, "GET", "/healthz") == \
            _request(ref.port, "GET", "/healthz")
    finally:
        ours.stop()
        ref.stop()


def test_heartbeat_pusher_reaches_jax_sink(monkeypatch):
    got = []
    srv = jax_health_server.HealthServer(port=0, host="127.0.0.1").start()
    srv.heartbeat_sink = lambda ns, name, host, payload: \
        got.append((ns, name, host, payload)) or True
    try:
        pusher = push.HeartbeatPusher(
            f"http://127.0.0.1:{srv.port}/v1/heartbeat/team/job-7/3",
            lambda: {"obs": {"step": 5, "host": 3}})
        assert pusher.push_once() and pusher.push_once()
        assert pusher.pushed == 2
        assert got == [("team", "job-7", 3, {"obs": {"step": 5, "host": 3}})] * 2
        pusher.stop()
        monkeypatch.delenv(push.PUSH_URL_ENV, raising=False)
        assert push.maybe_start_pusher(dict) is None
    finally:
        srv.stop()


def test_event_parser_matches_jax():
    text = "\n".join([
        '{"event": "obs_ready", "host": 0, "port": 1234}',
        "free text",
        '{"run": "llama-tiny-dp", "step": 1}',
        '{"event": "step_phases", "step": 1, "phases_ms": {"compile": 5.0}}',
        '{"event": "trunc',
        "[1, 2]",
        '{"event": "done", "elapsed_s": 1.5}',
    ])
    assert events.parse_events(text) == jax_events.parse_events(text)
    assert events.events_of(text, "done") == jax_events.events_of(text, "done")
    assert events.last_event(text, "step_phases") == \
        jax_events.last_event(text, "step_phases")
    for mod in (events, jax_events):
        with pytest.raises(mod.EventParseError, match="line 5"):
            mod.parse_events(text, strict=True)


# -- the nan-grad chaos arm ---------------------------------------------------


def test_chaos_scaled_matches_jax():
    for scale in (None, 1.0, 0.0):
        jb = {} if scale is None else {"chaos_scale": np.float32(scale)}
        tb = {} if scale is None else {"chaos_scale": torch.tensor(scale)}
        ref = float(jax_llama_train._chaos_scaled(jnp.float32(2.5), jb))
        ours = float(llama_train._chaos_scaled(torch.tensor(2.5), tb))
        assert (math.isnan(ours) and math.isnan(ref)) or ours == ref == 2.5


def test_consume_nan_grad_matches_jax():
    for mod in (health, jax_health):
        env = {"KTPU_CHAOS_NAN_GRAD": "3"}
        assert mod.nan_grad_armed(env) == 3
        assert [mod.consume_nan_grad(s, env) for s in (1, 2, 3)] == \
            [False, False, True]
        mod.arm_nan_grad()
        assert mod.nan_grad_armed({}) == -1
        assert mod.consume_nan_grad(9, {}) and mod.nan_grad_armed({}) is None
        assert mod.nan_grad_armed({"KTPU_CHAOS_NAN_GRAD": "x"}) is None


def _tiny_run(monkeypatch, args, **env):
    for key in ("KTPU_OBS_ADVERTISE", "KTPU_FLIGHT_DIR", "KTPU_TRACE",
                "KTPU_PROFILE_DIR", "KTPU_TB_LOGDIR", "KTPU_CHAOS_NAN_GRAD",
                "KTPU_CHAOS_NAN_GRAD_FIRED"):
        monkeypatch.delenv(key, raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, str(val))
    rdzv = Rendezvous({
        "KTPU_FORCE_PLATFORM": "cpu",
        "KTPU_PROGRAM": "k8s_tpu_torch.programs.llama_train:main",
        "KTPU_PROGRAM_ARGS": "--model=tiny --batch_size=2 --seq_len=16 "
                             "--log_every=1 " + args})
    return run_program(rdzv)


def test_nan_grad_chaos_poisons_exactly_the_armed_step(monkeypatch, capsys):
    _tiny_run(monkeypatch, "--steps=3", KTPU_CHAOS_NAN_GRAD=2)
    out = capsys.readouterr().out
    assert events.events_of(out, "chaos_nan_grad") == \
        [{"event": "chaos_nan_grad", "step": 2}]
    health_ev = events.events_of(out, "step_health")
    assert health_ev[0]["nonfinite_grads"] == 0
    assert math.isfinite(health_ev[0]["loss"])
    assert health_ev[1]["nonfinite_grads"] > 0
    assert health_ev[1]["step"] == 2
    assert "KTPU_CHAOS_NAN_GRAD" not in __import__("os").environ


# -- profiling and the TensorBoard writer --------------------------------------


def test_capture_profile_on_the_cpu(tmp_path, monkeypatch):
    """A session on a thread that only sleeps records no event: ok false,
    never a claimed empty capture. One whose window runs torch ops on
    the same thread records them. Errors as the JAX package's."""
    empty = health.capture_profile(str(tmp_path), 0.1)
    assert empty["ok"] is False and empty["events"] == 0
    assert "no CPU op event" in empty["error"]

    x = torch.ones(64, 64)
    monkeypatch.setattr(time, "sleep", lambda s: [x @ x for _ in range(3)])
    got = health.capture_profile(str(tmp_path), 0.1)
    assert got["ok"] is True and got["events"] >= 3
    assert got["dir"].startswith(str(tmp_path / "profile-"))
    assert health.trace_event_counts(got["trace"])["cpu_op"] == got["events"]
    assert health.capture_profile("", 1.0) == jax_health.capture_profile("", 1.0)
    with health._PROFILE_LOCK:
        assert health.capture_profile(str(tmp_path), 1.0) == \
            {"ok": False, "error": "profile capture already in progress"}


def test_profile_dir_wraps_the_loop(monkeypatch, tmp_path):
    _tiny_run(monkeypatch, "--steps=2", KTPU_PROFILE_DIR=tmp_path)
    traces = list(tmp_path.glob("loop-*.json"))
    assert len(traces) == 1
    assert health.trace_event_counts(str(traces[0])).get("cpu_op", 0) > 0


class _Writer:
    def __init__(self, path):
        self.path, self.scalars, self.flushes = path, [], 0
        _Writer.made.append(self)

    def add_scalar(self, key, value, step):
        self.scalars.append((key, value, step))

    def flush(self):
        self.flushes += 1


@pytest.mark.parametrize("pid", [0, -1, 1])
def test_metric_logger_tensorboard_writer(monkeypatch, capsys, tmp_path, pid):
    """KTPU_TB_LOGDIR: worker 0 writes each logged scalar (and
    steps_per_sec) under <logdir>/<run>; the control replica and other
    workers write nothing."""
    _Writer.made = []
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=_Writer))
    monkeypatch.setenv("KTPU_TB_LOGDIR", str(tmp_path))
    log = common.MetricLogger(types.SimpleNamespace(process_id=pid), "run-a")
    log.log(1, {"loss": 2.5})
    if pid != 0:
        assert _Writer.made == []
        return
    (w,) = _Writer.made
    assert w.path == str(tmp_path / "run-a")
    assert [s[0] for s in w.scalars] == ["loss", "steps_per_sec"]
    assert w.scalars[0] == ("loss", 2.5, 1) and w.flushes == 1
    assert json.loads(capsys.readouterr().out)["loss"] == 2.5


def test_metric_logger_without_tensorboard(monkeypatch, capsys, tmp_path):
    """Without the package (or with a writer that fails) the logger says
    so once, as the JAX one does, and keeps to stdout."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setenv("KTPU_TB_LOGDIR", str(tmp_path))
    log = common.MetricLogger(types.SimpleNamespace(process_id=0), "run-b")
    log.log(1, {"loss": 1.0})
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("tensorboard writer unavailable: ")
    assert json.loads(out[1])["loss"] == 1.0

    class Broken(_Writer):
        def add_scalar(self, *a):
            raise OSError("disk full")

    _Writer.made = []
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=Broken))
    log = common.MetricLogger(types.SimpleNamespace(process_id=0), "run-b")
    log.log(1, {"loss": 1.0})
    log.log(2, {"loss": 0.5})
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "tensorboard write failed, disabling: disk full"
    assert len(out) == 3 and log._tb is None
