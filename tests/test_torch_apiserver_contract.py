"""The port's REST backend, dev apiserver, informer and leader election
(``k8s_tpu_torch/api/{wire,apiserver,restcluster,informer,election}.py``,
``operator.py`` without ``--local``, ``kubectl_local --server``), held
to the JAX package's control plane, which imports no JAX on these paths.
Tolerance: exact equality of objects (uids and timestamps aside),
status codes and verdicts.

- The JAX package's own contract cases (``tests/test_apiserver_contract.py``:
  CRUD, watch, CRD and TpuJob clients, election CAS, the control plane
  over REST, the real-cluster behaviours, failover, bootstrap) run
  unchanged against the port's modules, the backend-parametrised ones
  over the port's in-memory cluster and its REST backend.
- The wire: every kind's route (prefix, plural, paths) is the JAX one.
- Cross-wire: one script of requests through the JAX ``RestCluster``
  against the port's ``LocalApiServer``, and through the port's
  ``RestCluster`` against the JAX one, gives the objects and status
  codes of the same script on either package alone.
- Over REST a running job reconciles with zero API calls besides its
  watches (the informer's reflector), and the CLI tools drive a job to
  ``Succeeded`` through a dev apiserver process.
"""

import functools
import os
import pathlib
import signal
import subprocess
import sys
import time

import pytest

from k8s_tpu.api import apiserver as jax_apiserver
from k8s_tpu.api import errors as jax_errors
from k8s_tpu.api import restcluster as jax_restcluster
from k8s_tpu.api import wire as jax_wire
from k8s_tpu_torch import spec as PS
from k8s_tpu_torch.api import apiserver as port_apiserver
from k8s_tpu_torch.api import errors as port_errors
from k8s_tpu_torch.api import restcluster as port_restcluster
from k8s_tpu_torch.api import wire as port_wire
from k8s_tpu_torch.api.client import KubeClient
from k8s_tpu_torch.api.crd_client import TpuJobClient
from k8s_tpu_torch.controller.controller import Controller
from k8s_tpu_torch.runtime.kubelet import LocalKubelet, SimulatedExecutor
from torch_port_cases import port_variant

REPO = pathlib.Path(__file__).resolve().parent.parent

# -- the JAX package's contract cases, on the port -----------------------------

_jax_cases = port_variant("test_apiserver_contract.py")
backend = _jax_cases.backend  # the fixture: the port's memory and REST backends
TestCrudContract = _jax_cases.TestCrudContract
TestWatchContract = _jax_cases.TestWatchContract


class TestCrdAndJobClient(_jax_cases.TestCrdAndJobClient):
    def test_tpujob_roundtrip(self, backend):
        """The JAX case with the port's ``gpu:`` block where it sets
        ``tpu:`` (which the port's TpuJob does not have)."""
        from k8s_tpu_torch.api.objects import Container, PodSpec, PodTemplateSpec

        c, _ = backend
        jc = TpuJobClient(c)
        j = PS.TpuJob()
        j.metadata.name = "roundtrip"
        j.metadata.namespace = "default"
        j.spec.replica_specs = [PS.TpuReplicaSpec(
            replica_type="COORDINATOR",
            template=PodTemplateSpec(spec=PodSpec(containers=[
                Container(name="jax", image="i")])))]
        j.spec.gpu = PS.GpuSpec(accelerator="h100-80gb", num_cards=8)
        jc.create(j)
        got = jc.get("default", "roundtrip")
        assert (got.spec.gpu.accelerator, got.spec.gpu.num_cards) == ("h100-80gb", 8)
        assert got.spec.replica_specs[0].template.spec.containers[0].name == "jax"
        got.status.phase = PS.TpuJobPhase.CREATING
        jc.update(got)
        assert jc.get("default", "roundtrip").status.phase == PS.TpuJobPhase.CREATING
        assert len(jc.list("default")) == 1
        jc.delete("default", "roundtrip")
        assert jc.list("default") == []


TestElectionContract = _jax_cases.TestElectionContract
TestControlPlaneOverRest = _jax_cases.TestControlPlaneOverRest


class TestRealClusterBehaviors(_jax_cases.TestRealClusterBehaviors):
    def test_watch_bookmarks_advance_redial_rv(self):
        """The JAX case, with its race taken out: it churns Services
        right after opening the Pod watch, and on a loaded machine the
        watch's thread may dial only after the churn, from an RV the
        history no longer holds (a 410, not a bookmark). Here the watch
        first delivers one Pod event, so the churn starts on an open
        stream."""
        from k8s_tpu_torch.api.cluster import _WATCH_HISTORY

        api = port_apiserver.LocalApiServer().start()
        try:
            rest = port_restcluster.RestCluster(api.url)
            rest.create("Pod", _jax_cases._pod("bm-seed"))
            w = rest.watch("Pod", "default", rest.resource_version)
            rest.create("Pod", _jax_cases._pod("bm-dialed"))
            _next_named(w, "bm-dialed")
            dialed_rv = w._rv
            for i in range(_WATCH_HISTORY + 50):
                api.cluster.create("Service", {
                    "metadata": {"name": f"churn-{i}", "namespace": "default"}})
            # idle >1 s: a bookmark carrying the post-churn RV must flow
            deadline = time.monotonic() + 30
            while w._rv <= dialed_rv and time.monotonic() < deadline:
                time.sleep(0.2)
            assert w._rv > _WATCH_HISTORY, \
                f"no bookmark advanced the watcher RV (rv={w._rv})"
            rest.create("Pod", _jax_cases._pod("bm-after"))
            _next_named(w, "bm-after")
            w.stop()
        finally:
            api.stop()


def _next_named(w, name, timeout=30.0):
    """The watch's next event for object ``name``, within ``timeout``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = w.next(timeout=0.5)
        if got is not None and got.name == name:
            return got
    raise AssertionError(f"watch died before {name}'s event")


TestOperatorFailover = _jax_cases.TestOperatorFailover
TestBootstrap = _jax_cases.TestBootstrap


def test_the_cases_run_against_the_port():
    assert _jax_cases.RestCluster is port_restcluster.RestCluster
    assert _jax_cases.LocalApiServer is port_apiserver.LocalApiServer
    assert _jax_cases.S is PS


# -- the wire ------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(jax_wire.ROUTES))
def test_wire_routes_equal_the_jax_ones(kind):
    j, p = jax_wire.ROUTES[kind], port_wire.ROUTES[kind]
    assert (p.kind, p.api_version, p.plural, p.namespaced, p.prefix) == \
        (j.kind, j.api_version, j.plural, j.namespaced, j.prefix)
    for ns in (None, "default"):
        assert p.collection_path(ns) == j.collection_path(ns)
        assert p.object_path(ns, "x-1") == j.object_path(ns, "x-1")


def test_wire_tables_equal_the_jax_ones():
    assert sorted(port_wire.ROUTES) == sorted(jax_wire.ROUTES)
    assert port_wire.PLURALS == jax_wire.PLURALS
    c, jc = port_wire.CRD_ROUTE, jax_wire.CRD_ROUTE
    assert (c.api_version, c.plural, c.collection_path(None)) == \
        (jc.api_version, jc.plural, jc.collection_path(None))
    assert port_wire.status_body(410, "Gone", "m") == jax_wire.status_body(410, "Gone", "m")
    sel = {"b": "2", "a": "1"}
    assert port_wire.format_label_selector(sel) == jax_wire.format_label_selector(sel)
    assert port_wire.parse_label_selector("a=1, b=2") == \
        jax_wire.parse_label_selector("a=1, b=2")


# -- cross-wire ------------------------------------------------------------------

_SIDES = {"jax": (jax_restcluster, jax_apiserver, jax_errors),
          "port": (port_restcluster, port_apiserver, port_errors)}


def _norm(obj):
    """An object as the script compares it: without its uid and
    creation timestamp (fresh per server)."""
    obj = dict(obj)
    meta = dict(obj.get("metadata") or {})
    meta.pop("uid", None)
    meta.pop("creationTimestamp", None)
    obj["metadata"] = meta
    return obj


def _script(client_side, server_side):
    """One request script through ``client_side``'s RestCluster against
    ``server_side``'s LocalApiServer: each step's object (normalized) or
    error (its code and class name)."""
    rest_mod, _, errs = _SIDES[client_side]
    api = _SIDES[server_side][1].LocalApiServer().start()
    out = []

    def step(name, fn):
        try:
            r = fn()
        except errs.ApiError as e:
            out.append((name, "error", getattr(e, "code", None), type(e).__name__))
            return None
        if isinstance(r, list):
            out.append((name, sorted(
                (o["metadata"]["name"], _norm(o)["metadata"].get("labels"))
                for o in r)))
        elif isinstance(r, dict):
            out.append((name, _norm(r)))
        else:
            out.append((name, r))
        return r

    try:
        rc = rest_mod.RestCluster(api.url)
        pod = {"metadata": {"name": "p-0", "namespace": "default",
                            "labels": {"job": "a"}},
               "spec": {"containers": [{"name": "jax", "image": "i"}]}}
        step("create", lambda: rc.create("Pod", pod))
        step("create-again", lambda: rc.create("Pod", pod))
        got = step("get", lambda: rc.get("Pod", "default", "p-0"))
        stale = _norm(got)
        stale["metadata"]["resourceVersion"] = "1"
        step("update", lambda: rc.update("Pod", {**got, "status": {"phase": "Running"}},
                                         check_version=True))
        step("cas-stale", lambda: rc.update("Pod", stale, check_version=True))
        step("create-b", lambda: rc.create("Pod", {**pod, "metadata": {
            "name": "p-1", "namespace": "default", "labels": {"job": "b"}}}))
        step("list-selector", lambda: rc.list("Pod", "default", {"job": "b"}))
        step("list", lambda: rc.list("Pod", "default"))
        step("tpujob", lambda: rc.create(PS.CRD_KIND, {
            "metadata": {"name": "j", "namespace": "default"},
            "spec": {"gpu": {"accelerator": "h100-80gb-x1", "numCards": 1}}}))
        step("get-tpujob", lambda: rc.get(PS.CRD_KIND, "default", "j"))
        step("delete", lambda: rc.delete("Pod", "default", "p-0"))
        step("get-missing", lambda: rc.get("Pod", "default", "p-0"))
        step("delete-missing", lambda: rc.delete("Pod", "default", "p-0"))
        step("log-without-dir", lambda: rc.pod_log("default", "p-1"))
        step("rv", lambda: rc.resource_version)
    finally:
        api.stop()
    return out


@functools.lru_cache(maxsize=None)
def _jax_alone():
    return _script("jax", "jax")


@pytest.mark.parametrize("client_side,server_side",
                         [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_cross_wire_round_trips(client_side, server_side):
    """Each package's client against the other's server (and the port
    alone) gives what the same script gives on the JAX package alone."""
    want = _jax_alone()
    assert _script(client_side, server_side) == want
    codes = {s[0]: s[2] for s in want if s[1] == "error"}
    assert codes == {"create-again": 409, "cas-stale": 409, "get-missing": 404,
                     "delete-missing": 404, "log-without-dir": 404}


def test_cross_wire_watch_and_410():
    """A watch from the JAX client on the port's server (and the port's
    client on the JAX server) sees the same frames, and a resourceVersion
    older than the server's history is a 410 on both."""
    seen = {}
    for client_side, server_side in (("jax", "port"), ("port", "jax")):
        rest_mod, _, errs = _SIDES[client_side]
        srv_mod = _SIDES[server_side][1]
        from k8s_tpu_torch.api.cluster import _WATCH_HISTORY

        api = srv_mod.LocalApiServer().start()
        try:
            rc = rest_mod.RestCluster(api.url)
            rc.create("ConfigMap", {"metadata": {"name": "seed", "namespace": "default"}})
            w = rc.watch("Service", "default", rc.resource_version)
            rc.create("Service", {"metadata": {"name": "s", "namespace": "default"}})
            rc.delete("Service", "default", "s")
            frames = []
            deadline = time.monotonic() + 10
            while len(frames) < 2 and time.monotonic() < deadline:
                ev = w.next(timeout=0.5)
                if ev is not None:
                    frames.append((ev.type, ev.kind, ev.name))
            w.stop()
            for i in range(_WATCH_HISTORY + 5):
                api.cluster.create("ConfigMap", {
                    "metadata": {"name": f"c{i}", "namespace": "default"}})
            old = rc.watch("Service", "default", 1)
            with pytest.raises(errs.OutdatedVersionError):
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline:
                    old.next(timeout=0.5)
            old.stop()
        finally:
            api.stop()
        seen[client_side] = frames
    assert seen["jax"] == seen["port"] == [("ADDED", "Service", "s"),
                                           ("DELETED", "Service", "s")]


# -- the informer over REST ----------------------------------------------------


def test_running_job_over_rest_reconciles_with_zero_api_calls():
    """Steady state of a RUNNING job over REST: the reflector's watches
    are the only requests (no GET, LIST, PUT, POST or DELETE)."""
    api = port_apiserver.LocalApiServer().start()
    kubelet = LocalKubelet(KubeClient(api.cluster), SimulatedExecutor(delay=3600))
    rest = port_restcluster.RestCluster(api.url)
    jc = TpuJobClient(rest)
    controller = Controller(KubeClient(rest), jc, PS.ControllerConfig(),
                            reconcile_interval=0.05)
    kubelet.start()
    controller.start()
    try:
        j = PS.TpuJob()
        j.metadata.name = "steady"
        j.metadata.namespace = "default"
        j.spec.replica_specs = [PS.TpuReplicaSpec(replica_type="WORKER", replicas=2)]
        jc.create(j)
        deadline = time.monotonic() + 20
        while jc.get("default", "steady").status.phase != PS.TpuJobPhase.RUNNING:
            assert time.monotonic() < deadline, "job never RUNNING"
            time.sleep(0.05)
        time.sleep(0.5)
        before = api.stats
        time.sleep(1.0)  # ~20 reconcile ticks at 0.05 s
        after = api.stats
        delta = {k: after.get(k, 0) - before.get(k, 0)
                 for k in set(before) | set(after) if k[0] != "WATCH"}
        assert {k: v for k, v in delta.items() if v} == {}
    finally:
        controller.stop()
        kubelet.stop()
        api.stop()


# -- the processes and the CLI -------------------------------------------------


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("KTPU_")}
    env["PYTHONPATH"] = str(REPO)
    return env


def test_dev_cluster_processes_run_a_job_to_succeeded(tmp_path, capsys):
    """``python -m k8s_tpu_torch.api.apiserver --port 0 --with-kubelet``,
    two ``python -m k8s_tpu_torch.operator`` processes without
    ``--local`` (one leads, one stands by), and ``kubectl_local
    --server``: create (as a process), then get, logs, describe and
    delete. The job's pod runs ``python -c`` on no card."""
    from k8s_tpu_torch.tools import kubectl_local

    env = _env()
    api = subprocess.Popen(
        [sys.executable, "-m", "k8s_tpu_torch.api.apiserver", "--port", "0",
         "--with-kubelet", "--log-dir", str(tmp_path / "logs")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ops = []
    try:
        url = None
        deadline = time.monotonic() + 30
        while url is None and time.monotonic() < deadline:
            line = api.stdout.readline()
            if line.startswith("serving on "):
                url = line.split()[2]
        assert url, "the apiserver printed no URL"
        for name in ("op-a", "op-b"):
            ops.append(subprocess.Popen(
                [sys.executable, "-m", "k8s_tpu_torch.operator", "--health-port=-1"],
                env={**env, "KTPU_APISERVER_URL": url, "MY_POD_NAMESPACE": "default",
                     "MY_POD_NAME": name},
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        manifest = tmp_path / "job.yaml"
        manifest.write_text(
            "apiVersion: tpu.k8s.io/v1alpha1\nkind: TpuJob\n"
            "metadata: {name: hello, namespace: default}\n"
            "spec:\n  replicaSpecs:\n  - tpuReplicaType: WORKER\n    template:\n"
            "      spec:\n        containers:\n        - name: jax\n          image: i\n"
            "          command: [python, -c, \"print('hello from the pod')\"]\n")
        r = subprocess.run(
            [sys.executable, "-m", "k8s_tpu_torch.tools.kubectl_local", "create",
             "-f", str(manifest), "--timeout", "60", "--server", url],
            env=env, capture_output=True, text=True, timeout=90)
        assert r.returncode == 0 and "state=Succeeded" in r.stdout, r.stdout + r.stderr

        def ktl(*argv):
            capsys.readouterr()
            rc = kubectl_local.main([*argv, "--server", url])
            return rc, capsys.readouterr().out

        rc, out = ktl("get", "tpujobs", "hello")
        assert rc == 0 and "Succeeded" in out, out
        rc, out = ktl("logs", "hello")
        assert rc == 0 and "hello from the pod" in out, out
        rc, out = ktl("describe", "hello")
        assert rc == 0 and "Finished" in out, out
        assert ktl("delete", "hello")[0] == 0
        assert "hello" not in ktl("get")[1]
        lock = port_restcluster.RestCluster(url).get("Endpoints", "default", "tpu-operator")
        holder = lock["metadata"]["annotations"]["control-plane.alpha.kubernetes.io/leader"]
        assert '"holderIdentity": "op-' in holder, holder
    finally:
        for p in ops + [api]:
            p.send_signal(signal.SIGTERM)
        for p in ops + [api]:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
