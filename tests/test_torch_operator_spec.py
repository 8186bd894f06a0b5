"""The port's operator spec and materializer (``k8s_tpu_torch/spec``,
``trainer/replicas.py``, ``trainer/training.py``'s exit policy), held to
the JAX package's control plane, which imports no JAX on these paths.
Tolerance: exact equality, except the differences each test lists.

- Spec: every manifest in ``examples/`` parses, validates and defaults to
  the same ``to_dict()`` on both sides. The listed differences: the
  accelerator block (``tpu:`` against ``gpu:``) and the WORKER count it
  derives, the defaulted image, and the default launcher module. The
  manifests with a ``tpu:`` block are compared with a GPU block in its
  place; the port refuses them as written, and refuses the serving
  manifests and the ``elastic:`` block with their ROADMAP items.
- Admission: the ``llama_train`` options the port's program refuses
  fail at validation, one test each (ROADMAP A5.4, A7, A8, A9, A10,
  A13), and so do the features of later operator slices at controller
  start (A12.2, A12.3, A12.6, A12.7).
- Materializer: the Services, Jobs, pod templates and ConfigMaps that
  ``TpuReplicaSet.create`` writes for one job, object by object; and no
  object the port writes names the JAX package, over every manifest.
- Exit policy: ``is_retryable_termination_state`` on codes 0-255, with
  and without OOMKilled.
"""

import copy
import json
import pathlib
import re

import pytest
import yaml

from k8s_tpu import spec as JS
from k8s_tpu.api.client import KubeClient as JKubeClient
from k8s_tpu.api.crd_client import TpuJobClient as JTpuJobClient
from k8s_tpu.api.objects import ContainerStateTerminated as JTerminated
from k8s_tpu.trainer.training import TrainingJob as JTrainingJob
from k8s_tpu.trainer.training import \
    is_retryable_termination_state as jax_retryable
from k8s_tpu_torch import spec as PS
from k8s_tpu_torch.api import client as papi_client
from k8s_tpu_torch.api.client import KubeClient as PKubeClient
from k8s_tpu_torch.api.crd_client import TpuJobClient as PTpuJobClient
from k8s_tpu_torch.api.objects import ContainerStateTerminated as PTerminated
from k8s_tpu_torch.controller.controller import Controller as PController
from k8s_tpu_torch.tools import kubectl_local
from k8s_tpu_torch.trainer.training import TrainingJob as PTrainingJob
from k8s_tpu_torch.trainer.training import \
    is_retryable_termination_state as port_retryable
from k8s_tpu_torch import operator as port_operator

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
PORT_EXAMPLES = REPO / "k8s_tpu_torch" / "examples"

AS_WRITTEN = ["tpu_job.yaml", "tpu_job_cpu_smoke.yaml", "tpu_job_defaults.yaml"]
# the GPU block that takes each TPU block's place: the same WORKER count
# where one node holds it (v5e-8: 1 host, v5e-16: 4 hosts); the 32 hosts
# of 2 x v5p-128 become one 8-card node (32 cards would span 4 nodes,
# where the manifest's zeroStage 2 is ROADMAP A5.4)
GPU_FOR = {
    "tpu_job_llama_generate.yaml": {"accelerator": "h100-80gb", "numCards": 1},
    "tpu_job_tensorboard_gcs.yaml": {"accelerator": "h100-80gb", "numCards": 4},
    "tpu_job_v5e_mnist.yaml": {"accelerator": "h100-80gb", "numCards": 1},
    "tpu_job_multislice_llama.yaml": {"accelerator": "h100-80gb", "numCards": 8},
}
JAX_LAUNCHER = ["python", "-m", "k8s_tpu.launcher.spmd_launcher"]
PORT_LAUNCHER = ["python", "-m", "k8s_tpu_torch.launcher.spmd_launcher"]


def _doc(name):
    return yaml.safe_load((EXAMPLES / name).read_text())


def _gpu_doc(name):
    """The manifest with the GPU block in place of its tpu: block; the
    multislice one also without its elastic: block and the latency
    hiding of its training block (ROADMAP A12.4 and A13, refused below)."""
    doc = _doc(name)
    del doc["spec"]["tpu"]
    doc["spec"]["gpu"] = dict(GPU_FOR[name])
    if name == "tpu_job_multislice_llama.yaml":
        del doc["spec"]["elastic"]
        del doc["spec"]["training"]["latencyHiding"]
    return doc


def _defaulted(spec_mod, doc):
    job = spec_mod.TpuJob.from_dict(copy.deepcopy(doc))
    job.spec.set_defaults()
    job.spec.validate()
    d = job.to_dict()
    del d["status"]  # written by the controller (the state-machine tests)
    return d


def _leaves(obj, path=()):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _leaves(v, path + (i,))
    else:
        yield path, obj


def _diff(a, b):
    """{path: (a, b)} of the leaves that differ (a missing leaf is None)."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    return {p: (la.get(p), lb.get(p)) for p in set(la) | set(lb)
            if la.get(p) != lb.get(p)}


def _check_listed(name, doc_jax, doc_port):
    jax_d = _defaulted(JS, doc_jax)
    port_d = _defaulted(PS, doc_port)
    diff = _diff(jax_d, port_d)
    for path, (a, b) in diff.items():
        spec_key = path[1] if path[:1] == ("spec",) else None
        if spec_key in ("tpu", "gpu"):
            continue  # the accelerator block itself
        if path == ("spec", "jaxImage"):
            assert (a, b) == (JS.DEFAULT_IMAGE, PS.DEFAULT_IMAGE)
            continue
        if spec_key == "replicaSpecs":
            i = path[2]
            r_jax = jax_d["spec"]["replicaSpecs"][i]
            if path[3:] == ("replicas",):
                # the WORKER count derived from the accelerator block
                assert r_jax["tpuReplicaType"] == "WORKER"
                assert "replicas" not in doc_port["spec"]["replicaSpecs"][i]
                assert b == doc_port["spec"]["gpu"]["numCards"]
                continue
            if r_jax.get("isDefaultLauncher"):
                tail = path[3:]
                if tail[:5] == ("template", "spec", "containers", 0, "command"):
                    assert jax_d_cmd(jax_d, i) == JAX_LAUNCHER
                    assert jax_d_cmd(port_d, i) == PORT_LAUNCHER
                    continue
                if tail == ("template", "spec", "containers", 0, "image"):
                    assert (a, b) == (JS.DEFAULT_IMAGE, PS.DEFAULT_IMAGE)
                    continue
        raise AssertionError(f"{name}: unlisted difference at {path}: {a!r} vs {b!r}")
    return jax_d, port_d


def jax_d_cmd(d, i):
    return d["spec"]["replicaSpecs"][i]["template"]["spec"]["containers"][0]["command"]


@pytest.mark.parametrize("name", AS_WRITTEN)
def test_examples_as_written_default_alike(name):
    _check_listed(name, _doc(name), _doc(name))


@pytest.mark.parametrize("name", sorted(GPU_FOR))
def test_examples_with_a_gpu_block_default_alike(name):
    jax_doc = _doc(name)
    if name == "tpu_job_multislice_llama.yaml":
        del jax_doc["spec"]["elastic"]
        del jax_doc["spec"]["training"]["latencyHiding"]
    jax_d, port_d = _check_listed(name, jax_doc, _gpu_doc(name))
    assert port_d["spec"]["gpu"] == {**GPU_FOR[name]}
    assert "tpu" in jax_d["spec"] and "tpu" not in port_d["spec"]


@pytest.mark.parametrize("name", sorted(GPU_FOR))
def test_port_refuses_the_tpu_block_naming_the_gpu_block(name):
    doc = _doc(name)
    if name == "tpu_job_multislice_llama.yaml":
        del doc["spec"]["elastic"]
    job = PS.TpuJob.from_dict(doc)
    job.spec.set_defaults()
    with pytest.raises(PS.ValidationError, match=r"tpu: block.*gpu: block"):
        job.spec.validate()


@pytest.mark.parametrize("name,what", [
    ("tpu_job_serving.yaml", r"spec\.serving:"),
    ("tpu_job_serving_disagg.yaml", r"spec\.serving\.disaggregation:"),
])
def test_serving_manifests_refused_with_their_roadmap_item(name, what):
    job = PS.TpuJob.from_dict(_doc(name))
    job.spec.set_defaults()
    with pytest.raises(PS.NotPortedError, match=what + r".*ROADMAP A12\.5"):
        job.spec.validate()
    assert isinstance(PS.NotPortedError("x"), NotImplementedError)


def test_elastic_block_refused_with_its_roadmap_item():
    for doc in (_doc("tpu_job_multislice_llama.yaml"),
                {**_gpu_doc("tpu_job_multislice_llama.yaml")}):
        doc["spec"]["elastic"] = {"minDpDegree": 1, "maxDpDegree": 2}
        job = PS.TpuJob.from_dict(doc)
        job.spec.set_defaults()
        with pytest.raises(PS.NotPortedError, match=r"elastic.*ROADMAP A12\.4"):
            job.spec.validate()


# -- admission: what the port's llama_train refuses --------------------------


def _llama_gpu(cards=8, args=None, training=None, accelerator="h100-80gb"):
    doc = yaml.safe_load((PORT_EXAMPLES / "gpu_job_llama.yaml").read_text())
    doc["spec"]["gpu"] = {"accelerator": accelerator, "numCards": cards}
    env = doc["spec"]["replicaSpecs"][0]["template"]["spec"]["containers"][0]["env"]
    if args is not None:
        next(e for e in env if e["name"] == "KTPU_PROGRAM_ARGS")["value"] = args
    if training is not None:
        doc["spec"]["training"] = training
    job = PS.TpuJob.from_dict(doc)
    job.spec.set_defaults()
    return job


@pytest.mark.parametrize("strategy", ["fsdp", "fsdp_tp"])
@pytest.mark.parametrize("stage_from", ["spec", "flag"])
def test_zero_on_several_nodes_under_fsdp_refused_a5_4(strategy, stage_from):
    args = f"--model=llama3-8b --strategy={strategy}"
    training = {"zeroStage": 1}
    if stage_from == "flag":
        args += " --zero_stage=2"
        training = None
    # 16 cards of 8-card nodes: 2 nodes, the data axis of an HSDP mesh
    with pytest.raises(PS.NotPortedError, match=r"2 nodes.*ROADMAP A5\.4"):
        _llama_gpu(16, args, training).spec.validate()
    # one node, or the dp strategy, or ZeRO off: accepted
    _llama_gpu(8, args, training).spec.validate()
    _llama_gpu(16, "--model=llama3-8b --strategy=dp --zero_stage=2").spec.validate()
    _llama_gpu(16, f"--model=llama3-8b --strategy={strategy}").spec.validate()


def test_multislice_manifest_on_32_cards_refused_a5_4():
    doc = _gpu_doc("tpu_job_multislice_llama.yaml")
    doc["spec"]["gpu"]["numCards"] = 32
    job = PS.TpuJob.from_dict(doc)
    job.spec.set_defaults()
    with pytest.raises(PS.NotPortedError, match=r"zeroStage 2 with 4 nodes.*A5\.4"):
        job.spec.validate()


@pytest.mark.parametrize("strategy,item", [
    ("pp", "A8"), ("pp_fsdp", "A8"), ("fsdp_tp_sp", "A7")])
def test_unported_strategies_refused(strategy, item):
    with pytest.raises(PS.NotPortedError,
                       match=rf"strategy='{strategy}'.*ROADMAP {item}"):
        _llama_gpu(8, f"--model=llama3-8b --strategy={strategy}").spec.validate()


@pytest.mark.parametrize("flag,item", [
    ("--quant=int8", "A10"), ("--num_experts=8", "A9"),
    ("--num-experts=8", "A9")])
def test_quantized_training_and_experts_refused(flag, item):
    with pytest.raises(PS.NotPortedError, match=rf"ROADMAP {item}"):
        _llama_gpu(8, f"--model=llama3-8b {flag}").spec.validate()


def test_latency_hiding_refused_a13():
    with pytest.raises(PS.NotPortedError, match=r"latencyHiding.*ROADMAP A13"):
        _llama_gpu(8, training={"latencyHiding": True}).spec.validate()
    # the multislice manifest with its training block whole
    doc = _gpu_doc("tpu_job_multislice_llama.yaml")
    doc["spec"]["training"]["latencyHiding"] = True
    job = PS.TpuJob.from_dict(doc)
    job.spec.set_defaults()
    with pytest.raises(PS.NotPortedError, match="A13"):
        job.spec.validate()


def test_admission_mirrors_the_programs_refusals():
    """The admission table is the program's: every strategy and option
    ``llama_train._check_unported`` refuses is refused here too."""
    from k8s_tpu_torch.programs import llama_train
    from k8s_tpu_torch.spec import tpu_job

    assert tpu_job._UNPORTED_STRATEGIES == llama_train._UNPORTED_STRATEGIES
    program = {key: (off, item) for key, _, off, item in llama_train._UNPORTED}
    admission = {key: (off, item) for key, off, item in tpu_job._UNPORTED_OPTIONS}
    assert admission == {k: v for k, v in program.items() if k != "latency_hiding"}
    assert program["latency_hiding"][1].startswith("A13")


def test_gpu_block_checks():
    for cards, msg in ((0, "numCards must be >= 1"),
                       (12, "takes whole nodes")):
        job = _llama_gpu(8)
        job.spec.gpu.num_cards = cards
        job.spec.replica_specs[0].replicas = cards
        with pytest.raises(PS.ValidationError, match=msg):
            job.spec.validate()
    with pytest.raises(PS.ValidationError, match="unknown gpu.accelerator"):
        _llama_gpu(8, accelerator="v5e-8").spec.validate()
    job = _llama_gpu(8)
    job.spec.replica_specs[0].replicas = 4
    with pytest.raises(PS.ValidationError, match="must equal gpu.numCards = 8"):
        job.spec.validate()
    assert _llama_gpu(16).spec.num_nodes() == 2
    assert _llama_gpu(3, accelerator="h100-80gb-x1").spec.num_nodes() == 3


@pytest.mark.parametrize("example", ["gpu_job_llama.yaml", "gpu_job_cpu_tiny.yaml"])
def test_port_examples_validate(example, capsys):
    assert kubectl_local.main(["validate", "-f", str(PORT_EXAMPLES / example)]) == 0
    assert "valid TpuJob" in capsys.readouterr().out


# -- refusals at controller start --------------------------------------------


def test_controller_start_refusals(monkeypatch):
    cl = PKubeClient()
    with pytest.raises(NotImplementedError, match=r"ROADMAP A12\.3"):
        PController(cl, PTpuJobClient(cl.cluster), PS.ControllerConfig(fleet={"h100-80gb": 2}))
    with pytest.raises(NotImplementedError, match=r"ROADMAP A12\.7"):
        PController(cl, PTpuJobClient(cl.cluster),
                    PS.ControllerConfig(use_native_supervisor=True))
    with pytest.raises(NotImplementedError, match=r"ROADMAP A12\.2"):
        port_operator.main(["--health-port=-1"])
    with pytest.raises(NotImplementedError, match=r"ROADMAP A12\.6"):
        port_operator.main(["--local", "--chaos-level=0", "--health-port=-1"])
    with pytest.raises(NotImplementedError, match=r"ROADMAP A12\.2"):
        kubectl_local.main(["--server", "http://127.0.0.1:1", "get"])
    monkeypatch.setenv("KTPU_APISERVER_URL", "http://127.0.0.1:1")
    with pytest.raises(NotImplementedError, match=r"ROADMAP A12\.2"):
        papi_client.get_cluster_client()


# -- exit policy --------------------------------------------------------------


@pytest.mark.parametrize("reason", ["", "OOMKilled", "Error", "Completed"])
def test_exit_policy_equal_on_0_to_255(reason):
    got = [port_retryable(PTerminated(exit_code=c, reason=reason)) for c in range(256)]
    want = [jax_retryable(JTerminated(exit_code=c, reason=reason)) for c in range(256)]
    assert got == want
    if reason == "OOMKilled":
        assert not any(got)
    else:
        assert got == [c >= 128 for c in range(256)]


# -- the materializer ----------------------------------------------------------

RUNTIME_ID = "ab12"


def _materialize(side, doc):
    """Setup + create_resources of one job on a fresh in-memory cluster;
    every object written, as dicts by kind."""
    kube, crd, training, spec_mod = side
    client = kube()
    jc = crd(client.cluster)
    job = jc.create(spec_mod.TpuJob.from_dict(copy.deepcopy(doc)))
    tj = training(client, jc, job)
    config = spec_mod.ControllerConfig()
    tj.setup(config)
    assert tj.status.phase == spec_mod.TpuJobPhase.CREATING, tj.status.reason
    tj.create_resources(config)
    out = {}
    for kind, res in (("Service", client.services), ("Job", client.jobs),
                      ("ConfigMap", client.config_maps),
                      ("Deployment", client.deployments)):
        out[kind] = {o.metadata.name: o.to_dict() for o in res.list("default")}
    return out, job.metadata.uid


JAX_SIDE = (JKubeClient, JTpuJobClient, JTrainingJob, JS)
PORT_SIDE = (PKubeClient, PTpuJobClient, PTrainingJob, PS)


def _materializer_job(accel):
    """COORDINATOR + 2 WORKERs on two nodes (JAX: 2 single-host v5e-8
    slices; port: 2 one-card nodes), every env-carrying spec block."""
    doc = {
        "apiVersion": "tpu.k8s.io/v1alpha1", "kind": "TpuJob",
        "metadata": {"name": "mat", "namespace": "default"},
        "spec": {
            "RuntimeId": RUNTIME_ID,
            "jaxImage": "img",
            "checkpointPolicy": {"localDir": "/scratch/ckpt", "localIntervalSteps": 5,
                                 "persistentDir": "/ckpt", "persistentIntervalSteps": 50,
                                 "peerPort": 8900},
            "training": {"zeroStage": 1, "compileCacheDir": "/cache"},
            "observability": {"obsPort": 8790, "flightRecorderDir": "/scratch/fr"},
            "scheduling": {"priority": 5, "queue": "research"},
            "tensorboard": {"logDir": "/logs/tb"},
            "replicaSpecs": [
                {"tpuReplicaType": "COORDINATOR", "replicas": 1,
                 "template": {"spec": {"containers": [{
                     "name": "jax", "image": "img",
                     "command": ["python", "-m", "k8s_tpu.launcher.spmd_launcher"]}]}}},
                {"tpuReplicaType": "WORKER", "template": {"spec": {"containers": [{
                    "name": "jax", "image": "img",
                    "command": ["python", "-m", "k8s_tpu.launcher.spmd_launcher"],
                    "env": [{"name": "KTPU_PROGRAM",
                             "value": "k8s_tpu.programs.llama_train:main"},
                            {"name": "KTPU_PROGRAM_ARGS",
                             "value": "--strategy=dp --steps=4"}]}]}}},
            ],
        },
    }
    if accel == "tpu":
        doc["spec"]["tpu"] = {"accelerator": "v5e-8", "numSlices": 2}
    else:
        doc["spec"]["gpu"] = {"accelerator": "h100-80gb-x1", "numCards": 2}
    return doc


def _normalize(obj, uid):
    """Cluster-assigned identity out: uid, resourceVersion, timestamps;
    the owner's uid becomes a placeholder."""
    obj = copy.deepcopy(obj)
    md = obj["metadata"]
    for k in ("uid", "resourceVersion", "creationTimestamp"):
        md.pop(k, None)
    for ref in md.get("ownerReferences", []):
        assert ref["uid"] == uid
        ref["uid"] = "<owner>"
    return obj


def _env(c):
    return {e["name"]: e.get("value") for e in c.get("env", [])}


def test_materialized_objects_equal_but_the_listed_differences():
    jax_objs, jax_uid = _materialize(JAX_SIDE, _materializer_job("tpu"))
    port_objs, port_uid = _materialize(PORT_SIDE, _materializer_job("gpu"))
    for kind in ("Service", "Job", "ConfigMap", "Deployment"):
        assert set(jax_objs[kind]) == set(port_objs[kind]), kind
    assert len(port_objs["Job"]) == 3 and len(port_objs["Service"]) == 4
    for name, svc in jax_objs["Service"].items():
        assert _normalize(svc, jax_uid) == _normalize(port_objs["Service"][name], port_uid)
    for name, dep in jax_objs["Deployment"].items():
        assert _normalize(dep, jax_uid) == _normalize(port_objs["Deployment"][name], port_uid)
    for name, cm in jax_objs["ConfigMap"].items():
        a, b = _normalize(cm, jax_uid), _normalize(port_objs["ConfigMap"][name], port_uid)
        # listed: the launcher source each operator ships
        assert a.pop("data").keys() == b.pop("data").keys() == {"spmd_launcher.py"}
        assert a == b
    for name, jax_job in jax_objs["Job"].items():
        a = _normalize(jax_job, jax_uid)
        b = _normalize(port_objs["Job"][name], port_uid)
        pa, pb = a["spec"]["template"]["spec"], b["spec"]["template"]["spec"]
        ca, cb = pa["containers"][0], pb["containers"][0]
        ea, eb = _env(ca), _env(cb)
        worker = "-worker-" in name
        # the KTPU_* contract key for key; KTPU_PROGRAM in port names
        ka = {k: v for k, v in ea.items() if k.startswith("KTPU_")}
        kb = {k: v for k, v in eb.items() if k.startswith("KTPU_")}
        assert ka.keys() == kb.keys()
        for k in ka:
            if k == "KTPU_PROGRAM":
                assert kb[k] == ka[k].replace("k8s_tpu.", "k8s_tpu_torch.")
            else:
                assert ka[k] == kb[k], k
        # listed: TPU_*/MEGASCALE_* against LOCAL_RANK/NCCL/GROUP_*
        other_a = {k: v for k, v in ea.items() if not k.startswith("KTPU_")}
        other_b = {k: v for k, v in eb.items() if not k.startswith("KTPU_")}
        assert set(other_a) <= {"TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES", "TPU_ACCELERATOR_TYPE",
                                "TPU_CHIPS_PER_HOST_BOUNDS", "MEGASCALE_NUM_SLICES",
                                "MEGASCALE_SLICE_ID", "MEGASCALE_COORDINATOR_ADDRESS"}
        if worker:
            idx = int(name.rsplit("-", 1)[1])
            assert other_b == {**PS.GPU_WORKER_ENV, "GROUP_WORLD_SIZE": "2",
                               "GROUP_RANK": str(idx)}
            assert other_a["MEGASCALE_SLICE_ID"] == str(idx)
            # listed: the resource name and count, the node selectors
            assert ca["resources"] == {"limits": {"google.com/tpu": 8},
                                       "requests": {"google.com/tpu": 8}}
            assert cb["resources"] == {"limits": {"nvidia.com/gpu": 1},
                                       "requests": {"nvidia.com/gpu": 1}}
            assert pb["nodeSelector"] == {"nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3",
                                          "nvidia.com/gpu.count": "1"}
            assert set(pa["nodeSelector"]) == {"cloud.google.com/gke-tpu-accelerator",
                                               "cloud.google.com/gke-tpu-topology"}
        else:
            # a control replica: no card; the node count, as JAX gives
            # it the megascale slice count
            assert other_b == {"GROUP_WORLD_SIZE": "2", "GROUP_RANK": "0"}
            assert other_a["MEGASCALE_NUM_SLICES"] == "2"
        # listed: the command, in port names
        assert ca["command"] == JAX_LAUNCHER and cb["command"] == PORT_LAUNCHER
        for c in (ca, cb):
            c.pop("env"), c.pop("command"), c.pop("resources", None)
        pa.pop("nodeSelector", None), pb.pop("nodeSelector", None)
        assert a == b, name


_JAX_NAME = re.compile(r"(?<![\w.])k8s_tpu\.")


def _all_manifests():
    """Every manifest of the spec tests, as the port accepts it."""
    docs = {n: _doc(n) for n in AS_WRITTEN}
    docs.update({n: _gpu_doc(n) for n in GPU_FOR})
    for n in ("gpu_job_llama.yaml", "gpu_job_cpu_tiny.yaml"):
        docs[n] = yaml.safe_load((PORT_EXAMPLES / n).read_text())
    docs["materializer"] = _materializer_job("gpu")
    return docs


@pytest.mark.parametrize("name", sorted(_all_manifests()))
def test_no_object_the_operator_writes_names_the_jax_package(name):
    doc = _all_manifests()[name]
    if name == "tpu_job_v5e_mnist.yaml":
        # mnist_train is not in the port: setup fails it by name instead
        cl = PKubeClient()
        jc = PTpuJobClient(cl.cluster)
        tj = PTrainingJob(cl, jc, jc.create(PS.TpuJob.from_dict(doc)))
        tj.setup(PS.ControllerConfig())
        assert tj.status.phase == PS.TpuJobPhase.FAILED
        assert re.search(r"mnist_train.*ROADMAP A9", tj.status.reason)
        return
    objs, _ = _materialize(PORT_SIDE, doc)
    assert objs["Job"]
    text = json.dumps(objs)
    assert not _JAX_NAME.search(text), _JAX_NAME.findall(text)
    for job in objs["Job"].values():
        for c in job["spec"]["template"]["spec"]["containers"]:
            program = _env(c).get("KTPU_PROGRAM", "k8s_tpu_torch.")
            assert program.startswith("k8s_tpu_torch."), program
            assert any("k8s_tpu_torch" in x or x.endswith("spmd_launcher.py")
                       or x == "true" for x in c["command"]), c["command"]
    for cm in objs["ConfigMap"].values():
        assert "k8s_tpu_torch." in cm["data"]["spmd_launcher.py"]
