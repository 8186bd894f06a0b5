"""TpuReplicaSet: materializes one replica group as K8s primitives
(the port's counterpart of ``k8s_tpu/trainer/replicas.py``).

Analogue of reference ``pkg/trainer/replicas.go``: per replica index a
``Service`` (:157-186) and a ``batch/v1 Job`` with Completions=1/
Parallelism=1 (:216-268); env injection into the container named
``jax`` replaces the ``TF_CONFIG`` JSON of :188-255; the default-
launcher ConfigMap replaces the default-PS ConfigMap of :126-150;
Delete by label-selector DeleteCollection mirrors :299-356; per-index
``GetStatus`` with newest-pod + LastTerminationState classification
mirrors :359-492; the ``"%.40s-<type>-<rid>-<i>"`` naming is :494-500.

The difference from the reference is the **rendezvous contract**:
instead of a TensorFlow ClusterSpec the operator emits the process-group
bootstrap the port's launcher reads — ``KTPU_COORDINATOR_ADDRESS`` /
``KTPU_PROCESS_ID`` / ``KTPU_NUM_PROCESSES``, the JAX package's
``KTPU_*`` contract key for key — plus what a GPU gang needs in place of
libtpu's and megascale's env: ``LOCAL_RANK`` (the pod's one card), the
NCCL env, and for a job over several nodes ``GROUP_WORLD_SIZE`` /
``GROUP_RANK`` (nodes, this pod's node: the ``data`` axis of the HSDP
mesh). NCCL collectives are the transport.

A manifest may name the JAX package's launcher or program modules
(``k8s_tpu.launcher.spmd_launcher``, ``KTPU_PROGRAM=k8s_tpu.programs.*``):
one manifest format serves both operators, and this one materializes
each such name as its port counterpart (:func:`port_module_names`), so
no pod it writes runs the JAX package.
"""

from __future__ import annotations

import importlib.util
import json
import logging
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from k8s_tpu_torch.api import errors
from k8s_tpu_torch.api.client import KubeClient
from k8s_tpu_torch.api.objects import (
    ConfigMap,
    ConfigMapVolumeSource,
    Container,
    ContainerPort,
    Job,
    JobSpec,
    ObjectMeta,
    Pod,
    Service,
    ServicePort,
    ServiceSpec,
    Volume,
    VolumeMount,
)
from k8s_tpu_torch.spec import (
    CONTAINER_NAME,
    GPU_WORKER_ENV,
    NotPortedError,
    ReplicaState,
    ReplicaStatus,
    TpuReplicaSpec,
    WORKER,
)
from k8s_tpu_torch.trainer import labels as L
from k8s_tpu_torch.trainer.labels import KubernetesLabels

# fix en route: _retry_transient's on_retry referenced a module logger
# that was never defined — the first teardown retry that actually fired
# would have died on the NameError instead of logging
log = logging.getLogger(__name__)

LAUNCHER_MOUNT_PATH = "/ktpu-launcher"
LAUNCHER_VOLUME = "launcher-config-volume"

# a module of the JAX package named in a manifest, and its port name
_JAX_MODULE = re.compile(r"(?<![\w.])k8s_tpu\.")
PORT_PACKAGE = "k8s_tpu_torch."
# programs of the JAX package the port does not have yet, by ROADMAP item
_UNPORTED_PROGRAMS = {
    "mnist_train": "A9 (other workloads)",
    "resnet_train": "A9 (other workloads)",
    "bert_train": "A9 (other workloads)",
    "router": "A12.5 (the serving fleet and router, with A15)",
}


def port_module_names(text: str) -> str:
    """``text`` with every module path of the JAX package
    (``k8s_tpu.x.y``) named as its counterpart in the port."""
    return _JAX_MODULE.sub(PORT_PACKAGE, text)


def check_program_ported(program: str) -> None:
    """Raise :class:`NotPortedError` when ``KTPU_PROGRAM`` (already in
    port names) names a module the port does not have — the job fails
    at setup with the ROADMAP item, not as a gang of import errors."""
    module = program.split(":")[0]
    if not module.startswith(PORT_PACKAGE):
        return
    try:
        found = importlib.util.find_spec(module) is not None
    except ModuleNotFoundError:
        found = False
    if not found:
        name = module.rsplit(".", 1)[-1]
        item = _UNPORTED_PROGRAMS.get(name, "queue A")
        raise NotPortedError(
            f"program {program!r} is not ported to k8s_tpu_torch yet "
            f"(ROADMAP {item})")


# Objects the gang restart just deleted may linger in the informer cache
# for a beat on the REST path (the cache is watch-fed, eventually
# consistent). Reads filter them by uid for this long; by then the
# DELETE events have long since applied.
TOMBSTONE_TTL = 60.0


@dataclass
class ReplicaSetSnapshot:
    """One-pass view of a replica set: aggregate status plus the
    degraded (retryably-dead) indices, computed from a single read of
    the set's batch Jobs and Pods — the informer-backed successor of
    the reference's per-index GET/LIST loop (replicas.go:432-467),
    which SURVEY §7.2 #4 flags as unscalable, and which round 2
    additionally ran TWICE per tick (get_status + degraded_indices)."""

    status: ReplicaStatus
    degraded: List[int] = field(default_factory=list)


@dataclass
class RendezvousSpec:
    """Everything one process needs to join the process group — the
    analogue of the reference's ``TfConfig{Cluster, Task, Environment}``
    struct (replicas.go:60-72)."""

    coordinator_address: str
    process_id: int
    num_processes: int
    replica_type: str
    task_index: int
    # nodes of the gang and this pod's node (the data axis of HSDP)
    num_slices: int = 1
    slice_id: int = 0
    gpu_worker: bool = False  # a gang WORKER: one card, NCCL env
    cluster: Optional[Dict[str, List[str]]] = None  # full name map (debug/prober)
    tb_log_dir: str = ""  # TpuJob tensorboard.logDir: programs write
    # TB scalar events there (the deployment the operator ships reads it)
    # KTPU_CKPT_* from spec.checkpointPolicy (+ KTPU_CKPT_PEERS: per-
    # index peer shard endpoints) — the multi-tier checkpoint contract
    checkpoint_env: Optional[Dict[str, str]] = None
    # KTPU_ZERO_STAGE / KTPU_COMPILE_CACHE_DIR from spec.training
    training_env: Optional[Dict[str, str]] = None
    # observability contract (spec.observability + the always-on job
    # trace id): KTPU_TRACE_ID, KTPU_TRACE, KTPU_FLIGHT_*, and
    # KTPU_OBS_ADVERTISE (per-index Service DNS the host's obs endpoint
    # binds/advertises)
    obs_env: Optional[Dict[str, str]] = None
    # scheduler terms (spec.scheduling): KTPU_SCHED_QUEUE/_PRIORITY/
    # _PREEMPTIBLE — the same spec→env→program round trip as
    # checkpointPolicy, so a program can see the terms it runs under
    sched_env: Optional[Dict[str, str]] = None

    def to_env(self) -> Dict[str, str]:
        env = {
            "KTPU_COORDINATOR_ADDRESS": self.coordinator_address,
            "KTPU_PROCESS_ID": str(self.process_id),
            "KTPU_NUM_PROCESSES": str(self.num_processes),
            "KTPU_REPLICA_TYPE": self.replica_type.lower(),
            "KTPU_TASK_INDEX": str(self.task_index),
            "KTPU_CLUSTER_SPEC": json.dumps(self.cluster or {}, sort_keys=True),
        }
        if self.gpu_worker:
            env.update(GPU_WORKER_ENV)
        if self.num_slices > 1:
            env["GROUP_WORLD_SIZE"] = str(self.num_slices)
            env["GROUP_RANK"] = str(self.slice_id)
        if self.tb_log_dir:
            env["KTPU_TB_LOGDIR"] = self.tb_log_dir
        if self.checkpoint_env:
            env.update(self.checkpoint_env)
        if self.training_env:
            env.update(self.training_env)
        if self.obs_env:
            env.update(self.obs_env)
        if self.sched_env:
            env.update(self.sched_env)
        return env


class TpuReplicaSet:
    """One replica group of a TrainingJob."""

    def __init__(self, client: KubeClient, spec: TpuReplicaSpec, job):
        # `job` is the owning trainer.TrainingJob (kept loosely typed to
        # avoid an import cycle, as the reference does with TrainingJob*).
        self.client = client
        self.spec = spec
        self.job = job
        # uid -> monotonic deadline; objects this reconciler deleted
        # whose DELETE event may not have reached the cache yet
        self._tombstones: Dict[str, float] = {}

    # ------------------------------------------------------------- cache I/O

    @property
    def _informer(self):
        inf = getattr(self.client, "informer", None)
        if inf is not None and inf.synced:
            return inf
        return None

    def _tombstone(self, objs) -> None:
        deadline = time.monotonic() + TOMBSTONE_TTL
        for o in objs:
            uid = o.metadata.uid if hasattr(o, "metadata") else \
                (o.get("metadata") or {}).get("uid")
            if uid:
                self._tombstones[uid] = deadline

    def _is_tombstoned(self, uid: Optional[str]) -> bool:
        if not uid or not self._tombstones:
            return False
        now = time.monotonic()
        for dead_uid, deadline in list(self._tombstones.items()):
            if deadline < now:
                del self._tombstones[dead_uid]
        return uid in self._tombstones

    def _cached_exists(self, kind: str, name: str) -> bool:
        """True iff the synced informer cache holds a live (non-
        tombstoned) object — the pre-create existence check that makes
        steady-state reconcile write-free."""
        inf = self._informer
        if inf is None:
            return False
        obj = inf.get(kind, self.namespace, name)
        return obj is not None and not self._is_tombstoned(
            (obj.get("metadata") or {}).get("uid")
        )

    # ------------------------------------------------------------- identity

    @property
    def namespace(self) -> str:
        return self.job.job.metadata.namespace

    @property
    def runtime_id(self) -> str:
        return self.job.job.spec.runtime_id

    def job_name(self, index: int) -> str:
        """DNS-label-safe per-index name (reference replicas.go:494-500)."""
        base = self.job.job.metadata.name[:40]
        return f"{base}-{self.spec.replica_type.lower()}-{self.runtime_id}-{index}"

    def default_labels(self) -> KubernetesLabels:
        return KubernetesLabels(
            {
                L.GROUP_LABEL: "",
                L.JOB_TYPE_LABEL: self.spec.replica_type,
                L.RUNTIME_ID_LABEL: self.runtime_id,
                L.JOB_NAME_LABEL: self.job.job.metadata.name,
            }
        )

    def task_labels(self, index: int) -> KubernetesLabels:
        l = self.default_labels()
        l[L.TASK_INDEX_LABEL] = str(index)
        return l

    @property
    def is_gang(self) -> bool:
        """In-mesh replicas (the SPMD gang). Control replicas
        (COORDINATOR/TensorBoard) are not part of the process group and
        keep independent restart semantics."""
        return self.spec.replica_type == WORKER

    # ------------------------------------------------------------- create

    def create(self, config) -> None:
        if self.spec.is_default_launcher:
            self._create_launcher_config_map(config)
        for index in range(self.spec.replicas or 0):
            self._create_service(index)
        for index in range(self.spec.replicas or 0):
            self._create_job(index, config)

    def _create_service(self, index: int) -> None:
        if self._cached_exists("Service", self.job_name(index)):
            return
        ports = [ServicePort(name="ktpu-port", port=self.spec.port)]
        obs = self.job.job.spec.observability
        if (obs is not None and obs.obs_port
                and self.spec.replica_type == WORKER):
            # a ClusterIP forwards only DECLARED ports — the reconciler's
            # straggler polls and operator-side flight-recorder pulls
            # ride this one
            ports.append(ServicePort(name="ktpu-obs", port=obs.obs_port))
        svc = Service(
            metadata=ObjectMeta(
                name=self.job_name(index),
                namespace=self.namespace,
                labels=dict(self.task_labels(index)),
                owner_references=[self.job.job.as_owner()],
            ),
            spec=ServiceSpec(
                selector=dict(self.task_labels(index)),
                ports=ports,
            ),
        )
        try:
            self.client.services.create(svc)
        except errors.AlreadyExistsError:
            pass  # idempotent re-create (reference replicas.go:180-186)

    def _create_job(self, index: int, config=None) -> None:
        if self._cached_exists("Job", self.job_name(index)):
            return
        template = self.spec.template.deepcopy()
        if template.metadata is None:
            template.metadata = ObjectMeta()
        template.metadata.name = self.job_name(index)
        template.metadata.labels = {
            **(template.metadata.labels or {}),
            **self.task_labels(index),
        }
        rdzv = self.rendezvous(index)
        pod_spec = template.spec
        for c in pod_spec.containers:
            if c.name != CONTAINER_NAME:
                continue
            self._port_module_names(c)
            for k, v in rdzv.to_env().items():
                c.set_env(k, v)
            if not any(p.container_port == self.spec.port for p in c.ports):
                c.ports.append(ContainerPort(container_port=self.spec.port, name="ktpu-port"))
            if self.spec.is_default_launcher:
                self._rewrite_launcher_command(c)
                self._ensure_launcher_volume(template)
        # stable DNS inside the gang: pods resolve each other through
        # their per-index Services
        job = Job(
            metadata=ObjectMeta(
                name=self.job_name(index),
                namespace=self.namespace,
                labels=dict(self.task_labels(index)),
                owner_references=[self.job.job.as_owner()],
            ),
            # In-mesh (gang) replicas get backoffLimit=0: a retryable
            # exit is a SLICE event, recovered by the reconciler's
            # whole-gang restart, never by a per-pod batch-Job restart
            # that would leave peers blocked in dead collectives.
            # Control replicas keep per-pod restart semantics.
            spec=JobSpec(completions=1, parallelism=1, template=template,
                         backoff_limit=0 if self.is_gang else None),
        )
        try:
            self.client.jobs.create(job)
        except errors.AlreadyExistsError:
            pass

    @staticmethod
    def _port_module_names(c: Container) -> None:
        """The container's command, args and ``KTPU_PROGRAM`` with the
        JAX package's module names in port names."""
        c.command = [port_module_names(x) for x in c.command]
        c.args = [port_module_names(x) for x in c.args]
        program = c.env_dict().get("KTPU_PROGRAM")
        if program:
            c.set_env("KTPU_PROGRAM", port_module_names(program))

    def check_programs(self) -> None:
        """Raise for a program the port does not have (setup-time)."""
        if self.spec.template is None or self.spec.template.spec is None:
            return
        for c in self.spec.template.spec.containers:
            program = c.env_dict().get("KTPU_PROGRAM")
            if c.name == CONTAINER_NAME and program:
                check_program_ported(port_module_names(program))

    # -- default launcher shipping (reference default-PS ConfigMap,
    # replicas.go:126-150 + command rewrite :205-208) ---------------------

    def launcher_config_map_name(self) -> str:
        return f"cm-launcher-{self.runtime_id}"

    def _create_launcher_config_map(self, config) -> None:
        if self._cached_exists("ConfigMap", self.launcher_config_map_name()):
            return
        from k8s_tpu_torch.launcher import launcher_source

        cm = ConfigMap(
            metadata=ObjectMeta(
                name=self.launcher_config_map_name(),
                namespace=self.namespace,
                labels=dict(self.default_labels()),
                owner_references=[self.job.job.as_owner()],
            ),
            data={"spmd_launcher.py": launcher_source(config)},
        )
        try:
            self.client.config_maps.create(cm)
        except errors.AlreadyExistsError:
            pass

    def _rewrite_launcher_command(self, c: Container) -> None:
        if not any(v.name == LAUNCHER_VOLUME for v in c.volume_mounts):
            c.volume_mounts.append(
                VolumeMount(name=LAUNCHER_VOLUME, mount_path=LAUNCHER_MOUNT_PATH)
            )
        c.command = ["python", f"{LAUNCHER_MOUNT_PATH}/spmd_launcher.py"]

    def _ensure_launcher_volume(self, template) -> None:
        spec = template.spec
        if not any(v.name == LAUNCHER_VOLUME for v in spec.volumes):
            spec.volumes.append(
                Volume(
                    name=LAUNCHER_VOLUME,
                    config_map=ConfigMapVolumeSource(name=self.launcher_config_map_name()),
                )
            )

    # ------------------------------------------------------------- rendezvous

    def rendezvous(self, index: int) -> RendezvousSpec:
        """Compute the bootstrap info for replica ``index`` — the
        successor of ``TfConfig`` build-up at reference
        replicas.go:189-203. The gang's "slices" are its nodes: a
        pod's node is its index over the cards per node."""
        job = self.job
        cluster = job.cluster_spec()
        workers = cluster.get(WORKER.lower(), [])
        num_processes = max(1, len(workers))
        num_slices = job.job.spec.num_nodes()
        per_slice = max(1, num_processes // max(1, num_slices))
        if self.spec.replica_type == WORKER:
            process_id = index
            slice_id = index // per_slice
        else:
            process_id = -1  # control-plane replica; not in the mesh
            slice_id = 0
        if workers:
            coordinator = workers[0]
        else:
            coordinator = f"{self.job_name(0)}:{self.spec.port}"
        return RendezvousSpec(
            coordinator_address=coordinator,
            process_id=process_id,
            num_processes=num_processes,
            replica_type=self.spec.replica_type,
            task_index=index % per_slice if self.spec.replica_type == WORKER else index,
            num_slices=num_slices,
            slice_id=slice_id,
            gpu_worker=self.is_gang,
            cluster=cluster,
            tb_log_dir=(
                self.job.job.spec.tensorboard.log_dir
                if self.job.job.spec.tensorboard is not None else ""
            ),
            checkpoint_env=self._checkpoint_env(workers),
            training_env=(
                job.job.spec.training.to_env()
                if job.job.spec.training is not None else None
            ),
            obs_env=self._obs_env(index),
            sched_env=self._sched_env(),
        )

    def _sched_env(self) -> Optional[Dict[str, str]]:
        """spec.scheduling → KTPU_SCHED_* (docs/SCHEDULER.md), the same
        spec→env→program round trip as checkpointPolicy."""
        sched = self.job.job.spec.scheduling
        return sched.to_env() if sched is not None else None

    def _obs_env(self, index: int) -> Dict[str, str]:
        """The observability contract (docs/OBSERVABILITY.md): EVERY
        replica gets the job trace id (spans/requests from any layer
        join on it); gang WORKERs with an ``observability`` block
        additionally get the tracing knobs and their per-index obs
        advertise address (Service DNS + obsPort — the local kubelet's
        resolver rewrites it to a loopback port, so the subprocess e2e
        exercises the same discovery path a cluster does)."""
        env = {
            "KTPU_TRACE_ID":
                f"{self.job.job.metadata.name}-{self.runtime_id}",
        }
        obs = self.job.job.spec.observability
        if obs is not None and self.spec.replica_type == WORKER:
            env.update(obs.to_env())
            if obs.obs_port:
                env["KTPU_OBS_ADVERTISE"] = \
                    f"{self.job_name(index)}:{obs.obs_port}"
            import os

            # event-driven heartbeats (docs/SCHEDULER.md): when the
            # operator deployment advertises its health endpoint, each
            # host pushes its own stats there instead of being polled
            operator = os.environ.get("KTPU_OPERATOR_HEALTH", "")
            if operator:
                md = self.job.job.metadata
                env["KTPU_OBS_PUSH_URL"] = (
                    f"http://{operator}/v1/heartbeat/"
                    f"{md.namespace}/{md.name}/{index}")
        return env

    def _checkpoint_env(self, workers) -> Optional[Dict[str, str]]:
        """spec.checkpointPolicy → KTPU_CKPT_* (+ per-index peer shard
        endpoints when the REST wire is enabled: the per-index Service
        names the operator already maintains give every host a stable
        DNS address for its peers' local tiers). After a
        ``TrainingDiverged`` verdict the reconciler's restore ceiling
        (``TrainingJob.restore_ceiling`` = the last *healthy* step)
        rides along as ``KTPU_CKPT_RESTORE_MAX_STEP``, so the restarted
        gang's planner never targets a NaN checkpoint
        (docs/OBSERVABILITY.md "Training health")."""
        policy = self.job.job.spec.checkpoint_policy
        env: Dict[str, str] = {} if policy is None else policy.to_env()
        if policy is not None and policy.peer_port \
                and self.spec.replica_type == WORKER:
            env["KTPU_CKPT_PEERS"] = ",".join(
                f"{i}=http://{w.rsplit(':', 1)[0]}:{policy.peer_port}"
                for i, w in enumerate(workers)
            )
        ceiling = getattr(self.job, "restore_ceiling", None)
        if ceiling is not None and self.spec.replica_type == WORKER:
            env["KTPU_CKPT_RESTORE_MAX_STEP"] = str(int(ceiling))
        return env or None

    # ------------------------------------------------------------- delete

    def delete_compute(self) -> None:
        """Gang-restart teardown: bulk-delete this set's batch Jobs and
        Pods but KEEP the per-index Services (stable DNS/ports for the
        re-spawned gang) and the launcher ConfigMap. The kubelet sees
        the Job deletions and terminates the processes — including
        survivors blocked in a dead collective.

        Every deleted object's uid is tombstoned first: on the REST
        path the informer cache only learns of the deletions when the
        watch events arrive, and a stale cached view of the dead gang
        must not be re-classified next tick (double-counting the
        restart budget, or failing the job off a stale exit-1 pod)."""
        jobs, pods = self._list_jobs_and_pods(filter_tombstones=False)
        self._tombstone(jobs)
        self._tombstone(pods)
        sel = dict(self.default_labels())
        # retry transient apiserver errors in-line: a flaked delete
        # here leaves the gang's jobs tombstoned-but-alive — invisible
        # to classification for a whole TOMBSTONE_TTL, wedging the
        # restart — so the delete must be pushed through the blip
        self._retry_transient(
            "gang jobs delete",
            lambda: self.client.jobs.delete_collection(self.namespace, sel))
        self._retry_transient(
            "gang pods delete",
            lambda: self.client.pods.delete_collection(self.namespace, sel))

    def _retry_transient(self, what: str, fn):
        """Unified-backoff retry for teardown writes whose failure
        wedges the gang (see delete_compute); semantic errors surface
        immediately."""
        from k8s_tpu_torch.robustness.backoff import BackoffPolicy, retry_call

        return retry_call(
            fn,
            policy=BackoffPolicy(base=0.1, cap=2.0, jitter=0.5, reset_after=0.0),
            max_attempts=4,
            should_retry=errors.is_transient,
            on_retry=lambda a, e, d: log.warning(
                "%s %s: transient API error (%s); retry in %.2fs",
                self.spec.replica_type, what, e, d),
        )

    def _list_jobs_and_pods(
        self, filter_tombstones: bool = True
    ) -> Tuple[List[Job], List[Pod]]:
        """The replica set's batch Jobs and Pods in TWO label-selector
        reads — from the informer cache when synced (zero apiserver
        calls), else direct LISTs (still O(1) calls, not O(replicas))."""
        sel = dict(self.default_labels())
        inf = self._informer
        if inf is not None:
            jobs = [Job.from_dict(d) for d in inf.list("Job", self.namespace, sel)]
            pods = [Pod.from_dict(d) for d in inf.list("Pod", self.namespace, sel)]
        else:
            jobs = self.client.jobs.list(self.namespace, sel)
            pods = self.client.pods.list(self.namespace, sel)
        if filter_tombstones and self._tombstones:
            jobs = [j for j in jobs if not self._is_tombstoned(j.metadata.uid)]
            pods = [p for p in pods if not self._is_tombstoned(p.metadata.uid)]
        return jobs, pods

    def _index_of(self, obj) -> Optional[int]:
        try:
            return int((obj.metadata.labels or {}).get(L.TASK_INDEX_LABEL))
        except (TypeError, ValueError):
            return None

    def snapshot(self) -> ReplicaSetSnapshot:
        """Status aggregation AND degraded-index detection in one pass
        over one read (reference replicas.go:415-492 + tf_job.go:376-383
        for the histogram; the degraded scan is the gang-restart
        trigger). Degraded = a batch Job marked failed whose newest
        pod's (last) termination is retryable; permanent exits are not
        degraded — they fail the job through the normal status path."""
        from k8s_tpu_torch.trainer.training import is_retryable_termination_state

        jobs, pods = self._list_jobs_and_pods()
        jobs_by_index: Dict[int, Job] = {}
        for j in jobs:
            idx = self._index_of(j)
            if idx is not None:
                jobs_by_index[idx] = j
        pods_by_index: Dict[int, List[Pod]] = {}
        for p in pods:
            idx = self._index_of(p)
            if idx is not None:
                pods_by_index.setdefault(idx, []).append(p)

        states: Dict[str, int] = {}
        degraded: List[int] = []
        for index in range(self.spec.replicas or 0):
            job = jobs_by_index.get(index)
            index_pods = pods_by_index.get(index, [])
            if job is None:
                state = ReplicaState.UNKNOWN
            elif job.status.succeeded >= 1:
                state = ReplicaState.SUCCEEDED
            else:
                state = replica_status_from_pod_list(index_pods, CONTAINER_NAME)
                if self.is_gang and job.status.failed >= 1 and any(
                    self._retryable_death(p, is_retryable_termination_state)
                    for p in index_pods
                ):
                    degraded.append(index)
            states[state] = states.get(state, 0) + 1

        overall = ReplicaState.UNKNOWN
        if states.get(ReplicaState.FAILED, 0) > 0:
            overall = ReplicaState.FAILED
        elif states.get(ReplicaState.RUNNING, 0) > 0:
            overall = ReplicaState.RUNNING
        elif (self.spec.replicas or 0) > 0 and states.get(ReplicaState.SUCCEEDED, 0) == self.spec.replicas:
            overall = ReplicaState.SUCCEEDED
        elif states.get(ReplicaState.STARTING, 0) > 0:
            overall = ReplicaState.STARTING
        return ReplicaSetSnapshot(
            status=ReplicaStatus(
                replica_type=self.spec.replica_type,
                state=overall,
                replicas_states=states,
            ),
            degraded=degraded,
        )

    @staticmethod
    def _retryable_death(pod: Pod, is_retryable) -> bool:
        for cs in pod.status.container_statuses:
            if cs.name != CONTAINER_NAME:
                continue
            term = None
            if cs.state is not None and cs.state.terminated is not None:
                term = cs.state.terminated
            if cs.last_state is not None and cs.last_state.terminated is not None:
                term = cs.last_state.terminated
            if term is not None and term.exit_code != 0 and is_retryable(term):
                return True
        return False

    def delete(self) -> None:
        """Teardown (reference replicas.go:299-356): bulk-delete Jobs and
        Pods by selector, Services per-name, then the launcher ConfigMap."""
        sel = dict(self.default_labels())
        self.client.jobs.delete_collection(self.namespace, sel)
        self.client.pods.delete_collection(self.namespace, sel)
        for index in range(self.spec.replicas or 0):
            try:
                self.client.services.delete(self.namespace, self.job_name(index))
            except errors.NotFoundError:
                pass
        if self.spec.is_default_launcher:
            try:
                self.client.config_maps.delete(self.namespace, self.launcher_config_map_name())
            except errors.NotFoundError:
                pass

    # ------------------------------------------------------------- status

    def get_status(self) -> ReplicaStatus:
        """Aggregate replica-set status (one pass; see snapshot())."""
        return self.snapshot().status


def replica_status_from_pod_list(pods: List[Pod], container_name: str) -> str:
    """Classify the newest pod's named-container state (reference
    ``replicaStatusFromPodList``, replicas.go:359-412). Reference
    semantics preserved exactly:

    - newest pod (by start time) wins;
    - ``LastTerminationState`` takes *precedence* over the current
      state when present (:386-390) — a crash seen after restart still
      drives the classification;
    - terminated exit 0 → Succeeded; retryable exit (128–255, per
      ``is_retryable_termination_state``) → **Running**, because the
      batch-Job controller will restart the container (:398-404);
      permanent exit → Failed;
    - running/waiting → Running; no pods yet → Starting.
    """
    from k8s_tpu_torch.trainer.training import is_retryable_termination_state

    if not pods:
        return ReplicaState.STARTING

    def start_key(p: Pod) -> float:
        return float(p.status.start_time or p.metadata.creation_timestamp or 0)

    newest = max(pods, key=start_key)
    status = None
    for cs in newest.status.container_statuses:
        if cs.name == container_name:
            status = cs
            break
    if status is None:
        return ReplicaState.STARTING
    state = status.state
    if status.last_state is not None and status.last_state.terminated is not None:
        state = status.last_state
    if state is None:
        return ReplicaState.STARTING
    if state.running is not None or state.waiting is not None:
        return ReplicaState.RUNNING
    if state.terminated is not None:
        if state.terminated.exit_code == 0:
            return ReplicaState.SUCCEEDED
        if is_retryable_termination_state(state.terminated):
            return ReplicaState.RUNNING
        return ReplicaState.FAILED
    return ReplicaState.STARTING
