"""In-process kubelet: runs the pods the operator materializes (the
port's counterpart of ``k8s_tpu/runtime/kubelet.py``, which also plays
the node's GPU device plugin).

Stands in for the node boundary of reference §3.2 ("[kubelet] schedules
pod, starts container `tensorflow`"): watches batch Jobs in the
cluster, creates Pods, executes their ``jax`` container, reflects exit
codes into pod/job status, and applies the batch-Job restart semantics
(retryable exits restart the pod up to a backoff limit, with
``restart_count``/``last_state`` bookkeeping so the operator's
exit-code policy sees crashes that happened before a restart —
reference ``replicas.go:386-390``).

Service DNS does not exist locally, so the kubelet resolves per-index
Service names to loopback ports (`LocalServiceResolver`) before
spawning — the local analogue of kube-dns for the rendezvous contract.

Device plugin: the node's cards (the parent's ``CUDA_VISIBLE_DEVICES``,
else every card CUDA reports, or a count the caller gives) are
handed to pods by their ``nvidia.com/gpu`` limit, from the cards not in
use, through ``CUDA_VISIBLE_DEVICES``; a pod that asks for more than are
free stays ``Pending`` until enough are released. A pod that asks for
none gets ``CUDA_VISIBLE_DEVICES=""`` and sees no card, as on a GPU
node. The kubelet never forces the CPU: ``KTPU_FORCE_PLATFORM=cpu``
reaches a pod only from its manifest or from the executor's
``extra_env``.
"""

from __future__ import annotations

import logging
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from k8s_tpu_torch.api import errors
from k8s_tpu_torch.api.client import KubeClient
from k8s_tpu_torch.api.cluster import WatchEvent
from k8s_tpu_torch.api.objects import (
    ContainerState,
    ContainerStateTerminated,
    ContainerStatus,
    Job,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodStatus,
)
from k8s_tpu_torch.spec import CONTAINER_NAME, GPU_RESOURCE

log = logging.getLogger(__name__)

DEFAULT_BACKOFF_LIMIT = 3
# the pod annotation that records the cards the device plugin gave it
CARDS_ANNOTATION = "tpu.k8s.io/cuda-visible-devices"

# parent of the k8s_tpu_torch package (source tree or install dir)
_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def node_cards(env=None) -> List[str]:
    """The cards of this node, as ``CUDA_VISIBLE_DEVICES`` entries: the
    parent's own ``CUDA_VISIBLE_DEVICES`` when set (an empty value
    means none), else one index per card CUDA reports."""
    env = os.environ if env is None else env
    vis = env.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return [c.strip() for c in vis.split(",") if c.strip()]
    import torch

    return [str(i) for i in range(torch.cuda.device_count())]


def cards_requested(pod_spec) -> int:
    """Cards the pod's containers ask for (``nvidia.com/gpu`` limit,
    else request, summed over containers)."""
    total = 0
    for c in (pod_spec.containers if pod_spec is not None else []):
        res = c.resources
        if res is None:
            continue
        val = res.limits.get(GPU_RESOURCE, res.requests.get(GPU_RESOURCE, 0))
        total += int(val or 0)
    return total


class DevicePlugin:
    """Hands the node's cards to pods: ``take(n)`` returns ``n`` free
    cards (``None`` while fewer are free, or once ``stop`` is set when
    it waits), ``give_back`` returns them."""

    def __init__(self, cards: List[str]):
        self.cards = list(cards)
        self._free = list(cards)
        self._cv = threading.Condition()

    def take(self, n: int, stop: Optional[threading.Event] = None
             ) -> Optional[List[str]]:
        with self._cv:
            while len(self._free) < n:
                if stop is None or stop.is_set():
                    return None
                self._cv.wait(0.1)
            got, self._free = self._free[:n], self._free[n:]
            return got

    def give_back(self, cards: List[str]) -> None:
        if not cards:
            return
        with self._cv:
            self._free.extend(cards)
            self._free.sort(key=self.cards.index)
            self._cv.notify_all()

    def free(self) -> List[str]:
        with self._cv:
            return list(self._free)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class LocalServiceResolver:
    """Maps Service DNS names to loopback endpoints, consistently for
    all pods of a job.

    Ports are keyed by ``(service, original port)``: one Service name
    resolves to one IP on a cluster, and its DECLARED ports are
    distinct listeners behind it. Conflating them into a single
    loopback port (the pre-obs behavior) collided the first time one
    pod served two ports — worker 0's JAX coordinator (``:2222``) and
    its observability endpoint (``:8790``) landed on the same local
    port and the obs listener lost the bind."""

    def __init__(self):
        self._ports: Dict[Tuple[str, int], int] = {}
        self._lock = threading.Lock()

    def port_for(self, service_name: str, port: int = 0) -> int:
        """Local port for ``service_name:port`` (``port=0`` = the
        service's portless mentions)."""
        key = (service_name, int(port))
        with self._lock:
            if key not in self._ports:
                self._ports[key] = _free_port()
            return self._ports[key]

    def rewrite_env(self, env: Dict[str, str], service_names: List[str]) -> Dict[str, str]:
        """Replace ``<svc>:<port>`` with ``127.0.0.1:<localport>`` and
        bare service hostnames with ``127.0.0.1`` in env values."""
        out = dict(env)
        for name in sorted(service_names, key=len, reverse=True):
            for k, v in out.items():
                if name in v:
                    nv = []
                    i = 0
                    while i < len(v):
                        j = v.find(name, i)
                        if j < 0:
                            nv.append(v[i:])
                            break
                        nv.append(v[i:j])
                        rest = v[j + len(name) :]
                        if rest.startswith(":") and \
                                rest[1:2].isdigit():
                            # swallow the original port digits and map
                            # this (service, port) pair's own listener
                            m = len(rest) - len(rest[1:].lstrip("0123456789")) - 1
                            orig = int(rest[1:1 + m])
                            nv.append(
                                f"127.0.0.1:{self.port_for(name, orig)}")
                            i = j + len(name) + 1 + m
                        else:
                            nv.append("127.0.0.1")
                            i = j + len(name)
                    out[k] = "".join(nv)
        return out


class SimulatedExecutor:
    """Unit-test executor: returns a scripted exit code per pod."""

    def __init__(
        self,
        exit_code: int = 0,
        delay: float = 0.0,
        fn: Optional[Callable[[Pod], int]] = None,
    ):
        self.exit_code = exit_code
        self.delay = delay
        self.fn = fn

    def execute(self, pod: Pod, env: Dict[str, str], stop: threading.Event) -> int:
        if self.delay:
            stop.wait(self.delay)
        if self.fn is not None:
            return self.fn(pod)
        return self.exit_code


class SubprocessExecutor:
    """Runs the ``jax`` container's command as a real local subprocess
    with the injected env — the actual data plane, minus containers.
    ``extra_env`` goes under the pod's env (the caller's platform
    overrides, e.g. ``KTPU_FORCE_PLATFORM=cpu`` for CPU tests)."""

    def __init__(self, log_dir: Optional[str] = None, extra_env: Optional[Dict[str, str]] = None):
        self.log_dir = log_dir
        self.extra_env = extra_env or {}
        self._procs: List[subprocess.Popen] = []
        # pod name -> its process (tests and chip_smoke.py signal a pod)
        self.procs: Dict[str, subprocess.Popen] = {}

    def execute(self, pod: Pod, env: Dict[str, str], stop: threading.Event) -> int:
        container = next(c for c in pod.spec.containers if c.name == CONTAINER_NAME)
        cmd = list(container.command) + list(container.args)
        if cmd and cmd[0] == "python":
            cmd[0] = sys.executable
        full_env = {**os.environ, **self.extra_env, **env}
        # a real pod's image has the package installed; the local
        # subprocess must be able to import k8s_tpu_torch (program dispatch,
        # KTPU_PROGRAM=module:fn) even when the parent got it via
        # pytest's rootdir rather than PYTHONPATH
        prev = full_env.get("PYTHONPATH", "")
        if _REPO_ROOT not in prev.split(os.pathsep):
            # APPEND: this is only a fallback for when the package
            # isn't otherwise importable — prepending would shadow a
            # user's own PYTHONPATH overrides with repo_root's contents
            full_env["PYTHONPATH"] = (
                (prev + os.pathsep if prev else "") + _REPO_ROOT
            )
        stdout = None
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            stdout = open(os.path.join(self.log_dir, f"{pod.metadata.name}.log"), "ab")
        try:
            proc = subprocess.Popen(
                cmd, env=full_env, stdout=stdout, stderr=subprocess.STDOUT if stdout else None
            )
            self._procs.append(proc)
            self.procs[pod.metadata.name] = proc
            while proc.poll() is None:
                if stop.is_set():
                    proc.terminate()
                    try:
                        proc.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                    return 143
                time.sleep(0.05)
            rc = proc.returncode
            # container runtimes report death-by-signal as 128+N
            # (SIGKILL -> 137); Popen reports it as -N
            return 128 - rc if rc < 0 else rc
        finally:
            if stdout:
                stdout.close()

    def shutdown(self):
        for p in self._procs:
            if p.poll() is None:
                p.kill()


class LocalKubelet:
    """Watches batch Jobs and runs their pods. ``cards`` is the node's
    card list (or a count, naming cards ``0..n-1``); ``None`` reads it
    from the machine (:func:`node_cards`) at start."""

    def __init__(
        self,
        client: KubeClient,
        executor=None,
        resolver: Optional[LocalServiceResolver] = None,
        cards=None,
    ):
        self.client = client
        self.executor = executor or SimulatedExecutor()
        self.resolver = resolver or LocalServiceResolver()
        if isinstance(cards, int):
            cards = [str(i) for i in range(cards)]
        self._cards = cards
        self.devices: Optional[DevicePlugin] = None
        self._stops: Dict[Tuple[str, str], threading.Event] = {}
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        self._started = False

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self.devices = DevicePlugin(
            self._cards if self._cards is not None else node_cards())
        self.client.cluster.hooks.append(self._on_event)
        # adopt jobs that already exist
        for job in self.client.jobs.list():
            self._maybe_launch(job)

    def stop(self) -> None:
        with self._lock:
            for ev in self._stops.values():
                ev.set()
        if hasattr(self.executor, "shutdown"):
            self.executor.shutdown()
        for t in self._threads:
            t.join(timeout=15)

    def wait_idle(self, timeout: float = 60.0) -> None:
        deadline = time.monotonic() + timeout
        for t in list(self._threads):
            t.join(timeout=max(0.0, deadline - time.monotonic()))

    # ------------------------------------------------------------ events

    def _on_event(self, ev: WatchEvent) -> None:
        if ev.kind != "Job":
            return
        key = (ev.namespace, ev.name)
        if ev.type == "ADDED":
            job = Job.from_dict(ev.object)
            self._maybe_launch(job)
        elif ev.type == "DELETED":
            with self._lock:
                stop = self._stops.get(key)
            if stop is not None:
                stop.set()

    def _maybe_launch(self, job: Job) -> None:
        key = (job.metadata.namespace, job.metadata.name)
        with self._lock:
            existing = self._stops.get(key)
            if existing is not None:
                if existing.is_set():
                    # previous instance of this name is still winding
                    # down (delete->recreate, e.g. a gang restart):
                    # retry once it frees the key
                    t = threading.Timer(0.25, self._relaunch_if_current, args=(job,))
                    t.daemon = True
                    t.start()
                return
            stop = threading.Event()
            self._stops[key] = stop
        t = threading.Thread(
            target=self._run_job, args=(job, stop), daemon=True,
            name=f"kubelet-{job.metadata.name}",
        )
        self._threads.append(t)
        t.start()

    def _relaunch_if_current(self, job: Job) -> None:
        """Deferred retry for a recreated same-name Job: only launch if
        the Job object still exists (it may have been deleted again)."""
        try:
            current = self._retry_api(
                "relaunch job read",
                lambda: self.client.jobs.get(
                    job.metadata.namespace, job.metadata.name))
        except errors.NotFoundError:
            return  # deleted again — nothing to relaunch
        except errors.ApiError:
            # still flaking after the in-line retries: reschedule
            # instead of silently abandoning the recreated Job — an
            # abandoned launch strands the whole gang forever
            t = threading.Timer(0.25, self._relaunch_if_current, args=(job,))
            t.daemon = True
            t.start()
            return
        if current.metadata.uid == job.metadata.uid:
            self._maybe_launch(current)

    # ------------------------------------------------------------ pod runs

    def _run_job(self, job: Job, stop: threading.Event) -> None:
        try:
            self._run_job_inner(job, stop)
        finally:
            # free the key so a recreated batch Job with the same name
            # (gang restart) launches again
            with self._lock:
                self._stops.pop((job.metadata.namespace, job.metadata.name), None)

    def _run_job_inner(self, job: Job, stop: threading.Event) -> None:
        ns = job.metadata.namespace
        # backoffLimit=0 is meaningful (gang replicas: restart is the
        # reconciler's job, not the pod's) — only None means default
        backoff = (DEFAULT_BACKOFF_LIMIT if job.spec.backoff_limit is None
                   else job.spec.backoff_limit)
        restarts = 0
        last_state: Optional[ContainerState] = None
        template = job.spec.template
        wanted = cards_requested(template.spec if template else None)
        while not stop.is_set():
            pod_name = f"{job.metadata.name}-pod-{restarts}"
            cards = self.devices.take(wanted)
            pod = self._create_pod(job, pod_name, restarts, last_state,
                                   cards=cards)
            if pod is None:
                self.devices.give_back(cards or [])
                return
            if cards is None:
                # Pending until the device plugin has the cards
                cards = self.devices.take(wanted, stop=stop)
                if cards is None:
                    return  # deleted while pending
                pod = self._start_pending(ns, pod_name, restarts,
                                          last_state, cards)
                if pod is None:
                    self.devices.give_back(cards)
                    return
            try:
                self._materialize_volumes(pod, ns)
                env = self._pod_env(pod, ns)
                env["CUDA_VISIBLE_DEVICES"] = ",".join(cards)
                exit_code = self.executor.execute(pod, env, stop)
            finally:
                self.devices.give_back(cards)
            killed = self._external_kill_code(ns, pod_name)
            if killed is not None:
                # an external agent (chaos pod-kill, a simulated node
                # failure) marked the pod Failed while we ran it — on a
                # real node the container died with that code and the
                # kubelet reports IT, not the workload's exit status
                exit_code = killed
            terminated = ContainerStateTerminated(exit_code=exit_code)
            self._finish_pod(ns, pod_name, terminated, restarts)
            if exit_code == 0:
                self._update_job_status(ns, job.metadata.name, succeeded=True)
                return
            retryable = 128 <= exit_code <= 255
            last_state = ContainerState(terminated=terminated)
            if not retryable or restarts >= backoff:
                self._update_job_status(ns, job.metadata.name, succeeded=False)
                return
            restarts += 1

    def _external_kill_code(self, ns: str, pod_name: str) -> Optional[int]:
        """Non-zero exit code if something OTHER than this kubelet
        (chaos pod-kill, node-failure simulation) marked the pod Failed
        while its workload ran; None when the pod is untouched/gone."""
        try:
            pod = self._retry_api(
                "kill check read",
                lambda: self.client.pods.get(ns, pod_name))
        except errors.ApiError:
            # gone, or still erroring after the transient retries: an
            # unreadable pod is treated as untouched
            return None
        if pod.status.phase != "Failed":
            return None
        for cs in pod.status.container_statuses:
            t = cs.state.terminated if cs.state else None
            if t is not None and t.exit_code != 0:
                return t.exit_code
        return None

    def _create_pod(
        self, job: Job, pod_name: str, restarts: int,
        last_state: Optional[ContainerState],
        cards: Optional[List[str]] = None,
    ) -> Optional[Pod]:
        """Create the pod: ``Running`` with its cards, or ``Pending``
        with no container status when ``cards`` is None (the device
        plugin has too few free)."""
        template = job.spec.template
        pod = Pod(
            metadata=ObjectMeta(
                name=pod_name,
                namespace=job.metadata.namespace,
                labels=dict((template.metadata.labels if template.metadata else {}) or {}),
                owner_references=[
                    # owned by the batch Job → cascade-deleted with it
                    OwnerReference(
                        api_version="batch/v1", kind="Job",
                        name=job.metadata.name, uid=job.metadata.uid,
                    )
                ],
                creation_timestamp=time.time(),
            ),
            spec=template.spec.deepcopy() if template and template.spec else None,
            status=PodStatus(phase="Pending"),
        )
        if cards is not None:
            self._set_running(pod, restarts, last_state, cards)
        try:
            return self._retry_api(
                "pod create", lambda: self.client.pods.create(pod))
        except errors.AlreadyExistsError:
            return self._retry_api(
                "pod adopt read",
                lambda: self.client.pods.get(job.metadata.namespace, pod_name))
        except errors.ApiError as e:
            log.error("pod create failed: %s", e)
            return None

    @staticmethod
    def _set_running(pod: Pod, restarts: int,
                     last_state: Optional[ContainerState],
                     cards: List[str]) -> None:
        if cards:
            pod.metadata.annotations[CARDS_ANNOTATION] = ",".join(cards)
        pod.status.phase = "Running"
        pod.status.start_time = time.time()
        pod.status.container_statuses = [
            ContainerStatus(
                name=CONTAINER_NAME,
                state=ContainerState(running={"startedAt": time.time()}),
                last_state=last_state,
                restart_count=restarts,
            )
        ]

    def _start_pending(self, ns: str, pod_name: str, restarts: int,
                       last_state: Optional[ContainerState],
                       cards: List[str]) -> Optional[Pod]:
        """A pending pod got its cards: write it Running."""
        try:
            pod = self._retry_api(
                "pending pod read", lambda: self.client.pods.get(ns, pod_name))
            self._set_running(pod, restarts, last_state, cards)
            return self._retry_api(
                "pod start write", lambda: self.client.pods.update(pod))
        except errors.ApiError as e:
            log.error("pod start failed: %s", e)
            return None

    def _materialize_volumes(self, pod: Pod, namespace: str) -> None:
        """Write ConfigMap volumes to local temp dirs and rewrite
        container mount paths — the local stand-in for kubelet volume
        mounting (needed for the default-launcher ConfigMap of
        reference replicas.go:126-150)."""
        import tempfile

        if pod.spec is None:
            return
        mount_map: Dict[str, str] = {}
        for v in pod.spec.volumes:
            if v.config_map is None:
                continue
            try:
                cm = self._retry_api(
                    "configmap read",
                    lambda: self.client.config_maps.get(
                        namespace, v.config_map.name))
            except errors.NotFoundError:
                continue
            d = tempfile.mkdtemp(prefix=f"ktpu-vol-{v.name}-")
            for fname, content in cm.data.items():
                with open(os.path.join(d, fname), "w") as f:
                    f.write(content)
            for c in pod.spec.containers:
                for m in c.volume_mounts:
                    if m.name == v.name:
                        mount_map[m.mount_path] = d
        if mount_map:
            for c in pod.spec.containers:
                c.command = [
                    self._rewrite_path(x, mount_map) for x in c.command
                ]
                c.args = [self._rewrite_path(x, mount_map) for x in c.args]

    @staticmethod
    def _rewrite_path(arg: str, mount_map: Dict[str, str]) -> str:
        for mount, local in mount_map.items():
            if arg.startswith(mount):
                return local + arg[len(mount):]
        return arg

    def _pod_env(self, pod: Pod, namespace: str) -> Dict[str, str]:
        container = next(
            (c for c in (pod.spec.containers if pod.spec else []) if c.name == CONTAINER_NAME),
            None,
        )
        env = container.env_dict() if container else {}
        service_names = [
            s.metadata.name
            for s in self._retry_api(
                "service list", lambda: self.client.services.list(namespace))
        ]
        return self.resolver.rewrite_env(env, service_names)

    def _retry_api(self, what: str, fn):
        """Route a status write through the unified backoff policy: a
        transient apiserver error (real 5xx/429 or a chaos api-flake)
        must not lose the exit-code/succeeded bookkeeping the control
        plane classifies restarts from. Semantic errors (404 etc.)
        surface immediately for the call site to handle."""
        from k8s_tpu_torch.robustness.backoff import BackoffPolicy, retry_call

        return retry_call(
            fn,
            policy=BackoffPolicy(base=0.1, cap=2.0, jitter=0.5, reset_after=0.0),
            max_attempts=4,
            should_retry=errors.is_transient,
            on_retry=lambda a, e, d: log.warning(
                "kubelet %s: transient API error (%s); retry in %.2fs",
                what, e, d),
        )

    def _finish_pod(
        self, ns: str, pod_name: str, terminated: ContainerStateTerminated, restarts: int
    ) -> None:
        try:
            pod = self._retry_api(
                "pod status read", lambda: self.client.pods.get(ns, pod_name))
        except errors.NotFoundError:
            return
        pod.status.phase = "Succeeded" if terminated.exit_code == 0 else "Failed"
        for cs in pod.status.container_statuses:
            if cs.name == CONTAINER_NAME:
                cs.state = ContainerState(terminated=terminated)
                cs.restart_count = restarts
        try:
            self._retry_api(
                "pod status write", lambda: self.client.pods.update(pod))
        except errors.NotFoundError:
            pass

    def _update_job_status(self, ns: str, name: str, succeeded: bool) -> None:
        try:
            job = self._retry_api(
                "job status read", lambda: self.client.jobs.get(ns, name))
        except errors.NotFoundError:
            return
        if succeeded:
            job.status.succeeded += 1
            job.status.active = 0
        else:
            job.status.failed += 1
            job.status.active = 0
        try:
            self._retry_api(
                "job status write", lambda: self.client.jobs.update(job))
        except errors.NotFoundError:
            pass
