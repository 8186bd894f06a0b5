"""Standalone PyTorch SPMD launcher (port of
``k8s_tpu/launcher/spmd_launcher.py``).

The one program the operator ships into pods. It

1. reads the rendezvous env the operator injected
   (``KTPU_COORDINATOR_ADDRESS`` / ``KTPU_PROCESS_ID`` /
   ``KTPU_NUM_PROCESSES`` and the rest of the contract), into the same
   attribute names as the JAX launcher, plus ``device``: ``"cpu"`` when
   ``KTPU_FORCE_PLATFORM=cpu``, else ``"cuda"``;
2. joins the job's process group: ``torch.distributed`` with NCCL on
   the card and gloo on the CPU, its store at ``tcp://`` +
   ``KTPU_COORDINATOR_ADDRESS`` (worker 0's host:port, where the JAX
   launcher runs its coordination service);
3. runs the program named by ``KTPU_PROGRAM`` (``module:function``),
   or the built-in mesh smoke check, and
4. exits with the operator's retry contract: 0 success, 1 permanent
   user error, EX_RETRYABLE (143) for coordination/bring-up failures
   that a gang restart can fix.

There is no CPU fallback: without ``KTPU_FORCE_PLATFORM=cpu`` the
process needs a card and exits 1 without one. One process drives one
device: card ``LOCAL_RANK`` of its node, else ``KTPU_PROCESS_ID`` modulo
the node's card count (``KTPU_NUM_CPU_DEVICES`` above 1 is refused). ``KTPU_COMPILE_CACHE_DIR`` is parsed into the rendezvous and has
no effect: the port compiles no XLA programs, and its CUDA kernels are
built once per checkout by ``k8s_tpu_torch.ops._kernels``.

This file must stay self-contained (stdlib + torch at module top, any
other import inside a function): it is mounted into images from a
ConfigMap.
"""

from __future__ import annotations

import importlib
import json
import os
import sys
import time

import torch

EX_OK = 0
EX_PERMANENT = 1
EX_RETRYABLE = 143  # SIGTERM-class: operator treats 128-255 as retryable

PLATFORMS = ("", "cpu", "cuda")


class Rendezvous:
    """Parsed rendezvous env (operator contract)."""

    def __init__(self, env=None):
        env = env if env is not None else os.environ
        self.coordinator_address = env.get("KTPU_COORDINATOR_ADDRESS", "")
        self.process_id = int(env.get("KTPU_PROCESS_ID", "0"))
        self.num_processes = int(env.get("KTPU_NUM_PROCESSES", "1"))
        self.replica_type = env.get("KTPU_REPLICA_TYPE", "worker")
        self.task_index = int(env.get("KTPU_TASK_INDEX", "0"))
        # the gang's nodes and this process's node, as the operator
        # writes them for a GPU job (GROUP_*, torchrun's names); the JAX
        # contract's slice keys are read when those are absent
        self.num_slices = int(env.get(
            "GROUP_WORLD_SIZE", env.get("MEGASCALE_NUM_SLICES", "1")))
        self.slice_id = int(env.get(
            "GROUP_RANK", env.get("MEGASCALE_SLICE_ID", "0")))
        try:
            self.cluster = json.loads(env.get("KTPU_CLUSTER_SPEC", "{}"))
        except ValueError:
            self.cluster = {}
        self.program = env.get("KTPU_PROGRAM", "")
        self.program_args = env.get("KTPU_PROGRAM_ARGS", "")
        self.init_timeout = float(env.get("KTPU_INIT_TIMEOUT", "300"))
        # multi-tier checkpoint contract (spec.checkpointPolicy →
        # operator env), parsed here so the contract is visible at the
        # launch boundary; the port's programs do not checkpoint yet
        self.ckpt_local_dir = env.get("KTPU_CKPT_LOCAL_DIR", "")
        self.ckpt_persistent_dir = env.get("KTPU_CKPT_DIR", "")
        self.ckpt_peers = env.get("KTPU_CKPT_PEERS", "")
        try:
            self.ckpt_peer_port = int(env.get("KTPU_CKPT_PEER_PORT", "0"))
        except ValueError:
            self.ckpt_peer_port = 0
        # trainer-mode contract (spec.training → operator env): the ZeRO
        # ladder, the latency-hiding scheduler and the compile cache
        self.zero1 = env.get("KTPU_ZERO1", "") in ("1", "true")
        # ZeRO stage ladder (KTPU_ZERO_STAGE 0..3); a legacy KTPU_ZERO1
        # alone means stage 1, a malformed value degrades the same way
        try:
            self.zero_stage = int(env.get(
                "KTPU_ZERO_STAGE", "1" if self.zero1 else "0"))
        except ValueError:
            self.zero_stage = 1 if self.zero1 else 0
        if not 0 <= self.zero_stage <= 3:
            self.zero_stage = 1 if self.zero1 else 0
        self.zero1 = self.zero1 or self.zero_stage >= 1
        try:
            self.zero3_min_leaf_size = int(
                env.get("KTPU_ZERO3_MIN_LEAF_SIZE", "0"))
        except ValueError:
            self.zero3_min_leaf_size = 0
        self.zero3_leaves = [
            s for s in env.get("KTPU_ZERO3_LEAVES", "").split(",") if s]
        self.latency_hiding = env.get(
            "KTPU_LATENCY_HIDING", "") in ("1", "true")
        self.compile_cache_dir = env.get("KTPU_COMPILE_CACHE_DIR", "")
        # observability contract (spec.observability + the job trace id,
        # consumed by k8s_tpu_torch.obs via programs.common)
        self.trace_id = env.get("KTPU_TRACE_ID", "")
        self.obs_advertise = env.get("KTPU_OBS_ADVERTISE", "")
        self.flight_dir = env.get("KTPU_FLIGHT_DIR", "")
        # the device every program defaults to: the card unless the job
        # asks for the CPU
        self.device = ("cpu" if env.get("KTPU_FORCE_PLATFORM", "") == "cpu"
                       else "cuda")

    @property
    def is_distributed(self):
        return self.num_processes > 1

    @property
    def is_control_replica(self):
        return self.process_id < 0


def local_device_index(env=None) -> int:
    """The card of this process on its node: ``LOCAL_RANK`` when set
    (one process per card, as a GPU node runs them), else
    ``KTPU_PROCESS_ID`` modulo the node's card count."""
    env = env if env is not None else os.environ
    if env.get("LOCAL_RANK", "") != "":
        return int(env["LOCAL_RANK"])
    return int(env.get("KTPU_PROCESS_ID", "0")) % max(1, torch.cuda.device_count())


def configure_platform(env=None):
    """Check the platform overrides before first device use and select
    the card. ``KTPU_FORCE_PLATFORM=cpu`` (CPU smoke jobs) runs on the
    CPU; unset, the process needs a card and takes card
    :func:`local_device_index`. Raises — mapped to the permanent exit
    code by :func:`main` — on an unknown platform, on
    ``KTPU_NUM_CPU_DEVICES`` above 1 on the CPU, when no card is
    visible, and when the index names no card (there is no fallback to
    card 0 or to the CPU)."""
    env = env if env is not None else os.environ
    platform = env.get("KTPU_FORCE_PLATFORM", "")
    if platform not in PLATFORMS:
        raise ValueError(
            f"KTPU_FORCE_PLATFORM={platform!r}: the port runs on "
            f"{' or '.join(p for p in PLATFORMS if p)} only")
    n_cpu = env.get("KTPU_NUM_CPU_DEVICES", "")
    if n_cpu and platform == "cpu" and int(n_cpu) > 1:
        raise ValueError(
            f"KTPU_NUM_CPU_DEVICES={n_cpu}: one process of the port drives "
            "one device; run one process per device")
    if platform == "cpu":
        return
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available "
            "(set KTPU_FORCE_PLATFORM=cpu to run on the CPU)")
    index, count = local_device_index(env), torch.cuda.device_count()
    if not 0 <= index < count:
        raise RuntimeError(
            f"this process's card index {index} (LOCAL_RANK or "
            f"KTPU_PROCESS_ID) names no card: {count} visible")
    torch.cuda.set_device(index)


def _device(rdzv) -> torch.device:
    if rdzv.device == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def initialize_distributed(rdzv):
    """Join the job's process group: NCCL on the card, gloo on the CPU,
    its TCP store at worker 0's ``KTPU_COORDINATOR_ADDRESS``, rank,
    world size and timeout given explicitly. Raises on timeout —
    mapped to the retryable exit code by :func:`main`."""
    if not rdzv.is_distributed:
        return
    import datetime

    import torch.distributed as dist

    kw = {}
    if rdzv.device == "cuda":
        kw["device_id"] = _device(rdzv)
    dist.init_process_group(
        backend="nccl" if rdzv.device == "cuda" else "gloo",
        init_method=f"tcp://{rdzv.coordinator_address}",
        rank=rdzv.process_id,
        world_size=rdzv.num_processes,
        timeout=datetime.timedelta(seconds=rdzv.init_timeout),
        **kw,
    )


def mesh_smoke_check(rdzv):
    """Built-in workload: every process computes its shard of a matmul
    on its device and a SUM all-reduce verifies that every process
    joined — the same check as the JAX launcher's psum over its mesh."""
    dev = _device(rdzv)
    x = torch.ones((8, 16), dtype=torch.float32, device=dev)
    w = torch.full((16, 4), 0.5, dtype=torch.float32, device=dev)
    total = (x @ w).sum()
    n = 1
    if rdzv.is_distributed:
        import torch.distributed as dist

        dist.all_reduce(total, op=dist.ReduceOp.SUM)
        n = dist.get_world_size()
    total = float(total)
    expected = 8.0 * n * 16 * 0.5 * 4
    if abs(total - expected) > 1e-3:
        raise RuntimeError(
            f"mesh smoke check mismatch: got {total}, want {expected} "
            f"across {n} devices"
        )
    if rdzv.process_id <= 0:
        print(
            json.dumps(
                {
                    "event": "smoke_ok",
                    "devices": n,
                    "processes": rdzv.num_processes,
                    "result": total,
                }
            ),
            flush=True,
        )


def run_program(rdzv):
    """Import and call ``module:function(rdzv)`` named by KTPU_PROGRAM."""
    mod_name, _, fn_name = rdzv.program.partition(":")
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, fn_name or "main")
    return fn(rdzv)


# Markers of coordination failures: a peer died and the runtime
# surfaced it as a distributed-layer error. These are SLICE faults a
# gang restart can fix — the exit-code contract must report them
# retryable (143), not as a permanent user error (1). Deliberately
# NARROW: each marker is a phrase the distributed layer emits, not a
# generic word ("timeout", "peer") a user exception might contain — a
# misclassified user error would burn the whole gang-restart budget on
# deterministic failures. The JAX launcher's list, unchanged.
_RETRYABLE_MARKERS = (
    "deadline_exceeded", "deadline exceeded",
    "unavailable:",              # grpc absl::Status: UNAVAILABLE: ...
    "coordination service", "distributed runtime",
    "heartbeat", "preemption",
    "connection reset", "connection refused", "failed to connect",
    "socket closed", "broken pipe",
)


def _retryable_classes():
    """The exception classes that mean a peer or the store went away:
    Python's network errors, and torch.distributed's network and store
    errors (where this torch has them). A CUDA OOM, an illegal address
    or NotImplementedError is none of them."""
    classes = [ConnectionError, TimeoutError]
    import torch.distributed as dist

    for name in ("DistNetworkError", "DistStoreError"):
        cls = getattr(dist, name, None)
        if isinstance(cls, type):
            classes.append(cls)
    return tuple(classes)


def is_retryable_error(e):
    """Classify a program exception: coordination failures → retryable.
    User code errors (shape mismatch, assertion, an unported option)
    stay permanent. Network-layer exceptions are retryable by class;
    other runtime errors only when the message carries a coordination
    marker — a CUDA OOM or illegal address is the user's."""
    if isinstance(e, _retryable_classes()):
        return True
    text = f"{type(e).__name__}: {e}".lower()
    return any(m in text for m in _RETRYABLE_MARKERS)


def _dump_flight(reason):
    """Best-effort flight-recorder dump (k8s_tpu_torch.obs): the
    post-mortem must exist on disk before the process dies, whatever
    kills it — SIGTERM or a crash exit. Never raises and never requires
    the obs package (bare images running the mesh smoke check simply
    skip it)."""
    try:
        from k8s_tpu_torch.obs.trace import dump_default

        return dump_default(reason)
    except Exception:
        return None


def install_preemption_handler():
    """Preemption and node drains arrive as SIGTERM with a grace
    period. The handler only RECORDS the request — flushing a
    checkpoint mid-signal-handler would deadlock on collectives.
    Programs that can use the grace period declare it by setting
    ``KTPU_PREEMPT_AWARE=1``; they poll ``KTPU_PREEMPT_REQUESTED`` at
    step boundaries, flush, and exit EX_RETRYABLE. A program that has
    NOT opted in exits EX_RETRYABLE immediately — swallowing SIGTERM
    there would just burn the grace period doing nothing until
    SIGKILL."""
    import signal

    def handler(signum, frame):
        os.environ["KTPU_PREEMPT_REQUESTED"] = "1"
        print(json.dumps({"event": "preempt_requested"}), flush=True)
        # flush the flight recorder NOW: a program that ignores the
        # flag (or never reaches another step) still leaves its last
        # spans on disk for the post-mortem
        _dump_flight("sigterm")
        if os.environ.get("KTPU_PREEMPT_AWARE") != "1":
            os._exit(EX_RETRYABLE)  # signal-safe

    try:
        signal.signal(signal.SIGTERM, handler)
    except ValueError:
        pass  # not the main thread (in-process test harness)


def _destroy_process_group():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def main(argv=None):
    rdzv = Rendezvous()
    t0 = time.time()
    install_preemption_handler()
    try:
        configure_platform()
    except Exception as e:
        print(f"platform config failed: {e}", file=sys.stderr, flush=True)
        return EX_PERMANENT
    if rdzv.is_control_replica:
        # Control-plane replica (COORDINATOR role): it is not part of
        # the SPMD group; it succeeds immediately unless given a program.
        if rdzv.program:
            try:
                run_program(rdzv)
            except Exception as e:  # user code error → permanent
                print(f"control program failed: {e}", file=sys.stderr, flush=True)
                return EX_PERMANENT
        return EX_OK
    try:
        initialize_distributed(rdzv)
    except Exception as e:
        # Bring-up failure (peer missing, DNS not yet live, store
        # unreachable): a whole-gang restart can fix it.
        print(f"distributed init failed (retryable): {e}", file=sys.stderr, flush=True)
        return EX_RETRYABLE
    try:
        if rdzv.program:
            run_program(rdzv)
        else:
            mesh_smoke_check(rdzv)
        if rdzv.process_id <= 0:
            print(
                json.dumps({"event": "done", "elapsed_s": round(time.time() - t0, 3)}),
                flush=True,
            )
        if rdzv.is_distributed:
            # the work is done and logged: leave the group, then exit
            # without the interpreter's teardown, so that a successful
            # run can never crash in a destructor into a retryable code
            try:
                _destroy_process_group()
            except Exception:
                pass
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(EX_OK)
        return EX_OK
    except Exception as e:
        _dump_flight("crash")
        if is_retryable_error(e):
            # a peer died out from under us mid-collective: the gang
            # restart path recovers this
            print(f"program failed (retryable coordination fault): {e}",
                  file=sys.stderr, flush=True)
            return EX_RETRYABLE
        print(f"program failed: {e}", file=sys.stderr, flush=True)
        return EX_PERMANENT
    finally:
        try:
            if rdzv.is_distributed:
                _destroy_process_group()
        except Exception:
            pass


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
