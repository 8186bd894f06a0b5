"""Checkpoint / resume: the persistent tier (port of
``k8s_tpu/train/checkpoint.py``) on ``torch.distributed.checkpoint``
(DCP) in place of orbax.

A state is a flat ``{path: tensor}`` dict (``train.trainer_lib.
state_tree``). Each step is written to a directory of its own,
``<directory>/<step>``, and DCP's ``.metadata`` file — written last — is
the commit point: a directory without it is an interrupted save,
invisible to :meth:`all_steps` and removed by the next save of that
step. A replicated state is written by one process (DCP with
``no_dist``: every rank holds the whole state, so process 0 writes); a
state with a sharded leaf (a ``DTensor``: FSDP2, a ZeRO slice) in a
process group is written and read by every rank through DCP's collective
path, each rank its own shards, on the manager's ``process_group`` (a
gloo group of its own, so a save on the committer thread never meets the
training thread's collectives). DCP reshards on load: a sharded
checkpoint loads into a whole template in one process (serving's
restore) and a replicated one into a sharded template. Restores load IN
PLACE into the template's tensors (their devices and dtypes; a bfloat16
template of an f32 checkpoint gets the values rounded by ``copy_``).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import shutil
import threading
import warnings
from typing import Callable, Dict, List, Optional

import torch

from k8s_tpu_torch.robustness.backoff import BackoffPolicy, retry_call

log = logging.getLogger(__name__)

# Save-retry schedule: a transient FS hiccup is retried through the
# shared policy instead of losing the checkpoint.
SAVE_RETRY_POLICY = BackoffPolicy(
    base=0.2, factor=2.0, cap=5.0, jitter=0.5, reset_after=0.0
)
SAVE_RETRY_ATTEMPTS = 4
METADATA = ".metadata"

# Chaos fault hook: called with the step at the top of every save
# attempt; raising makes the attempt fail. Fault tests only.
_save_fault_lock = threading.Lock()
SAVE_FAULT_HOOK: Optional[Callable[[int], None]] = None


def arm_save_faults(n: int, exc: Optional[Exception] = None) -> None:
    """Make the next ``n`` save attempts (process-wide) raise. ``n=0``
    disarms."""
    global SAVE_FAULT_HOOK
    remaining = {"n": n}

    def hook(step: int) -> None:
        with _save_fault_lock:
            if remaining["n"] <= 0:
                return
            remaining["n"] -= 1
        raise exc if exc is not None else OSError(
            f"chaos: injected checkpoint-save failure at step {step}"
        )

    SAVE_FAULT_HOOK = hook if n > 0 else None


def gang_reduce(value: int, op: str = "max") -> int:
    """``value`` reduced over the process group (``"max"`` or ``"min"``)
    with one ``all_reduce``; ``value`` itself without a process group.
    Every process must call it at the same point (the training thread,
    between steps)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return int(value)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.MIN)
    return int(t.item())


@contextlib.contextmanager
def _single_process():
    """DCP in this process alone (``no_dist``), without its warning that
    it assumes so; DCP's ``CheckpointException`` (a ``BaseException``,
    which ``except Exception`` handlers and the save retry would let
    through) re-raised as a ``RuntimeError``."""
    from torch.distributed.checkpoint.api import CheckpointException

    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message="torch.distributed is disabled")
        try:
            yield
        except CheckpointException as e:
            raise RuntimeError(f"torch.distributed.checkpoint failed: {e}") from None


def _is_sharded(state: Dict[str, torch.Tensor]) -> bool:
    """Whether the state holds a sharded leaf and a process group exists:
    then it is saved and loaded by every rank together."""
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and any(hasattr(t, "placements") for t in state.values()))


class CheckpointManager:
    """The persistent tier: DCP saves of the flat state under
    ``directory/<step>``, ``max_to_keep`` of them."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1,
                 max_restore_step: Optional[int] = None,
                 writer: bool = True, process_group=None):
        self.directory = directory
        # one writer per gang for a replicated state: it is the same on
        # every process, so process 0 writes and the others' saves are
        # no-ops (every process restores); a sharded state is written
        # by every rank on this group
        self.writer = writer
        self.process_group = process_group
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(1, int(save_interval_steps))
        # restore ceiling ("last healthy step"): default-step restores
        # never pick a step past it
        self.max_restore_step = max_restore_step
        self._preemption_poll_broken = False
        # seconds of the last save / load (the DCP call's wall)
        self.last_save_s: Optional[float] = None
        self.last_load_s: Optional[float] = None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, state: Dict[str, torch.Tensor],
             force: bool = False, unhealthy=None) -> bool:
        """Write ``state`` at ``step`` (synchronously; the multi-tier
        manager runs routed saves on its committer thread). False when
        the step is committed already, off the save interval (unless
        ``force``), or ``unhealthy()`` says the state is poisoned. A
        sharded state: every rank calls it at the same step."""
        sharded = _is_sharded(state)
        if (not self.writer and not sharded) or step in self.all_steps():
            return False  # not this process's to write, or written
        if not force and step % self.save_interval_steps:
            return False
        if unhealthy is not None and unhealthy():
            # the never-checkpoint-a-poisoned-state gate (evaluating it
            # syncs the device: callers pass it only where a write
            # would happen)
            print(json.dumps({"event": "ckpt_skip_unhealthy",
                              "step": step}), flush=True)
            return False

        if sharded:
            # collective: one attempt (a retry would have to be the
            # gang's), the stale directory removed by rank 0 alone
            self._save_collective(step, state)
            self._retain()
            return True

        def attempt() -> bool:
            import time

            import torch.distributed.checkpoint as dcp

            if SAVE_FAULT_HOOK is not None:
                SAVE_FAULT_HOOK(step)
            path = self.step_dir(step)
            # a directory without .metadata is an interrupted save
            shutil.rmtree(path, ignore_errors=True)
            t0 = time.perf_counter()
            with _single_process():
                dcp.save(dict(state), checkpoint_id=path, no_dist=True)
            self.last_save_s = time.perf_counter() - t0
            return True

        ok = retry_call(
            attempt,
            policy=SAVE_RETRY_POLICY,
            max_attempts=SAVE_RETRY_ATTEMPTS,
            on_retry=lambda a, e, d: log.warning(
                "checkpoint save step %d attempt %d failed (%s: %s); "
                "retry in %.2fs", step, a, type(e).__name__, e, d),
        )
        self._retain()
        return ok

    def _save_collective(self, step: int, state) -> None:
        import time

        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp

        path = self.step_dir(step)
        if dist.get_rank() == 0:
            shutil.rmtree(path, ignore_errors=True)
        dist.barrier(group=self.process_group)
        t0 = time.perf_counter()
        with _single_process():
            dcp.save(dict(state), checkpoint_id=path,
                     process_group=self.process_group)
        self.last_save_s = time.perf_counter() - t0

    def _retain(self) -> None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() \
                and dist.get_rank() != 0:
            return  # the directory is the gang's: rank 0 prunes it
        steps = self.all_steps()
        for old in steps[: max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(self.step_dir(old), ignore_errors=True)

    def _load(self, state: Dict[str, torch.Tensor], step: int) -> None:
        import time

        import torch.distributed.checkpoint as dcp

        t0 = time.perf_counter()
        with torch.no_grad(), _single_process():
            if _is_sharded(state):
                dcp.load(state, checkpoint_id=self.step_dir(step),
                         process_group=self.process_group)
            else:
                dcp.load(state, checkpoint_id=self.step_dir(step),
                         no_dist=True)
        if any(t.device.type == "cuda" for t in state.values()
               if isinstance(t, torch.Tensor)):
            torch.cuda.synchronize()
        self.last_load_s = time.perf_counter() - t0

    def restore(self, state_template: Dict[str, torch.Tensor],
                step: Optional[int] = None):
        """Load ``step`` (default: the newest within the ceiling) into
        the template's tensors in place; returns the template, or None
        when there is no step."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        self._load(state_template, step)
        return state_template

    def restore_params(self, params_template: Dict[str, torch.Tensor],
                       step: Optional[int] = None):
        """Restore ONLY the ``params/<name>`` leaves of a full-state
        checkpoint into ``params_template`` (keyed by ``<name>``), in
        place: the optimizer moments are never read off disk, and each
        weight lands straight in its template tensor (device and dtype
        of the template). Returns the template, or None when there is
        no step. A missing name or a shape mismatch fails inside DCP."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        self._load({f"params/{name}": t for name, t in params_template.items()},
                   step)
        return params_template

    def reached_preemption(self, step: int) -> bool:
        """Gang-wide preemption verdict at this step boundary: the
        launcher's SIGTERM flag (``KTPU_PREEMPT_REQUESTED``) in one
        process; with a process group, one ``all_reduce(MAX)`` of the
        flags, so every process reaches the same verdict at the same
        step boundary (what orbax's preemption notifier gives the JAX
        package). A broken poll logs once and reads as False."""
        try:
            return bool(gang_reduce(
                int(os.environ.get("KTPU_PREEMPT_REQUESTED") == "1"), "max"))
        except Exception as e:
            if not self._preemption_poll_broken:
                self._preemption_poll_broken = True
                log.warning("preemption poll unavailable (%s: %s); "
                            "falling back to periodic checkpoints only",
                            type(e).__name__, e)
            return False

    def all_steps(self) -> List[int]:
        """Committed steps (a ``<step>`` dir holding DCP's metadata),
        ascending."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        steps = []
        for name in names:
            if name.isdigit() and os.path.exists(
                    os.path.join(self.directory, name, METADATA)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        if self.max_restore_step is not None:
            steps = [s for s in steps if s <= self.max_restore_step]
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing to release."""
