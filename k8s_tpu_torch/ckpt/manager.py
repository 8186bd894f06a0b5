"""Multi-tier checkpoint manager + goodput accounting (port of
``k8s_tpu/ckpt/manager.py``).

One object with the surface the training programs use (``save /
restore / wait / close / reached_preemption / latest_step``),
composing:

- the **local tier** (:mod:`k8s_tpu_torch.ckpt.local`): cheap per-host
  snapshots every ``local_interval`` steps;
- the **persistent tier** (:class:`k8s_tpu_torch.train.checkpoint.
  CheckpointManager`, DCP), low-frequency durable saves every
  ``persistent_interval`` steps;
- the **restore planner** (:mod:`k8s_tpu_torch.ckpt.planner`): newest
  consistent step across tiers, peer-shard sourcing for replaced pods.

Goodput accounting rides along: every save is timed against loop
wall-clock (checkpoint overhead fraction), every restore records its
source tier, the steps lost since the last recorded progress, and its
seconds by phase. The numbers are exported as ``goodput()``, JSON event
lines on stdout (``ckpt_restore``, ``ckpt_skip_unhealthy``), the
``ktpu_ckpt_*`` series of :mod:`k8s_tpu_torch.controller.metrics`, and
``save_<phase>``/``restore_<phase>`` spans on the default tracer.

In a multi-process run the gang's local commits meet at ``barrier``
and the planned restore step goes through ``consensus``
(:func:`k8s_tpu_torch.programs.common.build_checkpoint_manager` wires
both over the process group).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from k8s_tpu_torch.ckpt.local import LocalTier
from k8s_tpu_torch.ckpt.peer import FilesystemPeerTransport, RestPeerTransport
from k8s_tpu_torch.ckpt.planner import (
    SOURCE_NONE,
    RestorePlan,
    RestorePlanner,
)

log = logging.getLogger(__name__)


@dataclass
class CheckpointPolicy:
    """Resolved checkpointPolicy (spec block → env → here). Zero
    intervals disable a tier."""

    local_dir: str = ""
    local_interval_steps: int = 0
    local_max_to_keep: int = 2
    persistent_dir: str = ""
    persistent_interval_steps: int = 0
    peer_fetch: bool = True
    # restore ceiling ("last healthy step"): after a TrainingDiverged
    # verdict the operator injects KTPU_CKPT_RESTORE_MAX_STEP on the
    # restarted gang so planning never targets a NaN checkpoint
    # (docs/OBSERVABILITY.md "Training health", docs/CHECKPOINT.md)
    max_restore_step: Optional[int] = None
    # restore pipeline (docs/CHECKPOINT.md "Restore critical path"):
    # fetch-pool width (1 = the serial schedule, byte-identical either
    # way) and the in-flight host-bytes cap on fetched shard buffers
    restore_parallel: int = 8
    restore_inflight_mb: int = 1024
    # save pipeline (docs/CHECKPOINT.md "Save critical path"):
    # snapshot-pool width (1 = serial device→host copies, byte-
    # identical committed output either way) and the cap on host bytes
    # staged between the snapshot and the background writer
    save_concurrency: int = 8
    save_buffer_bytes: int = 1 << 30

    @classmethod
    def from_env(cls, env=None) -> "CheckpointPolicy":
        env = env if env is not None else os.environ

        def num(name, default):
            try:
                return int(env.get(name, "") or default)
            except ValueError:
                return default

        raw_max = env.get("KTPU_CKPT_RESTORE_MAX_STEP", "")
        try:
            max_restore = int(raw_max) if raw_max else None
        except ValueError:
            max_restore = None
        return cls(
            local_dir=env.get("KTPU_CKPT_LOCAL_DIR", ""),
            local_interval_steps=num("KTPU_CKPT_LOCAL_EVERY", 0),
            local_max_to_keep=num("KTPU_CKPT_LOCAL_KEEP", 2),
            persistent_dir=env.get("KTPU_CKPT_DIR", ""),
            persistent_interval_steps=num("KTPU_CKPT_PERSIST_EVERY", 0),
            peer_fetch=env.get("KTPU_CKPT_PEER_FETCH", "1")
            not in ("0", "false"),
            max_restore_step=max_restore,
            restore_parallel=max(1, num("KTPU_CKPT_RESTORE_PARALLEL", 8)),
            restore_inflight_mb=num("KTPU_CKPT_RESTORE_INFLIGHT_MB", 1024),
            save_concurrency=max(1, num("KTPU_CKPT_SAVE_CONCURRENCY", 8)),
            save_buffer_bytes=num("KTPU_CKPT_SAVE_BUFFER_BYTES", 1 << 30),
        )

    @property
    def enabled(self) -> bool:
        return bool(self.local_dir or self.persistent_dir)


@dataclass
class GoodputStats:
    """Counters the acceptance criteria read. ``lost_steps_last`` /
    ``per restart``: progress the gang had made past the step the
    restart restored — the work a faster local tier exists to shrink."""

    restores: int = 0
    restore_sources: Dict[str, int] = field(default_factory=dict)
    lost_steps_total: int = 0
    lost_steps_last: int = -1  # -1: no restore yet / progress unknown
    # newest step ANY tier committed this process generation (-1 = no
    # save yet): rides the obs heartbeat so the cluster scheduler can
    # price a preemption as progress-past-last-save (docs/SCHEDULER.md)
    last_saved_step: int = -1
    peer_shards_fetched: int = 0
    local_saves: int = 0
    local_save_failures: int = 0
    persistent_saves: int = 0
    persistent_save_failures: int = 0
    # routed saves skipped because the previous one is still committing
    # in the background, by reason — silent goodput loss made visible
    # (a too-tight localIntervalSteps shows up HERE, not as a mystery
    # gap in the committed-steps ladder)
    save_skipped: Dict[str, int] = field(default_factory=dict)
    # save_seconds_total is the STEP-CRITICAL-PATH wall only (the
    # parallel device→host snapshot + routing) — what the overhead
    # fraction prices. The background writer/committer phases land in
    # save_phase_seconds (snapshot_s / serialize_s / commit_s), which
    # overlap training and may sum past save_seconds_total.
    save_seconds_total: float = 0.0
    save_phase_seconds: Dict[str, float] = field(default_factory=dict)
    loop_seconds_total: float = 0.0
    # MTTR accounting (docs/CHECKPOINT.md "Restore critical path"):
    # restart latency in SECONDS, not just lost steps — the quantity
    # the scheduler/resize cost models price a restart at. The phase
    # breakdown (plan_s / fetch_s / device_s) mirrors the planner's
    # pipeline; fetch and device overlap, so phases may sum past the
    # total.
    restore_seconds_total: float = 0.0
    restore_phase_seconds: Dict[str, float] = field(default_factory=dict)

    def overhead_fraction(self) -> float:
        if self.loop_seconds_total <= 0:
            return 0.0
        return min(1.0, self.save_seconds_total / self.loop_seconds_total)

    def lost_steps_per_restart(self) -> float:
        if self.restores == 0:
            return 0.0
        return self.lost_steps_total / self.restores

    def to_dict(self) -> Dict[str, Any]:
        return {
            "restores": self.restores,
            "restore_sources": dict(self.restore_sources),
            "lost_steps_total": self.lost_steps_total,
            "lost_steps_last": self.lost_steps_last,
            "last_saved_step": self.last_saved_step,
            "lost_steps_per_restart": round(self.lost_steps_per_restart(), 3),
            "peer_shards_fetched": self.peer_shards_fetched,
            "local_saves": self.local_saves,
            "local_save_failures": self.local_save_failures,
            "persistent_saves": self.persistent_saves,
            "persistent_save_failures": self.persistent_save_failures,
            # dict() first: the writer/committer threads add phase keys
            # while heartbeat threads serialize this block — a plain
            # sorted(d.items()) could observe the resize mid-iteration
            "save_skipped": dict(self.save_skipped),
            "save_seconds_total": round(self.save_seconds_total, 6),
            "save_phases_s": {
                k: round(v, 6)
                for k, v in sorted(dict(self.save_phase_seconds).items())},
            "ckpt_overhead_fraction": round(self.overhead_fraction(), 5),
            "restore_seconds_total": round(self.restore_seconds_total, 6),
            "restore_phases_s": {
                k: round(v, 6)
                for k, v in sorted(self.restore_phase_seconds.items())},
        }


class MultiTierCheckpointManager:
    """Drop-in for :class:`k8s_tpu_torch.train.checkpoint.CheckpointManager`
    with a local tier in front of it."""

    def __init__(
        self,
        policy: CheckpointPolicy,
        host_id: int = 0,
        barrier=None,
        transport=None,
        consensus=None,
        persistent=None,
        gang_consistent: bool = False,
        process_group=None,
    ):
        self.policy = policy
        self.host_id = host_id
        self.stats = GoodputStats()
        self._loop_t0 = time.monotonic()
        self._phase_lock = threading.Lock()
        # background persistent committer (docs/CHECKPOINT.md "Save
        # critical path"): ONE long-lived worker owns every persistent
        # save. Routed saves hand the worker a staged host copy and
        # return; force saves ride the same worker with the caller
        # blocking on the drain.
        self._persist_lock = threading.Lock()
        self._persist_pending = 0
        self._persist_q = None
        self._persist_worker: Optional[threading.Thread] = None
        self.local: Optional[LocalTier] = None
        if policy.local_dir and policy.local_interval_steps > 0:
            self.local = LocalTier(
                policy.local_dir,
                host_id=host_id,
                max_to_keep=policy.local_max_to_keep,
                barrier=barrier,
                parallel=policy.save_concurrency,
                buffer_bytes=policy.save_buffer_bytes,
                on_phases=self._note_background_phases,
            )
        self.persistent = persistent
        if self.persistent is None and policy.persistent_dir:
            from k8s_tpu_torch.train.checkpoint import CheckpointManager

            self.persistent = CheckpointManager(
                policy.persistent_dir,
                save_interval_steps=max(
                    1, policy.persistent_interval_steps or 1),
                max_restore_step=policy.max_restore_step,
                writer=host_id == 0,
                process_group=process_group,
            )
        if transport is None and self.local is not None and policy.peer_fetch:
            peers_env = os.environ.get("KTPU_CKPT_PEERS", "")
            if peers_env:
                transport = RestPeerTransport.from_env_value(
                    peers_env, self_host=host_id)
            else:
                # shared-root harness / scratch-tier deployments: sibling
                # host-* dirs ARE the peers' node-local disks
                transport = FilesystemPeerTransport(
                    policy.local_dir, self_host=host_id)
        self.transport = transport
        self.planner = RestorePlanner(
            self.local, self.persistent, transport=transport,
            consensus=consensus, gang_consistent=gang_consistent,
            max_step=policy.max_restore_step,
            parallel=policy.restore_parallel,
            inflight_bytes=max(0, policy.restore_inflight_mb) << 20,
        )
        self.last_restore_plan: Optional[RestorePlan] = None

    @classmethod
    def from_env(cls, host_id: int = 0, env=None, barrier=None,
                 consensus=None, gang_consistent: bool = False,
                 ) -> Optional["MultiTierCheckpointManager"]:
        policy = CheckpointPolicy.from_env(env)
        if not policy.enabled:
            return None
        return cls(policy, host_id=host_id, barrier=barrier,
                   consensus=consensus, gang_consistent=gang_consistent)

    # ------------------------------------------------------------ save

    def save(self, step: int, state: Any, force: bool = False,
             unhealthy=None) -> bool:
        """Tier routing: local every ``local_interval`` steps,
        persistent every ``persistent_interval`` steps; ``force`` writes
        BOTH (the preemption-flush / final-save path must land durably
        AND be the newest local step so the restart restores it fast).

        Routed (non-force) saves are ZERO-STALL (docs/CHECKPOINT.md
        "Save critical path"): the step pays only the parallel
        device→host snapshot — the local tier's writer and the
        persistent tier's committer run in the background over staged
        copies — and a save that arrives while the previous one is
        still committing is a counted skip
        (``ktpu_ckpt_save_skipped_total{reason}``), never a stall.
        ``force`` keeps today's synchronous both-tiers semantics: the
        preempt flush / final save drains the writer and commits before
        the process may exit.

        ``unhealthy`` (optional callable) gates every write: evaluated
        ONLY on steps a tier would actually write (it may sync the
        device — e.g. reading the in-step health block), and a True
        verdict skips BOTH tiers with a ``ckpt_skip_unhealthy`` event.
        A diverged run must never checkpoint its NaN state — retention
        would rotate the healthy snapshots out from under the restart
        (docs/CHECKPOINT.md, "last healthy step"). Owning the gate HERE
        keeps it in lockstep with the routing predicate by
        construction."""
        t0 = time.monotonic()
        wrote = False
        try:
            wants_local = self.local is not None and (
                force or step % self.policy.local_interval_steps == 0
            )
            wants_persistent = self.persistent is not None and (
                force
                or (
                    self.policy.persistent_interval_steps > 0
                    and step % self.policy.persistent_interval_steps == 0
                )
            )
            if ((wants_local or wants_persistent)
                    and unhealthy is not None and unhealthy()):
                print(json.dumps({"event": "ckpt_skip_unhealthy",
                                  "step": step}), flush=True)
                return False
            if wants_local:
                # best-effort: a failed local snapshot (full node disk,
                # chaos partial commit) degrades THIS interval's restart
                # cost, never the training job — the persistent tier is
                # the correctness floor
                try:
                    if self.local.save(step, state, block=force):
                        self.stats.local_saves += 1
                        self._metric("CKPT_LOCAL_SAVES").inc()
                        wrote = True
                        if force:
                            # a flush's wall holds the drain and the
                            # synchronous commit (the writer reports
                            # those); its snapshot phase is the local
                            # tier's own device→host stage
                            self._note_save_phase(
                                step, "snapshot",
                                self.local.last_save_stats.get("snapshot_s", 0.0))
                        # optimistic for the async local writer (the
                        # established local-tier semantics): a rare
                        # background write failure is already surfaced
                        # via local_save_failures
                        self.stats.last_saved_step = max(
                            self.stats.last_saved_step, step)
                    elif self.local.last_skip_reason == "writer_busy":
                        self._count_skip(step, "writer_busy")
                except Exception as e:
                    self.stats.local_save_failures += 1
                    log.warning(
                        "local checkpoint save failed at step %d (%s: %s); "
                        "local tier degraded this interval",
                        step, type(e).__name__, e)
            if wants_persistent:
                # NB: a STAGED persistent handoff does not advance
                # last_saved_step here — the committer does so only
                # when the DCP write actually lands, so the
                # scheduler's preemption pricing never believes in a
                # checkpoint a store outage swallowed
                wrote = self._save_persistent(step, state, force) or wrote
        finally:
            crit = time.monotonic() - t0
            self.stats.save_seconds_total += crit
            if wrote and not force:
                # the snapshot phase IS the step-critical-path slice of
                # a ROUTED save (everything else runs behind it). A
                # force save's wall includes the drain + synchronous
                # commits — already reported as serialize/commit by the
                # writer — so labeling it "snapshot" would double-count
                # the same seconds under the wrong phase; the full
                # flush wall stays visible in save_seconds_total.
                self._note_save_phase(step, "snapshot", crit)
            self._update_gauges()
        return wrote

    def _save_persistent(self, step: int, state: Any, force: bool) -> bool:
        """Persistent-tier leg of the routing.

        ALL persistent saves run on the single committer worker: routed
        saves stage a host copy of the whole tree (the step-critical
        slice; page-locked, not governed by saveBufferBytes, which
        bounds the local tier's leaf-by-leaf staging window) and return
        immediately; ``force`` (preempt flush / final save) hands the
        live tensors to the same worker with the caller BLOCKING until
        the commit landed."""
        sharded = any(hasattr(t, "placements") for t in state.values())
        if not force and self._persist_busy():
            self._count_skip(step, "committer_busy")
            return False
        if not force and not sharded:
            from k8s_tpu_torch.ckpt.pipeline import stage_tree

            staged = stage_tree(state)
            self._persist_enqueue(step, staged, force=False,
                                  blocking=False)
            # the handoff counts as a write for routing purposes (same
            # optimism as the local tier's async writer);
            # persistent_saves increments when the commit lands
            return True
        # forced, or a sharded state (a gang-wide DCP save of every
        # rank's shards, on the manager's own process group): the
        # caller blocks until the commit lands
        box = self._persist_enqueue(step, state, force=force,
                                    blocking=True)
        self._persist_drain()
        err = box.get("err")
        if err is not None and not force:
            self.stats.persistent_save_failures += 1
            log.warning("persistent checkpoint save failed at step %d "
                        "(%s: %s); persistent tier degraded this interval",
                        step, type(err).__name__, err)
            return False
        if err is not None:
            raise err  # today's contract: a failed forced flush raises
        if box.get("ok"):
            self.stats.persistent_saves += 1
            self.stats.last_saved_step = max(
                self.stats.last_saved_step, step)
            return True
        return False

    # ---- committer worker plumbing ------------------------------------

    def _persist_busy(self) -> bool:
        with self._persist_lock:
            return self._persist_pending > 0

    def _persist_enqueue(self, step, state, force, blocking) -> Dict:
        from queue import Queue

        with self._persist_lock:
            if self._persist_q is None:
                self._persist_q = Queue()
                t = threading.Thread(
                    target=self._persist_loop, args=(self._persist_q,),
                    daemon=True,
                    name=f"ckpt-persist-{self.host_id}")
                self._persist_worker = t
                t.start()
            self._persist_pending += 1
        box: Dict[str, Any] = {"blocking": blocking}
        self._persist_q.put((step, state, force, box))
        return box

    def _persist_loop(self, q) -> None:
        while True:
            item = q.get()
            if item is None:
                q.task_done()
                return
            step, state, force, box = item
            t0 = time.monotonic()
            try:
                ok = self.persistent.save(step, state, force=force)
                box["ok"] = ok
                if ok:
                    if not box["blocking"]:
                        # blocking callers count on their own thread
                        self.stats.persistent_saves += 1
                    self.stats.last_saved_step = max(
                        self.stats.last_saved_step, step)
                    self._note_save_phase(
                        step, "commit", time.monotonic() - t0)
            except BaseException as e:
                box["err"] = e
                if not box["blocking"]:
                    # degraded-not-fatal, like the local tier: the
                    # force path at preempt/final save re-writes (and
                    # re-raises) synchronously
                    self.stats.persistent_save_failures += 1
                    log.warning(
                        "background persistent checkpoint save failed "
                        "at step %d (%s: %s); persistent tier degraded "
                        "this interval", step, type(e).__name__, e)
            finally:
                with self._persist_lock:
                    self._persist_pending -= 1
                q.task_done()
                self._update_gauges()

    def _persist_drain(self) -> None:
        if self._persist_q is not None:
            self._persist_q.join()

    def _persist_shutdown(self) -> None:
        with self._persist_lock:
            q, self._persist_q = self._persist_q, None
            t, self._persist_worker = self._persist_worker, None
        if q is not None:
            q.put(None)
        if t is not None:
            t.join(timeout=10)

    def _count_skip(self, step: int, reason: str) -> None:
        self.stats.save_skipped[reason] = (
            self.stats.save_skipped.get(reason, 0) + 1)
        self._metric("CKPT_SAVE_SKIPPED").inc({"reason": reason})
        log.warning(
            "checkpoint save skipped at step %d (%s): the previous save "
            "is still committing in the background; tier degraded this "
            "interval — localIntervalSteps/persistentIntervalSteps may "
            "be too tight for the disk/store", step, reason)

    # ------------------------------------------------------------ phases

    def _note_save_phase(self, step: int, phase: str, seconds: float
                         ) -> None:
        """One save phase → goodput accumulation + the
        ktpu_ckpt_save_seconds gauge + a save_<phase> span on the
        process tracer (flight recorder). Called from the step path
        (snapshot) and from the writer/committer threads (serialize /
        commit) — mirrors the restore-side MTTR telemetry."""
        seconds = float(seconds)
        with self._phase_lock:
            key = f"{phase}_s"
            self.stats.save_phase_seconds[key] = (
                self.stats.save_phase_seconds.get(key, 0.0) + seconds)
        self._metric("CKPT_SAVE_SECONDS").set(seconds, {"phase": phase})
        from k8s_tpu_torch.obs.trace import default_tracer

        tracer = default_tracer()
        if tracer is not None:
            tracer.note_span(f"save_{phase}", seconds, step=step)

    def _note_background_phases(self, step: int,
                                phases: Dict[str, float]) -> None:
        """LocalTier writer callback: the background serialize/commit
        legs of a committed local save."""
        for phase in ("serialize", "commit"):
            if phase in phases:
                self._note_save_phase(step, phase, phases[phase])

    def note_step(self, step: int) -> None:
        """Per-step bookkeeping (cheap): progress marker for
        lost-steps accounting + loop-time accumulation for the overhead
        fraction."""
        now = time.monotonic()
        self.stats.loop_seconds_total += now - self._loop_t0
        self._loop_t0 = now
        if self.local is not None:
            self.local.note_progress(step)

    # ------------------------------------------------------------ restore

    def restore(self, state_template: Any,
                step: Optional[int] = None) -> Optional[Any]:
        if step is not None and self.persistent is not None:
            # explicit-step restore bypasses planning (debug surface)
            return self.persistent.restore(state_template, step=step)
        t0 = time.monotonic()
        tree, plan = self.planner.restore(state_template)
        restore_s = time.monotonic() - t0
        phases = dict(getattr(self.planner, "last_restore_stats", {}) or {})
        self.last_restore_plan = plan
        if plan.source != SOURCE_NONE:
            if plan.step is not None:
                # the restored step IS a committed checkpoint: seed the
                # save marker so a freshly-restarted job isn't priced
                # as if all its (replayed) progress were unsaved —
                # that would invert the scheduler's cheapest-victim
                # rule against exactly the jobs that just restored
                self.stats.last_saved_step = max(
                    self.stats.last_saved_step, int(plan.step))
            self.stats.restores += 1
            self.stats.restore_sources[plan.source] = (
                self.stats.restore_sources.get(plan.source, 0) + 1
            )
            self.stats.peer_shards_fetched += plan.peer_fetches
            self._metric("CKPT_RESTORES").inc({"source": plan.source})
            progress = self._best_progress()
            if progress >= 0 and plan.step is not None:
                lost = max(0, progress - plan.step)
                self.stats.lost_steps_last = lost
                self.stats.lost_steps_total += lost
                self._metric("CKPT_LOST_STEPS").inc(by=lost)
            # MTTR: restart latency as a first-class measured quantity
            # — goodput seconds + per-phase gauge + tracer spans that
            # land in the flight recorder next to the step spans
            # (docs/CHECKPOINT.md "Restore critical path")
            phase_s = {k: float(phases.get(k, 0.0))
                       for k in ("plan_s", "fetch_s", "device_s")}
            self.stats.restore_seconds_total += restore_s
            for k, v in phase_s.items():
                self.stats.restore_phase_seconds[k] = (
                    self.stats.restore_phase_seconds.get(k, 0.0) + v)
            gauge = self._metric("CKPT_RESTORE_SECONDS")
            gauge.set(restore_s, {"phase": "total"})
            for k, v in phase_s.items():
                gauge.set(v, {"phase": k[:-2]})
            from k8s_tpu_torch.obs.trace import default_tracer

            tracer = default_tracer()
            if tracer is not None:
                for k, v in phase_s.items():
                    tracer.note_span(
                        f"restore_{k[:-2]}", v,
                        step=plan.step, source=plan.source)
            print(json.dumps({
                "event": "ckpt_restore", "step": plan.step,
                "source": plan.source, "peer_shards": plan.peer_fetches,
                "lost_steps": self.stats.lost_steps_last,
                "seconds": round(restore_s, 6),
                "phases_s": {k: round(v, 6) for k, v in phase_s.items()},
            }), flush=True)
        self._update_gauges()
        return tree

    def _best_progress(self) -> int:
        best = self.local.progress() if self.local is not None else -1
        if self.transport is not None:
            try:
                best = max(best, self.transport.progress())
            except Exception:
                pass
        return best

    # ------------------------------------------------------------ passthrough

    def reached_preemption(self, step: int) -> bool:
        if self.persistent is not None:
            return self.persistent.reached_preemption(step)
        # local-only policy: no persistent manager → no gang-wide
        # poll. Fall back to the launcher's SIGTERM flag: the
        # node drain SIGTERMs every pod of the slice, and a local-tier
        # flush is collective-free (own shards → own disk), so each
        # host flushing at its own step boundary is safe — the restore
        # planner's gang rule reconciles off-by-one commits.
        return os.environ.get("KTPU_PREEMPT_REQUESTED") == "1"

    def latest_step(self) -> Optional[int]:
        steps = []
        if self.local is not None:
            steps.extend(self.local.committed_steps())
        if self.persistent is not None:
            ps = self.persistent.latest_step()
            if ps is not None:
                steps.append(ps)
        return max(steps) if steps else None

    def wait(self) -> None:
        if self.local is not None:
            try:
                self.local.wait()
            except Exception as e:  # async local write failed: degraded,
                self.stats.local_save_failures += 1  # not fatal
                log.warning("local checkpoint flush failed (%s: %s)",
                            type(e).__name__, e)
        # drain the background persistent committer (its own failures
        # were already counted/logged on the committer thread), so
        # "wait() returned" means "every handed-off save is on disk or
        # accounted as failed"
        self._persist_drain()
        if self.persistent is not None:
            self.persistent.wait()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._persist_shutdown()
            if self.local is not None:
                self.local.buffers.close()
            if self.persistent is not None:
                self.persistent.close()

    # ------------------------------------------------------------ goodput

    def goodput(self) -> Dict[str, Any]:
        return self.stats.to_dict()

    def _metric(self, name: str):
        from k8s_tpu_torch.controller import metrics

        return getattr(metrics, name)

    def _update_gauges(self) -> None:
        from k8s_tpu_torch.controller import metrics

        metrics.CKPT_OVERHEAD_FRACTION.set(self.stats.overhead_fraction())
        metrics.CKPT_LOST_STEPS_PER_RESTART.set(
            self.stats.lost_steps_per_restart())
