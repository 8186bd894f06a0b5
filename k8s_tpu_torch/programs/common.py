"""Program scaffolding of the port: run-config parsing, the preemption
flags and the step-metrics logger's stdout lines (own copies of the
JAX-free helpers in ``k8s_tpu/programs/common.py``, so the port imports
nothing of it)."""

from __future__ import annotations

import json
import os
import shlex
import time
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class RunConfig:
    steps: int = 100
    batch_size: int = 64
    accum_steps: int = 1
    log_every: int = 10
    checkpoint_dir: str = ""
    checkpoint_every: int = 0
    extra: Optional[Dict[str, str]] = None


def preempt_requested() -> bool:
    """True once the launcher's SIGTERM handler has fired (the
    ``KTPU_PREEMPT_REQUESTED`` contract). Poll between steps only."""
    return os.environ.get("KTPU_PREEMPT_REQUESTED") == "1"


def mark_preempt_aware() -> None:
    """Tell the launcher's SIGTERM handler this program will USE the
    grace period (drain, then exit) instead of exiting immediately."""
    os.environ["KTPU_PREEMPT_AWARE"] = "1"


def parse_run_config(rdzv, defaults: Optional[dict] = None) -> RunConfig:
    """Program args come from ``rdzv.program_args`` (shell-ish
    ``--key=value`` tokens): known :class:`RunConfig` fields are set,
    everything else lands in ``extra``. ``KTPU_STEPS`` overrides steps;
    the operator's ``KTPU_CKPT_DIR`` / ``KTPU_CKPT_PERSIST_EVERY`` fill
    an unset checkpoint dir / interval."""
    cfg = RunConfig(**(defaults or {}))
    extra: Dict[str, str] = {}
    for tok in shlex.split(getattr(rdzv, "program_args", "") or ""):
        if not tok.startswith("--") or "=" not in tok:
            continue
        key, _, val = tok[2:].partition("=")
        key = key.replace("-", "_")
        if hasattr(cfg, key) and key != "extra":
            cur = getattr(cfg, key)
            setattr(cfg, key, type(cur)(val) if cur is not None else val)
        else:
            extra[key] = val
    cfg.extra = extra
    if os.environ.get("KTPU_STEPS"):
        cfg.steps = int(os.environ["KTPU_STEPS"])
    if not cfg.checkpoint_dir and os.environ.get("KTPU_CKPT_DIR"):
        cfg.checkpoint_dir = os.environ["KTPU_CKPT_DIR"]
        if not cfg.checkpoint_every:
            try:
                cfg.checkpoint_every = int(
                    os.environ.get("KTPU_CKPT_PERSIST_EVERY", "0") or 0)
            except ValueError:
                pass
    return cfg


class MetricLogger:
    """Step-metrics logger: JSON lines on process 0's stdout,
    ``{"run", "step", "steps_per_sec", <metrics>}``."""

    def __init__(self, rdzv, run_name: str):
        self.enabled = rdzv.process_id <= 0
        self.run_name = run_name
        self._last_step = 0
        self._last_t = time.perf_counter()

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        if not self.enabled:
            return
        now = time.perf_counter()
        steps_per_sec = (step - self._last_step) / max(now - self._last_t, 1e-9)
        self._last_step, self._last_t = step, now
        print(json.dumps({
            "run": self.run_name, "step": step,
            "steps_per_sec": round(steps_per_sec, 3),
            **{k: round(float(v), 5) for k, v in metrics.items()},
        }), flush=True)
