"""Event-handler watchdog.

(The port's copy of ``k8s_tpu/controller/watchdog.py``.)

Analogue of reference ``pkg/controller/util.go:51-77`` (``panicTimer``):
the operator crashes itself if a single event handler blocks longer
than a deadline (1 min in the reference, armed at controller.go:110-117)
— a liveness guard standing in for real deadlock detection.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

log = logging.getLogger(__name__)

DEFAULT_DEADLINE = 60.0  # reference: panic at 1 min


class PanicTimerError(RuntimeError):
    pass


class PanicTimer:
    """Arm around each event dispatch; fires if not stopped in time."""

    def __init__(self, deadline: float = DEFAULT_DEADLINE, msg: str = "", hard: bool = False):
        self.deadline = deadline
        self.msg = msg
        self.hard = hard  # True → kill the process like Go panic would
        self._timer: Optional[threading.Timer] = None
        self.fired = threading.Event()

    def _fire(self):
        self.fired.set()
        log.critical("watchdog fired: %s (handler blocked > %.0fs)", self.msg, self.deadline)
        if self.hard:  # pragma: no cover - process suicide
            os._exit(2)

    def start(self) -> None:
        self.stop()
        self._timer = threading.Timer(self.deadline, self._fire)
        self._timer.daemon = True
        self._timer.start()

    def stop(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
