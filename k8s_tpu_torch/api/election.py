"""Leader election by annotation compare-and-swap.
(The port's copy of ``k8s_tpu/api/election.py``.)

Analogue of the reference's vendored leader-election fork
(``pkg/util/k8sutil/election/``): a ``LeaderElectionRecord`` stored in
the annotation ``control-plane.alpha.kubernetes.io/leader`` of an
Endpoints-like lock object, acquired/renewed by CAS on resourceVersion
(``election.go:140-265``, ``resourcelock/endpointslock.go:29-103``).
Lease semantics (15s lease / 5s renew / 3s retry defaults) match
``cmd/tf_operator/main.go:42-44``.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from k8s_tpu_torch.api import errors

LEADER_ANNOTATION = "control-plane.alpha.kubernetes.io/leader"
LOCK_KIND = "Endpoints"

DEFAULT_LEASE_DURATION = 15.0
DEFAULT_RENEW_DEADLINE = 5.0
DEFAULT_RETRY_PERIOD = 3.0


@dataclass
class LeaderElectionRecord:
    holder_identity: str
    lease_duration_seconds: float
    acquire_time: float
    renew_time: float

    def to_json(self) -> str:
        return json.dumps(
            {
                "holderIdentity": self.holder_identity,
                "leaseDurationSeconds": self.lease_duration_seconds,
                "acquireTime": self.acquire_time,
                "renewTime": self.renew_time,
            }
        )

    @classmethod
    def from_json(cls, s: str) -> "LeaderElectionRecord":
        d = json.loads(s)
        return cls(
            d.get("holderIdentity", ""),
            d.get("leaseDurationSeconds", DEFAULT_LEASE_DURATION),
            d.get("acquireTime", 0.0),
            d.get("renewTime", 0.0),
        )


class LeaderElector:
    def __init__(
        self,
        cluster,  # InMemoryCluster surface; RestCluster gives real CAS
        namespace: str,
        name: str,
        identity: str,
        lease_duration: float = DEFAULT_LEASE_DURATION,
        renew_deadline: float = DEFAULT_RENEW_DEADLINE,
        retry_period: float = DEFAULT_RETRY_PERIOD,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._cluster = cluster
        self.namespace = namespace
        self.name = name
        self.identity = identity
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        self._clock = clock
        self.observed: Optional[LeaderElectionRecord] = None
        self._observed_at = 0.0

    # -- one CAS round (reference tryAcquireOrRenew, election.go:213-265) --

    def try_acquire_or_renew(self) -> bool:
        now = self._clock()
        desired = LeaderElectionRecord(
            self.identity, self.lease_duration, now, now
        )
        try:
            lock = self._cluster.get(LOCK_KIND, self.namespace, self.name)
        except errors.NotFoundError:
            lock = {
                "metadata": {
                    "namespace": self.namespace,
                    "name": self.name,
                    "annotations": {LEADER_ANNOTATION: desired.to_json()},
                }
            }
            try:
                self._cluster.create(LOCK_KIND, lock)
            except errors.AlreadyExistsError:
                return False
            self.observed = desired
            self._observed_at = now
            return True

        raw = (lock["metadata"].get("annotations") or {}).get(LEADER_ANNOTATION, "")
        current = LeaderElectionRecord.from_json(raw) if raw else None
        if current is not None:
            if self.observed is None or current.renew_time != self.observed.renew_time:
                self.observed = current
                self._observed_at = now
            lease_valid = self._observed_at + self.lease_duration > now
            if current.holder_identity != self.identity and lease_valid:
                return False  # someone else holds an unexpired lease
            if current.holder_identity == self.identity:
                desired.acquire_time = current.acquire_time
        lock["metadata"].setdefault("annotations", {})[LEADER_ANNOTATION] = desired.to_json()
        try:
            self._cluster.update(LOCK_KIND, lock, check_version=True)
        except (errors.ConflictError, errors.NotFoundError):
            return False
        self.observed = desired
        self._observed_at = now
        return True

    def is_leader(self) -> bool:
        return self.observed is not None and self.observed.holder_identity == self.identity

    # -- blocking run loop (reference RunOrDie/Run, election.go:140-208) ---

    def run(
        self,
        on_started_leading: Callable[[threading.Event], None],
        on_stopped_leading: Callable[[], None],
        stop: Optional[threading.Event] = None,
    ) -> None:
        stop = stop or threading.Event()
        while not stop.is_set():
            if self.try_acquire_or_renew():
                break
            stop.wait(self.retry_period)
        if stop.is_set():
            return
        lost = threading.Event()

        def renew_loop():
            while not stop.is_set():
                stop.wait(self.renew_deadline)
                if stop.is_set():
                    break
                try:
                    renewed = self.try_acquire_or_renew()
                except Exception as e:
                    # a transient API error mid-renew previously killed
                    # this thread SILENTLY: the lease then expired with
                    # `lost` never set — the old leader kept leading
                    # while a new one took over (split brain). Failing
                    # safe — treat it as a lost lease — is the only
                    # correct direction.
                    import logging

                    logging.getLogger(__name__).warning(
                        "lease renew errored (%s); conceding leadership", e)
                    renewed = False
                if not renewed:
                    lost.set()
                    break

        t = threading.Thread(target=renew_loop, daemon=True, name="lease-renew")
        t.start()
        try:
            on_started_leading(lost)
        finally:
            stop.set()
            on_stopped_leading()
