"""API error taxonomy.

(The port's copy of ``k8s_tpu/api/errors.py``.)

Analogue of reference ``pkg/util/k8sutil/k8sutil.go`` error classifiers
(IsKubernetesResourceAlreadyExistError / NotFoundError) and the watch
staleness error ``ErrVersionOutdated`` (``pkg/controller/controller.go``).
"""

from __future__ import annotations


class ApiError(Exception):
    code = 500


class NotFoundError(ApiError):
    code = 404


class AlreadyExistsError(ApiError):
    code = 409


class ConflictError(ApiError):
    """resourceVersion mismatch on update (optimistic-concurrency CAS)."""

    code = 409


class OutdatedVersionError(ApiError):
    """Watch resourceVersion fell out of the history window — the
    analogue of HTTP 410 Gone, which the reference maps to
    ``ErrVersionOutdated`` and recovers from by relisting
    (``controller.go:331-344``)."""

    code = 410


class UnauthorizedError(ApiError):
    """401 — credentials missing/expired. Real clusters rotate bound
    serviceaccount tokens (~1h); the REST client re-reads its token
    source and retries once before surfacing this."""

    code = 401


class ForbiddenError(ApiError):
    """403 — authenticated but RBAC-denied. NOT retryable: retrying a
    403 just hammers the apiserver; it needs a ClusterRole fix."""

    code = 403


class InvalidError(ApiError):
    """422 — the object failed server-side validation. Not retryable."""

    code = 422


class TooManyRequestsError(ApiError):
    """429 — apiserver client-side throttling (APF). Retryable after
    the Retry-After the server names."""

    code = 429

    def __init__(self, message: str = "", retry_after: float = 1.0):
        super().__init__(message)
        self.retry_after = retry_after


def is_transient(e: BaseException) -> bool:
    """Worth retrying blindly? Plain ApiError is the 5xx/transport
    bucket (_raise_for_status's catch-all) and 429 names its own retry;
    every typed subclass (404/409/410/422/403/401) carries a semantic
    the caller must handle, not retry."""
    return type(e) is ApiError or isinstance(e, TooManyRequestsError)


def is_not_found(e: Exception) -> bool:
    return isinstance(e, NotFoundError)


def is_already_exists(e: Exception) -> bool:
    return isinstance(e, AlreadyExistsError)
