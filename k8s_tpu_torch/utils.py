"""Small shared utilities of the operator (the port's copy of
``k8s_tpu/utils.py`` without its JAX helpers).

Analogue of reference ``pkg/util/util.go`` (``RandString`` for DNS-safe
runtime ids :38-54) and
``pkg/util/retryutil/retry_util.go``.
"""

from __future__ import annotations

import random
import string
import time
from typing import Callable, Optional

# DNS-1035: lowercase alphanumeric, must start with a letter.
_LETTERS = string.ascii_lowercase
_ALNUM = string.ascii_lowercase + string.digits


def rand_string(n: int, seed: Optional[int] = None) -> str:
    """DNS-label-safe random id (reference RandString: first char is a
    letter so names like ``<job>-worker-<id>-0`` stay valid)."""
    rng = random.Random(seed)
    if n <= 0:
        return ""
    return rng.choice(_LETTERS) + "".join(rng.choice(_ALNUM) for _ in range(n - 1))


class RetryError(Exception):
    def __init__(self, n: int):
        super().__init__(f"still failing after {n} retries")
        self.retries = n


def retry(
    interval: float,
    max_retries: int,
    fn: Callable[[], bool],
    sleep: Callable[[float], None] = time.sleep,
) -> None:
    """Ticker-based retry (reference retryutil.Retry:27-48): calls
    ``fn`` up to ``max_retries`` times every ``interval`` seconds until
    it returns True; raises RetryError otherwise."""
    if max_retries <= 0:
        raise ValueError("max_retries must be > 0")
    for i in range(max_retries):
        if fn():
            return
        if i < max_retries - 1:
            sleep(interval)
    raise RetryError(max_retries)
