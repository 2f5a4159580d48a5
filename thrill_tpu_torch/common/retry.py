"""Bounded exponential backoff with full jitter: the one retry policy
(counterpart of the reference package's ``common/retry.py``).

Attempt k sleeps ``uniform(0, min(max_delay, base * 2**k))``. An
exception listed in ``permanent`` never retries, even if it is also
transient; injected faults carry their class in ``.kind``. Settings:
``THRILL_TPU_RETRY_ATTEMPTS`` (4), ``THRILL_TPU_RETRY_BASE_S`` (0.05),
``THRILL_TPU_RETRY_MAX_S`` (2.0); ``THRILL_TPU_RETRY=0`` turns every
retry off.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Any, Callable, Optional, Tuple

from . import faults


def _env_float(name: str, default: float) -> float:
    try:
        v = os.environ.get(name)
        return float(v) if v not in (None, "") else default
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        v = os.environ.get(name)
        return int(v) if v not in (None, "") else default
    except ValueError:
        return default


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Immutable retry policy; ``run()`` calls a function under it."""

    max_attempts: int = 4           # tries in all (1 = no retry)
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    transient: Tuple[type, ...] = (ConnectionError, TimeoutError, OSError)
    permanent: Tuple[type, ...] = ()

    def classify(self, exc: BaseException) -> str:
        """'transient' or 'permanent'; permanent wins. Deterministic
        OSErrors (a missing file, permissions), a failed authentication
        and a cluster abort (a coordinated shutdown) are permanent."""
        from ..net import wire
        from ..net.group import ClusterAbort
        if isinstance(exc, (wire.AuthError, ClusterAbort,
                            FileNotFoundError, PermissionError,
                            IsADirectoryError, NotADirectoryError)
                      + tuple(self.permanent)):
            return faults.PERMANENT
        if isinstance(exc, faults.InjectedFault):
            return exc.kind
        if isinstance(exc, tuple(self.transient)):
            return faults.TRANSIENT
        return faults.PERMANENT

    def delay(self, attempt: int, rng: random.Random) -> float:
        cap = min(self.max_delay_s, self.base_delay_s * (2 ** attempt))
        return rng.uniform(0.0, cap)

    def run(self, fn: Callable[[], Any], *, what: str,
            seed: Optional[int] = None,
            sleep: Callable[[float], None] = time.sleep) -> Any:
        """``fn()``, retrying transient failures with backoff; the last
        failure is raised unchanged."""
        attempts = self.max_attempts
        if os.environ.get("THRILL_TPU_RETRY", "1") == "0":
            attempts = 1
        rng = None
        for attempt in range(attempts):
            try:
                return fn()
            except BaseException as e:
                if (attempt + 1 >= attempts
                        or self.classify(e) != faults.TRANSIENT):
                    raise
                if rng is None:
                    rng = random.Random(seed if seed is not None
                                        else random.getrandbits(32))
                d = self.delay(attempt, rng)
                faults.note("retry", what=what, attempt=attempt + 1,
                            delay_s=round(d, 4), error=repr(e))
                sleep(d)
        raise AssertionError("unreachable")


def default_policy(**overrides: Any) -> RetryPolicy:
    """The policy with the environment's settings; keywords override."""
    kw = dict(
        max_attempts=_env_int("THRILL_TPU_RETRY_ATTEMPTS", 4),
        base_delay_s=_env_float("THRILL_TPU_RETRY_BASE_S", 0.05),
        max_delay_s=_env_float("THRILL_TPU_RETRY_MAX_S", 2.0),
    )
    kw.update(overrides)
    return RetryPolicy(**kw)
