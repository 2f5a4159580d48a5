"""Load-aware distress deadlines (counterpart of the reference
package's ``common/timeouts.py``, copied whole).

The net layer's "peer gone?" timeouts (bootstrap accept loops, isend
flush) exist to turn a dead peer into a clean error instead of a hang.
The reference has no such caps at these points — MPI_Waitall and its
tcp Connect loops block until the runtime kills the job — so ours must
never fire MERELY because the machine is oversubscribed: on a loaded
host a healthy peer can legitimately spend minutes between progress
points (kernel builds, EM spills), and a fixed cap converts that into a
spurious child death (observed: the 2-process MPI wordcount child
dying at a fixed 60 s flush deadline under a synthetic full-core load).

``scaled(base)`` stretches a base deadline by the PER-CORE 1-minute
loadavg (capped at 6x, floor 1x) — idle or merely-busy multi-core
machines keep the tight diagnostic deadline; only real
oversubscription (runnable tasks exceeding cores) stretches it.
tests/net/portalloc.load_scaled delegates here: one copy of the
policy for parent-side drain budgets and child-side deadlines alike.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

# loadavg is kernel-updated every ~5 s; poll loops re-evaluate budgets
# as often as every 50 us, so the read is cadence-limited to ~1 s
# (benign data race: tuple swap is atomic)
_LOAD_CACHE = (-10.0, 1.0)


def _per_core_load() -> float:
    global _LOAD_CACHE
    now = time.monotonic()
    ts, val = _LOAD_CACHE
    if now - ts > 1.0:
        try:
            val = os.getloadavg()[0] / (os.cpu_count() or 1)
        except (OSError, AttributeError):
            val = 0.0
        _LOAD_CACHE = (now, val)
    return val


def scaled(base_s: float) -> float:
    return base_s * max(1.0, min(_per_core_load(), 6.0))


def budget_fn(override: Optional[float],
              base_s: float) -> Callable[[], float]:
    """The one policy for distress-deadline dispatch: an explicit
    override is a FIXED budget (tests rely on determinism); otherwise
    the load-scaled base, re-evaluated on every call so a load spike
    arriving mid-wait stretches an already-started deadline. The
    stretch is a RATCHET: once granted, a budget never contracts —
    otherwise a wait started under load would spuriously expire the
    moment the 1-minute loadavg decays (elapsed > newly-shrunk budget)
    even though the now-unloaded peer is about to complete."""
    if override is not None:
        fixed = float(override)
        return lambda: fixed
    best = scaled(base_s)

    def ratchet() -> float:
        nonlocal best
        best = max(best, scaled(base_s))
        return best

    return ratchet
