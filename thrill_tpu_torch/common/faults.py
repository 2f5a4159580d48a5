"""Deterministic, seeded fault injection (counterpart of the reference
package's ``common/faults.py``, the part the memory ladder uses).

Code declares **sites** at import time (``declare("mem.hbm.spill")``)
and calls ``check(site)`` at the matching operation. With nothing armed
the check is one environment read. Sites are armed by
``THRILL_TPU_FAULTS`` or the :class:`inject` context manager; the
grammar is the reference's, so one spec string arms the same sites in
both packages. Entries are separated by semicolons::

    THRILL_TPU_FAULTS="mem.oom:n=1;mem.hbm.*:p=0.5:n=2:seed=7"

- a site name or ``fnmatch`` pattern (``mem.*``);
- ``p=<float>`` the chance a hit fires (default 1.0);
- ``n=<int>`` the most fires of the entry (default 1; 0 = unbounded);
- ``seed=<int>`` seeds a stream per ``(seed, site)`` (default 0);
- ``after=<int>`` skips the first k hits (default 0);
- ``delay=<dur>`` (``50ms``, ``2s`` or seconds): the latency mode. A
  fire sleeps that long at the site instead of raising: a slow site
  made on demand, so the performance doctor's wait attribution
  (common/doctor.py) can be tested without real contention. Delayed
  fires count apart (``faults_delayed``) and log with ``kind=delay``.

A fire raises the site's declared exception class, so the real recovery
paths run; every fire and every recovery ``note`` is kept in
:data:`REGISTRY` and written to the attached JSON logger.

Sites declared here rather than by their module: ``api.mesh.dispatch``
(every call through the mesh's dispatch choke point, retried under the
shared policy), ``api.loop.replay`` (every replayed loop iteration) and
``api.fuse.<Op>`` (one per op label of a stitched program,
:func:`fuse_site`, checked before its dispatch).
"""

from __future__ import annotations

import fnmatch
import os
import random
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

ENV_VAR = "THRILL_TPU_FAULTS"

TRANSIENT = "transient"
PERMANENT = "permanent"


class InjectedFault(Exception):
    """Base class of every injected error; ``site`` names the origin."""

    def __init__(self, site: str, kind: str = TRANSIENT) -> None:
        super().__init__(f"injected fault at site '{site}' ({kind})")
        self.site = site
        self.kind = kind


class InjectedConnectionError(InjectedFault, ConnectionError):
    """Injected transport fault (a dial, frame send or flush)."""


class InjectedIOError(InjectedFault, IOError):
    """Injected storage fault (spill or restore I/O)."""


class Site:
    """A declared injection point."""

    def __init__(self, name: str, kind: str, exc: type) -> None:
        self.name = name
        self.kind = kind
        self.exc = exc
        self.hits = 0               # check() calls while armed
        self.fires = 0              # faults raised


class _Arm:
    """One armed spec entry (pattern, probability, budget, stream)."""

    def __init__(self, pattern: str, p: float, n: int, seed: int,
                 after: int, delay: Optional[float] = None) -> None:
        self.pattern = pattern
        self.p = p
        self.n = n                  # 0 = unbounded
        self.seed = seed
        self.after = after
        self.delay = delay          # latency mode: sleep, not raise
        self._rngs: Dict[str, random.Random] = {}
        self._fired: Dict[str, int] = {}
        self._seen: Dict[str, int] = {}

    def matches(self, site: str) -> bool:
        return site == self.pattern or fnmatch.fnmatchcase(site,
                                                           self.pattern)

    def fire(self, site: str) -> bool:
        seen = self._seen.get(site, 0)
        self._seen[site] = seen + 1
        if seen < self.after:
            return False
        if self.n and self._fired.get(site, 0) >= self.n:
            return False
        rng = self._rngs.get(site)
        if rng is None:
            rng = self._rngs[site] = random.Random(f"{self.seed}:{site}")
        if self.p < 1.0 and rng.random() >= self.p:
            return False
        self._fired[site] = self._fired.get(site, 0) + 1
        return True


class FaultRegistry:
    """Site table and armed spec, parsed again when the spec changes."""

    def __init__(self) -> None:
        self.sites: Dict[str, Site] = {}
        self.events: List[dict] = []      # recent records, bounded
        self.injected = 0
        self.delayed = 0
        self.retries = 0
        self.recoveries = 0
        self.aborts = 0
        self._arms: List[_Arm] = []
        self._spec: Optional[str] = None
        self._log: Optional[Callable[..., None]] = None
        self._lock = threading.Lock()

    def declare(self, name: str, kind: str = TRANSIENT,
                exc: type = InjectedIOError) -> str:
        if name not in self.sites:
            self.sites[name] = Site(name, kind, exc)
        return name

    def _sync(self) -> None:
        spec = os.environ.get(ENV_VAR, "")
        if spec != self._spec:
            self._spec = spec
            self._arms = parse_spec(spec)

    def active(self) -> bool:
        """Might any site be armed? (One environment read.)"""
        return bool(os.environ.get(ENV_VAR)) or bool(self._arms)

    def check(self, name: str, **detail: Any) -> None:
        """Raise the site's exception when an armed entry fires;
        ``detail`` goes into the record."""
        spec = os.environ.get(ENV_VAR, "")
        if spec == self._spec and not self._arms:
            return
        with self._lock:
            self._sync()
            if not self._arms:
                return
            site = self.sites.get(name)
            if site is None:
                site = self.sites[name] = Site(name, TRANSIENT,
                                               InjectedIOError)
            fired = None
            for arm in self._arms:
                if arm.matches(name):
                    site.hits += 1
                    if arm.fire(name):
                        fired = arm
                        break
            if fired is None:
                return
            delay_s = fired.delay
            if delay_s is not None:
                # the latency mode: a slow site, not an error
                self.delayed += 1
                rec = {"event": "fault_injected", "site": name,
                       "kind": "delay", "delay_s": delay_s}
            else:
                site.fires += 1
                self.injected += 1
                rec = {"event": "fault_injected", "site": name,
                       "kind": site.kind, "fire": site.fires}
            rec.update(detail)
            self._keep(rec)
            log = self._log
        self._emit(log, rec)
        if delay_s is not None:
            # outside the lock: a slow site must not hold up every other
            # thread's check
            time.sleep(delay_s)
            return
        raise site.exc(name, site.kind)

    def note(self, event: str, _quiet: bool = False,
             **detail: Any) -> None:
        """Record a recovery-layer event (``retry``, ``recovery``,
        ``oom_retry``, ``mem_spill``...) in the same stream;
        ``_quiet`` counts it without a record."""
        with self._lock:
            if event == "retry":
                self.retries += 1
            elif event == "recovery":
                self.recoveries += 1
            elif event == "abort":
                self.aborts += 1
            if _quiet:
                return
            rec = {"event": event}
            rec.update(detail)
            self._keep(rec)
            log = self._log
        self._emit(log, rec)

    def _keep(self, rec: dict) -> None:
        self.events.append(rec)
        if len(self.events) > 1024:
            del self.events[:512]

    @staticmethod
    def _emit(log: Optional[Callable[..., None]], rec: dict) -> None:
        if log is not None:
            try:
                log(**rec)
            except Exception:
                pass                  # logging never masks the fault

    def set_logger(self, line: Optional[Callable[..., None]]) -> None:
        with self._lock:
            self._log = line

    def stats(self) -> dict:
        with self._lock:
            return {"faults_injected": self.injected,
                    "faults_delayed": self.delayed,
                    "retries": self.retries,
                    "recoveries": self.recoveries,
                    "aborts": self.aborts}

    def reset(self) -> None:
        """Forget the armed state and the counters (tests)."""
        with self._lock:
            self._spec = None
            self._arms = []
            self.events = []
            self.injected = self.retries = self.delayed = 0
            self.recoveries = self.aborts = 0
            for s in self.sites.values():
                s.hits = s.fires = 0


def parse_duration_s(v: str) -> float:
    """``50ms`` / ``2s`` / plain seconds as non-negative seconds."""
    v = v.strip()
    if v.endswith("ms"):
        out = float(v[:-2]) / 1e3
    elif v.endswith("s"):
        out = float(v[:-1])
    else:
        out = float(v)
    if out < 0:
        raise ValueError(v)
    return out


def parse_spec(spec: str) -> List[_Arm]:
    """The entries of a ``THRILL_TPU_FAULTS`` value; a malformed entry is
    skipped with a message on stderr."""
    arms: List[_Arm] = []
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        pattern, p, n, seed, after = parts[0].strip(), 1.0, 1, 0, 0
        delay: Optional[float] = None
        ok = bool(pattern)
        for kv in parts[1:]:
            k, _, v = kv.partition("=")
            try:
                if k == "p":
                    p = float(v)
                elif k == "n":
                    n = int(v)
                elif k == "seed":
                    seed = int(v)
                elif k == "after":
                    after = int(v)
                elif k == "delay":
                    delay = parse_duration_s(v)
                else:
                    raise ValueError(k)
            except ValueError:
                ok = False
        if ok:
            arms.append(_Arm(pattern, p, n, seed, after, delay))
        else:
            print(f"thrill_tpu_torch.faults: malformed {ENV_VAR} entry "
                  f"{entry!r} ignored", file=sys.stderr)
    return arms


#: the process's registry: sites declare here, the Context attaches its
#: logger here
REGISTRY = FaultRegistry()

declare = REGISTRY.declare
check = REGISTRY.check
note = REGISTRY.note

#: a call through the mesh's dispatch choke point (parallel/mesh.py)
F_DISPATCH = declare("api.mesh.dispatch")
#: a replayed loop iteration (api/loop.py): a fire falls back to a plain,
#: re-captured iteration
F_LOOP_REPLAY = declare("api.loop.replay")


def fuse_site(label: str) -> str:
    """The ``api.fuse.<label>`` site of an op stitched into a program
    (api/fusion.py)."""
    return declare("api.fuse." + label)


class inject:
    """Arm a site for the length of a ``with`` block; composes with an
    existing spec by appending, and restores it on exit."""

    def __init__(self, pattern: str, p: float = 1.0, n: int = 1,
                 seed: int = 0, after: int = 0) -> None:
        self.entry = f"{pattern}:p={p}:n={n}:seed={seed}:after={after}"
        self._prev: Optional[str] = None

    def __enter__(self) -> "inject":
        self._prev = os.environ.get(ENV_VAR)
        os.environ[ENV_VAR] = (f"{self._prev};{self.entry}" if self._prev
                               else self.entry)
        return self

    def __exit__(self, *exc) -> None:
        if self._prev is None:
            os.environ.pop(ENV_VAR, None)
        else:
            os.environ[ENV_VAR] = self._prev
