"""Structured JSON event logging (counterpart of the reference package's
``common/logger.py``; Thrill: common/json_logger.hpp).

One JSON object a line, each with a microsecond timestamp ``ts`` taken
from a monotonic clock off one wall-clock anchor, plus the logger's
common fields and the caller's. A child logger (``parent=``) shares its
parent's file, lock and anchor and adds common fields of its own, as
the reference's ``JsonLogger(parent, key, value)``.

No field may hold a tensor: serialising one would copy it to the host
(a device sync on the card), so :func:`_json_default` raises on it.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Optional


class JsonLogger:
    """Append-only JSON-lines event log; thread-safe. A logger without a
    path (and without a parent) is disabled and ``line`` does nothing.
    Closing a child detaches it and leaves the file open."""

    def __init__(self, path: Optional[str] = None,
                 parent: Optional["JsonLogger"] = None,
                 **common: Any) -> None:
        self.parent = parent
        self.common = dict(parent.common) if parent else {}
        self.common.update(common)
        if parent is not None:
            self._file = parent._file
            self._lock = parent._lock
            self._wall0 = parent._wall0
            self._perf0 = parent._perf0
        else:
            self._lock = threading.Lock()
            self._file = open(path, "a", buffering=1) if path else None
            self._wall0 = time.time()
            self._perf0 = time.perf_counter()

    @property
    def enabled(self) -> bool:
        return self._file is not None and not self._file.closed

    def now_us(self) -> int:
        """The event timestamp: the wall anchor plus the monotonic time
        since (shared by child loggers and the tracer)."""
        return self.us_at(time.perf_counter())

    def us_at(self, perf: float) -> int:
        """The timestamp of the ``time.perf_counter()`` reading ``perf``."""
        return int((self._wall0 + (perf - self._perf0)) * 1e6)

    def line(self, **fields: Any) -> None:
        if self._file is None or self._file.closed:
            return
        rec = {"ts": self.now_us()}
        rec.update(self.common)
        rec.update(fields)
        with self._lock:
            self._file.write(json.dumps(rec, default=_json_default) + "\n")

    def close(self) -> None:
        if self._file is not None and self.parent is None:
            self._file.close()
        self._file = None


def _json_default(o: Any) -> Any:
    """numpy scalars and arrays as plain values; a tensor raises (its
    ``str`` would copy it to the host); anything else as its ``str``."""
    import sys
    torch = sys.modules.get("torch")       # no tensor exists without it
    if torch is not None and isinstance(o, torch.Tensor):
        raise TypeError(
            f"a {type(o).__name__} on {o.device} is not a log field: pass "
            f"host ints, floats or strings (serialising it would sync "
            f"the device)")
    try:
        import numpy as np
    except ImportError:
        np = None
    if np is not None:
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
    return str(o)


def default_log_path(pattern: Optional[str],
                     host_rank: int) -> Optional[str]:
    """A ``THRILL_TPU_LOG`` pattern as this host's path: ``{}`` takes the
    rank, else ``-host<rank>`` goes before the extension (``.json`` when
    there is none)."""
    if not pattern:
        return None
    if "{}" in pattern:
        return pattern.format(host_rank)
    base, ext = os.path.splitext(pattern)
    return f"{base}-host{host_rank}{ext or '.json'}"
