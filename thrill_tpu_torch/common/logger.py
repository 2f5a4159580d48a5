"""Structured JSON event logging (counterpart of the reference package's
``common/logger.py``; Thrill: common/json_logger.hpp).

One JSON object a line, each with a microsecond timestamp ``ts`` taken
from a monotonic clock off one wall-clock anchor, plus the logger's
common fields and the caller's.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Optional


class JsonLogger:
    """Append-only JSON-lines event log; thread-safe. A logger without a
    path is disabled and ``line`` does nothing."""

    def __init__(self, path: Optional[str] = None, **common: Any) -> None:
        self.common = dict(common)
        self._lock = threading.Lock()
        self._file = open(path, "a", buffering=1) if path else None
        self._wall0 = time.time()
        self._perf0 = time.perf_counter()

    @property
    def enabled(self) -> bool:
        return self._file is not None and not self._file.closed

    def now_us(self) -> int:
        return int((self._wall0 + (time.perf_counter() - self._perf0))
                   * 1e6)

    def line(self, **fields: Any) -> None:
        if self._file is None or self._file.closed:
            return
        rec = {"ts": self.now_us()}
        rec.update(self.common)
        rec.update(fields)
        with self._lock:
            self._file.write(json.dumps(rec, default=_json_default) + "\n")

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
        self._file = None


def _json_default(o: Any) -> Any:
    import numpy as np
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
