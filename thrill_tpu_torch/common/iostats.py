"""Process-wide out-of-core I/O counters (counterpart of the reference
package's ``common/iostats.py``).

The spill tier runs its I/O on background threads (write-behind in
``data/writeback.py``, block readahead in ``data/file.py``); this is
the one ledger they share, so a caller can read the structure of the
overlap instead of inferring it from totals:

* ``prefetch_hits`` / ``prefetch_misses``: a consumer needing the next
  block found it already fetched (hit) or had to wait or read it
  itself (miss);
* ``io_wait_s``: foreground seconds blocked on background I/O (a full
  write-behind queue, a flush barrier, a readahead still in flight);
* ``io_busy_s``: seconds background threads spent inside reads and
  writes; :func:`overlap_frac` is ``1 - io_wait_s / io_busy_s``;
* ``writeback_bytes`` / ``writeback_queue_peak``: bytes written through
  write-behind and the deepest its queue got;
* ``spill_runs``, ``prefetch_submits``, ``records_blocks`` and
  ``runs_reused`` (sorted runs handed to the spiller, readahead jobs
  submitted, columnar blocks the records format encoded, committed runs
  a resumed Sort loaded instead of forming them, core/em_runs.py) are
  exact for a fixed program; ``restore_overlaps`` counts checkpoint
  restores that read a shard file ahead;
* ``remote_gets`` / ``remote_puts``: the requests the object-store
  transport sent (``vfs/object_store.py``: a GET for each ranged read
  stream, a PUT for each object or multipart part), exact for a fixed
  program, so a silent fall back to whole-object reads shows.

Counters are process-global (the threads have no Context); a caller
snapshots them and reports deltas.
"""

from __future__ import annotations

import threading

_COUNTERS = ("prefetch_hits", "prefetch_misses", "io_wait_s",
             "io_busy_s", "writeback_bytes", "spill_runs",
             "prefetch_submits", "records_blocks", "runs_reused",
             "restore_overlaps", "remote_gets", "remote_puts")


class IoStats:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.io_wait_s = 0.0
        self.io_busy_s = 0.0
        self.writeback_bytes = 0
        self.writeback_queue_peak = 0
        self.spill_runs = 0
        self.prefetch_submits = 0
        self.records_blocks = 0
        self.runs_reused = 0
        self.restore_overlaps = 0
        self.remote_gets = 0
        self.remote_puts = 0

    def add(self, **kv) -> None:
        with self._lock:
            for k, v in kv.items():
                setattr(self, k, getattr(self, k) + v)

    def note_queue_depth(self, depth: int) -> None:
        with self._lock:
            if depth > self.writeback_queue_peak:
                self.writeback_queue_peak = depth

    def snapshot(self) -> dict:
        with self._lock:
            out = {k: getattr(self, k) for k in _COUNTERS}
            out["writeback_queue_peak"] = self.writeback_queue_peak
            return out

    @staticmethod
    def delta(now: dict, base: dict) -> dict:
        """Counters since ``base``; the queue peak is a high-water mark,
        not a flow, so it reports raw."""
        out = {k: now[k] - base.get(k, 0) for k in _COUNTERS}
        out["io_wait_s"] = round(out["io_wait_s"], 4)
        out["io_busy_s"] = round(out["io_busy_s"], 4)
        out["writeback_queue_peak"] = now["writeback_queue_peak"]
        return out


def overlap_frac(stats: dict) -> float:
    """Fraction of background-I/O busy time the foreground did NOT
    wait for, clamped to [0, 1]; 0.0 when no background I/O ran."""
    busy = stats.get("io_busy_s", 0.0)
    if busy <= 0:
        return 0.0
    return max(0.0, min(1.0, 1.0 - stats.get("io_wait_s", 0.0) / busy))


def hit_rate(stats: dict) -> float:
    """Prefetch hit fraction; 0.0 with no prefetch consumption."""
    n = stats.get("prefetch_hits", 0) + stats.get("prefetch_misses", 0)
    return (stats.get("prefetch_hits", 0) / n) if n else 0.0


#: the process-wide ledger the background readers and writers add to
IO = IoStats()
