"""Bounded write-behind and block readahead: the overlap of the spill
tier (counterpart of the reference package's ``data/writeback.py``,
without its trace spans). Both sides add to the I/O ledger
(``common/iostats.py``): busy and wait seconds, bytes written, the
queue's peak, readahead hits, misses and submissions.

:class:`AsyncWriter` runs write jobs on ONE background thread in FIFO
order behind a bounded queue (:data:`QUEUE_DEPTH` jobs):
submission order is completion order, a full queue blocks the submitter,
and a job's error is raised on the submitting thread at the next
``submit``/``flush``/``close`` (``poison=False`` writers hand it to
``on_error`` instead and go on). ``THRILL_TPU_WRITEBACK=0`` runs every
job inline on the caller.

:func:`make_readahead` and :func:`overlapped_fetch` are the read side:
the next block's fetch runs on a short-lived pool while the caller
consumes the current one; a failed or not yet started background fetch
falls back to the demand read on the caller's thread.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional

from ..common import faults
from ..common.config import _env_flag
from ..common.iostats import IO as _IOSTATS

#: most write jobs waiting behind the running one
QUEUE_DEPTH = 2


def writeback_enabled() -> bool:
    """``THRILL_TPU_WRITEBACK=0`` writes spills on the caller's thread."""
    return _env_flag("THRILL_TPU_WRITEBACK", True)


class AsyncWriter:
    """Single-threaded bounded write-behind queue (see the module)."""

    def __init__(self, what: str, depth: Optional[int] = None,
                 sync: Optional[bool] = None, poison: bool = True,
                 on_error: Optional[Callable[[BaseException, Any],
                                             None]] = None) -> None:
        self.what = what
        self.sync = (not writeback_enabled()) if sync is None else sync
        self.depth = QUEUE_DEPTH if depth is None else depth
        self.poison = poison
        self.on_error = on_error
        self._cv = threading.Condition()
        self._jobs: collections.deque = collections.deque()
        self._err: Optional[BaseException] = None
        self._closed = False
        self._idle = True
        self._t: Optional[threading.Thread] = None
        self.jobs_run = 0
        self.bytes_written = 0

    def _ensure_thread(self) -> None:
        if self._t is None:
            self._t = threading.Thread(target=self._run, daemon=True,
                                       name="thrill-tpu-torch-writeback")
            self._t.start()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._jobs and not self._closed:
                    self._idle = True
                    self._cv.notify_all()
                    self._cv.wait(0.1)
                if not self._jobs and self._closed:
                    self._idle = True
                    self._cv.notify_all()
                    return
                fn, tag = self._jobs.popleft()
                self._idle = False
                self._cv.notify_all()
            try:
                t0 = time.perf_counter()
                nbytes = int(fn() or 0)
                _IOSTATS.add(io_busy_s=time.perf_counter() - t0,
                             writeback_bytes=nbytes)
                with self._cv:
                    self.jobs_run += 1
                    self.bytes_written += nbytes
                    self._cv.notify_all()
            except BaseException as e:
                if self.poison:
                    # the backlog's files will never be read: the error
                    # surfaces first
                    with self._cv:
                        self._err = e
                        self._jobs.clear()
                        self._idle = True
                        self._cv.notify_all()
                    return
                faults.note("recovery", what=f"{self.what}.degraded",
                            error=repr(e)[:200])
                if self.on_error is not None:
                    try:
                        self.on_error(e, tag)
                    except Exception:
                        pass
                with self._cv:
                    self._cv.notify_all()

    def _raise_pending(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            self._closed = True
            raise err

    def submit(self, fn: Callable[[], Any], tag: Any = None) -> None:
        """Queue one job (``fn() -> bytes written``); inline when sync.
        Blocks while ``depth`` jobs wait; raises a pending error."""
        if self.sync:
            nbytes = int(fn() or 0)
            _IOSTATS.add(writeback_bytes=nbytes)
            with self._cv:
                self.jobs_run += 1
                self.bytes_written += nbytes
            return
        self._ensure_thread()
        t0 = None
        with self._cv:
            self._raise_pending()
            if self._closed:
                raise RuntimeError(f"{self.what}: writer is closed")
            while len(self._jobs) >= self.depth and self._err is None:
                if t0 is None:
                    t0 = time.perf_counter()
                self._cv.wait(0.1)
            self._raise_pending()
            self._jobs.append((fn, tag))
            depth_now = len(self._jobs) + (0 if self._idle else 1)
            self._cv.notify_all()
        if t0 is not None:
            _IOSTATS.add(io_wait_s=time.perf_counter() - t0)
        _IOSTATS.note_queue_depth(depth_now)

    def flush(self) -> None:
        """Wait until every queued job is done; raises the writer's
        error here, before anyone reads what it should have written."""
        if self.sync or self._t is None:
            self._raise_pending()
            return
        t0 = time.perf_counter()
        with self._cv:
            while (self._jobs or not self._idle) and self._err is None:
                self._cv.wait(0.1)
            dt = time.perf_counter() - t0
            self._raise_pending()
        if dt > 1e-4:
            _IOSTATS.add(io_wait_s=dt)

    def close(self, drain: bool = True) -> None:
        """Stop the writer: ``drain=True`` flushes first (and raises a
        pending error), ``drain=False`` drops the backlog. Returns only
        when the thread has ended, so no job outlives its store."""
        if self._t is None:
            if drain:
                self._raise_pending()
            self._closed = True
            return
        try:
            if drain:
                self.flush()
        finally:
            with self._cv:
                self._closed = True
                if not drain:
                    self._jobs.clear()
                    self._err = None
                self._cv.notify_all()
            self._t.join(timeout=30)
            while self._t.is_alive():
                print(f"thrill_tpu_torch.writeback: {self.what} writer "
                      f"still writing; waiting before teardown",
                      file=sys.stderr)
                self._t.join(timeout=30)

    def __enter__(self) -> "AsyncWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        self.close(drain=exc_type is None)


def make_readahead(depth: int, workers: int = 0
                   ) -> Optional[ThreadPoolExecutor]:
    """A short-lived readahead pool for one operation, or None when
    prefetch is off (``depth`` <= 0); the caller shuts it down."""
    if depth <= 0:
        return None
    return ThreadPoolExecutor(
        max_workers=workers or max(2, min(depth, 8)),
        thread_name_prefix="thrill-tpu-torch-readahead")


def readahead_get(fut, demand: Callable[[], Any], what: str) -> Any:
    """One readahead future's result: a future not yet started is
    cancelled and a failed one noted, both replaced by the demand read
    (misses); one still running is waited for (a miss, its wait
    counted); one done is a hit."""
    if fut is None:
        return demand()
    waited = False
    if not fut.done():
        if fut.cancel():
            _IOSTATS.add(prefetch_misses=1)
            return demand()
        t0 = time.perf_counter()
        try:
            fut.result()
        except BaseException:
            pass
        _IOSTATS.add(prefetch_misses=1, io_wait_s=time.perf_counter() - t0)
        waited = True
    try:
        out = fut.result()
    except BaseException as e:
        if not waited:
            _IOSTATS.add(prefetch_misses=1)
        faults.note("recovery", what=f"{what}.prefetch_degraded",
                    error=repr(e)[:200])
        return demand()
    if not waited:
        _IOSTATS.add(prefetch_hits=1)
    return out


def readahead_job(fn: Callable[[], Any]) -> Callable[[], Any]:
    """``fn`` as a readahead job: one submission counted, its seconds
    counted busy."""
    _IOSTATS.add(prefetch_submits=1)

    def job():
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            _IOSTATS.add(io_busy_s=time.perf_counter() - t0)
    return job


def overlapped_fetch(items, fetch: Callable[[Any], Any], what: str,
                     ra: Optional[ThreadPoolExecutor],
                     skip_fn: Optional[Callable[[Any], bool]] = None,
                     stats: Optional[dict] = None):
    """Yield ``(item, fetch(item))`` with the next item's fetch in
    flight on ``ra`` while the caller consumes the current one.
    ``skip_fn`` marks items cheap to fetch inline; ``stats["prefetched"]``
    counts the fetches sent to the pool. ``ra=None`` fetches in turn."""
    items = list(items)
    fut = None
    for j, it in enumerate(items):
        nxt = None
        if ra is not None and j + 1 < len(items):
            nit = items[j + 1]
            if skip_fn is None or not skip_fn(nit):
                nxt = ra.submit(readahead_job(lambda nit=nit: fetch(nit)))
                if stats is not None:
                    stats["prefetched"] = stats.get("prefetched", 0) + 1
        out = readahead_get(fut, lambda it=it: fetch(it), what)
        fut = nxt
        yield it, out
