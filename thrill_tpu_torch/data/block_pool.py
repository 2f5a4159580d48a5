"""The spill store: byte blocks in RAM up to a soft limit, the coldest
evicted to files beyond it (counterpart of the reference package's
``data/block_pool.py``; Thrill: thrill/data/block_pool.hpp:42).

Bytes live in the native C++ store (``native/blockstore.cpp``, built
with ``g++`` at first use; ``BlockPool.native`` says so) and Python
handles ids only: ``put`` hands an array over by pointer, ``get_into``
reads a block straight into the caller's buffer, and the store's writer
thread spills without blocking ``put``. Without a compiler the Python
store runs the same ladder: its evictions go through the write-behind
of ``data/writeback.py`` (``THRILL_TPU_WRITEBACK=0`` writes them on the
caller's thread), and a block leaves RAM only once its file is written.

Spill files are named ``ttpu-blk-<pid>-<store>-<block>.<seq>-<host>.spill``:
the fields of the reference's names, with a per-spill sequence number
inside the block field so that two spills of one block never share a
file (fault C13). ``purge_stale_spills`` reads the pid and the host
alone, so it reclaims the files of dead processes of either package.
"""

from __future__ import annotations

import ctypes
import glob
import os
import socket
import threading
from typing import Dict, Optional

import numpy as np

from ..common import faults
from ..common.config import Config, parse_si_iec_units
from ..common.native_build import load_host
from ..common.retry import default_policy
from .writeback import AsyncWriter, writeback_enabled

# put allocates a fresh id and get reads immutable bytes, so transient
# storage faults retry under the shared policy before surfacing
_F_PUT = faults.declare("data.blockstore.put")
_F_GET = faults.declare("data.blockstore.get")

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def _sanitized_host() -> str:
    """This host's tag in spill file names (ASCII letters and digits,
    anything else ``_``), as the native store writes it."""
    return "".join(c if (c.isascii() and c.isalnum()) else "_"
                   for c in socket.gethostname()) or "unknown"


def _load_native() -> Optional[ctypes.CDLL]:
    """The native store's library with its signatures, or None when it
    cannot be built (``common/native_build.py`` says why on stderr)."""
    global _LIB, _LIB_TRIED
    with _LIB_LOCK:
        if _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        lib = load_host("blockstore")
        if lib is None:
            return None
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        for name, res, args in (
                ("bs_create", vp, [ctypes.c_char_p, i64, ctypes.c_int]),
                ("bs_destroy", None, [vp]),
                ("bs_flush", None, [vp]),
                ("bs_pending", i64, [vp]),
                ("bs_hold_writer", i64, [vp, ctypes.c_int]),
                ("bs_put", i64, [vp, vp, i64]),
                ("bs_size", i64, [vp, i64]),
                ("bs_get", ctypes.c_int, [vp, i64, vp]),
                ("bs_pin", ctypes.c_int, [vp, i64]),
                ("bs_unpin", ctypes.c_int, [vp, i64]),
                ("bs_drop", None, [vp, i64]),
                ("bs_resident", ctypes.c_int, [vp, i64]),
                ("bs_mem_usage", i64, [vp]),
                ("bs_spilled_bytes", i64, [vp]),
                ("bs_num_blocks", i64, [vp])):
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _LIB = lib
        return _LIB


def resident_override() -> Optional[int]:
    """``THRILL_TPU_SPILL_RESIDENT``: the resident bytes of every spill
    store (SI/IEC suffixes, at least 64 KiB) in place of the owner's
    sizing; None when unset or unreadable."""
    env = os.environ.get("THRILL_TPU_SPILL_RESIDENT")
    if not env:
        return None
    try:
        return max(parse_si_iec_units(env), 1 << 16)
    except (ValueError, TypeError):
        return None


def spill_pool(spill_dir: str, mem_limit) -> "BlockPool":
    """The external-memory operators' spill store: a quarter of the
    grant stays resident (at least 8 MiB; 64 MiB without a grant)."""
    soft = resident_override()
    if soft is None:
        soft = max((mem_limit or 256 << 20) // 4, 8 << 20)
    return BlockPool(spill_dir=spill_dir, soft_limit=soft)


def _as_bytes_view(data) -> np.ndarray:
    """``data`` (bytes-like or a numpy array) as a flat C-contiguous
    uint8 array over the same memory where it can be."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return np.frombuffer(memoryview(data), dtype=np.uint8)


class BlockPool:
    """Immutable byte blocks by id, with a soft RAM limit: past it, the
    least recently used unpinned blocks go to files in ``spill_dir`` and
    come back on ``get``. Blocks shared by several views count their
    references (``addref``/``release``). ``use_native=False`` takes the
    Python store even where the native one builds."""

    def __init__(self, spill_dir: Optional[str] = None,
                 soft_limit: int = 0, use_native: bool = True) -> None:
        self._spill_dir = spill_dir or Config.from_env().spill_dir
        self._soft = int(soft_limit)
        self._lib = _load_native() if use_native else None
        self.native = self._lib is not None
        self._policy = default_policy()
        self._refs: Dict[int, int] = {}         # shared blocks (> 1)
        self._ref_lock = threading.Lock()
        # payload bytes taken by put()
        self.bytes_put = 0
        self._spilled_final: Optional[int] = None
        if self.native:
            os.makedirs(self._spill_dir, exist_ok=True)
            # 1: the store's writer thread spills, put never waits
            self._h = self._lib.bs_create(self._spill_dir.encode(),
                                          self._soft, 1)
            return
        self._host_tag = _sanitized_host()
        self._blocks: Dict[int, bytes] = {}     # resident, oldest first
        self._spilled: Dict[int, str] = {}      # block id -> file
        self._pins: Dict[int, int] = {}
        self._inflight: Dict[int, int] = {}     # block id -> bytes
        self._next = 1
        self._spill_seq = 0
        self._mem = 0
        self._bytes_spilled = 0
        self._lock = threading.RLock()
        self._writer = None

    # -- the Python store's spill ladder ----------------------------------
    def _spill_path(self, block_id: int) -> str:
        with self._lock:
            self._spill_seq += 1
            seq = self._spill_seq
        return os.path.join(
            self._spill_dir,
            f"ttpu-blk-{os.getpid()}-{hex(id(self))}-{block_id}.{seq}-"
            f"{self._host_tag}.spill")

    def _maybe_spill(self) -> None:
        """Evict the oldest unpinned resident blocks until the resident
        bytes (less those being written) fit the soft limit."""
        if self._soft <= 0 or self._mem <= self._soft:
            return
        if writeback_enabled() and self._writer is None:
            self._writer = AsyncWriter("data.blockpool.spill", poison=False,
                                       on_error=self._spill_failed)
        with self._lock:
            projected = self._mem - sum(self._inflight.values())
            victims = []
            for bid, data in self._blocks.items():
                if projected <= self._soft:
                    break
                if self._pins.get(bid, 0) > 0 or bid in self._inflight:
                    continue
                victims.append((bid, data))
                self._inflight[bid] = len(data)
                projected -= len(data)
        for bid, data in victims:
            if self._writer is None:
                self._spill_job(bid, data)
            else:
                self._writer.submit(
                    lambda bid=bid, data=data: self._spill_job(bid, data),
                    tag=bid)

    def _spill_failed(self, exc: BaseException, bid) -> None:
        with self._lock:
            self._inflight.pop(bid, None)

    def _spill_job(self, bid: int, data: bytes) -> int:
        """Write one evicted block; the block leaves RAM only when its
        file is whole. A failed write keeps it resident: over the limit
        beats losing it."""
        path = self._spill_path(bid)
        try:
            os.makedirs(self._spill_dir, exist_ok=True)
            with open(path, "wb") as f:
                f.write(data)
        except OSError as e:
            try:
                os.unlink(path)
            except OSError:
                pass
            faults.note("recovery", what="blockpool.spill_skipped",
                        block=bid, error=repr(e)[:200])
            with self._lock:
                self._inflight.pop(bid, None)
            return 0
        with self._lock:
            self._inflight.pop(bid, None)
            self._bytes_spilled += len(data)
            if bid not in self._blocks or self._pins.get(bid, 0) > 0:
                # dropped or pinned meanwhile: RAM stays authoritative
                try:
                    os.unlink(path)
                except OSError:
                    pass
                return len(data)
            self._spilled[bid] = path
            del self._blocks[bid]
            self._mem -= len(data)
        return len(data)

    # -- the interface ------------------------------------------------------
    def put(self, data) -> int:
        """Store one block (bytes or a numpy array, copied); returns its
        id. The native store takes an array by pointer."""
        return self._policy.run(lambda: self._put_once(data),
                                what="blockstore.put")

    def _put_once(self, data) -> int:
        arr = _as_bytes_view(data)
        n = int(arr.nbytes)
        faults.check(_F_PUT, nbytes=n)
        self.bytes_put += n
        if self.native:
            return self._lib.bs_put(self._h,
                                    arr.ctypes.data_as(ctypes.c_void_p), n)
        with self._lock:
            bid = self._next
            self._next += 1
            self._blocks[bid] = arr.tobytes()
            self._mem += n
        self._maybe_spill()
        return bid

    def size(self, block_id: int) -> int:
        """Bytes of a block (KeyError when unknown)."""
        if self.native:
            n = self._lib.bs_size(self._h, block_id)
        else:
            with self._lock:
                data = self._blocks.get(block_id)
                path = self._spilled.get(block_id)
            n = (len(data) if data is not None else
                 os.path.getsize(path) if path is not None else -1)
        if n < 0:
            raise KeyError(f"unknown block {block_id}")
        return int(n)

    def get(self, block_id: int) -> bytes:
        n = self.size(block_id)
        out = np.empty(max(n, 1), dtype=np.uint8)
        self.get_into(block_id, out)
        return out[:n].tobytes()

    def get_into(self, block_id: int, out: np.ndarray) -> None:
        """Copy a block into ``out`` (a writable C-contiguous array of at
        least its size); the native store writes it without a copy in
        Python and without the GIL."""
        self._policy.run(lambda: self._get_into_once(block_id, out),
                         what="blockstore.get")

    def _get_into_once(self, block_id: int, out: np.ndarray) -> None:
        faults.check(_F_GET, block=block_id)
        n = self.size(block_id)
        if out.nbytes < n or not out.flags.c_contiguous:
            raise ValueError(f"block {block_id}: {n} bytes do not fit a "
                             f"buffer of {out.nbytes}")
        if self.native:
            rc = self._lib.bs_get(self._h, block_id,
                                  out.ctypes.data_as(ctypes.c_void_p))
            if rc == -1:
                raise KeyError(f"unknown block {block_id}")
            if rc != 0:
                raise IOError(f"block {block_id} fetch failed rc={rc}")
            return
        dst = out.reshape(-1).view(np.uint8)
        with self._lock:
            data = self._blocks.get(block_id)
            path = self._spilled.get(block_id)
        if data is not None:
            dst[:n] = np.frombuffer(data, dtype=np.uint8)
            return
        if path is None:
            raise KeyError(f"unknown block {block_id}")
        with open(path, "rb") as f:
            if f.readinto(memoryview(dst[:n])) != n:
                raise IOError(f"block {block_id}: short read of {path}")

    def resident(self, block_id: int) -> bool:
        """Is the block served from RAM (no disk read)? Unknown ids say
        True: the demand read is where they surface."""
        if self.native:
            return self._lib.bs_resident(self._h, block_id) != 0
        with self._lock:
            return block_id in self._blocks or block_id not in self._spilled

    def pin(self, block_id: int) -> None:
        """Keep a block in RAM (read back from disk if it is there)."""
        if self.native:
            self._lib.bs_pin(self._h, block_id)
            return
        with self._lock:
            path = self._spilled.pop(block_id, None)
            if path is not None:
                with open(path, "rb") as f:
                    data = f.read()
                os.unlink(path)
                self._blocks[block_id] = data
                self._mem += len(data)
            self._pins[block_id] = self._pins.get(block_id, 0) + 1

    def unpin(self, block_id: int) -> None:
        if self.native:
            self._lib.bs_unpin(self._h, block_id)
            return
        with self._lock:
            n = self._pins.get(block_id, 0) - 1
            if n > 0:
                self._pins[block_id] = n
            else:
                self._pins.pop(block_id, None)
        self._maybe_spill()

    def drop(self, block_id: int) -> None:
        if self.native:
            self._lib.bs_drop(self._h, block_id)
            return
        with self._lock:
            data = self._blocks.pop(block_id, None)
            if data is not None:
                self._mem -= len(data)
            self._pins.pop(block_id, None)
            self._inflight.pop(block_id, None)
            path = self._spilled.pop(block_id, None)
        if path is not None:
            try:
                os.unlink(path)
            except OSError:
                pass

    def addref(self, block_id: int) -> None:
        """Another view now shares this block."""
        with self._ref_lock:
            self._refs[block_id] = self._refs.get(block_id, 1) + 1

    def release(self, block_id: int) -> None:
        """One view fewer; the last one drops the block."""
        with self._ref_lock:
            n = self._refs.get(block_id, 1) - 1
            if n > 0:
                self._refs[block_id] = n
                return
            self._refs.pop(block_id, None)
        self.drop(block_id)

    def flush(self) -> None:
        """Wait for every queued spill write."""
        if self.native:
            if self._h:
                self._lib.bs_flush(self._h)
        elif self._writer is not None:
            self._writer.flush()

    @property
    def pending_spills(self) -> int:
        if self.native:
            return int(self._lib.bs_pending(self._h)) if self._h else 0
        with self._lock:
            return len(self._inflight)

    @property
    def bytes_spilled(self) -> int:
        """Bytes written to spill files so far."""
        if self._spilled_final is not None:
            return self._spilled_final
        if self.native:
            return int(self._lib.bs_spilled_bytes(self._h))
        return self._bytes_spilled

    @property
    def mem_usage(self) -> int:
        if self.native:
            return int(self._lib.bs_mem_usage(self._h)) if self._h else 0
        with self._lock:
            return self._mem

    @property
    def num_blocks(self) -> int:
        if self.native:
            return int(self._lib.bs_num_blocks(self._h)) if self._h else 0
        with self._lock:
            return len(self._blocks) + len(self._spilled)

    def close(self) -> None:
        """Drop every block and delete every spill file."""
        if self._spilled_final is not None:
            return
        if self.native:
            # the store drains its queue before it goes, so the count is
            # final after the flush
            self._lib.bs_flush(self._h)
            self._spilled_final = int(self._lib.bs_spilled_bytes(self._h))
            self._lib.bs_destroy(self._h)
            self._h = None
            return
        if self._writer is not None:
            # the backlog's blocks are still resident: nothing is lost
            self._writer.close(drain=False)
            self._writer = None
        with self._lock:
            for path in self._spilled.values():
                try:
                    os.unlink(path)
                except OSError:
                    pass
            self._spilled.clear()
            self._blocks.clear()
            self._pins.clear()
            self._inflight.clear()
            self._mem = 0
        self._refs.clear()
        self._spilled_final = self._bytes_spilled

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def purge_stale_spills(spill_dir: str) -> int:
    """Delete the spill files in ``spill_dir`` of processes of this host
    that no longer run (a killed process never closes its stores); files
    of other hosts are left alone. Returns how many went."""
    my_host = _sanitized_host()
    removed = 0
    for path in glob.glob(os.path.join(spill_dir, "ttpu-blk-*.spill")):
        parts = os.path.basename(path)[:-len(".spill")].split("-")
        try:
            pid = int(parts[2])
            host = "-".join(parts[5:])
        except (IndexError, ValueError):
            continue
        if host != my_host or pid == os.getpid():
            continue
        try:
            os.kill(pid, 0)
            continue                   # the owner runs
        except ProcessLookupError:
            pass
        except OSError:
            continue                   # runs as another user, or unknown
        try:
            os.unlink(path)
            removed += 1
        except OSError:
            pass
    return removed
