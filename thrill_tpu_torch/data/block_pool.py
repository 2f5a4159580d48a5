"""The spill store: byte blocks in RAM up to a soft limit, the coldest
evicted to files beyond it (counterpart of the reference package's
``data/block_pool.py`` in its pure-Python form; Thrill:
thrill/data/block_pool.hpp:42).

Evictions are written synchronously, as the reference's store writes
them with ``THRILL_TPU_WRITEBACK=0``; its write-behind thread and its
native C++ store are not ported. Spill files are named
``ttpu-blk-<pid>-<store>-<block>-<host>.spill`` as the reference names
them, so ``purge_stale_spills`` reclaims the files of dead processes of
either package.
"""

from __future__ import annotations

import glob
import os
import socket
from typing import Dict, Optional

import numpy as np

from ..common.config import Config, parse_si_iec_units


def _sanitized_host() -> str:
    """This host's tag in spill file names (ASCII letters and digits,
    anything else ``_``)."""
    return "".join(c if (c.isascii() and c.isalnum()) else "_"
                   for c in socket.gethostname()) or "unknown"


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


class BlockPool:
    """Immutable byte blocks by id, with a soft RAM limit: past it, the
    least recently stored unpinned blocks go to files in ``spill_dir``
    and come back on ``get``. Blocks shared by several views count their
    references (``addref``/``release``)."""

    def __init__(self, spill_dir: Optional[str] = None,
                 soft_limit: int = 0) -> None:
        self._spill_dir = spill_dir or Config.from_env().spill_dir
        self._soft = int(soft_limit)
        self._host_tag = _sanitized_host()
        self._blocks: Dict[int, bytes] = {}     # resident, oldest first
        self._spilled: Dict[int, str] = {}      # block id -> file
        self._pins: Dict[int, int] = {}
        self._refs: Dict[int, int] = {}         # shared blocks (> 1)
        self._next = 1
        self._mem = 0
        # payload bytes taken by put(), and written to spill files
        self.bytes_put = 0
        self.bytes_spilled = 0

    def _spill_path(self, block_id: int) -> str:
        return os.path.join(
            self._spill_dir,
            f"ttpu-blk-{os.getpid()}-{hex(id(self))}-{block_id}-"
            f"{self._host_tag}.spill")

    def _maybe_spill(self) -> None:
        """Evict the oldest unpinned resident blocks until the resident
        bytes fit the soft limit. A block whose write fails stays
        resident: over the limit beats losing it."""
        if self._soft <= 0 or self._mem <= self._soft:
            return
        victims = [bid for bid in self._blocks
                   if self._pins.get(bid, 0) <= 0]
        for bid in victims:
            if self._mem <= self._soft:
                break
            data = self._blocks[bid]
            path = self._spill_path(bid)
            try:
                os.makedirs(self._spill_dir, exist_ok=True)
                with open(path, "wb") as f:
                    f.write(data)
            except OSError:
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            self._spilled[bid] = path
            del self._blocks[bid]
            self._mem -= len(data)
            self.bytes_spilled += len(data)

    def put(self, data) -> int:
        """Store one block (``bytes`` or a numpy array); returns its
        id."""
        if isinstance(data, np.ndarray):
            data = np.ascontiguousarray(data).tobytes()
        else:
            data = bytes(data)
        bid = self._next
        self._next += 1
        self._blocks[bid] = data
        self._mem += len(data)
        self.bytes_put += len(data)
        self._maybe_spill()
        return bid

    def get(self, block_id: int) -> bytes:
        data = self._blocks.get(block_id)
        if data is not None:
            return data
        path = self._spilled.get(block_id)
        if path is None:
            raise KeyError(f"unknown block {block_id}")
        with open(path, "rb") as f:
            return f.read()

    def pin(self, block_id: int) -> None:
        self._pins[block_id] = self._pins.get(block_id, 0) + 1

    def unpin(self, block_id: int) -> None:
        n = self._pins.get(block_id, 0) - 1
        if n > 0:
            self._pins[block_id] = n
        else:
            self._pins.pop(block_id, None)

    def drop(self, block_id: int) -> None:
        data = self._blocks.pop(block_id, None)
        if data is not None:
            self._mem -= len(data)
        self._pins.pop(block_id, None)
        path = self._spilled.pop(block_id, None)
        if path is not None:
            try:
                os.unlink(path)
            except OSError:
                pass

    def addref(self, block_id: int) -> None:
        """Another view now shares this block."""
        self._refs[block_id] = self._refs.get(block_id, 1) + 1

    def release(self, block_id: int) -> None:
        """One view fewer; the last one drops the block."""
        n = self._refs.get(block_id, 1) - 1
        if n > 0:
            self._refs[block_id] = n
            return
        self._refs.pop(block_id, None)
        self.drop(block_id)

    @property
    def mem_usage(self) -> int:
        return self._mem

    @property
    def num_blocks(self) -> int:
        return len(self._blocks) + len(self._spilled)

    def close(self) -> None:
        """Drop every block and delete every spill file."""
        for path in self._spilled.values():
            try:
                os.unlink(path)
            except OSError:
                pass
        self._spilled.clear()
        self._blocks.clear()
        self._pins.clear()
        self._refs.clear()
        self._mem = 0

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
