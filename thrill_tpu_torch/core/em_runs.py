"""Resumable runs of the external-memory Sort: a spilled run is a
checkpoint (counterpart of the reference package's ``core/em_runs.py``).

With a checkpoint directory, the job that spills a run also writes its
blocks to ``<ckpt_dir>/em_runs/<signature>/run_<slot>.bin`` and, once
those bytes are on storage, a JSON manifest with their CRC beside them
(``write_file_atomic``, as the epochs commit): a SIGKILL at any point
leaves a committed run or nothing visible.

Run again with ``resume=True``, the Sort streams its input again (the
reservoir must see the same items for the same splitters), but a run
whose committed manifest matches (slot, first position, length and the
first item's fingerprint) is loaded instead of sorted, serialized and
written. Each counts ``runs_reused`` (common/iostats.py) and
``resume_skipped_runs`` (the checkpoint manager). A missing manifest
forms the run again silently (the crash came before the commit); a
corrupt or mismatching one says so (``faults.note("recovery",
what="em_runs.manifest_invalid")``) and forms it again.

The signature pins (node id, label, W, run size, input size, host
rank), so the same program maps each Sort to the same directory.
``THRILL_TPU_EM_RESUME=0`` turns the store off. No entry point raises:
a store failure leaves the sort without resume.

Not ported (ROADMAP item 6, its checkpoint part): orphan adoption (``adopt_orphan_runs``,
``OWNER.json``/``ADOPTED.json``) and remote stores.
"""

from __future__ import annotations

import json
import os
import pickle
import struct
import threading
import zlib
from typing import Optional, Tuple

from ..common import faults

# armed at the manifest's commit and at its load
_F_MANIFEST = faults.declare("em.run.manifest")

_MAGIC = 0x454D5231  # "EMR1"

# width of the pool that commits runs (and, on resume, reads manifests
# and keeps bins in flight): the reference's default, which nothing sets
COMMIT_CONC = 4


def _enabled() -> bool:
    return os.environ.get("THRILL_TPU_EM_RESUME", "1") != "0"


def fingerprint(item) -> int:
    """CRC of the first item of a run in arrival order; with (slot,
    pos0, n) it pins the run to its place in its input."""
    try:
        return zlib.crc32(pickle.dumps(item, protocol=4)) & 0xFFFFFFFF
    except Exception:
        return 0


def store_for(ctx, node_id: int, label: str, W: int, run_size: int,
              total: int) -> Optional["RunStore"]:
    """The run store of one external Sort, or None without a checkpoint
    manager or with ``THRILL_TPU_EM_RESUME=0``."""
    ckpt = getattr(ctx, "checkpoint", None)
    if ckpt is None or not _enabled():
        return None
    try:
        sig = (f"n{node_id}_{label.lower()}_w{W}_r{run_size}"
               f"_t{total}_h{getattr(ctx, 'host_rank', 0)}")
        return RunStore(os.path.join(ckpt.dir.rstrip("/"), "em_runs", sig),
                        mgr=ckpt)
    except Exception as e:
        faults.note("recovery", what="em_runs.store_unavailable",
                    error=repr(e)[:200])
        return None


class RunStore:
    """Commit and reload of one Sort's spilled runs. ``commit`` runs in
    the spill job (or a pool thread) once the run's blocks are in the
    block store; ``try_load`` runs on the main thread before a run's job
    would be submitted."""

    def __init__(self, base: str, mgr=None) -> None:
        self.base = base
        self.mgr = mgr          # the CheckpointManager (resume counters)
        self.resume = bool(getattr(mgr, "resume", False))
        # commits of different runs are independent: a small pool
        # overlaps them, unless write-behind is off
        # (THRILL_TPU_WRITEBACK=0 commits in the caller's thread)
        self._pool = None
        self._pending: list = []
        # resume: one listing and every manifest read in flight from
        # construction on, while the Sort streams its input; bins ride a
        # window of readahead
        self._manfut: dict = {}             # manifest path -> Future
        self._committed: Optional[set] = None   # slots listed
        self._binfut: dict = {}             # bin path -> Future
        self._warm_evt: Optional[threading.Event] = None
        os.makedirs(base, exist_ok=True)
        if self.resume:
            self._warm_evt = threading.Event()
            threading.Thread(target=self._warm_bg, daemon=True,
                             name="thrill-tpu-em-warm").start()

    def _commit_async(self) -> bool:
        from ..data.writeback import writeback_enabled
        return writeback_enabled()

    def _ensure_pool(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=COMMIT_CONC,
                thread_name_prefix="thrill-tpu-em-commit")
        return self._pool

    @staticmethod
    def _read_path(path: str) -> bytes:
        with open(path, "rb") as r:
            return r.read()

    def _paths(self, slot: int) -> Tuple[str, str]:
        return (os.path.join(self.base, f"run_{slot:06d}.bin"),
                os.path.join(self.base, f"run_{slot:06d}.json"))

    # -- the bin's layout -----------------------------------------------
    @staticmethod
    def _pack_file(f) -> bytes:
        """A File's blocks as ``[u32 nblocks]`` and, a block at a time,
        ``[u32 lo][u32 hi][u64 len][payload]``."""
        parts = [struct.pack("<I", len(f.blocks))]
        for b in f.blocks:
            payload = f.pool.get(b.bid)
            parts.append(struct.pack("<IIQ", b.lo, b.hi, len(payload)))
            parts.append(payload)
        return b"".join(parts)

    @staticmethod
    def _unpack_file(body: bytes, off: int, pool, block_items: int):
        from ..data.block import Block
        from ..data.file import File
        (nblocks,) = struct.unpack_from("<I", body, off)
        off += 4
        f = File(pool=pool, block_items=block_items)
        for _ in range(nblocks):
            lo, hi, plen = struct.unpack_from("<IIQ", body, off)
            off += 16
            payload = body[off:off + plen]
            if len(payload) != plen:
                raise ValueError("truncated run payload")
            off += plen
            f.blocks.append(Block(pool, pool.put(payload), lo, hi))
        return f, off

    # -- commit ---------------------------------------------------------
    def commit(self, slot: int, pos0: int, n: int, fp: int, f,
               kf=None) -> bool:
        """Persist one spilled run: the bin first, the manifest (the
        commit) after it. A failure is noted and leaves the run without
        resume."""
        from ..vfs.file_io import write_file_atomic
        bin_path, man_path = self._paths(slot)
        try:
            body = struct.pack("<I", _MAGIC) + self._pack_file(f)
            has_keys = kf is not None and kf.blocks
            body += self._pack_file(kf) if has_keys else struct.pack("<I", 0)
            write_file_atomic(bin_path, body)
            faults.check(_F_MANIFEST, path=man_path, op="commit")
            manifest = {"slot": slot, "pos0": pos0, "n": n, "fp": fp,
                        "crc": zlib.crc32(body) & 0xFFFFFFFF,
                        "bin_bytes": len(body),
                        "has_keys": bool(has_keys)}
            write_file_atomic(man_path, json.dumps(manifest).encode("ascii"))
            if self._committed is not None:
                self._committed.add(slot)
            return True
        except Exception as e:
            faults.note("recovery", what="em_runs.commit_failed",
                        slot=slot, error=repr(e)[:200])
            return False

    def submit_commit(self, slot: int, pos0: int, n: int, fp: int, f,
                      kf=None) -> None:
        """Commit on the pool (in this thread without write-behind); the
        run's blocks no longer change, so packing them races nothing.
        ``drain`` joins the commits."""
        if not self._commit_async():
            self.commit(slot, pos0, n, fp, f, kf)
            return
        try:
            self._pending.append(self._ensure_pool().submit(
                self.commit, slot, pos0, n, fp, f, kf))
        except Exception as e:
            faults.note("recovery", what="em_runs.commit_failed",
                        slot=slot, error=repr(e)[:200])

    def drain(self) -> None:
        """Join every commit in flight (the Sort's barrier before the
        merge consumes the blocks); never raises."""
        pending, self._pending = self._pending, []
        for fut in pending:
            try:
                fut.result()
            except Exception:
                pass

    def close(self) -> None:
        self.drain()
        self._binfut.clear()
        self._manfut.clear()
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    # -- reuse ----------------------------------------------------------
    def _warm_bg(self) -> None:
        try:
            self._warm()
            if self._committed:
                self._prefetch_bins(min(self._committed))
        except Exception as e:
            faults.note("recovery", what="em_runs.warm_failed",
                        error=repr(e)[:200])
        finally:
            self._warm_evt.set()

    def _warm(self) -> None:
        """List the committed manifests and start reading each; a slot
        missing from the listing costs no read at all."""
        try:
            from ..vfs.file_io import Glob
            listed = [fi.path for fi in
                      Glob(os.path.join(self.base, "run_*.json")).files]
        except Exception as e:
            faults.note("recovery", what="em_runs.warm_failed",
                        error=repr(e)[:200])
            return                # per-slot reads then
        committed = set()
        for p in listed:
            stem = os.path.basename(p)
            try:
                committed.add(int(stem[len("run_"):-len(".json")]))
            except ValueError:
                pass
        ex = self._ensure_pool()
        self._manfut = {p: ex.submit(self._read_path, p) for p in listed}
        self._committed = committed

    def _prefetch_bins(self, slot: int) -> None:
        """Keep the bins of the next committed slots (a pool's width) in
        flight: the merge takes runs in slot order."""
        if self._committed is None:
            return
        ex = self._ensure_pool()
        for s in range(slot, slot + COMMIT_CONC):
            if s in self._committed:
                bp = self._paths(s)[0]
                if bp not in self._binfut:
                    self._binfut[bp] = ex.submit(self._read_path, bp)

    def try_load(self, slot: int, pos0: int, n: int, fp: int, pool,
                 block_items: int):
        """(item File, key File or None) of a committed run that
        matches, or None."""
        if not self.resume:
            return None
        if self._warm_evt is not None:
            self._warm_evt.wait()
        bin_path, man_path = self._paths(slot)
        try:
            raw = None
            if self._committed is not None:
                if slot not in self._committed:
                    return None       # never committed: no read
                fut = self._manfut.pop(man_path, None)
                if fut is not None:
                    try:
                        raw = fut.result()
                    except Exception:
                        raw = None    # the direct read below decides
            if raw is None:
                try:
                    raw = self._read_path(man_path)
                except FileNotFoundError:
                    return None       # never committed: normal
            faults.check(_F_MANIFEST, path=man_path, op="load")
            man = json.loads(raw.decode("ascii"))
            if (man.get("slot") != slot or man.get("pos0") != pos0
                    or man.get("n") != n or man.get("fp") != fp):
                live = {"slot": slot, "pos0": pos0, "n": n, "fp": fp}
                raise ValueError(
                    f"run identity mismatch: manifest "
                    f"{ {k: man.get(k) for k in live} } != live {live}")
            self._prefetch_bins(slot)
            fut = self._binfut.pop(bin_path, None)
            body = (fut.result() if fut is not None
                    else self._read_path(bin_path))
            if len(body) != man["bin_bytes"] or \
                    (zlib.crc32(body) & 0xFFFFFFFF) != man["crc"]:
                raise ValueError("run bin CRC/length mismatch")
            (magic,) = struct.unpack_from("<I", body, 0)
            if magic != _MAGIC:
                raise ValueError(f"bad run magic {magic:#x}")
            f, off = self._unpack_file(body, 4, pool, block_items)
            kf = None
            if man["has_keys"]:
                kf, off = self._unpack_file(body, off, pool, block_items)
            if self.mgr is not None:
                self.mgr.resume_skipped_runs += 1
            return f, kf
        except FileNotFoundError:
            return None
        except Exception as e:
            faults.note("recovery", what="em_runs.manifest_invalid",
                        slot=slot, path=man_path, error=repr(e)[:200])
            return None
