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

Orphan adoption (reference: ``core/em_runs.py:60-183``): every store
records its owner process in ``OWNER.json``. A process that joins a
group in a departed rank's place (``net/tcp.py`` ``join_tcp_group``)
calls :func:`adopt_orphan_runs`, which claims the committed runs of its
rank's stores whose owner is gone and marks each such store
``ADOPTED.json``; an adopted store loads its runs without resume mode.
Both files are the reference's, byte for byte. Remote stores are
ROADMAP item 6, its remote-vfs part.
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

# orphan adoption: OWNER.json names the process that owns a store (a
# store whose owner still runs is no orphan); ADOPTED.json marks a store
# claimed by a joiner, whose RunStore then loads runs without resume
# mode. Only the same rank id adopts: the host rank in the signature
# pins the input that rank saw, so another rank's runs would never pass
# the identity check
_OWNER = "OWNER.json"
_ADOPTED = "ADOPTED.json"
_adopt_lock = threading.Lock()
_adopted = 0

# width of the pool that commits runs (and, on resume, reads manifests
# and keeps bins in flight): the reference's default, which nothing sets
COMMIT_CONC = 4


def _enabled() -> bool:
    return os.environ.get("THRILL_TPU_EM_RESUME", "1") != "0"


def adopted_total() -> int:
    """Runs this process adopted from departed owners
    (``runs_adopted`` of ``Context.overall_stats``)."""
    with _adopt_lock:
        return _adopted


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(int(pid), 0)
        return True
    except (OSError, ValueError, TypeError):
        return False


def adopt_orphan_runs(ckpt_dir: str, my_rank: int) -> int:
    """Adopt the committed runs a departed rank left: scan
    ``<ckpt_dir>/em_runs/*_h<my_rank>`` for stores whose owner process
    is gone, check each committed run (its manifest parses and holds
    every key, its bin has the manifest's size; the CRC is checked when
    the run loads), take the ownership and mark the store adopted.
    Returns the runs adopted; never raises, and a missing store adopts
    nothing. Remote directories are skipped."""
    global _adopted
    if not _enabled() or not ckpt_dir or "://" in ckpt_dir:
        return 0
    from ..vfs.file_io import write_file_atomic
    base = os.path.join(ckpt_dir.rstrip("/"), "em_runs")
    suffix = f"_h{int(my_rank)}"
    total = 0
    try:
        sigs = sorted(os.listdir(base))
    except OSError:
        return 0
    for sig in sigs:
        if not sig.endswith(suffix):
            continue
        sdir = os.path.join(base, sig)
        if not os.path.isdir(sdir) \
                or os.path.isfile(os.path.join(sdir, _ADOPTED)):
            continue
        try:
            opath = os.path.join(sdir, _OWNER)
            try:
                with open(opath, "rb") as fh:
                    owner = json.loads(fh.read().decode("ascii"))
            except (OSError, ValueError):
                owner = None           # a store without an owner record
            if owner is not None:
                pid = owner.get("pid")
                if pid == os.getpid() or _pid_alive(pid):
                    continue           # this process's, or a live owner's
            verified = 0
            for name in sorted(os.listdir(sdir)):
                if not (name.startswith("run_") and name.endswith(".json")):
                    continue
                try:
                    with open(os.path.join(sdir, name), "rb") as fh:
                        man = json.loads(fh.read().decode("ascii"))
                    if not all(k in man for k in ("slot", "pos0", "n", "fp",
                                                  "crc", "bin_bytes")):
                        raise ValueError("manifest missing keys")
                    bin_path = os.path.join(sdir,
                                            name[:-len(".json")] + ".bin")
                    if os.path.getsize(bin_path) != man["bin_bytes"]:
                        raise ValueError("bin size mismatch")
                    verified += 1
                except (OSError, ValueError) as e:
                    faults.note("recovery", what="em_runs.adopt_skipped_run",
                                sig=sig, run=name, error=repr(e)[:200])
            if not verified:
                continue
            write_file_atomic(
                os.path.join(sdir, _ADOPTED),
                json.dumps({"runs": verified, "by_pid": os.getpid(),
                            "from_pid": (owner or {}).get("pid")}
                           ).encode("ascii"))
            write_file_atomic(opath, json.dumps(
                {"pid": os.getpid(), "rank": int(my_rank)}).encode("ascii"))
            total += verified
            faults.note("recovery", what="em_runs.adopted", sig=sig,
                        runs=verified, _quiet=True)
        except Exception as e:
            faults.note("recovery", what="em_runs.adopt_failed", sig=sig,
                        error=repr(e)[:200])
    if total:
        with _adopt_lock:
            _adopted += total
    return total


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
        # a store a joiner adopted loads its runs without resume mode
        # (probed only once this process adopted something)
        if not self.resume and adopted_total() > 0 \
                and os.path.isfile(os.path.join(base, _ADOPTED)):
            self.resume = True
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
        # the owner record the adoption scan reads; best effort (a store
        # without one is adoptable once its runs check out)
        try:
            from ..vfs.file_io import write_file_atomic
            write_file_atomic(os.path.join(base, _OWNER),
                              json.dumps({"pid": os.getpid()}).encode("ascii"))
        except Exception:
            pass
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
