"""Checkpoints and resume: durable epochs of materialized DIAs
(counterpart of the reference package's ``api/checkpoint.py``, its
single-controller part).

At a ``dia.Checkpoint()`` barrier (every freshly computed op with
``THRILL_TPU_CKPT_AUTO=1``, every k iterations of
``Iterate(checkpoint_every=k)``) a node's per-worker shards are
serialized into an epoch directory under ``THRILL_TPU_CKPT_DIR``::

    $THRILL_TPU_CKPT_DIR/
      epoch_000000/
        n<dia_id>.w<worker>.bin     a worker's shard payload
        MANIFEST.json               the commit record (temp + rename)
      epoch_000001/ ...

An epoch is committed once its manifest exists: ``write_file_atomic``
writes it after every shard file, with the counts, the cap, the leaves'
skeleton and a CRC32 a file. A job run again with ``Run(...,
resume=True)`` (``THRILL_TPU_RESUME=1``) loads the newest committed
epoch whose worker count matches, rebuilds that node's shards from it,
and the pull recursion never reaches the node's upstream graph. A
node is named ``"<dia_id>:<label>"`` across runs: ids count in
construction order, so the same job code makes the same ids. The shard
files and manifests are the reference's, byte for byte.

On the card a device node's worker slices leave the card and come back
through the HBM governor's pinned ``StagingRing`` (``mem/hbm.py``): a
save copies slice k+1 off the card while slice k goes into its worker's
payload (its one host copy), a restore uploads slice k while slice k+1
is copied into the next pinned slot.

Not ported (ROADMAP item 6, its checkpoint part): the multi-controller
agreement and
``poison_on_error``, remote (``s3://``, ``hdfs://``) directories, the
resize epochs and markers, and ``stage_repartition`` /
``commit_repartition``. The restore's readahead depth is the
planner's learned depth of the ``ckpt.restore`` site, an
``io_prefetch`` decision audited by the measured hit rate.

With no checkpoint directory nothing here runs: ``Context.checkpoint``
is None and ``Checkpoint()`` is a plain materialization barrier.
"""

from __future__ import annotations

import base64
import functools
import glob
import json
import os
import pickle
import shutil
import sys
import time
import types
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..common import faults
from ..common import tree as pt
from ..common.retry import default_policy
from ..data.serializer import (deserialize_batch, deserialize_leaves,
                               pack_leaves, serialize_batch,
                               serialize_leaves)
from ..data.shards import DeviceShards, HostShards
from ..vfs import file_io

MANIFEST = "MANIFEST.json"
_EPOCH_FMT = "epoch_{:06d}"

# the writes are idempotent (whole files, an atomic manifest), so
# transient storage faults retry under the shared policy
_F_WRITE = faults.declare("ckpt.write")
_F_READ = faults.declare("ckpt.read")
_F_MANIFEST = faults.declare("ckpt.manifest")


def node_key(node) -> str:
    return f"{node.id}:{node.label}"


def _epoch_num(path: str) -> Optional[int]:
    name = os.path.basename(path.rstrip("/"))
    if not name.startswith("epoch_"):
        return None
    try:
        return int(name[len("epoch_"):])
    except ValueError:
        return None


def _remote(path: str) -> bool:
    return "://" in path and not path.startswith("file://")


class CheckpointManager:
    """Owned by :class:`api.context.Context` when a checkpoint directory
    is set: seals materialized shards into epochs and restores them on
    resume."""

    def __init__(self, ctx, directory: str, resume: bool = False,
                 auto: bool = False) -> None:
        if _remote(directory):
            raise NotImplementedError(
                f"checkpoint directory {directory!r}: remote stores are "
                f"not ported yet (ROADMAP.md queue A item 6, its "
                f"remote-vfs part)")
        if ctx.mesh_exec.multiprocess:
            # every process would seal and restore its own epochs with
            # no agreement between them
            raise NotImplementedError(
                "checkpoints on a mesh of several processes are not "
                "ported yet (ROADMAP.md queue A item 6, its checkpoint "
                "part)")
        self.ctx = ctx
        self.dir = directory
        self.auto = auto
        self.resume = resume
        # the stats (Context.overall_stats)
        self.epochs_written = 0
        self.bytes_written = 0
        self.resume_skipped_ops = 0
        # runs of an external sort reloaded, not formed (core/em_runs.py)
        self.resume_skipped_runs = 0
        self.restored_nodes = 0
        self.recovery_time_s = 0.0
        self.resume_epoch: Optional[int] = None
        self._inflight_dir: Optional[str] = None
        self._manifest: Optional[dict] = None
        os.makedirs(self.dir, exist_ok=True)
        self._next_epoch = 1 + max(
            (e for e in (_epoch_num(p) for p in self._epoch_dirs())
             if e is not None), default=-1)
        if resume:
            self.cleanup_incomplete()
            self._manifest = self._load_newest_manifest()
            if self._manifest is not None:
                self.resume_epoch = int(self._manifest["epoch"])
                log = ctx.logger
                if log.enabled:
                    log.line(event="resume", epoch=self.resume_epoch,
                             node=self._manifest["node"]["key"])

    def _epoch_dirs(self) -> List[str]:
        return [p for p in glob.glob(os.path.join(self.dir, "epoch_*"))
                if os.path.isdir(p)]

    # -- save -----------------------------------------------------------
    def maybe_autosave(self, node, shards) -> None:
        """With ``THRILL_TPU_CKPT_AUTO=1``, seal every freshly computed
        op's result; sources and Checkpoint nodes (they seal themselves)
        are left out."""
        if not self.auto or not node.parents:
            return
        if node.label.startswith("Checkpoint"):
            return
        if isinstance(shards, (DeviceShards, HostShards)):
            self.save(node, shards)

    def save(self, node, shards) -> int:
        """Write one epoch holding ``shards`` for ``node``; returns its
        number. The epoch is durable once the manifest lands."""
        t0 = time.perf_counter()
        epoch = self._next_epoch
        self._next_epoch += 1
        edir = os.path.join(self.dir, _EPOCH_FMT.format(epoch))
        os.makedirs(edir, exist_ok=True)
        self._inflight_dir = edir
        steps = {"payload_s": 0.0, "write_s": 0.0}
        if isinstance(shards, DeviceShards):
            rec, nbytes = self._save_device(node, shards, edir, steps)
        elif isinstance(shards, HostShards):
            rec, nbytes = self._save_host(node, shards, edir, steps)
        else:
            raise TypeError(f"cannot checkpoint {type(shards).__name__}")
        manifest = {"format": 1, "epoch": epoch,
                    "workers": self.ctx.mesh_exec.num_workers,
                    "node": rec}
        payload = json.dumps(manifest, sort_keys=True).encode()

        def commit():
            faults.check(_F_MANIFEST, epoch=epoch)
            file_io.write_file_atomic(os.path.join(edir, MANIFEST), payload)

        t_commit = time.perf_counter()
        default_policy().run(commit, what="ckpt.manifest")
        t_end = time.perf_counter()
        self._inflight_dir = None
        self.epochs_written += 1
        self.bytes_written += nbytes
        log = self.ctx.logger
        if log.enabled:
            log.line(event="checkpoint", epoch=epoch, node=node.label,
                     dia_id=node.id, bytes=nbytes,
                     seconds=round(t_end - t0, 4),
                     payload_s=steps["payload_s"],
                     write_s=steps["write_s"],
                     commit_s=t_end - t_commit)
        return epoch

    def _write_file(self, edir: str, name: str, payload: bytes) -> dict:
        path = os.path.join(edir, name)

        def write():
            faults.check(_F_WRITE, file=name)
            with file_io.OpenWriteStream(path) as f:
                f.write(payload)

        default_policy().run(write, what="ckpt.write")
        return {"name": name, "crc": zlib.crc32(payload),
                "bytes": len(payload)}

    def _worker_payloads(self, shards: DeviceShards):
        """Yield ``(worker, its serialize_leaves payload)``, workers in
        order. On the card each worker slice leaves through the
        governor's staging ring (the next slice's copy runs while this
        one is taken) and is copied once, into its worker's payload."""
        leaves = pt.leaves(shards.tree)
        W, L = shards.num_workers, len(leaves)
        counts = [int(c) for c in shards.counts]
        if shards.mesh_exec.device.type != "cuda":
            for w in range(W):
                yield w, serialize_leaves(
                    [leaf[w, :counts[w]].numpy() for leaf in leaves])
            return
        slices = [leaf[w, :counts[w]] for w in range(W) for leaf in leaves]
        staged = self.ctx.hbm._ring.download(slices)
        for w in range(W):
            mine = slices[w * L:(w + 1) * L]
            yield w, pack_leaves(
                [(_np_dtype(t.dtype), t.shape) for t in mine], staged)

    def _write_payloads(self, node, edir: str, payloads, steps: dict):
        """Write each ``(worker, payload)`` of ``payloads`` to its shard
        file: the manifest's files and the bytes written. ``steps``
        gains the seconds spent making the payloads (``payload_s``: off
        the card, or the serializer) and writing them (``write_s``: the
        CRC32 and the write)."""
        files: Dict[str, Any] = {}
        nbytes = 0
        t = time.perf_counter()
        for w, payload in payloads:
            t1 = time.perf_counter()
            files[str(w)] = self._write_file(edir, f"n{node.id}.w{w}.bin",
                                             payload)
            nbytes += len(payload)
            t2 = time.perf_counter()
            steps["payload_s"] += t1 - t
            steps["write_s"] += t2 - t1
            t = t2
        return files, nbytes

    def _save_device(self, node, shards: DeviceShards, edir: str,
                     steps: dict):
        leaves, treedef = pt.flatten(shards.tree)
        skeleton = pt.unflatten(treedef, list(range(len(leaves))))
        files, nbytes = self._write_payloads(
            node, edir, self._worker_payloads(shards), steps)
        rec = {"key": node_key(node), "dia_id": node.id,
               "label": node.label, "kind": "device",
               "counts": [int(c) for c in shards.counts],
               "cap": int(shards.cap),
               "skeleton": base64.b64encode(
                   pickle.dumps(skeleton)).decode("ascii"),
               "files": files}
        return rec, nbytes

    def _save_host(self, node, shards: HostShards, edir: str,
                   steps: dict):
        files, nbytes = self._write_payloads(
            node, edir, ((w, serialize_batch(list(items)))
                         for w, items in enumerate(shards.lists)), steps)
        counts = {str(w): len(items) for w, items in enumerate(shards.lists)}
        rec = {"key": node_key(node), "dia_id": node.id,
               "label": node.label, "kind": "host",
               "counts": counts, "files": files}
        return rec, nbytes

    # -- resume ---------------------------------------------------------
    def _try_load_manifest(self, edir: str) -> Optional[dict]:
        mpath = os.path.join(edir, MANIFEST)
        if not os.path.isfile(mpath):
            return None
        try:
            with open(mpath, "rb") as f:
                m = json.loads(f.read().decode())
            if m.get("format") != 1:
                raise ValueError(f"unknown format {m.get('format')}")
            W = self.ctx.mesh_exec.num_workers
            if m.get("workers") != W:
                raise ValueError(
                    f"epoch was written by a {m.get('workers')}-worker "
                    f"mesh; this run has {W}")
            m["_dir"] = edir
            return m
        except (ValueError, KeyError, OSError) as e:
            print(f"thrill_tpu_torch.checkpoint: skipping epoch "
                  f"{os.path.basename(edir)}: {e}", file=sys.stderr)
            return None

    def _load_newest_manifest(self) -> Optional[dict]:
        # epoch_* directories without a number are not epochs
        dirs = sorted((p for p in self._epoch_dirs()
                       if _epoch_num(p) is not None),
                      key=_epoch_num, reverse=True)
        for edir in dirs:
            m = self._try_load_manifest(edir)
            if m is not None:
                return m
        return None

    def restorable(self, node) -> bool:
        """Does the resume epoch hold this node's shards?"""
        m = self._manifest
        return (m is not None and node._shards is None
                and m["node"]["key"] == node_key(node))

    def try_restore(self, node):
        """The node's shards rebuilt from the resume epoch, or None. A
        corrupt epoch (a CRC mismatch, a missing file) says so on stderr
        and returns None: the node is computed from its lineage."""
        if not self.restorable(node):
            return None
        m = self._manifest
        res = self._restore_agreed(node.label, "recomputing from lineage")
        # one restore a manifest: a later node of the same key (an id
        # used again after a Dispose) computes
        self._manifest = None
        if res is None:
            return None
        shards, dt = res
        skipped = _count_upstream_new(node)
        self.resume_skipped_ops += skipped
        faults.note("recovery", what="ckpt.restore", node=node.label,
                    epoch=m["epoch"], skipped_ops=skipped,
                    seconds=round(dt, 4))
        return shards

    # -- loop-carry epochs (Iterate(checkpoint_every=k)) ----------------
    def save_loop_state(self, name: str, iteration: int, shards) -> int:
        """Seal a loop's carry; the label holds (loop name, iteration),
        so a resumed run enters the loop after it."""
        shim = types.SimpleNamespace(
            id=0, label=f"LoopState[{name}@{iteration}]", parents=())
        return self.save(shim, shards)

    def try_restore_loop(self, name: str):
        """(shards, iteration) when the resume epoch is a loop epoch of
        ``name``, else None."""
        m = self._manifest
        if m is None:
            return None
        label = m["node"]["key"].split(":", 1)[1]
        prefix = f"LoopState[{name}@"
        if not label.startswith(prefix) or not label.endswith("]"):
            return None
        try:
            iteration = int(label[len(prefix):-1])
        except ValueError:
            return None
        res = self._restore_agreed(label,
                                   "re-running the loop from its start")
        self._manifest = None
        if res is None:
            return None
        shards, dt = res
        faults.note("recovery", what="ckpt.restore", node=label,
                    epoch=m["epoch"], loop=name, iteration=iteration,
                    seconds=round(dt, 4))
        return shards, iteration

    def _restore_agreed(self, label: str, fallback: str):
        """Rebuild the manifest node's shards: (shards, seconds), or None
        after a loud note when the epoch is corrupt. One controller
        agrees with itself; the multi-controller agreement waits for
        ROADMAP item 6, its checkpoint part."""
        m = self._manifest
        rec = m["node"]
        t0 = time.perf_counter()
        try:
            if rec["kind"] == "device":
                shards = self._restore_device(rec, m["_dir"])
            else:
                shards = self._restore_host(rec, m["_dir"])
        except Exception as e:
            print(f"thrill_tpu_torch.checkpoint: restore of {rec['key']} "
                  f"from epoch {m['epoch']} failed ({e!r}); {fallback}",
                  file=sys.stderr)
            faults.note("recovery", what="ckpt.restore_failed",
                        node=label, epoch=m["epoch"], error=repr(e))
            return None
        dt = time.perf_counter() - t0
        self.restored_nodes += 1
        self.recovery_time_s += dt
        return shards, dt

    def _read_file(self, edir: str, finfo: dict) -> bytes:
        path = os.path.join(edir, finfo["name"])

        def read():
            faults.check(_F_READ, file=finfo["name"])
            with file_io.OpenReadStream(path) as f:
                return f.read()

        data = default_policy().run(read, what="ckpt.read")
        if zlib.crc32(data) != finfo["crc"]:
            raise IOError(f"CRC mismatch in {finfo['name']}")
        return data

    def _overlapped_reads(self, edir: str, rec: dict, workers):
        """Yield ``(worker, shard file bytes)`` with the next worker's
        read in flight while the caller decodes and uploads this one
        (``THRILL_TPU_PREFETCH=0`` reads in turn). Each read is the whole
        retry and CRC path; a failed background read is read again on
        this thread."""
        from ..common.decisions import record_of, resolve_io_prefetch
        from ..common.iostats import IO as _IOSTATS
        from ..data.writeback import make_readahead, overlapped_fetch
        from ..vfs.file_io import prefetch_depth
        from .planner import planner_of
        workers = list(workers)
        mex = self.ctx.mesh_exec
        ra = drec = None
        st: dict = {}
        io0 = _IOSTATS.snapshot()
        if len(workers) > 1:
            # only where a readahead pool runs: a one-file restore must
            # not take a replan mark it cannot exercise
            depth = prefetch_depth()
            pl = planner_of(mex)
            if pl is not None:
                depth = pl.io_prefetch_depth("ckpt.restore", depth)
            ra = make_readahead(depth)
            if ra is not None:
                drec = record_of(
                    mex, "io_prefetch", "ckpt.restore", f"depth={depth}",
                    predicted=1.0, reason="overlap next shard's read with "
                                          "the current decode+upload",
                    files=len(workers), depth=depth)
        try:
            yield from overlapped_fetch(
                workers, lambda w: self._read_file(edir,
                                                   rec["files"][str(w)]),
                "ckpt.restore", ra, stats=st)
            if st.get("prefetched"):
                _IOSTATS.add(restore_overlaps=1)
        finally:
            if ra is not None:
                ra.shutdown(wait=True, cancel_futures=True)
            resolve_io_prefetch(
                mex, drec, _IOSTATS.delta(_IOSTATS.snapshot(), io0))

    def _restore_device(self, rec: dict, edir: str) -> DeviceShards:
        mex = self.ctx.mesh_exec
        W = mex.num_workers
        counts = np.asarray([int(c) for c in rec["counts"]], dtype=np.int64)
        cap = int(rec["cap"])
        skeleton = pickle.loads(base64.b64decode(rec["skeleton"]))
        ids, treedef = pt.flatten(skeleton)
        n_leaves = len(ids)
        per_worker: Dict[int, List[np.ndarray]] = {}
        t0 = time.perf_counter()
        for w, data in self._overlapped_reads(edir, rec, range(W)):
            leaves = deserialize_leaves(data)
            if len(leaves) != n_leaves:
                raise IOError(f"worker {w}: {len(leaves)} leaves, the "
                              f"skeleton wants {n_leaves}")
            if leaves and leaves[0].shape[0] != counts[w]:
                raise IOError(f"worker {w}: {leaves[0].shape[0]} rows, "
                              f"manifest says {counts[w]}")
            per_worker[w] = leaves
        t1 = time.perf_counter()
        dev = mex.device
        out_leaves, items = [], []
        for i in range(n_leaves):
            tail = per_worker[0][i].shape[1:]
            dtype = per_worker[0][i].dtype
            for w in range(W):
                arr = per_worker[w][i]
                if arr.dtype != dtype or arr.shape[1:] != tail:
                    raise IOError(
                        f"worker {w} leaf {i}: {arr.dtype}{arr.shape} does "
                        f"not match worker 0's {dtype}(*, {tail}): corrupt "
                        f"epoch")
            leaf = torch.zeros((W, cap) + tuple(tail),
                               dtype=_torch_dtype(dtype), device=dev)
            items += [(leaf[w, :int(counts[w])], per_worker[w][i])
                      for w in range(W)]
            out_leaves.append(leaf)
        if dev.type == "cuda":
            self.ctx.hbm._ring.upload(
                [(dst, functools.partial(_fill, arr)) for dst, arr in items])
        else:
            for dst, arr in items:
                dst.numpy()[...] = arr
        shards = DeviceShards(mex, pt.unflatten(treedef, out_leaves), counts)
        log = self.ctx.logger
        if log.enabled:
            # read_s: the shard files read, CRC-checked and decoded;
            # upload_s: the leaves allocated and their uploads issued
            # (the last may still be in flight)
            log.line(event="ckpt_restore", kind="device",
                     epoch=self._manifest["epoch"], items=int(counts.sum()),
                     read_s=t1 - t0,
                     upload_s=time.perf_counter() - t1)
        return shards

    def _restore_host(self, rec: dict, edir: str) -> HostShards:
        W = self.ctx.mesh_exec.num_workers
        lists: List[List[Any]] = [[] for _ in range(W)]
        for w in range(W):
            if rec["files"].get(str(w)) is None:
                raise IOError(f"worker {w}: shard file missing from "
                              f"manifest")
        for w, data in self._overlapped_reads(edir, rec, range(W)):
            lists[w] = deserialize_batch(data)
            want = (int(rec["counts"].get(str(w), len(lists[w])))
                    if isinstance(rec["counts"], dict)
                    else int(rec["counts"][w]))
            if len(lists[w]) != want:
                raise IOError(f"worker {w}: {len(lists[w])} items, "
                              f"manifest says {want}")
        shards = HostShards(W, lists)
        log = self.ctx.logger
        if log.enabled:
            log.line(event="ckpt_restore", kind="host",
                     epoch=self._manifest["epoch"], items=shards.total)
        return shards

    # -- hygiene --------------------------------------------------------
    def cleanup_incomplete(self) -> int:
        """Remove the epoch directories without a manifest (a crashed
        run's half-written epoch); only at resume, when the run that
        wrote them is gone."""
        removed = 0
        for edir in self._epoch_dirs():
            if os.path.isfile(os.path.join(edir, MANIFEST)):
                continue
            try:
                shutil.rmtree(edir)
                removed += 1
            except OSError:
                pass
        if removed:
            faults.note("recovery", what="ckpt.cleanup_incomplete",
                        removed=removed)
        return removed

    def abort_cleanup(self) -> None:
        """Drop this run's epoch in flight, if its manifest never
        landed."""
        edir, self._inflight_dir = self._inflight_dir, None
        if edir and not os.path.isfile(os.path.join(edir, MANIFEST)):
            try:
                shutil.rmtree(edir)
            except OSError:
                pass

    def stats(self) -> dict:
        return {"checkpoint_epochs": self.epochs_written,
                "ckpt_bytes_written": self.bytes_written,
                "resume_skipped_ops": self.resume_skipped_ops,
                "resume_skipped_runs": self.resume_skipped_runs,
                "recovery_time_s": round(self.recovery_time_s, 4)}


def _fill(arr: np.ndarray, buf: np.ndarray) -> None:
    buf[:] = arr.reshape(-1).view(np.uint8)


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dt).numpy().dtype


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dt)).dtype


def _count_upstream_new(node) -> int:
    """How many ancestors the restore left NEW (the pull never reaches
    them)."""
    seen = set()
    stack = [p.node for p in node.parents]
    n = 0
    while stack:
        x = stack.pop()
        if x.id in seen:
            continue
        seen.add(x.id)
        if x.state == "NEW":
            n += 1
            stack.extend(p.node for p in x.parents)
    return n


def make_checkpoint_node(dia, name: Optional[str] = None):
    from .dia import DIA
    from .dia_base import DIABase

    class CheckpointNode(DIABase):
        """Materializes its parent and seals the result into an epoch."""

        def compute(self):
            shards = self.parents[0].pull()
            mgr = self.context.checkpoint
            if mgr is not None:
                mgr.save(self, shards)
            return shards

    label = "Checkpoint" if name is None else f"Checkpoint[{name}]"
    return DIA(CheckpointNode(dia.context, label, [dia._link()]))
