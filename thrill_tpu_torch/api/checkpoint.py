"""Checkpoints and resume: durable epochs of materialized DIAs
(counterpart of the reference package's ``api/checkpoint.py``).

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

Elasticity (reference: ``api/checkpoint.py:100-150, 425-578,
961-1030``): ``stage_repartition`` / ``commit_repartition`` re-split a
live result across a new W for ``Context.resize`` (a device result on
its device); ``seal_resize`` writes a RESIZE epoch already re-split to
the target W and ``commit_resize_marker`` the ``RESIZE.json`` marker
that ``run-scripts/supervise.sh`` reads; a resume at the target W
consumes the marker (``Context.resize_processes``).

A mesh of several processes (reference: ``api/checkpoint.py:196-246,
293-361, 425-578, 704-745``; the directory is shared): the processes
agree on the epoch numbers, rank 0 alone sweeps incomplete epochs, and a
resume takes the newest epoch every process can load, agreed to be held
everywhere. Each process writes the shard files of its own workers,
named by the global worker index, from its ``[W_local, cap]`` leaves;
the file tables and counts are gathered over the host control plane,
rank 0 commits the manifest and a barrier follows, all under the abort
protocol (``poison_on_error``). A device epoch so written is the one a
single process of the same W writes, byte for byte. ``seal_resize``
gathers every worker's payload to rank 0, which re-splits and writes
the W' epoch; rank 0 writes and consumes the marker. A restore reads
the local workers' files only and is all-or-nothing across processes: a
process whose restore fails makes every process compute the node.

A remote directory (``s3://``, ``http(s)://``, ``hdfs://``; reference:
``_is_remote``) makes no directories and removes none: epochs are found
by ``Glob`` of the ``epoch_*`` keys, a missing manifest is the read's
FileNotFoundError, an epoch without one is never resumed (so it is not
swept), and the resize marker is not consumed (a relaunch at the target
W makes a stale one harmless). Shards and manifests already go through
the vfs. The restore's readahead depth is the planner's
learned depth of the ``ckpt.restore`` site, an ``io_prefetch`` decision
audited by the measured hit rate.

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
#: the commit record of a process-level resize (Context.resize_processes):
#: written atomically after the RESIZE epoch sealed and the host group
#: agreed to relaunch; the supervisor reads ``target_w`` from it and the
#: relaunched run at that W consumes it
RESIZE_MARKER = "RESIZE.json"

# the writes are idempotent (whole files, an atomic manifest), so
# transient storage faults retry under the shared policy
_F_WRITE = faults.declare("ckpt.write")
_F_READ = faults.declare("ckpt.read")
_F_MANIFEST = faults.declare("ckpt.manifest")

# Context.resize: fired when a live result is staged, before any shard or
# the mesh changed, so a failure leaves the old W whole and the next
# attempt starts from the same state
_F_REPART = faults.declare("ckpt.repartition")

# Context.resize_processes: fired as the RESIZE epoch's seal starts and
# again as the marker commits, each before its writes: a failure leaves
# nothing (seal) or a sealed epoch no marker announces, which an old-W
# resume rejects by its worker count
_F_RESIZE_MANIFEST = faults.declare("ckpt.resize_manifest")


def node_key(node) -> str:
    return f"{node.id}:{node.label}"


def resize_marker_path(directory: str) -> str:
    return os.path.join(directory, RESIZE_MARKER)


def pending_resize_target(directory: str) -> Optional[dict]:
    """The committed, unconsumed resize marker under ``directory``, or
    None (needs no Context: a relaunched child reads it to size its mesh
    first). A corrupt marker says so and counts as absent: the relaunch
    then runs at the old W, whose epochs are still committed."""
    path = resize_marker_path(directory)
    try:
        if file_io.is_remote(directory):
            with file_io.OpenReadStream(path) as f:
                raw = f.read()
        else:
            if not os.path.isfile(path):
                return None
            with open(path, "rb") as f:
                raw = f.read()
        m = json.loads(raw.decode())
        if int(m.get("target_w", 0)) < 1:
            raise ValueError(f"bad target_w {m.get('target_w')!r}")
        return m
    except FileNotFoundError:
        return None
    except (ValueError, KeyError, OSError) as e:
        print(f"thrill_tpu_torch.checkpoint: ignoring corrupt resize "
              f"marker {path}: {e}", file=sys.stderr)
        return None


def clear_resize_marker(directory: str) -> bool:
    """Consume the resize marker (the relaunched run is up at the
    target W). A remote store has no delete on the vfs: False."""
    if file_io.is_remote(directory):
        return False
    try:
        os.remove(resize_marker_path(directory))
        return True
    except OSError:
        return False


def _epoch_num(path: str) -> Optional[int]:
    name = os.path.basename(path.rstrip("/"))
    if not name.startswith("epoch_"):
        return None
    try:
        return int(name[len("epoch_"):])
    except ValueError:
        return None


class CheckpointManager:
    """Owned by :class:`api.context.Context` when a checkpoint directory
    is set: seals materialized shards into epochs and restores them on
    resume."""

    def __init__(self, ctx, directory: str, resume: bool = False,
                 auto: bool = False) -> None:
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
        self.remote = file_io.is_remote(directory)
        if not self.remote:
            os.makedirs(self.dir, exist_ok=True)
        self._next_epoch = 1 + max(
            (e for e in (_epoch_num(p) for p in self._epoch_dirs())
             if e is not None), default=-1)
        if self._multihost():
            # one epoch numbering: a process whose scan raced rank 0's
            # sweep would write into another epoch's directory
            self._next_epoch = max(ctx.net.all_gather(self._next_epoch))
        if resume:
            if self._host_rank() == 0:
                self.cleanup_incomplete()
            self._manifest = self._load_newest_manifest()
            if self._multihost():
                # one resume epoch or none: the oldest of the newest
                # each process sees (every process can load it; -1
                # anywhere: nobody resumes), then agreed to be held
                # everywhere
                mine = (int(self._manifest["epoch"])
                        if self._manifest is not None else -1)
                agreed = min(ctx.net.all_gather(mine))
                if agreed < 0:
                    self._manifest = None
                elif agreed != mine:
                    self._manifest = self._load_manifest_for(agreed)
                if not all(ctx.net.all_gather(self._manifest is not None)):
                    self._manifest = None
            if self._manifest is not None:
                self.resume_epoch = int(self._manifest["epoch"])
                log = ctx.logger
                if log.enabled:
                    log.line(event="resume", epoch=self.resume_epoch,
                             node=self._manifest["node"]["key"])
            # a committed resize marker is consumed once the relaunch is
            # up at its target W: the move is complete and the
            # supervisor must not relaunch again. A marker for another W
            # stays (this run is not the relaunch it asked for; epochs
            # are gated by their worker count)
            marker = pending_resize_target(self.dir)
            if marker is not None and self._host_rank() == 0 \
                    and int(marker["target_w"]) == ctx.mesh_exec.num_workers:
                clear_resize_marker(self.dir)
                faults.note("recovery", what="ckpt.resize_complete",
                            target_w=int(marker["target_w"]),
                            from_w=marker.get("from_w"),
                            epoch=marker.get("epoch"))

    # -- the processes ---------------------------------------------------
    def _host_rank(self) -> int:
        return self.ctx.net.my_rank if self._multihost() else 0

    def _multihost(self) -> bool:
        return self.ctx.net.num_workers > 1

    def _local_workers(self) -> List[int]:
        """The global indices of this process's workers."""
        return list(self.ctx.mesh_exec.local_workers)

    def _epoch_dirs(self) -> List[str]:
        if self.remote:
            # no directories in an object store: the epoch_* keys' first
            # path component
            base = self.dir.rstrip("/")
            seen: Dict[str, None] = {}
            try:
                listing = file_io.Glob(base + "/epoch_*")
            except (OSError, NotImplementedError):
                return []
            for fi in listing:
                rest = fi.path[len(base) + 1:]
                if "/" in rest:
                    seen.setdefault(rest.split("/", 1)[0], None)
            return [f"{base}/{d}" for d in seen]
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
        number. The epoch is durable once the manifest lands. Across
        processes the whole save runs under the abort protocol: a process
        whose write fails poisons its peers before they wait for its file
        table."""
        from ..net.group import poison_on_error
        grp = self.ctx.net.group if self._multihost() else None
        with poison_on_error(grp, "ckpt.save"):
            return self._save_guarded(node, shards)

    def _save_guarded(self, node, shards) -> int:
        t0 = time.perf_counter()
        epoch = self._next_epoch
        self._next_epoch += 1
        edir = os.path.join(self.dir, _EPOCH_FMT.format(epoch))
        if not self.remote:
            os.makedirs(edir, exist_ok=True)
        self._inflight_dir = edir
        steps = {"payload_s": 0.0, "write_s": 0.0}
        if isinstance(shards, DeviceShards):
            rec, nbytes = self._save_device(node, shards, edir, steps)
        elif isinstance(shards, HostShards):
            rec, nbytes = self._save_host(node, shards, edir, steps)
        else:
            raise TypeError(f"cannot checkpoint {type(shards).__name__}")
        t_commit = time.perf_counter()
        W = self.ctx.mesh_exec.num_workers
        if self._multihost() or rec["kind"] == "device":
            # every process's file table, and every worker's counts as a
            # list (a host epoch of one process keeps the reference's
            # dict); rank 0 commits for all of them
            tables = (self.ctx.net.all_gather((rec["files"], rec["counts"]))
                      if self._multihost()
                      else [(rec["files"], rec["counts"])])
            rec["files"], rec["counts"] = {}, [0] * W
            for tab, cnts in tables:
                rec["files"].update(tab)
                for w, c in cnts.items():
                    rec["counts"][int(w)] = int(c)
        self._commit(edir, {"format": 1, "epoch": epoch, "workers": W,
                            "node": rec})
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

    def _commit(self, edir: str, manifest: Optional[dict]) -> None:
        """Rank 0 writes the epoch's ``manifest`` (the commit); across
        processes a barrier follows, so no process goes on before the
        epoch is committed."""
        if self._host_rank() == 0:
            payload = json.dumps(manifest, sort_keys=True).encode()

            def commit():
                faults.check(_F_MANIFEST, epoch=manifest["epoch"])
                file_io.write_file_atomic(os.path.join(edir, MANIFEST),
                                          payload)

            default_policy().run(commit, what="ckpt.manifest")
            self._inflight_dir = None
        if self._multihost():
            self.ctx.net.barrier()

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
        """Yield ``(global worker index, its serialize_leaves payload)``
        for this process's workers, in order: the rows of its
        ``[W_local, cap]`` leaves only. On the card each worker slice
        leaves through the governor's staging ring (the next slice's copy
        runs while this one is taken) and is copied once, into its
        worker's payload."""
        shards.validate_pending()
        leaves = pt.leaves(shards.tree)
        L = len(leaves)
        counts = [int(c) for c in shards.counts]
        base = shards.mesh_exec.worker_base
        if shards.mesh_exec.device.type != "cuda":
            for w, c in enumerate(counts):
                yield base + w, serialize_leaves(
                    [leaf[w, :c].numpy() for leaf in leaves])
            return
        slices = [leaf[w, :c] for w, c in enumerate(counts)
                  for leaf in leaves]
        staged = self.ctx.hbm._ring.download(slices)
        for w in range(len(counts)):
            mine = slices[w * L:(w + 1) * L]
            yield base + w, pack_leaves(
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
        # this process's counts by global worker; ``save`` makes them the
        # manifest's list of every worker's
        counts = {str(w): int(c) for w, c in zip(self._local_workers(),
                                                 shards.counts)}
        rec = {"key": node_key(node), "dia_id": node.id,
               "label": node.label, "kind": "device",
               "counts": counts,
               "cap": int(shards.cap),
               "skeleton": base64.b64encode(
                   pickle.dumps(skeleton)).decode("ascii"),
               "files": files}
        return rec, nbytes

    def _save_host(self, node, shards: HostShards, edir: str,
                   steps: dict):
        local = self._local_workers()
        files, nbytes = self._write_payloads(
            node, edir, ((w, serialize_batch(list(shards.lists[w])))
                         for w in local), steps)
        # a dict in one process, as the reference's; across processes
        # ``save`` merges every process's into a list, as the
        # reference's does
        counts = {str(w): len(shards.lists[w]) for w in local}
        rec = {"key": node_key(node), "dia_id": node.id,
               "label": node.label, "kind": "host",
               "counts": counts, "files": files}
        return rec, nbytes

    # -- the process-level resize (Context.resize_processes) -------------
    def seal_resize(self, node, shards, target_w: int) -> int:
        """Seal a RESIZE epoch: ``shards`` re-split to ``target_w``
        workers now and written as a ``target_w``-worker epoch, which
        the relaunched W'-wide run restores through the usual resume
        (its worker count matches) in the layout a fixed-W' run of the
        same items has. The ``ckpt.resize_manifest`` site fires before
        any byte lands; an uncommitted epoch (a SIGKILL mid-seal) is
        swept at the next resume; a committed W' epoch without a marker
        is rejected by an old-W resume. Across processes every process
        sends its workers' payloads to rank 0 over the host control
        plane (the joiners of a grow do not exist yet), which re-splits
        and writes every W' file, under the abort protocol. Files and
        manifest are the reference's, byte for byte."""
        from ..net.group import poison_on_error
        grp = self.ctx.net.group if self._multihost() else None
        with poison_on_error(grp, "ckpt.seal_resize"):
            return self._seal_resize_guarded(node, shards, target_w)

    def _seal_resize_guarded(self, node, shards, target_w: int) -> int:
        from ..data.shards import resplit_leaves
        t0 = time.perf_counter()
        target_w = int(target_w)
        old_w = self.ctx.mesh_exec.num_workers
        faults.check(_F_RESIZE_MANIFEST, stage="seal", target=target_w,
                     old=old_w)
        # this process's workers' payloads, then every worker's at rank 0
        if isinstance(shards, DeviceShards):
            leaves, treedef = pt.flatten(shards.tree)
            skeleton = pt.unflatten(treedef, list(range(len(leaves))))
            local_tab = dict(self._worker_payloads(shards))
            kind = "device"
        elif isinstance(shards, HostShards):
            skeleton = None
            local_tab = {w: serialize_batch(list(shards.lists[w]))
                         for w in self._local_workers()}
            kind = "host"
        else:
            raise TypeError(
                f"cannot seal {type(shards).__name__} for a resize")
        if self._multihost():
            full: Dict[int, bytes] = {}
            for tab in self.ctx.net.all_gather(local_tab):
                full.update({int(w): p for w, p in tab.items()})
        else:
            full = local_tab
        epoch = self._next_epoch
        self._next_epoch += 1
        edir = os.path.join(self.dir, _EPOCH_FMT.format(epoch))
        nbytes, manifest = 0, None
        if self._host_rank() == 0:
            if kind == "device":
                new_leaves = resplit_leaves(
                    [deserialize_leaves(full[w]) for w in range(old_w)],
                    target_w)
                counts = [int(l[0].shape[0]) if l else 0 for l in new_leaves]
                payloads = [serialize_leaves(l) for l in new_leaves]
                rec: Dict[str, Any] = {
                    "key": node_key(node), "dia_id": node.id,
                    "label": node.label, "kind": "device",
                    "counts": counts, "cap": max([1] + counts),
                    "skeleton": base64.b64encode(
                        pickle.dumps(skeleton)).decode("ascii")}
            else:
                lists = [deserialize_batch(full[w]) for w in range(old_w)]
                new = HostShards(old_w, lists).repartition(target_w)
                counts = [len(l) for l in new.lists]
                payloads = [serialize_batch(l) for l in new.lists]
                rec = {"key": node_key(node), "dia_id": node.id,
                       "label": node.label, "kind": "host",
                       "counts": counts}
            if not self.remote:
                os.makedirs(edir, exist_ok=True)
            self._inflight_dir = edir
            files: Dict[str, Any] = {}
            for w in range(target_w):
                files[str(w)] = self._write_file(
                    edir, f"n{node.id}.w{w}.bin", payloads[w])
                nbytes += len(payloads[w])
            rec["files"] = files
            manifest = {"format": 1, "epoch": epoch, "workers": target_w,
                        "resize": {"from": old_w, "to": target_w},
                        "node": rec}
        self._commit(edir, manifest)
        self.epochs_written += 1
        self.bytes_written += nbytes
        log = self.ctx.logger
        if log.enabled:
            log.line(event="resize_seal", epoch=epoch, node=node.label,
                     dia_id=node.id, workers_old=old_w,
                     workers_new=target_w, bytes=nbytes,
                     seconds=round(time.perf_counter() - t0, 4))
        return epoch

    def commit_resize_marker(self, target_w: int,
                             epoch: Optional[int] = None,
                             generation: Optional[int] = None,
                             procs: Optional[int] = None) -> str:
        """Commit the move: the marker tells the supervisor, and any
        relaunch however the process died, to relaunch at ``target_w``
        (``target_procs`` processes in its ``-w`` mode). Atomic (a
        temporary file renamed) and written by rank 0, then a barrier;
        the fault site fires first, so a failure commits nothing."""
        faults.check(_F_RESIZE_MANIFEST, stage="marker",
                     target=int(target_w))
        payload = json.dumps(
            {"format": 1, "target_w": int(target_w),
             "from_w": self.ctx.mesh_exec.num_workers,
             "target_procs": int(procs) if procs else 1,
             "epoch": epoch, "generation": generation},
            sort_keys=True).encode()
        path = resize_marker_path(self.dir)
        if self._host_rank() == 0:
            default_policy().run(
                lambda: file_io.write_file_atomic(path, payload),
                what="ckpt.resize_marker")
        if self._multihost():
            self.ctx.net.barrier()
        return path

    # -- resume ---------------------------------------------------------
    def _load_manifest_for(self, epoch: int) -> Optional[dict]:
        """One epoch's manifest (the agreement between processes chose an
        epoch older than this process's newest)."""
        return self._try_load_manifest(
            os.path.join(self.dir, _EPOCH_FMT.format(epoch)))

    def _try_load_manifest(self, edir: str) -> Optional[dict]:
        mpath = os.path.join(edir, MANIFEST)
        if not self.remote and not os.path.isfile(mpath):
            return None
        try:
            if self.remote:
                try:
                    with file_io.OpenReadStream(mpath) as f:
                        raw = f.read()
                except FileNotFoundError:
                    return None          # an epoch never committed
            else:
                with open(mpath, "rb") as f:
                    raw = f.read()
            m = json.loads(raw.decode())
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
        after a loud note when the epoch is corrupt. All or nothing
        across processes: one process computing the node while the
        others restore it would enter its upstream exchanges alone. The
        agreement runs in lockstep (``restorable()`` is the same on every
        process after the startup agreement), and a process that
        restored but whose peer failed notes ``ckpt.restore_abandoned``
        and computes too."""
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
            shards = None
        if self._multihost():
            oks = self.ctx.net.all_gather(shards is not None)
            if not all(oks) and shards is not None:
                faults.note("recovery", what="ckpt.restore_abandoned",
                            node=label, epoch=m["epoch"],
                            peers_failed=oks.count(False))
                shards = None
        if shards is None:
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
        """This process's workers' files into ``[W_local, cap]`` leaves,
        on the card through the staging ring; the current stream waits
        for the uploads before anything reads the leaves."""
        mex = self.ctx.mesh_exec
        counts = np.asarray([int(c) for c in rec["counts"]], dtype=np.int64)
        cap = int(rec["cap"])
        skeleton = pickle.loads(base64.b64decode(rec["skeleton"]))
        ids, treedef = pt.flatten(skeleton)
        n_leaves = len(ids)
        local = self._local_workers()
        per_worker: Dict[int, List[np.ndarray]] = {}
        t0 = time.perf_counter()
        for w, data in self._overlapped_reads(edir, rec, local):
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
        first = local[0]
        out_leaves, items = [], []
        for i in range(n_leaves):
            tail = per_worker[first][i].shape[1:]
            dtype = per_worker[first][i].dtype
            for w in local:
                arr = per_worker[w][i]
                if arr.dtype != dtype or arr.shape[1:] != tail:
                    raise IOError(
                        f"worker {w} leaf {i}: {arr.dtype}{arr.shape} does "
                        f"not match worker {first}'s {dtype}(*, {tail}): "
                        f"corrupt epoch")
            leaf = torch.zeros((len(local), cap) + tuple(tail),
                               dtype=_torch_dtype(dtype), device=dev)
            items += [(leaf[j, :int(counts[w])], per_worker[w][i])
                      for j, w in enumerate(local)]
            out_leaves.append(leaf)
        if dev.type == "cuda":
            self.ctx.hbm._ring.upload(
                [(dst, functools.partial(_fill, arr)) for dst, arr in items])
        else:
            for dst, arr in items:
                dst.numpy()[...] = arr
        shards = DeviceShards(mex, pt.unflatten(treedef, out_leaves),
                              counts[local[0]:local[-1] + 1])
        if mex.multiprocess:
            # every worker's counts are the manifest's: no gather needed
            shards._counts_global = counts
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
        """This process's workers' lists (the others stay empty across
        processes, the reference's host-storage invariant)."""
        W = self.ctx.mesh_exec.num_workers
        lists: List[List[Any]] = [[] for _ in range(W)]
        local = self._local_workers()
        for w in local:
            if rec["files"].get(str(w)) is None:
                raise IOError(f"worker {w}: shard file missing from "
                              f"manifest")
        for w, data in self._overlapped_reads(edir, rec, local):
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
        wrote them is gone, and by rank 0 alone across processes. A
        remote store has no delete on the vfs; its epochs without a
        manifest are never resumed."""
        if self.remote:
            return 0
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
        if edir and self.remote:
            return
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


# ----------------------------------------------------------------------
# the re-split of a live result for Context.resize
# ----------------------------------------------------------------------

def stage_repartition(shards) -> dict:
    """Stage one live shard store for a W change; returns what
    :func:`commit_repartition` consumes, with its ``bytes``. Reads only:
    the shards stay valid and unchanged. A device store stays on its
    device (its leaves and host counts are held); a host store is
    serialized, as the reference's."""
    faults.check(_F_REPART, kind=type(shards).__name__,
                 workers=shards.num_workers)
    if isinstance(shards, DeviceShards):
        shards.validate_pending()
        counts = np.asarray(shards.counts, dtype=np.int64).copy()
        n = int(counts.sum())
        nbytes = sum(n * (l.element_size() * int(np.prod(l.shape[2:],
                                                         dtype=np.int64)))
                     for l in pt.leaves(shards.tree))
        return {"kind": "device", "tree": shards.tree, "counts": counts,
                "bytes": int(nbytes)}
    if isinstance(shards, HostShards):
        payloads = [serialize_batch(list(items)) for items in shards.lists]
        return {"kind": "host", "payloads": payloads,
                "bytes": sum(len(p) for p in payloads)}
    raise TypeError(f"cannot repartition {type(shards).__name__}")


def commit_repartition(mex, staged: dict):
    """Rebuild one staged store on the resized mesh: a device store by
    one gather on its device (data/shards.py :func:`resplit_device`), a
    host store deserialized and re-split by ``dense_range_bounds``."""
    if staged["kind"] == "host":
        lists = [deserialize_batch(p) for p in staged["payloads"]]
        return HostShards(len(lists), lists).repartition(mex.num_workers)
    from ..data.shards import resplit_device
    return resplit_device(mex, staged["tree"], staged["counts"])


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
