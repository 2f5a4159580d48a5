"""Distributed item storage (counterpart of the reference package's
``data/shards.py``).

DeviceShards: columnar ``[W, cap, ...]`` leaves plus per-worker valid
counts. In a mesh of several processes (parallel/mesh.py) a process
holds its local workers' rows only, ``[W_local, cap, ...]`` leaves and
``W_local`` counts; ``global_counts`` and ``total`` are every worker's,
agreed over the processes, and every process's shards of one DIA share
one ``cap``. Rows ``[0, counts[w])`` of worker ``w`` are its items; rows past
the count are padding whose contents are unspecified unless the maker
says otherwise (``from_worker_arrays`` and ``zero_beyond_count`` give
zeros, as the reference's buffers hold; the exchange leaves copies).

HostShards: per-worker Python item lists, for items of any type. Across
processes a process fills only its local workers' lists, the others stay
empty (the reference's host-storage invariant, data/multiplexer.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import tree as pt
from ..common.partition import dense_range_bounds
from ..core.rowmove import row_cumsum, scatter_slots, take_rows
from ..parallel.mesh import DeviceLike, MeshExec


def round_up_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def itemize(tree: Any) -> list:
    """A columnar pytree of numpy leaves (item axis 0) as a list of
    items: scalar columns as Python numbers, array columns as numpy
    rows, a bare leaf's items unwrapped. Every place that turns columns
    into host items goes through here, so item types do not depend on
    the path that made them."""
    leaves, td = pt.flatten(tree)
    if not leaves:
        return []
    cols = [l.tolist() if l.ndim == 1 else list(l) for l in leaves]
    if td is pt.LEAF:
        return cols[0]
    return [pt.unflatten(td, list(vals)) for vals in zip(*cols)]


def columnarize(items: Sequence[Any]) -> Any:
    """A non-empty list of fixed-shape item pytrees as one pytree of
    numpy columns. Leaves that are not numbers raise TypeError, as the
    reference's device upload does."""
    rows = [pt.flatten(it) for it in items]
    td = rows[0][1]
    cols = [np.asarray([r[0][i] for r in rows])
            for i in range(len(rows[0][0]))]
    for c in cols:
        if c.dtype.kind not in "biufc":
            raise TypeError(f"Dtype {c.dtype} is not a valid device array "
                            f"type. Only arrays of numeric types are "
                            f"supported on device storage")
    return pt.unflatten(td, cols)


def _host_source(leaf: Any, device: torch.device) -> torch.Tensor:
    """``leaf`` as a tensor to copy to ``device`` from: a host array
    bound for the card is staged in page-locked memory, so the upload is
    one DMA that does not block the host."""
    t = torch.as_tensor(leaf)
    if device.type == "cuda" and t.device.type == "cpu" and not t.is_pinned():
        t = t.pin_memory()
    return t


class DeviceShards:
    """Leaves ``[W, cap, ...]`` on the mesh's device plus per-worker
    valid counts, held in one of two forms that convert lazily
    (reference: ``thrill_tpu/data/shards.py:90-200``):

    * on the host (numpy ``[W]`` int64, ``_counts_host``), which plan
      steps need (exchange sizing, splitters, action results);
    * on the device (a ``[W]`` int64 tensor, ``_counts_dev``), the
      output of a stitched program (api/fusion.py), which is all the
      next program needs.

    ``counts`` fetches device counts once, on first use, through the
    mesh's counted :meth:`MeshExec.fetch`, so a chain of device ops
    makes no host round trip between them and a test can count the
    ones it makes. ``_counts_check`` is a deferred validation (the
    hinted join's overflow check) run when the counts first reach the
    host, or earlier by :meth:`validate_pending`."""

    def __init__(self, mesh_exec: MeshExec, tree: Any, counts) -> None:
        self.mesh_exec = mesh_exec
        self.tree = tree
        if isinstance(counts, torch.Tensor):
            self._counts_host: Optional[np.ndarray] = None
            self._counts_dev: Optional[torch.Tensor] = counts.reshape(
                -1).to(torch.int64)
        else:
            self._counts_host = np.asarray(counts, dtype=np.int64)
            self._counts_dev = None
        self._counts_check: Optional[Callable] = None
        self._counts_global: Optional[np.ndarray] = None

    @property
    def global_counts(self) -> np.ndarray:
        """Every worker's count, ``[W]``: :attr:`counts` in one process,
        gathered from every process in several."""
        if not self.mesh_exec.multiprocess:
            return self.counts
        if self._counts_global is None:
            self._counts_global = self.mesh_exec.gather_host(self.counts)
        return self._counts_global

    @property
    def counts(self) -> np.ndarray:
        """Host counts; fetched from the device (and kept) on first
        use. A pending check runs before they are kept: if it raises,
        the next read checks again; a recovering check may heal the
        tree in place and return the counts that replace these."""
        if self._counts_host is None:
            counts = self.mesh_exec.fetch(self._counts_dev).reshape(
                -1).astype(np.int64)
            if self._counts_check is not None:
                fixed = self._counts_check(counts)
                self._counts_check = None
                if fixed is not None:
                    counts = np.asarray(fixed, dtype=np.int64)
            self._counts_host = counts
        return self._counts_host

    def validate_pending(self) -> None:
        """Run a deferred counts check now (nothing without one): a
        consumer calls this before it reads the columns, so a hinted
        join's overflow is found, and healed, before truncated rows can
        flow on. Its transfer is :meth:`MeshExec._fetch_raw`, which is
        not counted as a host sync of the chain."""
        if self._counts_check is None:
            return
        if self._counts_host is not None:
            counts = self._counts_host
        else:
            counts = self.mesh_exec._fetch_raw(
                self._counts_dev).reshape(-1).astype(np.int64)
        fixed = self._counts_check(counts)      # stays set if it raises
        self._counts_check = None
        if fixed is not None:
            self._counts_host = np.asarray(fixed, dtype=np.int64)
        elif self._counts_host is None:
            self._counts_host = counts

    @property
    def num_workers(self) -> int:
        return self.mesh_exec.num_workers

    @property
    def cap(self) -> int:
        return pt.leaves(self.tree)[0].shape[1]

    @property
    def total(self) -> int:
        """Every worker's items (every process's, across processes)."""
        return int(self.global_counts.sum())

    def offsets(self) -> np.ndarray:
        """``[W_local]`` int64: the global index of each local worker's
        first item (the items of every worker before it)."""
        g = self.global_counts
        return self.mesh_exec.local(
            np.concatenate([[0], np.cumsum(g)])[:-1].astype(np.int64))

    def counts_device(self) -> torch.Tensor:
        """Counts as a ``[W]`` int64 tensor on the device, uploaded once
        when they are host counts."""
        if self._counts_dev is None:
            self._counts_dev = self.mesh_exec.put_small(self._counts_host)
        return self._counts_dev

    def counts_like(self):
        """These counts in the form they are held (host copy or device
        tensor), for shards of the same rows, without a fetch."""
        if self._counts_host is not None:
            return self._counts_host.copy()
        return self._counts_dev

    def valid_mask(self) -> torch.Tensor:
        """``[W, cap]`` bool: row is one of its worker's items."""
        ar = torch.arange(self.cap, device=self.mesh_exec.device)
        return ar[None, :] < self.counts_device()[:, None]

    @staticmethod
    def from_worker_arrays(mesh_exec: MeshExec, per_worker: Sequence[Any],
                           counts=None) -> "DeviceShards":
        """Shards from W per-worker pytrees (numpy arrays or tensors,
        item axis 0): worker ``w``'s first ``counts[w]`` rows are copied
        straight into its ``[cap]`` slice (host arrays through pinned
        memory, one copy a worker and leaf), and rows past each count
        are zeros. ``counts`` defaults to each worker's length. Across
        processes a process reads its local workers' pytrees (the
        others may be empty) and the capacity comes from every
        worker's count."""
        W = mesh_exec.num_workers
        if len(per_worker) != W:
            raise ValueError(f"from_worker_arrays: {len(per_worker)} "
                             f"pytrees for W={W}")
        lo, Wl = mesh_exec.worker_base, mesh_exec.num_local
        flat = [pt.flatten(t) for t in per_worker[lo:lo + Wl]]
        td = flat[0][1]
        if counts is None:
            counts = [int(leaves[0].shape[0]) if leaves else 0
                      for leaves, _ in flat]
        else:
            counts = np.asarray(counts, dtype=np.int64)[lo:lo + Wl]
        counts = np.asarray(counts, dtype=np.int64)
        cap = round_up_pow2(int(mesh_exec.gather_host(counts).max()))
        dev = mesh_exec.device
        out = []
        for li in range(len(flat[0][0])):
            srcs = [_host_source(leaves[li], dev) for leaves, _ in flat]
            buf = torch.zeros((Wl, cap) + tuple(srcs[0].shape[1:]),
                              dtype=srcs[0].dtype, device=dev)
            for w, src in enumerate(srcs):
                c = int(counts[w])
                if c:
                    buf[w, :c].copy_(src[:c], non_blocking=True)
            out.append(mesh_exec.bless(buf))
        return DeviceShards(mesh_exec, pt.unflatten(td, out), counts)

    @staticmethod
    def from_global_numpy(mesh_exec: MeshExec, tree: Any,
                          counts=None) -> "DeviceShards":
        """Range-split one global pytree (item axis 0; numpy arrays or
        tensors) across the workers, order preserved: evenly, or worker
        ``w`` taking the next ``counts[w]`` items. Across processes
        every process is given the same pytree and keeps its local
        workers' ranges."""
        W = mesh_exec.num_workers
        lo, Wl = mesh_exec.worker_base, mesh_exec.num_local
        dev = mesh_exec.device
        leaves, td = pt.flatten(tree)
        n = int(leaves[0].shape[0]) if leaves else 0
        bnd = (dense_range_bounds(n, W) if counts is None else
               np.concatenate([[0], np.cumsum(counts)]).astype(np.int64))
        counts = np.diff(bnd)
        cap = round_up_pow2(int(counts.max()))
        # rows past a worker's count repeat row n-1 (masked by counts)
        idx = np.minimum(np.arange(cap)[None, :] + bnd[lo:lo + Wl, None],
                         max(n - 1, 0)).reshape(-1)
        idx_t = torch.as_tensor(idx, device=dev)

        def place(leaf):
            t = torch.as_tensor(leaf)
            if n == 0:
                return torch.zeros((Wl, cap) + tuple(t.shape[1:]),
                                   dtype=t.dtype, device=dev)
            if Wl < W and t.device != dev:
                # only the local ranges cross to the device
                t = t[int(bnd[lo]):int(bnd[lo + Wl])]
                sel = idx_t - int(bnd[lo])
                sel = sel.clamp(0, max(t.shape[0] - 1, 0))
                return t.to(dev).index_select(0, sel).reshape(
                    (Wl, cap) + tuple(t.shape[1:]))
            return t.to(dev).index_select(0, idx_t).reshape(
                (Wl, cap) + tuple(t.shape[1:]))

        # host uploads: legitimate constants of a loop capture
        return DeviceShards(mesh_exec, pt.unflatten(
            td, [mesh_exec.bless(place(l)) for l in leaves]),
            counts[lo:lo + Wl])

    def to_worker_arrays(self) -> List[Any]:
        """The local workers' pytrees of numpy arrays (every worker's in
        one process), trimmed to the counts."""
        # a pending check may heal the tree: run it before reading it
        self.validate_pending()
        host = pt.tree_map(self.mesh_exec.fetch, self.tree)
        return [pt.tree_map(lambda a, w=w: a[w, :int(self.counts[w])], host)
                for w in range(len(self.counts))]

    def to_global_numpy(self) -> Any:
        """All workers' items concatenated in worker-rank order (every
        process's, across processes)."""
        per_worker = self.to_worker_arrays()
        local = pt.tree_map(lambda *ls: np.concatenate(ls, axis=0),
                            *per_worker)
        parts = self.mesh_exec.allgather_object(local)
        if len(parts) == 1:
            return local
        return pt.tree_map(lambda *ls: np.concatenate(ls, axis=0), *parts)

    def to_host_shards(self, reason: str = "unspecified") -> "HostShards":
        """Itemize into per-worker Python lists: the pipeline leaves
        columnar device storage and goes on at Python speed. Every such
        demotion logs ``event=device_to_host`` with ``reason`` (the op
        that forced it) and the items, counted off the lists made."""
        mex = self.mesh_exec
        lists = [[] for _ in range(mex.worker_base)] + [
            itemize(t) for t in self.to_worker_arrays()]
        lists += [[] for _ in range(self.num_workers - len(lists))]
        log = getattr(mex, "logger", None)
        if log is not None and log.enabled:
            log.line(event="device_to_host", reason=reason,
                     items=sum(len(l) for l in lists))
        return HostShards(self.num_workers, lists)

    def zero_beyond_count(self) -> "DeviceShards":
        """The same items with every row at or past its worker's count
        zeroed: the reference's pad items. The exchange leaves copies of
        shipped rows there (ROADMAP.md fault C4)."""
        mask = self.valid_mask()

        def zero(leaf):
            m = mask.reshape(mask.shape + (1,) * (leaf.dim() - 2))
            return torch.where(m, leaf, torch.zeros(
                (), dtype=leaf.dtype, device=leaf.device))

        return DeviceShards(self.mesh_exec, pt.tree_map(zero, self.tree),
                            self.counts_like())


@dataclasses.dataclass
class HostShards:
    """Per-worker Python item lists: storage for items of any type, one
    process holding every worker's list."""

    num_workers: int
    lists: List[List[Any]]

    @property
    def counts(self) -> np.ndarray:
        return np.array([len(l) for l in self.lists], dtype=np.int64)

    @property
    def total(self) -> int:
        return sum(len(l) for l in self.lists)

    def repartition(self, new_w: int) -> "HostShards":
        """The items in worker-rank order, re-split over ``new_w``
        workers by ``dense_range_bounds``."""
        merged = [it for items in self.lists for it in items]
        bounds = dense_range_bounds(len(merged), new_w).tolist()
        return HostShards(new_w, [merged[bounds[w]:bounds[w + 1]]
                                  for w in range(new_w)])

    def to_device(self, mesh_exec: MeshExec) -> DeviceShards:
        """Columnarize each worker's items (fixed-shape pytrees of
        numbers) into device shards; an empty worker takes the schema of
        a non-empty one (of any process's, across processes)."""
        if mesh_exec.multiprocess:
            from .multiplexer import host_to_device
            return host_to_device(mesh_exec, self)
        per_worker = [columnarize(items) if items else None
                      for items in self.lists]
        template = next((t for t in per_worker if t is not None), None)
        if template is None:
            raise ValueError("cannot infer schema of an entirely empty DIA")
        empty = pt.tree_map(lambda a: a[:0], template)
        return DeviceShards.from_worker_arrays(
            mesh_exec, [empty if t is None else t for t in per_worker])


def from_numpy_shards(tree: Any, counts, device: DeviceLike = None
                      ) -> DeviceShards:
    """Shards given as ``[W, cap, ...]`` numpy leaves plus counts (for
    instance the reference package's DeviceShards fetched to the host)
    as the port's DeviceShards on a new W-worker mesh."""
    counts = np.asarray(counts, dtype=np.int64)
    mex = MeshExec(num_workers=len(counts), device=device)
    leaves, td = pt.flatten(tree)
    for l in leaves:
        if l.shape[0] != len(counts):
            raise ValueError(f"leaf of shape {l.shape} does not lead "
                             f"with W={len(counts)}")
    return DeviceShards(
        mex, pt.unflatten(td, [torch.tensor(np.asarray(l), device=mex.device)
                               for l in leaves]), counts)


def compact_valid(tree: Any, mask: torch.Tensor) -> Tuple[Any, torch.Tensor]:
    """Move each worker's valid rows to the front, stably.

    ``tree`` leaves ``[W, n, ...]``, ``mask`` ``[W, n]`` bool. Returns
    (tree, counts ``[W]``). One scatter of row indices builds each
    output row's source (invalid rows go to dump rows), and every leaf is
    gathered by it. Rows past a worker's count repeat row 0.
    """
    W, n = mask.shape
    region = 2 * n
    src = torch.zeros(W * region, dtype=torch.int64, device=mask.device)
    src.index_put_((scatter_slots(row_cumsum(mask) - 1, mask, n),),
                   torch.arange(n, device=mask.device).repeat(W))
    src = src.reshape(W, region)[:, :n]
    return pt.tree_map(lambda l: take_rows(l, src), tree), mask.sum(dim=1)
