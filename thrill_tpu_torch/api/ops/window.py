"""Window, DisjointWindow and FlatWindow (counterpart of the reference
package's ``api/ops/window.py``; Thrill's ``api/window.hpp``).

A window of ``k`` items ending at local item ``j`` needs the ``k - 1``
items before it, which for the first items of a worker lie on the worker
before (Thrill's ``FlowControlChannel::Predecessor``, the reference's
``ppermute`` ring step). Here the halo is two steps on ``[W, ...]``
tensors: a gather of each worker's last ``k - 1`` valid rows, then a
shift by one along the worker dimension, worker 0's halo zeroed.
``[halo | rows]`` of every worker, laid end to end, unfolds into the
windows as a view (``Tensor.unfold``), so the ``[W * cap, k, ...]``
windows are never copied; the ``k - 1`` windows that straddle two
workers' blocks are computed and dropped.

``device_fn`` is batched as the Map stack is: it sees every worker's
windows on one item axis, ``[n, k, ...]`` leaves. Windows that do not
exist (before global item ``k - 1``, or ending past a worker's count)
are masked, and the kept rows compacted.

The reference's host fallback is its contract and is kept: host
storage, a ``partial_fn``, or a worker other than the last with fewer
than ``k - 1`` items run ``fn`` per window on the host, and raise when
only ``device_fn`` was given. ``MeshExec.device_runs`` counts the
device path's runs by op, so a caller can tell that nothing was
demoted. Fusion of
these ops into their neighbours is not ported (ROADMAP.md queue A).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ...common import tree as pt
from ...data.shards import DeviceShards, HostShards, compact_valid
from ..dia import DIA
from ..dia_base import DIABase

def _halo(leaf: torch.Tensor, counts: torch.Tensor, k: int) -> torch.Tensor:
    """``[W, k - 1, ...]``: row ``w`` holds the last ``k - 1`` valid rows
    of worker ``w - 1`` (zeros for worker 0). Only rows below a count are
    read (worker ``W - 1``'s gather is shifted out)."""
    W, cap = leaf.shape[:2]
    idx = (counts[:, None] - (k - 1)
           + torch.arange(k - 1, device=leaf.device)[None, :]).clamp(
        0, cap - 1)
    flat = (idx + torch.arange(W, device=leaf.device)[:, None] * cap
            ).reshape(-1)
    h = leaf.reshape((W * cap,) + tuple(leaf.shape[2:])).index_select(
        0, flat).reshape((W, k - 1) + tuple(leaf.shape[2:]))
    return torch.cat([torch.zeros_like(h[:1]), h[:-1]], dim=0)


def _windows(shards: DeviceShards, k: int):
    """The windows of every worker's rows: (tree of ``[W * (cap + k - 1)
    - k + 1, k, ...]`` views, window ``w * (cap + k - 1) + j`` ending at
    worker ``w``'s local item ``j``; ``[W, cap]`` mask of the windows
    whose items all exist; ``[W, cap]`` global index of each window's
    first item)."""
    mex = shards.mesh_exec
    W, cap, dev = shards.num_workers, shards.cap, mex.device
    counts = shards.counts_device()

    def unfold(leaf):
        ext = torch.cat([_halo(leaf, counts, k), leaf], dim=1)
        flat = ext.reshape((W * (cap + k - 1),) + tuple(leaf.shape[2:]))
        return flat.unfold(0, k, 1).movedim(-1, 1)

    offsets = np.concatenate([[0], np.cumsum(shards.counts)])[:-1]
    j = torch.arange(cap, device=dev)[None, :]
    g_end = mex.put_small(offsets.astype(np.int64))[:, None] + j
    ends_valid = (j < counts[:, None]) & (g_end >= k - 1)
    return pt.tree_map(unfold, shards.tree), ends_valid, g_end - (k - 1)


def _per_worker_rows(leaf: torch.Tensor, W: int, cap: int,
                     k: int) -> torch.Tensor:
    """The rows of a ``[W * (cap + k - 1) - k + 1, ...]`` output that
    belong to real windows, as ``[W, cap, ...]``."""
    trail = tuple(leaf.shape[1:])
    pad = torch.zeros((k - 1,) + trail, dtype=leaf.dtype, device=leaf.device)
    return torch.cat([leaf, pad], dim=0).reshape(
        (W, cap + k - 1) + trail)[:, :cap]


def _device_window_op(shards: DeviceShards, k: int, make_output,
                      label: str, factor: int = 0) -> DeviceShards:
    """Windows, then ``make_output(windows, ends_valid, g_start) -> (out
    tree, keep)`` on the windows' item axis: out leaves ``[n, ...]`` and
    keep ``[W, cap]``, or with a ``factor`` out leaves ``[n, factor,
    ...]`` and keep ``[W, cap, factor]``; the kept rows are compacted."""
    mex = shards.mesh_exec
    W, cap = shards.num_workers, shards.cap
    windows, ends_valid, g_start = _windows(shards, k)
    out, keep = make_output(windows, ends_valid, g_start)
    lead, rows = (3, cap * factor) if factor else (2, cap)

    def per_worker(leaf):
        r = _per_worker_rows(torch.as_tensor(leaf, device=mex.device),
                             W, cap, k)
        return r.reshape((W, rows) + tuple(r.shape[lead:]))

    mex.device_runs[label] += 1
    tree, counts = compact_valid(pt.tree_map(per_worker, out),
                                 keep.reshape(W, rows))
    return DeviceShards(mex, tree, mex.fetch(counts).astype(np.int64))


def _device_ok(shards, k: int) -> bool:
    return (isinstance(shards, DeviceShards)
            and bool(np.all(shards.counts[:-1] >= k - 1)))


class WindowNode(DIABase):
    def __init__(self, ctx, link, k: int, fn: Optional[Callable],
                 device_fn: Optional[Callable], disjoint: bool,
                 partial_fn: Optional[Callable] = None) -> None:
        super().__init__(ctx, "DisjointWindow" if disjoint else "Window",
                         [link])
        self.k = int(k)
        self.fn = fn
        self.device_fn = device_fn
        self.disjoint = disjoint
        # DisjointWindow hands the trailing block of fewer than k items
        # to partial_fn (Thrill: api/window.hpp:389); its length varies,
        # so it keeps the op on the host
        if partial_fn is not None and not disjoint:
            raise ValueError(
                "partial_fn only applies to DisjointWindow (the sliding "
                "Window has no trailing partial block)")
        self.partial_fn = partial_fn

    def compute(self):
        shards = self.parents[0].pull()
        if (self.device_fn is not None and self.partial_fn is None
                and _device_ok(shards, self.k)):
            return self._compute_device(shards)
        if self.fn is None:
            raise ValueError(
                f"{self.label} fell back to the host path (host storage, "
                f"a worker with fewer than k-1 items, or partial_fn, which "
                f"is host-only) but no host fn was given: pass fn "
                f"alongside device_fn")
        if isinstance(shards, DeviceShards):
            shards = shards.to_host_shards("window-host-fn")
        return self._compute_host(shards)

    def _compute_host(self, shards: HostShards) -> HostShards:
        k, fn = self.k, self.fn
        flat = [it for l in shards.lists for it in l]
        step = k if self.disjoint else 1
        out = [fn(i, flat[i:i + k])
               for i in range(0, len(flat) - k + 1, step)]
        if self.disjoint and self.partial_fn is not None and len(flat) % k:
            rest = flat[len(flat) - len(flat) % k:]
            out.append(self.partial_fn(len(flat) - len(rest), rest))
        return HostShards(1, [out]).repartition(shards.num_workers)

    def _compute_device(self, shards: DeviceShards) -> DeviceShards:
        k, fn, disjoint = self.k, self.device_fn, self.disjoint

        def make_output(windows, valid, g_start):
            if disjoint:
                # only the windows that start on a multiple of k
                valid = valid & (g_start % k == 0)
            return fn(windows), valid

        return _device_window_op(shards, k, make_output, self.label)


class FlatWindowNode(DIABase):
    """``fn(index, window) -> iterable`` of outputs per window on the
    host; on the device ``device_fn(windows) -> (outputs [n, factor,
    ...], mask [n, factor])`` with the static ``factor``, as the device
    FlatMap's contract."""

    def __init__(self, ctx, link, k: int, fn: Optional[Callable],
                 device_fn: Optional[Callable] = None,
                 factor: int = 0) -> None:
        super().__init__(ctx, "FlatWindow", [link])
        self.k = int(k)
        self.fn = fn
        self.device_fn = device_fn
        self.factor = int(factor)
        if device_fn is not None and self.factor <= 0:
            raise ValueError("FlatWindow device_fn requires factor > 0 "
                             "(static outputs per window)")
        if fn is None and device_fn is None:
            raise ValueError("FlatWindow needs fn and/or device_fn")

    def compute(self):
        shards = self.parents[0].pull()
        if self.device_fn is not None and _device_ok(shards, self.k):
            return self._compute_device(shards)
        if self.fn is None:
            raise ValueError(
                "FlatWindow fell back to the host path (host storage or a "
                "worker with fewer than k-1 items) but no host fn was "
                "given: pass fn alongside device_fn")
        if isinstance(shards, DeviceShards):
            shards = shards.to_host_shards("flatwindow")
        flat = [it for l in shards.lists for it in l]
        out = []
        for i in range(len(flat) - self.k + 1):
            out.extend(self.fn(i, flat[i:i + self.k]))
        return HostShards(1, [out]).repartition(shards.num_workers)

    def _compute_device(self, shards: DeviceShards) -> DeviceShards:
        fn, factor = self.device_fn, self.factor

        def make_output(windows, valid, g_start):
            out, mask = fn(windows)
            mask = _per_worker_rows(torch.as_tensor(
                mask, device=valid.device).to(torch.bool), *valid.shape,
                self.k)
            return out, valid[:, :, None] & mask

        return _device_window_op(shards, self.k, make_output, self.label,
                                 factor)


def Window(dia: DIA, k: int, fn, device_fn=None, disjoint: bool = False,
           partial_fn=None) -> DIA:
    return DIA(WindowNode(dia.context, dia._link(), k, fn, device_fn,
                          disjoint, partial_fn=partial_fn))


def FlatWindow(dia: DIA, k: int, fn=None, device_fn=None,
               factor: int = 0) -> DIA:
    return DIA(FlatWindowNode(dia.context, dia._link(), k, fn,
                              device_fn=device_fn, factor=factor))
