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
demoted.

Stitched (api/fusion.py), Window and FlatWindow with a ``device_fn`` are
segments when the chain before them keeps the source's host-known counts
(so the halo check needs no fetch): the counts and offsets of the halo
come from the chain's mask inside the program (reference:
``thrill_tpu/api/ops/window.py:96-111``).

Across processes the halo's shift and the offsets take every process's
workers (``mesh.worker_shift``, ``worker_exscan``), the checks read
the global counts, and the host paths replicate the items and keep
their own workers' share of the output.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ...common import tree as pt
from ...data import multiplexer
from ...data.shards import DeviceShards, HostShards, compact_valid
from ...parallel.mesh import current_mex, worker_shift
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
    # across processes the first local worker's halo comes from the
    # last worker of the process before
    return worker_shift(h, current_mex())


def _windows(tree, counts: torch.Tensor, offsets: torch.Tensor, k: int):
    """The windows of every worker's rows: (tree of ``[W * (cap + k - 1)
    - k + 1, k, ...]`` views, window ``w * (cap + k - 1) + j`` ending at
    worker ``w``'s local item ``j``; ``[W, cap]`` mask of the windows
    whose items all exist; ``[W, cap]`` global index of each window's
    first item). ``counts`` and ``offsets`` (each worker's first global
    index) are ``[W]`` device tensors."""
    W, cap = pt.leaves(tree)[0].shape[:2]
    dev = counts.device

    def unfold(leaf):
        ext = torch.cat([_halo(leaf, counts, k), leaf], dim=1)
        flat = ext.reshape((W * (cap + k - 1),) + tuple(leaf.shape[2:]))
        return flat.unfold(0, k, 1).movedim(-1, 1)

    j = torch.arange(cap, device=dev)[None, :]
    g_end = offsets[:, None] + j
    ends_valid = (j < counts[:, None]) & (g_end >= k - 1)
    return pt.tree_map(unfold, tree), ends_valid, g_end - (k - 1)


def _per_worker_rows(leaf: torch.Tensor, W: int, cap: int,
                     k: int) -> torch.Tensor:
    """The rows of a ``[W * (cap + k - 1) - k + 1, ...]`` output that
    belong to real windows, as ``[W, cap, ...]``."""
    trail = tuple(leaf.shape[1:])
    pad = torch.zeros((k - 1,) + trail, dtype=leaf.dtype, device=leaf.device)
    return torch.cat([leaf, pad], dim=0).reshape(
        (W, cap + k - 1) + trail)[:, :cap]


def _window_rows(tree, counts: torch.Tensor, offsets: torch.Tensor, k: int,
                 make_output, factor: int = 0):
    """Windows, then ``make_output(windows, ends_valid, g_start) -> (out
    tree, keep)`` on the windows' item axis: out leaves ``[n, ...]`` and
    keep ``[W, cap]``, or with a ``factor`` out leaves ``[n, factor,
    ...]`` and keep ``[W, cap, factor]``. Returns the output as ``[W,
    rows, ...]`` leaves and its ``[W, rows]`` keep mask, uncompacted."""
    W, cap = pt.leaves(tree)[0].shape[:2]
    windows, ends_valid, g_start = _windows(tree, counts, offsets, k)
    out, keep = make_output(windows, ends_valid, g_start)
    lead, rows = (3, cap * factor) if factor else (2, cap)

    def per_worker(leaf):
        r = _per_worker_rows(torch.as_tensor(leaf, device=counts.device),
                             W, cap, k)
        return r.reshape((W, rows) + tuple(r.shape[lead:]))

    return pt.tree_map(per_worker, out), keep.reshape(W, rows)


def _window_program(tree, counts, offsets, k, make_output, factor):
    return compact_valid(*_window_rows(tree, counts, offsets, k,
                                       make_output, factor))


def _device_window_op(shards: DeviceShards, k: int, make_output,
                      label: str, token, factor: int = 0) -> DeviceShards:
    """The windows' outputs of every worker (:func:`_window_rows`), the
    kept rows compacted, as one program."""
    mex = shards.mesh_exec
    offsets = mex.put_small(shards.offsets())
    prog = mex.program(("window",) + token, _window_program)
    tree, counts = prog(shards.tree, shards.counts_device(), offsets, k,
                        make_output, factor)
    mex.device_runs[label] += 1
    return DeviceShards(mex, tree, mex.fetch(counts).astype(np.int64))


def _window_segment(node, make_output, token, factor: int = 0):
    """A Window-family op as a segment: counts and offsets from the
    chain's mask, whose valid rows are a prefix under the gate of
    :func:`_fused_window_plan`."""
    from .. import fusion
    k, label = node.k, node.label
    mex = node.context.mesh_exec

    def trace(fctx, tree, mask, _bound):
        mex.device_runs[label] += 1
        return _window_rows(tree, fctx.count(mask),
                            fctx.exclusive_offset(mask), k, make_output,
                            factor)

    return fusion.Segment(label=label, token=token, trace=trace,
                          dia_id=node.id)


def _fused_window_plan(node):
    """The Window family's gate (reference:
    ``thrill_tpu/api/ops/window.py:96-111``): the halo check (every
    worker but the last holds at least k-1 items) needs host counts, so
    the op stitches only when the pending chain keeps the source's known
    counts; otherwise the chain runs and the per-op path takes over."""
    from .. import fusion
    plan = fusion.pull_plan(node.parents[0])
    if plan.stitchable and plan.counts_preserved() \
            and plan.known_counts is not None \
            and bool(np.all(node.context.mesh_exec.gather_host(
                plan.known_counts)[:-1] >= node.k - 1)):
        plan.append(node._fuse_segment())
        return plan
    return fusion.wrap(node._compute_on(plan.finish()))


def _device_ok(shards, k: int) -> bool:
    return (isinstance(shards, DeviceShards)
            and bool(np.all(shards.global_counts[:-1] >= k - 1)))


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

    def _make_output(self):
        k, fn, disjoint = self.k, self.device_fn, self.disjoint

        def make_output(windows, valid, g_start):
            if disjoint:
                # only the windows that start on a multiple of k
                valid = valid & (g_start % k == 0)
            return fn(windows), valid

        return make_output

    def _fuse_segment(self):
        return _window_segment(self, self._make_output(),
                               ("window_fused", self.device_fn,
                                self.disjoint, self.k))

    def compute_plan(self):
        if self.device_fn is None or self.partial_fn is not None:
            return None
        return _fused_window_plan(self)

    def compute(self):
        plan = self.compute_plan()
        if plan is not None:
            return plan.finish()
        return self._compute_on(self.parents[0].pull())

    def _compute_on(self, shards):
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
        mex = self.context.mesh_exec
        flat = multiplexer.all_items(mex, shards)
        step = k if self.disjoint else 1
        out = [fn(i, flat[i:i + k])
               for i in range(0, len(flat) - k + 1, step)]
        if self.disjoint and self.partial_fn is not None and len(flat) % k:
            rest = flat[len(flat) - len(flat) % k:]
            out.append(self.partial_fn(len(flat) - len(rest), rest))
        return multiplexer.split_even(mex, out, shards.num_workers)

    def _compute_device(self, shards: DeviceShards) -> DeviceShards:
        return _device_window_op(shards, self.k, self._make_output(),
                                 self.label, (self.device_fn,
                                              self.disjoint, self.k))


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

    def _make_output(self):
        fn, k = self.device_fn, self.k

        def make_output(windows, valid, g_start):
            out, mask = fn(windows)
            mask = _per_worker_rows(torch.as_tensor(
                mask, device=valid.device).to(torch.bool), *valid.shape, k)
            return out, valid[:, :, None] & mask

        return make_output

    def _fuse_segment(self):
        return _window_segment(self, self._make_output(),
                               ("flatwindow_fused", self.device_fn,
                                self.factor, self.k), self.factor)

    def compute_plan(self):
        if self.device_fn is None or self.factor <= 0:
            return None
        return _fused_window_plan(self)

    def compute(self):
        plan = self.compute_plan()
        if plan is not None:
            return plan.finish()
        return self._compute_on(self.parents[0].pull())

    def _compute_on(self, shards):
        if self.device_fn is not None and _device_ok(shards, self.k):
            return self._compute_device(shards)
        if self.fn is None:
            raise ValueError(
                "FlatWindow fell back to the host path (host storage or a "
                "worker with fewer than k-1 items) but no host fn was "
                "given: pass fn alongside device_fn")
        if isinstance(shards, DeviceShards):
            shards = shards.to_host_shards("flatwindow")
        mex = self.context.mesh_exec
        flat = multiplexer.all_items(mex, shards)
        out = []
        for i in range(len(flat) - self.k + 1):
            out.extend(self.fn(i, flat[i:i + self.k]))
        return multiplexer.split_even(mex, out, shards.num_workers)

    def _compute_device(self, shards: DeviceShards) -> DeviceShards:
        return _device_window_op(shards, self.k, self._make_output(),
                                 self.label, (self.device_fn, self.factor,
                                              self.k), self.factor)


def Window(dia: DIA, k: int, fn, device_fn=None, disjoint: bool = False,
           partial_fn=None) -> DIA:
    return DIA(WindowNode(dia.context, dia._link(), k, fn, device_fn,
                          disjoint, partial_fn=partial_fn))


def FlatWindow(dia: DIA, k: int, fn=None, device_fn=None,
               factor: int = 0) -> DIA:
    return DIA(FlatWindowNode(dia.context, dia._link(), k, fn,
                              device_fn=device_fn, factor=factor))
