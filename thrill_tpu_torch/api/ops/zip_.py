"""Zip, ZipWithIndex and ZipWindow (counterpart of the reference
package's ``api/ops/zip_.py``).

Realignment is an index-range exchange: item ``g`` of a DIA goes to the
worker whose bound of the target partition holds it (the first DIA's
partition cut to the output size, or an even split in pad mode). A
partition that already matches is kept without an exchange. The local
zip then calls ``zip_fn`` on the batched columns of every worker.

On host storage Zip calls ``zip_fn`` per item over the inputs in global
order and splits the output evenly; only mixed storage demotes the
device inputs to host items. ZipWithIndex on host storage calls
``zip_fn(item, global_index)`` per item.

Stitched (api/fusion.py): Zip's local zip is the head of a plan over
the realigned inputs, so downstream ops run in its program; ZipWithIndex
is a segment whose indices are each valid row's position in the chain's
mask plus the earlier workers' valid rows, summed in the program.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ...common import tree as pt
from ...common.partition import dense_range_bounds
from ...data import exchange, multiplexer
from ...data.shards import DeviceShards, HostShards
from ..dia import DIA
from ..dia_base import DIABase
from ...core.rowmove import row_cumsum
from ..stack import call_batched


def _mask_tail(shards: DeviceShards, n_out: int) -> DeviceShards:
    """Trim counts so only the first ``n_out`` global items stay valid."""
    new_counts = np.clip(n_out - shards.offsets(), 0, shards.counts)
    return DeviceShards(shards.mesh_exec, shards.tree,
                        new_counts.astype(np.int64))


def _realign(shards: DeviceShards, target_bounds: np.ndarray,
             n_out: int, token, min_cap: int = 1) -> DeviceShards:
    """Worker ``w`` gets global items ``[target_bounds[w],
    target_bounds[w+1])``; items from ``n_out`` on are dropped. Order is
    kept: the exchange is stable and receivers keep senders' rank
    order."""
    mex = shards.mesh_exec
    W = mex.num_workers
    offsets = mex.put_small(shards.offsets())
    upper = mex.put_small(np.asarray(target_bounds[1:], dtype=np.int64))

    def dest(tree, mask, widx):
        cap = mask.shape[1]
        g = offsets[:, None] + torch.arange(cap, device=mex.device)[None, :]
        return torch.searchsorted(upper, g, right=True)

    # the exchange clips valid destinations into [0, W): the tail past
    # n_out must be invalid before it runs, or it lands on worker W-1
    out = exchange.exchange(_mask_tail(shards, n_out), dest,
                            ("realign", token, W), min_cap=min_cap)
    out.validate_pending()          # optimistic-exchange heal point
    return out


def _realign_or_keep(p: DeviceShards, tb: np.ndarray, n_out: int, token,
                     min_cap: int = 1) -> DeviceShards:
    off = np.concatenate([[0], np.cumsum(p.global_counts)])
    if len(off) == len(tb) and np.array_equal(np.clip(off, 0, n_out), tb):
        return _mask_tail(p, n_out)
    return _realign(p, tb, n_out, token, min_cap=min_cap)


def _repad(shards: DeviceShards, cap: int) -> DeviceShards:
    """Zero rows appended up to capacity ``cap``."""
    if shards.cap >= cap:
        return shards
    pad = cap - shards.cap
    tree = pt.tree_map(lambda l: torch.cat(
        [l, torch.zeros((l.shape[0], pad) + tuple(l.shape[2:]),
                        dtype=l.dtype, device=l.device)], dim=1), shards.tree)
    return DeviceShards(shards.mesh_exec, tree, shards.counts)


class ZipNode(DIABase):
    def __init__(self, ctx, links, zip_fn: Optional[Callable],
                 mode: str) -> None:
        super().__init__(ctx, "Zip", links)
        if mode not in ("strict", "cut", "pad"):
            raise ValueError(f"Zip: unknown mode {mode!r}")
        self.zip_fn = zip_fn
        self.mode = mode

    def _out_size(self, totals: List[int]) -> int:
        if self.mode == "cut":
            return min(totals)
        if self.mode == "pad":
            return max(totals)
        if len(set(totals)) != 1:
            raise ValueError(
                f"Zip: unequal sizes {totals}; use mode='cut' or 'pad'")
        return totals[0]

    def compute_plan(self):
        from .. import fusion
        res = self._compute_any()
        if isinstance(res, fusion.FusionPlan):
            return res
        return fusion.wrap(res)

    def compute(self):
        from .. import fusion
        res = self._compute_any()
        if isinstance(res, fusion.FusionPlan):
            return res.finish()
        return res

    def _compute_any(self):
        pulls = [l.pull() for l in self.parents]
        if any(isinstance(p, HostShards) for p in pulls):
            return self._compute_host([
                p.to_host_shards("zip-mixed-storage")
                if isinstance(p, DeviceShards) else p for p in pulls])
        mex = pulls[0].mesh_exec
        W, Wl = mex.num_workers, mex.num_local
        totals = [p.total for p in pulls]
        n_out = self._out_size(totals)
        if self.mode == "pad" and max(totals) != min(totals):
            # every input realigned to an even split of n_out; a short
            # input's missing rows are zero items
            tb = dense_range_bounds(n_out, W)
            pad_cap = int(np.diff(tb).max())
            counts = mex.local(np.diff(tb).astype(np.int64))
            aligned = [
                DeviceShards(mex, _repad(
                    _realign_or_keep(p, tb, n_out, (self.id, i, "pad"),
                                     min_cap=pad_cap).zero_beyond_count(),
                    pad_cap).tree, counts.copy())
                for i, p in enumerate(pulls)]
        else:
            # the first DIA's partition, cut to n_out
            tb = np.clip(np.concatenate(
                [[0], np.cumsum(pulls[0].global_counts)]), 0, n_out)
            counts = mex.local(np.diff(tb).astype(np.int64))
            aligned = [_realign_or_keep(p, tb, n_out, (self.id, i))
                       for i, p in enumerate(pulls)]
        cap = max(a.cap for a in aligned)
        aligned = [_repad(a, cap) for a in aligned]
        from .. import fusion
        if fusion.enabled():
            # the local zip heads a plan over the aligned inputs, so the
            # ops downstream run in its program
            zip_fn = self.zip_fn

            def trace(fctx, states, _bound):
                return (call_batched(zip_fn, [t for t, _m in states], Wl,
                                     cap, mex.device), states[0][1])

            head = fusion.Segment(label="Zip",
                                  token=("zip_fuse_head", zip_fn,
                                         self.mode),
                                  trace=trace, already_compact=True,
                                  dia_id=self.id)
            return fusion.FusionPlan(
                mex, [DeviceShards(mex, a.tree, counts.copy())
                      for a in aligned], head=head, known_counts=counts)
        prog = mex.program(("zip", self.zip_fn), call_batched)
        return DeviceShards(mex, prog(self.zip_fn, [a.tree for a in aligned],
                                      Wl, cap, mex.device), counts)

    def _compute_host(self, pulls: List[HostShards]) -> HostShards:
        """Reference: ``thrill_tpu/api/ops/zip_.py:190-211``."""
        W = pulls[0].num_workers
        mex = self.context.mesh_exec
        pulls = [multiplexer.ensure_replicated(mex, p, "zip-host")
                 for p in pulls]
        lists = [[it for l in p.lists for it in l] for p in pulls]
        n_out = self._out_size([len(l) for l in lists])
        if self.mode == "pad":
            # Thrill's ZipPad pads with default-constructed items
            lists = [l + [_default_item(l)] * (n_out - len(l))
                     for l in lists]
        zf = self.zip_fn or (lambda *xs: tuple(xs))
        zipped = [zf(*vals) for vals in zip(*[l[:n_out] for l in lists])]
        bounds = dense_range_bounds(n_out, W).tolist()
        return multiplexer.localize(
            mex, HostShards(W, [zipped[bounds[w]:bounds[w + 1]]
                                for w in range(W)]))


def _default_item(items):
    """A zero or default-constructed item of the first item's schema
    (None for an empty side, which zips nothing)."""
    if not items:
        return None
    return pt.tree_map(lambda l: (np.zeros_like(np.asarray(l))
                                  if isinstance(l, (np.ndarray, np.generic))
                                  else type(l)()), items[0])


def _zwi_default(it, i):
    return (it, i)


class ZipWithIndexNode(DIABase):
    """``zip_fn(item, global_index)`` (reference: api/zip_with_index.hpp)."""

    def __init__(self, ctx, link, zip_fn: Optional[Callable]) -> None:
        super().__init__(ctx, "ZipWithIndex", [link])
        self.zip_fn = zip_fn or _zwi_default

    def _fuse_segment(self):
        """Global indices from the mask (reference:
        ``thrill_tpu/api/ops/zip_.py:310-326``): a valid row's position
        among its worker's valid rows plus the earlier workers' valid
        rows, both summed in the program."""
        from .. import fusion
        zf = self.zip_fn

        def trace(fctx, tree, mask, _bound):
            W, cap = mask.shape
            pos = row_cumsum(mask) - 1
            g = fctx.exclusive_offset(mask)[:, None] + pos
            return call_batched(zf, [tree, g], W, cap, mask.device), mask

        return fusion.Segment(label="ZipWithIndex",
                              token=("zip_index_fused", self.zip_fn),
                              trace=trace, preserves_counts=True,
                              dia_id=self.id)

    def compute_plan(self):
        from .. import fusion
        plan = fusion.pull_plan(self.parents[0])
        if not plan.stitchable:
            return fusion.wrap(self._compute_on(plan.finish()))
        plan.append(self._fuse_segment())
        return plan

    def compute(self):
        return self.compute_plan().finish()

    def _compute_on(self, shards):
        if isinstance(shards, HostShards):
            # reference: thrill_tpu/api/ops/zip_.py:336-350
            counts = multiplexer.global_counts(self.context.mesh_exec,
                                               shards)
            offsets = np.concatenate([[0], np.cumsum(counts)])
            return HostShards(shards.num_workers, [
                [self.zip_fn(it, int(offsets[w]) + i)
                 for i, it in enumerate(items)]
                for w, items in enumerate(shards.lists)])
        mex = shards.mesh_exec
        W, cap = mex.num_local, shards.cap
        g = (mex.put_small(shards.offsets())[:, None]
             + torch.arange(cap, device=mex.device)[None, :])
        prog = mex.program(("zip_index", self.zip_fn), call_batched)
        tree = prog(self.zip_fn, [shards.tree, g], W, cap, mex.device)
        return DeviceShards(mex, tree, shards.counts.copy())


class ZipWindowNode(DIABase):
    """Fixed-size windows zipped across DIAs (Thrill:
    ``api/zip_window.hpp``): DIA ``i`` is read in chunks of
    ``window[i]`` items, and output item ``j`` combines chunk ``j`` of
    every DIA, up to the shortest.

    Device path: each input is realigned so that worker ``w`` holds
    exactly its output chunks ``dense_range_bounds(n_out, W)[w:w+2]``,
    then viewed as ``[W, chunk_cap, window[i], ...]``; ``device_fn(*chunk
    trees)`` sees every worker's chunks on one item axis (leaves ``[n,
    window[i], ...]``), as the Map stack's batching does. Without
    ``zip_fn`` and ``device_fn`` the output is the reference's default
    schema, the tuple of the chunks, on the device."""

    def __init__(self, ctx, links, window, zip_fn: Optional[Callable],
                 device_fn: Optional[Callable] = None) -> None:
        super().__init__(ctx, "ZipWindow", links)
        self.window = tuple(int(w) for w in window)
        self.zip_fn = zip_fn
        self.device_fn = device_fn

    def compute(self):
        pulls = [l.pull() for l in self.parents]
        if all(isinstance(p, DeviceShards) for p in pulls):
            if self.device_fn is not None or self.zip_fn is None:
                return self._compute_device(pulls)
        if self.device_fn is not None and self.zip_fn is None:
            raise ValueError(
                "ZipWindow: inputs are host-resident but only device_fn "
                "was given: pass zip_fn alongside device_fn")
        mex = self.context.mesh_exec
        flats = [multiplexer.all_items(
            mex, p.to_host_shards("zipwindow")
            if isinstance(p, DeviceShards) else p) for p in pulls]
        n_out = min(len(f) // w for f, w in zip(flats, self.window))
        zf = self.zip_fn or (lambda *chunks: tuple(chunks))
        out = [zf(*[flats[i][j * w:(j + 1) * w]
                    for i, w in enumerate(self.window)])
               for j in range(n_out)]
        return multiplexer.split_even(mex, out, self.context.num_workers)

    def _compute_device(self, pulls: List[DeviceShards]) -> DeviceShards:
        mex = pulls[0].mesh_exec
        W, Wl = mex.num_workers, mex.num_local
        n_out = min(p.total // w for p, w in zip(pulls, self.window))
        cb = dense_range_bounds(n_out, W)                 # chunk bounds
        chunk_counts = np.diff(cb).astype(np.int64)
        chunk_cap = max(1, int(chunk_counts.max()))
        trees = []
        for i, (p, wsz) in enumerate(zip(pulls, self.window)):
            a = _repad(_realign_or_keep(p, cb * wsz, n_out * wsz,
                                        (self.id, i, "zw"),
                                        min_cap=chunk_cap * wsz),
                       chunk_cap * wsz)
            trees.append(pt.tree_map(
                lambda l, wsz=wsz: l[:, :chunk_cap * wsz].reshape(
                    (Wl, chunk_cap, wsz) + tuple(l.shape[2:])), a.tree))
        return DeviceShards(mex, call_batched(self.device_fn, trees, Wl,
                                              chunk_cap, mex.device),
                            mex.local(chunk_counts))


def Zip(dias: List[DIA], zip_fn=None, mode: str = "strict") -> DIA:
    if len(dias) < 2:
        raise ValueError("Zip needs at least two DIAs")
    return DIA(ZipNode(dias[0].context, [d._link() for d in dias], zip_fn,
                       mode))


def ZipWithIndex(dia: DIA, zip_fn=None) -> DIA:
    return DIA(ZipWithIndexNode(dia.context, dia._link(), zip_fn))


def ZipWindow(dias: List[DIA], window, zip_fn=None, device_fn=None) -> DIA:
    if len(dias) != len(window):
        raise ValueError(f"ZipWindow: {len(window)} window sizes for "
                         f"{len(dias)} DIAs")
    return DIA(ZipWindowNode(dias[0].context, [d._link() for d in dias],
                             window, zip_fn, device_fn))

