"""Distributed sample sort (counterpart of the reference package's
``api/ops/sort.py``). Host storage, and a ``compare_fn`` on any storage,
sort the items in memory on the host; device storage takes the sample
sort below.

All W workers run each phase as one batched program over ``[W, cap]``
tensors; only (validity, key words, global index) go through the sort
engine and the payload is gathered once per phase:

 1. keys:     per-worker argsort of (key words, global index) and
              OVERSAMPLE quantile samples. W == 1 ends here with one
              payload gather.
 2. classify: the host picks W-1 splitters from the samples; each item's
              destination is its rank among them under the (words,
              global index) order, so equal keys spread across workers
              and destinations are monotone in the sorted order. The
              send matrix comes from the histogram kernel.
 3. merge:    ship the blocks (scatter plus a worker-dim transpose),
              then one argsort of the received (invalid, words, global
              index) and one payload gather.

The order (words, global index) is total, so the result is globally
sorted across worker ranks and stable, row for row the reference's.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional

import numpy as np
import torch

from ...common import tree as pt
from ...core import keys as keymod
from ...core.device_sort import argsort_words
from ...core.rowmove import take_rows, take_rows_multi
from ...data import exchange
from ...data.shards import DeviceShards, HostShards
from ..dia import DIA
from ..dia_base import DIABase

OVERSAMPLE = 32  # samples per worker; splitter error ~ 1/OVERSAMPLE
VALID_BITS = 8   # the validity word is 0 or 1: one radix digit


def quantile_positions(counts: torch.Tensor, cap: int) -> torch.Tensor:
    """``[W, OVERSAMPLE]`` quantile positions over each worker's valid
    prefix ``[0, count)`` of a sorted column, clipped to ``[0, cap)``."""
    count = counts.to(torch.int64).clamp(min=1)[:, None]
    k = torch.arange(OVERSAMPLE, device=counts.device)[None, :]
    return ((k * 2 + 1) * count // (2 * OVERSAMPLE)).clamp(0, cap - 1)


def choose_splitters(samples, W: int, ncols: int) -> np.ndarray:
    """W-1 equidistant splitters from SORTED sample tuples (each a flat
    tuple of ints, ncols wide) -> uint64 ``[max(W-1, 1), ncols]``."""
    splitters = np.zeros((max(W - 1, 1), ncols), dtype=np.uint64)
    if samples and W > 1:
        for j in range(1, W):
            s = samples[min(len(samples) - 1, (j * len(samples)) // W)]
            splitters[j - 1] = np.array(s, dtype=np.uint64)
    return splitters


def _lex_greater(words: torch.Tensor, gidx: torch.Tensor,
                 splitter: torch.Tensor) -> torch.Tensor:
    """(words, gidx) > splitter lexicographically in unsigned order.
    ``words`` ``[W, cap, nw]``, ``gidx`` ``[W, cap]``, ``splitter``
    ``[nw + 1]`` int64 -> ``[W, cap]`` bool."""
    nw = words.shape[2]
    spl = keymod.order_view(splitter)
    gt = torch.zeros(gidx.shape, dtype=torch.bool, device=gidx.device)
    eq = torch.ones_like(gt)
    for i in range(nw):
        w = keymod.order_view(words[:, :, i])
        gt |= eq & (w > spl[i])
        eq &= w == spl[i]
    return gt | (eq & (keymod.order_view(gidx) > spl[nw]))


class SortNode(DIABase):
    def __init__(self, ctx, link, key_fn: Optional[Callable],
                 compare_fn: Optional[Callable] = None) -> None:
        super().__init__(ctx, "Sort", [link])
        self.key_fn = key_fn or (lambda x: x)
        self.compare_fn = compare_fn

    def compute(self):
        shards = self.parents[0].pull()
        if isinstance(shards, HostShards):
            return self._compute_host(shards)
        if self.compare_fn is not None:
            # a comparator sees items, not columns: the items move to the
            # host, as in the reference
            return self._compute_host(shards.to_host_shards("sort-compare-fn"))
        return _device_sample_sort(shards, self.key_fn)

    def _compute_host(self, shards: HostShards) -> HostShards:
        """Every item sorted in memory by ``key_fn`` per item, or by the
        less-than predicate ``compare_fn``, stably, then split evenly.
        The reference spills runs above 2^20 items to files and merges
        them (``_em_sort``) in the same order; that waits for the
        out-of-core layer (ROADMAP.md queue A 'Still to port' item 5)."""
        if self.compare_fn is not None:
            less = self.compare_fn
            sort_key = functools.cmp_to_key(
                lambda a, b: -1 if less(a, b) else (1 if less(b, a) else 0))
        else:
            sort_key = self.key_fn
        items = sorted((it for l in shards.lists for it in l), key=sort_key)
        return HostShards(1, [items]).repartition(shards.num_workers)


def _device_sample_sort(shards: DeviceShards,
                        key_fn: Callable) -> DeviceShards:
    mex = shards.mesh_exec
    W, cap, dev = mex.num_workers, shards.cap, mex.device
    leaves, treedef = pt.flatten(shards.tree)
    if shards.total == 0:
        return shards
    counts = shards.counts_device()
    offsets = np.concatenate([[0], np.cumsum(shards.counts)])[:-1]
    # every shard full: the validity word is dropped (the common case
    # after Distribute/Generate)
    full = bool(np.all(shards.counts == cap))
    ar = torch.arange(cap, device=dev)
    # [W, cap]; after the phase-1 argsort the valid rows come first, so
    # the same mask marks the valid rows of the sorted columns
    valid = shards.valid_mask()
    words = keymod.worker_key_words(key_fn, shards.tree)
    nwords = len(words)
    lead = [] if full else [(~valid).to(torch.int64)]
    lead_bits = [] if full else [VALID_BITS]

    if W == 1:
        # one worker: key argsort and one payload gather, no exchange
        iota = ar[None, :].clone()
        perm = argsort_words(lead + words + [iota],
                             lead_bits + [64] * (nwords + 1),
                             passes=mex.radix_passes)
        out = take_rows_multi(leaves, perm)
        return DeviceShards(mex, pt.unflatten(treedef, out),
                            shards.counts.copy())

    # ---- phase 1: key argsort + quantile samples (no payload) ---------
    gidx = mex.put_small(offsets.astype(np.int64))[:, None] + ar[None, :]
    perm = argsort_words(lead + words + [gidx],
                         lead_bits + [64] * (nwords + 1),
                         passes=mex.radix_passes)
    words_s = torch.stack([torch.gather(w, 1, perm) for w in words], dim=2)
    gidx_s = torch.gather(gidx, 1, perm)
    qpos = quantile_positions(counts, cap)                    # [W, S]
    s_words = take_rows(words_s, qpos)                        # [W, S, nw]
    s_idx = torch.gather(gidx_s, 1, qpos)
    s_valid = qpos < counts[:, None]

    # ---- host: choose splitters (the "worker 0" step) -----------------
    splitters = device_splitters(
        mex, host_samples(mex, s_words, s_idx, s_valid), W, nwords + 1)

    # ---- phase 2: classify sorted keys + the one payload gather -------
    d = torch.zeros((W, cap), dtype=torch.int32, device=dev)
    for j in range(W - 1):
        d += _lex_greater(words_s, gidx_s, splitters[j]).to(torch.int32)
    dest = torch.where(valid, d, torch.full_like(d, W))
    S = mex.fetch(exchange.send_counts(dest, W)).astype(np.int64)
    payload = take_rows_multi(leaves, perm)
    out = _fused_exchange_merge(mex, dest, words_s, gidx_s, payload, S)
    return DeviceShards(mex, pt.unflatten(treedef, out), S.sum(axis=0))


def host_samples(mex, s_words: torch.Tensor, s_idx: torch.Tensor,
                 s_valid: torch.Tensor, tag: tuple = ()) -> list:
    """The valid quantile samples on the host: tuples of (key words as
    unsigned ints, ``*tag``, global index), so that Python's tuple order
    is the unsigned order of the words (C1). ``s_words`` ``[W, S, nw]``,
    ``s_idx`` and ``s_valid`` ``[W, S]``."""
    W, S, nwords = s_words.shape
    sw = mex.fetch(s_words).view(np.uint64).reshape(W * S, nwords)
    si = mex.fetch(s_idx).reshape(-1)
    sv = mex.fetch(s_valid).reshape(-1)
    return [tuple(int(x) for x in sw[i]) + tag + (int(si[i]),)
            for i in range(len(sv)) if sv[i]]


def device_splitters(mex, samples: list, W: int,
                     ncols: int) -> torch.Tensor:
    """W-1 splitters of the sample tuples, on the device as int64 bit
    patterns ``[max(W-1, 1), ncols]``."""
    return mex.put_small(choose_splitters(sorted(samples), W, ncols).view(
        np.int64))


def merge_blocks(mex, blocks, out_cap: int) -> List[torch.Tensor]:
    """Merge each worker's sorted runs with one argsort and one payload
    gather. ``blocks`` holds per input (valid ``[W, n]``, key words ``[W,
    n, nw]``, global index ``[W, n]``, payload leaves ``[W, n, ...]``);
    the argsort is of (invalid, key words, input index where there are
    several inputs, global index), so equal keys order by input, then by
    original position. Returns the payload leaves ``[W, out_cap, ...]``;
    rows past the counts are invalid rows, repeated where ``out_cap``
    passes the blocks' width."""
    W = mex.num_workers

    def cat(xs):
        return xs[0] if len(xs) == 1 else torch.cat(xs, dim=1)

    valid, words, gidx = (cat([b[i] for b in blocks]) for i in range(3))
    payload = [cat(list(ls)) for ls in zip(*(b[3] for b in blocks))]
    nwords = words.shape[2]
    sort_words = ([(~valid).to(torch.int64)]
                  + [words[:, :, k].contiguous() for k in range(nwords)])
    bits = [VALID_BITS] + [64] * nwords
    if len(blocks) > 1:
        sort_words.append(cat([torch.full(b[2].shape, i, dtype=torch.int64,
                                          device=gidx.device)
                               for i, b in enumerate(blocks)]))
        bits.append(len(blocks).bit_length())
    perm = argsort_words(sort_words + [gidx], bits + [64],
                         passes=mex.radix_passes)
    if out_cap > perm.shape[1]:
        perm = torch.cat([perm, perm[:, -1:].expand(
            W, out_cap - perm.shape[1])], dim=1)
    return take_rows_multi(payload, perm[:, :out_cap])


def _fused_exchange_merge(mex, dest, words_s, gidx_s, payload,
                          S: np.ndarray) -> List[torch.Tensor]:
    """Ship the classified rows and merge each receiver's W runs straight
    from the shipped blocks (:func:`merge_blocks`), with no compaction
    gather. Returns the payload leaves ``[W, max(received), ...]``."""
    W, dev = mex.num_workers, mex.device
    ship, S_dev, M_pad = exchange.ship_presorted(
        mex, dest, S, exchange.leaf_item_bytes(payload)
        + 8 * (words_s.shape[2] + 1))
    wm_r = ship(words_s)                               # [W, W*M_pad, nw]
    gi_r = ship(gidx_s)                                # [W, W*M_pad]
    payload_r = [ship(p) for p in payload]
    j = torch.arange(M_pad, device=dev)
    # receiver w's run from sender s holds S[s, w] rows
    valid = (j[None, None, :] < S_dev.T[:, :, None]).reshape(W, W * M_pad)
    return merge_blocks(mex, [(valid, wm_r, gi_r, payload_r)],
                        max(int(S.sum(axis=0).max()), 1))


def Sort(dia: DIA, key_fn=None, compare_fn=None) -> DIA:
    return DIA(SortNode(dia.context, dia._link(), key_fn, compare_fn))
