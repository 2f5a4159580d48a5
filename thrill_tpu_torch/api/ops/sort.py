"""Distributed sample sort (counterpart of the device path of the
reference package's ``api/ops/sort.py``).

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

from typing import Callable, List, Optional

import numpy as np
import torch

from ...common import tree as pt
from ...core import keys as keymod
from ...core.device_sort import argsort_words
from ...core.rowmove import take_rows, take_rows_multi
from ...data import exchange
from ...data.shards import DeviceShards
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
    def __init__(self, ctx, link, key_fn: Optional[Callable]) -> None:
        super().__init__(ctx, "Sort", [link])
        self.key_fn = key_fn or (lambda x: x)

    def compute(self) -> DeviceShards:
        return _device_sample_sort(self.pull_device(), self.key_fn)


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
    sw = mex.fetch(s_words).view(np.uint64).reshape(W * OVERSAMPLE, nwords)
    si = mex.fetch(s_idx).reshape(-1)
    sv = mex.fetch(s_valid).reshape(-1)
    samples = sorted(tuple(int(x) for x in sw[i]) + (int(si[i]),)
                     for i in range(len(sv)) if sv[i])
    splitters = mex.put_small(
        choose_splitters(samples, W, nwords + 1).view(np.int64))

    # ---- phase 2: classify sorted keys + the one payload gather -------
    d = torch.zeros((W, cap), dtype=torch.int32, device=dev)
    for j in range(W - 1):
        d += _lex_greater(words_s, gidx_s, splitters[j]).to(torch.int32)
    dest = torch.where(valid, d, torch.full_like(d, W))
    S = mex.fetch(exchange.send_counts(dest, W)).astype(np.int64)
    payload = take_rows_multi(leaves, perm)
    out = _fused_exchange_merge(mex, dest, words_s, gidx_s, payload, S)
    return DeviceShards(mex, pt.unflatten(treedef, out), S.sum(axis=0))


def _fused_exchange_merge(mex, dest, words_s, gidx_s, payload,
                          S: np.ndarray) -> List[torch.Tensor]:
    """Ship the classified rows and merge each receiver's W runs with one
    argsort of (invalid, words, global index) and one payload gather.
    Returns the payload leaves ``[W, max(received), ...]``."""
    W, cap, nwords = words_s.shape
    dev = mex.device
    R = S.sum(axis=0)
    M_pad = max(int(S.max()), 1)
    out_cap = max(int(R.max()), 1)
    exchange.account_traffic(
        mex, S, exchange.leaf_item_bytes(payload) + 8 * (nwords + 1))
    S_dev = mex.put_small(S)
    send_idx = exchange.send_slot_index(dest, S_dev, W, M_pad, cap)

    def ship(x):
        return exchange.ship_blocks(x, send_idx, W, M_pad)

    wm_r = ship(words_s)                               # [W, W*M_pad, nw]
    gi_r = ship(gidx_s)                                # [W, W*M_pad]
    payload_r = [ship(p) for p in payload]
    j = torch.arange(M_pad, device=dev)
    # receiver w's run from sender s holds S[s, w] rows
    valid = (j[None, None, :] < S_dev.T[:, :, None]).reshape(W, W * M_pad)
    sort_words = ([(~valid).to(torch.int64)]
                  + [wm_r[:, :, k].contiguous() for k in range(nwords)]
                  + [gi_r])
    perm = argsort_words(sort_words, [VALID_BITS] + [64] * (nwords + 1),
                         passes=mex.radix_passes)
    return take_rows_multi(payload_r, perm[:, :out_cap])


def Sort(dia: DIA, key_fn=None) -> DIA:
    return DIA(SortNode(dia.context, dia._link(), key_fn))
