"""Sort-based segmented aggregation: the device reduce engine
(counterpart of the reference package's ``core/segmented.py``).

Equal keys are grouped by a stable sort into runs; each run is folded
into one item; one representative per run survives. Every function here
works on all W workers at once: key words and masks are ``[W, n]``,
tree leaves ``[W, n, ...]``, and runs never cross a worker's row.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from ..common import tree as pt
from .device_sort import argsort_words
from .rowmove import row_cumsum, scatter_slots, take_rows

VALID_BITS = 8   # the invalid word is 0 or 1: one radix digit


def sort_by_key_words(words: List[torch.Tensor], tree: Any,
                      valid: torch.Tensor):
    """Stable sort of (words, tree, valid) per worker with invalid items
    last. Returns (sorted_words, sorted_tree, sorted_valid)."""
    perm = argsort_words([(~valid).to(torch.int64)] + list(words),
                         [VALID_BITS] + [64] * len(words))
    return ([torch.gather(w, 1, perm) for w in words],
            pt.tree_map(lambda l: take_rows(l, perm), tree),
            torch.gather(valid, 1, perm))


def segment_boundaries(words: List[torch.Tensor],
                       valid: torch.Tensor) -> torch.Tensor:
    """starts[w, i] = True iff item i of worker w begins a new key run
    (valid items, key-sorted with invalid last)."""
    starts = torch.zeros_like(valid)
    starts[:, 0] = True
    for w in words:
        starts[:, 1:] |= w[:, 1:] != w[:, :-1]
    return starts & valid


def _rep_mask(starts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Representative = last item of each run (position before the next
    start), or the last valid item overall."""
    W, n = valid.shape
    next_start = torch.ones_like(starts)
    next_start[:, :-1] = starts[:, 1:]
    count = valid.sum(dim=1, keepdim=True)
    is_last_valid = torch.arange(n, device=valid.device)[None, :] == count - 1
    return valid & (next_start | is_last_valid)


def _bshape(flag: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Broadcast a ``[W, n]`` flag against a ``[W, n, ...]`` leaf."""
    return flag.reshape(flag.shape + (1,) * (leaf.dim() - 2))


def segmented_reduce(words: List[torch.Tensor], tree: Any,
                     valid: torch.Tensor, reduce_fn: Callable
                     ) -> Tuple[List[torch.Tensor], Any, torch.Tensor]:
    """Combine each equal-key run into one item with a black-box
    associative ``reduce_fn``.

    A segmented inclusive scan in ceil(log2(n)) Hillis-Steele rounds:
    round d combines every item with the one d places before it unless a
    run starts in between. ``reduce_fn`` sees two item trees whose
    leaves lead with one item axis over all workers' rows. Returns
    (words, tree, rep_mask); the representative holds its run's fold.
    """
    starts = segment_boundaries(words, valid)
    W, n = valid.shape
    leaves, td = pt.flatten(tree)
    flag = starts
    d = 1
    while d < n:
        m = n - d

        def items(ls, lo):
            return pt.unflatten(td, [l[:, lo:lo + m].reshape(
                (W * m,) + tuple(l.shape[2:])) for l in ls])

        merged = pt.leaves(reduce_fn(items(leaves, 0), items(leaves, d)))
        if len(merged) != len(leaves):
            raise ValueError("reduce_fn returned a different item structure")
        keep_b = flag[:, d:]
        new = []
        for l, mg in zip(leaves, merged):
            mg = torch.as_tensor(mg, device=l.device).to(l.dtype).expand(
                (W * m,) + tuple(l.shape[2:])).reshape(
                (W, m) + tuple(l.shape[2:]))
            tail = torch.where(_bshape(keep_b, l), l[:, d:], mg)
            new.append(torch.cat([l[:, :d], tail], dim=1))
        leaves = new
        flag = torch.cat([flag[:, :d], flag[:, :m] | flag[:, d:]], dim=1)
        d *= 2
    return words, pt.unflatten(td, leaves), _rep_mask(starts, valid)


def reduce_runs(words, tree, valid, reduce_fn, specs):
    """One dispatch point for every device reduce: the field engine when
    ``specs`` (from FieldReduce, gated by :func:`fields_specializable`)
    is given, else the generic scan. Same (words, tree, rep) contract."""
    if specs is not None:
        return segmented_reduce_fields(words, tree, valid, specs)
    return segmented_reduce(words, tree, valid, reduce_fn)


def fields_specializable(flat_specs, leaf_dtypes) -> bool:
    """Can :func:`segmented_reduce_fields` handle this FieldReduce spec?
    "first" takes any non-complex dtype; "sum" needs integer or floating
    (not bool); "min"/"max" need integers, so float NaN order stays with
    the generic scan, as in the reference."""
    for s, dt in zip(flat_specs, leaf_dtypes):
        if s == "first":
            if dt.is_complex:
                return False
        elif s == "sum":
            if dt == torch.bool or dt.is_complex:
                return False
        elif s in ("min", "max"):
            if dt == torch.bool or dt.is_floating_point or dt.is_complex:
                return False
        else:
            return False
    return True


def segmented_reduce_fields(words: List[torch.Tensor], tree: Any,
                            valid: torch.Tensor, flat_specs
                            ) -> Tuple[List[torch.Tensor], Any,
                                       torch.Tensor]:
    """FieldReduce engine with the contract of :func:`segmented_reduce`:
    each field folds with one segment reduction plus one gather.

    "first" gathers each run's start row (the same bits as the
    reference's masked integer segment sum). "sum" adds into a +0.0
    base, so a float run whose true sum is -0.0 comes back +0.0, as in
    the reference; float sums on a card add in atomic order.
    """
    W, n = valid.shape
    dev = valid.device
    starts = segment_boundaries(words, valid)
    seg = (row_cumsum(starts) - 1).clamp(0, n - 1)
    region = 2 * n
    # invalid rows scatter to dump rows, never into a run
    flat_seg = scatter_slots(seg, valid, n)
    leaves, td = pt.flatten(tree)
    run_start = None
    out = []
    for s, leaf in zip(flat_specs, leaves):
        trail = tuple(leaf.shape[2:])
        if s == "first":
            if run_start is None:
                # each run's start row, scattered to its run id, then read
                # back per row
                at = torch.zeros(W * region, dtype=torch.int64, device=dev)
                at.index_put_((scatter_slots(seg, starts, n),),
                              torch.arange(n, device=dev).repeat(W))
                run_start = torch.gather(at.reshape(W, region), 1, seg)
            out.append(take_rows(leaf, run_start))
            continue
        src = leaf.reshape((W * n,) + trail)
        if s == "sum":
            res = torch.zeros((W * region,) + trail, dtype=leaf.dtype,
                              device=dev).index_add_(0, flat_seg, src)
        else:
            info = torch.iinfo(leaf.dtype)
            idx = flat_seg.reshape((W * n,) + (1,) * len(trail)).expand(
                src.shape)
            res = torch.full((W * region,) + trail,
                             info.max if s == "min" else info.min,
                             dtype=leaf.dtype, device=dev).scatter_reduce_(
                0, idx, src, "amin" if s == "min" else "amax")
        out.append(take_rows(res.reshape((W, region) + trail), seg))
    return words, pt.unflatten(td, out), _rep_mask(starts, valid)
