"""The native CPU engine of the local sort, reduce and group phases
(counterpart of the reference package's ``core/host_radix.py``).

On a mesh whose device is the CPU the shards are host memory, so the
local phases can take the engines the reference uses for its in-RAM run
sorts (Thrill: ``sort_algorithm_`` = std::sort / tlx radix variants,
``api/sort.hpp``; the probing tables of ``core/reduce_pre_phase.hpp:94``):
``native/hostsort.cpp``'s stable LSD radix argsort over the key words, a
row gather for the payload permutation, and an open-addressing grouping
table. ``hostsort.cpp`` is built with g++ at first use
(``common/native_build.py`` ``load_host``). On the card the device
engines run: :func:`eligible` is False there, so no card path changes.

The wrappers take CPU tensors or numpy arrays and read them without a
copy (``tensor.numpy()``); they return numpy arrays. Key words are the
port's int64 words holding the reference's uint64 bits
(``core/keys.py``): the engine reads their ``view(np.uint64)``, not
:func:`keys.order_view`'s sign-flipped form.

Stability makes the global-index tie-break implicit: equal keys keep
their input order, which at W == 1 is global-index order.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


class NativeEngineError(RuntimeError):
    """A native engine call itself failed (a bad return code, a plan of
    the wrong size). It means the engine is broken, not inapplicable: a
    caller never takes this for a reason to run another engine."""


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        from ..common.native_build import load_host
        lib = load_host("hostsort")
        if lib is not None:
            vp, pvp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
            i32, i64 = ctypes.c_int32, ctypes.c_int64
            lib.radix_argsort_u64.restype = ctypes.c_int
            lib.radix_argsort_u64.argtypes = [i64, i32, pvp, vp]
            lib.gather_rows_u8.restype = None
            lib.gather_rows_u8.argtypes = [i64, i64, vp, vp, vp]
            lib.scatter_rows_u8.restype = None
            lib.scatter_rows_u8.argtypes = [i64, i64, vp, vp, vp]
            lib.hash_group_u64.restype = i64
            lib.hash_group_u64.argtypes = [i64, i32, pvp, vp, vp]
            lib.fold_plan_u32.restype = i64
            lib.fold_plan_u32.argtypes = [i64, vp, vp, vp]
            lib.hash_group_acc_u64.restype = i64
            lib.hash_group_acc_u64.argtypes = [i64, i32, pvp, i32, vp, pvp,
                                               pvp, vp]
        _LIB = lib
        return _LIB


def available() -> bool:
    """``THRILL_TPU_HOST_RADIX`` is not ``0`` (default ``1``) and the
    library loads."""
    if os.environ.get("THRILL_TPU_HOST_RADIX", "1") == "0":
        return False
    return _load() is not None


def eligible(mex) -> bool:
    """The gate of the native fast paths (Sort at W == 1, ReduceByKey,
    ReduceToIndex, GroupByKey; reference: ``core/host_radix.py:82-92``):
    the mesh's device is the CPU, so its shards are host memory, it runs
    one process, and the library has loaded."""
    return (mex.device.type == "cpu"
            and getattr(mex, "num_processes", 1) <= 1
            and available())


def _host(a) -> np.ndarray:
    """A CPU tensor or numpy array as numpy, without a copy."""
    if isinstance(a, torch.Tensor):
        return a.detach().numpy()
    return np.asarray(a)


def _word_cols(words: Sequence) -> List[np.ndarray]:
    """Key words (int64 words with uint64 bits, or uint64) as contiguous
    uint64 columns."""
    cols = []
    for w in words:
        a = _host(w)
        if a.dtype == np.int64:
            a = a.view(np.uint64)
        cols.append(np.ascontiguousarray(a, dtype=np.uint64))
    return cols


def _ptrs(arrs: Sequence[np.ndarray]):
    """A ``void*`` array of the arrays' data (one null slot when empty)."""
    vals = [a.ctypes.data for a in arrs] or [0]
    arr = (ctypes.c_void_p * len(vals))(*vals)
    return ctypes.cast(arr, ctypes.POINTER(ctypes.c_void_p))


def _vp(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def sorted_runs(words: Sequence):
    """Stable radix argsort and equal-key run detection: ``(perm,
    same_next)``, ``same_next[i]`` True iff sorted rows i and i+1 share
    every key word."""
    cols = _word_cols(words)
    perm = radix_argsort(cols)
    n = int(perm.shape[0])
    same_next = np.ones(max(n - 1, 0), dtype=bool)
    for kw in cols:
        kws = kw[perm]
        same_next &= kws[1:] == kws[:-1]
    return perm, same_next


def radix_argsort(words: Sequence) -> np.ndarray:
    """Stable argsort by lexicographic unsigned words (``words[0]`` most
    significant): the uint32 permutation, sorted -> original."""
    lib = _load()
    assert lib is not None
    cols = _word_cols(words)
    n = int(cols[0].shape[0])
    perm = np.empty(n, dtype=np.uint32)
    rc = lib.radix_argsort_u64(n, len(cols), _ptrs(cols), _vp(perm))
    if rc < 0:
        raise NativeEngineError(f"radix_argsort_u64 failed (rc={rc}, n={n})")
    return perm


def hash_group(words: Sequence):
    """Group rows by exact key-word equality through the native
    open-addressing table: ``(perm, lens)``, ``perm`` (uint32) the rows
    group by group in first-appearance order, stable within a group,
    ``lens`` (uint32) the rows of each group. The group order is not
    key-sorted: ReduceByKey and GroupByKey only need equal keys
    adjacent."""
    lib = _load()
    assert lib is not None
    cols = _word_cols(words)
    n = int(cols[0].shape[0])
    perm = np.empty(n, dtype=np.uint32)
    lens = np.empty(max(n, 1), dtype=np.uint32)
    ng = lib.hash_group_u64(n, len(cols), _ptrs(cols), _vp(perm), _vp(lens))
    if ng < 0:
        raise NativeEngineError(f"hash_group_u64 failed (rc={ng}, n={n})")
    return perm, lens[:ng].copy()


def hash_group_acc(words: Sequence, cols: Sequence, ops: Sequence[int]):
    """Grouping and per-column accumulation in one native pass (the
    FieldReduce path, ``api/functors.py`` ``acc_plan``): ``cols`` are
    1-D columns of 8-byte items, ``ops`` their ``hash_group_acc_u64``
    opcodes. Returns ``(heads, accs)``: ``heads`` (uint32) the original
    row of each group's first row, ``accs[c]`` column c's accumulated
    values, in the same first-appearance group order."""
    lib = _load()
    assert lib is not None
    kcols = _word_cols(words)
    n = int(kcols[0].shape[0])
    vcols = [np.ascontiguousarray(_host(c)) for c in cols]
    for c in vcols:
        if c.ndim != 1 or c.dtype.itemsize != 8:
            # the native pass reads and writes fixed 8-byte strides
            raise ValueError(
                f"hash_group_acc: columns must be 1-D 8-byte scalars, "
                f"got ndim={c.ndim} dtype={c.dtype}")
    ops_arr = np.ascontiguousarray(ops, dtype=np.int32)
    accs = [np.empty(max(n, 1), dtype=c.dtype) for c in vcols]
    heads = np.empty(max(n, 1), dtype=np.uint32)
    ng = lib.hash_group_acc_u64(
        n, len(kcols), _ptrs(kcols), len(vcols), _vp(ops_arr),
        _ptrs(vcols), _ptrs(accs), _vp(heads))
    if ng < 0:
        raise NativeEngineError(
            f"hash_group_acc_u64 failed (rc={ng}, n={n})")
    return heads[:ng].copy(), [a[:ng].copy() for a in accs]


def fold_plan(lens):
    """The strided run fold's plan: ``(ri, level_counts)``, ``ri``
    (uint32) the absorbed right-operand rows level by level (level l:
    in-run position p with ``p & -p == 1 << l``, ascending within a
    level), ``level_counts`` (int64[32]) each level's rows;
    ``sum(level_counts) == sum(lens) - len(lens)``."""
    lib = _load()
    assert lib is not None
    lens_c = np.ascontiguousarray(_host(lens), dtype=np.uint32)
    total = int(lens_c.sum(dtype=np.int64)) - len(lens_c)
    ri = np.empty(max(total, 1), dtype=np.uint32)
    level_counts = np.empty(32, dtype=np.int64)
    got = lib.fold_plan_u32(len(lens_c), _vp(lens_c), _vp(ri),
                            _vp(level_counts))
    if got != total:
        raise NativeEngineError(
            f"fold_plan_u32 size mismatch (got={got}, expected={total})")
    return ri[:total], level_counts


def scatter_rows(dst, idx, src) -> None:
    """``dst[idx[r]] = src[r]`` along axis 0, in place: native when both
    sides are C-contiguous of one dtype and shape, numpy's fancy
    assignment otherwise (broadcasts, casts)."""
    dst, idx, src = _host(dst), _host(idx), _host(src)
    lib = _load()
    n = int(idx.shape[0])
    if (lib is None or not dst.flags.c_contiguous
            or not src.flags.c_contiguous or dst.dtype != src.dtype
            or src.shape != (n,) + dst.shape[1:]):
        dst[idx] = src
        return
    row_bytes = int(dst.dtype.itemsize
                    * int(np.prod(dst.shape[1:], dtype=np.int64)))
    if n == 0 or row_bytes == 0:
        return
    idx_c = np.ascontiguousarray(idx, dtype=np.uint32)
    lib.scatter_rows_u8(n, row_bytes, _vp(src), _vp(idx_c), _vp(dst))


def gather_rows(arr, perm) -> np.ndarray:
    """``arr[perm]`` along axis 0 through the native row gather (numpy's
    take for a non-contiguous input)."""
    arr, perm = _host(arr), _host(perm)
    lib = _load()
    if lib is None or not arr.flags.c_contiguous:
        return np.take(arr, perm, axis=0)
    n = int(perm.shape[0])
    row_bytes = int(arr.dtype.itemsize
                    * int(np.prod(arr.shape[1:], dtype=np.int64)))
    if row_bytes == 0 or n == 0:
        return np.take(arr, perm, axis=0)
    out = np.empty((n,) + arr.shape[1:], dtype=arr.dtype)
    perm_c = np.ascontiguousarray(perm, dtype=np.uint32)
    lib.gather_rows_u8(n, row_bytes, _vp(arr), _vp(perm_c), _vp(out))
    return out
