"""Columnar spill records: the schema probe, the vectorized encode and
the ctypes binding of ``native/records.cpp`` (counterpart of the
reference package's ``data/records.py``).

* **Schema probe and vectorized columns.** Items built of Python
  scalars (int, bool, float, str, bytes), fixed-shape ndarrays and
  (nested) tuples of them map to the serializer's columnar kind
  (``data/serializer.py`` ``_COLS``): one numpy column a leaf, built by
  one vectorized call a field and batch. What the mapping cannot
  represent exactly returns None and the caller pickles: ints outside
  int64, mixed types at one position, numpy scalars, strings or bytes
  with a trailing NUL (numpy's U and S dtypes strip them), ragged
  arrays.
* **Native sort and gather** (``native/records.cpp``, built with g++ at
  first use by ``common/native_build.py`` ``load_host``):
  ``argsort_rows`` memcmp-sorts a run's fixed-width key rows and
  ``write_run_blocks`` gathers the position and payload columns straight
  into block buffers. ctypes releases the GIL for each call, so a spill
  job on the write-behind thread runs beside the main thread's next run.
  Without the compiler both fall back to numpy: the same bytes.
* **Degrade** (fault site ``data.records.encode``): an encode failure,
  injected or real, falls back to the pickle path and notes the
  recovery; decoding reads every kind whatever the settings.

``THRILL_TPU_NATIVE_RECORDS=0`` turns the columnar kind off:
``serialize_batch`` and the Sort's run spiller write pickle blocks.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from ..common import faults
from ..common.config import _env_flag
from ..common.iostats import IO as _IOSTATS

_F_ENCODE = faults.declare("data.records.encode")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def enabled() -> bool:
    """``THRILL_TPU_NATIVE_RECORDS=0`` writes pickle blocks and (offsets,
    blob) key chunks, the reference's pre-columnar bytes; columnar blocks
    already written still decode."""
    return _env_flag("THRILL_TPU_NATIVE_RECORDS", True)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        from ..common.native_build import load_host
        lib = load_host("records")
        if lib is not None:
            lib.rec_argsort.restype = ctypes.c_int32
            lib.rec_argsort.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p]
            lib.rec_gather.restype = ctypes.c_int64
            lib.rec_gather.argtypes = [
                ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p]
        _LIB = lib
        return _LIB


# ----------------------------------------------------------------------
# schema probe + vectorized column encode
# ----------------------------------------------------------------------

#: the exact Python scalar types a column leaf may hold (numpy scalars
#: are excluded: a round trip must give back the same types, and the
#: item unboxing of ``data/shards.py`` yields these)
_LEAF_TYPES = (bool, int, float, str, bytes)


def template_of(item: Any):
    """Serializer template of one sample item, or None (unsupported)."""
    t = type(item)
    if t in _LEAF_TYPES:
        return "x"
    if t is np.ndarray:
        # fixed-shape, fixed-dtype ndarray leaf: one ``("A", dstr,
        # shape)`` column of V rows. The probe pins the exact dtype.str
        # and shape; a batch member that deviates (ragged, upcast, 0-d,
        # empty, object dtype) makes the encoder return None and that
        # batch pickles.
        if (item.ndim >= 1 and item.size > 0
                and item.dtype.kind in "biufcSU"
                and item.dtype.itemsize > 0):
            return ("A", item.dtype.str, item.shape)
        return None
    if t is tuple and item:
        subs = tuple(template_of(e) for e in item)
        if any(s is None for s in subs):
            return None
        return ("T",) + subs
    return None


def _is_leaf(tmpl) -> bool:
    return tmpl in ("x", "s") or tmpl[0] == "A"


def _leaf_values(tmpl, items: List[Any], out: List[list]) -> None:
    """Transpose items into per-leaf value lists (template order)."""
    if _is_leaf(tmpl):
        out.append(items)
        return
    # every row must be a tuple of EXACTLY the probed arity (both
    # checks are single C-level passes): zip would silently truncate a
    # longer row — a wrong-data bug, not a fallback
    if set(map(type, items)) != {tuple} or \
            set(map(len, items)) != {len(tmpl) - 1}:
        raise TypeError("tuple shape deviates from the probed schema")
    for sub, vals in zip(tmpl[1:], zip(*items)):
        _leaf_values(sub, list(vals), out)


def _leaf_templates(tmpl, out: List[Any]) -> None:
    """Flatten a probe template into its leaves, in column order."""
    if _is_leaf(tmpl):
        out.append(tmpl)
        return
    for sub in tmpl[1:]:
        _leaf_templates(sub, out)


def _encode_leaf(vals: list
                 ) -> Optional[Tuple[str, np.ndarray]]:
    """One scalar column as ``(leaf_tag, array)``, or None when the
    values cannot ride a fixed dtype EXACTLY. Raises OverflowError on
    out-of-int64 ints (caller treats any raise as fallback too).

    ASCII str columns compact to S storage (tag ``"s"``, 1 byte/char
    on disk instead of UCS-4's four — spill volume is the out-of-core
    tier's real currency); non-ASCII strings keep the exact U column
    (tag ``"x"``)."""
    kinds = set(map(type, vals))
    if len(kinds) != 1:
        return None
    t = kinds.pop()
    n = len(vals)
    if t is bool:
        return "x", np.fromiter(vals, dtype=np.bool_, count=n)
    if t is int:
        # OverflowError on out-of-int64 values -> caller falls back
        return "x", np.fromiter(vals, dtype=np.int64, count=n)
    if t is float:
        return "x", np.fromiter(vals, dtype=np.float64, count=n)
    if t is str or t is bytes:
        arr = np.asarray(vals)
        if arr.dtype.kind not in ("U", "S") or arr.dtype.itemsize == 0:
            return None
        # numpy's U/S dtypes strip TRAILING NULs at unbox time; a value
        # whose true length disagrees with the stored length cannot
        # round-trip and must fall back (vectorized: one str_len pass
        # against the python lengths)
        lens = np.fromiter(map(len, vals), dtype=np.int64, count=n)
        if (np.char.str_len(arr) != lens).any():
            return None
        if t is str:
            try:
                return "s", arr.astype(
                    f"S{max(arr.dtype.itemsize // 4, 1)}")
            except (UnicodeEncodeError, UnicodeError):
                return "x", arr          # non-ASCII: exact U column
        return "x", arr
    return None


def _encode_array_leaf(vals: list, tmpl
                       ) -> Optional[Tuple[Any, np.ndarray]]:
    """One ndarray-leaf column: the (N, *shape) stack's bytes as a 1D
    ``|V{row_bytes}`` array (itemsize == one element's bytes), so the
    downstream byte machinery — run-block gather, slice arithmetic,
    native widths — treats it exactly like any other fixed-width
    column. None when any value deviates from the probed dtype/shape
    (ragged batches pickle, never lie)."""
    _, dstr, shape = tmpl
    shape = tuple(shape)
    for v in vals:
        if type(v) is not np.ndarray or v.dtype.str != dstr \
                or v.shape != shape:
            return None
    n = len(vals)
    stacked = np.ascontiguousarray(np.stack(vals))
    rb = stacked.dtype.itemsize * int(
        np.prod(shape, dtype=np.int64))
    col = stacked.reshape(n, -1).view(f"V{rb}").reshape(n)
    return tmpl, col


def _retag(tmpl, tags) -> Any:
    """Template with each leaf replaced by its encode-time tag
    (``tags`` iterates in leaf order; ndarray leaves tag as their full
    ``("A", ...)`` template)."""
    if _is_leaf(tmpl):
        return next(tags)
    return ("T",) + tuple(_retag(s, tags) for s in tmpl[1:])


def _encode_columns(tmpl, items: List[Any]
                    ) -> Optional[Tuple[Any, List[np.ndarray]]]:
    """(retagged_template, columns) or None. May raise (callers own
    the fallback)."""
    leaves: List[list] = []
    _leaf_values(tmpl, items, leaves)
    ltmpls: List[Any] = []
    _leaf_templates(tmpl, ltmpls)
    cols: List[np.ndarray] = []
    tags: List[Any] = []
    for lt, vals in zip(ltmpls, leaves):
        enc = _encode_array_leaf(vals, lt) if lt != "x" \
            else _encode_leaf(vals)
        if enc is None:
            return None
        tags.append(enc[0])
        cols.append(enc[1])
    return _retag(tmpl, iter(tags)), cols


def make_run_encoder(sample_item: Any) -> Optional[Callable]:
    """Payload encoder for the host Sort's run spiller, or None.

    ``encoder(batch) -> (template, list[np.ndarray]) | None``: the
    batch's payload columns plus the encode-time template (leaf tags
    like the ASCII-compact ``"s"`` are data-dependent), or None when
    this batch deviates from the probed schema. The CALLER requires
    one template per run (columns concatenate across batches) and
    falls back to the item-list path when batches disagree."""
    if not enabled():
        return None
    tmpl = template_of(sample_item)
    if tmpl is None:
        return None

    def encode(batch: List[Any]):
        try:
            return _encode_columns(tmpl, batch)
        except (TypeError, ValueError, OverflowError):
            return None

    # self-check on the sample (e.g. a trailing-NUL sample string)
    if encode([sample_item]) is None:
        return None
    return encode


def encode_batch_columns(items: List[Any]
                         ) -> Optional[Tuple[Any, List[np.ndarray]]]:
    """One-shot columnar encode for ``serialize_batch``: (template,
    columns) or None (the caller pickles). Never raises — the
    ``data.records.encode`` fault site degrades here too."""
    if not enabled():
        return None
    tmpl = template_of(items[0])
    if tmpl is None:
        return None
    try:
        if faults.REGISTRY.active():
            faults.check(_F_ENCODE, n=len(items))
        enc = _encode_columns(tmpl, items)
    except faults.InjectedFault as e:
        faults.note("recovery", what="records.encode_degraded",
                    error=repr(e)[:200])
        return None
    except (TypeError, ValueError, OverflowError):
        return None
    if enc is None:
        return None
    _IOSTATS.add(records_blocks=1)
    return enc


# ----------------------------------------------------------------------
# native sort + gather (numpy fallbacks: identical bytes, GIL held)
# ----------------------------------------------------------------------

def argsort_rows(arr: np.ndarray) -> np.ndarray:
    """Lexicographic argsort of an ``S{w}`` row array as int64. The
    native engine memcmp-sorts with the GIL released; the numpy
    fallback is order-identical (S comparison == padded memcmp: the
    \\0 pad is the minimum byte), so on/off results are bit-equal."""
    lib = _load() if enabled() else None
    if lib is None:
        return np.argsort(arr, kind="stable").astype(np.int64)
    arr = np.ascontiguousarray(arr)
    out = np.empty(len(arr), dtype=np.int64)
    rc = lib.rec_argsort(arr.ctypes.data_as(ctypes.c_void_p),
                         arr.dtype.itemsize, len(arr),
                         out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"rec_argsort failed rc={rc}")
    return out


def _gather_native(cols: List[np.ndarray], order: np.ndarray,
                   i0: int, i1: int, out_view: np.ndarray) -> None:
    """Gather rows order[i0:i1] of every column into ``out_view``
    (uint8, exactly the gathered bytes), natively when available."""
    lib = _load() if enabled() else None
    if lib is not None:
        ptrs = (ctypes.c_void_p * len(cols))(
            *[c.ctypes.data for c in cols])
        widths = np.array([c.dtype.itemsize for c in cols],
                          dtype=np.int64)
        n = lib.rec_gather(
            len(cols), ptrs, widths.ctypes.data_as(ctypes.c_void_p),
            order.ctypes.data_as(ctypes.c_void_p), i0, i1,
            out_view.ctypes.data_as(ctypes.c_void_p))
        if n != out_view.nbytes:
            raise RuntimeError(
                f"rec_gather wrote {n} of {out_view.nbytes} bytes")
        return
    # numpy fallback: same bytes, fancy-index per column
    idx = order[i0:i1]
    off = 0
    for c in cols:
        w = c.dtype.itemsize
        nb = (i1 - i0) * w
        out_view[off:off + nb] = c[idx].view(np.uint8)
        off += nb


def gather_rows(arr: np.ndarray, order: np.ndarray) -> np.ndarray:
    """``arr[order]`` for a fixed-width row array through the native
    gather (GIL-free) — the sorted key rows the merge's key file
    spills."""
    arr = np.ascontiguousarray(arr)
    order = np.ascontiguousarray(order, dtype=np.int64)
    out = np.empty(len(order) * arr.dtype.itemsize, dtype=np.uint8)
    _gather_native([arr], order, 0, len(order), out)
    return out.view(arr.dtype)


def write_run_blocks(file, order: np.ndarray, p0: int,
                     pay_cols: List[np.ndarray], item_tmpl,
                     block_items: int) -> int:
    """Write one sorted run's (pos, item) records into ``file`` as
    columnar blocks, gathered by ``order`` — ONE native call per block
    instead of per-item tuple+pickle work; the assembled buffer is
    handed to the block store whole (the native store's one copy). Runs
    on the write-behind thread; raises on any failure (the caller owns
    the degrade-to-pickle fallback). Returns rows written.

    The ``data.records.encode`` site fires here too, exercising the
    degrade contract on the REAL spill path."""
    from .block import Block
    from .serializer import columnar_header
    if faults.REGISTRY.active():
        faults.check(_F_ENCODE, rows=len(order))
    n = len(order)
    order = np.ascontiguousarray(order, dtype=np.int64)
    cols = [np.arange(p0, p0 + n, dtype=np.int64)] \
        + [np.ascontiguousarray(c) for c in pay_cols]
    tmpl = ("T", "x", item_tmpl)
    dstrs = [c.dtype.str for c in cols]
    row_bytes = sum(c.dtype.itemsize for c in cols)
    pool = file.pool
    nblocks = 0
    for i0 in range(0, n, block_items):
        i1 = min(i0 + block_items, n)
        head = columnar_header(tmpl, dstrs, i1 - i0)
        buf = np.empty(len(head) + (i1 - i0) * row_bytes,
                       dtype=np.uint8)
        buf[:len(head)] = np.frombuffer(head, dtype=np.uint8)
        _gather_native(cols, order, i0, i1, buf[len(head):])
        bid = pool.put(buf)
        file.blocks.append(Block(pool, bid, 0, i1 - i0))
        nblocks += 1
    # counted only once the WHOLE run wrote: a mid-run failure's
    # blocks are discarded by the caller's degrade path and must not
    # read as a surviving columnar spill
    _IOSTATS.add(records_blocks=nblocks)
    return n
