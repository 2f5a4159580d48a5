"""Item serialization for the host data plane (counterpart of the
reference package's ``data/serializer.py``; Thrill:
thrill/data/serialization.hpp). One block payload is

    [u32 hlen][hlen pickled header][payload]

* ``_RAW``    header ``(0, dtype_str, shape)``: the payload is one
  contiguous array, a stack of same-shape ndarray items;
* ``_PICKLE`` header ``(1, None, n)``: the payload pickles the item list;
* ``_COLS``   header ``(2, (template, dtype_strs), nrows)``: the payload
  is one fixed-dtype column per leaf of the template, one after another.
  Items built of Python scalars and (nested) tuples of them encode so
  (``data/records.py`` probes the schema and builds the columns), decode
  by ``np.frombuffer`` views with no pickle, and slice by byte
  arithmetic like ``_RAW``. What cannot round-trip exactly (mixed
  types, ints outside int64, strings with a trailing NUL, ragged arrays)
  is pickled; ``THRILL_TPU_NATIVE_RECORDS=0`` pickles everything, the
  bytes of the reference's pre-columnar encode. Decoding reads all
  three kinds either way.

The template grammar: ``"x"`` is one scalar leaf and column (unboxed by
``tolist``: int64 -> int, bool -> bool, float64 -> float, U -> str, S ->
bytes); ``"s"`` is an ASCII str leaf stored as an S column (1 byte a
character) and cast back to str; ``("T", sub, ...)`` a tuple;
``("A", dstr, shape)`` a fixed-shape ndarray leaf stored as one column
of ``|V{row_bytes}`` rows. The per-leaf codec of checkpoints
(``serialize_leaves``) waits for them.
"""

from __future__ import annotations

import pickle
import struct
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np

_RAW = 0       # np.ndarray with given dtype/shape
_PICKLE = 1
_COLS = 2      # fixed-dtype scalar columns (native records)


def serialize_batch(items: List[Any]) -> bytes:
    """Serialize a list of items into one block payload."""
    if items and all(isinstance(it, np.ndarray) for it in items) and \
            len({(it.dtype.str, it.shape) for it in items}) == 1:
        arr = np.stack(items)
        header = pickle.dumps((_RAW, arr.dtype.str, arr.shape))
        return struct.pack("<I", len(header)) + header + \
            np.ascontiguousarray(arr).tobytes()
    if items:
        # the columnar kind (off with THRILL_TPU_NATIVE_RECORDS=0; None
        # for anything it cannot represent exactly)
        from . import records
        enc = records.encode_batch_columns(items)
        if enc is not None:
            return serialize_columns(enc[0], enc[1])
    header = pickle.dumps((_PICKLE, None, len(items)))
    return struct.pack("<I", len(header)) + header + pickle.dumps(items)


# ----------------------------------------------------------------------
# the columnar container kind
# ----------------------------------------------------------------------

def leaf_count(tmpl) -> int:
    """Columns a template consumes (one per scalar or ndarray leaf)."""
    if tmpl in ("x", "s") or tmpl[0] == "A":
        return 1
    return sum(leaf_count(s) for s in tmpl[1:])


def columnar_header(tmpl, dstrs: Sequence[str], nrows: int) -> bytes:
    """Length-prefixed header of a columnar block (the caller appends
    exactly ``nrows`` rows of each column, in order)."""
    header = pickle.dumps((_COLS, (tmpl, tuple(dstrs)), nrows))
    return struct.pack("<I", len(header)) + header


def serialize_columns(tmpl, cols: List[np.ndarray]) -> bytes:
    """Pack template + columns into one block payload (the Host Sort's
    run spiller writes the same layout through the native gather,
    ``data/records.py``)."""
    nrows = len(cols[0]) if cols else 0
    head = columnar_header(tmpl, [c.dtype.str for c in cols], nrows)
    return head + b"".join(
        np.ascontiguousarray(c).tobytes() for c in cols)


def _cols_views(data: bytes, dstrs, nrows: int, base: int, lo: int,
                hi: int, take: Optional[Sequence[int]] = None
                ) -> List[np.ndarray]:
    """Zero-copy views of rows [lo, hi) of each column (or only the
    column indices in ``take``)."""
    out = []
    off = base
    for c, dstr in enumerate(dstrs):
        isz = np.dtype(dstr).itemsize
        if take is None or c in take:
            out.append(np.frombuffer(data, dtype=np.dtype(dstr),
                                     count=hi - lo,
                                     offset=off + lo * isz))
        off += nrows * isz
    return out


def _build_items(tmpl, cols: List[np.ndarray]) -> List[Any]:
    """Rebuild the item list from sliced column views: one ``tolist``
    per column (C-speed unboxing), tuples assembled by ``zip``."""
    it = iter(cols)

    def build(t):
        if t == "x":
            return next(it).tolist()
        if t == "s":   # ASCII-compacted str: one vectorized S->U cast
            col = next(it)
            return col.astype(f"U{col.dtype.itemsize}").tolist()
        if t[0] == "A":
            # ndarray leaf: the V rows view back to the element dtype
            # (one zero-copy reinterpret + reshape for the whole
            # column); like _RAW, items are read-only views into the
            # block's buffer
            _, dstr, shape = t
            col = next(it)
            arr = col.view(np.dtype(dstr)).reshape(
                (len(col),) + tuple(shape))
            return list(arr)
        parts = [build(s) for s in t[1:]]
        return list(zip(*parts))

    return build(tmpl)


def _sub_template(tmpl, project: int):
    """(sub_template, column_indices) of tuple element ``project``."""
    assert tmpl not in ("x", "s") and tmpl[0] == "T" \
        and len(tmpl) > project + 1, (tmpl, project)
    skip = sum(leaf_count(s) for s in tmpl[1:1 + project])
    sub = tmpl[1 + project]
    return sub, range(skip, skip + leaf_count(sub))


def _parse_header(data: bytes):
    (hlen,) = struct.unpack_from("<I", data, 0)
    kind, meta, n = pickle.loads(data[4:4 + hlen])
    if kind not in (_RAW, _PICKLE, _COLS):
        raise ValueError(f"block payload of kind {kind} is not readable "
                         f"here (only raw, pickled and columnar batches)")
    return kind, meta, n, 4 + hlen


def deserialize_batch(data: bytes) -> List[Any]:
    kind, meta, shape_or_n, base = _parse_header(data)
    payload = data[base:]
    if kind == _RAW:
        arr = np.frombuffer(payload, dtype=np.dtype(meta)).reshape(
            shape_or_n)
        return list(arr)
    if kind == _COLS:
        tmpl, dstrs = meta
        return _build_items(tmpl, _cols_views(data, dstrs, shape_or_n,
                                              base, 0, shape_or_n))
    return pickle.loads(payload)


def deserialize_slice(data: bytes, lo: int, hi: int) -> List[Any]:
    """Items ``[lo, hi)`` of a payload: raw and columnar batches decode
    only those rows (Thrill re-slices fixed-size items without
    deserializing, thrill/data/stream.hpp:77-210); pickled ones decode
    the batch."""
    kind, meta, shape_or_n, base = _parse_header(data)
    if kind == _RAW:
        dt = np.dtype(meta)
        row_shape = tuple(shape_or_n[1:])
        row_bytes = dt.itemsize * int(np.prod(row_shape, dtype=np.int64))
        arr = np.frombuffer(data, dtype=dt, count=(hi - lo) *
                            (row_bytes // dt.itemsize),
                            offset=base + lo * row_bytes)
        return list(arr.reshape((hi - lo,) + row_shape))
    if kind == _COLS:
        tmpl, dstrs = meta
        return _build_items(tmpl, _cols_views(data, dstrs, shape_or_n,
                                              base, lo, hi))
    return pickle.loads(data[base:])[lo:hi]


def deserialize_iter(data: bytes, lo: int, hi: int,
                     project: Optional[int] = None) -> Iterator[Any]:
    """Items ``[lo, hi)`` as an iterator that decodes at the first pull.
    ``project`` yields only tuple element ``project`` of each item; a
    columnar block then decodes only that element's columns (the Sort's
    merge reads the item half of its (position, item) records). Other
    kinds decode the batch."""
    if hi <= lo:
        return
    kind, meta, shape_or_n, base = _parse_header(data)
    if kind == _COLS:
        tmpl, dstrs = meta
        take = None
        if project is not None:
            tmpl, take = _sub_template(tmpl, project)
        views = _cols_views(data, dstrs, shape_or_n, base, lo, hi, take)
        yield from _build_items(tmpl, views)
        return
    items = deserialize_slice(data, lo, hi)
    if project is None:
        yield from items
    else:
        for t in items:
            yield t[project]
