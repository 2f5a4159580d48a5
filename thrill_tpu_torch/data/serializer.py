"""Item serialization for the host data plane (counterpart of the
reference package's ``data/serializer.py``; Thrill:
thrill/data/serialization.hpp). One block payload is

    [u32 hlen][hlen pickled header][payload]

* ``_RAW``    header ``(0, dtype_str, shape)``: the payload is one
  contiguous array, a stack of same-shape ndarray items;
* ``_PICKLE`` header ``(1, None, n)``: the payload pickles the item list.

``serialize_batch`` writes the bytes the reference writes with its
columnar records off (``THRILL_TPU_NATIVE_RECORDS=0``). Its third kind
(``_COLS``) and the per-leaf codec of checkpoints are not ported.
"""

from __future__ import annotations

import pickle
import struct
from typing import Any, Iterator, List

import numpy as np

_RAW = 0
_PICKLE = 1


def serialize_batch(items: List[Any]) -> bytes:
    """One block payload of ``items``: fixed-shape ndarrays of one dtype
    as raw bytes, anything else pickled."""
    if items and all(isinstance(it, np.ndarray) for it in items) and \
            len({(it.dtype.str, it.shape) for it in items}) == 1:
        arr = np.stack(items)
        header = pickle.dumps((_RAW, arr.dtype.str, arr.shape))
        return struct.pack("<I", len(header)) + header + \
            np.ascontiguousarray(arr).tobytes()
    header = pickle.dumps((_PICKLE, None, len(items)))
    return struct.pack("<I", len(header)) + header + pickle.dumps(items)


def _parse_header(data: bytes):
    (hlen,) = struct.unpack_from("<I", data, 0)
    kind, meta, n = pickle.loads(data[4:4 + hlen])
    if kind not in (_RAW, _PICKLE):
        raise ValueError(f"block payload of kind {kind} is not readable "
                         f"here (only raw and pickled batches)")
    return kind, meta, n, 4 + hlen


def deserialize_batch(data: bytes) -> List[Any]:
    kind, meta, shape_or_n, base = _parse_header(data)
    if kind == _RAW:
        return list(np.frombuffer(data[base:], dtype=np.dtype(meta))
                    .reshape(shape_or_n))
    return pickle.loads(data[base:])


def deserialize_slice(data: bytes, lo: int, hi: int) -> List[Any]:
    """Items ``[lo, hi)`` of a payload: raw batches decode only those
    rows (Thrill re-slices fixed-size items without deserializing,
    thrill/data/stream.hpp:77-210); pickled ones decode the batch."""
    kind, meta, shape_or_n, base = _parse_header(data)
    if kind == _RAW:
        dt = np.dtype(meta)
        row_shape = tuple(shape_or_n[1:])
        row_items = int(np.prod(row_shape, dtype=np.int64))
        arr = np.frombuffer(data, dtype=dt, count=(hi - lo) * row_items,
                            offset=base + lo * row_items * dt.itemsize)
        return list(arr.reshape((hi - lo,) + row_shape))
    return pickle.loads(data[base:])[lo:hi]


def deserialize_iter(data: bytes, lo: int, hi: int) -> Iterator[Any]:
    """Items ``[lo, hi)`` as an iterator that decodes at the first
    pull."""
    if hi > lo:
        yield from deserialize_slice(data, lo, hi)
