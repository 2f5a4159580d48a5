"""Native k-way merge of spilled runs over byte-encoded keys
(counterpart of the reference package's ``core/native_merge.py``).

The ctypes binding of ``native/mwmerge.cpp``, built with g++ at first use
(``common/native_build.py`` ``load_host``). A run is a pair of Files in
the block store: an item File of the run's (position, item) records in
key order, and a key File of the matching order-encoded keys
(``core/order_key.py``) in chunks. The engine takes key chunks and emits
the merged order as run indices; items never leave Python, and one key
chunk a run is resident, so the merge stays external-memory (Thrill:
the partial multiway merge, thrill/api/sort.hpp:229-260,
core/multiway_merge.hpp:132).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..data.file import File
from .multiway_merge import MAX_MERGE_DEGREE

#: keys per spilled chunk item (a few hundred KB of key bytes for
#: typical keys — one chunk per run resident during the merge)
KEY_CHUNK = 8192

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        from ..common.native_build import load_host
        lib = load_host("mwmerge")
        if lib is not None:
            lib.mwm_create.restype = ctypes.c_void_p
            lib.mwm_create.argtypes = [ctypes.c_int32]
            lib.mwm_destroy.restype = None
            lib.mwm_destroy.argtypes = [ctypes.c_void_p]
            lib.mwm_done.restype = ctypes.c_int32
            lib.mwm_done.argtypes = [ctypes.c_void_p]
            lib.mwm_set_chunk.restype = ctypes.c_int32
            lib.mwm_set_chunk.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
            lib.mwm_next.restype = ctypes.c_int64
            lib.mwm_next.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64]
        _LIB = lib
        return _LIB


def available() -> bool:
    """Is the native merge engine built and loaded?"""
    return _load() is not None


def write_key_chunks(keys_file: File, key_bytes: List[bytes]) -> None:
    """Spill a sorted run's key bytes as (offsets, blob) chunk items."""
    with keys_file.writer() as w:
        for i in range(0, len(key_bytes), KEY_CHUNK):
            chunk = key_bytes[i:i + KEY_CHUNK]
            offs = np.zeros(len(chunk) + 1, dtype=np.int64)
            np.cumsum([len(b) for b in chunk], out=offs[1:])
            w.put((offs, b"".join(chunk)))


def write_key_chunks_fixed(keys_file: File, arr: np.ndarray) -> None:
    """Fixed-width variant of :func:`write_key_chunks`: ``arr`` is a
    key-sorted ``S{w}`` array; offsets are an arange and the blob is one
    copy of its memory, with no per-key Python object.

    With the records on, each chunk spills as one raw ndarray item (the
    serializer's raw kind: a header and a copy, no pickle) and the merge
    reads the decoded array in place. ``THRILL_TPU_NATIVE_RECORDS=0``
    writes pickled ``(offs, blob)`` chunk items instead."""
    from ..data import records
    w_ = arr.dtype.itemsize
    raw = records.enabled()
    with keys_file.writer() as wtr:
        for i in range(0, len(arr), KEY_CHUNK):
            chunk = arr[i:i + KEY_CHUNK]
            if raw:
                wtr.put(np.ascontiguousarray(chunk))
                wtr.flush()        # one RAW block per chunk item
            else:
                offs = np.arange(len(chunk) + 1, dtype=np.int64) * w_
                wtr.put((offs, chunk.tobytes()))


class _RunFeed:
    """One run's key-chunk stream; owns the live buffers the native
    engine points into (they must outlive the chunk's consumption)."""

    def __init__(self, reader) -> None:
        self.reader = reader
        self.offs: Optional[np.ndarray] = None
        self.blob: Optional[bytes] = None

    def feed(self, lib, handle, r: int) -> None:
        nxt = next(self.reader, None)
        if nxt is None:
            self.offs = np.zeros(1, dtype=np.int64)
            self.blob = b""
            rc = lib.mwm_set_chunk(
                handle, r, 0, self.offs.ctypes.data_as(ctypes.c_void_p),
                None, 1)
        elif isinstance(nxt, np.ndarray):
            # raw fixed-width chunk (write_key_chunks_fixed, native
            # records): synthesize arange offsets and point the engine
            # straight into the decoded array — no per-chunk bytes copy
            w = nxt.dtype.itemsize
            arr = np.ascontiguousarray(nxt)
            self.offs = np.arange(len(arr) + 1, dtype=np.int64) * w
            self.blob = arr               # owns the live buffer
            rc = lib.mwm_set_chunk(
                handle, r, len(arr),
                self.offs.ctypes.data_as(ctypes.c_void_p),
                arr.ctypes.data_as(ctypes.c_void_p), 0)
        else:
            offs, blob = nxt
            self.offs = np.ascontiguousarray(offs, dtype=np.int64)
            self.blob = bytes(blob)
            rc = lib.mwm_set_chunk(
                handle, r, len(self.offs) - 1,
                self.offs.ctypes.data_as(ctypes.c_void_p),
                ctypes.cast(ctypes.c_char_p(self.blob), ctypes.c_void_p),
                0)
        if rc != 0:
            raise RuntimeError(f"mwm_set_chunk failed for run {r}")


def _merge_group(item_files: List[File], key_files: List[File],
                 consume: bool,
                 submit=None) -> Iterator[Tuple[bytes, object]]:
    """Stream the native merge of one group: yields (key_bytes, item)
    in merged order. ``submit`` (readahead executor, data/writeback.py)
    gives each run's key/item streams one block of readahead."""
    lib = _load()
    assert lib is not None
    k = len(item_files)
    handle = lib.mwm_create(k)
    if not handle:
        raise RuntimeError("mwm_create failed")
    out_cap = 8192
    out_runs = np.empty(out_cap, dtype=np.uint32)
    out_offs = np.empty(out_cap + 1, dtype=np.int64)
    blob_cap = 1 << 20
    need = ctypes.c_int32(-1)
    try:
        feeds = [_RunFeed(kf.prefetch_reader(consume=consume,
                                             submit=submit))
                 for kf in key_files]
        item_readers = [f.prefetch_reader(consume=consume, submit=submit)
                        for f in item_files]
        for r, feed in enumerate(feeds):
            feed.feed(lib, handle, r)
        out_blob = ctypes.create_string_buffer(blob_cap)
        while True:
            cnt = lib.mwm_next(
                handle, out_runs.ctypes.data_as(ctypes.c_void_p),
                out_cap, ctypes.byref(need),
                out_offs.ctypes.data_as(ctypes.c_void_p),
                out_blob, blob_cap)
            if cnt < 0:
                raise RuntimeError("mwm_next failed")
            if cnt:
                # copy only the used prefix (blob_cap can be MBs after
                # a growth; .raw would copy all of it every round)
                blob = ctypes.string_at(out_blob, int(out_offs[cnt]))
                offs = out_offs
                runs = out_runs
                for i in range(cnt):
                    kb = blob[offs[i]:offs[i + 1]]
                    yield kb, next(item_readers[runs[i]])
            if need.value >= 0:
                feeds[need.value].feed(lib, handle, need.value)
                continue
            if lib.mwm_done(handle):
                return
            if cnt == 0:
                # next key alone exceeds the blob buffer: grow it
                blob_cap *= 4
                out_blob = ctypes.create_string_buffer(blob_cap)
    finally:
        lib.mwm_destroy(handle)


def _resolve_degree(max_merge_degree: int) -> int:
    return max(max_merge_degree or MAX_MERGE_DEGREE, 2)


def _reduce_degree(pairs: List[Tuple[File, File]], max_merge_degree: int,
                   consume: bool, made: List[File],
                   submit=None) -> List[Tuple[File, File]]:
    """Partially merge the smallest (item, key) file pairs into
    intermediate pairs until at most ``max_merge_degree`` remain
    (reference: the partial multiway merge bound, api/sort.hpp:229-260).
    Intermediates are appended to ``made`` (caller clears them);
    ``consume=False`` reads input runs with keep semantics so the
    caller's Files survive."""
    while len(pairs) > max_merge_degree:
        pairs.sort(key=lambda p: p[0].num_items)
        group, pairs = pairs[:max_merge_degree], pairs[max_merge_degree:]
        pool = group[0][0].pool
        mi, mk = File(pool=pool), File(pool=pool)
        kb_buf: List[bytes] = []
        with mi.writer() as wi, mk.writer() as wk:
            for kb, item in _merge_group(
                    [p[0] for p in group], [p[1] for p in group],
                    consume=consume, submit=submit):
                wi.put(item)
                kb_buf.append(kb)
                if len(kb_buf) >= KEY_CHUNK:
                    _put_chunk(wk, kb_buf)
                    kb_buf = []
            if kb_buf:
                _put_chunk(wk, kb_buf)
        if consume:
            for fi, fk in group:
                fi.clear()
                fk.clear()
        made.extend([mi, mk])
        # intermediates are always consumable (they are ours)
        pairs.append((mi, mk))
    return pairs


def merge_partitioned(item_files: List[File], key_files: List[File],
                      splitters_kb: List[bytes], out_lists: List[list],
                      consume: bool = True,
                      max_merge_degree: int = 0,
                      submit=None) -> None:
    """Merge + splitter-partition in one pass, appending items into
    ``out_lists`` directly (the EM sort's final phase).

    The splitters ride as ONE EXTRA RUN of the native merge: when the
    engine emits the splitter run, the partition index advances — so
    partitioning costs zero key comparisons in Python and the final
    merge never copies key bytes out of the engine at all. Tie
    semantics match the generic path exactly: the splitter run has the
    HIGHEST run index, so items whose key equals a splitter pop first
    (run-id tiebreak) and land in the current partition, like the
    generic ``k > split_keys[w]`` advance."""
    max_merge_degree = _resolve_degree(max_merge_degree)
    pairs = list(zip(item_files, key_files))
    made: List[File] = []
    lib = _load()
    assert lib is not None
    try:
        pairs = _reduce_degree(pairs, max_merge_degree, consume, made,
                               submit=submit)
        k = len(pairs)
        handle = lib.mwm_create(k + 1)      # +1: the splitter run
        if not handle:
            raise RuntimeError("mwm_create failed")
        out_cap = 8192
        out_runs = np.empty(out_cap, dtype=np.uint32)
        need = ctypes.c_int32(-1)
        try:
            feeds = [_RunFeed(p[1].prefetch_reader(consume=consume,
                                                   submit=submit))
                     for p in pairs]
            # project=1: only the item half of each (pos, item) record
            # is read; columnar run blocks never decode their pos column
            item_readers = [p[0].prefetch_reader(consume=consume,
                                                 submit=submit,
                                                 project=1)
                            for p in pairs]
            for r, feed in enumerate(feeds):
                feed.feed(lib, handle, r)
            sp_offs = np.zeros(len(splitters_kb) + 1, dtype=np.int64)
            np.cumsum([len(b) for b in splitters_kb], out=sp_offs[1:])
            sp_blob = b"".join(splitters_kb)
            rc = lib.mwm_set_chunk(
                handle, k, len(splitters_kb),
                sp_offs.ctypes.data_as(ctypes.c_void_p),
                ctypes.cast(ctypes.c_char_p(sp_blob), ctypes.c_void_p)
                if sp_blob else None, 1)
            if rc != 0:
                raise RuntimeError("mwm_set_chunk(splitters) failed")
            w = 0
            while True:
                cnt = lib.mwm_next(
                    handle, out_runs.ctypes.data_as(ctypes.c_void_p),
                    out_cap, ctypes.byref(need), None, None, 0)
                if cnt < 0:
                    raise RuntimeError("mwm_next failed")
                if cnt:
                    cur = out_lists[w]
                    for r in out_runs[:cnt].tolist():
                        if r == k:
                            w += 1
                            cur = out_lists[w]
                        else:
                            cur.append(next(item_readers[r]))
                if need.value >= 0:
                    feeds[need.value].feed(lib, handle, need.value)
                    continue
                if lib.mwm_done(handle):
                    return
        finally:
            lib.mwm_destroy(handle)
    finally:
        for f in made:
            f.clear()


def merge_key_files(item_files: List[File], key_files: List[File],
                    consume: bool = True,
                    max_merge_degree: int = 0, submit=None
                    ) -> Iterator[Tuple[bytes, object]]:
    """Merge sorted (item, key) file pairs; yields (key_bytes, item).

    Mirrors multiway_merge_files' bounded-degree strategy: when there
    are more runs than ``max_merge_degree``, the smallest runs are
    partially merged into intermediate item+key Files first, so at most
    max_merge_degree key chunks are resident at once."""
    max_merge_degree = _resolve_degree(max_merge_degree)
    pairs = list(zip(item_files, key_files))
    made: List[File] = []
    try:
        pairs = _reduce_degree(pairs, max_merge_degree, consume, made,
                               submit=submit)
        yield from _merge_group([p[0] for p in pairs],
                                [p[1] for p in pairs], consume=consume,
                                submit=submit)
    finally:
        for f in made:
            f.clear()


def _put_chunk(writer, kb_buf: List[bytes]) -> None:
    offs = np.zeros(len(kb_buf) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in kb_buf], out=offs[1:])
    writer.put((offs, b"".join(kb_buf)))
