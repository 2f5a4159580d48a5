"""The port's order-key encoders, columnar records and native k-way merge
against the reference package on the CPU, on the cases of the
reference's own tests (``tests/core/test_native_merge.py``,
``tests/data/test_records.py``).

* ``core/order_key.py``: for every key of each case the port's bytes
  equal the reference's (per-item, batch and array encoders, the
  ``None`` of an array batch it cannot take included), the bytes sort
  as the keys do, and deviations raise in both;
* ``data/records.py`` with ``data/serializer.py``: ``serialize_batch``
  writes the reference's bytes for every batch (columnar, ndarray
  leaves, the ones that fall back to pickle), decodes them to equal
  items and types, slices and projects; ``argsort_rows``,
  ``gather_rows`` and ``write_run_blocks`` give the reference's order
  and block bytes;
* ``core/native_merge.py``: ``merge_key_files`` and
  ``merge_partitioned`` over the same runs give the reference's
  sequence and partitions, with small key chunks and a merge degree
  below the run count.
"""

import pickle
import random
import string
import struct

import numpy as np
import pytest

from thrill_tpu.core import native_merge as jnm
from thrill_tpu.core import order_key as jok
from thrill_tpu.data import block_pool as jbp
from thrill_tpu.data import file as jfile
from thrill_tpu.data import records as jrec
from thrill_tpu.data import serializer as jser

from thrill_tpu_torch.core import native_merge as tnm
from thrill_tpu_torch.core import order_key as tok
from thrill_tpu_torch.data import block_pool as tbp
from thrill_tpu_torch.data import file as tfile
from thrill_tpu_torch.data import records as trec
from thrill_tpu_torch.data import serializer as tser


@pytest.fixture(autouse=True)
def _records_on(monkeypatch):
    monkeypatch.delenv("THRILL_TPU_NATIVE_RECORDS", raising=False)


def _key_cases():
    rng = random.Random(0)
    return {
        "str": ["".join(rng.choices(string.printable, k=rng.randrange(0, 20)))
                for _ in range(300)] + ["", "a", "a\x00", "a\x00b", "ab"],
        "bytes": [bytes(rng.randrange(256) for _ in range(rng.randrange(12)))
                  for _ in range(300)] + [b"", b"\x00", b"\x00\x01", b"\xff"],
        "int": [rng.randrange(-(1 << 62), 1 << 62) for _ in range(300)]
        + [0, -1, 1, -(1 << 63), (1 << 63) - 1],
        "bool": [True, False] * 10,
        "float": [rng.uniform(-1e300, 1e300) for _ in range(300)]
        + [0.0, -0.0, float("inf"), float("-inf"), 1e-308],
        "tuple": [(rng.randrange(100), "".join(rng.choices(
            "abc", k=rng.randrange(0, 4))), rng.uniform(-9, 9))
            for _ in range(300)],
        "nested": [("a", ""), ("a", "b"), ("ab", ""), ("a", "\x00")],
        "unicode": ["ключ", "ключи", "κλειδί", "a", "z", "é"] * 5,
        "pairs": [(rng.randrange(50), f"s{rng.randrange(9)}")
                  for _ in range(200)],
        "ascii_widths": ["k" * rng.randrange(1, 12) + str(i)
                         for i in range(200)],
    }


@pytest.mark.parametrize("case", sorted(_key_cases()))
def test_order_key_encoders_write_the_references_bytes(case):
    keys = _key_cases()[case]
    enc_t, enc_j = tok.make_encoder(keys[0]), jok.make_encoder(keys[0])
    assert (enc_t is None) == (enc_j is None) and enc_t is not None
    kt = [tok.encode_or_raise(enc_t, k) for k in keys]
    assert kt == [jok.encode_or_raise(enc_j, k) for k in keys]
    # the bytes sort as the keys do
    by_value = sorted(range(len(keys)), key=lambda i: keys[i])
    by_bytes = sorted(range(len(keys)), key=lambda i: (kt[i], i))
    assert [keys[i] for i in by_bytes] == [keys[i] for i in by_value]
    bt, bj = tok.make_batch_encoder(keys[0]), jok.make_batch_encoder(keys[0])
    assert (bt is None) == (bj is None)
    if bt is not None:
        assert bt(keys, range(100, 100 + len(keys))) == \
            bj(keys, range(100, 100 + len(keys)))
    at = tok.make_array_batch_encoder(keys[0])
    aj = jok.make_array_batch_encoder(keys[0])
    assert (at is None) == (aj is None)
    if at is not None:
        for lo in range(0, len(keys), 64):
            got, want = at(keys[lo:lo + 64], lo), aj(keys[lo:lo + 64], lo)
            assert (got is None) == (want is None)
            if got is not None:
                assert got.dtype == want.dtype and \
                    got.tobytes() == want.tobytes()


@pytest.mark.parametrize("sample,bad", [
    ("hello", 42), (7, 1 << 70), (7, 3.5), ((1, "a"), (1, "a", 2)),
    (b"x", "x")])
def test_order_key_deviations_raise_in_both(sample, bad):
    for mod in (tok, jok):
        enc = mod.make_encoder(sample)
        with pytest.raises(mod.OrderKeyError):
            mod.encode_or_raise(enc, bad)
        batch = mod.make_batch_encoder(sample)
        with pytest.raises(mod.BATCH_ENCODE_ERRORS):
            batch([sample, bad], [0, 1])
    for unsupported in (object(), [1, 2]):
        assert tok.make_encoder(unsupported) is None
        assert jok.make_encoder(unsupported) is None


# -- records -------------------------------------------------------------

BATCHES = {
    "ints": [1, 2, -5, 2 ** 62],
    "bools": [True, False, True],
    "floats": [1.5, -0.0, float("inf")],
    "strs": ["abc", "x", "defgh", ""],
    "unicode": ["ключ-1", "ключ-2"],
    "bytes": [b"ab", b"c", b"a\x00b"],
    "pairs": [(0, "abc"), (1, "x")],
    "nested": [(5, (1, 2.5)), (6, (3, -1.5))],
    "wide": [(1, ("a", b"b", True, 2, 3.5)), (2, ("c", b"d", False, 4, 5.5))],
    "array_leaf": [(f"k{i}", np.full((4,), float(i))) for i in range(6)],
    "array_2d": [(i, np.arange(12, dtype=np.int32).reshape(4, 3) + i)
                 for i in range(5)],
    "array_str": [(i, np.array(["ab", "cdef"], dtype="U4")) for i in range(3)],
    "raw_arrays": [np.arange(4) + i for i in range(3)],
    # what falls back to pickle
    "mixed": [1, "a"],
    "int_overflow": [1 << 70],
    "bool_int": [True, 1],
    "nul_str": ["a\x00"],
    "nul_bytes": [b"a\x00"],
    "np_scalar": [np.int64(3)],
    "ragged_tuple": [(1, 2), (1, 2, 3)],
    "ragged_array": [(1, np.arange(3)), (2, np.arange(4))],
    "empty_tuple": [()],
}


def _same(a, b):
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (type(a) is type(b) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    return type(a) is type(b) and (a == b or a != a)


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_serialize_batch_writes_the_references_columnar_bytes(name):
    items = BATCHES[name]
    blob = tser.serialize_batch(items)
    assert blob == jser.serialize_batch(items)
    back = tser.deserialize_batch(blob)
    assert len(back) == len(items) and all(map(_same, back, items))
    n = len(items)
    for lo, hi in [(0, n), (1, n), (n, n)]:
        assert all(map(_same, tser.deserialize_slice(blob, lo, hi),
                       items[lo:hi]))
        assert all(map(_same, tser.deserialize_iter(blob, lo, hi),
                       items[lo:hi]))
    if isinstance(items[0], tuple) and tser._parse_header(blob)[0] == \
            tser._COLS:
        assert all(map(_same, tser.deserialize_iter(blob, 0, n, 1),
                       [t[1] for t in items]))


def test_records_off_writes_pickle(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_NATIVE_RECORDS", "0")
    items = BATCHES["pairs"]
    blob = tser.serialize_batch(items)
    assert blob == jser.serialize_batch(items)
    assert tser._parse_header(blob)[0] == tser._PICKLE


def _rows(n, w=12, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=(n, w), dtype=np.uint8).reshape(-1).view(
        f"S{w}")


def test_argsort_and_gather_rows_match_the_reference():
    arr = _rows(5000)
    order = trec.argsort_rows(arr)
    assert np.array_equal(order, jrec.argsort_rows(arr))
    assert trec.gather_rows(arr, order).tobytes() == \
        jrec.gather_rows(arr, order).tobytes()


@pytest.mark.parametrize("kind", ["str", "tuple", "array"])
def test_write_run_blocks_writes_the_references_blocks(kind):
    n = 50
    items = {"str": [f"k{i % 7}-{i}" for i in range(n)],
             "tuple": [(i % 5, float(i), f"s{i}") for i in range(n)],
             "array": [(i, np.full((3,), i, np.int16)) for i in range(n)]}[kind]
    order = np.random.default_rng(2).permutation(n).astype(np.int64)
    blocks = []
    for rec, fmod, bp in ((trec, tfile, tbp), (jrec, jfile, jbp)):
        pool = bp.BlockPool()
        f = fmod.File(pool=pool, block_items=16)
        tmpl, cols = rec.make_run_encoder(items[0])(items)
        rec.write_run_blocks(f, order, 100, cols, tmpl, f.block_items)
        blocks.append([pool.get(b.bid) for b in f.blocks])
        if rec is trec:
            want = [(100 + int(i), items[int(i)]) for i in order]
            assert all(map(_same, f.keep_reader(), want))
            assert all(map(_same, f.keep_reader(project=1),
                           [w[1] for w in want]))
        f.close()
        pool.close()
    assert blocks[0] == blocks[1] and len(blocks[0]) == 4


def test_run_encoder_refuses_what_cannot_round_trip():
    for sample in ("a\x00", 1 << 70, np.int64(3), object()):
        assert trec.make_run_encoder(sample) is None
        assert jrec.make_run_encoder(sample) is None
    enc = trec.make_run_encoder("abc")
    assert enc(["abc", "a\x00"]) is None and enc(["abc", 3]) is None


# -- native merge ---------------------------------------------------------

def _runs(fmod, bp, nmod, okmod, k, per_run, seed):
    rng = random.Random(seed)
    pool = bp.BlockPool()
    item_files, key_files = [], []
    enc = okmod.make_encoder(("x", 0))
    pos = 0
    for _ in range(k):
        n = (per_run + rng.randrange(-per_run // 2, per_run // 2 + 1)
             if per_run else 0)
        items = []
        for _ in range(n):
            items.append(("".join(rng.choices("abcd", k=rng.randrange(6))),
                          pos))
            pos += 1
        items.sort()
        f, kf = fmod.File(pool=pool), fmod.File(pool=pool)
        with f.writer() as w:
            for it in items:
                w.put(it)
        nmod.write_key_chunks(kf, [okmod.encode_or_raise(enc, it)
                                   for it in items])
        item_files.append(f)
        key_files.append(kf)
    return pool, item_files, key_files, enc


@pytest.mark.parametrize("k,per_run,chunk,degree", [
    (1, 100, 8192, 0), (3, 1000, 64, 0), (7, 311, 17, 0), (2, 0, 8192, 0),
    (5, 2000, 1024, 0), (11, 150, 50, 3)])
def test_native_merge_matches_the_reference(k, per_run, chunk, degree,
                                            monkeypatch):
    monkeypatch.setattr(tnm, "KEY_CHUNK", chunk)
    monkeypatch.setattr(jnm, "KEY_CHUNK", chunk)
    out = []
    for nmod, fmod, bp, okmod in ((tnm, tfile, tbp, tok),
                                  (jnm, jfile, jbp, jok)):
        pool, fi, fk, _ = _runs(fmod, bp, nmod, okmod, k, per_run,
                                k * 1000 + per_run)
        out.append(list(nmod.merge_key_files(fi, fk, consume=True,
                                             max_merge_degree=degree)))
        pool.close()
    assert out[0] == out[1]
    assert [it for _, it in out[0]] == sorted(it for _, it in out[0])


@pytest.mark.parametrize("W", [1, 2, 4])
def test_merge_partitioned_matches_the_reference(W, monkeypatch):
    monkeypatch.setattr(tnm, "KEY_CHUNK", 64)
    monkeypatch.setattr(jnm, "KEY_CHUNK", 64)
    out = []
    for nmod, fmod, bp, okmod in ((tnm, tfile, tbp, tok),
                                  (jnm, jfile, jbp, jok)):
        pool, fi, fk, enc = _runs(fmod, bp, nmod, okmod, 6, 400, W)
        splitters = [okmod.encode_or_raise(enc, (s, 10 ** 9))
                     for s in ("ab", "c", "cd")[:W - 1]]
        lists = [[] for _ in range(W)]
        nmod.merge_partitioned(fi, fk, splitters, lists, consume=True,
                               max_merge_degree=4)
        out.append(lists)
        pool.close()
    assert out[0] == out[1]
    # the records are (key, position): the merge yields element 1 of each
    flat = [it for l in out[0] for it in l]
    assert sorted(flat) == list(range(len(flat)))


def test_key_chunks_fixed_write_the_references_bytes():
    arr = _rows(20_000, w=9)
    arr = arr[np.argsort(arr)]
    blobs = []
    for nmod, fmod, bp in ((tnm, tfile, tbp), (jnm, jfile, jbp)):
        pool = bp.BlockPool()
        kf = fmod.File(pool=pool)
        nmod.write_key_chunks_fixed(kf, arr)
        blobs.append([pool.get(b.bid) for b in kf.blocks])
        pool.close()
    assert blobs[0] == blobs[1] and len(blobs[0]) == 3
    assert pickle.loads(blobs[0][0][4:4 + struct.unpack_from(
        "<I", blobs[0][0])[0]])[0] == tser._RAW
