"""The port's kernel modules against the reference package on the CPU.

The plain versions of the partition-histogram, stable-partition and
presence-fill kernels must equal the Pallas kernels in interpret mode bit
for bit, the segment sum within ``atol=1e-4`` (the reference's own bound
for sums of a thousand normal values: the one-hot kernel adds in blocks
of 64, the plain version in order); on int64 ids beyond 32 bits, which
the Pallas kernels cut to int32, the histogram and the presence fill
must equal the reference's dispatch functions, whose non-Pallas path on
the CPU compares at full width;
key encoding must equal the reference's word for word; the radix loop
must equal numpy's stable sorts. The CUDA kernels themselves run only on
a card: ``tests/test_torch_gpu.py`` holds them against their plain
versions there.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from thrill_tpu.core import keys as jkeys
from thrill_tpu.core import pallas_kernels as jpk
from thrill_tpu.core import pallas_sort as jps
from thrill_tpu_torch.core import device_sort as tds
from thrill_tpu_torch.core import keys as tkeys
from thrill_tpu_torch.core import pallas_kernels as tpk
from thrill_tpu_torch.core import pallas_sort as tps
from thrill_tpu_torch.data import exchange as texchange


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- partition histogram (kernel B1) ----------------------------------------

@pytest.mark.parametrize("n,bins", [(10, 4), (512, 8), (2000, 17),
                                    (4096, 256)])
def test_histogram_plain_matches_pallas(n, bins):
    rng = np.random.default_rng(n)
    dest = rng.integers(0, bins, n).astype(np.int32)
    want = np.asarray(jpk.partition_histogram_pallas(
        jnp.asarray(dest), bins, interpret=True))
    got = tpk.partition_histogram_plain(_t(dest), bins)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("dest,bins", [
    ([0, 1, 1, 7, 7, 7, -1], 4),           # 7 = "W" sentinel, -1 padding
    ([], 4),                               # empty input
    ([-5, 300, 2, 2, 255, 256], 256),      # out of range both sides
])
def test_histogram_plain_edge_cases_match_pallas(dest, bins):
    d = np.asarray(dest, dtype=np.int32)
    want = np.asarray(jpk.partition_histogram_pallas(
        jnp.asarray(d), bins, interpret=True))
    assert np.array_equal(tpk.partition_histogram_plain(_t(d), bins).numpy(),
                          want)
    # the wrapper takes the plain version for a CPU tensor
    assert np.array_equal(tpk.partition_histogram(_t(d), bins).numpy(), want)


def test_histogram_batched_rows_match_pallas():
    rng = np.random.default_rng(5)
    W, n, bins = 4, 1500, 5
    dest = rng.integers(-1, bins + 1, (W, n)).astype(np.int32)
    got = tpk.partition_histogram(_t(dest), bins).numpy()
    assert got.shape == (W, bins)
    for w in range(W):
        want = np.asarray(jpk.partition_histogram_pallas(
            jnp.asarray(dest[w]), bins, interpret=True))
        assert np.array_equal(got[w], want)


# int64 ids at and beyond 32 bits: a kernel that cut them to int32 would
# count 2^32 + 1 in bin 1 and 2^32 + 3 in bin 3
_WIDE_IDS = [2**31 - 1, 2**31, 2**32, 2**32 + 1, 2**32 + 3, 2**40 + 2,
             -2**31, -2**32 + 1, -1, 2**63 - 1, -2**63]


@pytest.mark.parametrize("shape,bins,sort", [
    ((1000,), 4, True),                    # sorted send destinations
    ((4, 1500), 4, True),                  # per worker, sentinel tail
    ((4097,), 4, False),                   # random, ragged
    ((3000,), 17, False),
    ((2, 2048), 256, True),
])
def test_histogram_int64_ids_match_pallas(shape, bins, sort):
    rng = np.random.default_rng(40 + shape[-1])
    dest = rng.integers(0, bins + 1, shape).astype(np.int64)  # bins: W
    if sort:
        dest.sort(axis=-1)
    got = tpk.partition_histogram(_t(dest), bins)
    assert got.dtype == torch.int32 and got.shape == shape[:-1] + (bins,)
    for row, g in zip(dest.reshape(-1, shape[-1]), got.reshape(-1, bins)):
        want = np.asarray(jpk.partition_histogram_pallas(
            jnp.asarray(row), bins, interpret=True))
        assert np.array_equal(g.numpy(), want)


@pytest.mark.parametrize("bins,W", [(4, 1), (4, 4), (5, 2), (256, 1)])
def test_histogram_int64_beyond_32_bits_matches_reference(bins, W):
    rng = np.random.default_rng(bins + W)
    dest = np.concatenate([np.tile(_WIDE_IDS, (W, 1)),
                           rng.integers(0, bins, (W, 400))], axis=1)
    dest = rng.permuted(dest.astype(np.int64), axis=1)
    got = tpk.partition_histogram(_t(dest), bins).numpy()
    for w in range(W):
        want = np.asarray(jpk.partition_histogram(jnp.asarray(dest[w]), bins))
        assert np.array_equal(got[w], want)
        assert got[w, 1] == np.sum(dest[w] == 1)


def test_send_counts_hands_the_ids_over_as_they_are(monkeypatch):
    seen = []

    def hist(dest, bins):
        seen.append(dest)
        return tpk.partition_histogram(dest, bins)

    monkeypatch.setattr(texchange, "partition_histogram", hist)
    dest = torch.tensor([[0, 0, 1, 3, 4, 4], [1, 2, 2, 2, 3, 4]])
    S = texchange.send_counts(dest, 4)
    assert seen[0] is dest and dest.dtype == torch.int64
    assert S.tolist() == [[2, 1, 0, 1], [0, 1, 3, 1]]


# -- stable partition offsets (kernel B2) -----------------------------------

@pytest.mark.parametrize("n,B", [(1, 1), (513, 3), (1000, 8), (5000, 256),
                                 (4096, 100)])
def test_offsets_plain_matches_pallas(n, B):
    rng = np.random.default_rng(n)
    dest = rng.integers(0, B, size=n).astype(np.int32)
    want = np.asarray(jps.stable_partition_offsets_pallas(
        jnp.asarray(dest), B, interpret=True))
    got = tps.stable_partition_offsets_plain(_t(dest), B)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    perm = np.zeros(n, np.int64)
    perm[got.numpy()] = np.arange(n)
    assert np.array_equal(perm, np.argsort(dest, kind="stable"))


@pytest.mark.parametrize("dest,B", [
    ([5, -1, 2, 7, 2, 99], 8),             # sentinels land stably last
    ([], 256),                             # empty input
    ([3, 3, 3, 3], 256),                   # one digit
])
def test_offsets_plain_edge_cases_match_pallas(dest, B):
    d = np.asarray(dest, dtype=np.int32)
    want = np.asarray(jps.stable_partition_offsets_pallas(
        jnp.asarray(d), B, interpret=True))
    got = tps.stable_partition_offsets(_t(d), B).numpy()
    assert np.array_equal(got, want)
    assert sorted(got.tolist()) == list(range(len(dest)))


def test_offsets_batched_rows_match_pallas():
    rng = np.random.default_rng(11)
    W, n, B = 2, 3000, 256
    dest = rng.integers(-3, B + 3, (W, n)).astype(np.int32)
    got = tps.stable_partition_offsets(_t(dest), B).numpy()
    for w in range(W):
        want = np.asarray(jps.stable_partition_offsets_pallas(
            jnp.asarray(dest[w]), B, interpret=True))
        assert np.array_equal(got[w], want)


def test_wrappers_refuse_other_devices_and_inputs():
    meta = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tpk.partition_histogram(meta, 4)
    with pytest.raises(ValueError):
        tps.stable_partition_offsets(meta, 4)
    # the kernels' own gates refuse before touching a device
    with pytest.raises(ValueError):
        tpk._launch(torch.zeros(8, dtype=torch.int16), 4)
    with pytest.raises(ValueError):
        tpk._launch(torch.zeros(8, dtype=torch.float32), 4)
    with pytest.raises(ValueError):
        tpk._launch(torch.zeros((2, 8), dtype=torch.int64)[:, ::2], 4)
    with pytest.raises(ValueError):
        tpk._launch(torch.zeros(8, dtype=torch.int32), tpk.MAX_BINS + 1)
    with pytest.raises(ValueError):
        tps._launch(torch.zeros(8, dtype=torch.int32), tps.MAX_BINS + 1)
    with pytest.raises(ValueError):
        tps._launch(torch.zeros((2, 8), dtype=torch.int32)[:, ::2], 4)


# -- segment sum (kernel B3) ------------------------------------------------

@pytest.mark.parametrize("n,segs", [(100, 5), (1000, 300), (4096, 4096),
                                    (777, 1)])
def test_segment_sum_plain_matches_pallas(n, segs):
    rng = np.random.default_rng(n)
    ids = rng.integers(0, segs, n).astype(np.int32)
    vals = rng.normal(size=n).astype(np.float32)
    want = np.asarray(jpk.segment_sum_pallas(
        jnp.asarray(ids), jnp.asarray(vals), segs, interpret=True))
    got = tpk.segment_sum_plain(_t(ids), _t(vals), segs)
    assert got.dtype == torch.float32 and got.shape == (segs,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    ref = np.zeros(segs, np.float64)
    np.add.at(ref, ids, vals)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("ids,segs", [
    ([0, -1, 3, 99, 3, 2, 4], 4),          # -1 padding, >= S overflow
    ([], 5),                               # empty input
    ([2] * 300, 3),                        # one segment everywhere
])
def test_segment_sum_plain_edge_cases_match_pallas(ids, segs):
    d = np.asarray(ids, dtype=np.int32)
    v = np.linspace(-1, 2, len(ids)).astype(np.float32)
    want = np.asarray(jpk.segment_sum_pallas(
        jnp.asarray(d), jnp.asarray(v), segs, interpret=True))
    np.testing.assert_allclose(tpk.segment_sum(_t(d), _t(v), segs).numpy(),
                               want, rtol=0, atol=1e-4)


def test_segment_sum_batched_rows_match_pallas():
    rng = np.random.default_rng(6)
    W, n, segs = 4, 1200, 70
    ids = rng.integers(-2, segs + 2, (W, n)).astype(np.int32)
    vals = rng.normal(size=(W, n)).astype(np.float32)
    got = tpk.segment_sum(_t(ids), _t(vals), segs).numpy()
    assert got.shape == (W, segs)
    for w in range(W):
        want = np.asarray(jpk.segment_sum_pallas(
            jnp.asarray(ids[w]), jnp.asarray(vals[w]), segs, interpret=True))
        np.testing.assert_allclose(got[w], want, rtol=0, atol=1e-4)


# -- presence fill (kernel B4) ----------------------------------------------

@pytest.mark.parametrize("n,M", [(10, 4), (512, 64), (3000, 500),
                                 (4096, 1024)])
def test_presence_fill_plain_matches_pallas(n, M):
    rng = np.random.default_rng(n + M)
    h = rng.integers(0, M, n).astype(np.int32)
    valid = rng.random(n) < 0.7
    want = np.asarray(jpk.presence_fill_pallas(
        jnp.asarray(h), jnp.asarray(valid), M, interpret=True))
    got = tpk.presence_fill_plain(_t(h), _t(valid), M)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,valid,M", [
    ([0, -1, 3, 99, 3, 2], [1, 1, 1, 1, 0, 1], 4),   # sentinels, invalid
    ([], [], 8),                                     # empty input
    ([5] * 100, [1] * 100, 6),                       # one register
])
def test_presence_fill_plain_edge_cases_match_pallas(h, valid, M):
    h = np.asarray(h, dtype=np.int32)
    valid = np.asarray(valid, dtype=bool)
    want = np.asarray(jpk.presence_fill_pallas(
        jnp.asarray(h), jnp.asarray(valid), M, interpret=True))
    assert np.array_equal(tpk.presence_fill(_t(h), _t(valid), M).numpy(),
                          want)


@pytest.mark.parametrize("shape,M,frac", [
    ((2000,), 64, 0.22),                   # WordCount's compacted shards
    ((4, 4097), 4096, 0.5),
    ((3, 777), 300, 1.0),
    ((2, 1000), 1 << 17, 0.0),             # no valid row
])
def test_presence_fill_int64_compacted_prefix_matches_pallas(shape, M, frac):
    rng = np.random.default_rng(50 + M)
    n = shape[-1]
    h = rng.integers(0, M, shape).astype(np.int64)
    valid = np.broadcast_to(np.arange(n) < int(frac * n), shape).copy()
    got = tpk.presence_fill(_t(h), _t(valid), M)
    assert got.dtype == torch.uint8 and got.shape == shape[:-1] + (M,)
    for hr, vr, g in zip(h.reshape(-1, n), valid.reshape(-1, n),
                         got.reshape(-1, M)):
        want = np.asarray(jpk.presence_fill_pallas(
            jnp.asarray(hr), jnp.asarray(vr), M, interpret=True))
        assert np.array_equal(g.numpy(), want)


@pytest.mark.parametrize("M", [4, 300, 1 << 17])
def test_presence_fill_int64_beyond_32_bits_matches_reference(M):
    rng = np.random.default_rng(M)
    rest = rng.integers(0, M, 300)
    rest[(rest == 1) | (rest == 3)] = 0
    h = rng.permutation(np.concatenate([_WIDE_IDS, rest]).astype(np.int64))
    valid = (rng.random(len(h)) < 0.6) | (np.abs(h) >= 2**31 - 1)
    got = tpk.presence_fill(_t(h), _t(valid), M).numpy()
    want = np.asarray(jpk.presence_fill(jnp.asarray(h), jnp.asarray(valid),
                                        M))
    assert np.array_equal(got, want)
    assert got[1] == 0 and got[3] == 0


@pytest.mark.parametrize("W", [2, 4])
def test_reduce_by_key_hands_the_register_ids_over_as_they_are(
        monkeypatch, W):
    import thrill_tpu_torch as tt
    from thrill_tpu_torch.api.ops import reduce as treduce
    seen = []

    def fill(h, valid, regs):
        seen.append(h.dtype)
        return tpk.presence_fill(h, valid, regs)

    monkeypatch.setattr(treduce, "presence_fill", fill)
    k = np.random.default_rng(W).integers(0, 50, 600).astype(np.int64)
    out = tt.Run(lambda ctx: ctx.Distribute({"k": k, "c": np.ones_like(k)})
                 .ReduceByKey(lambda r: r["k"],
                              tt.FieldReduce({"k": "first", "c": "sum"}),
                              dup_detection=True).AllGatherArrays(),
                 W, device="cpu")
    assert seen == [torch.int64]
    order = np.argsort(out["k"].numpy())
    assert np.array_equal(out["k"].numpy()[order], np.unique(k))
    assert np.array_equal(out["c"].numpy()[order],
                          np.bincount(k)[np.unique(k)])


def test_presence_fill_batched_rows_match_pallas():
    rng = np.random.default_rng(12)
    W, n, M = 4, 2000, 300
    h = rng.integers(-5, M + 5, (W, n)).astype(np.int32)
    valid = rng.random((W, n)) < 0.5
    got = tpk.presence_fill(_t(h), _t(valid), M).numpy()
    assert got.shape == (W, M)
    for w in range(W):
        want = np.asarray(jpk.presence_fill_pallas(
            jnp.asarray(h[w]), jnp.asarray(valid[w]), M, interpret=True))
        assert np.array_equal(got[w], want)


def test_segment_and_presence_wrappers_refuse_bad_inputs():
    meta = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tpk.segment_sum(meta, torch.empty(8, device="meta"), 4)
    with pytest.raises(ValueError):
        tpk.presence_fill(meta, torch.empty(8, dtype=torch.bool,
                                            device="meta"), 4)
    i32 = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):                 # f64 values
        tpk._seg_launch(i32, torch.zeros(8, dtype=torch.float64), 4)
    with pytest.raises(ValueError):                 # shapes differ
        tpk._seg_launch(i32, torch.zeros(9), 4)
    with pytest.raises(ValueError):                 # no segments
        tpk._seg_launch(i32, torch.zeros(8), 0)
    with pytest.raises(ValueError):                 # int flags
        tpk._pres_launch(i32, torch.zeros(8, dtype=torch.int32), 4)
    with pytest.raises(ValueError):                 # int16 ids
        tpk._pres_launch(torch.zeros(8, dtype=torch.int16),
                         torch.zeros(8, dtype=torch.bool), 4)
    with pytest.raises(ValueError):                 # beyond the bitset
        tpk._pres_launch(torch.zeros(8, dtype=torch.int64),
                         torch.zeros(8, dtype=torch.bool),
                         tpk.BITSET_REGS + 1)
    with pytest.raises(ValueError):                 # strided ids
        tpk._pres_launch(torch.zeros((2, 8), dtype=torch.int32)[:, ::2],
                         torch.zeros((2, 4), dtype=torch.bool), 4)


# -- key encoding -----------------------------------------------------------

def _key_cases():
    rng = np.random.default_rng(3)
    n = 257
    fl = np.array([-np.inf, -1.5, -0.0, 0.0, 1e-300, 3.0, np.inf, np.nan])
    return [
        ("bytes10", rng.integers(0, 256, (n, 10)).astype(np.uint8)),
        ("bytes3", rng.integers(0, 256, (n, 3)).astype(np.uint8)),
        ("bytes16", rng.integers(0, 256, (n, 16)).astype(np.uint8)),
        ("int32", rng.integers(-2**31, 2**31, n).astype(np.int32)),
        ("int64", np.array([-2**63, -1, 0, 1, 2**63 - 1], np.int64)),
        ("bool", rng.integers(0, 2, n).astype(bool)),
        ("uint8", rng.integers(0, 256, n).astype(np.uint8)),
        ("uint16", rng.integers(0, 2**16, n).astype(np.uint16)),
        ("uint32", rng.integers(0, 2**32, n).astype(np.uint32)),
        ("float32", fl.astype(np.float32)),
        ("float64", np.concatenate([fl, rng.normal(size=n)])),
    ]


@pytest.mark.parametrize("name,leaf", _key_cases(),
                         ids=[c[0] for c in _key_cases()])
def test_encode_key_words_matches_reference(name, leaf):
    want = [np.asarray(w).view(np.int64)
            for w in jkeys.encode_key_words(jnp.asarray(leaf))]
    got = [w.numpy() for w in tkeys.encode_key_words(_t(leaf))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_encode_key_tree_orders_leaves_like_reference():
    rng = np.random.default_rng(4)
    tree = {"b": rng.integers(-9, 9, 50).astype(np.int64),
            "a": rng.normal(size=50),
            "c": (rng.integers(0, 256, (50, 9)).astype(np.uint8),)}
    want = [np.asarray(w).view(np.int64) for w in jkeys.encode_key_words(
        {k: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple)
             else jnp.asarray(v)) for k, v in tree.items()})]
    got = [w.numpy() for w in tkeys.encode_key_words(
        {k: (tuple(_t(x) for x in v) if isinstance(v, tuple) else _t(v))
         for k, v in tree.items()})]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


# -- radix loop and the argsort engines -------------------------------------

def test_radix_argsort_matches_lexsort():
    rng = np.random.default_rng(0)
    n = 5000
    w0 = rng.integers(0, 1 << 63, size=n).astype(np.uint64)
    w0[::3] |= np.uint64(1 << 63)             # high bit: unsigned order
    w1 = (rng.integers(0, 1 << 16, size=n).astype(np.uint64)
          << np.uint64(48))
    passes = []
    perm = tps.radix_argsort_device([_t(w0.view(np.int64)),
                                     _t(w1.view(np.int64))], passes=passes)
    assert np.array_equal(perm.numpy(), np.lexsort((w1, w0)))
    # 8 digits of w0 and the 2 high digits of w1 vary; the rest skip
    assert passes == [(10, 16)]


def test_radix_argsort_stability():
    rng = np.random.default_rng(1)
    wd = rng.integers(0, 4, size=5000).astype(np.int64)
    perm = tps.radix_argsort_device([_t(wd)], word_bits=[8])
    assert np.array_equal(perm.numpy(), np.argsort(wd, kind="stable"))


@pytest.mark.parametrize("W", [1, 2, 4])
def test_argsort_engines_agree_per_worker(W):
    rng = np.random.default_rng(W)
    n = 1200
    words = [rng.integers(-2**63, 2**63, (W, n), dtype=np.int64),
             rng.integers(0, 3, (W, n)).astype(np.int64) << 62]
    words[0][:, ::4] = 7                      # ties broken by word 1
    tw = [_t(w) for w in words]
    radix = tps.radix_argsort_device(tw).numpy()
    plain = tds.argsort_words(tw).numpy()      # CPU: the plain engine
    assert np.array_equal(radix, plain)
    for w in range(W):
        u = [x[w].view(np.uint64) for x in words]
        assert np.array_equal(plain[w], np.lexsort((u[1], u[0])))


def test_radix_argsort_empty_rows():
    perm = tps.radix_argsort_device([torch.zeros((2, 0), dtype=torch.int64)])
    assert perm.shape == (2, 0)


# -- the onesweep engine's plain versions against the reference -------------

def _digit(words, shift):
    return ((words.view(np.uint64) >> np.uint64(shift))
            & np.uint64(255)).astype(np.int32)


@pytest.mark.parametrize("n,shift,gather", [(1000, 0, False), (3001, 8, True),
                                            (4097, 56, True),
                                            (5000, 24, False)])
def test_radix_pass_plain_matches_pallas_partition(n, shift, gather):
    # the pass = the TPU kernel's offsets, then .at[offs].set of the
    # carried keys and permutation
    rng = np.random.default_rng(n + shift)
    words = rng.integers(-2**63, 2**63, n, dtype=np.int64)
    words[::5] = words[0]                      # ties keep their order
    perm = rng.permutation(n).astype(np.int32)
    carried = words[perm] if gather else words
    offs = jps.stable_partition_offsets_pallas(
        jnp.asarray(_digit(carried, shift)), 256, interpret=True)
    want_p = np.asarray(jnp.zeros(n, jnp.int32).at[offs].set(perm))
    want_k = np.asarray(jnp.zeros(n, jnp.int64).at[offs].set(carried))
    k, p = tps.radix_pass_plain(_t(words), _t(perm), shift, gather=gather)
    assert p.dtype == torch.int32 and k.dtype == torch.int64
    assert np.array_equal(p.numpy(), want_p)
    assert np.array_equal(k.numpy(), want_k)
    # the wrapper takes the plain version for CPU tensors; without keys
    hist = tps.radix_upsweep(_t(words))[shift // 8]
    k2, p2 = tps.radix_pass(_t(words), _t(perm), shift, hist, gather=gather,
                            write_keys=False)
    assert k2 is None and np.array_equal(p2.numpy(), want_p)


def test_radix_pass_identity_permutation():
    rng = np.random.default_rng(21)
    W, n = 3, 2000
    words = rng.integers(-2**63, 2**63, (W, n), dtype=np.int64)
    k, p = tps.radix_pass_plain(_t(words), None, 16, gather=True)
    for w in range(W):
        order = np.argsort(_digit(words[w], 16), kind="stable")
        assert np.array_equal(p[w].numpy(), order)
        assert np.array_equal(k[w].numpy(), words[w][order])


@pytest.mark.parametrize("W,n,ndigits", [(1, 1000, 8), (2, 777, 3),
                                         (4, 1500, 2)])
def test_radix_upsweep_plain_matches_pallas_histograms(W, n, ndigits):
    rng = np.random.default_rng(W * n)
    words = rng.integers(-2**63, 2**63, (W, n), dtype=np.int64)
    words[:, ::2] |= np.int64(-2**63)         # the sign bit set
    words[:, 1::7] = -1
    got = tps.radix_upsweep(_t(words), ndigits).numpy()
    assert got.shape == (W, 8, 256) and got.dtype == np.int32
    for w in range(W):
        for j in range(8):
            want = (np.asarray(jpk.partition_histogram_pallas(
                jnp.asarray(_digit(words[w], 8 * j)), 256, interpret=True))
                if j < ndigits else np.zeros(256, np.int32))
            assert np.array_equal(got[w, j], want)


@pytest.mark.parametrize("W", [1, 2, 4])
def test_radix_argsort_matches_reference_engine_per_row(W):
    rng = np.random.default_rng(30 + W)
    n = tps.TILE + 37                          # a ragged last tile
    w0 = rng.integers(0, 2**64, (W, n), dtype=np.uint64)
    w0[:, ::3] = w0[:, :1]                     # ties broken by w1
    w1 = rng.integers(0, 200, (W, n)).astype(np.uint64)
    passes = []
    got = tps.radix_argsort_device([_t(w0.view(np.int64)),
                                    _t(w1.view(np.int64))], [64, 8],
                                   passes=passes).numpy()
    assert passes == [(9, 9)]
    for w in range(W):
        want = np.asarray(jps.radix_argsort_device(
            [jnp.asarray(w0[w]), jnp.asarray(w1[w])], word_bits=[64, 8]))
        assert np.array_equal(got[w], want)


@pytest.mark.parametrize("W", [1, 2, 4])
def test_radix_argsort_empty_rows_have_no_live_pass(W):
    # the reference engine reads digit[0] and takes no empty row; the
    # port's upsweep sees an empty histogram and runs no pass
    passes = []
    got = tps.radix_argsort_device([torch.zeros((W, 0), dtype=torch.int64)],
                                   [16], passes=passes)
    assert got.shape == (W, 0) and got.dtype == torch.int64
    assert passes == [(0, 2)]
