"""The port's Golomb-Rice codec (``thrill_tpu_torch/core/golomb.py``) and
LocationDetection (``core/location_detection.py``) against the
reference package's.

Tolerance: none. Payload bytes, bit counts and value counts are equal
to the reference's for both encoders; every round trip gives the input
back; LocationDetection's wire bytes, holders, targets and common hashes
equal the reference's.
"""

import numpy as np
import pytest

from thrill_tpu.core import golomb as jg
from thrill_tpu.core import location_detection as jld

from thrill_tpu_torch.core import golomb as tg
from thrill_tpu_torch.core import location_detection as tld


def _sorted_values(rng, n, span):
    return np.unique(rng.integers(0, span, n)).astype(np.int64)


@pytest.mark.parametrize("k", [0, 1, 3, 7, 12])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_sorted_is_the_reference_s(k, seed):
    rng = np.random.default_rng(seed)
    v = _sorted_values(rng, 300, 1 << (k + 6))
    want = jg.encode_sorted([int(x) for x in v], k)
    assert tg.encode_sorted([int(x) for x in v], k) == want
    assert tg.encode_sorted_np(v, k) == jg.encode_sorted_np(v, k) == want
    payload, nbits, count = want
    assert list(tg.decode_sorted(payload, nbits, count, k)) == v.tolist()
    assert tg.decode_sorted_np(payload, nbits, count, k).tolist() == \
        v.tolist()


@pytest.mark.parametrize("values", [[], [0], [5], [0, 1, 2, 3],
                                    [(1 << 16) - 1], [3, 1000, 1 << 16]])
def test_edge_lists_round_trip(values):
    for k in (0, 2, 9):
        got = tg.encode_sorted(values, k)
        assert got == jg.encode_sorted(values, k)
        assert tg.encode_sorted_np(np.asarray(values, np.int64), k) == got
        assert list(tg.decode_sorted(*got, k)) == values
        assert tg.decode_sorted_np(*got, k).tolist() == values


def test_not_increasing_raises_as_the_reference():
    for enc in (tg.encode_sorted, jg.encode_sorted):
        with pytest.raises(AssertionError):
            enc([3, 3], 1)
    for enc in (tg.encode_sorted_np, jg.encode_sorted_np):
        with pytest.raises(AssertionError):
            enc(np.asarray([4, 2]), 1)
        with pytest.raises(AssertionError):
            enc(np.asarray([-1, 2]), 1)


def test_truncated_stream_raises():
    payload, nbits, count = tg.encode_sorted_np(np.arange(0, 90, 7), 2)
    with pytest.raises(ValueError, match="truncated"):
        tg.decode_sorted_np(payload, nbits - 5, count, 2)


@pytest.mark.parametrize("mean", [0.0, 1.0, 1.5, 2.0, 3.0, 1000.0,
                                  2.0 ** 20 + 1, 2.0 ** 32])
def test_rice_parameter_is_the_reference_s(mean):
    assert tg.rice_parameter(mean) == jg.rice_parameter(mean)


def test_bit_writer_and_reader_are_the_reference_s():
    tw, jw = tg.BitWriter(), jg.BitWriter()
    for w in (tw, jw):
        w.put_bits(0b1011, 4)
        w.put_unary(5)
        w.put_bits(3, 7)
    assert tw.to_bytes() == jw.to_bytes() and len(tw) == len(jw) == 17
    r = tg.BitReader(tw.to_bytes(), len(tw))
    assert r.get_bits(4) == 0b1011 and r.get_unary() == 5
    assert r.get_bits(7) == 3 and r.exhausted


def _hashes(rng, W, n, space):
    """Per-worker 64-bit key hashes with shared keys across workers."""
    keys = rng.integers(0, space, (W, n))
    return [[int((int(k) * 0x9E3779B97F4A7C15) & ((1 << 64) - 1))
             for k in row] for row in keys]


@pytest.mark.parametrize("W", [1, 2, 4])
def test_location_detection_is_the_reference_s(W):
    rng = np.random.default_rng(W)
    lh = _hashes(rng, W, 400, 2000)
    rh = _hashes(rng, W, 300, 2000)
    sides = []
    for mod in (tld, jld):
        a, b = mod.LocationDetection(W), mod.LocationDetection(W)
        wire = [(a.add_worker(w, lh[w]), b.add_worker(w, rh[w]))
                for w in range(W)]
        sides.append((a, b, wire))
    (ta, tb, twire), (ja, jb, jwire) = sides
    assert twire == jwire and all(x > 0 for pair in twire for x in pair)
    assert ta.common_hashes(tb) == ja.common_hashes(jb)
    probe = [h for row in lh + rh for h in row][:500] + [12345, 1 << 40]
    for h in probe:
        assert ta.workers_of(h) == ja.workers_of(h)
        assert ta.target_of(h) == ja.target_of(h)
        assert tb.target_of(h) == jb.target_of(h)


def test_fingerprint_messages_are_the_reference_s():
    rng = np.random.default_rng(7)
    for n in (0, 1, 50, 5000):
        fp = tld.fingerprint(int(x) for x in rng.integers(0, 1 << 62, n))
        assert np.array_equal(fp, jld.fingerprint(fp.tolist()))
        msg = tld.encode_fingerprint(fp)
        assert msg == jld.encode_fingerprint(fp)
        assert np.array_equal(tld.decode_fingerprint(msg),
                              jld.decode_fingerprint(msg))
        assert tld.decode_fingerprint(msg).tolist() == fp.tolist()
