"""The port's wire codec (``thrill_tpu_torch/net/wire.py``) against the
reference package's on the CPU.

Tolerance: exact. On one battery (ints small and past 64 bits, floats
with NaN and signed zeros, every numpy dtype as arrays and scalars, the
NARROW, DELTA and RICE column cases, nested containers, ``bytes`` and
``str``) the port's frames are byte-equal to the reference's, with and
without compression and through the scatter-gather parts; each package
decodes the other's frames; the mutual authentication of the two
packages' connections interoperates.
"""

import socket
import threading

import numpy as np
import pytest

from thrill_tpu.net import wire as jwire
from thrill_tpu.net.tcp import TcpConnection as JTcpConnection

from thrill_tpu_torch.net import wire
from thrill_tpu_torch.net.tcp import TcpConnection

DTYPES = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
          "uint32", "uint64", "float16", "float32", "float64", "complex64",
          "complex128"]


def _battery():
    rng = np.random.default_rng(0)
    cases = {
        "none": None, "true": True, "false": False, "zero": 0, "neg": -1,
        "big": 1 << 100, "negbig": -(1 << 100), "float": 3.5,
        "inf": float("inf"), "nan": float("nan"), "negzero": -0.0,
        "str": "héllo wörld", "bytes": b"\x00\xff" * 40,
        "bigbytes": bytes(range(256)) * 600,
        "tuple": (1, "a", None), "nested": [1, [2, [3, (4, {"k": b"v"})]]],
        "dict": {"a": 1, (1, 2): [3.0], 7: {"x": [None, True]}},
        "intlist": list(range(100)),
        "sorted_ints": sorted(int(x) for x in np.unique(
            rng.integers(0, 1 << 32, 2000))),
        "int_tuple": tuple(range(0, 4000, 3)),
        "mixed": [1, "a", 3.5] * 50,
        "narrow_i64": rng.integers(0, 1000, 2048).astype(np.int64),
        "narrow_negative": rng.integers(-100, 100, 2048).astype(np.int64),
        "rice": np.unique(rng.integers(0, 1 << 32, 4096).astype(np.int64)),
        "delta": np.sort(rng.integers(0, 1 << 40, 2048).astype(np.int64)),
        "constant": np.full(2048, 7, np.int64),
        "unsorted_wide": rng.integers(-(1 << 62), 1 << 62,
                                      2048).astype(np.int64),
        "u64_sorted": np.sort(rng.integers(0, 1 << 63, 512).astype(
            np.uint64) * np.uint64(2)),
        "twod": rng.integers(0, 50, (256, 16)).astype(np.int64),
        "empty": np.zeros(0, np.int64),
        "frame": {0: {1: list(range(100)),
                      2: rng.integers(0, 1000, 2048).astype(np.int64)}},
    }
    for dt in DTYPES:
        a = (rng.integers(0, 100, 300) % 2).astype(dt) if dt == "bool" \
            else rng.integers(0, 100, 300).astype(dt)
        cases["arr_" + dt] = a
        cases["arr2d_" + dt] = a.reshape(30, 10)
        cases["scalar_" + dt] = a[3]
    return cases


CASES = _battery()


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(a, np.generic):
        return (type(a) is type(b) and a.dtype == b.dtype
                and np.shape(a) == np.shape(b)
                and np.asarray(a).tobytes() == np.asarray(b).tobytes())
    if isinstance(a, float) and a != a:
        return isinstance(b, float) and b != b
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (type(b) is dict and list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, float):
        return type(b) is float and np.float64(a).tobytes() == \
            np.float64(b).tobytes()
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_frames_are_the_reference_s_bytes(name, compress):
    obj = CASES[name]
    mine = wire.dumps(obj, allow_pickle=False, compress=compress)
    assert mine == jwire.dumps(obj, allow_pickle=False, compress=compress)
    parts = b"".join(bytes(p) for p in wire.dumps_parts(
        obj, compress=compress))
    assert parts == b"".join(bytes(p) for p in jwire.dumps_parts(
        obj, compress=compress))
    # each package decodes the other's frame
    assert _same(wire.loads(mine), obj)
    assert _same(jwire.loads(mine), obj)
    assert _same(wire.loads(jwire.dumps(obj, compress=compress)), obj)


def test_compress_flag_off_is_the_reference_s(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_WIRE_COMPRESS", "0")
    frame = CASES["frame"]
    assert wire.dumps(frame) == jwire.dumps(frame) == \
        wire.dumps(frame, compress=False)
    monkeypatch.delenv("THRILL_TPU_WIRE_COMPRESS")
    assert wire.dumps(frame) == jwire.dumps(frame)
    assert len(wire.dumps(frame)) < len(wire.dumps(frame, compress=False))


def test_pickle_needs_authentication_as_in_the_reference():
    class Thing:
        pass

    for w in (wire, jwire):
        with pytest.raises(TypeError):
            w.dumps(Thing(), allow_pickle=False)
    obj = {"fn": slice(1, 2)}
    assert wire.dumps(obj, allow_pickle=True) == \
        jwire.dumps(obj, allow_pickle=True)
    forged = jwire.dumps(obj, allow_pickle=True)
    with pytest.raises(ValueError):
        wire.loads(forged, allow_pickle=False)
    assert wire.loads(forged, allow_pickle=True) == obj


def test_frame_macs_are_the_reference_s():
    parts = wire.dumps_parts(CASES["frame"])
    key = b"k" * 32
    assert wire.frame_mac_parts(key, b"c>", 7, parts) == \
        jwire.frame_mac_parts(key, b"c>", 7, parts)


@pytest.mark.parametrize("secret", [b"cluster-secret", b"other"])
def test_authentication_interoperates_with_the_reference(secret):
    """A port connection authenticates against a reference connection
    over a socketpair with the same secret, and both then exchange MACed
    frames; a wrong secret fails on both sides."""
    a, b = socket.socketpair()
    mine, theirs = TcpConnection(a), JTcpConnection(b)
    err = []

    def server():
        try:
            theirs.authenticate(b"cluster-secret", role="server")
            theirs.send(theirs.recv())
        except Exception as e:
            err.append(e)

    t = threading.Thread(target=server, daemon=True)
    t.start()
    try:
        if secret == b"cluster-secret":
            mine.authenticate(secret, role="client")
            mine.send(CASES["nested"])
            assert mine.recv() == CASES["nested"]
        else:
            with pytest.raises(Exception):
                mine.authenticate(secret, role="client")
    finally:
        mine.close()
        t.join(timeout=10)
        theirs.close()
    assert not t.is_alive()
    assert bool(err) == (secret != b"cluster-secret")
