"""Non-executing wire codec + HMAC connection authentication
(counterpart of the reference package's ``net/wire.py``: the same
frames, byte for byte).

The control-plane sockets (net/tcp.py) originally framed raw pickle —
any process able to reach the port could execute code via a crafted
payload. This module provides:

- ``dumps``/``loads``: a small self-describing binary codec for the
  values collectives actually ship (None, bool, int, float, str, bytes,
  tuple, list, dict, numpy scalars/arrays). Decoding never executes
  code. Arbitrary objects are only ever pickled when the connection is
  *authenticated* (``allow_pickle=True``), and an unauthenticated
  receiver refuses pickle frames outright.
- ``mutual_auth``: role-bound HMAC-SHA256 challenge-response in both
  directions over a shared secret, modeled on
  multiprocessing.connection's deliver/answer challenge (role binding
  defeats reflection).

Reference analog: the reference trusts its cluster network (raw
sockets, thrill/net/tcp/construct.cpp); we keep the trusted-cluster
fast path but gate code-executing deserialization behind the secret.
"""

from __future__ import annotations

import hmac
import io
import os
import pickle
import struct
import threading
from typing import Any, Callable, Optional, Tuple

import numpy as np

_MAX_DEPTH = 100

# type tags
_T_NONE = b"N"
_T_TRUE = b"T"
_T_FALSE = b"F"
_T_INT = b"I"       # signed big int: 4-byte len + bytes
_T_FLOAT = b"f"     # 8-byte double
_T_STR = b"s"
_T_BYTES = b"b"
_T_TUPLE = b"t"
_T_LIST = b"l"
_T_DICT = b"d"
_T_NDARRAY = b"a"   # dtype-str, shape, raw bytes
_T_NPSCALAR = b"n"  # dtype-str, raw bytes
_T_PICKLE = b"P"    # authenticated connections only
_T_COMPRESSED = b"C"  # compressed integer column (see _compress_column)

# -- frame compression (the shrink-the-wire host plane) -----------------
#
# Integer columns — ndarrays and homogeneous int lists/tuples — can ride
# one of three self-describing codecs instead of their raw bytes:
#
#   NARROW  min/max fit a narrower dtype: ship the cast (u8..i32), the
#           receiver casts back — exact for in-range ints by definition.
#   DELTA   monotone non-decreasing 1-D column: ship the first value +
#           the narrowed gaps (sorted splitters, offsets, cumsums).
#   RICE    strictly increasing non-negative 1-D column: delta + Rice
#           coded bit stream (core/golomb.py) — the reference's Golomb
#           CatStream for LocationDetection/DuplicateDetection hash
#           fingerprints (thrill/core/golomb_bit_stream.hpp:29).
#
# The encoder picks the smallest candidate per column and falls back to
# the raw tags whenever nothing shrinks; the decoder accepts every
# scheme unconditionally (decoding never executes code, same stance as
# the rest of this module). Floats are NEVER compressed — NaN payloads
# and signed zeros must round-trip bit-identically, and no narrowing is
# exact for them. THRILL_TPU_WIRE_COMPRESS=0 restores the pre-codec
# frames byte-identically (no _T_COMPRESSED tag is ever emitted).

_SCHEME_NARROW = 1
_SCHEME_DELTA = 2
_SCHEME_RICE = 3
_CONT_NDARRAY = 0
_CONT_LIST = 1
_CONT_TUPLE = 2

_COMPRESS_MIN_BYTES = 256        # tiny columns: headers beat savings
_COMPRESS_MIN_ITEMS = 32

_STATS_LOCK = threading.Lock()
_STATS = {"columns": 0, "bytes_raw": 0, "bytes_out": 0}

try:
    from ..common import faults as _faults
    _F_COMPRESS = _faults.declare("net.wire.compress")
except Exception:                # standalone import in codec tests
    _faults = None
    _F_COMPRESS = None


def compress_enabled() -> bool:
    """THRILL_TPU_WIRE_COMPRESS=0 disables the per-frame column codec:
    dumps() output is then byte-identical to the pre-codec wire format
    (master switch for the host plane; the device plane's row
    narrowing has its own sub-knob, data/exchange.py). One parser for
    the flag — config.wire_compress_enabled — so the master switch can
    never split across the two planes; the inline fallback only serves
    standalone codec imports."""
    try:
        from ..common.config import wire_compress_enabled
        return wire_compress_enabled()
    except Exception:
        v = os.environ.get("THRILL_TPU_WIRE_COMPRESS")
        return v not in ("0", "off", "false")


def compress_stats() -> Tuple[int, int, int]:
    """(columns compressed, raw bytes they held, bytes shipped) —
    process-wide; the multiplexer snapshots deltas around an exchange
    to attribute savings to its mesh (wire_compress_ratio)."""
    with _STATS_LOCK:
        return (_STATS["columns"], _STATS["bytes_raw"],
                _STATS["bytes_out"])


def _note_compressed(raw: int, out: int) -> None:
    with _STATS_LOCK:
        _STATS["columns"] += 1
        _STATS["bytes_raw"] += raw
        _STATS["bytes_out"] += out


_NARROW_LADDER = (np.dtype(np.uint8), np.dtype(np.int8),
                  np.dtype(np.uint16), np.dtype(np.int16),
                  np.dtype(np.uint32), np.dtype(np.int32))


def narrow_dtype(lo: int, hi: int, itemsize: int) -> Optional[np.dtype]:
    """Smallest ladder dtype holding [lo, hi], if strictly narrower."""
    for d in _NARROW_LADDER:
        if d.itemsize >= itemsize:
            return None
        info = np.iinfo(d)
        if info.min <= lo and hi <= info.max:
            return d
    return None


def _compress_column(a: np.ndarray) -> Optional[bytes]:
    """Best compressed payload for an integer column, or None when raw
    wins. Returned bytes are everything AFTER the _T_COMPRESSED tag and
    the container/original-dtype/shape header."""
    n = a.size
    flat = a.reshape(-1)
    lo, hi = int(flat.min()), int(flat.max())
    isz = a.dtype.itemsize
    best: Optional[bytes] = None

    nd = narrow_dtype(lo, hi, isz)
    if nd is not None:
        body = io.BytesIO()
        body.write(bytes([_SCHEME_NARROW]))
        _w_bytes(body, nd.str.encode())
        body.write(flat.astype(nd, copy=False).tobytes())
        best = body.getvalue()

    # Rice/delta code through int64 math: u64 values past int64.max
    # (and their gaps) would wrap — those columns only get NARROW
    if a.ndim == 1 and n >= 2 and hi <= np.iinfo(np.int64).max \
            and lo >= np.iinfo(np.int64).min:
        gaps = np.diff(flat.astype(np.int64))
        gmin, gmax = int(gaps.min()), int(gaps.max())
        if gmin >= 0:                        # monotone non-decreasing
            if gmin > 0 and lo >= 0:
                # strictly increasing: the Rice stream (mean-gap k)
                from ..core.golomb import encode_sorted_np, rice_parameter
                k = rice_parameter(max((hi - lo) / max(n - 1, 1), 1.0))
                # unary blowup guard: a few giant gaps in an otherwise
                # dense column would code to huge runs — bound total
                # unary bits to ~4/value before paying the encode
                if int(np.sum(gaps >> k)) + (int(flat[0]) >> k) \
                        <= 4 * n + 64:
                    payload, nbits, count = encode_sorted_np(flat, k)
                    body = io.BytesIO()
                    body.write(bytes([_SCHEME_RICE, k]))
                    struct_pack = struct.pack
                    body.write(struct_pack("<QI", nbits, count))
                    _w_bytes(body, payload)
                    cand = body.getvalue()
                    if best is None or len(cand) < len(best):
                        best = cand
            gd = narrow_dtype(0, gmax, isz)
            if gd is not None:
                body = io.BytesIO()
                body.write(bytes([_SCHEME_DELTA]))
                body.write(struct.pack("<q", int(flat[0])))
                _w_bytes(body, gd.str.encode())
                body.write(gaps.astype(gd, copy=False).tobytes())
                cand = body.getvalue()
                if best is None or len(cand) < len(best):
                    best = cand

    if best is not None and len(best) < a.nbytes:
        return best
    return None


def _try_compress_ndarray(a: np.ndarray) -> Optional[bytes]:
    """Full _T_COMPRESSED frame body for an ndarray (container +
    original dtype + shape + scheme payload), or None."""
    if (a.dtype.kind not in "iu" or a.dtype.itemsize < 2
            or a.nbytes < _COMPRESS_MIN_BYTES or a.size == 0):
        return None
    if _faults is not None and _faults.REGISTRY.active():
        try:
            _faults.check(_F_COMPRESS)
        except _faults.InjectedFault:
            # degrade, never fail the frame: the raw tags are always
            # a correct encoding of the same column
            _faults.note("recovery", what="wire.compress_degrade")
            return None
    payload = _compress_column(np.ascontiguousarray(a))
    if payload is None:
        return None
    head = io.BytesIO()
    head.write(bytes([_CONT_NDARRAY]))
    _w_bytes(head, a.dtype.str.encode())
    _w_len(head, a.ndim)
    for d in a.shape:
        _w_len(head, d)
    head.write(payload)
    out = head.getvalue()
    if len(out) >= a.nbytes:
        return None
    _note_compressed(a.nbytes, len(out))
    return out


def _try_compress_intseq(obj) -> Optional[bytes]:
    """_T_COMPRESSED body for a homogeneous list/tuple of python ints
    (the fingerprint/hash-list frames), or None."""
    if len(obj) < _COMPRESS_MIN_ITEMS:
        return None
    for x in obj:
        if type(x) is not int:
            return None
    try:
        a = np.asarray(obj, dtype=np.int64)
    except OverflowError:
        return None
    if _faults is not None and _faults.REGISTRY.active():
        try:
            _faults.check(_F_COMPRESS)
        except _faults.InjectedFault:
            _faults.note("recovery", what="wire.compress_degrade")
            return None
    payload = _compress_column(a)
    if payload is None:
        return None
    head = io.BytesIO()
    head.write(bytes([_CONT_LIST if type(obj) is list else _CONT_TUPLE]))
    _w_bytes(head, a.dtype.str.encode())
    _w_len(head, 1)
    _w_len(head, len(obj))
    head.write(payload)
    out = head.getvalue()
    # raw equivalent: each int costs 1 tag + 4 len + ~9 value bytes
    _note_compressed(14 * len(obj), len(out))
    return out


def _decode_compressed(r: "_Reader") -> Any:
    cont = r.take(1)[0]
    dtype = np.dtype(r.take_bytes().decode())
    if dtype.hasobject:
        raise ValueError("wire: object dtype refused")
    ndim = r.take_len()
    shape = tuple(r.take_len() for _ in range(ndim))
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    scheme = r.take(1)[0]
    if scheme == _SCHEME_NARROW:
        nd = np.dtype(r.take_bytes().decode())
        flat = np.frombuffer(r.take(n * nd.itemsize), dtype=nd)
        flat = flat.astype(dtype)
    elif scheme == _SCHEME_DELTA:
        if n < 1:
            # the encoder only emits DELTA for n >= 2; a forged n of 0
            # would turn the gaps read into a negative (rewinding) take
            raise ValueError("wire: delta column size mismatch")
        (first,) = struct.unpack("<q", r.take(8))
        gd = np.dtype(r.take_bytes().decode())
        gaps = np.frombuffer(r.take((n - 1) * gd.itemsize), dtype=gd)
        flat = np.empty(n, dtype=np.int64)
        flat[0] = first
        flat[1:] = first + np.cumsum(gaps.astype(np.int64))
        flat = flat.astype(dtype)
    elif scheme == _SCHEME_RICE:
        k = r.take(1)[0]
        nbits, count = struct.unpack("<QI", r.take(12))
        payload = r.take_bytes()          # bounded by the real buffer
        # validate the CLAIMED sizes before allocating by them: every
        # value consumes at least one bit, and the bit count must fit
        # the payload actually present — a forged count/nbits must not
        # drive allocation (decoding stays payload-bounded, like the
        # raw ndarray path)
        if count != n or nbits > 8 * len(payload) or count > nbits:
            raise ValueError("wire: Rice column size mismatch")
        from ..core.golomb import decode_sorted_np
        flat = decode_sorted_np(payload, int(nbits), int(count),
                                int(k)).astype(dtype)
    else:
        raise ValueError(f"wire: unknown compression scheme {scheme}")
    if flat.shape[0] != n:
        raise ValueError("wire: compressed column size mismatch")
    if cont == _CONT_NDARRAY:
        return flat.reshape(shape).copy()
    vals = [int(x) for x in flat]
    return vals if cont == _CONT_LIST else tuple(vals)


def _w_len(buf: io.BytesIO, n: int) -> None:
    buf.write(struct.pack("<I", n))


def _w_bytes(buf: io.BytesIO, b: bytes) -> None:
    _w_len(buf, len(b))
    buf.write(b)


def _encode(buf: io.BytesIO, obj: Any, allow_pickle: bool,
            depth: int, compress: bool = False) -> None:
    if depth > _MAX_DEPTH:
        raise ValueError("wire: nesting too deep")
    if obj is None:
        buf.write(_T_NONE)
    elif obj is True:
        buf.write(_T_TRUE)
    elif obj is False:
        buf.write(_T_FALSE)
    elif type(obj) is int:
        raw = obj.to_bytes((obj.bit_length() + 8) // 8 + 1, "little",
                           signed=True)
        buf.write(_T_INT)
        _w_bytes(buf, raw)
    elif type(obj) is float:
        buf.write(_T_FLOAT)
        buf.write(struct.pack("<d", obj))
    elif type(obj) is str:
        buf.write(_T_STR)
        _w_bytes(buf, obj.encode("utf-8"))
    elif type(obj) is bytes:
        buf.write(_T_BYTES)
        _w_bytes(buf, obj)
    elif type(obj) is tuple or type(obj) is list:
        if compress:
            body = _try_compress_intseq(obj)
            if body is not None:
                buf.write(_T_COMPRESSED)
                buf.write(body)
                return
        buf.write(_T_TUPLE if type(obj) is tuple else _T_LIST)
        _w_len(buf, len(obj))
        for x in obj:
            _encode(buf, x, allow_pickle, depth + 1, compress)
    elif type(obj) is dict:
        buf.write(_T_DICT)
        _w_len(buf, len(obj))
        for k, v in obj.items():
            _encode(buf, k, allow_pickle, depth + 1, compress)
            _encode(buf, v, allow_pickle, depth + 1, compress)
    elif isinstance(obj, np.ndarray) and obj.dtype.hasobject is False:
        a = np.ascontiguousarray(obj)
        if compress:
            body = _try_compress_ndarray(a)
            if body is not None:
                buf.write(_T_COMPRESSED)
                buf.write(body)
                return
        buf.write(_T_NDARRAY)
        _w_bytes(buf, a.dtype.str.encode())
        _w_len(buf, a.ndim)
        for d in a.shape:
            _w_len(buf, d)
        _w_bytes(buf, a.tobytes())
    elif isinstance(obj, np.generic) and not isinstance(obj, np.object_):
        buf.write(_T_NPSCALAR)
        _w_bytes(buf, obj.dtype.str.encode())
        _w_bytes(buf, obj.tobytes())
    elif allow_pickle:
        buf.write(_T_PICKLE)
        _w_bytes(buf, pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
    else:
        raise TypeError(
            f"wire: refusing to send {type(obj).__name__} over an "
            f"unauthenticated connection (set THRILL_TPU_SECRET on all "
            f"hosts to enable pickled payloads)")


def dumps(obj: Any, allow_pickle: bool = False,
          compress: Optional[bool] = None) -> bytes:
    if compress is None:
        compress = compress_enabled()
    buf = io.BytesIO()
    _encode(buf, obj, allow_pickle, 0, compress)
    return buf.getvalue()


# payloads at least this large take the zero-copy parts path
_BIG_PAYLOAD = 1 << 16


def dumps_parts(obj: Any, allow_pickle: bool = False,
                compress: Optional[bool] = None) -> list:
    """Encode to a LIST of buffers whose concatenation equals
    ``dumps(obj)``. Large ``bytes`` and numpy-array payloads are
    returned as borrowed views instead of being copied into one
    contiguous buffer — senders with scatter-gather I/O (sendmsg, the
    async engine's per-buffer writes) skip the O(size) framing copies
    entirely. A big integer ndarray that the column codec shrinks
    takes the compressed (copying) form instead — fewer wire bytes
    beat a saved framing copy."""
    if compress is None:
        compress = compress_enabled()
    if type(obj) is bytes and len(obj) >= _BIG_PAYLOAD:
        head = io.BytesIO()
        head.write(_T_BYTES)
        _w_len(head, len(obj))
        return [head.getvalue(), obj]
    if (isinstance(obj, np.ndarray) and obj.dtype.hasobject is False
            and obj.nbytes >= _BIG_PAYLOAD):
        a = np.ascontiguousarray(obj)
        if compress:
            body = _try_compress_ndarray(a)
            if body is not None:
                return [_T_COMPRESSED + body]
        head = io.BytesIO()
        head.write(_T_NDARRAY)
        _w_bytes(head, a.dtype.str.encode())
        _w_len(head, a.ndim)
        for d in a.shape:
            _w_len(head, d)
        _w_len(head, a.nbytes)
        return [head.getvalue(), a.data.cast("B")]
    return [dumps(obj, allow_pickle, compress=compress)]


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError("wire: truncated frame")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def take_len(self) -> int:
        (n,) = struct.unpack("<I", self.take(4))
        return n

    def take_bytes(self) -> bytes:
        return self.take(self.take_len())


def _decode(r: _Reader, allow_pickle: bool, depth: int) -> Any:
    if depth > _MAX_DEPTH:
        raise ValueError("wire: nesting too deep")
    tag = r.take(1)
    if tag == _T_NONE:
        return None
    if tag == _T_TRUE:
        return True
    if tag == _T_FALSE:
        return False
    if tag == _T_INT:
        return int.from_bytes(r.take_bytes(), "little", signed=True)
    if tag == _T_FLOAT:
        return struct.unpack("<d", r.take(8))[0]
    if tag == _T_STR:
        return r.take_bytes().decode("utf-8")
    if tag == _T_BYTES:
        return r.take_bytes()
    if tag in (_T_TUPLE, _T_LIST):
        n = r.take_len()
        items = [_decode(r, allow_pickle, depth + 1) for _ in range(n)]
        return tuple(items) if tag == _T_TUPLE else items
    if tag == _T_DICT:
        n = r.take_len()
        return {_decode(r, allow_pickle, depth + 1):
                _decode(r, allow_pickle, depth + 1) for _ in range(n)}
    if tag == _T_NDARRAY:
        dtype = np.dtype(r.take_bytes().decode())
        if dtype.hasobject:
            raise ValueError("wire: object dtype refused")
        ndim = r.take_len()
        shape = tuple(r.take_len() for _ in range(ndim))
        # .copy(): frombuffer views are read-only; receivers expect
        # writable arrays (parity with the former pickle format)
        return np.frombuffer(r.take_bytes(),
                             dtype=dtype).reshape(shape).copy()
    if tag == _T_NPSCALAR:
        dtype = np.dtype(r.take_bytes().decode())
        if dtype.hasobject:
            raise ValueError("wire: object dtype refused")
        return np.frombuffer(r.take_bytes(), dtype=dtype).copy()[0]
    if tag == _T_COMPRESSED:
        # decoding a compressed column never executes code (pure
        # numpy casts + the Rice bit stream), so it is accepted on
        # unauthenticated connections exactly like _T_NDARRAY
        return _decode_compressed(r)
    if tag == _T_PICKLE:
        if not allow_pickle:
            raise ValueError(
                "wire: pickle frame refused on unauthenticated "
                "connection")
        return pickle.loads(r.take_bytes())
    raise ValueError(f"wire: unknown tag {tag!r}")


def loads(data: bytes, allow_pickle: bool = False) -> Any:
    r = _Reader(data)
    obj = _decode(r, allow_pickle, 0)
    if r.pos != len(r.data):
        raise ValueError("wire: trailing bytes in frame")
    return obj


# -- HMAC challenge-response (both directions) --------------------------

_CHALLENGE_LEN = 32


class AuthError(ConnectionError):
    """HMAC authentication failure (definitive, not transient)."""


def secret_from_env() -> Optional[bytes]:
    s = os.environ.get("THRILL_TPU_SECRET")
    return s.encode("utf-8") if s else None


def _answer(secret: bytes, role: bytes, challenge: bytes) -> bytes:
    return hmac.new(secret, role + b":" + challenge, "sha256").digest()


def mutual_auth(secret: bytes, role: str,
                send_raw: Callable[[bytes], None],
                recv_raw: Callable[[int], bytes]) -> bytes:
    """Run a mutual challenge-response over raw framed I/O.

    Both sides issue a random challenge and verify the peer's HMAC
    answer; either side raises on mismatch. The answering side's *role*
    ("client" = dialer, "server" = acceptor) is bound into the MAC, so
    reflecting a side's own challenge back at it yields an answer keyed
    to the wrong role and fails verification (no reflection attack).
    ``send_raw`` writes a fixed-size blob, ``recv_raw(n)`` reads
    exactly n bytes.

    Returns the derived per-connection *session key* — the handshake
    only proves who is at each end; every subsequent frame must carry a
    MAC under this key (``frame_mac``) or an on-path attacker could
    inject a pickle frame into the authenticated stream.
    """
    if role not in ("client", "server"):
        raise ValueError(f"wire: bad auth role {role!r}")
    my_role = role.encode()
    peer_role = b"server" if role == "client" else b"client"
    my_challenge = os.urandom(_CHALLENGE_LEN)
    send_raw(my_challenge)
    peer_challenge = recv_raw(_CHALLENGE_LEN)
    if hmac.compare_digest(peer_challenge, my_challenge):
        raise AuthError("wire: reflected challenge")
    send_raw(_answer(secret, my_role, peer_challenge))
    peer_answer = recv_raw(32)
    if not hmac.compare_digest(
            peer_answer, _answer(secret, peer_role, my_challenge)):
        raise AuthError("wire: HMAC authentication failed")
    client_chal = my_challenge if role == "client" else peer_challenge
    server_chal = peer_challenge if role == "client" else my_challenge
    return hmac.new(secret, b"session:" + client_chal + server_chal,
                    "sha256").digest()


_MAC_LEN = 16


def frame_mac(session_key: bytes, direction: bytes, seq: int,
              payload: bytes) -> bytes:
    """Per-frame MAC: binds session key, direction and sequence number
    (anti-injection + anti-replay + anti-reorder)."""
    return frame_mac_parts(session_key, direction, seq, [payload])


def frame_mac_parts(session_key: bytes, direction: bytes, seq: int,
                    parts) -> bytes:
    """``frame_mac`` over a payload given as buffer parts (the
    scatter-gather send path) — hmac streams, no concatenation."""
    h = hmac.new(session_key, direction + seq.to_bytes(8, "little"),
                 "sha256")
    for p in parts:
        h.update(p)
    return h.digest()[:_MAC_LEN]
