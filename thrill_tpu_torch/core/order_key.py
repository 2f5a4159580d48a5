"""Order-preserving byte encodings of sort keys (counterpart of the
reference package's ``core/order_key.py``).

The host Sort spills sorted runs and k-way merges them. Comparing
Python keys per item in that merge is slow; these encoders map the
common key schemas (str, bytes, ints in the int64 range, floats and
(nested) tuples of them) to byte strings whose memcmp order is Python's
order, so the merge runs in C++ over bytes (``native/mwmerge.cpp``) and
a run sorts plain bytes objects.

Encodings (each self-delimiting, so a tuple's concatenation compares
element by element and a prefix compares smaller, as in Python):

* bytes/str: 0x00 escaped as 0x00 0xFF, then a 0x00 terminator (str as
  UTF-8 first, whose byte order is code-point order);
* int in [-2**63, 2**63): 8 bytes big-endian of value + 2**63;
* float: 8 bytes big-endian of the monotone IEEE-754 transform;
* tuple: the concatenation of its elements' encodings.

The schema comes from one sample key; the encoder raises
:class:`OrderKeyError` on a later key that deviates (another type, an
int overflow, another tuple arity), and the caller falls back to Python
comparisons. A position mixing int and float encodes as float when the
int is exactly representable, else raises.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Optional

import numpy as np


class OrderKeyError(TypeError):
    """Key does not fit the schema probed from the first item."""


def _enc_bytes(b: bytes) -> bytes:
    return b.replace(b"\x00", b"\x00\xff") + b"\x00"


def _enc_int(v: int) -> bytes:
    if not -(1 << 63) <= v < (1 << 63):
        raise OrderKeyError(f"int out of int64 range: {v}")
    return struct.pack(">Q", v + (1 << 63))


_F64 = struct.Struct(">d")
_Q = struct.Struct(">Q")


def _enc_float(v: float) -> bytes:
    if v == 0:
        v = 0.0        # -0.0 == 0.0 in Python: one encoding for both
    (bits,) = _Q.unpack(_F64.pack(v))
    if bits >> 63:
        bits = ~bits & 0xFFFFFFFFFFFFFFFF
    else:
        bits |= 1 << 63
    return _Q.pack(bits)


def _enc_numeric(v) -> bytes:
    """Mixed int/float position: compare as floats, exactly or not at
    all."""
    if isinstance(v, float):
        return _enc_float(v)
    if isinstance(v, int):
        f = float(v)
        if int(f) != v:
            raise OrderKeyError(f"int {v} not exactly representable "
                                f"as float in mixed numeric key")
        return _enc_float(f)
    raise OrderKeyError(f"non-numeric {type(v).__name__} in numeric key")


def _schema_of(key: Any):
    if isinstance(key, (np.generic,)):
        key = key.item()
    if isinstance(key, bytes):
        return "bytes"
    if isinstance(key, str):
        return "str"
    if isinstance(key, bool):
        return "int"                   # bool is an int in comparisons
    if isinstance(key, int):
        return "int"
    if isinstance(key, float):
        return "float"
    if isinstance(key, tuple):
        return ("tuple", tuple(_schema_of(e) for e in key))
    raise OrderKeyError(f"unsupported key type {type(key).__name__}")


def _encoder_for(schema) -> Callable[[Any], bytes]:
    if schema == "bytes":
        def enc(k):
            if isinstance(k, np.generic):
                k = k.item()
            if not isinstance(k, bytes):
                raise OrderKeyError(f"expected bytes, got "
                                    f"{type(k).__name__}")
            return _enc_bytes(k)
        return enc
    if schema == "str":
        def enc(k):
            if isinstance(k, np.generic):
                k = k.item()
            if not isinstance(k, str):
                raise OrderKeyError(f"expected str, got "
                                    f"{type(k).__name__}")
            return _enc_bytes(k.encode("utf-8"))
        return enc
    if schema == "int":
        def enc(k):
            if isinstance(k, np.generic):
                k = k.item()
            if isinstance(k, int):          # bool included
                return _enc_int(k)
            # an int-schema position meeting a float: re-route both
            # sides through the numeric encoding
            if isinstance(k, float):
                raise _MixedNumeric()
            raise OrderKeyError(f"expected int, got {type(k).__name__}")
        return enc
    if schema == "float":
        def enc(k):
            if isinstance(k, np.generic):
                k = k.item()
            return _enc_numeric(k)
        return enc
    if isinstance(schema, tuple) and schema[0] == "tuple":
        subs = [_encoder_for(s) for s in schema[1]]

        def enc(k):
            if not isinstance(k, tuple) or len(k) != len(subs):
                raise OrderKeyError(
                    f"expected {len(subs)}-tuple, got {k!r:.60}")
            return b"".join(e(v) for e, v in zip(subs, k))
        return enc
    raise OrderKeyError(f"no encoder for schema {schema!r}")


class _MixedNumeric(Exception):
    """Signal: int-schema met a float; retry with the float schema."""


def make_encoder(sample_key: Any) -> Optional[Callable[[Any], bytes]]:
    """Encoder for ``sample_key``'s schema, or None if unsupported.

    The returned callable raises :class:`OrderKeyError` for keys that
    do not fit the schema. An int-schema position that later meets a
    float widens to the numeric (float) schema transparently — but the
    WIDENING invalidates earlier encodings, so it raises
    ``OrderKeyError`` too; callers treat it as a schema mismatch."""
    try:
        schema = _schema_of(sample_key)
        enc = _encoder_for(schema)
        enc(sample_key)                    # self-check on the sample
        return enc
    except (OrderKeyError, _MixedNumeric, UnicodeError):
        return None


def encode_or_raise(enc: Callable[[Any], bytes], key: Any) -> bytes:
    try:
        return enc(key)
    except _MixedNumeric:
        raise OrderKeyError("int key position met a float key")


#: everything an encoder call can raise on a schema deviation — batch
#: callers catch this tuple around a whole-run listcomp instead of
#: paying a wrapper call per item
ENCODE_ERRORS = (OrderKeyError, _MixedNumeric, UnicodeError)

#: the batch encoders below additionally surface deviations as the
#: underlying C-level errors (struct.error is a Exception subclass)
BATCH_ENCODE_ERRORS = ENCODE_ERRORS + (AttributeError, TypeError,
                                       struct.error, OverflowError)

_PK = _Q.pack
_BIAS = 1 << 63


def _pos_rows(pos0: int, n: int) -> "np.ndarray":
    """[n, 8] uint8 big-endian rows of positions pos0..pos0+n-1."""
    import numpy as np
    # astype to an EXPLICIT big-endian dtype is endian-correct on any
    # host (native dtypes report byteorder '=', so a != '>' test would
    # byteswap wrongly on big-endian machines)
    p = np.arange(pos0, pos0 + n, dtype=np.uint64).astype(">u8")
    return p.view(np.uint8).reshape(n, 8)


def make_array_batch_encoder(sample_key: Any):
    """Vectorized sibling of :func:`make_batch_encoder`:
    ``g(keys_list, pos0) -> np.ndarray(S{w}) | None``, producing the
    same bytes per key as the listcomp encoder but as rows of one
    fixed-width numpy array, with no per-item Python object, so the
    Sort's run formation (encode and order) stays in C (an argsort of
    the S view is memcmp). Returns a callable for int and str
    schemas, else None. The callable returns None for a batch it cannot
    vectorize exactly (non-ASCII, unequal lengths, embedded NULs —
    where escaping/termination make widths vary); the caller then uses
    the listcomp encoder for that batch. Schema DEVIATIONS raise
    ``BATCH_ENCODE_ERRORS`` exactly like the listcomp encoder."""
    import numpy as np
    try:
        schema = _schema_of(sample_key)
    except OrderKeyError:
        return None
    if schema == "int" and type(sample_key) in (int, bool):
        def g(keys, pos0):
            if set(map(type, keys)) - {int, bool}:
                raise OrderKeyError("non-int key in int batch")
            n = len(keys)
            # OverflowError (in BATCH_ENCODE_ERRORS) on > int64 range
            a = np.fromiter(keys, dtype=np.int64, count=n)
            biased = (a.view(np.uint64)
                      + np.uint64(_BIAS)).astype(">u8")  # wraps: k+BIAS
            out = np.empty((n, 16), dtype=np.uint8)
            out[:, :8] = biased.view(np.uint8).reshape(n, 8)
            out[:, 8:] = _pos_rows(pos0, n)
            return out.reshape(-1).view("S16")   # zero-copy rows view
        return g
    if schema == "str" and type(sample_key) is str:
        # Variable-length batches emit NUL-PADDED rows: row i is
        # content + \x00 terminator + 8-byte pos + zero padding to the
        # batch max. Padding is ORDER-SAFE against both padded rows of
        # any width and the exact variable-length kbs (mixed runs /
        # splitters): content bytes are NUL-free (the exact encoder
        # escapes \x00, and batches containing NULs fall back), so the
        # first memcmp mismatch always lands in content, terminator, or
        # the globally-unique pos field — never in padding — and there
        # it agrees with the variable-length comparison byte for byte.
        # Data rows carry globally-unique positions, so no data-data
        # comparison ever reaches the pads with everything equal; the
        # one same-(key, pos) pairing that exists — a splitter kb
        # against its own sampled twin row — ties toward the exact
        # (shorter, prefix) form, which only shifts that one item
        # across a partition boundary, never breaking sortedness.
        def g(keys, pos0):
            if set(map(type, keys)) - {str}:
                raise OrderKeyError("non-str key in str batch")
            n = len(keys)
            u = np.array(keys)
            try:
                s = u.astype(f"S{max(u.dtype.itemsize // 4, 1)}")
            except (UnicodeEncodeError, UnicodeError):
                return None                  # non-ASCII: listcomp batch
            w = s.dtype.itemsize
            view = s.view(np.uint8).reshape(n, w)
            nz = view != 0
            # content NULs (the exact encoder escapes them, changing
            # widths) make padding ambiguous — detect and fall back:
            # an interior zero followed by a nonzero byte, or a key
            # ENDING in U+0000 (its padding-like suffix would encode
            # differently), cannot take this path
            if (~nz[:, :-1] & nz[:, 1:]).any():
                return None
            lens = np.count_nonzero(nz, axis=1)
            # numpy's U dtype itself drops trailing NULs at np.array(),
            # so compare against the PYTHON lengths: any key whose true
            # length disagrees (trailing U+0000) must fall back
            if (lens != np.fromiter(map(len, keys), dtype=np.int64,
                                    count=n)).any():
                return None
            out = np.zeros((n, w + 9), dtype=np.uint8)
            out[:, :w] = view                # content, zero-padded
            rows = np.arange(n)
            # terminator is the zero already at out[rows, lens]; the
            # pos field lands right after it, pads stay zero
            out[rows[:, None],
                lens[:, None] + 1 + np.arange(8)] = _pos_rows(pos0, n)
            return out.reshape(-1).view(f"S{w + 9}")  # zero-copy view
        return g
    return None


def make_batch_encoder(sample_key: Any):
    """Batch encoder ``fn(keys_list, positions) -> list[bytes]`` where
    each output is the order encoding of the key plus an 8-byte
    big-endian position suffix (the Sort's stability and splitter
    tie-break). Flat str/bytes/int schemas run as one type-checked
    listcomp with no per-item Python dispatch.
    Other schemas wrap the per-item encoder in a single comp. Returns
    None when the schema is unsupported; raises a member of
    ``BATCH_ENCODE_ERRORS`` on any later schema deviation (the caller
    demotes to the generic merge)."""
    try:
        schema = _schema_of(sample_key)
    except OrderKeyError:
        return None
    # exact-type specializations only (a numpy-scalar sample routes to
    # the per-item branch, which unboxes it); the up-front set(map(type))
    # pass is one C-level scan that keeps look-alike custom key types
    # (anything with .encode/.replace) out of the fast comp
    if schema == "str" and type(sample_key) is str:
        def f(keys, poss):
            if set(map(type, keys)) - {str}:
                raise OrderKeyError("non-str key in str batch")
            return [k.encode("utf-8").replace(b"\x00", b"\x00\xff")
                    + b"\x00" + _PK(p)
                    for k, p in zip(keys, poss)]
    elif schema == "bytes" and type(sample_key) is bytes:
        def f(keys, poss):
            if set(map(type, keys)) - {bytes}:
                raise OrderKeyError("non-bytes key in bytes batch")
            return [k.replace(b"\x00", b"\x00\xff") + b"\x00" + _PK(p)
                    for k, p in zip(keys, poss)]
    elif schema == "int" and type(sample_key) in (int, bool):
        def f(keys, poss):
            if set(map(type, keys)) - {int, bool}:
                raise OrderKeyError("non-int key in int batch")
            # struct.error surfaces out-of-int64-range values
            return [_PK(k + _BIAS) + _PK(p)
                    for k, p in zip(keys, poss)]
    else:
        enc = _encoder_for(schema)

        def f(keys, poss):
            return [enc(k) + _PK(p) for k, p in zip(keys, poss)]
    try:
        got = f([sample_key], [0])          # self-check on the sample
        per_item = make_encoder(sample_key)
        if per_item is None or got[0] != per_item(sample_key) + _PK(0):
            return None
    except BATCH_ENCODE_ERRORS:
        return None
    return f
