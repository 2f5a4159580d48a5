"""Unsigned user columns wider than a byte (ROADMAP.md fault C22).

torch has ``uint16``, ``uint32`` and ``uint64`` tensors but few kernels
for them (no ``index_select``, arithmetic, compares or ``scatter_reduce``
on the CPU). The port keeps such a column in its torch unsigned type, so
the element type reaches the host unchanged (``AllGather`` and
``AllGatherArrays`` give numpy ``uint`` arrays, as the reference's do),
and moves it as the signed type of the same width, bit for bit
(:func:`signed`).

A call whose inputs hold such a column runs under :class:`UnsignedMode`:
a program dispatch whose arguments hold one (:func:`scope_for`), an
action's fold, and a node's compute from the first pulled input that
holds one (:func:`node_scope`, :func:`on_pull`). There the port's own
code and a user function (a Map, a Filter, a key or a fold) compute on
it as the reference's unsigned arrays do: ``x + 1``, ``x * c``,
``x // c``, ``x % c``, shifts and the bitwise ops wrap at the column's
width and stay unsigned; ``x > c`` and the other compares, ``min``,
``max``, ``clamp``, sorting and the ``amin``/``amax`` scatters read the
unsigned value; the conversion to a float type reads it too; a sum
without a type is a uint64 one, as numpy's. In-place ops that only move
or add bits write them through the signed views; any other in-place op
computes out of place and writes the result's bits back. Values travel
as :class:`UInt`, int64 tensors holding the value (the bits, for 64-bit
columns), inside one call only.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any

import torch

from ..common import tree as pt

#: the signed type of each unsigned type's width
SIGNED_OF = {torch.uint16: torch.int16, torch.uint32: torch.int32,
             torch.uint64: torch.int64}
_BITS = {torch.uint16: 16, torch.uint32: 32, torch.uint64: 64}
_UNSIGNED_OF_BITS = {b: t for t, b in _BITS.items()}
_SIGN = -(1 << 63)


def signed(t: torch.Tensor) -> torch.Tensor:
    """``t`` viewed as the signed type of its width when it is a wide
    unsigned tensor (the bits unchanged), else ``t``."""
    s = SIGNED_OF.get(t.dtype)
    return t if s is None else t.view(s)


def unsigned_values(t: torch.Tensor) -> torch.Tensor:
    """A wide unsigned tensor's values as int64: exact for 16 and 32
    bits, the same bits for 64."""
    if t.dtype == torch.uint64:
        return t.view(torch.int64)
    return signed(t).to(torch.int64) & ((1 << _BITS[t.dtype]) - 1)


def holds(tree: Any) -> bool:
    """True when a leaf of ``tree`` is a wide unsigned tensor."""
    return any(isinstance(l, torch.Tensor) and l.dtype in SIGNED_OF
               for l in pt.leaves(tree))


def _wrap(v: torch.Tensor, bits: int) -> "UInt":
    if bits < 64:
        v = v & ((1 << bits) - 1)
    return UInt(v, bits)


def _plain(x):
    return x.as_subclass(torch.Tensor) if isinstance(x, UInt) else x


def _is_int(x) -> bool:
    return isinstance(x, int) and not isinstance(x, bool)


def _scalar_bits(x, bits: int):
    """A Python int operand in the int64 domain of a ``bits``-wide
    column (a uint64 constant past 2^63 as its two's complement)."""
    if not _is_int(x):
        return x
    x &= (1 << bits) - 1 if bits < 64 else (1 << 64) - 1
    return x - (1 << 64) if bits == 64 and x >= 1 << 63 else x


def _signed_scalar(x, bits: int):
    """A Python int as the signed ``bits``-wide value of the same bits
    (small ints, dimensions among them, stay as they are)."""
    if not _is_int(x):
        return x
    x &= (1 << bits) - 1
    return x - (1 << bits) if x >= 1 << (bits - 1) else x


def _to_float(v: torch.Tensor, bits: int, dtype) -> torch.Tensor:
    f = v.to(dtype)
    if bits == 64:
        f = torch.where(v < 0, f + 2.0 ** 64, f)
    return f


def _udivmod(a: torch.Tensor, b, bits: int):
    """Unsigned floor division and remainder of int64 bit patterns."""
    if bits < 64:
        return a // b, a % b
    b = torch.as_tensor(b, dtype=torch.int64, device=a.device)
    # (a >>> 1) // b, doubled, then one correction step
    half = (a >> 1) & ((1 << 63) - 1)
    q = (half // b) << 1
    r = a - q * b
    fix = (r ^ _SIGN) >= (b ^ _SIGN)
    return q + fix.to(torch.int64), r - torch.where(fix, b, 0)


def _lshr(a: torch.Tensor, s) -> torch.Tensor:
    """The logical right shift of int64 bit patterns by ``s`` (0-63)."""
    s = torch.as_tensor(s, dtype=torch.int64, device=a.device)
    keep = torch.where(s > 0, (torch.ones_like(s) << (64 - s).clamp(
        max=63)) - 1, -1)
    return (a >> s) & keep


#: ops whose int64 result is an index or a count, not a column's value
_INDEX_OUT = {"argsort", "argmax", "argmin", "nonzero", "searchsorted",
              "bincount", "count_nonzero", "bucketize", "argwhere"}
#: ops that may return (values, indices): only the values are a column's
_VALUES_FIRST = {"max", "min", "sort", "topk", "kthvalue", "median",
                 "cummax", "cummin", "unique", "unique_consecutive"}
#: ops that order values: a 64-bit column's take part with the sign bit
#: flipped, whose signed order is the unsigned order of the bits
_ORDER = {"amax", "amin", "max", "min", "maximum", "minimum", "clamp",
          "clamp_min", "clamp_max", "sort", "argsort", "msort", "topk",
          "kthvalue", "median", "cummax", "cummin", "searchsorted",
          "bucketize", "argmax", "argmin", "unique", "unique_consecutive",
          "scatter_reduce", "index_reduce"}
_BINARY = {"add", "__add__", "__radd__", "sub", "__sub__", "__rsub__",
           "mul", "__mul__", "__rmul__", "bitwise_and", "__and__",
           "__rand__", "bitwise_or", "__or__", "__ror__", "bitwise_xor",
           "__xor__", "__rxor__", "eq", "__eq__", "ne", "__ne__", "where",
           "maximum", "minimum", "full_like"}
_CMP = {"gt": "__gt__", "ge": "__ge__", "lt": "__lt__", "le": "__le__",
        "__gt__": "__gt__", "__ge__": "__ge__", "__lt__": "__lt__",
        "__le__": "__le__", "greater": "__gt__", "less": "__lt__"}
_FLOAT = {"float": torch.float32, "double": torch.float64,
          "half": torch.float16}


def _tmap(fn, out):
    """``pt.tree_map`` that keeps torch's named result tuples."""
    if isinstance(out, tuple) and type(out).__module__ == \
            "torch.return_types":
        return type(out)([_tmap(fn, o) for o in out])
    return pt.tree_map(fn, out)


def _values(out, fn):
    """``fn`` on a result's values: the first item of a (values,
    indices) tuple, else the result itself."""
    if isinstance(out, tuple):
        items = [fn(out[0])] + list(out[1:])
        return type(out)(items) if type(out).__module__ == \
            "torch.return_types" else tuple(items)
    return fn(out)


class UInt(torch.Tensor):
    """A wide unsigned column as a user function sees it: int64 values
    (the bits, for 64-bit columns) computing as the reference's unsigned
    arrays (see the module docstring)."""

    @staticmethod
    def __new__(cls, values: torch.Tensor, bits: int):
        r = torch.Tensor._make_subclass(cls, values.to(torch.int64))
        r._ubits = bits
        return r

    def __repr__(self) -> str:
        return f"UInt{self._ubits}({self.as_subclass(torch.Tensor)!r})"

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        with torch._C.DisableTorchFunctionSubclass():
            return _dispatch(func, args, kwargs or {})


def _dispatch(func, args, kwargs):
    """:meth:`UInt.__torch_function__`'s body, with subclass dispatch
    off (attribute reads of a UInt would recurse otherwise)."""
    name = getattr(func, "__name__", "")
    bits = max(a._ubits for a in pt.leaves((args, kwargs))
               if isinstance(a, UInt))
    flat, td = pt.flatten((args, kwargs))
    if any(isinstance(a, float) or (isinstance(a, torch.Tensor)
                                    and a.dtype.is_floating_point)
           for a in flat):
        # with a float operand the unsigned values take part
        flat = [_to_float(_plain(a), a._ubits, torch.float64)
                if isinstance(a, UInt) else a for a in flat]
        args, kwargs = pt.unflatten(td, flat)
        return func(*args, **kwargs)
    if name in _FLOAT or (name == "to" and _float_target(args, kwargs)):
        dt = _FLOAT.get(name) or _float_target(args, kwargs)
        return _to_float(_plain(args[0]), bits, dt)
    if name in _CMP and bits == 64:
        flat = [(_plain(a) ^ _SIGN) if isinstance(a, UInt)
                else (_scalar_bits(a, 64) ^ _SIGN if _is_int(a) else a)
                for a in flat]
        a, b = pt.unflatten(td, flat)[0][:2]
        return getattr(torch.Tensor, _CMP[name])(torch.as_tensor(a), b)
    if name in ("sum", "cumsum"):
        # the reference's (numpy's) rule: without a dtype an unsigned
        # sum is a uint64 one, with an unsigned dtype it wraps there
        dt = kwargs.get("dtype")
        kw = {k: v for k, v in kwargs.items() if k != "dtype"}
        if dt is not None and dt not in SIGNED_OF:
            return func(*[_plain(a) for a in args], dtype=dt, **kw)
        out = func(*[_plain(a) for a in args], **kw)
        return _wrap(out, _BITS.get(dt, 64))
    if name in ("floor_divide", "__floordiv__", "remainder", "__mod__",
                "fmod"):
        a, b = _plain(args[0]), args[1]
        b = _plain(b) if isinstance(b, torch.Tensor) else \
            _scalar_bits(b, bits)
        q, r = _udivmod(a, b, bits)
        return _wrap(q if "div" in name else r, bits)
    if name in ("__rfloordiv__", "__rmod__"):
        a = _scalar_bits(args[1], bits)
        a = torch.full_like(_plain(args[0]), a)
        q, r = _udivmod(a, _plain(args[0]), bits)
        return _wrap(q if "div" in name else r, bits)
    if name in ("__rshift__", "bitwise_right_shift") and bits == 64 \
            and isinstance(args[0], UInt):
        s = args[1]
        return _wrap(_lshr(_plain(args[0]), _plain(s)), 64)
    if name in _ORDER and bits == 64 and (
            name not in ("scatter_reduce", "index_reduce")
            or any(a in ("amin", "amax") for a in flat
                   if isinstance(a, str))):
        clamp = name.startswith("clamp")
        flat = [(_plain(a) ^ _SIGN) if isinstance(a, UInt) else
                (_scalar_bits(a, 64) ^ _SIGN if clamp and _is_int(a)
                 else a) for a in flat]
        args, kwargs = pt.unflatten(td, flat)
        out = func(*args, **kwargs)
        if name in _INDEX_OUT:
            return out
        return _values(out, lambda v: _wrap(v ^ _SIGN, 64)
                       if isinstance(v, torch.Tensor)
                       and v.dtype == torch.int64 else v)
    # a uint64 constant past 2^63 takes part as its two's complement;
    # other int arguments (dims, shapes) pass as they are
    flat = [_plain(a) if isinstance(a, UInt) else
            (_scalar_bits(a, 64) if bits == 64 and name in _BINARY
             and _is_int(a) else a) for a in flat]
    args, kwargs = pt.unflatten(td, flat)
    out = func(*args, **kwargs)
    if name in _INDEX_OUT:
        return out

    def wrap(o):
        return _wrap(o, bits) if isinstance(o, torch.Tensor) and not \
            isinstance(o, UInt) and o.dtype == torch.int64 else o

    # the values of an unsigned column stay unsigned
    if name in _VALUES_FIRST and isinstance(out, tuple):
        return _values(out, wrap)
    return _tmap(wrap, out)


def _float_target(args, kwargs):
    for a in list(args[1:]) + list(kwargs.values()):
        if isinstance(a, torch.dtype) and a.is_floating_point:
            return a
    return None


def from_user(tree: Any) -> Any:
    """A user function's result with every :class:`UInt` leaf back in
    its torch unsigned type."""
    def back(l):
        if not isinstance(l, UInt):
            return l
        dt = _UNSIGNED_OF_BITS[l._ubits]
        v = l.as_subclass(torch.Tensor)
        return v.to(SIGNED_OF[dt]).view(dt)
    return _tmap(back, tree)


#: ops that work on torch's unsigned types as they are: metadata, views,
#: copies and moves that keep the element type
_NATIVE = {"__get__", "__set__", "view", "to", "type", "reshape", "clone",
           "contiguous", "__getitem__", "cat", "concatenate", "flatten",
           "squeeze", "unsqueeze", "expand", "permute", "transpose", "t",
           "narrow", "select", "split", "chunk", "unbind", "cpu", "cuda",
           "numpy", "tolist", "item", "element_size", "dim", "size",
           "numel", "nelement", "data_ptr", "is_contiguous", "stride",
           "storage_offset", "untyped_storage", "__len__", "__repr__",
           "__format__", "is_pinned", "pin_memory", "detach", "empty_like",
           "zeros_like", "new_zeros", "new_empty", "is_floating_point",
           "is_complex", "__reduce_ex__", "__deepcopy__", "__setstate__",
           "_typed_storage", "storage", "get_device", "__hash__",
           "__array__", "float", "double", "record_stream",
           "requires_grad_", "share_memory_", "resize_", "set_"}
#: in-place ops whose bits do not depend on reading them as unsigned:
#: they run on the signed views
_INPLACE_BITS = {"copy_", "fill_", "zero_", "__setitem__", "index_put_",
                 "masked_fill_", "masked_scatter_", "scatter_",
                 "scatter_add_", "index_add_", "index_copy_",
                 "index_fill_", "put_", "add_", "sub_", "mul_", "neg_",
                 "bitwise_and_", "bitwise_or_", "bitwise_xor_",
                 "bitwise_not_", "bitwise_left_shift_", "__iadd__",
                 "__isub__", "__imul__", "__iand__", "__ior__", "__ixor__",
                 "__ilshift__"}
_INPLACE_DUNDER = {"__iadd__", "__isub__", "__imul__", "__iand__",
                   "__ior__", "__ixor__", "__ilshift__", "__irshift__",
                   "__ifloordiv__", "__imod__", "__itruediv__", "__ipow__"}


def _uint_args(flat):
    return [UInt(unsigned_values(a), _BITS[a.dtype])
            if isinstance(a, torch.Tensor) and a.dtype in SIGNED_OF else a
            for a in flat]


class UnsignedMode(torch.overrides.TorchFunctionMode):
    """While active, torch functions given a uint16, uint32 or uint64
    tensor compute as the reference's unsigned arrays (see the module
    docstring)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in _NATIVE:
            return func(*args, **kwargs)
        flat, td = pt.flatten((args, kwargs))
        if not any(isinstance(a, torch.Tensor) and a.dtype in SIGNED_OF
                   for a in flat):
            return func(*args, **kwargs)
        if name in ("__int__", "__index__", "__bool__"):
            v = args[0].item()
            return bool(v) if name == "__bool__" else int(v)
        inplace = name in _INPLACE_DUNDER or name == "__setitem__" or (
            name.endswith("_") and not name.startswith("__"))
        if not inplace:
            a2, k2 = pt.unflatten(td, _uint_args(flat))
            with torch._C.DisableTorchFunctionSubclass():
                out = _dispatch(func, a2, k2)
            return from_user(out)
        dst = args[0]
        if name in _INPLACE_BITS and dst.dtype in SIGNED_OF:
            # the same bits through the signed views; a float source is
            # converted to the column's type first, an int scalar to
            # the signed value of its bits
            bits = _BITS[dst.dtype]
            a2, k2 = pt.unflatten(td, [
                signed(a.to(dst.dtype) if a.dtype.is_floating_point
                       else a) if isinstance(a, torch.Tensor)
                else _signed_scalar(a, bits) for a in flat])
            func(*a2, **k2)
            return dst
        # any other in-place op: computed out of place, its bits written
        oop = "__" + name[3:] if name in _INPLACE_DUNDER else name[:-1]
        f = getattr(torch.Tensor, oop, None)
        if f is None:
            raise NotImplementedError(
                f"{name} on a {dst.dtype} tensor (fault C22)")
        a2, k2 = pt.unflatten(td, _uint_args(flat))
        with torch._C.DisableTorchFunctionSubclass():
            res = from_user(_dispatch(f, a2, k2))
        if res.dtype.is_floating_point and not dst.dtype.is_floating_point:
            raise RuntimeError(f"result type {res.dtype} can't be cast to "
                               f"the desired output type {dst.dtype}")
        if dst.dtype in SIGNED_OF:
            signed(dst).copy_(signed(res))
        else:
            dst.copy_(res)
        return dst


_TLS = threading.local()


def _active() -> bool:
    return getattr(_TLS, "active", False)


@contextlib.contextmanager
def scope_for(tree: Any):
    """:class:`UnsignedMode` around a call whose inputs ``tree`` hold a
    wide unsigned column (a program dispatch, an action's fold);
    nothing otherwise, and nothing more inside an active one."""
    if _active() or not holds(tree):
        yield
        return
    _TLS.active = True
    try:
        with UnsignedMode():
            yield
    finally:
        _TLS.active = False


@contextlib.contextmanager
def node_scope():
    """A node's compute: :func:`on_pull` turns :class:`UnsignedMode` on
    for the rest of it once a pulled input holds a wide unsigned column;
    it ends with the compute."""
    frames = _TLS.__dict__.setdefault("frames", [])
    frame = [None]
    frames.append(frame)
    try:
        yield
    finally:
        frames.pop()
        if frame[0] is not None:
            frame[0].__exit__(None, None, None)
            _TLS.active = False


def on_pull(shards) -> None:
    """Called with each input a node's compute pulls (see
    :func:`node_scope`)."""
    frames = getattr(_TLS, "frames", None)
    if not frames or _active():
        return
    tree = getattr(shards, "tree", None)
    if tree is None or not holds(tree):
        return
    mode = UnsignedMode()
    mode.__enter__()
    _TLS.active = True
    frames[-1][0] = mode
