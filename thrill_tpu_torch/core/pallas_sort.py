"""Device radix sort: the onesweep engine and the stable-partition offsets.

Counterpart of the reference package's ``core/pallas_sort.py``. Its TPU
kernel ``stable_partition_offsets_pallas`` and the LSD loop around it
become ``csrc/stable_partition.cu``, a key-value radix sort in the style
of onesweep with three wrappers:

* ``radix_upsweep(words, ndigits)``: the byte-digit histograms of one key
  word, int32 ``[W, 8, 256]``, one launch per word;
* ``radix_pass(keys, perm, shift, hist, ...)``: one stable partition of
  (key, permutation) pairs by the digit ``(key >> shift) & 255``, with
  the scatter fused in, one launch per live digit;
* ``stable_partition_offsets(dest, bins)``: the TPU kernel's own function,

    offsets[i] = base[d_i] + #{j < i : d_j == d_i}

  with ids outside ``[0, num_bins)`` sanitised into a trailing sentinel
  bin, so the result is always a permutation of ``[0, n)``: the pass
  kernel's offsets epilogue after an id histogram.

Each wrapper takes its plain PyTorch version only for a tensor on the
CPU; a CUDA tensor launches the kernel or raises. ``<wrapper>.launches``
counts launches.

``radix_argsort_device`` runs 8-bit LSD passes over int64 key words
(``core/keys.py``: unsigned order, most significant word first) and
skips passes whose digit is the same in every row, which costs one host
read an argsort; ``sync_free`` makes every digit of the known bits a
pass and reads nothing (a pass over a digit that is the same in every
row is the identity), so the argsort can run inside a CUDA graph.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from ..common import native_build, taint
from .pallas_kernels import MAX_ROWS, _rows_of, _sms

MAX_BINS = 256                   # bins (plus the sentinel) a block owns
RADIX = 256
TILE = 4096                      # keys per tile of the pass kernel
_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int


def _lib():
    lib = native_build.load("stable_partition")
    if lib.thrill_radix_pass.argtypes is None:
        for name, args, res in (
                ("thrill_radix_upsweep", [_P, _P, _LL, _I, _I, _I, _P], _I),
                ("thrill_radix_pass", [_P, _P, _I, _P, _P, _P, _LL, _P, _P,
                                       _LL, _I, _I, _LL, _P], _I),
                ("thrill_stable_partition_scratch", [_LL, _I, _I], _LL),
                ("thrill_stable_partition_offsets", [_P, _P, _P, _LL, _I, _I,
                                                     _I, _P], _I)):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _per_row(n: int, rows: int, device: torch.device) -> int:
    return max(1, min(-(-n // 2048), (4 * _sms(device)) // rows))


def _device(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type == "cuda"


# -- upsweep: byte-digit histograms of a key word ----------------------------

def radix_upsweep_plain(words: torch.Tensor, ndigits: int = 8) -> torch.Tensor:
    """``bincount`` of each of the first ``ndigits`` byte-digits
    ``(w >> 8j) & 255`` of int64 ``words`` ``[n]`` or ``[W, n]``, per row:
    int32 ``[8, 256]`` or ``[W, 8, 256]``, later digits zero."""
    rows = _rows_of(words)
    R, n = rows.shape
    dev = words.device
    # (w >> s) & 255 is the byte in spite of the arithmetic shift
    b = torch.stack([(rows >> (8 * j)) & 255 for j in range(ndigits)]
                    or [rows[:, :0]], dim=2)                  # [R, n, nd]
    slot = (torch.arange(R, device=dev)[:, None, None] * 8
            + torch.arange(b.shape[2], device=dev)[None, None, :]) * RADIX
    hist = torch.bincount((b + slot).reshape(-1), minlength=R * 8 * RADIX)
    return hist.reshape(R, 8, RADIX).to(torch.int32).reshape(
        words.shape[:-1] + (8, RADIX))


def radix_upsweep(words: torch.Tensor, ndigits: int = 8) -> torch.Tensor:
    """Byte-digit histograms of one int64 key word per row (see
    :func:`radix_upsweep_plain`)."""
    if not 0 <= ndigits <= 8:
        raise ValueError(f"radix_upsweep: {ndigits} digits of a 64-bit word")
    if not _device("radix_upsweep", words):
        return radix_upsweep_plain(words, ndigits)
    rows = _rows_of(words)
    if rows.dtype != torch.int64 or not rows.is_contiguous():
        raise ValueError("the upsweep kernel takes contiguous int64 words")
    R, n = rows.shape
    if n > MAX_ROWS or R > 65535:
        raise ValueError(f"upsweep of {R} rows of {n} words is outside the "
                         f"kernel's range")
    hist = torch.zeros((R, 8, RADIX), dtype=torch.int32, device=words.device)
    if n and R and ndigits:
        with torch.cuda.device(words.device):
            _check("radix_upsweep", _lib().thrill_radix_upsweep(
                rows.data_ptr(), hist.data_ptr(), n, R, ndigits,
                _per_row(n, R, words.device), _stream(words)))
        radix_upsweep.launches += 1
        taint.kernel_edge((rows,), (hist,))
    return hist.reshape(words.shape[:-1] + (8, RADIX))


radix_upsweep.launches = 0


# -- one radix pass ----------------------------------------------------------

class Lookback:
    """Zeroed status words and tile counters shared by up to ``passes``
    radix passes over ``[R, n]`` keys; each pass takes its own epoch."""

    def __init__(self, R: int, n: int, passes: int,
                 device: torch.device) -> None:
        tiles = -(-n // TILE)
        if R * tiles >= 1 << 31:
            raise ValueError(f"{R} rows of {n} keys: too many tiles for the "
                             f"pass kernel's counter")
        self.status = torch.zeros(R * tiles * RADIX, dtype=torch.int64,
                                  device=device)
        self.counters = torch.zeros(passes + 1, dtype=torch.int32,
                                    device=device)
        self.epoch = 0

    def take(self):
        """(status pointer, counter pointer, epoch) of the next pass."""
        self.epoch += 1
        if self.epoch >= self.counters.numel():
            raise ValueError("more radix passes than the look-back state "
                             "was made for")
        return (self.status.data_ptr(),
                self.counters.data_ptr() + 4 * self.epoch, self.epoch)


def radix_pass_plain(keys: torch.Tensor, perm: Optional[torch.Tensor],
                     shift: int, gather: bool = False,
                     write_keys: bool = True):
    """Stable partition of (key, permutation) pairs per row by the digit
    ``(key >> shift) & 255``: a stable argsort by the digit, then a gather
    of key and permutation. ``keys`` int64 ``[n]`` or ``[W, n]``; ``perm``
    int32 of the same shape, or None for the identity; with ``gather``
    the keys are a word in its original order, read through ``perm``.
    Returns (int64 keys or None, int32 permutation)."""
    rows = _rows_of(keys)
    R, n = rows.shape
    p = (_rows_of(perm) if perm is not None else
         torch.arange(n, dtype=torch.int32, device=keys.device).expand(R, n))
    k = (torch.gather(rows, 1, p.to(torch.int64)) if gather
         and perm is not None else rows)
    order = torch.argsort((k >> shift) & 255, dim=1, stable=True)
    p_out = torch.gather(p, 1, order).reshape(keys.shape)
    k_out = torch.gather(k, 1, order).reshape(keys.shape)
    return (k_out if write_keys else None), p_out


def radix_pass(keys: torch.Tensor, perm: Optional[torch.Tensor], shift: int,
               hist: torch.Tensor, gather: bool = False,
               write_keys: bool = True,
               lookback: Optional[Lookback] = None):
    """One radix pass (see :func:`radix_pass_plain`). ``hist`` int32
    ``[W, 256]`` (any row stride) is the digit's histogram per row, from
    :func:`radix_upsweep`; ``lookback`` the state of the caller's
    argsort, or None for a pass of its own."""
    if shift not in range(0, 64, 8):
        raise ValueError(f"radix_pass: shift {shift} is not a byte digit")
    if not _device("radix_pass", keys):
        return radix_pass_plain(keys, perm, shift, gather, write_keys)
    rows, h = _rows_of(keys), _rows_of(hist)
    R, n = rows.shape
    pr = _rows_of(perm) if perm is not None else None
    if (rows.dtype != torch.int64 or not rows.is_contiguous()
            or (pr is not None and (pr.dtype != torch.int32
                                    or not pr.is_contiguous()
                                    or pr.shape != rows.shape))
            or h.dtype != torch.int32 or h.shape != (R, RADIX)
            or h.stride(1) != 1):
        raise ValueError("the radix pass takes contiguous int64 keys, int32 "
                         "permutation entries of their shape and an int32 "
                         "[W, 256] histogram")
    if n > MAX_ROWS or R > 65535:
        raise ValueError(f"radix pass over {R} rows of {n} keys is outside "
                         f"the kernel's range")
    dev = keys.device
    k_out = torch.empty((R, n), dtype=torch.int64, device=dev) if (
        write_keys) else None
    p_out = torch.empty((R, n), dtype=torch.int32, device=dev)
    if n and R:
        lb = lookback or Lookback(R, n, 1, dev)
        status, counter, epoch = lb.take()
        with torch.cuda.device(dev):
            _check("radix_pass", _lib().thrill_radix_pass(
                rows.data_ptr(), pr.data_ptr() if pr is not None else None,
                int(gather), k_out.data_ptr() if write_keys else None,
                p_out.data_ptr(), h.data_ptr(), h.stride(0), status, counter,
                n, R, shift, epoch, _stream(keys)))
        radix_pass.launches += 1
        taint.kernel_edge((rows, pr, h), (k_out, p_out))
    return (k_out.reshape(keys.shape) if write_keys else None,
            p_out.reshape(keys.shape))


radix_pass.launches = 0


# -- stable partition offsets (the TPU kernel's function) --------------------

def stable_partition_offsets_plain(dest: torch.Tensor,
                                   num_bins: int) -> torch.Tensor:
    """The inverse of a stable argsort of the sanitised ids, per row:
    the same function as the reference's ``_offsets_scan``."""
    rows = _rows_of(dest)
    R, n = rows.shape
    d = rows.to(torch.int64)
    safe = torch.where((d >= 0) & (d < num_bins), d,
                       torch.full_like(d, num_bins))
    order = torch.argsort(safe, dim=1, stable=True)
    offs = torch.empty_like(order)
    offs.scatter_(1, order, torch.arange(n, device=d.device).expand(R, n))
    return offs.to(torch.int32).reshape(dest.shape)


def _launch(dest: torch.Tensor, num_bins: int) -> torch.Tensor:
    rows = _rows_of(dest)
    if rows.dtype != torch.int32 or not rows.is_contiguous():
        raise ValueError("the stable-partition kernel takes contiguous "
                         "int32 ids")
    R, n = rows.shape
    if n > MAX_ROWS or not 1 <= num_bins <= MAX_BINS or R > 65535:
        raise ValueError(f"stable partition of n={n} ids over {num_bins} "
                         f"bins in {R} rows is outside the kernel's range")
    if R * -(-n // TILE) >= 1 << 31:
        raise ValueError(f"{R} rows of {n} ids: too many tiles for the "
                         f"pass kernel's counter")
    lib = _lib()
    scratch = torch.zeros(lib.thrill_stable_partition_scratch(n, R, num_bins),
                          dtype=torch.int64, device=dest.device)
    out = torch.empty((R, n), dtype=torch.int32, device=dest.device)
    with torch.cuda.device(dest.device):
        _check("stable_partition_offsets", lib.thrill_stable_partition_offsets(
            rows.data_ptr(), scratch.data_ptr(), out.data_ptr(), n, R,
            num_bins, _per_row(n, max(R, 1), dest.device), _stream(dest)))
    stable_partition_offsets.launches += 1
    taint.kernel_edge((rows,), (out,))
    return out.reshape(dest.shape)


def stable_partition_offsets(dest: torch.Tensor,
                             num_bins: int) -> torch.Tensor:
    """offsets[i] = stable-partition target of row i under dest[i], per
    row of ``dest`` (int32 ``[n]`` or ``[W, n]``); int32 result."""
    if not _device("stable_partition_offsets", dest):
        return stable_partition_offsets_plain(dest, num_bins)
    return _launch(dest, num_bins)


stable_partition_offsets.launches = 0


# -- the LSD driver ----------------------------------------------------------

#: the radix engine's host syncs (:func:`live_digits` calls)
live_reads = 0


def live_digits(varies: torch.Tensor) -> list:
    """``[K][8]`` on the host: is digit ``j`` of used word ``k`` live in
    some row. The radix engine's one host sync an argsort, counted in
    :data:`live_reads` and shown to a loop capture as a host read."""
    global live_reads
    live_reads += 1
    live = varies.any(dim=1)
    taint.host_read(live)
    return live.tolist()


def radix_argsort_device(words: Sequence[torch.Tensor],
                         word_bits: Optional[Sequence[int]] = None,
                         passes: Optional[List[Tuple[int, int]]] = None,
                         sync_free: bool = False) -> torch.Tensor:
    """Stable LSD radix argsort by int64 key words (``words[0]`` most
    significant, unsigned order) in 8-bit digits, per row: words ``[n]``
    or ``[W, n]`` give an int64 permutation of the same shape.

    ``word_bits[k]`` bounds the used low bits of ``words[k]`` (default
    64). One upsweep per word with used bits counts every digit; a pass
    whose digit is the same in every row is skipped, so the skip costs one
    host sync per argsort, not one per pass. The first live pass of a word
    reads it through the permutation so far; its later passes carry (key,
    permutation) pairs. ``passes``, when given, receives (live passes,
    candidate passes). ``sync_free`` (``word_bits`` given) takes every
    candidate digit as live and makes no host read.
    """
    if sync_free and word_bits is None:
        raise ValueError("a sync-free radix argsort needs word_bits")
    shape = words[0].shape
    words = [(w if w.dim() == 2 else w.unsqueeze(0)).contiguous()
             for w in words]
    R, n = words[0].shape
    dev = words[0].device
    ndig = [-(-(64 if word_bits is None else int(word_bits[k])) // 8)
            for k in range(len(words))]
    used = [k for k in range(len(words)) if ndig[k] > 0]
    hists = {k: radix_upsweep(words[k], ndig[k]) for k in used}
    live = []
    if sync_free:
        live = [[True] * 8 for _ in used]
    elif used:
        # a digit is live if some row holds two values of it: the one sync
        varies = torch.stack([hists[k] for k in used]).amax(dim=3) < n
        live = live_digits(varies)                         # [K][8]
    todo = [(k, [j for j in range(ndig[k]) if live[i][j]])
            for i, k in reversed(list(enumerate(used)))]
    nlive = sum(len(js) for _, js in todo)
    perm = None
    if nlive:
        lb = Lookback(R, n, nlive, dev) if dev.type == "cuda" else None
        for k, js in todo:
            keys = words[k]
            for i, j in enumerate(js):
                keys, perm = radix_pass(keys, perm, 8 * j, hists[k][:, j],
                                        gather=i == 0,
                                        write_keys=i + 1 < len(js),
                                        lookback=lb)
    if passes is not None:
        passes.append((nlive, sum(ndig)))
    if perm is None:
        return torch.arange(n, device=dev).expand(R, n).reshape(shape)
    return perm.to(torch.int64).reshape(shape)
