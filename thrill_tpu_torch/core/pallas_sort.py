"""Device radix sort: the stable-partition kernel and the LSD loop.

Counterpart of the reference package's ``core/pallas_sort.py``. Its TPU
kernel ``stable_partition_offsets_pallas`` becomes
``csrc/stable_partition.cu``:

  offsets[i] = base[d_i] + #{j < i : d_j == d_i}

with ids outside ``[0, num_bins)`` sanitised into a trailing sentinel bin,
so the result is always a permutation of ``[0, n)``. The wrapper takes
the plain version only for a tensor on the CPU; a CUDA tensor launches
the kernel or raises. ``stable_partition_offsets.launches`` counts
launches (one per call; each call is four kernels on the card).

``radix_argsort_device`` runs 8-bit LSD passes over int64 key words
(``core/keys.py``: unsigned order, most significant word first) and
skips passes whose digit is the same in every row.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from ..common import native_build
from .pallas_kernels import MAX_ROWS, _rows_of, partition_histogram

MAX_BINS = 256                   # per-warp digit counts in shared memory


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


def _lib():
    lib = native_build.load("stable_partition")
    fn = lib.thrill_stable_partition_offsets
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        sz = lib.thrill_stable_partition_scratch
        sz.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        sz.restype = ctypes.c_longlong
    return lib


def _launch(dest: torch.Tensor, num_bins: int) -> torch.Tensor:
    rows = _rows_of(dest)
    if rows.dtype != torch.int32 or not rows.is_contiguous():
        raise ValueError("the stable-partition kernel takes contiguous "
                         "int32 ids")
    R, n = rows.shape
    if n > MAX_ROWS or not 1 <= num_bins <= MAX_BINS or R > 65535:
        raise ValueError(f"stable partition of n={n} ids over {num_bins} "
                         f"bins in {R} rows is outside the kernel's range")
    lib = _lib()
    scratch = torch.empty(lib.thrill_stable_partition_scratch(n, R, num_bins),
                          dtype=torch.int32, device=dest.device)
    out = torch.empty((R, n), dtype=torch.int32, device=dest.device)
    with torch.cuda.device(dest.device):
        stream = torch.cuda.current_stream(dest.device).cuda_stream
        err = lib.thrill_stable_partition_offsets(
            rows.data_ptr(), scratch.data_ptr(), out.data_ptr(), n, R,
            num_bins, stream)
    if err != 0:
        raise RuntimeError(f"stable_partition_offsets kernel launch "
                           f"failed: cudaError {err}")
    stable_partition_offsets.launches += 1
    return out.reshape(dest.shape)


def stable_partition_offsets(dest: torch.Tensor,
                             num_bins: int) -> torch.Tensor:
    """offsets[i] = stable-partition target of row i under dest[i], per
    row of ``dest`` (int32 ``[n]`` or ``[W, n]``); int32 result."""
    if dest.device.type == "cpu":
        return stable_partition_offsets_plain(dest, num_bins)
    if dest.device.type != "cuda":
        raise ValueError(f"stable_partition_offsets: unsupported device "
                         f"{dest.device}")
    return _launch(dest, num_bins)


stable_partition_offsets.launches = 0


def radix_argsort_device(words: Sequence[torch.Tensor],
                         word_bits: Optional[Sequence[int]] = None,
                         passes: Optional[List[Tuple[int, int]]] = None
                         ) -> torch.Tensor:
    """Stable LSD radix argsort by int64 key words (``words[0]`` most
    significant, unsigned order) in 8-bit digits, per row: words ``[n]``
    or ``[W, n]`` give an int64 permutation of the same shape.

    ``word_bits[k]`` bounds the used low bits of ``words[k]`` (default
    64). A pass whose digit is the same in every row is skipped. A
    digit's histogram does not depend on the row order, so every
    candidate pass is priced before the first one runs and the skip
    costs one host sync per argsort, not one per pass. ``passes``, when
    given, receives (live passes, candidate passes).
    """
    shape = words[0].shape
    words = [(w if w.dim() == 2 else w.unsqueeze(0)).contiguous()
             for w in words]
    R, n = words[0].shape
    cands = [(k, s)
             for k in range(len(words) - 1, -1, -1)
             for s in range(0, 64 if word_bits is None else int(word_bits[k]),
                            8)]

    def digits(k, s):
        # byte s/8 of the little-endian word is (w >> s) & 255: a strided
        # uint8 view, no shift or mask over int64
        return words[k].view(torch.uint8).view(R, n, 8)[:, :, s // 8]

    hists = torch.stack([partition_histogram(digits(k, s).to(torch.int32),
                                             256)
                         for k, s in cands])              # [P, R, 256]
    live = (hists.amax(dim=2) < n).any(dim=1).tolist()    # the one sync
    todo = [c for c, l in zip(cands, live) if l]
    perm = torch.arange(n, device=words[0].device).expand(R, n).contiguous()
    for k, s in todo:
        d = torch.gather(digits(k, s), 1, perm).to(torch.int32)
        offs = stable_partition_offsets(d, 256).to(torch.int64)
        nxt = torch.empty_like(perm)
        nxt.scatter_(1, offs, perm)
        perm = nxt
    if passes is not None:
        passes.append((len(todo), len(cands)))
    return perm.reshape(shape)
