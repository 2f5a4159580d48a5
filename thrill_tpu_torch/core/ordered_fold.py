"""Ordered float sums: every run folded left to right, in operand order.

The reference folds every float "sum" outside the f32 segment-sum
kernel with ``.at[pos].add`` or ``jax.ops.segment_sum``, which XLA
applies in operand order. ``index_add_`` does the same on the CPU, but
on a card it adds with atomics in an order that changes from run to
run. Here a float sum is one fold per run, from +0.0, row after row:

* :func:`ordered_segment_sum` (``csrc/ordered_segment_sum.cu``) takes
  the values, a stable grouping ``order`` of their rows (or None when
  the rows already lie in runs) and the runs' offsets;
* :func:`group_rows` makes that grouping from segment ids with the
  port's engines: a stable radix argsort (B2) for the order and the
  send-count histogram (B1, where the segments fit it) for the offsets;
* :func:`ordered_fold` is the two together, the ordered counterpart of
  ``index_add_`` into ``num_segments`` rows with other ids dropped.

Integer sums stay ``index_add_`` (exact in any order), and so does the
f32 scalar sum through the segment-sum kernel (B3), whose contract is
unordered.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..common import native_build, taint
from .device_sort import argsort_words
from .pallas_kernels import MAX_BINS, partition_histogram

# dtype codes of csrc/ordered_segment_sum.cu
_DTYPES = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
           torch.bfloat16: 3}
FOLD_DTYPES = tuple(_DTYPES)
_WARPS_A_BLOCK = 8          # warps a block, one run each (kWarps)
_CHUNK = 32                 # columns a grid.y (kChunk)


def _as_rows(values: torch.Tensor) -> torch.Tensor:
    """``[T, ...]`` values as ``[T, C]`` (C = 1 for ``[T]``)."""
    return values.reshape(values.shape[0], -1)


def ordered_segment_sum_plain(values: torch.Tensor,
                              order: Optional[torch.Tensor],
                              run_offsets: torch.Tensor) -> torch.Tensor:
    """The fold of each run by ``index_add_`` of the runs' rows, taken in
    run order, into zeros, one column at a time. ``index_add_`` on the
    CPU adds the elements of a 1-D source one after another in index
    order (the tests pin this against ``np.add.at`` and the reference's
    scatter), so each output element is +0.0 plus the run's values left
    to right; of a 2-D half tensor it does not round after every add.
    ``values`` ``[T, ...]``, ``order`` ``[T]`` or None, ``run_offsets``
    ``[S + 1]`` -> ``[S, ...]``."""
    S = run_offsets.shape[0] - 1
    lo, hi = int(run_offsets[0]), int(run_offsets[-1])
    lengths = run_offsets[1:] - run_offsets[:-1]
    seg = torch.repeat_interleave(
        torch.arange(S, device=values.device), lengths)
    rows = (order[lo:hi] if order is not None
            else torch.arange(lo, hi, device=values.device))
    src = _as_rows(values).index_select(0, rows)
    out = torch.zeros((S, src.shape[1]), dtype=values.dtype,
                      device=values.device)
    for c in range(src.shape[1]):
        out[:, c] = torch.zeros(S, dtype=values.dtype,
                                device=values.device).index_add_(
            0, seg, src[:, c].contiguous())
    return out.reshape((S,) + tuple(values.shape[1:]))


def _lib():
    fn = native_build.load("ordered_segment_sum").thrill_ordered_segment_sum
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(values: torch.Tensor, order: Optional[torch.Tensor],
            run_offsets: torch.Tensor) -> torch.Tensor:
    dev = values.device
    if values.dtype not in _DTYPES:
        raise ValueError(f"the ordered fold takes {FOLD_DTYPES}, got "
                         f"{values.dtype}")
    if (run_offsets.dtype != torch.int64 or run_offsets.device != dev
            or (order is not None and (order.dtype != torch.int64
                                       or order.device != dev))):
        raise ValueError("the ordered fold takes int64 order and offsets on "
                         "the values' device")
    rows = _as_rows(values).contiguous()
    offs = run_offsets.contiguous()
    order = None if order is None else order.contiguous()
    S = offs.shape[0] - 1
    C = rows.shape[1]
    if -(-C // _CHUNK) > 65535:
        raise ValueError(f"the ordered fold takes at most "
                         f"{65535 * _CHUNK} columns, got {C}")
    out = torch.empty((S, C), dtype=values.dtype, device=dev)
    if S > 0 and C > 0:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        # the small runs: 8 blocks of 8 warps an SM; the long ones (listed
        # by the first launch): a block each up to 32 an SM, so that the
        # hot runs fold side by side (a block past the list ends at once)
        small = max(1, min(-(-S // _WARPS_A_BLOCK), 8 * sms))
        big_blocks = max(1, min(S, 32 * sms))
        nbig = torch.zeros(1, dtype=torch.int32, device=dev)
        big = torch.empty(S, dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _lib()(rows.data_ptr(), _DTYPES[values.dtype],
                         0 if order is None else order.data_ptr(),
                         offs.data_ptr(), out.data_ptr(), S, C,
                         nbig.data_ptr(), big.data_ptr(), small, big_blocks,
                         stream)
        if err != 0:
            raise RuntimeError(f"ordered_segment_sum kernel launch failed: "
                               f"cudaError {err}")
        ordered_segment_sum.launches += 1
        taint.kernel_edge((rows, order, offs), (out,))
    return out.reshape((S,) + tuple(values.shape[1:]))


def ordered_segment_sum(values: torch.Tensor, order: Optional[torch.Tensor],
                        run_offsets: torch.Tensor) -> torch.Tensor:
    """``out[s]`` = +0.0 plus the rows of run ``s`` added left to right:
    rows ``order[run_offsets[s]:run_offsets[s + 1]]`` of ``values``
    ``[T, ...]`` (f32, f64, f16 or bf16; a half add rounds after each
    add), or those positions themselves when ``order`` is None. The same
    bits on every run, on the card as on the CPU."""
    if values.device.type == "cpu":
        return ordered_segment_sum_plain(values, order, run_offsets)
    if values.device.type != "cuda":
        raise ValueError(f"ordered_segment_sum: unsupported device "
                         f"{values.device}")
    return _launch(values, order, run_offsets)


ordered_segment_sum.launches = 0


def group_rows(ids: torch.Tensor, num_segments: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, run_offsets) of ``[T]`` segment ids: ``order`` lists the
    rows of segment 0, then of segment 1, ..., each in row order (a
    stable argsort, the radix engine on a card, with no host read), with
    the rows of ids outside ``[0, num_segments)`` last and in no run;
    ``run_offsets`` ``[num_segments + 1]`` int64 (the histogram kernel
    counts the rows a segment where ``num_segments`` fits it, an integer
    ``index_add_`` past that: ``bincount`` on a card reads the largest
    id back to the host). Nothing here waits for the device, so a CUDA
    graph can hold it."""
    ids = ids.reshape(-1).to(torch.int64)
    offsets = torch.zeros(num_segments + 1, dtype=torch.int64,
                          device=ids.device)
    if ids.numel() == 0:
        return ids, offsets
    keys = torch.where((ids >= 0) & (ids < num_segments), ids,
                       torch.full_like(ids, num_segments))
    # the ids' bits are known: every digit sorts, no host read
    order = argsort_words([keys], [max(1, num_segments.bit_length())],
                          sync_free=True)
    if num_segments <= MAX_BINS:
        counts = partition_histogram(keys, num_segments).to(torch.int64)
    else:
        counts = torch.zeros(num_segments + 1, dtype=torch.int64,
                             device=ids.device).index_add_(
            0, keys, torch.ones_like(keys))[:num_segments]
    offsets[1:] = torch.cumsum(counts, 0)
    return order, offsets


def ordered_fold(values: torch.Tensor, ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Sum of the rows of ``values`` ``[T, ...]`` by ``ids`` ``[T]`` into
    ``[num_segments, ...]``, each segment folded in row order; other ids
    are dropped."""
    order, offsets = group_rows(ids, num_segments)
    return ordered_segment_sum(values, order, offsets)
