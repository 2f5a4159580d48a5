"""Partition histogram: the CUDA kernel, its plain version, its wrapper.

Counterpart of ``partition_histogram`` in the reference package's
``core/pallas_kernels.py``, whose TPU kernel ``partition_histogram_pallas``
this port replaces with ``csrc/partition_histogram.cu``. It counts send
destinations for every exchange (``data/exchange.send_counts``) and
digits for every radix pass (``core/pallas_sort``).

The wrapper takes the plain version only for a tensor on the CPU. A CUDA
tensor launches the kernel or raises. ``partition_histogram.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..common import native_build

# ids are int32 and counters int32; the TPU's f32 gate does not apply
MAX_ROWS = (1 << 31) - 1
MAX_BINS = 12288                 # shared-memory histogram of 48 KB


def _rows_of(dest: torch.Tensor):
    if dest.dim() not in (1, 2):
        raise ValueError(f"dest must be [n] or [W, n], got {tuple(dest.shape)}")
    return dest if dest.dim() == 2 else dest.unsqueeze(0)


def partition_histogram_plain(dest: torch.Tensor,
                              num_bins: int) -> torch.Tensor:
    """``bincount`` of the ids sanitised into a dropped sentinel bin, per
    row. ``dest`` ``[n]`` or ``[W, n]`` -> int32 ``[num_bins]`` or
    ``[W, num_bins]``."""
    rows = _rows_of(dest)
    R = rows.shape[0]
    nb = num_bins + 1
    d = rows.to(torch.int64)
    safe = torch.where((d >= 0) & (d < num_bins), d,
                       torch.full_like(d, num_bins))
    safe = safe + torch.arange(R, device=d.device)[:, None] * nb
    hist = torch.bincount(safe.reshape(-1), minlength=R * nb)
    out = hist.reshape(R, nb)[:, :num_bins].to(torch.int32)
    return out.reshape(dest.shape[:-1] + (num_bins,))


def _lib():
    lib = native_build.load("partition_histogram")
    fn = lib.thrill_partition_histogram
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(dest: torch.Tensor, num_bins: int) -> torch.Tensor:
    rows = _rows_of(dest)
    if rows.dtype != torch.int32 or not rows.is_contiguous():
        raise ValueError("the histogram kernel takes contiguous int32 ids")
    R, n = rows.shape
    if n > MAX_ROWS or not 1 <= num_bins <= MAX_BINS or R > 65535:
        raise ValueError(f"histogram of n={n} ids over {num_bins} bins "
                         f"in {R} rows is outside the kernel's range")
    out = torch.zeros((R, num_bins), dtype=torch.int32, device=dest.device)
    sms = torch.cuda.get_device_properties(dest.device).multi_processor_count
    per_row = max(1, min(-(-n // 2048), (8 * sms) // R))
    with torch.cuda.device(dest.device):
        stream = torch.cuda.current_stream(dest.device).cuda_stream
        err = _lib()(rows.data_ptr(), out.data_ptr(), n, R, num_bins,
                     per_row, stream)
    if err != 0:
        raise RuntimeError(f"partition_histogram kernel launch failed: "
                           f"cudaError {err}")
    partition_histogram.launches += 1
    return out.reshape(dest.shape[:-1] + (num_bins,))


def partition_histogram(dest: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Count of each id in ``[0, num_bins)`` per row of ``dest`` (int32
    ``[n]`` or ``[W, n]``); ids outside the range are not counted."""
    if dest.device.type == "cpu":
        return partition_histogram_plain(dest, num_bins)
    if dest.device.type != "cuda":
        raise ValueError(f"partition_histogram: unsupported device "
                         f"{dest.device}")
    return _launch(dest, num_bins)


partition_histogram.launches = 0
