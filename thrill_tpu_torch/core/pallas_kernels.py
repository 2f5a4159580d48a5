"""Per-bin kernels: partition histogram, segment sum, presence fill.
Each has its CUDA kernel, its plain PyTorch version and its wrapper.

Counterparts of ``partition_histogram``, ``segment_sum`` and
``presence_fill`` in the reference package's ``core/pallas_kernels.py``,
whose TPU kernels become:

* ``partition_histogram_pallas`` -> ``csrc/partition_histogram.cu``: send
  destinations of every exchange (``data/exchange.send_counts``; the
  radix engine counts its digits itself);
* ``segment_sum_pallas`` -> ``csrc/segment_sum.cu``: ReduceToIndex's
  additive f32 fold (``api/ops/reduce.py``);
* ``presence_fill_pallas`` -> ``csrc/presence_fill.cu``: ReduceByKey's
  DuplicateDetection registers.

Each wrapper takes the plain version only for a tensor on the CPU. A CUDA
tensor launches the kernel or raises. ``<wrapper>.launches`` counts
kernel launches. The TPU's size gates (2^24 rows, 4096 segments, 8192
registers) come from its f32 one-hot sums and are not inherited:
counters are int32 here, and the wrappers refuse only what int32 cannot
index. The histogram and the presence fill take int32 or int64 ids as
their callers hold them and test them at full width.
"""

from __future__ import annotations

import ctypes

import torch

from ..common import native_build

# counters are int32; the TPU's f32 gate does not apply
MAX_ROWS = (1 << 31) - 1
MAX_BINS = 12288                 # shared-memory histogram of 48 KB
# id dtypes the histogram and presence-fill kernels read as they are
ID_DTYPES = (torch.int32, torch.int64)


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


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _lib():
    lib = native_build.load("partition_histogram")
    fn = lib.thrill_partition_histogram
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(dest: torch.Tensor, num_bins: int) -> torch.Tensor:
    rows = _rows_of(dest)
    if rows.dtype not in ID_DTYPES or not rows.is_contiguous():
        raise ValueError("the histogram kernel takes contiguous int32 or "
                         "int64 ids")
    R, n = rows.shape
    if n > MAX_ROWS or not 1 <= num_bins <= MAX_BINS or R > 65535:
        raise ValueError(f"histogram of n={n} ids over {num_bins} bins "
                         f"in {R} rows is outside the kernel's range")
    dev = dest.device
    # a block reads at least four 16-byte loads a lane; 8 blocks an SM
    per_row = max(1, min(-(-n * rows.element_size() // (16 * 256 * 4)),
                         (8 * _sms(dev)) // R))
    out = torch.zeros((R, num_bins), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()(rows.data_ptr(), rows.element_size(), out.data_ptr(), n,
                     R, num_bins, per_row, stream)
    if err != 0:
        raise RuntimeError(f"partition_histogram kernel launch failed: "
                           f"cudaError {err}")
    partition_histogram.launches += 1
    return out.reshape(dest.shape[:-1] + (num_bins,))


def partition_histogram(dest: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Count of each id in ``[0, num_bins)`` per row of ``dest`` (int32
    or int64 ``[n]`` or ``[W, n]``); ids outside the range are not
    counted."""
    if dest.device.type == "cpu":
        return partition_histogram_plain(dest, num_bins)
    if dest.device.type != "cuda":
        raise ValueError(f"partition_histogram: unsupported device "
                         f"{dest.device}")
    return _launch(dest, num_bins)


partition_histogram.launches = 0


def _check_bins(name: str, n: int, bins: int, rows: int) -> None:
    if n > MAX_ROWS or not 1 <= bins <= MAX_ROWS or rows > 65535:
        raise ValueError(f"{name} of n={n} ids over {bins} bins in {rows} "
                         f"rows is outside the kernel's range")


# -- segment sum (replaces segment_sum_pallas) -------------------------------

def segment_sum_plain(seg_ids: torch.Tensor, values: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """f32 ``index_add_`` of ``values`` into ``num_segments + 1`` bins of
    the sanitised ids per row, the dump bin dropped. ``seg_ids`` and
    ``values`` ``[n]`` or ``[W, n]`` -> f32 ``[num_segments]`` or
    ``[W, num_segments]``."""
    rows = _rows_of(seg_ids)
    R, n = rows.shape
    nb = num_segments + 1
    d = rows.to(torch.int64)
    safe = torch.where((d >= 0) & (d < num_segments), d,
                       torch.full_like(d, num_segments))
    safe = safe + torch.arange(R, device=d.device)[:, None] * nb
    out = torch.zeros(R * nb, dtype=torch.float32, device=d.device)
    out.index_add_(0, safe.reshape(-1),
                   values.reshape(-1).to(torch.float32))
    return out.reshape(R, nb)[:, :num_segments].reshape(
        seg_ids.shape[:-1] + (num_segments,))


def _seg_launch(seg_ids: torch.Tensor, values: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    rows, vals = _rows_of(seg_ids), _rows_of(values)
    if (rows.dtype != torch.int32 or vals.dtype != torch.float32
            or not rows.is_contiguous() or not vals.is_contiguous()
            or rows.shape != vals.shape or vals.device != rows.device):
        raise ValueError("the segment-sum kernel takes contiguous int32 ids "
                         "and float32 values of one shape on one device")
    R, n = rows.shape
    _check_bins("segment sum", n, num_segments, R)
    out = torch.zeros((R, num_segments), dtype=torch.float32,
                      device=seg_ids.device)
    lib = native_build.load("segment_sum")
    fn = lib.thrill_segment_sum
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(seg_ids.device):
        stream = torch.cuda.current_stream(seg_ids.device).cuda_stream
        err = fn(rows.data_ptr(), vals.data_ptr(), out.data_ptr(), n, R,
                 num_segments, _sms(seg_ids.device), stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: cudaError "
                           f"{err}")
    segment_sum.launches += 1
    return out.reshape(seg_ids.shape[:-1] + (num_segments,))


def segment_sum(seg_ids: torch.Tensor, values: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """f32 sum of ``values`` per segment id in ``[0, num_segments)``, per
    row of ``seg_ids`` (int32 ``[n]`` or ``[W, n]``); other ids are
    dropped. On a card the sum order is that of atomics."""
    if seg_ids.device.type == "cpu":
        return segment_sum_plain(seg_ids, values, num_segments)
    if seg_ids.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {seg_ids.device}")
    return _seg_launch(seg_ids, values, num_segments)


segment_sum.launches = 0


# -- presence fill (replaces presence_fill_pallas) ---------------------------

def presence_fill_plain(h: torch.Tensor, valid: torch.Tensor,
                        num_regs: int) -> torch.Tensor:
    """A zeroed ``[W, num_regs + 1]`` u8 tensor with ``index_put_`` of
    ones at the valid sanitised ids, the dump column dropped. ``h`` and
    ``valid`` ``[n]`` or ``[W, n]`` -> u8 ``[num_regs]`` or
    ``[W, num_regs]``."""
    rows = _rows_of(h)
    R, n = rows.shape
    nb = num_regs + 1
    d = rows.to(torch.int64)
    ok = _rows_of(valid).to(torch.bool) & (d >= 0) & (d < num_regs)
    safe = torch.where(ok, d, torch.full_like(d, num_regs))
    safe = safe + torch.arange(R, device=d.device)[:, None] * nb
    out = torch.zeros(R * nb, dtype=torch.uint8, device=d.device)
    out.index_put_((safe.reshape(-1),),
                   torch.ones((), dtype=torch.uint8, device=d.device))
    return out.reshape(R, nb)[:, :num_regs].reshape(
        h.shape[:-1] + (num_regs,))


# registers up to this many are set in a shared bitset (kMaxBitsetRegs in
# csrc/presence_fill.cu, 128 KB); ReduceByKey sizes at most 2^17
BITSET_REGS = 1 << 20
# the global bitsets, which every launch leaves zeroed, one per (device,
# stream): launches on one stream run in order, so they can share it
_bitsets = {}


def _bitset_scratch(device: torch.device, stream: int,
                    words: int) -> torch.Tensor:
    t = _bitsets.get((device, stream))
    if t is None or t.numel() < words:
        t = _bitsets[(device, stream)] = torch.zeros(
            max(words, 64), dtype=torch.int32, device=device)
    return t


def _pres_lib():
    fn = native_build.load("presence_fill").thrill_presence_fill
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _pres_launch(h: torch.Tensor, valid: torch.Tensor,
                 num_regs: int) -> torch.Tensor:
    rows, flags = _rows_of(h), _rows_of(valid)
    if (rows.dtype not in ID_DTYPES or flags.dtype != torch.bool
            or not rows.is_contiguous() or not flags.is_contiguous()
            or rows.shape != flags.shape or flags.device != rows.device):
        raise ValueError("the presence kernel takes contiguous int32 or "
                         "int64 ids and bool flags of one shape on one "
                         "device")
    R, n = rows.shape
    _check_bins("presence fill", n, num_regs, R)
    if num_regs > BITSET_REGS:
        raise ValueError(f"presence fill over {num_regs} registers: the "
                         f"kernel's shared bitset holds {BITSET_REGS}")
    dev = h.device
    words = -(-num_regs // 32)
    # 512-row chunks, 16 warps a block; two blocks an SM while the shared
    # bitset leaves room for them
    per_sm = 2 if words * 4 <= 64 * 1024 else 1
    per_row = max(1, min(-(-n // (512 * 16)), (per_sm * _sms(dev)) // R))
    out = torch.empty((R, num_regs), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        bits = _bitset_scratch(dev, stream, R * words)
        err = _pres_lib()(rows.data_ptr(), rows.element_size(),
                          flags.data_ptr(), bits.data_ptr(), out.data_ptr(),
                          n, R, num_regs, per_row, stream)
    if err != 0:
        # a failed launch may leave bits set: the next gets fresh zeros
        _bitsets.pop((dev, stream), None)
        raise RuntimeError(f"presence_fill kernel launch failed: cudaError "
                           f"{err}")
    presence_fill.launches += 1
    return out.reshape(h.shape[:-1] + (num_regs,))


def presence_fill(h: torch.Tensor, valid: torch.Tensor,
                  num_regs: int) -> torch.Tensor:
    """u8 presence registers per row of ``h`` (int32 or int64 ``[n]`` or
    ``[W, n]``): ``out[m] = 1`` iff some ``i`` with ``valid[i]`` has
    ``h[i] == m``; ids outside ``[0, num_regs)`` are ignored. On a card
    ``num_regs`` is at most ``BITSET_REGS``."""
    if h.device.type == "cpu":
        return presence_fill_plain(h, valid, num_regs)
    if h.device.type != "cuda":
        raise ValueError(f"presence_fill: unsupported device {h.device}")
    return _pres_launch(h, valid, num_regs)


presence_fill.launches = 0
