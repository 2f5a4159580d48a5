#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (thrill_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build every CUDA kernel from thrill_tpu_torch/csrc (one nvcc per
     source, all at once);
  2. hold each kernel against its plain PyTorch version on the card, at
     the main path's shapes and on edge cases (results are integers and
     must be bit-equal): the send-count histogram (int32 and sorted int64
     destinations over 4 bins with the sentinel run last, int64 ids at and
     beyond 32 bits, 256 bins), the radix engine's
     upsweep and pass kernels (the pass in both its modes, repeated at the
     main path's shape, where a missing fence would show as a rare wrong
     offset), the stable-partition offsets, segment sum and presence
     fill (int64 ids with a compacted valid prefix, ids beyond 32 bits,
     the largest shared bitset); then time kernel, plain version and
     library call;
  3. TeraSort through the port's API, Context -> Distribute -> Sort ->
     Size / AllGatherArrays, of 100-byte records (10-byte key, 90-byte
     value) made from a numpy seed: W=4 virtual workers x 2^22 records,
     then W=1 x 2^22. Kernel launch counters are zeroed just before and
     read just after each run; the output must equal np.lexsort's order
     of the same records (ties by global index); warm repeats give the
     Sort's time and, at W=4, a torch.profiler table of device time;
  4. WordCount, Distribute({"w", "c"}).ReduceByKey(w, FieldReduce({"w":
     "first", "c": "sum"})) with the default dup_detection=None, of 16-byte
     zero-padded words drawn with Zipf weights 1/rank from a vocabulary of
     2^20 words: W=4 x 2^22 words (the auto verdict must switch duplicate
     detection on), then W=1 x 2^22; the counts must equal np.bincount of
     the word ids exactly; warm repeats and, at W=4, a profiler table;
  5. the PageRank contribution step at W=4: 2^24 edges {"d", "v"} with
     Zipf targets over 2^22 pages through ReduceToIndex(d, FieldReduce({
     "d": "first", "v": "sum"}), 2^22); "v" must agree with np.bincount(d,
     weights=v) in f64 within 1e-4 of each page's sum of |v| plus 1e-6;
     warm repeats and a profiler table;
  6. PageRank end to end, thrill_tpu_torch/examples/page_rank.py's
     page_rank (Zip with the degree table, the dense-index InnerJoin,
     ReduceToIndex, Iterate; f64) over zipf_graph(2^22 pages, 2^24 edges),
     10 iterations at W=4: every page within 1e-9 of its rank plus 1e-18
     of a numpy version (np.bincount in place of np.add.at); Sum(), Min()
     and Max() of the ranks against numpy; B1 and B2 launched; peak and
     current device memory after iterations 2 and 10 (flat within 2 %);
     first-run and warm times and a profiler table; then W=1 at 3
     iterations;
  7. TPC-H Q3-lite, thrill_tpu_torch/examples/tpch.py's q3_lite (a
     filtered orders x lineitem InnerJoin, then ReduceToIndex by
     priority) over generate_tables(2^22 orders, 4 lines an order) at
     W=4: with the cost model's location-detection verdict (printed),
     forced on (presence_fill launched once per side) and forced off,
     each exact (int64) against a numpy version; items exchanged in each;
     warm times and a profiler table; then W=1;
  8. k-means end to end, thrill_tpu_torch/examples/k_means.py's k_means
     (Distribute, Map(Bind) of the distance matmul, ReduceToIndex by
     cluster, AllGatherArrays, a jit_cached update, Iterate with a tensor
     carry; f64) over 2^24 normal points x 8 dims, k = 10, 10 iterations
     at W=4: centers within 1e-9 x (1 + |c|) of a numpy Lloyd with the
     same distance formula, every iteration's label counts equal; one B1,
     one upsweep and one pass an iteration; items exchanged, peak memory
     after iterations 2 and 10 (flat), warm times, a profiler table, the
     card's idle share and a host profile; then W=1 at 3 iterations;
  9. select_kth at W=4 (2^24 int64 values in [0, 2^40), k = n/2; Sample's
     score argsort runs B2): equal to np.partition, rounds printed;
 10. sgd at W=4 (2^22 rows, dim 6, 40 iterations; BernoulliSample and
     Sum(device=True)): at batch fraction 1 within 1e-9 of numpy's
     full-batch descent; at 0.25 every batch size within 5 sigma of n p
     and the error to the true weights at most numpy's full-batch error +
     0.01;
 11. suffix_array (prefix doubling) at W=4 over 2^22 random ACGT
     letters: check_sa holds, one Sort (one B1) a round, pass launches
     equal the live passes;
 12. wavelet_tree at W=4 over 2^20 random bytes: every level equal to
     numpy's stable partition by the bit;
 13. on the inputs the W=4 runs gave the kernels, captured at the call
     sites: the send-count histogram on the Sort's int32 destinations and
     on the WordCount's, the PageRank step's and k-means' sorted int64
     destinations,
     each beside its bound, the parent's int32 copy plus kernel and
     torch.bincount; segment_sum on the PageRank step's ids; presence_fill
     on the WordCount's register ids and on the join's location-filter
     ids of both sides (its bound counts every flag and the id of each
     valid row only); then print the card, the kernels line (each kernel
     with its launches on every W=4 path) and, last, the device line.

    python3 chip_smoke.py --save-inputs DIR

also saves those captured inputs to DIR/main_inputs.pt, for
``kernel_times.py --inputs DIR`` to time other versions of the kernels on.

Exits non-zero without a result line when no CUDA device is present or
the port's sources are not beside this script.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
SCALAR_OPS_PER_S = 67e12       # H100 SXM non-tensor 32-bit rate (data sheet)
PER_WORKER = 1 << 22
SEED = 20261016
VOCAB = 1 << 20                # WordCount vocabulary
PAGES = 1 << 22                # PageRank pages
SEG_RTOL = 1e-4                # f32 sum vs plain/f64: of the segment's sum|v|
SEG_ATOL = 1e-6
PR_EDGES = 1 << 24             # PageRank edges (pages: PAGES)
PR_ITERS = 10
PR_RTOL = 1e-9                 # f64 PageRank vs numpy: of each page's rank
PR_ATOL = 1e-18
PR_MEM_SLACK = 1.02            # peak memory after iteration 10 vs 2
ORDERS = 1 << 22               # TPC-H Q3-lite orders, 4 lines an order
KM_POINTS = 1 << 24            # k-means points (the example's dim and k)
KM_DIM = 8
KM_K = 10
KM_ITERS = 10
KM_CHUNK = 1 << 20             # rows a step of the numpy Lloyd
KM_RTOL = 1e-9                 # centers vs numpy: of 1 + |center|
SK_VALUES = 1 << 24            # select_kth values in [0, 2^40)
SGD_ROWS = 1 << 22             # sgd rows (the example's dim)
SGD_DIM = 6
SGD_ITERS = 40
SGD_RTOL = 1e-9                # full-batch weights vs numpy
SA_BYTES = 1 << 22             # suffix_array text, 4 letters
WT_BYTES = 1 << 20             # wavelet_tree text, 256 letters
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


WARMUP, ITERS, WINDOWS = 2, 10, 3


HOST_AHEAD_CYCLES = 20_000_000  # about 10 ms of device sleep


def cuda_ms(torch, fn, iters: int = ITERS, windows: int = WINDOWS) -> float:
    """Device time of one call of ``fn``: the median over ``windows``
    windows of the mean over ``iters`` calls, after WARMUP calls. Each
    window is queued behind a device sleep, so the host has queued every
    call before the first runs: a wrapper whose host time (about 0.05 ms)
    exceeds its kernel's would otherwise time the host (the 0.035-0.096 ms
    spread of a 0.04 ms histogram)."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOST_AHEAD_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[windows // 2]


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(torch, np, pk, ps):
    """Kernel vs plain version, bit for bit, on the card."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED)

    def ids(shape, lo, hi, dtype=np.int32):
        return torch.as_tensor(rng.integers(lo, hi, size=shape, dtype=dtype),
                               device=dev)

    W = 4
    main = (W, PER_WORKER)
    hist_cases = [
        ("digits", ids(main, 0, 256), 256),
        ("send counts", ids(main, 0, W + 1), W),      # W = invalid
        ("uniform", torch.full(main, 7, dtype=torch.int32, device=dev), 256),
        ("out of range", ids((3, 70001), -9, 300), 256),
        ("empty", ids((0,), 0, 1), 256),
        ("empty rows", ids((W, 0), 0, 1), W),
        ("one", ids((1,), 0, 5), 5),
        ("ragged", ids((2, 4097), 0, 17), 17),
        # the exchange's sorted int64 destinations, the sentinel run last
        ("sorted int64 send counts",
         ids(main, 0, W + 1, np.int64).sort(dim=1).values, W),
        ("random int64 send counts", ids(main, 0, W + 1, np.int64), W),
        ("sorted int32 send counts (Sort)",
         ids(main, 0, W + 1).sort(dim=1).values, W),
        ("int64 beyond 32 bits", wide_ids(torch, np, rng, (W, 70001), W, dev),
         W),
        ("int64, 32 bins, ragged", ids((3, 4097), -1, 34, np.int64), 32),
        ("int64, 256 bins",
         ids((3, 70001), -9, 300, np.int64), 256),
    ]
    part_cases = [
        ("digits", ids(main, 0, 256), 256),
        ("uniform", torch.full((1, PER_WORKER), 3, dtype=torch.int32,
                               device=dev), 256),
        ("two digits", ids(main, 0, 2), 256),
        ("out of range", ids((3, 70001), -9, 300), 256),
        ("sentinels", torch.tensor([5, -1, 2, 7, 2, 99], dtype=torch.int32,
                                   device=dev), 8),
        ("empty", ids((0,), 0, 1), 256),
        ("one", ids((1,), 0, 3), 3),
        ("ragged", ids((2, 4097), 0, 100), 100),
        ("small bins", ids((W, 5000), 0, 3), 3),
        ("skewed", skewed(torch, np, rng, main, dev), 256),
    ]
    errs = {}
    for name, fn, plain, cases in (
            ("partition_histogram", pk.partition_histogram,
             pk.partition_histogram_plain, hist_cases),
            ("stable_partition_offsets", ps.stable_partition_offsets,
             ps.stable_partition_offsets_plain, part_cases)):
        worst = 0
        for label, d, bins in cases:
            got = fn(d, bins)
            want = plain(d, bins)
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(
                    f"{name} on '{label}': {tuple(got.shape)} {got.dtype} "
                    f"vs plain {tuple(want.shape)} {want.dtype}")
            diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
            err = int(diff.max()) if diff.numel() else 0
            if err:
                raise AssertionError(
                    f"{name} disagrees with its plain version on "
                    f"'{label}' {tuple(d.shape)} bins={bins}: max |diff| "
                    f"{err}")
            worst = max(worst, err)
        errs[name] = worst
        log(f"check {name}: {len(cases)} cases bit-equal to the plain "
            f"version")
    errs.update(check_radix(torch, np, ps, rng, part_cases))
    errs["segment_sum"] = check_segment_sum(torch, np, pk, rng)
    errs["presence_fill"] = check_presence_fill(torch, np, pk, rng)
    return errs


def wide_ids(torch, np, rng, shape, bins, dev):
    """int64 ids in [0, bins) mixed with ids at and beyond 32 bits (2^31,
    2^32 + 1, 2^32 + 3, -2^32 + 1, ...), which a kernel that cut ids to
    int32 would count in bins 0, 1 and 3."""
    wide = np.array([2**31 - 1, 2**31, 2**32, 2**32 + 1, 2**32 + 3,
                     -2**31, -2**32 + 1, -1, 2**63 - 1, -2**63], np.int64)
    d = rng.integers(0, bins, size=shape, dtype=np.int64)
    pick = rng.random(shape) < 0.3
    d[pick] = rng.choice(wide, size=int(pick.sum()))
    return torch.as_tensor(d, device=dev)


def skewed(torch, np, rng, shape, dev):
    """Digits of which 90 % are one value (WordCount's Zipf letters, the
    equal high bytes of global indices) and the rest uniform in [0, 256)."""
    d = rng.integers(0, 256, size=shape, dtype=np.int32)
    d[rng.random(shape) < 0.9] = 7
    return torch.as_tensor(d, device=dev)


def check_radix(torch, np, ps, rng, part_cases):
    """The upsweep and the pass kernel against their plain versions, bit
    for bit. Each stable-partition case becomes keys (random int64 words
    whose byte at a random shift is the case's id & 255) with a random
    permutation: the pass runs carrying (key, permutation) and reading the
    word through the permutation, and the upsweep counts the words. The
    main path's shape runs three times in both modes."""
    dev = torch.device(DEVICE)
    main = [c for c in part_cases if c[0] in ("digits", "skewed")]
    for label, d, _ in part_cases + main + main:
        k = torch.as_tensor(rng.integers(-2**63, 2**63, size=tuple(d.shape),
                                         dtype=np.int64), device=dev)
        shift = 8 * int(rng.integers(0, 8))
        if d.numel():
            k.view(torch.uint8).view(*d.shape, 8)[..., shift // 8] = (
                d & 255).to(torch.uint8)
        nd = int(rng.integers(1, 9))
        hist = ps.radix_upsweep(k, nd)
        if not torch.equal(hist, ps.radix_upsweep_plain(k, nd)):
            raise AssertionError(f"radix_upsweep disagrees with its plain "
                                 f"version on '{label}' {tuple(d.shape)}")
        h = ps.radix_upsweep(k)[..., shift // 8, :]
        perm = torch.argsort(torch.rand(tuple(d.shape), device=dev),
                             dim=-1).to(torch.int32)
        for p, gather in ((perm, False), (perm, True), (None, True)):
            got = ps.radix_pass(k, p, shift, h, gather=gather)
            want = ps.radix_pass_plain(k, p, shift, gather=gather)
            torch.cuda.synchronize()
            for g, w, what in zip(got, want, ("keys", "permutation")):
                if g.dtype != w.dtype or not torch.equal(g, w):
                    raise AssertionError(
                        f"radix_pass disagrees with its plain version on "
                        f"'{label}' {tuple(d.shape)} shift={shift} "
                        f"gather={gather} identity={p is None}: {what}")
    log(f"check radix_upsweep, radix_pass: {len(part_cases) + 2 * len(main)}"
        f" cases (the pass in 3 modes each) bit-equal to the plain version")
    return {"radix_upsweep": 0, "radix_pass": 0}


def zipf_ids(torch, n: int, vocab: int, gen):
    """``n`` ids in [0, vocab) drawn on the card with weights 1/rank."""
    dev = torch.device(DEVICE)
    cdf = torch.cumsum(1.0 / torch.arange(1, vocab + 1, dtype=torch.float64,
                                          device=dev), 0)
    u = torch.rand(n, dtype=torch.float64, device=dev, generator=gen)
    return torch.searchsorted(cdf / cdf[-1], u).clamp_(max=vocab - 1)


def seg_err(torch, pk, ids, vals, segs, got):
    """max |kernel - plain| and whether every segment is within
    SEG_RTOL of its sum of |v| plus SEG_ATOL."""
    want = pk.segment_sum_plain(ids, vals, segs)
    scale = pk.segment_sum_plain(ids, vals.abs(), segs)
    diff = (got - want).abs()
    ok = bool((diff <= SEG_RTOL * scale + SEG_ATOL).all())
    return (float(diff.max()) if diff.numel() else 0.0), ok


def check_segment_sum(torch, np, pk, rng):
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    W, n = 4, PER_WORKER

    def f32(shape):
        return torch.randn(shape, device=dev, generator=gen)

    def ids(shape, lo, hi):
        return torch.as_tensor(rng.integers(lo, hi, size=shape,
                                            dtype=np.int32), device=dev)

    cases = [
        ("4096 segments", ids((W, n), 0, 4096), f32((W, n)), 4096),
        ("2^20 zipf segments", zipf_ids(torch, W * n, 1 << 20, gen).to(
            torch.int32).reshape(W, n), f32((W, n)), 1 << 20),
        ("empty rows", ids((W, 0), 0, 1), f32((W, 0)), 4096),
        ("all equal, shared", torch.full((2, 1 << 16), 5, dtype=torch.int32,
                                         device=dev), f32((2, 1 << 16)), 16),
        ("all equal, global", torch.full((2, 1 << 16), 7, dtype=torch.int32,
                                         device=dev), f32((2, 1 << 16)),
         1 << 20),
        ("ids -1 and >= S", ids((3, 70001), -1, 5000), f32((3, 70001)),
         4096),
        ("ragged", ids((3, 4097), 0, 300), f32((3, 4097)), 300),
        ("empty", ids((0,), 0, 1), f32((0,)), 8),
    ]
    worst = 0.0
    for label, d, v, segs in cases:
        got = pk.segment_sum(d, v, segs)
        torch.cuda.synchronize()
        err, ok = seg_err(torch, pk, d, v, segs, got)
        if not ok:
            raise AssertionError(f"segment_sum disagrees with its plain "
                                 f"version on '{label}': max |diff| {err}")
        worst = max(worst, err)
    log(f"check segment_sum: {len(cases)} cases within {SEG_RTOL} of each "
        f"segment's sum |v| + {SEG_ATOL} of the plain version; max |diff| "
        f"{worst}")
    return worst


def check_presence_fill(torch, np, pk, rng):
    dev = torch.device(DEVICE)
    W, n = 4, PER_WORKER

    def case(shape, lo, hi, dtype=np.int32, prefix=None):
        valid = (rng.random(shape) < 0.7 if prefix is None else
                 np.broadcast_to(np.arange(shape[-1]) < prefix * shape[-1],
                                 shape).copy())
        return (torch.as_tensor(rng.integers(lo, hi, size=shape,
                                             dtype=dtype), device=dev),
                torch.as_tensor(valid, device=dev))

    cases = [("2^17 registers", *case((W, n), 0, 1 << 17), 1 << 17),
             ("4096 registers (the TPU kernel's domain)",
              *case((W, n), 0, 4096), 4096),
             ("sentinels", *case((3, 70001), -3, 1 << 17), 100000),
             ("empty", *case((0,), 0, 1), 8),
             ("empty rows", *case((W, 0), 0, 1), 8),
             # WordCount's int64 register ids, valid rows first
             ("int64, 22 % valid prefix, 2^17 registers",
              *case((W, n), 0, 1 << 17, np.int64, 0.22), 1 << 17),
             ("int64 beyond 32 bits",
              wide_ids(torch, np, rng, (W, 70001), 4096, dev),
              torch.as_tensor(rng.random((W, 70001)) < 0.7, device=dev),
              4096),
             ("int64, 2^20 registers (the largest bitset)",
              *case((2, 1 << 20), -1, (1 << 20) + 9, np.int64), 1 << 20),
             ("int64, ragged rows, 1000 registers",
              *case((3, 4097), -9, 1009, np.int64, 0.5), 1000)]
    for label, h, valid, regs in cases:
        got = pk.presence_fill(h, valid, regs)
        want = pk.presence_fill_plain(h, valid, regs)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"presence_fill disagrees with its plain "
                                 f"version on '{label}'")
    log(f"check presence_fill: {len(cases)} cases bit-equal to the plain "
        f"version")
    return 0


def time_kernels(torch, np, pk, ps):
    """Kernel, plain version and library call at the main path's shape
    (W=4 rows of 2^22 radix digits or key words)."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 1)
    R, n, bins = 4, PER_WORKER, 256
    d = torch.as_tensor(rng.integers(0, bins, size=(R, n), dtype=np.int32),
                        device=dev)
    rows = {}
    # off the main path since the radix engine counts its own digits: 256
    # random int32 bins, kept for a comparison with earlier runs of this
    # line
    b, by = bound(R * n * 4 + R * bins * 4, R * n)
    flat = (d.to(torch.int64) + torch.arange(R, device=dev)[:, None] * bins
            ).reshape(-1)
    off = dict(ms=cuda_ms(torch, lambda: pk.partition_histogram(d, bins)),
               plain_ms=cuda_ms(torch, lambda: pk.partition_histogram_plain(
                   d, bins)),
               bound_ms=b, bound_by=by,
               library_ms=cuda_ms(torch, lambda: torch.bincount(
                   flat, minlength=R * bins)))
    log(f"time partition_histogram OFF the main path at [{R}, {n}] random "
        f"int32 ids, bins={bins}: " + json.dumps(off))
    ms = cuda_ms(torch, lambda: ps.stable_partition_offsets(d, bins))
    plain = cuda_ms(torch, lambda: ps.stable_partition_offsets_plain(d, bins))
    lib = cuda_ms(torch, lambda: torch.sort(d, dim=1, stable=True))
    b, by = bound(R * n * 4 * 2, 2 * R * n)
    rows["stable_partition_offsets"] = dict(ms=ms, plain_ms=plain,
                                            bound_ms=b, bound_by=by,
                                            library_ms=lib)
    # the radix engine's kernels on int64 words: 8 digits counted by the
    # upsweep; a pass carrying (key, permutation), shift 8
    k = torch.as_tensor(rng.integers(-2**63, 2**63, size=(R, n),
                                     dtype=np.int64), device=dev)
    ms = cuda_ms(torch, lambda: ps.radix_upsweep(k))
    plain = cuda_ms(torch, lambda: ps.radix_upsweep_plain(k))
    b, by = bound(R * n * 8 + R * 8 * bins * 4, R * n * 8)
    # the library call: one bincount of the row- and digit-offset bytes
    flat = (k.view(torch.uint8).view(R, n, 8).to(torch.int64)
            + (torch.arange(R, device=dev)[:, None, None] * 8
               + torch.arange(8, device=dev)[None, None, :]) * bins
            ).reshape(-1)
    lib = cuda_ms(torch, lambda: torch.bincount(flat, minlength=R * 8 * bins))
    del flat
    rows["radix_upsweep"] = dict(ms=ms, plain_ms=plain, bound_ms=b,
                                 bound_by=by, library_ms=lib)
    perm = torch.argsort(torch.rand((R, n), device=dev), dim=1).to(
        torch.int32)
    h = ps.radix_upsweep(k)[:, 1]
    # one look-back state for the passes of a timing, as an argsort
    # shares one across its passes
    timed = WARMUP + ITERS * WINDOWS
    lb = ps.Lookback(R, n, timed, dev)
    ms = cuda_ms(torch, lambda: ps.radix_pass(k, perm, 8, h, lookback=lb))
    lb = ps.Lookback(R, n, timed, dev)
    gather_ms = cuda_ms(torch, lambda: ps.radix_pass(k, perm, 8, h,
                                                     gather=True,
                                                     lookback=lb))
    plain = cuda_ms(torch, lambda: ps.radix_pass_plain(k, perm, 8))
    b, by = bound(R * n * (8 + 4) * 2, 2 * R * n)
    # no one PyTorch call carries (key, permutation) through a digit's
    # stable partition
    rows["radix_pass"] = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                              library_ms=None)
    log(f"time radix_pass reading the word through the permutation "
        f"(a word's first pass) at [{R}, {n}]: {gather_ms} ms")
    for k, v in rows.items():
        log(f"time {k} at [{R}, {n}] bins={bins}: " + json.dumps(v))
    return rows


def time_argsort(torch, np):
    """The whole multi-word argsort of Sort's phase 1 at W=4: the radix
    engine (both kernels) against the plain engine (stable torch.argsort
    per word) and one stable torch.sort of the most significant word."""
    from thrill_tpu_torch.core import device_sort, keys
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 2)
    R, n = 4, PER_WORKER
    key = torch.as_tensor(rng.integers(0, 256, size=(R * n, 10),
                                       dtype=np.uint8), device=dev)
    words = [w.reshape(R, n) for w in keys.encode_key_words(key)]
    gidx = torch.arange(R * n, device=dev).reshape(R, n)
    ws = words + [gidx]
    passes = []
    radix = device_sort.argsort_words(ws, passes=passes)
    plain = device_sort.plain_argsort_words(ws)
    torch.cuda.synchronize()
    if not torch.equal(radix, plain):
        raise AssertionError("radix argsort disagrees with the plain engine")
    out = dict(shape=[R, n], words=len(ws), live_passes=passes[0][0],
               candidate_passes=passes[0][1],
               radix_ms=cuda_ms(torch, lambda: device_sort.argsort_words(ws),
                                iters=3),
               plain_ms=cuda_ms(torch,
                                lambda: device_sort.plain_argsort_words(ws),
                                iters=3),
               torch_sort_ms=cuda_ms(torch, lambda: torch.sort(
                   keys.order_view(words[0]), dim=1, stable=True), iters=3))
    log("argsort " + json.dumps(out))
    return out


def terasort(torch, np, tt, W: int, pk, ps, exchange_mod):
    """One TeraSort through the port's API; returns the kernel launches
    of the checked run and the send_counts inputs it made (W > 1)."""
    n = W * PER_WORKER
    rng = np.random.default_rng(SEED + W)
    rec = np.frombuffer(rng.bytes(n * 100), dtype=np.uint8).reshape(n, 100)
    recs = {"key": np.ascontiguousarray(rec[:, :10]),
            "value": np.ascontiguousarray(rec[:, 10:])}
    del rec
    ctx = tt.Context(num_workers=W, device=DEVICE)
    torch.cuda.synchronize()
    zero_launches(pk, ps)
    with Capture(exchange_mod, "send_counts") as cap:
        t0 = time.perf_counter()
        d = ctx.Distribute(recs).Sort(key_fn=lambda r: r["key"]).Keep()
        size = d.Size()
        out = d.AllGatherArrays()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = read_launches(pk, ps)
    passes = list(ctx.mesh_exec.radix_passes)
    if size != n:
        raise AssertionError(f"Size() = {size}, expected {n}")
    # the radix engine: one upsweep per key word, one pass per live digit;
    # the send counts of the exchange (W > 1) through the histogram kernel
    need = ["radix_upsweep", "radix_pass"] + (
        ["partition_histogram"] if W > 1 else [])
    for name in need:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the W={W} "
                                 f"Sort path")
    live = sum(p[0] for p in passes)
    if launches["radix_pass"] != live:
        raise AssertionError(f"W={W} Sort: {launches['radix_pass']} pass "
                             f"launches for {live} live passes")
    # reference: np.lexsort of the big-endian key words, stable by index
    kp = np.zeros((n, 16), dtype=np.uint8)
    kp[:, :10] = recs["key"]
    kw = kp.view(">u8").astype(np.uint64)
    del kp
    order = np.lexsort((kw[:, 1], kw[:, 0]))
    del kw
    for leaf in ("key", "value"):
        got = out[leaf].cpu().numpy()
        if got.shape != recs[leaf].shape or not np.array_equal(
                got, recs[leaf][order]):
            raise AssertionError(f"W={W} TeraSort {leaf} column differs "
                                 f"from np.lexsort")
    log(f"terasort W={W} n={n}: equal to np.lexsort; {secs:.3f} s "
        f"(first run, host clock, includes Distribute upload); launches "
        f"{json.dumps(launches)}; radix (live, candidate) passes {passes}; "
        f"exchanged items {ctx.mesh_exec.stats_items_moved}")
    del d, out
    # warm repeat, data already resident: the Sort alone
    warm = []
    for _ in range(2):
        ctx2 = tt.Context(num_workers=W, device=DEVICE)
        src = ctx2.Distribute(recs).Keep()
        src.Execute()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = src.Sort(key_fn=lambda r: r["key"]).AllGatherArrays()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        del res
    log(f"terasort W={W} warm Sort+AllGatherArrays seconds: "
        f"{[round(s, 6) for s in warm]} (host clock after synchronize)")
    if W > 1:
        from torch.profiler import ProfilerActivity, profile as tprof
        ctx3 = tt.Context(num_workers=W, device=DEVICE)
        src = ctx3.Distribute(recs).Keep()
        src.Execute()
        torch.cuda.synchronize()
        with tprof(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            src.Sort(key_fn=lambda r: r["key"]).AllGatherArrays()
            torch.cuda.synchronize()
        log(prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25))
    return launches, cap.args


class Capture:
    """Wraps a kernel wrapper where a module calls it: the call goes
    through unchanged (and counts its launch), its arguments are kept
    (``args`` the last call's, ``calls`` every call's unless
    ``keep_all`` is false: a loop's calls would hold every iteration's
    tensors)."""

    def __init__(self, module, name: str, keep_all: bool = True) -> None:
        self.module, self.name = module, name
        self.inner = getattr(module, name)
        self.keep_all = keep_all
        self.args = None
        self.calls = []

    def __enter__(self):
        def call(*args):
            self.args = args
            if self.keep_all:
                self.calls.append(args)
            return self.inner(*args)
        setattr(self.module, self.name, call)
        return self

    def __exit__(self, *exc) -> None:
        setattr(self.module, self.name, self.inner)


def zero_launches(pk, ps) -> None:
    for k in (pk.partition_histogram, ps.radix_upsweep, ps.radix_pass,
              ps.stable_partition_offsets, pk.segment_sum, pk.presence_fill):
        k.launches = 0


def read_launches(pk, ps) -> dict:
    return {"partition_histogram": pk.partition_histogram.launches,
            "radix_upsweep": ps.radix_upsweep.launches,
            "radix_pass": ps.radix_pass.launches,
            "stable_partition_offsets": ps.stable_partition_offsets.launches,
            "segment_sum": pk.segment_sum.launches,
            "presence_fill": pk.presence_fill.launches}


def vocabulary(torch, gen):
    """VOCAB distinct 16-byte zero-padded words: letters 0..4 spell the
    word's id in base 26 (so every word is distinct and names its id),
    then random letters up to a random length in [5, 16]."""
    dev = torch.device(DEVICE)
    ids = torch.arange(VOCAB, device=dev)
    voc = torch.randint(97, 123, (VOCAB, 16), device=dev, generator=gen,
                        dtype=torch.int64)
    for k in range(5):
        voc[:, k] = (ids // 26 ** k) % 26 + 97
    lens = torch.randint(5, 17, (VOCAB, 1), device=dev, generator=gen)
    voc[torch.arange(16, device=dev)[None, :] >= lens] = 0
    return voc.to(torch.uint8)


def word_ids(np, w: np.ndarray) -> np.ndarray:
    """Word ids spelled by letters 0..4 of ``[K, 16]`` word rows."""
    d = w[:, :5].astype(np.int64) - 97
    return (d * (26 ** np.arange(5))[None, :]).sum(axis=1)


def wordcount(torch, np, tt, W: int, pk, ps, reduce_mod, exchange_mod):
    """One WordCount of W x 2^22 words through the port's API; returns
    the kernel launches of the checked run and the presence_fill and
    send_counts inputs it made (W > 1)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10 + W)
    n = W * PER_WORKER
    voc = vocabulary(torch, gen)
    ids = zipf_ids(torch, n, VOCAB, gen)
    recs = {"w": voc[ids], "c": torch.ones(n, dtype=torch.int64,
                                           device=DEVICE)}
    want = np.bincount(ids.cpu().numpy(), minlength=VOCAB)
    red = tt.FieldReduce({"w": "first", "c": "sum"})

    def run(ctx, src):
        return src.ReduceByKey(lambda t: t["w"], red).AllGatherArrays()

    ctx = tt.Context(num_workers=W, device=DEVICE)
    src = ctx.Distribute(recs).Keep()
    src.Execute()
    torch.cuda.synchronize()
    zero_launches(pk, ps)
    with Capture(reduce_mod, "presence_fill") as cap, \
            Capture(exchange_mod, "send_counts") as cap_sc:
        t0 = time.perf_counter()
        out = run(ctx, src)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = read_launches(pk, ps)
    verdicts = list(ctx.mesh_exec.prune_verdicts.values())
    need = ["radix_upsweep", "radix_pass"]
    if W > 1:
        need += ["partition_histogram", "presence_fill"]
        if verdicts != [True]:
            raise AssertionError(f"W={W} WordCount: the dup-detection "
                                 f"verdict is {verdicts}, expected on")
    for name in need:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the W={W} "
                                 f"WordCount path")
    w, c = out["w"].cpu().numpy(), out["c"].cpu().numpy()
    got_ids = word_ids(np, w)
    voc_h = voc.cpu().numpy()
    present = np.flatnonzero(want)
    if (len(got_ids) != len(present)
            or not np.array_equal(np.sort(got_ids), present)
            or not np.array_equal(c, want[got_ids])
            or not np.array_equal(w, voc_h[got_ids])):
        raise AssertionError(f"W={W} WordCount differs from np.bincount")
    log(f"wordcount W={W} n={n}: {len(present)} distinct words, equal to "
        f"np.bincount; {secs:.3f} s (first run, host clock after "
        f"synchronize, data resident); launches {json.dumps(launches)}; "
        f"dup verdicts {verdicts}; exchanged items "
        f"{ctx.mesh_exec.stats_items_moved}")
    del out
    warm = []
    for _ in range(2):
        ctx2 = tt.Context(num_workers=W, device=DEVICE)
        src2 = ctx2.Distribute(recs).Keep()
        src2.Execute()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(ctx2, src2)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        del res
    log(f"wordcount W={W} warm ReduceByKey+AllGatherArrays seconds: "
        f"{[round(x, 6) for x in warm]} (host clock after synchronize)")
    if W > 1:
        from torch.profiler import ProfilerActivity, profile as tprof
        ctx3 = tt.Context(num_workers=W, device=DEVICE)
        src3 = ctx3.Distribute(recs).Keep()
        src3.Execute()
        torch.cuda.synchronize()
        with tprof(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            run(ctx3, src3)
            torch.cuda.synchronize()
        log(prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25))
    return launches, cap.args, cap_sc.args


def pagerank_step(torch, np, tt, pk, ps, reduce_mod, exchange_mod):
    """The PageRank contribution step at W=4: 2^24 edges with Zipf
    targets into 2^22 pages. Returns the launches of the checked run and
    the segment_sum and send_counts inputs it made."""
    W = 4
    n = W * PER_WORKER
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    d = zipf_ids(torch, n, PAGES, gen)
    v = torch.rand(n, device=DEVICE, generator=gen)
    edges = {"d": d, "v": v}
    red = tt.FieldReduce({"d": "first", "v": "sum"})

    def run(src):
        return src.ReduceToIndex(lambda c: c["d"], red, PAGES,
                                 neutral={"d": 0, "v": 0.0}).AllGatherArrays()

    ctx = tt.Context(num_workers=W, device=DEVICE)
    src = ctx.Distribute(edges).Keep()
    src.Execute()
    torch.cuda.synchronize()
    zero_launches(pk, ps)
    with Capture(reduce_mod, "segment_sum") as cap, \
            Capture(exchange_mod, "send_counts") as cap_sc:
        t0 = time.perf_counter()
        out = run(src)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = read_launches(pk, ps)
    for name in ("segment_sum", "partition_histogram", "radix_upsweep",
                 "radix_pass"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the "
                                 f"ReduceToIndex path")
    dh, vh = d.cpu().numpy(), v.cpu().numpy().astype(np.float64)
    want = np.bincount(dh, weights=vh, minlength=PAGES)
    scale = want        # v >= 0: each page's sum of |v|
    got_v = out["v"].cpu().numpy().astype(np.float64)
    got_d = out["d"].cpu().numpy()
    hit = np.bincount(dh, minlength=PAGES) > 0
    err = np.abs(got_v - want)
    if (got_v.shape != (PAGES,) or not np.isfinite(got_v).all()
            or not (err <= SEG_RTOL * scale + SEG_ATOL).all()
            or not np.array_equal(got_d, np.where(hit, np.arange(PAGES), 0))):
        raise AssertionError(f"ReduceToIndex differs from np.bincount: max "
                             f"|diff| {err.max()}")
    log(f"pagerank step W={W} edges={n} pages={PAGES}: within {SEG_RTOL} "
        f"of np.bincount in f64 (max |diff| {err.max():.6g}, largest page "
        f"sum {want.max():.6g}); {secs:.3f} s (first run, host clock after "
        f"synchronize, data resident); launches {json.dumps(launches)}; "
        f"exchanged items {ctx.mesh_exec.stats_items_moved}")
    del out
    warm = []
    for _ in range(2):
        ctx2 = tt.Context(num_workers=W, device=DEVICE)
        src2 = ctx2.Distribute(edges).Keep()
        src2.Execute()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(src2)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        del res
    log(f"pagerank step W={W} warm ReduceToIndex+AllGatherArrays seconds: "
        f"{[round(x, 6) for x in warm]} (host clock after synchronize)")
    from torch.profiler import ProfilerActivity, profile as tprof
    ctx3 = tt.Context(num_workers=W, device=DEVICE)
    src3 = ctx3.Distribute(edges).Keep()
    src3.Execute()
    torch.cuda.synchronize()
    with tprof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        run(src3)
        torch.cuda.synchronize()
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
    return launches, cap.args, cap_sc.args


def host_profile(torch, label: str, fn) -> None:
    """The host's time by function (cProfile, sorted by own time) over
    one call of ``fn``: where the host clock goes that the device table
    does not show."""
    import cProfile
    import io
    import pstats
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    secs = time.perf_counter() - t0
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(15)
    lines = [l for l in out.getvalue().splitlines() if l.strip()]
    log(f"host profile {label}: {secs:.3f} s under cProfile")
    for line in lines[-16:]:
        log("  " + line.strip())


def page_rank_np(np, edges, n: int, iters: int, damp: float):
    """The example's page_rank_dense with np.bincount for np.add.at."""
    src, dst = edges[:, 0], edges[:, 1]
    inv_deg = 1.0 / np.maximum(np.bincount(src, minlength=n), 1)
    r = np.full(n, 1.0 / n)
    for _ in range(iters):
        contrib = np.bincount(dst, weights=r[src] * inv_deg[src],
                              minlength=n)
        r = (1 - damp) / n + damp * contrib
    return r


def pagerank(torch, np, tt, W: int, iters: int, edges, pk, ps):
    """``page_rank`` of the port's example, end to end through its entry
    points; returns the launches of the checked run."""
    from thrill_tpu_torch.examples import page_rank as tpr
    want = page_rank_np(np, edges, PAGES, iters, tpr.DAMPENING)
    mem = {}
    real_iterate = tpr.Iterate

    def iterate(ctx, body, carry, n, **kw):
        calls = [0]

        def body_after(d):
            calls[0] += 1
            if calls[0] == 3:      # iterations 1 and 2 are materialized
                torch.cuda.synchronize()
                mem[2] = (torch.cuda.max_memory_allocated(),
                          torch.cuda.memory_allocated())
            return body(d)

        out = real_iterate(ctx, body_after, carry, n, **kw)
        torch.cuda.synchronize()
        mem[n] = (torch.cuda.max_memory_allocated(),
                  torch.cuda.memory_allocated())
        return out

    ctx = tt.Context(num_workers=W, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(pk, ps)
    tpr.Iterate = iterate
    try:
        t0 = time.perf_counter()
        got = tpr.page_rank(ctx, edges, PAGES, iters)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        tpr.Iterate = real_iterate
    launches = read_launches(pk, ps)
    if W > 1:
        for name in ("partition_histogram", "radix_upsweep", "radix_pass"):
            if launches[name] <= 0:
                raise AssertionError(f"{name} was not launched on the W={W} "
                                     f"PageRank path")
    err = np.abs(got - want)
    if (got.shape != (PAGES,) or got.dtype != np.float64
            or not np.isfinite(got).all()
            or not (err <= PR_RTOL * want + PR_ATOL).all()):
        raise AssertionError(f"W={W} PageRank differs from numpy: max |diff| "
                             f"{err.max()}, max relative "
                             f"{(err / want).max()}")
    if iters > 2 and (mem[iters][0] > PR_MEM_SLACK * mem[2][0]
                      or mem[iters][1] > PR_MEM_SLACK * mem[2][1]):
        raise AssertionError(f"W={W} PageRank: device memory grew from "
                             f"iteration 2 to {iters}: (peak, current) "
                             f"{mem[2]} -> {mem[iters]}")
    # the actions on the ranks, against numpy
    ranks = ctx.Distribute(torch.as_tensor(got, device=DEVICE)).Keep(2)
    acts = {"Sum": (ranks.Sum(), want.sum()), "Min": (ranks.Min(),
                                                      want.min()),
            "Max": (ranks.Max(), want.max())}
    for name, (g, w) in acts.items():
        if not abs(g - w) <= PR_RTOL * abs(w) + PR_ATOL:
            raise AssertionError(f"W={W} PageRank ranks.{name}() = {g}, "
                                 f"numpy {w}")
    log(f"pagerank W={W} pages={PAGES} edges={len(edges)} iterations={iters}"
        f" f64: every page within {PR_RTOL} of its rank + {PR_ATOL} of numpy"
        f" (max |diff| {err.max():.6g}, max relative "
        f"{(err / want).max():.6g}); Sum/Min/Max "
        f"{[acts[k][0] for k in acts]} against numpy "
        f"{[float(acts[k][1]) for k in acts]}; {secs:.3f} s (first run, "
        f"host clock after synchronize, from numpy edges to numpy ranks); "
        f"launches {json.dumps(launches)}; exchanged items "
        f"{ctx.mesh_exec.stats_items_moved}; device memory (peak, current) "
        f"bytes after iteration 2 {mem.get(2)}, after iteration {iters} "
        f"{mem[iters]}")
    del ranks
    warm = []
    for _ in range(2):
        ctx2 = tt.Context(num_workers=W, device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tpr.page_rank(ctx2, edges, PAGES, iters)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    log(f"pagerank W={W} warm page_rank seconds: "
        f"{[round(x, 6) for x in warm]} (host clock after synchronize)")
    if W > 1:
        profile_table(torch, lambda: tpr.page_rank(
            tt.Context(num_workers=W, device=DEVICE), edges, PAGES, iters))
    host_profile(torch, f"pagerank W={W}", lambda: tpr.page_rank(
        tt.Context(num_workers=W, device=DEVICE), edges, PAGES, iters))
    return launches


def q3_np(np, orders, lineitem, cutoff: int = 1250):
    """q3_dense of the example, vectorized: the orders' keys are their
    row numbers."""
    ok = (orders["date"] < cutoff)[lineitem["orderkey"]]
    prio = orders["prio"][lineitem["orderkey"]]
    rev = lineitem["price"] * (100 - lineitem["discount_pct"])
    return np.array([int(rev[ok & (prio == p)].sum()) for p in range(5)],
                    dtype=np.int64)


def tpch(torch, np, tt, W: int, tables, pk, ps, join_mod):
    """``q3_lite`` of the port's example with the cost model's
    location-detection verdict, forced on and forced off. Returns the
    launches of the verdict's and the forced run and the presence_fill
    inputs of the forced run."""
    from thrill_tpu_torch.examples import tpch as ttp
    orders, lineitem = tables
    want = q3_np(np, orders, lineitem)
    runs = {}
    for mode, ld in (("verdict", None), ("on", True), ("off", False)):
        if W == 1 and mode != "verdict":
            continue
        ctx = tt.Context(num_workers=W, device=DEVICE)
        torch.cuda.synchronize()
        zero_launches(pk, ps)
        with Capture(join_mod, "presence_fill") as cap:
            t0 = time.perf_counter()
            got = ttp.q3_lite(ctx, orders, lineitem, location_detection=ld)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches = read_launches(pk, ps)
        if got.dtype != np.int64 or not np.array_equal(got, want):
            raise AssertionError(f"W={W} Q3-lite ({mode}) = {got.tolist()}, "
                                 f"numpy {want.tolist()}")
        if W > 1:
            for name in ("partition_histogram", "radix_upsweep",
                         "radix_pass"):
                if launches[name] <= 0:
                    raise AssertionError(f"{name} was not launched on the "
                                         f"W={W} Q3-lite path ({mode})")
        if mode == "on" and launches["presence_fill"] < 2:
            raise AssertionError(f"W={W} Q3-lite with location detection: "
                                 f"{launches['presence_fill']} presence_fill "
                                 f"launches, expected one a side")
        verdicts = {str(k[0]): v for k, v in
                    ctx.mesh_exec.prune_verdicts.items()}
        runs[mode] = dict(launches=launches, calls=cap.calls)
        log(f"tpch q3 W={W} orders={len(orders['key'])} lineitems="
            f"{len(lineitem['orderkey'])} location detection {mode}: equal "
            f"to numpy {want.tolist()}; verdicts {verdicts}; {secs:.3f} s "
            f"(first run, host clock after synchronize, from numpy tables); "
            f"launches {json.dumps(launches)}; exchanged items "
            f"{ctx.mesh_exec.stats_items_moved}")
    warm = []
    for _ in range(2):
        ctx2 = tt.Context(num_workers=W, device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ttp.q3_lite(ctx2, orders, lineitem)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    log(f"tpch q3 W={W} warm q3_lite seconds (the verdict's path): "
        f"{[round(x, 6) for x in warm]} (host clock after synchronize)")
    if W > 1:
        profile_table(torch, lambda: ttp.q3_lite(
            tt.Context(num_workers=W, device=DEVICE), orders, lineitem))
        host_profile(torch, f"tpch q3 W={W}", lambda: ttp.q3_lite(
            tt.Context(num_workers=W, device=DEVICE), orders, lineitem))
    return runs


def profile_table(torch, fn):
    """A torch.profiler table (device time by op) of one call of ``fn``;
    returns the device's busy time in ms (one stream) and the call's wall
    seconds under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprof
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tprof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    log(avgs.table(sort_by="cuda_time_total", row_limit=25))
    # the device's own events (kernels, copies): an op's row repeats its
    # kernels' time, as the table's "Self CUDA time total" leaves it out
    busy = sum(e.self_device_time_total for e in avgs
               if e.device_type == DeviceType.CUDA)
    return busy / 1e3, wall


def warm_seconds(torch, fn, calls: int):
    out = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def lloyd_np(np, pts, c, iters: int):
    """Lloyd's iterations in numpy with the example's distance formula
    (x.x - 2 x c^T + c.c, the first minimum), KM_CHUNK rows at a time (the
    example's k_means_dense builds [n, k, dim]: 10.7 GB here). The points
    are held transposed, so that the products are one ``c @ x^T`` and
    every column is contiguous (``x @ c.T`` of a skinny ``x`` took numpy
    minutes here). Returns the centers and each iteration's count of
    points per cluster."""
    k, dim = c.shape
    pts_t = np.ascontiguousarray(pts.T)
    xx = np.einsum("ij,ij->i", pts, pts)
    counts = []
    for _ in range(iters):
        sums = np.zeros((k, dim))
        cnt = np.zeros(k, dtype=np.int64)
        cc = (c * c).sum(1)
        for s in range(0, len(pts), KM_CHUNK):
            xt = pts_t[:, s:s + KM_CHUNK]
            # (x.x - 2 x c^T) + c.c in place: adding -2 x c^T is the
            # subtraction, bit for bit
            d2 = c @ xt
            d2 *= -2.0
            d2 += xx[None, s:s + KM_CHUNK]
            d2 += cc[:, None]
            # the first minimum, as argmin: a later cluster wins only
            # when strictly nearer
            best, lab = d2[0].copy(), np.zeros(xt.shape[1], dtype=np.int64)
            for j in range(1, k):
                np.putmask(lab, d2[j] < best, j)
                np.minimum(best, d2[j], out=best)
            cnt += np.bincount(lab, minlength=k)
            for j in range(dim):
                sums[:, j] += np.bincount(lab, weights=xt[j], minlength=k)
        counts.append(cnt)
        c = np.where((cnt > 0)[:, None], sums / np.maximum(cnt, 1)[:, None],
                     c)
    return c, counts


def kmeans(torch, np, tt, W: int, iters: int, pts, pk, ps, exchange_mod,
           card: str):
    """``k_means`` of the port's example end to end (points from numpy
    to numpy centers): held against lloyd_np, centers and every
    iteration's counts; returns the launches of the checked run and the
    send_counts input of its last exchange (W > 1)."""
    from thrill_tpu_torch.examples import k_means as tkm
    c0 = pts[np.random.default_rng(0).choice(len(pts), KM_K, replace=False)]
    t0 = time.perf_counter()
    want, want_counts = lloyd_np(np, pts, c0, iters)
    np_secs = time.perf_counter() - t0
    mem, cnts = {}, []
    real_iterate, real_update = tkm.Iterate, tkm._center_update

    def update(sum_x, cnt, centers):
        cnts.append(cnt.clone())
        return real_update(sum_x, cnt, centers)

    def iterate(ctx, body, carry, n, **kw):
        calls = [0]

        def body_after(c):
            calls[0] += 1
            if calls[0] == 3:      # iterations 1 and 2 are done
                torch.cuda.synchronize()
                mem[2] = (torch.cuda.max_memory_allocated(),
                          torch.cuda.memory_allocated())
            return body(c)

        out = real_iterate(ctx, body_after, carry, n, **kw)
        torch.cuda.synchronize()
        mem[n] = (torch.cuda.max_memory_allocated(),
                  torch.cuda.memory_allocated())
        return out

    ctx = tt.Context(num_workers=W, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(pk, ps)
    tkm.Iterate, tkm._center_update = iterate, update
    try:
        with Capture(exchange_mod, "send_counts", keep_all=False) as cap_sc:
            t0 = time.perf_counter()
            got = tkm.k_means(ctx, pts, KM_K, iters)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    finally:
        tkm.Iterate, tkm._center_update = real_iterate, real_update
    launches = read_launches(pk, ps)
    stats = ctx.overall_stats()
    err = np.abs(got - want)
    if (got.shape != (KM_K, KM_DIM) or not np.isfinite(got).all()
            or not (err <= KM_RTOL * (1 + np.abs(want))).all()):
        raise AssertionError(f"W={W} k-means centers differ from numpy: max "
                             f"|diff| {err.max()}")
    got_counts = [c.cpu().numpy() for c in cnts]
    if len(got_counts) != iters or any(
            not np.array_equal(g, w) for g, w in zip(got_counts,
                                                     want_counts)):
        raise AssertionError(f"W={W} k-means label counts differ from "
                             f"numpy: {got_counts} vs {want_counts}")
    if W > 1:
        # one range exchange an iteration: its send counts (B1), and one
        # upsweep and one pass (the destination's 3 bits are one digit)
        for name in ("partition_histogram", "radix_upsweep", "radix_pass"):
            if launches[name] != iters:
                raise AssertionError(f"W={W} k-means: {launches[name]} "
                                     f"{name} launches, expected {iters}")
        if stats["exchanges"] != iters:
            raise AssertionError(f"W={W} k-means: {stats['exchanges']} "
                                 f"exchanges, expected {iters}")
    if iters > 2 and (mem[iters][0] > PR_MEM_SLACK * mem[2][0]
                      or mem[iters][1] > PR_MEM_SLACK * mem[2][1]):
        raise AssertionError(f"W={W} k-means: device memory grew from "
                             f"iteration 2 to {iters}: (peak, current) "
                             f"{mem[2]} -> {mem[iters]}")
    log(f"k-means W={W} points={len(pts)} dim={KM_DIM} k={KM_K} "
        f"iterations={iters} f64: centers within {KM_RTOL} x (1 + |c|) of "
        f"numpy's Lloyd (max |diff| {err.max():.6g}), label counts equal in "
        f"every iteration (last "
        f"{got_counts[-1].astype(np.int64).tolist()}); {secs:.3f} s "
        f"(first run, host clock after synchronize, from numpy points to "
        f"numpy centers; numpy's Lloyd {np_secs:.1f} s); launches "
        f"{json.dumps(launches)}; exchanges {stats['exchanges']}, items "
        f"exchanged {stats['items_moved']} ({stats['items_moved'] // iters}"
        f" an iteration, {stats['bytes_moved'] // iters} bytes); device "
        f"memory (peak, current) bytes after iteration 2 {mem.get(2)}, "
        f"after iteration {iters} {mem[iters]} [{card}]")

    def run():
        tkm.k_means(tt.Context(num_workers=W, device=DEVICE), pts, KM_K,
                    iters)

    warm = warm_seconds(torch, run, 3)
    log(f"k-means W={W} warm k_means seconds: {[round(x, 6) for x in warm]} "
        f"(host clock after synchronize) [{card}]")
    busy, wall = profile_table(torch, run)
    med = sorted(warm)[1]
    log(f"k-means W={W} device busy {busy:.3f} ms in the profiled call "
        f"({wall:.3f} s under the profiler); idle share against the warm "
        f"median {med:.3f} s: {1 - busy / 1e3 / med:.4f} [{card}]")
    if W > 1:
        host_profile(torch, f"k-means W={W}", run)
    return launches, cap_sc.args


def select_kth_phase(torch, np, tt, pk, ps, card: str):
    """``select_kth`` of the port's example at W=4 over SK_VALUES int64
    values in [0, 2^40), k = n/2: equal to np.partition. Returns the
    launches (each round's Sample argsorts its scores: B2)."""
    from thrill_tpu_torch.examples import select_kth as tsk
    vals = np.random.default_rng(SEED + 60).integers(0, 1 << 40, SK_VALUES)
    k = SK_VALUES // 2
    want = int(np.partition(vals, k)[k])
    rounds = [0]
    real = tt.DIA.Sample

    def sample(self, *a, **kw):
        rounds[0] += 1
        return real(self, *a, **kw)

    ctx = tt.Context(num_workers=4, device=DEVICE)
    torch.cuda.synchronize()
    zero_launches(pk, ps)
    tt.DIA.Sample = sample
    try:
        t0 = time.perf_counter()
        got = tsk.select_kth(ctx, vals, k)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        tt.DIA.Sample = real
    launches = read_launches(pk, ps)
    if got != want:
        raise AssertionError(f"select_kth = {got}, np.partition {want}")
    for name in ("radix_upsweep", "radix_pass"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the "
                                 f"select_kth path")
    log(f"select_kth W=4 n={SK_VALUES} k={k}: {got}, equal to np.partition;"
        f" {rounds[0]} Sample rounds; {secs:.3f} s (first run, host clock "
        f"after synchronize, from numpy values); launches "
        f"{json.dumps(launches)} [{card}]")
    return launches


def sgd_phase(torch, np, tt, pk, ps, sample_mod, card: str):
    """``sgd_linear`` of the port's example at W=4: with every row in the
    batch, within SGD_RTOL of numpy's full-batch descent; at a batch
    fraction of 0.25 every batch's size within 5 sigma of n p and the
    error to the true weights at most numpy's full-batch error + 0.01.
    Returns the launches of the sampled run."""
    from thrill_tpu_torch.examples import sgd as tsg
    rng = np.random.default_rng(SEED + 70)
    true_w = rng.normal(size=SGD_DIM)
    X = rng.normal(size=(SGD_ROWS, SGD_DIM))
    y = X @ true_w + 0.01 * rng.normal(size=SGD_ROWS)
    lr, p = 0.1, 0.25
    w_np = np.zeros(SGD_DIM)
    for _ in range(SGD_ITERS):
        w_np = w_np - lr * (X.T @ (X @ w_np - y)) / SGD_ROWS
    err_np = float(np.linalg.norm(w_np - true_w))
    full = tsg.sgd_linear(tt.Context(num_workers=4, device=DEVICE), X, y,
                          iterations=SGD_ITERS, batch_fraction=1.0)
    diff = float(np.abs(full - w_np).max())
    if not diff <= SGD_RTOL * max(1.0, float(np.abs(w_np).max())):
        raise AssertionError(f"sgd full batch differs from numpy: {diff}")
    sizes = []
    real_cv = sample_mod.compact_valid

    def compact(tree, mask):
        sizes.append(mask.sum())
        return real_cv(tree, mask)

    ctx = tt.Context(num_workers=4, device=DEVICE)
    torch.cuda.synchronize()
    zero_launches(pk, ps)
    sample_mod.compact_valid = compact
    try:
        t0 = time.perf_counter()
        w = tsg.sgd_linear(ctx, X, y, iterations=SGD_ITERS,
                           batch_fraction=p)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        sample_mod.compact_valid = real_cv
    launches = read_launches(pk, ps)
    sizes = [int(s) for s in sizes]
    sigma = (SGD_ROWS * p * (1 - p)) ** 0.5
    if len(sizes) != SGD_ITERS or any(abs(s - SGD_ROWS * p) > 5 * sigma
                                      for s in sizes):
        raise AssertionError(f"sgd batch sizes {sizes} not within 5 sigma "
                             f"({sigma:.1f}) of {SGD_ROWS * p}")
    err = float(np.linalg.norm(w - true_w))
    if not err <= err_np + 0.01:
        raise AssertionError(f"sgd error {err} > numpy's full batch "
                             f"{err_np} + 0.01")
    log(f"sgd W=4 rows={SGD_ROWS} dim={SGD_DIM} iterations={SGD_ITERS}: full "
        f"batch within {SGD_RTOL} of numpy (max |diff| {diff:.6g}); at "
        f"p={p} batch sizes {min(sizes)}..{max(sizes)} (n p = "
        f"{SGD_ROWS * p:.0f}, 5 sigma = {5 * sigma:.0f}), error to the true "
        f"weights {err:.6g} against numpy's full batch {err_np:.6g}; "
        f"{secs:.3f} s (sampled run, host clock after synchronize, from "
        f"numpy rows); launches {json.dumps(launches)} [{card}]")
    return launches


def suffix_array_phase(torch, np, tt, pk, ps, card: str):
    """``suffix_array`` (prefix doubling) of the port's example at W=4 over
    SA_BYTES random letters of ACGT: check_sa must hold; one Sort a round,
    every pass launch a live pass. Returns the launches."""
    from thrill_tpu_torch.examples import suffix_sorting as tss
    rng = np.random.default_rng(SEED + 80)
    text = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4,
                                                                SA_BYTES)]
    ctx = tt.Context(num_workers=4, device=DEVICE)
    rounds = [0]
    real = ctx.Distribute

    def distribute(items, storage=None):
        rounds[0] += 1
        return real(items, storage)

    ctx.Distribute = distribute
    torch.cuda.synchronize()
    zero_launches(pk, ps)
    t0 = time.perf_counter()
    sa = tss.suffix_array(ctx, text)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(pk, ps)
    live = sum(p[0] for p in ctx.mesh_exec.radix_passes)
    if not tss.check_sa(text, sa):
        raise AssertionError("suffix_array fails check_sa")
    if launches["partition_histogram"] != rounds[0]:
        raise AssertionError(f"suffix_array: {rounds[0]} Sorts but "
                             f"{launches['partition_histogram']} send counts")
    if launches["radix_upsweep"] <= 0 or launches["radix_pass"] != live:
        raise AssertionError(f"suffix_array: {launches['radix_pass']} pass "
                             f"launches for {live} live passes")
    warm = warm_seconds(torch, lambda: tss.suffix_array(
        tt.Context(num_workers=4, device=DEVICE), text), 2)
    log(f"suffix_array W=4 n={SA_BYTES} (ACGT): check_sa holds; {rounds[0]} "
        f"doubling rounds; {secs:.3f} s (first run, host clock after "
        f"synchronize, from numpy text to numpy suffix array), warm "
        f"{[round(x, 6) for x in warm]}; launches {json.dumps(launches)}; "
        f"exchanged items {ctx.mesh_exec.stats_items_moved} [{card}]")
    return launches


def wavelet_phase(torch, np, tt, pk, ps, card: str):
    """``wavelet_tree`` of the port's example at W=4 over WT_BYTES random
    bytes: every level equal to numpy's stable partition by the bit.
    Returns the launches."""
    from thrill_tpu_torch.examples import suffix_sorting as tss
    text = np.random.default_rng(SEED + 90).integers(0, 256, WT_BYTES
                                                     ).astype(np.uint8)
    want, cur = [], text
    for b in reversed(range(8)):
        bit = (cur >> b) & 1
        want.append(np.packbits(bit))
        cur = cur[np.argsort(bit, kind="stable")]
    ctx = tt.Context(num_workers=4, device=DEVICE)
    torch.cuda.synchronize()
    zero_launches(pk, ps)
    t0 = time.perf_counter()
    got = tss.wavelet_tree(ctx, text)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(pk, ps)
    if len(got) != 8 or any(not np.array_equal(g, w)
                            for g, w in zip(got, want)):
        raise AssertionError("wavelet_tree differs from numpy's stable "
                             "partitions")
    log(f"wavelet_tree W=4 n={WT_BYTES}: 8 levels equal to numpy's stable "
        f"partitions; {secs:.3f} s (host clock after synchronize, from "
        f"numpy text); launches {json.dumps(launches)} [{card}]")
    return launches


def time_send_counts(torch, pk, label, dest, W):
    """The send-count histogram on one captured ``send_counts`` input (the
    kernel reads it as it is): held against the plain version, then timed
    (``ms``), behind the int32 copy that ``send_counts`` made before the
    kernel took int64 ids (``copy_ms``), beside the plain version, one
    bincount and the bound: the ids' bytes as the caller holds them plus
    the output."""
    R, n = dest.shape
    if not torch.equal(pk.partition_histogram(dest, W),
                       pk.partition_histogram_plain(dest, W)):
        raise AssertionError(f"partition_histogram disagrees with its plain "
                             f"version on the {label} input")
    d64 = dest.to(torch.int64)
    flat = (torch.where((d64 >= 0) & (d64 < W), d64, torch.full_like(d64, W))
            + torch.arange(R, device=dest.device)[:, None] * (W + 1)
            ).reshape(-1)
    del d64
    b, by = bound(dest.numel() * dest.element_size() + R * W * 4, R * n)
    row = dict(
        ms=cuda_ms(torch, lambda: pk.partition_histogram(dest, W)),
        copy_ms=cuda_ms(torch, lambda: pk.partition_histogram(
            dest.to(torch.int32).contiguous(), W)),
        plain_ms=cuda_ms(torch, lambda: pk.partition_histogram_plain(dest,
                                                                    W)),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.bincount(
            flat, minlength=R * (W + 1))))
    rows_sorted = bool((dest[:, 1:] >= dest[:, :-1]).all())
    log(f"time partition_histogram on the {label} send_counts input [{R}, "
        f"{n}] {str(dest.dtype)[6:]}, {W} bins, sorted rows {rows_sorted}, "
        f"{int((dest < W).sum())} valid ids: " + json.dumps(row))
    return row


def time_main_path_inputs(torch, pk, seg_args, pres_args, sc_args,
                          join_pres):
    """The kernels on the inputs the W=4 runs gave them: held against the
    plain version, then timed beside the plain version, one library call
    and the bound. Returns the rows of the kernels line (the histogram's
    and the presence fill's from the WordCount inputs) and the worst
    errors."""
    rows, errs = {}, {}
    for label, (dest, W) in sc_args.items():
        row = time_send_counts(torch, pk, label, dest, W)
        if label == "WordCount":
            rows["partition_histogram"] = row
    errs["partition_histogram"] = 0
    ids, vals, segs = seg_args
    R, n = ids.shape
    err, ok = seg_err(torch, pk, ids, vals, segs,
                      pk.segment_sum(ids, vals, segs))
    if not ok:
        raise AssertionError(f"segment_sum disagrees with its plain version "
                             f"on the main path's inputs: {err}")
    errs["segment_sum"] = err
    flat = torch.where((ids >= 0) & (ids < segs), ids.to(torch.int64),
                       torch.full_like(ids, segs, dtype=torch.int64))
    flat = (flat + torch.arange(R, device=ids.device)[:, None] * (segs + 1)
            ).reshape(-1)
    acc = torch.zeros(R * (segs + 1), device=ids.device)
    vflat = vals.reshape(-1)
    b, by = bound(R * n * 8 + R * segs * 4, R * n)
    rows["segment_sum"] = dict(
        ms=cuda_ms(torch, lambda: pk.segment_sum(ids, vals, segs)),
        plain_ms=cuda_ms(torch, lambda: pk.segment_sum_plain(ids, vals,
                                                             segs)),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(torch, lambda: acc.index_add_(0, flat, vflat)))
    log(f"time segment_sum at the main path's [{R}, {n}], {segs} segments: "
        + json.dumps(rows["segment_sum"]))
    rows["presence_fill"] = time_presence_fill(torch, pk, "WordCount",
                                               *pres_args)
    for label, args in join_pres.items():
        time_presence_fill(torch, pk, label, *args)
    errs["presence_fill"] = 0
    return rows, errs


def time_presence_fill(torch, pk, label, h, valid, regs):
    """presence_fill on one captured input (the call site's int64
    register ids from hashing.umod): held against the plain version, then
    timed beside its int32 copy, the plain version, one index_put_ and
    the bound."""
    R, n = h.shape
    if not torch.equal(pk.presence_fill(h, valid, regs),
                       pk.presence_fill_plain(h, valid, regs)):
        raise AssertionError(f"presence_fill disagrees with its plain "
                             f"version on the {label} input")
    ok = valid & (h >= 0) & (h < regs)
    flat = torch.where(ok, h, torch.full_like(h, regs))
    flat = (flat + torch.arange(R, device=h.device)[:, None] * (regs + 1)
            ).reshape(-1)
    reg = torch.zeros(R * (regs + 1), dtype=torch.uint8, device=h.device)
    one = torch.ones((), dtype=torch.uint8, device=h.device)
    # what these inputs need: every flag, the id of each valid row (int64,
    # as the call site holds it), the registers written once
    nvalid = int(valid.sum())
    b, by = bound(R * n + nvalid * h.element_size() + R * regs, R * n)
    row = dict(
        ms=cuda_ms(torch, lambda: pk.presence_fill(h, valid, regs)),
        copy_ms=cuda_ms(torch, lambda: pk.presence_fill(
            h.to(torch.int32), valid, regs)),
        plain_ms=cuda_ms(torch, lambda: pk.presence_fill_plain(h, valid,
                                                               regs)),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(torch, lambda: reg.index_put_((flat,), one)))
    old_b, _ = bound(R * n * 5 + R * regs, R * n)
    log(f"time presence_fill on the {label} input [{R}, {n}], {regs} "
        f"registers, {nvalid} valid rows ({nvalid / (R * n):.4f}; the bound "
        f"that counted 5 bytes a row: {old_b}): " + json.dumps(row))
    return row


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import thrill_tpu_torch as tt
    from thrill_tpu_torch.common import native_build
    from thrill_tpu_torch.api.ops import join as join_mod
    from thrill_tpu_torch.api.ops import reduce as reduce_mod
    from thrill_tpu_torch.api.ops import sample as sample_mod
    from thrill_tpu_torch.data import exchange as exchange_mod
    from thrill_tpu_torch.examples import page_rank as tpr
    from thrill_tpu_torch.examples import tpch as ttp
    from thrill_tpu_torch.core import pallas_kernels as pk
    from thrill_tpu_torch.core import pallas_sort as ps

    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    native_build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for "
        f"{native_build.sources()}")
    for name, text in native_build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"  ptxas {name}: {line.strip()}")

    errs = check_kernels(torch, np, pk, ps)
    times = time_kernels(torch, np, pk, ps)
    time_argsort(torch, np)
    sort4, sc_sort = terasort(torch, np, tt, 4, pk, ps, exchange_mod)
    terasort(torch, np, tt, 1, pk, ps, exchange_mod)
    wc4, pres_args, sc_wc = wordcount(torch, np, tt, 4, pk, ps, reduce_mod,
                                      exchange_mod)
    wordcount(torch, np, tt, 1, pk, ps, reduce_mod, exchange_mod)
    step4, seg_args, sc_pr = pagerank_step(torch, np, tt, pk, ps, reduce_mod,
                                           exchange_mod)
    edges = tpr.zipf_graph(PAGES, PR_EDGES, seed=SEED + 30)
    pr4 = pagerank(torch, np, tt, 4, PR_ITERS, edges, pk, ps)
    pagerank(torch, np, tt, 1, 3, edges, pk, ps)
    del edges
    tables = ttp.generate_tables(ORDERS, 4, seed=SEED + 40)
    q3 = tpch(torch, np, tt, 4, tables, pk, ps, join_mod)
    tpch(torch, np, tt, 1, tables, pk, ps, join_mod)
    del tables
    pts = np.random.default_rng(SEED + 50).normal(size=(KM_POINTS, KM_DIM))
    km4, sc_km = kmeans(torch, np, tt, 4, KM_ITERS, pts, pk, ps,
                        exchange_mod, card)
    kmeans(torch, np, tt, 1, 3, pts, pk, ps, exchange_mod, card)
    del pts
    sk4 = select_kth_phase(torch, np, tt, pk, ps, card)
    sgd4 = sgd_phase(torch, np, tt, pk, ps, sample_mod, card)
    sa4 = suffix_array_phase(torch, np, tt, pk, ps, card)
    wt4 = wavelet_phase(torch, np, tt, pk, ps, card)
    sc_args = {"Sort": sc_sort, "WordCount": sc_wc, "PageRank step": sc_pr,
               "k-means": sc_km}
    # the location filter's register ids, left side (orders) then right
    join_pres = {f"Q3-lite {side} location-filter": args for side, args in
                 zip(("orders", "lineitem"), q3["on"]["calls"])}
    if "--save-inputs" in sys.argv:
        out_dir = sys.argv[sys.argv.index("--save-inputs") + 1]
        os.makedirs(out_dir, exist_ok=True)
        torch.save({"send_counts": sc_args, "presence_fill": pres_args,
                    "join_presence_fill": join_pres},
                   os.path.join(out_dir, "main_inputs.pt"))
    main_times, main_errs = time_main_path_inputs(torch, pk, seg_args,
                                                  pres_args, sc_args,
                                                  join_pres)
    times.update(main_times)
    for k, e in main_errs.items():
        errs[k] = max(errs[k], e)

    # each kernel's launches on the path that runs it, counted from zero
    meta = {
        "partition_histogram": dict(
            source="thrill_tpu_torch/csrc/partition_histogram.cu",
            replaces="thrill_tpu/core/pallas_kernels.py:116",
            launches=wc4["partition_histogram"]),
        # the TPU kernel's stable partition became the radix engine's two
        # kernels; its offsets epilogue is timed and checked above but is
        # not on the main path
        "radix_upsweep": dict(
            source="thrill_tpu_torch/csrc/stable_partition.cu",
            replaces="thrill_tpu/core/pallas_sort.py:85",
            launches=sort4["radix_upsweep"]),
        "radix_pass": dict(
            source="thrill_tpu_torch/csrc/stable_partition.cu",
            replaces="thrill_tpu/core/pallas_sort.py:85",
            launches=sort4["radix_pass"]),
        "segment_sum": dict(
            source="thrill_tpu_torch/csrc/segment_sum.cu",
            replaces="thrill_tpu/core/pallas_kernels.py:187",
            launches=step4["segment_sum"]),
        "presence_fill": dict(
            source="thrill_tpu_torch/csrc/presence_fill.cu",
            replaces="thrill_tpu/core/pallas_kernels.py:239",
            launches=wc4["presence_fill"]),
    }
    # and on every W=4 path, each counted from zero
    paths = {"Sort W=4": sort4, "WordCount W=4": wc4,
             "PageRank step W=4": step4, "pagerank W=4": pr4,
             "tpch q3 W=4 (verdict)": q3["verdict"]["launches"],
             "tpch q3 W=4 (location detection on)": q3["on"]["launches"],
             "k-means W=4": km4, "select_kth W=4": sk4, "sgd W=4": sgd4,
             "suffix_array W=4": sa4, "wavelet_tree W=4": wt4}
    kernels = [dict(name=k, route="cuda", max_abs_err=errs[k], **m,
                    **times[k], paths={p: c[k] for p, c in paths.items()})
               for k, m in meta.items()]
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
