#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (thrill_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build every CUDA kernel from thrill_tpu_torch/csrc (one nvcc per
     source, all at once);
  2. hold each kernel against its plain PyTorch version on the card, at
     the main path's shapes and on edge cases (results are integers and
     must be bit-equal), and time kernel, plain version and library call;
  3. TeraSort through the port's API, Context -> Distribute -> Sort ->
     Size / AllGatherArrays, of 100-byte records (10-byte key, 90-byte
     value) made from a numpy seed: W=4 virtual workers x 2^22 records,
     then W=1 x 2^22. Kernel launch counters are zeroed just before and
     read just after each run; the output must equal np.lexsort's order
     of the same records (ties by global index); warm repeats give the
     Sort's time and, at W=4, a torch.profiler table of device time;
  4. print the card, the kernels line and, last, the device line.

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


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(torch, np, pk, ps):
    """Kernel vs plain version, bit for bit, on the card."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def ids(shape, lo, hi):
        return torch.as_tensor(rng.integers(lo, hi, size=shape,
                                            dtype=np.int32), device=dev)

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
    return errs


def time_kernels(torch, np, pk, ps):
    """Kernel, plain version and library call at the main path's shape
    (W=4 rows of 2^22 radix digits)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 1)
    R, n, bins = 4, PER_WORKER, 256
    d = torch.as_tensor(rng.integers(0, bins, size=(R, n), dtype=np.int32),
                        device=dev)
    rows = {}
    ms = cuda_ms(torch, lambda: pk.partition_histogram(d, bins))
    plain = cuda_ms(torch, lambda: pk.partition_histogram_plain(d, bins))
    b, by = bound(R * n * 4 + R * bins * 4, R * n)
    rows["partition_histogram"] = dict(ms=ms, plain_ms=plain, bound_ms=b,
                                       bound_by=by, library_ms=None)
    ms = cuda_ms(torch, lambda: ps.stable_partition_offsets(d, bins))
    plain = cuda_ms(torch, lambda: ps.stable_partition_offsets_plain(d, bins))
    lib = cuda_ms(torch, lambda: torch.sort(d, dim=1, stable=True))
    b, by = bound(R * n * 4 * 2, 2 * R * n)
    rows["stable_partition_offsets"] = dict(ms=ms, plain_ms=plain,
                                            bound_ms=b, bound_by=by,
                                            library_ms=lib)
    for k, v in rows.items():
        log(f"time {k} at [{R}, {n}] bins={bins}: " + json.dumps(v))
    return rows


def time_argsort(torch, np):
    """The whole multi-word argsort of Sort's phase 1 at W=4: the radix
    engine (both kernels) against the plain engine (stable torch.argsort
    per word) and one stable torch.sort of the most significant word."""
    from thrill_tpu_torch.core import device_sort, keys
    dev = torch.device("cuda")
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


def terasort(torch, np, tt, W: int, pk, ps):
    """One TeraSort through the port's API; returns the kernel launches
    of the checked run."""
    n = W * PER_WORKER
    rng = np.random.default_rng(SEED + W)
    rec = np.frombuffer(rng.bytes(n * 100), dtype=np.uint8).reshape(n, 100)
    recs = {"key": np.ascontiguousarray(rec[:, :10]),
            "value": np.ascontiguousarray(rec[:, 10:])}
    del rec
    ctx = tt.Context(num_workers=W)
    torch.cuda.synchronize()
    pk.partition_histogram.launches = 0
    ps.stable_partition_offsets.launches = 0
    t0 = time.perf_counter()
    d = ctx.Distribute(recs).Sort(key_fn=lambda r: r["key"]).Keep()
    size = d.Size()
    out = d.AllGatherArrays()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"partition_histogram": pk.partition_histogram.launches,
                "stable_partition_offsets":
                    ps.stable_partition_offsets.launches}
    passes = list(ctx.mesh_exec.radix_passes)
    if size != n:
        raise AssertionError(f"Size() = {size}, expected {n}")
    for name, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"{name} was not launched on the Sort path")
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
        ctx2 = tt.Context(num_workers=W)
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
        ctx3 = tt.Context(num_workers=W)
        src = ctx3.Distribute(recs).Keep()
        src.Execute()
        torch.cuda.synchronize()
        with tprof(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            src.Sort(key_fn=lambda r: r["key"]).AllGatherArrays()
            torch.cuda.synchronize()
        log(prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25))
    return launches


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import thrill_tpu_torch as tt
    from thrill_tpu_torch.common import native_build
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
    launches4 = terasort(torch, np, tt, 4, pk, ps)
    terasort(torch, np, tt, 1, pk, ps)

    meta = {
        "partition_histogram": dict(
            source="thrill_tpu_torch/csrc/partition_histogram.cu",
            replaces="thrill_tpu/core/pallas_kernels.py:116"),
        "stable_partition_offsets": dict(
            source="thrill_tpu_torch/csrc/stable_partition.cu",
            replaces="thrill_tpu/core/pallas_sort.py:85"),
    }
    kernels = [dict(name=k, route="cuda", source=m["source"],
                    replaces=m["replaces"], launches=launches4[k],
                    max_abs_err=errs[k], **times[k])
               for k, m in meta.items()]
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
