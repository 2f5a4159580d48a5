#!/usr/bin/env python3
"""Times the port's kernels on one GPU.

    python3 kernel_times.py [--inputs DIR]
    python3 kernel_times.py --paths REPS

At the main path's shapes: a radix pass over [4, 2^22] int64 keys carrying
int32 permutation entries (and the same pass reading the word through the
permutation, as a word's first pass does, and over one row), the
stable-partition offsets of [4, 2^22] digits, the upsweep of [4, 2^22]
words, the whole argsort of the W=4 TeraSort's phase 1 (two key words and
the global index), and segment_sum of 2^24 Zipf ids (weights 1/rank, as
the PageRank step's) and of 2^24 uniform ids over 2^22 segments; the
send-count histogram on sorted int64 destinations over 4 bins with an
invalid tail at [4, 2^22], as every W=4 exchange hands it over, and at
the off-path shape of [4, 2^22] random int32 ids over 256 bins, each in
five windows with L2 left warm and with L2 flushed before every call;
presence_fill at [4, 2^22] with a valid prefix of 22 % of each row and
2^17 registers, as the W=4 WordCount hands it over. With ``--inputs
DIR`` the histogram and presence_fill are timed also on the inputs that
``chip_smoke.py --save-inputs DIR`` captured on the main path. Each
kernel is first held against its plain version. Prints one JSON line of
milliseconds (CUDA events, mean of 10 calls after 2 warm-ups; 3 for the
argsort) and the card. chip_smoke.py is the full check; this script is
for comparing versions of the kernels' sources side by side: the
histogram and presence_fill are timed as their call sites run them, so
a version whose wrappers take int32 ids only is timed with the int32
copy its call sites made.

With ``--paths REPS`` it times instead the three W=4 paths of
chip_smoke.py end to end, REPS warm runs each (host clock after
synchronize, data resident, a fresh Context per run): TeraSort of 2^24
100-byte records, WordCount of 2^24 Zipf words over 2^20 16-byte words,
the PageRank step of 2^24 Zipf edges into 2^22 pages. It prints every
run's milliseconds, for A/B runs of whole trees in one call.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SEED = 20261016


def cuda_ms(torch, fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` calls queued behind a
    device sleep, so the host's time per call is not what is timed."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(torch, fn, flush, iters: int = 10) -> float:
    """Mean device time of ``fn`` with L2 flushed before each call (a
    write of ``flush``, outside the timed span)."""
    for _ in range(2):
        fn()
    spans = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in spans) / iters


def host_ms(torch, fn, iters: int = 50) -> float:
    """Host time of one call of ``fn`` while the device sleeps, so no call
    waits for the device."""
    import time
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs * 1e3 / iters


def id_form(torch, pk, x):
    """``x`` as this tree's kernels take ids: as it is where the wrapper
    takes its dtype, else an int32 copy."""
    ok = getattr(pk, "ID_DTYPES", (torch.int32,))
    return x if x.dtype in ok else x.to(torch.int32)


def time_b1_b4(torch, np, rng, dev, inputs_dir):
    """The histogram (as ``send_counts`` runs it, and the kernel alone)
    and presence_fill (as ReduceByKey's call site runs it) on synthetic
    main-path inputs and, with ``inputs_dir``, on captured ones; the
    histogram's time spread in windows, L2 warm and flushed."""
    from thrill_tpu_torch.core import pallas_kernels as pk
    from thrill_tpu_torch.data import exchange
    R, n, W = 4, 1 << 22, 4
    d = np.sort(rng.integers(0, W, (R, n)), axis=1)
    d[:, (9 * n) // 10:] = W                  # the invalid rows' sentinel
    sc = {"sorted_int64": (torch.as_tensor(d, device=dev), W)}
    regs = 1 << 17
    h = torch.as_tensor(rng.integers(0, 2**63, (R, n), dtype=np.int64)
                        % regs, device=dev)
    valid = torch.zeros((R, n), dtype=torch.bool, device=dev)
    valid[:, :(22 * n) // 100] = True
    pres = {"prefix22": (h, valid, regs)}
    if inputs_dir:
        saved = torch.load(os.path.join(inputs_dir, "main_inputs.pt"),
                           map_location=dev)
        for label, args in saved["send_counts"].items():
            sc["captured_" + label.replace(" ", "_")] = args
        pres["captured_WordCount"] = saved["presence_fill"]
    sc["offpath_int32_256"] = (torch.as_tensor(
        rng.integers(0, 256, (R, n), dtype=np.int32), device=dev), 256)
    flush = torch.empty(1 << 28, dtype=torch.uint8, device=dev)
    out, windows = {}, {}
    for label, (dest, bins) in sc.items():
        x = id_form(torch, pk, dest)
        if not torch.equal(pk.partition_histogram(x, bins),
                           pk.partition_histogram_plain(dest, bins)):
            raise AssertionError(f"partition_histogram differs on {label}")
        if bins == W:
            out["send_counts_" + label] = cuda_ms(
                torch, lambda: exchange.send_counts(dest, W))
        windows["hist_" + label] = [
            cuda_ms(torch, lambda: pk.partition_histogram(x, bins))
            for _ in range(5)]
        windows["hist_cold_" + label] = [
            cold_ms(torch, lambda: pk.partition_histogram(x, bins), flush)
            for _ in range(5)]
        out["hist_" + label] = sorted(windows["hist_" + label])[2]
        out["hist_cold_" + label] = sorted(windows["hist_cold_" + label])[2]
    # the wrappers' host time per call, queued behind a device sleep
    dest, _ = sc["sorted_int64"]
    h, valid, regs = pres["prefix22"]
    out["host_ms_send_counts"] = host_ms(
        torch, lambda: exchange.send_counts(dest, W))
    out["host_ms_presence_fill"] = host_ms(
        torch, lambda: pk.presence_fill(id_form(torch, pk, h), valid, regs))
    for label, (h, valid, regs) in pres.items():
        h64 = h.to(torch.int64)
        want = pk.presence_fill_plain(h64, valid, regs)
        if torch.int64 in getattr(pk, "ID_DTYPES", ()):
            fn = lambda: pk.presence_fill(h64, valid, regs)
        else:
            fn = lambda: pk.presence_fill(h64.to(torch.int32), valid, regs)
        if not torch.equal(fn(), want):
            raise AssertionError(f"presence_fill differs on {label}")
        out["presence_fill_" + label] = cuda_ms(torch, fn)
        out["presence_fill_cold_" + label] = cold_ms(torch, fn, flush)
    return out, windows


def time_paths(torch, np, reps: int) -> dict:
    """Warm host-clock milliseconds of ``reps`` runs of each W=4 path."""
    import time
    import thrill_tpu_torch as tt
    dev, W = "cuda", 4
    n = W << 22
    rng = np.random.default_rng(SEED)
    rec = np.frombuffer(rng.bytes(n * 100), dtype=np.uint8).reshape(n, 100)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def zipf(m, vocab):
        cdf = torch.cumsum(1.0 / torch.arange(1, vocab + 1,
                                              dtype=torch.float64,
                                              device=dev), 0)
        u = torch.rand(m, dtype=torch.float64, device=dev, generator=gen)
        return torch.searchsorted(cdf / cdf[-1], u).clamp_(max=vocab - 1)

    voc = torch.randint(97, 123, (1 << 20, 16), device=dev, generator=gen,
                        dtype=torch.uint8)
    data = {
        "terasort": ({"key": np.ascontiguousarray(rec[:, :10]),
                      "value": np.ascontiguousarray(rec[:, 10:])},
                     lambda s: s.Sort(key_fn=lambda r: r["key"])),
        "wordcount": ({"w": voc[zipf(n, 1 << 20)],
                       "c": torch.ones(n, dtype=torch.int64, device=dev)},
                      lambda s: s.ReduceByKey(
                          lambda t: t["w"],
                          tt.FieldReduce({"w": "first", "c": "sum"}))),
        "pagerank_step": ({"d": zipf(n, 1 << 22),
                           "v": torch.rand(n, device=dev, generator=gen)},
                          lambda s: s.ReduceToIndex(
                              lambda c: c["d"],
                              tt.FieldReduce({"d": "first", "v": "sum"}),
                              1 << 22, neutral={"d": 0, "v": 0.0})),
    }
    del rec
    out = {}
    for name, (items, job) in data.items():
        out[name] = []
        for _ in range(reps):
            src = tt.Context(num_workers=W, device=dev).Distribute(
                items).Keep()
            src.Execute()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = job(src).AllGatherArrays()
            torch.cuda.synchronize()
            out[name].append((time.perf_counter() - t0) * 1e3)
            del res, src
    return out


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if "--paths" in sys.argv:
        reps = int(sys.argv[sys.argv.index("--paths") + 1])
        print(json.dumps({"paths_ms": time_paths(torch, np, reps),
                          "card": card_line()}))
        return 0
    from thrill_tpu_torch.core import device_sort, keys
    from thrill_tpu_torch.core import pallas_kernels as pk
    from thrill_tpu_torch.core import pallas_sort as ps

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    R, n = 4, 1 << 22
    out = {}
    k = torch.as_tensor(rng.integers(-2**63, 2**63, (R, n), dtype=np.int64),
                        device=dev)
    perm = torch.argsort(torch.rand((R, n), device=dev), dim=1).to(
        torch.int32)
    h = ps.radix_upsweep(k)[:, 1]
    for gather in (False, True):
        got = ps.radix_pass(k, perm, 8, h, gather=gather)
        want = ps.radix_pass_plain(k, perm, 8, gather=gather)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            raise AssertionError(f"radix_pass (gather={gather}) differs")
    for name, gather in (("radix_pass", False), ("radix_pass_gather", True)):
        lb = ps.Lookback(R, n, 12, dev)
        out[name] = cuda_ms(torch, lambda: ps.radix_pass(
            k, perm, 8, h, gather=gather, lookback=lb))
    k1, p1, h1 = k[:1].contiguous(), perm[:1].contiguous(), h[:1]
    lb = ps.Lookback(1, n, 12, dev)
    out["radix_pass_one_row"] = cuda_ms(
        torch, lambda: ps.radix_pass(k1, p1, 8, h1, lookback=lb))
    d = torch.as_tensor(rng.integers(0, 256, (R, n), dtype=np.int32),
                        device=dev)
    if not torch.equal(ps.stable_partition_offsets(d, 256),
                       ps.stable_partition_offsets_plain(d, 256)):
        raise AssertionError("stable_partition_offsets differs")
    out["stable_partition_offsets"] = cuda_ms(
        torch, lambda: ps.stable_partition_offsets(d, 256))
    if not torch.equal(ps.radix_upsweep(k), ps.radix_upsweep_plain(k)):
        raise AssertionError("radix_upsweep differs")
    out["radix_upsweep"] = cuda_ms(torch, lambda: ps.radix_upsweep(k))
    key = torch.as_tensor(rng.integers(0, 256, (R * n, 10), dtype=np.uint8),
                          device=dev)
    ws = [w.reshape(R, n) for w in keys.encode_key_words(key)]
    ws.append(torch.arange(R * n, device=dev).reshape(R, n))
    if not torch.equal(device_sort.argsort_words(ws),
                       device_sort.plain_argsort_words(ws)):
        raise AssertionError("radix argsort differs from the plain engine")
    out["argsort"] = cuda_ms(torch, lambda: device_sort.argsort_words(ws), 3)
    del k, perm, d, key, ws
    inputs_dir = (sys.argv[sys.argv.index("--inputs") + 1]
                  if "--inputs" in sys.argv else None)
    b1b4, windows = time_b1_b4(torch, np, rng, dev, inputs_dir)
    out.update(b1b4)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    S, m = 1 << 22, 1 << 24
    cdf = torch.cumsum(1.0 / torch.arange(1, S + 1, dtype=torch.float64,
                                          device=dev), 0)
    zipf = torch.searchsorted(cdf / cdf[-1], torch.rand(
        m, dtype=torch.float64, device=dev, generator=gen)).clamp_(
        max=S - 1).to(torch.int32)[None]
    uniform = torch.randint(0, S, (1, m), device=dev, generator=gen,
                            dtype=torch.int32)
    v = torch.rand((1, m), device=dev, generator=gen)
    for name, ids in (("segment_sum_zipf", zipf),
                      ("segment_sum_uniform", uniform)):
        got = pk.segment_sum(ids, v, S)
        want = pk.segment_sum_plain(ids, v, S)
        if not bool(((got - want).abs() <= 1e-4 * want + 1e-6).all()):
            raise AssertionError(f"{name}: outside 1e-4 of the plain sum")
        out[name] = cuda_ms(torch, lambda: pk.segment_sum(ids, v, S))
    print(json.dumps({"ms": out, "windows": windows, "card": card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
