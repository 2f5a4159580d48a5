#!/usr/bin/env python3
"""Times the radix engine's kernels and the segment sum on one GPU.

    python3 kernel_times.py

At the main path's shapes: a radix pass over [4, 2^22] int64 keys carrying
int32 permutation entries (and the same pass reading the word through the
permutation, as a word's first pass does, and over one row), the
stable-partition offsets of [4, 2^22] digits, the upsweep of [4, 2^22]
words, the whole argsort of the W=4 TeraSort's phase 1 (two key words and
the global index), and segment_sum of 2^24 Zipf ids (weights 1/rank, as
the PageRank step's) and of 2^24 uniform ids over 2^22 segments. Each
kernel is first held against its plain version. Prints one JSON line of
milliseconds (CUDA events, mean of 10 calls after 2 warm-ups; 3 for the
argsort) and the card. chip_smoke.py is the full check; this script is
for comparing versions of the kernels' sources side by side.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SEED = 20261016


def cuda_ms(torch, fn, iters: int = 10) -> float:
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


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
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
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"ms": out, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
