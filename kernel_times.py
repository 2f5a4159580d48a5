#!/usr/bin/env python3
"""Times the port's kernels on one GPU.

    python3 kernel_times.py [--inputs DIR]
    python3 kernel_times.py --paths REPS
    python3 kernel_times.py --loops REPS
    python3 kernel_times.py --add-chain
    python3 kernel_times.py --sort-engines
    python3 kernel_times.py --xchg-crossover
    python3 kernel_times.py --plan-paths REPS

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
2^17 registers, as the W=4 WordCount hands it over; the latency of one
dependent f64 and f32 add (``add_ns_*``, ``add_cycles_*``: one thread's
chain of adds with its operands in registers, :func:`add_chain_latency`),
the floor of the ordered fold on a run of many rows. With ``--inputs
DIR`` the histogram and presence_fill are timed also on the inputs that
``chip_smoke.py --save-inputs DIR`` captured on the main path. Each
kernel is first held against its plain version. Prints one JSON line of
milliseconds (CUDA events, mean of 10 calls after 2 warm-ups; 3 for the
argsort) and the card. chip_smoke.py is the full check; this script is
for comparing versions of the kernels' sources side by side: the
histogram and presence_fill are timed as their call sites run them, so
a version whose wrappers take int32 ids only is timed with the int32
copy its call sites made.

With ``--loops REPS`` it times instead the two loop examples (PageRank
and k-means at W=4 and W=1, the smoke's sizes): every run's seconds and
every loop body's host seconds, as the loop layer's measurements before
and after need them; it runs unchanged in a copy of an earlier tree.

With ``--paths REPS`` it times instead the three W=4 paths of
chip_smoke.py end to end, REPS warm runs each (host clock after
synchronize, data resident, a fresh Context per run): TeraSort of 2^24
100-byte records, WordCount of 2^24 Zipf words over 2^20 16-byte words,
the PageRank step of 2^24 Zipf edges into 2^22 pages. It prints every
run's milliseconds, for A/B runs of whole trees in one call.

With ``--sort-engines`` it sweeps the two sort engines of
``core/device_sort.py`` instead: the radix engine (the histogram and
stable-partition kernels) and the plain engine (a stable torch.argsort a
word), on [4, n/4] random full-width int64 words, n = 2^10 to 2^24 rows
and 1 to 3 words, host milliseconds a whole call after synchronize (the
radix engine reads its live digits on the host); then the least-squares
fit of ``sort_engine_policy``'s CUDA constants: radix = launch * (words
+ passes) + rows * passes * per_row_pass, plain = launch * words + rows
* words * per_row_word (microseconds). The card sorts on the radix engine
at every size; the constants price the decision records.

With ``--xchg-crossover`` it sweeps the exchange's two phase-B plans at
W = 4 (``data/exchange.py``): the dense program and the 1-factor rounds,
on one int64 leaf, over a balanced and a hot-pair send matrix at padded
volumes from 2^10 to 2^22 rows a pair; host milliseconds after
synchronize. It prints the copy rate of the dense plan, the per-round
overhead of the 1-factor plan and their product, the smallest
``_bytes_eq`` under which the reference's cost model would pick every
measured winner, and the least at which the rounds won a case (null when
they won none: then the card's exchange is dense without a cost model,
``data/exchange.py`` ``_one_card``).

With ``--plan-paths REPS`` it runs instead the plan layer's W=4 paths
(PageRank with loop replay off, Q3-lite, TeraSort; chip_smoke.py phase
P's sizes) with the capacity cache on and off
(``THRILL_TPU_XCHG_CAP_CACHE=0``), REPS warm runs each after one first
run: every run's host milliseconds, counted host fetches, and the device
milliseconds of the exchanges (CUDA events around every exchange call).
It reads the plan counters where the tree has them, so it runs
unchanged in a copy of an earlier tree.
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


def time_loops(torch, np, reps: int) -> list:
    """The loop examples at chip_smoke.py's sizes (PageRank over
    zipf_graph(2^22, 2^24), k-means over 2^24 x 8 points, 10 iterations,
    W = 4 and 1): one build-and-warm run, then ``reps`` runs each, every
    run's host seconds after synchronize and, for every call of the loop
    body, its host seconds without a synchronize (the body and the pull
    of its result: the host's planning and issuing of an iteration, its
    syncs included) and with one. A tree whose Iterate replays calls the
    body in its capture iterations only."""
    import time
    import thrill_tpu_torch as tt
    from thrill_tpu_torch.api import loop as loop_mod
    from thrill_tpu_torch.examples import k_means as tkm
    from thrill_tpu_torch.examples import page_rank as tpr
    pages, edges_n = 1 << 22, 1 << 24
    edges = tpr.zipf_graph(pages, edges_n, seed=SEED + 30)
    pts = np.random.default_rng(SEED + 50).normal(size=(1 << 24, 8))

    def timed(mod, rec):
        real = mod.Iterate

        def iterate(ctx, body, carry, n, **kw):
            def b(x):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = body(x)
                if hasattr(out, "_link"):
                    out = loop_mod._carry_dia(ctx, out._link().pull(
                        consume=True))
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                rec.append((t1 - t0, time.perf_counter() - t0))
                return out
            return real(ctx, b, carry, n, **kw)
        return iterate

    runs = {"pagerank": (tpr, lambda ctx, it: tpr.page_rank(
                ctx, edges, pages, it)),
            "k-means": (tkm, lambda ctx, it: tkm.k_means(ctx, pts, 10, it))}
    out = []
    for name, (mod, run) in runs.items():
        for W in (4, 1):
            for rep in range(reps + 1):
                rec = []
                real = mod.Iterate
                mod.Iterate = timed(mod, rec)
                try:
                    ctx = tt.Context(num_workers=W, device="cuda")
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run(ctx, 10 if rep else 2)
                    torch.cuda.synchronize()
                    secs = time.perf_counter() - t0
                finally:
                    mod.Iterate = real
                if rep:
                    out.append({"path": name, "W": W, "warm_s": secs,
                                "body_host_s": [r[0] for r in rec],
                                "body_synced_s": [r[1] for r in rec]})
    return out


ADD_CHAIN_CU = r"""
#include <cuda_runtime.h>

// One thread, one chain of n dependent adds: the two operands sit in
// registers (loaded once, before the chain), every add reads the sum the
// one before it wrote. clock64() around the chain gives its cycles.
template <typename T>
__global__ void add_chain(const T* in, T* out, long long n,
                          long long* cycles) {
  T a = in[0], b = in[1], acc = in[2];
  long long t0 = clock64();
  for (long long i = 0; i < n; i += 16) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc += a;
      acc += b;
    }
  }
  long long t1 = clock64();
  out[0] = acc;
  cycles[0] = t1 - t0;
}

extern "C" int add_chain_launch(int f64, const void* in, void* out,
                                long long n, long long* cycles,
                                cudaStream_t stream) {
  if (f64)
    add_chain<double><<<1, 1, 0, stream>>>(
        static_cast<const double*>(in), static_cast<double*>(out), n,
        cycles);
  else
    add_chain<float><<<1, 1, 0, stream>>>(
        static_cast<const float*>(in), static_cast<float*>(out), n, cycles);
  return static_cast<int>(cudaGetLastError());
}
"""


def add_chain_latency(torch) -> dict:
    """The latency of one dependent add on the card, the floor of the
    ordered fold (a run's adds are one chain): ADD_CHAIN_CU, built here
    with nvcc for sm_90a, runs one thread through n adds with its
    operands in registers. Two chain lengths, each timed with CUDA
    events (mean of 10 launches after 2 warm-ups): the difference over
    the difference of adds is ns an add, free of the launch. Its sum is
    held to the exact one, and clock64()
    gives the cycles an add. Returns ``add_ns_<dtype>`` and
    ``add_cycles_<dtype>`` for float64 and float32."""
    import ctypes
    import hashlib
    from thrill_tpu_torch.common import native_build as nb
    digest = hashlib.sha256(ADD_CHAIN_CU.encode()).hexdigest()[:16]
    lib_path = os.path.join(nb.BUILD_DIR, f"libadd_chain-{digest}.so")
    if not os.path.exists(lib_path):
        os.makedirs(nb.BUILD_DIR, exist_ok=True)
        src = lib_path[:-3] + ".cu"
        with open(src, "w") as f:
            f.write(ADD_CHAIN_CU)
        subprocess.run([nb._nvcc(), *nb.ARCH_FLAGS, "-O3", "-shared",
                        "-Xcompiler", "-fPIC", "-o", lib_path, src],
                       check=True, timeout=600)
    lib = ctypes.CDLL(lib_path)
    lib.add_chain_launch.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_void_p, ctypes.c_void_p]
    dev = torch.device("cuda")
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    out = {}
    short, long_ = 1 << 20, 1 << 22
    for dt in (torch.float64, torch.float32):
        ops = torch.tensor([0.5, 0.25, 1.0], dtype=dt, device=dev)
        res = torch.zeros(1, dtype=dt, device=dev)

        def launch(n):
            rc = lib.add_chain_launch(
                int(dt == torch.float64), ops.data_ptr(), res.data_ptr(),
                n, cycles.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"add_chain launch failed: {rc}")

        launch(short)
        # every partial sum is a multiple of 0.25 below 2^21: exact in
        # both types, so the chain's sum is 1 + 0.375 n
        if float(res.item()) != 1 + 0.375 * short:
            raise AssertionError(f"add chain ({dt}) summed {res.item()}, "
                                 f"not {1 + 0.375 * short}")
        ms = {n: cuda_ms(torch, lambda n=n: launch(n)) for n in (short,
                                                                 long_)}
        launch(long_)
        torch.cuda.synchronize()
        name = str(dt)[6:]
        out[f"add_ns_{name}"] = (ms[long_] - ms[short]) * 1e6 / (
            long_ - short)
        out[f"add_cycles_{name}"] = int(cycles.item()) / long_
    return out


def wall_ms(torch, fn, iters: int = 5) -> float:
    """Mean host milliseconds of a whole call of ``fn``, synchronized."""
    import time
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def sort_engines(torch, np) -> dict:
    """Both sort engines over a sweep of rows and words, and the fit of
    the policy's CUDA constants."""
    from thrill_tpu_torch.core import device_sort
    from thrill_tpu_torch.core import pallas_sort as ps
    rng = np.random.default_rng(SEED + 7)
    R = 4
    rows = []
    for lg in range(10, 25, 2):
        n = 1 << lg
        for nw in (1, 2, 3):
            ws = [torch.as_tensor(rng.integers(-2**63, 2**63, (R, n // R),
                                               dtype=np.int64), device="cuda")
                  for _ in range(nw)]
            if not torch.equal(ps.radix_argsort_device(ws),
                               device_sort.plain_argsort_words(ws)):
                raise AssertionError(f"engines differ at n={n} w={nw}")
            it = 5 if lg < 22 else 2
            rows.append({"rows": n, "words": nw, "passes": 8 * nw,
                         "radix_ms": wall_ms(
                             torch, lambda: ps.radix_argsort_device(ws), it),
                         "plain_ms": wall_ms(
                             torch, lambda: device_sort.plain_argsort_words(
                                 ws), it)})
            del ws
    # least squares, microseconds
    a = np.array([[r["words"] + r["passes"], r["rows"] * r["passes"]]
                  for r in rows], dtype=np.float64)
    b = np.array([[r["words"], r["rows"] * r["words"]] for r in rows],
                 dtype=np.float64)
    fr = np.linalg.lstsq(a, [r["radix_ms"] * 1e3 for r in rows],
                         rcond=None)[0]
    fp = np.linalg.lstsq(b, [r["plain_ms"] * 1e3 for r in rows],
                         rcond=None)[0]
    fit = {"radix_launch_us": float(fr[0]), "radix_row_pass_us": float(fr[1]),
           "plain_launch_us": float(fp[0]), "plain_row_word_us": float(fp[1])}
    return {"sweep": rows, "fit": fit}


def xchg_crossover(torch, np) -> dict:
    """The dense and the 1-factor phase-B programs at W = 4 over sized
    balanced and hot-pair send matrices; the fitted bytes_eq."""
    import thrill_tpu_torch as tt
    from thrill_tpu_torch.data import exchange as ex
    W = 4
    ctx = tt.Context(num_workers=W, device="cuda")
    mex = ctx.mesh_exec
    rng = np.random.default_rng(SEED + 8)
    rows = []
    for lg in range(10, 23, 2):
        M = 1 << lg
        for kind in ("balanced", "hot"):
            if kind == "balanced":
                S = np.full((W, W), M, dtype=np.int64)
            else:
                S = np.full((W, W), max(M // 100, 1), dtype=np.int64)
                S[3, 0] = M
            cap = int(S.sum(axis=1).max())
            cap = 1 << (cap - 1).bit_length()
            dest = np.full((W, cap), W, dtype=np.int64)
            for w in range(W):
                dest[w, :S[w].sum()] = np.repeat(np.arange(W), S[w])
            dest_t = torch.as_tensor(dest, device="cuda")
            x = torch.as_tensor(rng.integers(-2**62, 2**62, (W, cap),
                                             dtype=np.int64), device="cuda")
            R = S.sum(axis=0)
            out_cap = 1 << (int(R.max()) - 1).bit_length()
            M_pad = 1 << (int(S.max()) - 1).bit_length()
            smat = torch.as_tensor(S.astype(np.int32), device="cuda")
            rounds = tuple(tuple(int(v) for v in to)
                           for to in ex.one_factor_rounds(mex))
            M_rounds = tuple(1 << (max(int(S[np.arange(W), np.asarray(to)]
                                           .max()), 1) - 1).bit_length()
                             for to in rounds)

            def dense():
                return ex._chunk_prog(dest_t, smat, [x], None, M_pad,
                                      out_cap, 0, M_pad, M_pad, None, True,
                                      True, True)

            def onefactor():
                return ex._onefactor_prog(dest_t, smat, [x], rounds,
                                          M_rounds, out_cap, None)

            d_out = dense()[2][0]
            o_out = onefactor()[0]
            for w in range(W):
                if not torch.equal(d_out[w, :R[w]], o_out[w, :R[w]]):
                    raise AssertionError(f"plans differ at M={M} {kind}")
            rows.append({"pair_rows": M, "kind": kind,
                         "dense_bytes": W * (W - 1) * M_pad * 8,
                         "onefactor_bytes": W * sum(M_rounds) * 8,
                         "dense_ms": wall_ms(torch, dense),
                         "onefactor_ms": wall_ms(torch, onefactor)})
            del x, dest_t, d_out, o_out
    ctx.close()
    bal = [r for r in rows if r["kind"] == "balanced"]
    # the copy rate of the dense plan from its two largest runs; a round
    # beyond the dense plan's one program costs (onefactor - dense) /
    # (W - 1) where there is almost no data
    rate = float(np.mean([r["dense_bytes"] / (r["dense_ms"] * 1e-3)
                          for r in bal[-2:]]))
    over_s = max(bal[0]["onefactor_ms"] - bal[0]["dense_ms"], 0.0) * 1e-3 \
        / (W - 1)
    # the smallest constant under which the model (1-factor iff the
    # padding it saves exceeds (W - 1) * bytes_eq) picks every measured
    # winner: above the savings of the cases the dense plan won
    dense_won = [(r["dense_bytes"] - r["onefactor_bytes"]) / (W - 1)
                 for r in rows if r["dense_ms"] <= r["onefactor_ms"]]
    of_won = [(r["dense_bytes"] - r["onefactor_bytes"]) / (W - 1)
              for r in rows if r["dense_ms"] > r["onefactor_ms"]]
    return {"sweep": rows, "copy_bytes_per_s": rate,
            "round_overhead_us": over_s * 1e6,
            "bytes_eq_product": int(over_s * rate),
            "bytes_eq_crossover": int(max(dense_won, default=0)),
            "onefactor_won_min_bytes_eq": (int(min(of_won))
                                           if of_won else None)}


def _q3_date(t):
    return t["date"] < 1250


def _q3_okey(t):
    return t["key"]


def _q3_lkey(t):
    return t["orderkey"]


def _q3_join(ot, lt):
    return {"prio": ot["prio"],
            "rev": lt["price"] * (100 - lt["discount_pct"])}


def _q3_prio(t):
    return t["prio"]


def _q3_add(a, b):
    return {"prio": a["prio"], "rev": a["rev"] + b["rev"]}


def q3_stable(tt, np, ctx, orders, lineitem, prios: int):
    """``examples/tpch.py``'s Q3-lite with module-level functions, so a
    repeated run finds its exchange sites' cached plans."""
    o = ctx.Distribute(orders).Filter(_q3_date)
    j = tt.InnerJoin(o, ctx.Distribute(lineitem), _q3_okey, _q3_lkey,
                     _q3_join)
    return np.asarray([int(t["rev"]) for t in j.ReduceToIndex(
        _q3_prio, _q3_add, prios, neutral={"prio": 0, "rev": 0}
    ).AllGather()])


def _terasort_key(r):
    return r["key"]


def plan_paths(torch, np, reps: int) -> dict:
    """The plan layer's W=4 paths with the capacity cache on and off."""
    import time
    import thrill_tpu_torch as tt
    from thrill_tpu_torch.api.ops import sort as sort_mod
    from thrill_tpu_torch.data import exchange as ex
    from thrill_tpu_torch.examples import page_rank as tpr
    from thrill_tpu_torch.examples import tpch as ttp
    spans = []

    def timed(fn):
        def wrapper(*a, **k):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **k)
            e.record()
            spans.append((s, e))
            return out
        return wrapper

    ex.exchange = timed(ex.exchange)
    ex.exchange_presorted = timed(ex.exchange_presorted)
    sort_mod._fused_exchange_merge = timed(sort_mod._fused_exchange_merge)
    W = 4
    edges = tpr.zipf_graph(1 << 20, 1 << 22, seed=SEED + 30)
    tables = ttp.generate_tables(1 << 20, W, seed=SEED + 40)
    rng = np.random.default_rng(SEED)
    n = 1 << 22
    rec = np.frombuffer(rng.bytes(n * 100), dtype=np.uint8).reshape(n, 100)
    recs = {"key": np.ascontiguousarray(rec[:, :10]),
            "value": np.ascontiguousarray(rec[:, 10:])}
    del rec
    jobs = {
        "pagerank": lambda ctx: tpr.page_rank(ctx, edges, 1 << 20,
                                              iterations=5),
        "q3": lambda ctx: q3_stable(tt, np, ctx, *tables,
                                    ttp.NUM_PRIORITIES),
        "terasort": lambda ctx: ctx.Distribute(recs).Sort(
            key_fn=_terasort_key).AllGatherArrays(),
    }
    keys = ("cap_cache_hits", "cap_cache_misses", "exchanges_overlapped",
            "bytes_wire_device", "bytes_wire_device_raw")
    out = {}
    os.environ["THRILL_TPU_LOOP_REPLAY"] = "0"
    for cache in ("1", "0"):
        os.environ["THRILL_TPU_XCHG_CAP_CACHE"] = cache
        for name, job in jobs.items():
            ctx = tt.Context(num_workers=W, device="cuda")
            runs = []
            for _ in range(reps + 1):
                spans.clear()
                f0 = ctx.mesh_exec.stats_fetches
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                job(ctx)
                torch.cuda.synchronize()
                runs.append({
                    "ms": (time.perf_counter() - t0) * 1e3,
                    "fetches": ctx.mesh_exec.stats_fetches - f0,
                    "xchg_ms": sum(s.elapsed_time(e) for s, e in spans),
                    "exchanges": len(spans)})
            st = ctx.overall_stats()
            out[f"{name} cache={cache}"] = {
                "first": runs[0], "warm": runs[1:],
                **{k: st.get(k) for k in keys}}
            ctx.close()
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
    if "--sort-engines" in sys.argv:
        print(json.dumps({"sort_engines": sort_engines(torch, np),
                          "card": card_line()}))
        return 0
    if "--xchg-crossover" in sys.argv:
        print(json.dumps({"xchg_crossover": xchg_crossover(torch, np),
                          "card": card_line()}))
        return 0
    if "--plan-paths" in sys.argv:
        reps = int(sys.argv[sys.argv.index("--plan-paths") + 1])
        print(json.dumps({"plan_paths": plan_paths(torch, np, reps),
                          "card": card_line()}))
        return 0
    if "--add-chain" in sys.argv:
        print(json.dumps({"ms": add_chain_latency(torch),
                          "card": card_line()}))
        return 0
    if "--loops" in sys.argv:
        reps = int(sys.argv[sys.argv.index("--loops") + 1])
        print(json.dumps({"loops": time_loops(torch, np, reps),
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
    if not torch.equal(ps.radix_argsort_device(ws),
                       device_sort.plain_argsort_words(ws)):
        raise AssertionError("radix argsort differs from the plain engine")
    out["argsort"] = cuda_ms(torch, lambda: ps.radix_argsort_device(ws), 3)
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
    out.update(add_chain_latency(torch))
    print(json.dumps({"ms": out, "windows": windows, "card": card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
