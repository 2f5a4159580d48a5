"""The op battery: every DIA op of the port, the device InnerJoin and
Iterate on one context, each result as a JSON-able value.

The battery holds every entry of the reference's distributed sweep
(device and host Sort, device and host ReduceByKey, GroupByKey on both
storages, Zip, Window, Concat plus Rebalance, three fuzz chains), then
ZipWithIndex, ZipWindow, PrefixSum and ExPrefixSum, DisjointWindow and
FlatWindow, Merge, Union, GroupToIndex, ReduceToIndex (f32 and f64),
Sample and BernoulliSample, HyperLogLog, ToHost and ToDevice, a
WriteBinary/ReadBinary and WriteLines/ReadLines round trip, the device
InnerJoin with location detection forced on and off, Q3-lite, and
PageRank and k-means through Iterate with ``THRILL_TPU_LOOP_REPLAY`` on
and off. Every input is made from fixed seeds with numpy and every op
stays at or below 2^11 items, so the same battery on a mesh of several
processes (``RunDistributed``) and on one process can be compared entry
for entry. The framework is a handle (:class:`Port` for this package),
so the same code drives another package of the same API.

    python -m thrill_tpu_torch.examples.op_battery --device cpu
"""

from __future__ import annotations

import hashlib
import os
from contextlib import contextmanager

import numpy as np

PR_PAGES, PR_EDGES, PR_ITERS = 256, 2048, 5
KM_POINTS, KM_K, KM_ITERS = 1500, 5, 4
# the entries that count this process's own work, and those of the port
# alone (its counters and loop reports)
PER_RANK = ("items_moved_local", "moved_ld", "moved_plain")
PORT_ONLY = PER_RANK + ("items_moved", "loops")


@contextmanager
def _env(key, value):
    old = os.environ.get(key)
    os.environ[key] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = old


def _digest(seq) -> str:
    h = hashlib.sha256()
    for x in seq:
        h.update(repr(x).encode())
    return h.hexdigest()[:16]


def _ints(items):
    return [int(v) for v in items]




class Port:
    """This package as the battery's framework: its API, its array
    module, its segment sum and its example pipelines."""
    name = "port"

    def __init__(self):
        import torch

        import thrill_tpu_torch as tt
        from thrill_tpu_torch.core import segmented
        self.api = tt
        self.xp = torch
        self.seg_sum = segmented.segment_sum

    def stack1(self, xs):
        return self.xp.stack(xs, dim=1)

    def to_f64(self, x):
        return x.to(self.xp.float64)

    def ones_like(self, x):
        return self.xp.ones_like(x)

    def examples(self):
        """The PageRank, k-means and Q3-lite example modules."""
        from thrill_tpu_torch.examples import k_means, page_rank, tpch
        return page_rank, k_means, tpch


def battery(ctx, L, tmp: str) -> dict:
    """The battery on one context; ``L`` the framework (:class:`Port`, or
    a handle of the same shape on another package), ``tmp`` a directory
    of this run's own. Returns JSON-able results by entry."""
    api = L.api
    out = {}
    rng = np.random.default_rng(42)          # the same stream everywhere
    mex = ctx.mesh_exec

    # -- the reference's ops_sweep_child.py ----------------------------
    keys = rng.integers(0, 256, size=(600, 10)).astype(np.uint8)
    srt = ctx.Distribute({"k": keys}).Sort(key_fn=lambda t: t["k"])
    out["dev_sort"] = _digest(bytes(np.asarray(r["k"]))
                              for r in srt.AllGather())
    words = [f"w{v:06d}" for v in rng.integers(0, 5000, size=2000)]
    out["host_sort"] = _digest(ctx.Distribute(words, storage="host")
                               .Sort().AllGather())
    kv = {"k": rng.integers(0, 37, size=2000).astype(np.int64),
          "v": rng.integers(0, 100, size=2000).astype(np.int64)}
    red = ctx.Distribute(kv).ReduceByKey(
        lambda t: t["k"], api.FieldReduce({"k": "first", "v": "sum"}))
    out["dev_reduce"] = sorted((int(r["k"]), int(r["v"]))
                               for r in red.AllGather())
    hred = ctx.Distribute([(f"k{v % 23}", 1) for v in range(1500)],
                          storage="host").ReduceByKey(
        lambda t: t[0], lambda a, b: (a[0], a[1] + b[1]),
        dup_detection=True)
    out["host_reduce"] = sorted(map(list, hred.AllGather()))
    gb_dev = ctx.Distribute(
        {"k": rng.integers(0, 11, size=800).astype(np.int64),
         "v": np.arange(800, dtype=np.int64)}).GroupByKey(
        lambda t: t["k"], lambda k, items: (int(k), len(items)))
    out["dev_group"] = sorted(map(list, gb_dev.AllGather()))
    gb_host = ctx.Distribute([(i % 7, i) for i in range(900)],
                             storage="host").GroupByKey(
        lambda t: t[0], lambda k, items: (k, sum(i[1] for i in items)))
    out["host_group"] = sorted(map(list, gb_host.AllGather()))
    z = api.Zip(ctx.Generate(700), ctx.Generate(700, fn=lambda i: i * 3),
                zip_fn=lambda x, y: x + y)
    out["zip"] = _ints(z.AllGather())
    win = ctx.Generate(640).Window(3, lambda i, w: sum(w),
                                   device_fn=lambda wins: wins.sum(1))
    out["window"] = _ints(win.AllGather())
    cc = api.Concat(
        ctx.Distribute([f"a{i}" for i in range(100)], storage="host"),
        ctx.Distribute([f"b{i}" for i in range(50)], storage="host")
    ).Rebalance()
    out["concat_rebalance"] = cc.AllGather()
    for seed in (1, 2, 3):
        frng = np.random.default_rng(seed)
        vals = frng.integers(0, 1000, size=1200).astype(np.int64)
        mod = int(frng.integers(2, 30))
        thr = int(frng.integers(0, 800))
        d = ctx.Distribute(vals).Map(lambda x, m=mod: (x % m, x)) \
            .Filter(lambda t, th=thr: t[1] < th) \
            .ReducePair(lambda a, b: a + b)
        out[f"fuzz{seed}"] = sorted((int(k), int(v))
                                    for k, v in d.AllGather())

    # -- the rest of the op surface -------------------------------------
    vals = rng.integers(-50, 50, size=1000).astype(np.int64)
    out["zip_with_index"] = [
        list(map(int, t)) for t in ctx.Distribute(vals)
        .ZipWithIndex(lambda x, i: (x, i)).AllGather()]
    out["zip_with_index_host"] = [
        list(t) for t in ctx.Distribute(vals.tolist(), storage="host")
        .ZipWithIndex().AllGather()]
    out["zip_pad"] = [list(map(int, t)) for t in api.Zip(
        ctx.Distribute(vals[:700]), ctx.Distribute(vals[:300] * 2),
        zip_fn=lambda a, b: (a, b), mode="pad").AllGather()]
    out["zip_window"] = _ints(api.ZipWindow(
        (2, 3), ctx.Distribute(vals[:600]), ctx.Distribute(vals),
        device_fn=lambda a, b: a.sum(1) + b.sum(1)).AllGather())
    out["zip_window_host"] = [
        [list(map(int, a)), list(map(int, b))] for a, b in api.ZipWindow(
            (2, 3), ctx.Distribute(vals[:90].tolist(), storage="host"),
            ctx.Distribute(vals[:150].tolist(), storage="host"),
            zip_fn=lambda a, b: (a, b)).AllGather()]
    fl = rng.random(1000).astype(np.float32)
    out["prefix_sum"] = _ints(ctx.Distribute(vals).PrefixSum().AllGather())
    out["ex_prefix_sum"] = _ints(ctx.Distribute(vals)
                                 .ExPrefixSum(initial=7).AllGather())
    out["prefix_sum_f32"] = [float(v) for v in ctx.Distribute(fl)
                             .PrefixSum().AllGather()]
    out["prefix_sum_host"] = ctx.Distribute(
        [f"s{i % 5}" for i in range(300)], storage="host").PrefixSum(
        lambda a, b: a[-6:] + b, initial="").AllGather()
    out["disjoint_window"] = _ints(ctx.Distribute(vals).DisjointWindow(
        4, lambda i, w: sum(w), device_fn=lambda w: w.sum(1)).AllGather())
    out["flat_window"] = _ints(ctx.Distribute(vals).FlatWindow(
        2, device_fn=lambda w: (L.stack1([w[:, 0], w[:, 0] + w[:, 1]]),
                                L.stack1([w[:, 0] > 0, w[:, 1] > 0])),
        factor=2).AllGather())
    out["window_host"] = [list(map(int, w)) for w in ctx.Distribute(
        vals[:200].tolist(), storage="host").Window(
        3, lambda i, w: (i, sum(w))).AllGather()]
    s1 = np.sort(rng.integers(0, 400, 700)).astype(np.int64)
    s2 = np.sort(rng.integers(0, 400, 500)).astype(np.int64)
    s3 = np.sort(rng.integers(0, 400, 300)).astype(np.int64)
    out["merge"] = _ints(api.Merge(ctx.Distribute(s1), ctx.Distribute(s2),
                                   ctx.Distribute(s3)).AllGather())
    out["merge_host"] = api.Merge(
        ctx.Distribute(s1[:200].tolist(), storage="host"),
        ctx.Distribute(s2[:100].tolist(), storage="host")).AllGather()
    out["union"] = sorted(_ints(api.Union(
        ctx.Distribute(vals[:300]), ctx.Distribute(vals[:500] * 3))
        .AllGather()))
    g = {"i": rng.integers(0, 40, 1200).astype(np.int64),
         "v": rng.random(1200).astype(np.float32)}

    def g2i_fn(tree, ids, nseg):
        return {"n": L.seg_sum(L.ones_like(tree["i"]), ids,
                               num_segments=nseg),
                "s": L.seg_sum(tree["v"], ids, num_segments=nseg)}

    g2i = ctx.Distribute(g).GroupToIndex(
        lambda t: t["i"], size=45, neutral={"n": -1, "s": -1.0},
        device_fn=g2i_fn).AllGather()
    out["group_to_index"] = [[int(t["n"]), float(t["s"])] for t in g2i]
    out["group_to_index_host"] = ctx.Distribute(
        [(i % 13, i) for i in range(500)], storage="host").GroupToIndex(
        lambda t: t[0], lambda i, items: (i, sum(t[1] for t in items)),
        size=15, neutral=(-1, -1)).AllGather()
    out["group_by_key_dev_fn"] = [
        [int(t["n"]), float(t["s"])] for t in ctx.Distribute(g).GroupByKey(
            lambda t: t["i"], device_fn=lambda tree, ids, nseg: {
                "n": L.seg_sum(L.ones_like(tree["i"]), ids,
                               num_segments=nseg),
                "s": L.seg_sum(tree["v"], ids, num_segments=nseg)})
        .AllGather()]
    out["group_by_key_dev_fn"].sort()
    r32 = ctx.Distribute(g).ReduceToIndex(
        lambda t: t["i"], api.FieldReduce({"i": "first", "v": "sum"}), 45,
        neutral={"i": 0, "v": 0.0}).AllGather()
    out["reduce_to_index_f32"] = [[int(t["i"]), float(t["v"])] for t in r32]
    g64 = {"i": g["i"], "v": g["v"].astype(np.float64)}
    r64 = ctx.Distribute(g64).ReduceToIndex(
        lambda t: t["i"], api.FieldReduce({"i": "first", "v": "sum"}), 45,
        neutral={"i": 0, "v": 0.0}).AllGather()
    out["reduce_to_index_f64"] = [[int(t["i"]), float(t["v"])] for t in r64]
    out["reduce_to_index_host"] = ctx.Distribute(
        [(i % 9, i) for i in range(400)], storage="host").ReduceToIndex(
        lambda t: t[0], lambda a, b: (a[0], a[1] + b[1]), 12,
        neutral=(0, 0)).AllGather()
    out["sample"] = _ints(ctx.Distribute(vals).Sample(100, seed=3)
                          .AllGather())
    out["bernoulli"] = _ints(ctx.Distribute(vals).BernoulliSample(
        0.3, seed=5).AllGather())
    out["sample_host"] = ctx.Distribute(vals.tolist(), storage="host") \
        .Sample(50, seed=4).AllGather()
    out["bernoulli_host"] = ctx.Distribute(vals.tolist(), storage="host") \
        .BernoulliSample(0.2, seed=6).AllGather()
    hv = rng.integers(0, 700, 2000).astype(np.int64)
    out["hll"] = float(ctx.Distribute(hv).HyperLogLog(10))
    out["hll_host"] = float(ctx.Distribute(
        [f"h{v}" for v in hv.tolist()], storage="host").HyperLogLog(10))
    out["to_host_to_device"] = _ints(
        ctx.Distribute(vals).ToHost().Map(lambda x: int(x) * 2)
        .ToDevice().Map(lambda x: x + 1).AllGather())
    recs = rng.integers(0, 256, (800, 6)).astype(np.uint8)
    ctx.Distribute(recs).WriteBinary(os.path.join(tmp, "rec-$$$$$.bin"))
    back = ctx.ReadBinary(os.path.join(tmp, "rec-*.bin"), np.uint8, (6,))
    out["binary_round_trip"] = _digest(bytes(np.asarray(r))
                                       for r in back.AllGather())
    lines = [f"line {i} {v}" for i, v in enumerate(vals[:400].tolist())]
    ctx.Distribute(lines, storage="host").WriteLines(
        os.path.join(tmp, "lines-$$$$$.txt"))
    out["lines_round_trip"] = ctx.ReadLines(
        os.path.join(tmp, "lines-*.txt")).AllGather()

    # -- the device InnerJoin, location detection forced on and off -----
    lj = {"k": rng.integers(0, 300, 900).astype(np.int64),
          "a": np.arange(900, dtype=np.int64)}
    rj = {"k": rng.integers(150, 600, 700).astype(np.int64),
          "b": np.arange(700, dtype=np.int64)}
    for ld in (True, False):
        base = int(mex.stats_items_moved)
        j = api.InnerJoin(ctx.Distribute(lj), ctx.Distribute(rj),
                          lambda t: t["k"], lambda t: t["k"],
                          lambda a, b: {"k": a["k"], "a": a["a"],
                                        "b": b["b"]},
                          location_detection=ld)
        pairs = sorted((int(t["k"]), int(t["a"]), int(t["b"]))
                       for t in j.AllGather())
        out[f"join_ld_{ld}"] = pairs
        if L.name == "port":
            out["moved_ld" if ld else "moved_plain"] = \
                int(mex.stats_items_moved) - base

    # -- the examples: Q3-lite, PageRank and k-means through Iterate ----
    page_rank, k_means, tpch = L.examples()
    orders, lineitem = tpch.generate_tables(400, seed=3)
    with _env("THRILL_TPU_LOCATION_DETECT", "1"):
        out["q3_ld"] = _ints(tpch.q3_lite(ctx, orders, lineitem))
    edges = page_rank.zipf_graph(PR_PAGES, PR_EDGES, seed=7)
    krng = np.random.default_rng(11)
    pts = np.concatenate([krng.normal(loc=c, size=(KM_POINTS // 3, 3))
                          for c in (-4.0, 0.0, 5.0)])
    pts = pts[krng.permutation(len(pts))]
    for mode in ("1", "0"):
        with _env("THRILL_TPU_LOOP_REPLAY", mode):
            n0 = len(getattr(mex, "loop_reports", []))
            ranks = page_rank.page_rank(ctx, edges, PR_PAGES, PR_ITERS)
            out[f"pagerank_replay{mode}"] = [float(v) for v in ranks]
            cent = k_means.k_means(ctx, pts, KM_K, iterations=KM_ITERS,
                                   seed=2)
            out[f"kmeans_replay{mode}"] = [float(v) for v in
                                           np.asarray(cent).reshape(-1)]
            if L.name == "port":
                out.setdefault("loops", []).extend(
                    {k: r[k] for k in ("name", "captures", "replays",
                                       "fori_iters", "fallbacks")}
                    for r in mex.loop_reports[n0:])
    if L.name == "port":
        out["items_moved_local"] = int(mex.stats_items_moved)
        out["items_moved"] = ctx.overall_stats()["items_moved"]
    return out


#: the element types of :func:`dtype_battery`'s columns
DTYPE_COLUMNS = ("int16", "uint16", "uint32", "uint64", "bool")


def _host(a) -> np.ndarray:
    """An egress array on the host as numpy (a tensor on the card is
    copied off it)."""
    return np.asarray(a.cpu() if hasattr(a, "cpu") else a)


def _vals(a) -> list:
    """A column of results as Python ints (bools as 0 and 1); a list is
    read item by item (numpy would turn uint64 values past 2^63 mixed
    with smaller ones into floats)."""
    if isinstance(a, (list, tuple)):
        return [int(v) for v in a]
    return [int(v) for v in _host(a).reshape(-1).tolist()]


def dtype_column(name: str, n: int = 1000) -> np.ndarray:
    """``n`` values of element type ``name`` from a fixed seed, spread
    over the whole range (unsigned values above the signed maximum
    among them)."""
    rng = np.random.default_rng(7)
    dt = np.dtype(name)
    if dt == np.bool_:
        return rng.random(n) < 0.5
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, size=n, dtype=dt,
                        endpoint=True)


def dtype_battery(ctx, L, dtypes=DTYPE_COLUMNS, n: int = 1000) -> dict:
    """The ops over one column of each element type in ``dtypes``:
    AllGatherArrays, Gather, Sort, Min, Max, Sum, Size, PrefixSum and
    ExPrefixSum, Window and DisjointWindow, Zip, Merge, Sample,
    BernoulliSample, Rebalance, ReduceToIndex, ReduceByKey on the column
    and keyed by it, GroupByKey keyed by it, and for the integer types
    ReduceByKey and ReduceToIndex with a min and a max fold of the
    column, a Map of ``x + 1``, ``x // 3`` and the conversion to float64
    and a Filter of ``x > c``. Min and Max of bools are left out (both
    packages refuse them). Returns JSON-able results by
    ``"<dtype>/<op>"``, with the element type each egress returned."""
    api = L.api
    out = {}
    for name in dtypes:
        col = dtype_column(name, n)
        is_bool = col.dtype == np.bool_
        keys = np.random.default_rng(8).integers(0, 13, n).astype(np.int64)
        ones = np.ones(n, dtype=np.int64)

        def d(c=col):
            return ctx.Distribute(c)

        def put(op, value):
            out[f"{name}/{op}"] = value

        arr = d().AllGatherArrays()
        put("all_gather_arrays", [str(_host(arr).dtype), _vals(arr)])
        put("gather", _vals(d().Gather(0)))
        put("sort", _vals(d().Sort().AllGather()))
        if not is_bool and name != "uint64":
            put("min", int(d().Min()))
        if not is_bool:
            put("max", int(d().Max()))
        put("sum", int(d().Sum()))
        put("size", int(d().Size()))
        put("prefix_sum", _vals(d().PrefixSum().AllGather()))
        put("ex_prefix_sum", _vals(d().ExPrefixSum(initial=1)
                                   .AllGather()))
        put("window", _vals(d().Window(
            3, lambda i, w: w[-1], device_fn=lambda w: w[:, -1])
            .AllGather()))
        put("disjoint_window", _vals(d().DisjointWindow(
            4, lambda i, w: w[0], device_fn=lambda w: w[:, 0])
            .AllGather()))
        put("zip", _vals(api.Zip(d(), d(col[::-1].copy()),
                                 zip_fn=lambda a, b: a ^ b).AllGather()))
        half = n // 2
        put("merge", _vals(api.Merge(
            ctx.Distribute(np.sort(col[:half])),
            ctx.Distribute(np.sort(col[half:]))).AllGather()))
        put("sample", _vals(d().Sample(50, seed=3).AllGather()))
        put("bernoulli", _vals(d().BernoulliSample(0.2, seed=5)
                               .AllGather()))
        reb = api.Concat(d(col[:300].copy()), d(col[300:].copy()))
        put("rebalance", _vals(reb.Rebalance().AllGather()))
        rti = ctx.Distribute({"i": keys, "v": col}).ReduceToIndex(
            lambda t: t["i"], api.FieldReduce({"i": "first", "v": "sum"}),
            13, neutral={"i": 0, "v": col[:1][0] * 0}).AllGather()
        put("reduce_to_index", [[int(t["i"]), int(t["v"])] for t in rti])
        rv = ctx.Distribute({"k": keys, "v": col}).ReduceByKey(
            lambda t: t["k"], api.FieldReduce({"k": "first", "v": "sum"}))
        put("reduce_by_key_value", sorted(
            (int(t["k"]), int(t["v"])) for t in rv.AllGather()))
        rk = ctx.Distribute({"k": col, "v": ones}).ReduceByKey(
            lambda t: t["k"], api.FieldReduce({"k": "first", "v": "sum"}))
        put("reduce_by_key_keyed", sorted(
            (int(t["k"]), int(t["v"])) for t in rk.AllGather()))
        if not is_bool:
            # the min and max folds read the unsigned value
            for fold in ("min", "max"):
                red = api.FieldReduce({"k": "first", "v": fold})
                rv = ctx.Distribute({"k": keys, "v": col}).ReduceByKey(
                    lambda t: t["k"], red)
                put(f"reduce_by_key_{fold}", sorted(
                    (int(t["k"]), int(t["v"])) for t in rv.AllGather()))
                ri = ctx.Distribute({"k": keys, "v": col}).ReduceToIndex(
                    lambda t: t["k"], red, 13,
                    neutral={"k": 0, "v": col[:1][0] * 0}).AllGather()
                put(f"reduce_to_index_{fold}",
                    [[int(t["k"]), int(t["v"])] for t in ri])
        gk = ctx.Distribute({"k": col, "v": ones}).GroupByKey(
            lambda t: t["k"], lambda k, items: (int(k), len(items)))
        put("group_by_key", sorted(map(list, gk.AllGather())))
        if not is_bool:
            c = int(col[n // 3])
            put("map_add", _vals(d().Map(lambda x: x + 1).AllGather()))
            put("map_floordiv", _vals(d().Map(lambda x: x // 3)
                                      .AllGather()))
            put("filter_gt", _vals(d().Filter(lambda x, c=c: x > c)
                                   .AllGather()))
            f64 = d().Map(L.to_f64).AllGatherArrays()
            put("map_f64", [str(_host(f64).dtype),
                            [float(v) for v in _host(f64).tolist()]])
            m = d().Map(lambda x: x + 1).AllGatherArrays()
            put("map_dtype", str(_host(m).dtype))
    return out


def main():
    import argparse
    import json
    import tempfile

    import thrill_tpu_torch as tt
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        out = tt.Run(lambda ctx: battery(ctx, Port(), tmp), args.workers,
                     device=args.device)
    print(json.dumps({k: (v if isinstance(v, (int, float, str)) else
                          len(v)) for k, v in out.items()}))


if __name__ == "__main__":
    main()
