"""The exchange modes on a mesh of two real processes
(``tt.RunDistributed``) on the CPU, against the reference package's
one-process run and the port's own.

Two processes, each a port controller with 2 workers (W = 4), gloo for
the device plane, run one battery in one launch: a Sort of 2^12
TeraSort-shaped records, a ReduceByKey of 2^12 Zipf words with f64
weights and PageRank (2^10 pages, 2^12 edges, 3 iterations), each under
the dense, the 1-factor and the ragged exchange, and the ReduceByKey's
streamed post phase (``THRILL_TPU_REDUCE_STREAM=1``); then the skew
flip to the 1-factor rounds, narrowing on and off, the optimistic
dispatch warm against the capacity cache off, a capacity overflow in
one process's rows only, and seeds installed without the ``symmetric``
attestation. The same battery runs in one process at W = 4. This file
is also the child: run as ``__main__`` it is one process of the mesh.

Tolerance: the processes are bit-equal to the port's one-process run in
every case, the streamed ReduceByKey included (the rounds come in the
same schedule, and each receiver folds them in it). Against the
reference's one-process W = 4 run the dense and 1-factor results are
bit-equal but PageRank's f64 ranks, within 1e-12 (fault C15, as in
every cross-package PageRank test); XLA:CPU has no
``ragged_all_to_all``, so the ragged results are held against the
reference's dense ones; the streamed ReduceByKey equals the reference's
as a set of keys with their integer counts, its f64 sums within 1e-12
relative, the tolerance ``tests/test_torch_exchange_stream.py`` states
for the streamed fold against the rank-order one. The children run
under a load-scaled deadline of 150 s with one retry, so a hang in a
heal fails the test instead of holding it.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1 << 12                      # items a job
PAGES, EDGES, ITERS = 1 << 10, 1 << 12, 3
MODES = ("dense", "onefactor", "ragged")
PR_TOL = 1e-12
STREAM_RTOL = 1e-12


def sort_records():
    rng = np.random.default_rng(20)
    return {"key": rng.integers(0, 256, (N, 10), dtype=np.uint8),
            "val": np.arange(N, dtype=np.int64)}


def words():
    rng = np.random.default_rng(21)
    p = 1.0 / np.arange(1, 301)
    return {"w": rng.choice(300, N, p=p / p.sum()).astype(np.int64),
            "c": np.ones(N, dtype=np.int64),
            "f": rng.normal(size=N)}


def _digest(tree) -> str:
    h = hashlib.sha256()
    for k in sorted(tree):
        h.update(np.ascontiguousarray(np.asarray(tree[k])).tobytes())
    return h.hexdigest()


def _pairs(tree):
    """(key, count, f64 sum) triples, ordered by key."""
    o = np.argsort(np.asarray(tree["w"]), kind="stable")
    return [[int(tree["w"][i]), int(tree["c"][i]), float(tree["f"][i])]
            for i in o]


class _Env:
    """Set environment variables for a block, restoring them after."""

    def __init__(self, **kv):
        self.kv = kv

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.kv}
        for k, v in self.kv.items():
            os.environ[k] = v

    def __exit__(self, *a):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _stats(mex):
    return (mex.stats_bytes_cross, mex.stats_fetches,
            mex.stats_exchanges_overlapped, mex.stats_cap_cache_misses)


def port_job(ctx):
    """The battery on the port (a job of ``tt.Run``/``RunDistributed``)."""
    import torch

    import thrill_tpu_torch as tt
    from thrill_tpu_torch.data import exchange as ex
    from thrill_tpu_torch.examples import page_rank as tpr

    mex = ctx.mesh_exec
    W = mex.num_workers
    out = {"rank": ctx.host_rank}
    recs, wds = sort_records(), words()
    red = tt.FieldReduce({"w": "first", "c": "sum", "f": "sum"})
    edges = tpr.zipf_graph(PAGES, EDGES, seed=3)

    def reduce():
        return ctx.Distribute(wds).ReduceByKey(lambda t: t["w"], red) \
            .AllGatherArrays()

    for mode in MODES:
        mex.exchange_mode = mode
        b0 = mex.stats_bytes_cross
        srt = ctx.Distribute(recs).Sort(key_fn=lambda r: r["key"]) \
            .AllGatherArrays()
        out[f"sort_{mode}"] = _digest(srt)
        out[f"sort_{mode}_cross"] = mex.stats_bytes_cross - b0
        out[f"reduce_{mode}"] = _pairs(reduce())
        ranks = tpr.page_rank(ctx, edges, PAGES, ITERS)
        out[f"pagerank_{mode}"] = np.asarray(ranks).tolist()
    mex.exchange_mode = "dense"
    with _Env(THRILL_TPU_REDUCE_STREAM="1"):
        out["reduce_stream"] = _pairs(reduce())

    # the skew flip: each worker sends nine tenths of its rows to the
    # next one, so the 1-factor rounds pad one round, the dense plan all
    vals = np.arange(4 * N, dtype=np.int64)
    shards = ctx.Distribute(vals).node.materialize()

    def skew_dest(t, m, w):
        return torch.where(t % 10 == 0, t % W, (w + 1) % W)
    got = ex.exchange(shards, skew_dest, ("skew_test", W))
    out["skew"] = np.asarray(got.to_global_numpy()).tolist()
    out["skew_counts"] = got.global_counts.tolist()
    out["skew_chosen"] = [r.chosen for r in ctx.decisions.records
                          if r.kind == "xchg_strategy"
                          and r.site == ex._site(("skew_test", W))]

    # narrowing on and off: the ragged Sort's carrier narrows its index
    mex.exchange_mode = "ragged"
    for narrow in ("1", "0"):
        with _Env(THRILL_TPU_XCHG_NARROW=narrow):
            b0 = mex.stats_bytes_cross
            srt = ctx.Distribute(recs).Sort(key_fn=lambda r: r["key"]) \
                .AllGatherArrays()
            out[f"narrow_{narrow}"] = _digest(srt)
            out[f"narrow_{narrow}_cross"] = mex.stats_bytes_cross - b0
    mex.exchange_mode = "dense"

    # the optimistic dispatch: the same exchange three times with the
    # capacity cache on (the third warm), once with it off
    def balanced(t, m, w):
        return t % W

    def run_site(site, dest, data=vals):
        s = ctx.Distribute(data).node.materialize()
        before = _stats(mex)
        got = ex.exchange(s, dest, (site, W))
        arr = np.asarray(got.to_global_numpy())
        after = _stats(mex)
        return arr, [a - b for a, b in zip(after, before)]

    for _ in range(2):
        run_site("opt_test", balanced)
    warm, d_on = run_site("opt_test", balanced)
    with _Env(THRILL_TPU_XCHG_CAP_CACHE="0"):
        cold, d_off = run_site("opt_test", balanced)
    out["opt_equal"] = bool(np.array_equal(warm, cold))
    out["opt_fetches"] = [d_on[1], d_off[1]]
    out["opt_overlapped"] = [d_on[2], d_off[2]]

    # a capacity overflow in one process's rows only: the site learns a
    # balanced plan, then the second process's workers send every row
    # to worker 0
    run_site("ovf_test", balanced)

    def hot(t, m, w):
        return torch.where(w >= W // 2, torch.zeros_like(t), t % W)
    healed, d = run_site("ovf_test", hot)
    out["ovf"] = healed.tolist()
    out["ovf_misses"] = d[3]
    out["ovf_records"] = [
        [r.kind, r.chosen, r.verdict] for r in ctx.decisions.records
        if r.site == ex._site(("ovf_test", W))]

    # seeds without the attestation turn optimism off across processes
    ex.install_plan_seeds(mex, {"caps": {"0" * 40: [1, 1]}}, ("caps",))
    _, d = run_site("opt_test", balanced)
    out["unattested_overlapped"] = d[2]
    out["symmetric"] = bool(getattr(mex, "_plan_seed_symmetric", True))
    return out


def ref_run():
    """The modes' jobs on the reference package, one process, W = 4:
    dense and 1-factor (its ragged program does not compile on
    XLA:CPU), and the streamed ReduceByKey."""
    import jax

    from thrill_tpu.api import Context as JContext
    from thrill_tpu.api import FieldReduce as JFieldReduce
    from thrill_tpu.parallel.mesh import MeshExec as JMeshExec
    sys.path.insert(0, os.path.join(REPO, "examples"))
    import page_rank as jpr

    ctx = JContext(JMeshExec(devices=jax.devices("cpu")[:4]))
    mex = ctx.mesh_exec
    out = {}
    red = JFieldReduce({"w": "first", "c": "sum", "f": "sum"})
    edges = jpr.zipf_graph(PAGES, EDGES, seed=3)

    def reduce():
        arr = ctx.Distribute(words()).ReduceByKey(lambda t: t["w"], red) \
            .AllGatherArrays()
        return {k: np.asarray(v) for k, v in arr.items()}
    try:
        for mode in ("dense", "onefactor"):
            mex.exchange_mode = mode
            srt = ctx.Distribute(sort_records()).Sort(
                key_fn=lambda r: r["key"]).AllGatherArrays()
            out[f"sort_{mode}"] = _digest(
                {k: np.asarray(v) for k, v in srt.items()})
            out[f"reduce_{mode}"] = _pairs(reduce())
            out[f"pagerank_{mode}"] = np.asarray(
                jpr.page_rank(ctx, edges, PAGES, ITERS)).tolist()
        mex.exchange_mode = "dense"
        with _Env(THRILL_TPU_REDUCE_STREAM="1"):
            out["reduce_stream"] = _pairs(reduce())
    finally:
        ctx.close()
    return out


def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _launch(nproc, out_dir):
    ports = _free_ports(1 + nproc)
    coordinator = f"127.0.0.1:{ports[0]}"
    hostlist = " ".join(f"127.0.0.1:{p}" for p in ports[1:])
    procs = []
    for rank in range(nproc):
        env = dict(os.environ, THRILL_TPU_HOSTLIST=hostlist,
                   THRILL_TPU_RANK=str(rank),
                   THRILL_TPU_SECRET="test-cluster-secret",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        for var in ("THRILL_TPU_EXCHANGE", "THRILL_TPU_REDUCE_STREAM",
                    "THRILL_TPU_XCHG_NARROW", "THRILL_TPU_XCHG_CAP_CACHE"):
            env.pop(var, None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), coordinator,
             str(rank), str(nproc), _result_path(out_dir, rank)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
    return procs


class _ChildTimeout(Exception):
    pass


def _result_path(out_dir, rank):
    return os.path.join(str(out_dir), f"result-{rank}.json")


def _drain(procs, timeout_s, out_dir):
    import concurrent.futures as cf

    from thrill_tpu_torch.common.timeouts import scaled
    timeout_s = scaled(timeout_s)
    with cf.ThreadPoolExecutor(len(procs)) as ex:
        futs = [ex.submit(p.communicate, None, timeout_s) for p in procs]
        try:
            drained = [f.result(timeout=timeout_s + 20) for f in futs]
        except (cf.TimeoutError, subprocess.TimeoutExpired):
            for q in procs:
                q.kill()
            raise _ChildTimeout(f"children timed out ({timeout_s:.0f}s)")
    results = []
    for rank, (p, (out, err)) in enumerate(zip(procs, drained)):
        assert p.returncode == 0, f"child failed:\n{err[-3000:]}"
        # the result comes through a file the child wrote whole and
        # renamed into place: a 300 KB line through the stdout pipe was
        # read cut in two under load
        path = _result_path(out_dir, rank)
        assert os.path.exists(path), f"no result file:\n{out}\n{err[-2000:]}"
        with open(path) as f:
            results.append(json.load(f))
    return results


def _run_children(nproc, out_dir, timeout_s=150):
    """Launch and drain, with one retry on a timeout or a child's
    failure (a load spike, not a fault, fails once)."""
    try:
        return _drain(_launch(nproc, out_dir), timeout_s, out_dir)
    except (_ChildTimeout, AssertionError) as e:
        print(f"first attempt failed; retrying once:\n{e}", flush=True)
        for rank in range(nproc):
            if os.path.exists(_result_path(out_dir, rank)):
                os.remove(_result_path(out_dir, rank))
        return _drain(_launch(nproc, out_dir), timeout_s, out_dir)


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool(
        np.all(np.abs(a - b) <= tol * np.maximum(np.abs(b), 1e-300)))


def test_every_mode_across_processes_is_one_process_and_the_reference(
        monkeypatch, tmp_path):
    import thrill_tpu_torch as tt

    for var in ("THRILL_TPU_EXCHANGE", "THRILL_TPU_REDUCE_STREAM",
                "THRILL_TPU_XCHG_NARROW", "THRILL_TPU_XCHG_CAP_CACHE"):
        monkeypatch.delenv(var, raising=False)
    kids = _run_children(2, tmp_path)
    one = json.loads(json.dumps(tt.Run(port_job, 4, device="cpu")))
    ref = json.loads(json.dumps(ref_run()))

    # every rank bit-equal to one process, but what counts processes
    per_rank = ("rank", "sort_dense_cross", "sort_onefactor_cross",
                "sort_ragged_cross", "narrow_1_cross", "narrow_0_cross",
                "opt_fetches", "unattested_overlapped", "symmetric")
    for k in kids:
        for key, v in one.items():
            if key not in per_rank:
                assert k[key] == v, key
    # the reference: dense and 1-factor bit-equal, ragged against dense
    for mode in MODES:
        want = "dense" if mode == "ragged" else mode
        assert one[f"sort_{mode}"] == ref[f"sort_{want}"], mode
        assert one[f"reduce_{mode}"] == ref[f"reduce_{want}"], mode
        assert _close(one[f"pagerank_{mode}"], ref[f"pagerank_{want}"],
                      PR_TOL), mode
        assert one[f"pagerank_{mode}"] == one["pagerank_dense"], mode
    s_one, s_ref = one["reduce_stream"], ref["reduce_stream"]
    assert [p[:2] for p in s_one] == [p[:2] for p in s_ref]
    assert _close([p[2] for p in s_one], [p[2] for p in s_ref],
                  STREAM_RTOL)

    for k in kids:
        # the skew flip read the global matrix: the 1-factor rounds in
        # every process, as in one process
        assert k["skew_chosen"] == one["skew_chosen"] == ["onefactor"]
        # the ragged exchange ships only the rows that leave their
        # process; narrowing ships them narrower
        assert k["sort_ragged_cross"] < k["sort_dense_cross"]
        assert k["narrow_1"] == k["narrow_0"]
        assert k["narrow_1_cross"] < k["narrow_0_cross"]
        # warm and optimistic: fewer counted fetches than the synced
        # plan, and the same rows
        assert k["opt_equal"]
        assert k["opt_overlapped"] == [1, 0]
        assert k["opt_fetches"][0] < k["opt_fetches"][1]
        # the overflow in one process's rows healed in both
        assert k["ovf_misses"] == 1
        assert k["ovf_records"] == kids[0]["ovf_records"]
        assert ["xchg_optimistic", "optimistic", "miss"] in k["ovf_records"]
        # unattested seeds: the synced plan across processes
        assert not k["symmetric"] and k["unattested_overlapped"] == 0
    assert one["ovf_misses"] == 1 and one["unattested_overlapped"] == 1


def _child(coordinator, rank, nproc, out_path):
    import thrill_tpu_torch as tt
    res = tt.RunDistributed(port_job, coordinator_address=coordinator,
                            num_processes=nproc, process_id=rank,
                            workers_per_process=2, device="cpu")
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(res, f)
    os.replace(tmp, out_path)


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
