"""A mesh of two real processes (``tt.RunDistributed``) on the CPU
against the reference package's one-process run and the port's own.

Two processes, each a port controller with 2 workers (W = 4), gloo for
the device plane and the authenticated TCP group for the host plane, run
the battery of the reference's ``tests/net/distributed_child.py`` (the
device WordCount-shaped ReducePair and Sum, ``ctx.net.all_gather``, the
host text WordCount and Size over the multiplexer, the host
``Sort(compare_fn)``, the ``ReadWordsPacked`` device WordCount, the host
InnerJoin with and without LocationDetection, ``collective_mean_stdev``)
plus a device Sort of 2^12 TeraSort-shaped records. This file is also
the child: run as ``__main__`` it is one process of the mesh.

Tolerance: exact (no float is compared). Every rank's results equal the
reference's one-process W = 4 run and the port's one-process W = 4 run;
the items moved by each rank sum to the one-process port's; the
location detection moves fewer items than the plain join. The children
run under a load-scaled deadline with one retry, as the reference's
``tests/net/test_distributed.py:123-137`` does.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TEXT = "\n".join(
    f"line {i} word{i % 7} again word{i % 3}" for i in range(211)) + "\n"
SORT_N = 1 << 12


def sort_records():
    rng = np.random.default_rng(18)
    return {"key": rng.integers(0, 256, (SORT_N, 10), dtype=np.uint8),
            "val": np.arange(SORT_N, dtype=np.int64)}


def _digest(tree) -> str:
    h = hashlib.sha256()
    for k in sorted(tree):
        h.update(np.ascontiguousarray(tree[k]).tobytes())
    return h.hexdigest()


def _join_inputs():
    left = [(f"A{i % 10}", i) for i in range(60)]
    right = [(f"A{i % 5}" if i % 2 else f"B{i}", -i) for i in range(60)]
    return left, right


def port_job(text_path):
    """The battery on the port (a job of ``tt.Run``/``RunDistributed``)."""
    import torch

    from thrill_tpu_torch.api.dia import InnerJoin

    def job(ctx):
        vals = np.arange(1000, dtype=np.int64)
        hist = ctx.Distribute(vals).Map(lambda x: (x % 10, 1)) \
            .ReducePair(lambda a, b: a + b)
        pairs = sorted((int(k), int(v)) for k, v in hist.AllGather())
        total = int(ctx.Distribute(vals).Sum())
        totals = ctx.net.all_gather(total)
        words = ctx.ReadLines(text_path).FlatMap(lambda line: line.split())
        words.Keep()
        wc = words.Map(lambda w: (w, 1)).ReducePair(lambda a, b: a + b)
        host_counts = sorted((k, int(v)) for k, v in wc.AllGather())
        host_total = int(words.Size())
        host_sorted = ctx.ReadLines(text_path) \
            .FlatMap(lambda line: line.split()) \
            .Sort(compare_fn=lambda a, b: a < b).AllGather()
        red = ctx.ReadWordsPacked(text_path, max_word=12).Map(lambda t: {
            "w": t["w"],
            "c": torch.ones_like(t["w"][..., 0], dtype=torch.int64)}) \
            .ReduceByKey(lambda t: t["w"],
                         lambda a, b: {"w": a["w"], "c": a["c"] + b["c"]})
        device_counts = sorted(
            (bytes(np.asarray(it["w"])).rstrip(b"\x00").decode(),
             int(it["c"])) for it in red.AllGather())

        def mkj(ld):
            left, right = _join_inputs()
            return InnerJoin(ctx.Distribute(left, storage="host"),
                             ctx.Distribute(right, storage="host"),
                             lambda t: t[0], lambda t: t[0],
                             lambda a, b: (a[0], a[1], b[1]),
                             location_detection=ld)

        mex = ctx.mesh_exec
        base = int(mex.stats_items_moved)
        join_plain = sorted(map(list, mkj(False).AllGather()))
        moved_plain = int(mex.stats_items_moved) - base
        base = int(mex.stats_items_moved)
        join_ld = sorted(map(list, mkj(True).AllGather()))
        moved_ld = int(mex.stats_items_moved) - base
        srt = ctx.Distribute(sort_records()).Sort(
            key_fn=lambda r: r["key"]).Keep()
        sort_size = srt.Size()
        out = {k: v.cpu().numpy() for k, v in srt.AllGatherArrays().items()}
        ms = ctx.collective_mean_stdev(float(ctx.host_rank))
        stats = ctx.overall_stats()
        return {"pairs": pairs, "total": total, "totals": totals,
                "rank_mean_stdev": [round(ms[0], 6), round(ms[1], 6)],
                "device_counts": device_counts, "join_plain": join_plain,
                "join_ld": join_ld, "moved_plain": moved_plain,
                "moved_ld": moved_ld, "host_counts": host_counts,
                "host_total": host_total, "host_sorted": host_sorted,
                "sort_size": sort_size, "sort_digest": _digest(out),
                "hosts": stats.get("hosts", 1),
                "net_workers": ctx.net.num_workers,
                "mesh_workers": ctx.num_workers,
                "items_moved_local": int(mex.stats_items_moved),
                "items_moved": stats["items_moved"]}
    return job


def ref_run(text_path):
    """The same battery on the reference package, one process, W = 4."""
    import jax
    import jax.numpy as jnp

    from thrill_tpu.api import Context as JContext
    from thrill_tpu.api.ops.join import InnerJoin as JInnerJoin
    from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

    ctx = JContext(JMeshExec(devices=jax.devices("cpu")[:4]))
    try:
        vals = np.arange(1000, dtype=np.int64)
        hist = ctx.Distribute(vals).Map(lambda x: (x % 10, 1)) \
            .ReducePair(lambda a, b: a + b)
        pairs = sorted((int(k), int(v)) for k, v in hist.AllGather())
        total = int(ctx.Distribute(vals).Sum())
        words = ctx.ReadLines(text_path).FlatMap(lambda line: line.split())
        words.Keep()
        wc = words.Map(lambda w: (w, 1)).ReducePair(lambda a, b: a + b)
        host_counts = sorted((k, int(v)) for k, v in wc.AllGather())
        host_total = int(words.Size())
        host_sorted = ctx.ReadLines(text_path) \
            .FlatMap(lambda line: line.split()) \
            .Sort(compare_fn=lambda a, b: a < b).AllGather()
        red = ctx.ReadWordsPacked(text_path, max_word=12).Map(lambda t: {
            "w": t["w"],
            "c": jnp.ones_like(t["w"][..., 0], dtype=jnp.int64)}) \
            .ReduceByKey(lambda t: t["w"],
                         lambda a, b: {"w": a["w"], "c": a["c"] + b["c"]})
        device_counts = sorted(
            (bytes(np.asarray(it["w"])).rstrip(b"\x00").decode(),
             int(it["c"])) for it in red.AllGather())

        def mkj(ld):
            left, right = _join_inputs()
            return JInnerJoin(ctx.Distribute(left, storage="host"),
                              ctx.Distribute(right, storage="host"),
                              lambda t: t[0], lambda t: t[0],
                              lambda a, b: (a[0], a[1], b[1]),
                              location_detection=ld)

        join_plain = sorted(map(list, mkj(False).AllGather()))
        join_ld = sorted(map(list, mkj(True).AllGather()))
        srt = ctx.Distribute(sort_records()).Sort(key_fn=lambda r: r["key"])
        out = {k: np.asarray(v) for k, v in srt.AllGatherArrays().items()}
        return {"pairs": pairs, "total": total,
                "device_counts": device_counts, "join_plain": join_plain,
                "join_ld": join_ld, "host_counts": host_counts,
                "host_total": host_total, "host_sorted": host_sorted,
                "sort_size": len(out["val"]), "sort_digest": _digest(out)}
    finally:
        ctx.close()


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


def _launch(nproc, text_path):
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
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), coordinator,
             str(rank), str(nproc), text_path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
    return procs


class _ChildTimeout(Exception):
    pass


def _drain(procs, timeout_s):
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
    for p, (out, err) in zip(procs, drained):
        assert p.returncode == 0, f"child failed:\n{err[-3000:]}"
        lines = [l for l in out.splitlines() if l.startswith("RESULT ")]
        assert lines, f"no RESULT line:\n{out}\n{err[-2000:]}"
        results.append(json.loads(lines[-1][len("RESULT "):]))
    return results


def _run_children(nproc, text_path, timeout_s=120):
    """Launch and drain, with one retry on a timeout or a child's
    failure (a load spike, not a fault, fails once)."""
    try:
        return _drain(_launch(nproc, text_path), timeout_s)
    except (_ChildTimeout, AssertionError) as e:
        print(f"first attempt failed; retrying once:\n{e}", flush=True)
        return _drain(_launch(nproc, text_path), timeout_s)


def test_two_processes_equal_the_reference_and_one_process(tmp_path):
    import thrill_tpu_torch as tt

    text = tmp_path / "words.txt"
    text.write_text(_TEXT)
    procs_results = _run_children(2, str(text))
    # through JSON as the children's results come (tuples as lists)
    one = json.loads(json.dumps(tt.Run(port_job(str(text)), 4,
                                       device="cpu")))
    ref = json.loads(json.dumps(ref_run(str(text))))

    # the reference's battery, value for value
    for r in procs_results + [one]:
        for k, v in ref.items():
            assert r[k] == v, k
    # every rank equal, and equal to the one-process port but for what
    # counts processes
    per_rank = ("totals", "rank_mean_stdev", "hosts", "net_workers",
                "moved_plain", "moved_ld", "items_moved_local")
    r0 = {k: v for k, v in procs_results[0].items() if k not in per_rank}
    for r in procs_results[1:]:
        assert {k: v for k, v in r.items() if k not in per_rank} == r0
    assert r0 == {k: v for k, v in one.items() if k not in per_rank}
    for r in procs_results:
        assert r["totals"] == [r["total"]] * 2
        assert r["rank_mean_stdev"] == [0.5, 0.5]
        assert r["hosts"] == 2 and r["net_workers"] == 2
        assert r["mesh_workers"] == 4
    assert one["totals"] == [one["total"]] and one["net_workers"] == 1
    # the processes' items moved sum to the one-process run's
    assert sum(r["items_moved_local"] for r in procs_results) == \
        one["items_moved_local"] == one["items_moved"]
    assert procs_results[0]["items_moved"] == one["items_moved"]
    for key in ("moved_plain", "moved_ld"):
        assert sum(r[key] for r in procs_results) == one[key]
    # the location detection prunes single-side keys before the shuffle
    assert sum(r["moved_ld"] for r in procs_results) < \
        sum(r["moved_plain"] for r in procs_results)


def test_ops_and_a_checkpoint_manager_are_made_across_processes(tmp_path):
    """Every op is made on a mesh of several processes (the op sweep
    runs them, ``test_torch_distributed_ops.py``), and every exchange
    mode is taken there (``test_torch_exchange_modes_mp.py`` runs them);
    a checkpoint directory gives each process a checkpoint manager whose
    workers are its own (``test_torch_ckpt_mp.py`` runs its epochs)."""
    import thrill_tpu_torch as tt
    from thrill_tpu_torch.common.config import Config
    from thrill_tpu_torch.data import exchange
    from thrill_tpu_torch.parallel.mesh import MeshExec

    mex = MeshExec(num_workers=4, device="cpu", process_index=0,
                   num_processes=2)
    ctx = tt.Context(mex)
    try:
        d = ctx.Distribute(np.arange(8, dtype=np.int64))
        for made in (d.PrefixSum(), d.ZipWithIndex(), d.Rebalance(),
                     d.Window(2, None, device_fn=lambda w: w.sum(1)),
                     d.Sample(3), d.ReduceToIndex(lambda x: x, None, 8)):
            assert made.node.context is ctx
        for mode in ("onefactor", "ragged"):
            mex.exchange_mode = mode
            assert exchange.resolve_mode(mex) == mode
    finally:
        ctx.close()
    for rank, mine in ((0, [0, 1]), (1, [2, 3])):
        ctx = tt.Context(MeshExec(num_workers=4, device="cpu",
                                  process_index=rank, num_processes=2),
                         config=Config(ckpt_dir=str(tmp_path)))
        try:
            assert ctx.checkpoint is not None
            assert ctx.checkpoint._local_workers() == mine
        finally:
            ctx.close()


def failing_job(ctx):
    """Process 1 fails before a host collective that process 0 waits
    in: process 0 must abort with process 1's cause."""
    from thrill_tpu_torch.net.group import ClusterAbort
    if ctx.host_rank == 1:
        raise RuntimeError("disk on fire")
    try:
        ctx.net.all_gather(1)
    except ClusterAbort as e:
        return {"origin": e.origin, "cause": e.cause}
    return {"origin": None}


def test_a_failing_process_aborts_the_other():
    procs = _launch(2, "fail")
    outs = [p.communicate(timeout=120) for p in procs]
    assert procs[1].returncode != 0 and "disk on fire" in outs[1][1]
    assert procs[0].returncode == 0, outs[0][1][-3000:]
    res = json.loads([l for l in outs[0][0].splitlines()
                      if l.startswith("RESULT ")][-1][len("RESULT "):])
    assert res == {"origin": 1, "cause": "RuntimeError: disk on fire"}


def _child(coordinator, rank, nproc, text_path):
    import thrill_tpu_torch as tt
    job = failing_job if text_path == "fail" else port_job(text_path)
    res = tt.RunDistributed(job,
                            coordinator_address=coordinator,
                            num_processes=nproc, process_id=rank,
                            workers_per_process=2, device="cpu")
    print("RESULT " + json.dumps(res), flush=True)


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
