"""The op sweep across processes: every DIA op, the device InnerJoin and
Iterate on a mesh of two real processes (``tt.RunDistributed``) on the
CPU, against the reference package's one-process run and the port's own.

Two processes, each a port controller with 2 workers (W = 4), gloo for
the device plane and the authenticated TCP group for the host plane, run
one battery in one launch: ``thrill_tpu_torch/examples/op_battery.py``,
which holds every entry of the reference's
``tests/net/ops_sweep_child.py`` (the host Sort with forced spills
here) and every other op of the DIA surface. The reference runs the same
battery through ``_Ref``, a handle of the reference package. This file
is also the child: run as ``__main__`` it is one process of the mesh.

Tolerance: every rank's results equal the reference's one-process W = 4
run exactly, except PageRank's f64 ranks, within 1e-12 of each rank
(C15: a page's sum may associate differently in XLA), and the f32
PrefixSum, within 1e-6 of each value relative (XLA's scan associates
differently: one ulp at the largest values);
they are bit-equal to the port's one-process W = 4 run (floats through
JSON, which keeps every bit). The items moved by each rank sum to the
one-process port's. A failing op in one process aborts the other with
its cause. Sizes stay at or below 2^11 items; the children run under a
load-scaled deadline with one retry.
"""

import json
import os
import socket
import subprocess
import sys

from thrill_tpu_torch.examples.op_battery import (
    PER_RANK, PORT_ONLY, PR_ITERS, Port, battery)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_SORT_RUN = "500"            # forces the host Sort to spill runs
PR_TOL = 1e-12
F32_RTOL = 1e-6


class _Ref:
    name = "ref"

    def __init__(self):
        import jax
        import jax.numpy as jnp

        import thrill_tpu.api as api
        self.api = api
        self.xp = jnp
        self.seg_sum = jax.ops.segment_sum

    def stack1(self, xs):
        return self.xp.stack(xs, axis=1)

    def ones_like(self, x):
        return self.xp.ones_like(x)

    def examples(self):
        """The reference's examples (``examples/`` at the repository's
        root)."""
        sys.path.insert(0, os.path.join(REPO, "examples"))
        import k_means
        import page_rank
        import tpch
        return page_rank, k_means, tpch


def port_job(tmp):
    def job(ctx):
        return battery(ctx, Port(), tmp)
    return job


def ref_run(tmp):
    """The battery on the reference package, one process, W = 4."""
    import jax

    from thrill_tpu.api import Context as JContext
    from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

    ctx = JContext(JMeshExec(devices=jax.devices("cpu")[:4]))
    try:
        return battery(ctx, _Ref(), tmp)
    finally:
        ctx.close()


def failing_op_job(ctx):
    """An op fails in process 1 (its host PrefixSum's fold raises after
    the items were replicated); process 0 goes on to the next collective
    and must abort there with process 1's cause."""
    from thrill_tpu_torch.net.group import ClusterAbort
    rank = ctx.host_rank

    def fold(a, b):
        if rank == 1:
            raise RuntimeError("fold failed on process 1")
        return a + b

    d = ctx.Distribute(list(range(64)), storage="host").PrefixSum(fold)
    try:
        d.AllGather()
    except ClusterAbort as e:
        return {"origin": e.origin, "cause": e.cause}
    return {"origin": None}


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


def _launch(nproc, tmp):
    ports = _free_ports(1 + nproc)
    coordinator = f"127.0.0.1:{ports[0]}"
    hostlist = " ".join(f"127.0.0.1:{p}" for p in ports[1:])
    procs = []
    for rank in range(nproc):
        env = dict(os.environ, THRILL_TPU_HOSTLIST=hostlist,
                   THRILL_TPU_RANK=str(rank),
                   THRILL_TPU_SECRET="test-cluster-secret",
                   THRILL_TPU_HOST_SORT_RUN=HOST_SORT_RUN,
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), coordinator,
             str(rank), str(nproc), tmp],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
    return procs


class _ChildTimeout(Exception):
    pass


class _Children:
    """Launched children whose pipes are read from the start (a child
    blocked on a full pipe would stall while the parent works)."""

    def __init__(self, tmp, timeout_s):
        import concurrent.futures as cf

        from thrill_tpu_torch.common.timeouts import scaled
        self.tmp = tmp
        self.timeout_s = scaled(timeout_s)
        self.procs = _launch(2, tmp)
        self._ex = cf.ThreadPoolExecutor(len(self.procs))
        self._futs = [self._ex.submit(p.communicate, None, self.timeout_s)
                      for p in self.procs]

    def results(self):
        """Each child's result, which it writes to a file of the run's
        directory (a long line on a pipe may be cut at the child's
        exit)."""
        import concurrent.futures as cf
        try:
            drained = [f.result(timeout=self.timeout_s + 20)
                       for f in self._futs]
        except (cf.TimeoutError, subprocess.TimeoutExpired):
            self.kill()
            raise _ChildTimeout(f"children timed out "
                                f"({self.timeout_s:.0f}s)")
        finally:
            self._ex.shutdown(wait=False)
        out = []
        for rank, (p, (_o, err)) in enumerate(zip(self.procs, drained)):
            assert p.returncode == 0, f"child failed:\n{err[-3000:]}"
            path = os.path.join(self.tmp, f"result-{rank}.json")
            assert os.path.exists(path), f"no result:\n{err[-2000:]}"
            with open(path) as f:
                out.append(json.load(f))
        return out

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()


def _close(a, b, tol):
    return len(a) == len(b) and all(abs(x - y) <= tol for x, y in zip(a, b))


def test_the_op_battery_across_two_processes(tmp_path, monkeypatch):
    """Two processes against the reference's one-process W = 4 run
    (exact; PageRank's ranks within 1e-12, the f32 PrefixSum within
    1e-6 relative) and bit-equal to the port's one-process W = 4 run."""
    import thrill_tpu_torch as tt

    monkeypatch.setenv("THRILL_TPU_HOST_SORT_RUN", HOST_SORT_RUN)
    dirs = {k: tmp_path / k for k in ("procs", "one", "ref")}
    for d in dirs.values():
        d.mkdir()
    kids = _Children(str(dirs["procs"]), 150)
    try:
        # the one-process runs go on while the children work
        one = json.loads(json.dumps(tt.Run(port_job(str(dirs["one"])), 4,
                                           device="cpu")))
        ref = json.loads(json.dumps(ref_run(str(dirs["ref"]))))
        try:
            ranks = kids.results()
        except (_ChildTimeout, AssertionError) as e:
            print(f"first attempt failed; retrying once:\n{e}", flush=True)
            for d in dirs["procs"].iterdir():
                d.unlink()
            kids = _Children(str(dirs["procs"]), 150)
            ranks = kids.results()
    finally:
        kids.kill()

    assert set(one) - set(PORT_ONLY) == set(ref)
    for r in ranks + [one]:
        for k, v in ref.items():
            if k.startswith("pagerank"):
                assert _close(r[k], v, PR_TOL), k
            elif k == "prefix_sum_f32":
                assert _close(r[k], v, F32_RTOL * max(map(abs, v))), k
            else:
                assert r[k] == v, k
    # every rank bit-equal to the one-process port but for what counts
    # processes
    for r in ranks:
        assert {k: v for k, v in r.items() if k not in PER_RANK} == \
            {k: v for k, v in one.items() if k not in PER_RANK}
    # the items moved by each rank sum to the one-process run's
    for k in PER_RANK:
        assert sum(r[k] for r in ranks) == one[k], k
    assert one["items_moved_local"] == one["items_moved"]
    assert all(r["items_moved"] == one["items_moved"] for r in ranks)
    # the location filter moved fewer items than the plain join
    assert sum(r["moved_ld"] for r in ranks) < \
        sum(r["moved_plain"] for r in ranks)
    # with replay on PageRank replayed its tape and k-means missed its
    # capture (its send matrix follows the labels), in every process as
    # in one; with replay off both ran plain
    loops = ranks[0]["loops"]
    assert [l["name"] for l in loops] == ["page_rank", "k_means"] * 2
    assert loops[0]["captures"] == 1
    assert loops[0]["replays"] + loops[0]["fori_iters"] == PR_ITERS - 1
    assert all(l["captures"] == 0 and l["replays"] == 0
               and l["fori_iters"] == 0 for l in loops[1:])


def test_a_failing_op_aborts_the_other_process(tmp_path):
    procs = _launch(2, "fail")
    outs = [p.communicate(timeout=180) for p in procs]
    assert procs[1].returncode != 0
    assert "fold failed on process 1" in outs[1][1]
    assert procs[0].returncode == 0, outs[0][1][-3000:]
    res = json.loads([l for l in outs[0][0].splitlines()
                      if l.startswith("RESULT ")][-1][len("RESULT "):])
    assert res == {"origin": 1,
                   "cause": "RuntimeError: fold failed on process 1"}


def _child(coordinator, rank, nproc, tmp):
    import thrill_tpu_torch as tt
    job = failing_op_job if tmp == "fail" else port_job(tmp)
    res = tt.RunDistributed(job, coordinator_address=coordinator,
                            num_processes=nproc, process_id=rank,
                            workers_per_process=2, device="cpu")
    if tmp == "fail":
        print("RESULT " + json.dumps(res), flush=True)
        return
    with open(os.path.join(tmp, f"result-{rank}.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
