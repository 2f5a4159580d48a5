"""The port's MPI transport (``thrill_tpu_torch/net/mpi.py``) over the
reference's strict-rendezvous fake world (``tests/net/fake_mpi.py``,
loaded by path: it imports nothing of either package): the cases of
the reference's ``tests/net/test_mpi.py``, and real processes through a
port child (this file, run as ``__main__``).

mpi4py is not installed here, so the world is the fake: every message
is a rendezvous (an Isend completes only when the matching receive
posts), so a send that waited for its Isend would deadlock and fail its
join timeout. The shared collectives run on 1, 2, 3 and 7 thread-ranks;
a bulk exchange has every rank send before it receives; groups are
independent tag namespaces; ``construct()`` without mpi4py raises the
actionable message. The child runs the reference's child battery
(collectives on group 0, a bulk exchange on group 1, flush), then a
``RunDistributed`` job whose host control plane is the MPI world
(``THRILL_TPU_NET=mpi``): a host WordCount and a device Sum across the
processes, equal to one process's. As in the reference, the 3-process
run is marked slow. Tolerance: exact.
"""

import importlib.util
import json
import operator
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fake_mpi():
    spec = importlib.util.spec_from_file_location(
        "fake_mpi", os.path.join(REPO, "tests", "net", "fake_mpi.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scaled(s):
    from thrill_tpu_torch.common.timeouts import scaled
    return scaled(s)


def run_mpi_group(num_hosts, job, group_count=2, timeout=30):
    """``job(groups)`` on one daemon thread a fake-MPI rank; a rank's
    exception is raised here, and a rank still running after the join
    timeout is a deadlock. Returns the results by rank."""
    from thrill_tpu_torch.net import mpi as mpi_backend
    fake_mpi = _fake_mpi()
    timeout = _scaled(timeout)
    modules = fake_mpi.make_inprocess_world(num_hosts)
    results = [None] * num_hosts
    errors = [None] * num_hosts

    def target(rank):
        try:
            engine = mpi_backend._SendEngine()
            groups = [mpi_backend.MpiGroup(modules[rank],
                                           modules[rank].COMM_WORLD,
                                           group_tag=g, engine=engine)
                      for g in range(group_count)]
            results[rank] = job(groups)
            for grp in groups:
                grp.flush()
        except Exception as e:
            errors[rank] = e

    threads = [threading.Thread(target=target, args=(r,), daemon=True)
               for r in range(num_hosts)]
    for t in threads:
        t.start()
    stuck = []
    for t in threads:
        t.join(timeout=timeout)
        if t.is_alive():
            stuck.append(t)
    for e in errors:
        if e is not None:
            raise e
    assert not stuck, ("deadlock: a collective or send blocked past the "
                       "join timeout under strict rendezvous")
    for m in modules:
        m.COMM_WORLD.close()
    return results


SIZES = [1, 2, 3, 7]


@pytest.mark.parametrize("p", SIZES)
def test_prefix_sum(p):
    res = run_mpi_group(p, lambda gs: gs[0].prefix_sum(gs[0].my_rank + 1))
    assert res == [sum(range(1, r + 2)) for r in range(p)]


@pytest.mark.parametrize("p", SIZES)
def test_broadcast(p):
    res = run_mpi_group(p, lambda gs: gs[0].broadcast(
        42 if gs[0].my_rank == 0 else None, origin=0))
    assert res == [42] * p


@pytest.mark.parametrize("p", SIZES)
def test_all_gather(p):
    res = run_mpi_group(p, lambda gs: gs[0].all_gather(gs[0].my_rank * 2))
    assert res == [[i * 2 for i in range(p)]] * p


@pytest.mark.parametrize("p", SIZES)
def test_all_reduce_noncommutative_concat(p):
    res = run_mpi_group(
        p, lambda gs: gs[0].all_reduce(str(gs[0].my_rank), operator.add))
    assert res == ["".join(map(str, range(p)))] * p


@pytest.mark.parametrize("p", [2, 3, 7])
def test_groups_are_independent_tag_namespaces(p):
    """Traffic on group 0 does not cross into group 1 (Thrill's flow and
    data groups over one MPI world)."""

    def job(gs):
        g0, g1 = gs[0], gs[1]
        r, peer = g0.my_rank, (g0.my_rank + 1) % g0.num_hosts
        g0.send_to(peer, ("g0", r))
        g1.send_to(peer, ("g1", r))
        frm = (r - 1) % g0.num_hosts
        m1 = g1.recv_from(frm)      # group 1 first
        m0 = g0.recv_from(frm)
        return m0, m1

    res = run_mpi_group(p, job)
    for r, (m0, m1) in enumerate(res):
        frm = (r - 1) % p
        assert m0 == ("g0", frm) and m1 == ("g1", frm)


@pytest.mark.parametrize("p", [2, 3])
def test_bulk_exchange_every_rank_sends_first(p):
    """About 600 KiB numpy frames in a ring where every rank issues all
    its sends before any receive, the host exchange's shape: under
    strict rendezvous only lazy Isend completion survives it."""
    n = 75_000

    def job(gs):
        g = gs[0]
        r = g.my_rank
        arr = np.arange(n, dtype=np.int64) + r * 1_000_000
        for d in range(1, p):
            g.send_to((r + d) % p, arr)
        got = {}
        for d in range(1, p):
            frm = (r - d) % p
            got[frm] = g.recv_from(frm)
        return {frm: int(a[0]) for frm, a in got.items()}

    res = run_mpi_group(p, job, timeout=60)
    for r, got in enumerate(res):
        assert got == {frm: frm * 1_000_000
                       for frm in range(p) if frm != r}


def test_send_returns_before_peer_receives():
    """send() returns while the peer has not posted its receive (lazy
    Isend completion), and the payload still arrives intact."""
    sent_event = threading.Event()

    def job(gs):
        g = gs[0]
        if g.my_rank == 0:
            g.send_to(1, np.arange(200_000, dtype=np.int64))
            sent_event.set()
            return True
        assert sent_event.wait(timeout=20), \
            "send() blocked until the matching recv posted"
        return int(g.recv_from(0)[-1])

    assert run_mpi_group(2, job, timeout=40) == [True, 199_999]


def test_flush_completes_pending_isends():
    """After the peer drains, flush() empties the engine's ledger."""

    def job(gs):
        g = gs[0]
        if g.my_rank == 0:
            g.send_to(1, b"x" * 100_000)
            g.flush()
            assert not g.engine.pending
            return "flushed"
        return len(g.recv_from(0))

    assert run_mpi_group(2, job, timeout=40) == ["flushed", 100_000]


def test_pending_isend_completes_while_sender_is_parked():
    """A rendezvous Isend completes even when its owning thread never
    calls the transport again (a rank parked in a device collective):
    the engine's progress thread answers the peer."""
    delivered = threading.Event()

    def job(gs):
        g = gs[0]
        if g.my_rank == 0:
            g.send_to(1, np.arange(100_000, dtype=np.int64))
            assert delivered.wait(timeout=_scaled(30)), \
                "the peer starved: the pending Isend never completed"
            return "parked"
        got = g.recv_from(0)
        delivered.set()
        return int(got[-1])

    assert run_mpi_group(2, job, timeout=60) == ["parked", 99_999]


def test_construct_without_mpi_raises_actionable():
    from thrill_tpu_torch.net import mpi as mpi_backend
    mpi_backend.MPI = None
    assert not mpi_backend.available()
    with pytest.raises(mpi_backend.MpiUnavailable, match="mpirun"):
        mpi_backend.construct()


def test_frames_are_the_reference_s():
    """An MPI frame is the wire codec's bytes, the same in both
    packages."""
    from thrill_tpu.net import wire as jwire

    from thrill_tpu_torch.net import wire
    msg = {3: {0: ["a", "bb"], 1: [(1, 2.5)]}, "n": np.arange(5)}
    assert wire.dumps(msg, allow_pickle=True) == \
        jwire.dumps(msg, allow_pickle=True)


# ---------------------------------------------------------------------
# real processes: the port child over the fake world
# ---------------------------------------------------------------------

_TEXT = "\n".join(f"line {i} word{i % 7} again word{i % 3}"
                  for i in range(97)) + "\n"


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


def word_job(text_path):
    def job(ctx):
        words = ctx.ReadLines(text_path).FlatMap(lambda line: line.split())
        counts = words.Map(lambda w: (w, 1)).ReducePair(
            lambda a, b: a + b).AllGather()
        total = int(ctx.Distribute(np.arange(1000, dtype=np.int64)).Sum())
        return {"counts": sorted([k, int(v)] for k, v in counts),
                "total": total, "hosts": ctx.net.num_workers,
                "group": type(ctx.net.group).__name__}
    return job


@pytest.mark.parametrize("nproc", [
    2, pytest.param(3, marks=pytest.mark.slow)])
def test_mpi_real_processes(nproc, tmp_path):
    """Each rank a real process running the port's backend over the
    fake world: the reference child's battery, then a RunDistributed
    job over ``THRILL_TPU_NET=mpi`` equal to one process's."""
    import thrill_tpu_torch as tt

    text = tmp_path / "words.txt"
    text.write_text(_TEXT)
    ports = _free_ports(nproc)
    coord = _free_ports(1)[0]
    env = dict(os.environ, THRILL_TPU_NET="mpi",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), str(nproc),
         ",".join(map(str, ports)), f"127.0.0.1:{coord}", str(text)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env) for rank in range(nproc)]
    import concurrent.futures as cf
    budget = _scaled(120)
    with cf.ThreadPoolExecutor(len(procs)) as ex:
        futs = [ex.submit(p.communicate, None, budget) for p in procs]
        try:
            drained = [f.result(timeout=budget + 20) for f in futs]
        except (cf.TimeoutError, subprocess.TimeoutExpired):
            for q in procs:
                q.kill()
            pytest.fail("MPI child process timed out (deadlock?)")
    results = []
    for p, (out, err) in zip(procs, drained):
        assert p.returncode == 0, f"child failed:\n{err[-3000:]}"
        lines = [l for l in out.splitlines() if l.startswith("RESULT ")]
        assert lines, f"no RESULT line:\n{out}\n{err[-2000:]}"
        results.append(json.loads(lines[-1][len("RESULT "):]))
    one = json.loads(json.dumps(tt.Run(word_job(str(text)), nproc,
                                       device="cpu")))
    for rank, res in enumerate(results):
        assert res["rank"] == rank
        assert res["prefix"] == sum(range(1, rank + 2))
        assert res["gathered"] == [i * 3 for i in range(nproc)]
        assert res["bulk"] == [frm * 7 for frm in range(nproc)
                               if frm != rank]
        assert res["bcast"] == 1234
        job = res["job"]
        assert job["group"] == "MpiGroup" and job["hosts"] == nproc
        assert job["counts"] == one["counts"]
        assert job["total"] == one["total"]


def _child(rank, nproc, ports, coordinator, text_path):
    import thrill_tpu_torch as tt
    from thrill_tpu_torch.net import mpi as mpi_backend

    fake_mpi = _fake_mpi()
    mpi_backend.MPI = fake_mpi.connect_world(rank, nproc, ports)
    groups = mpi_backend.construct(2)
    g0 = groups[0]
    assert g0.my_rank == rank and g0.num_hosts == nproc
    prefix = g0.prefix_sum(rank + 1)
    gathered = g0.all_gather(rank * 3)
    bcast = g0.broadcast(1234 if rank == 0 else None, origin=0)
    # every rank sends before it receives, on the data group
    g1 = groups[1]
    arr = np.arange(50_000, dtype=np.int64) + rank * 7
    for d in range(1, nproc):
        g1.send_to((rank + d) % nproc, arr)
    bulk = []
    for d in range(1, nproc):
        frm = (rank - d) % nproc
        got = g1.recv_from(frm)
        assert got.shape == (50_000,) and int(got[1]) == frm * 7 + 1
        bulk.append(int(got[0]))
    for g in groups:
        g.flush()
    g0.barrier()
    for g in groups:
        g.flush()
    # the host control plane of a mesh of processes over the same world
    job = tt.RunDistributed(word_job(text_path),
                            coordinator_address=coordinator,
                            num_processes=nproc, process_id=rank,
                            workers_per_process=1, device="cpu")
    print("RESULT " + json.dumps({
        "rank": rank, "prefix": int(prefix),
        "gathered": [int(x) for x in gathered],
        "bulk": sorted(bulk), "bcast": int(bcast), "job": job}),
        flush=True)


if __name__ == "__main__":
    _child(int(sys.argv[1]), int(sys.argv[2]),
           [int(p) for p in sys.argv[3].split(",")], sys.argv[4],
           sys.argv[5])
