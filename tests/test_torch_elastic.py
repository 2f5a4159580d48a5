"""The elastic mesh (the reference's ``tests/net/test_elastic.py``) on the
port: ``Group.resize`` and ``join_tcp_group`` grow and shrink real TCP
groups with a SIGKILL in the middle of a resize, the mock width sweep,
``Context.resize`` 4 -> 2 -> 4 -> 3 against fresh Contexts of both
packages, the chaos sweep over the resize sites and
``THRILL_TPU_RESIZE=0``.

Tolerance: exact. After each resize TeraSort and WordCount equal a fresh
W' Context's of both packages, PageRank's f64 ranks are bit-equal to a
fresh W' port Context's and within 1e-12 of the reference's (C15: a
page's sum associates differently in XLA). A kept result re-split to W'
has the counts, rows and zero padding of a fresh W' Distribute of its
items. On the return to W = 4 the plan and loop counters of the same
jobs equal the reference's in the same sequence. This file is also the
child of the TCP case: run as ``__main__`` it is one rank.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

from thrill_tpu_torch.common import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 420
PR_TOL = 1e-12
COUNTERS = ("cap_cache_hits", "cap_cache_misses", "plan_builds",
            "loop_plan_builds", "loop_replays")


@pytest.fixture(autouse=True, scope="module")
def _file_time_limit():
    """This file's own time limit: a test still running past it fails."""
    def expired(*_):
        raise TimeoutError(f"{__name__}: past its {LIMIT_S} s limit")
    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def _clean_registry(monkeypatch):
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    faults.REGISTRY.reset()
    yield
    faults.REGISTRY.reset()


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


# ----------------------------------------------------------------------
# the jobs, on either package
# ----------------------------------------------------------------------

def _examples(pkg):
    if pkg == "port":
        from thrill_tpu_torch.examples import page_rank, terasort, word_count
        return terasort, word_count, page_rank
    sys.path.insert(0, os.path.join(REPO, "examples"))
    import page_rank
    import terasort
    import word_count
    return terasort, word_count, page_rank


_REC = None


def _inputs():
    global _REC
    if _REC is None:
        from thrill_tpu_torch.examples import page_rank, terasort, word_count
        rng = np.random.default_rng(5)
        words = [f"w{v}" for v in rng.zipf(1.3, 3000) % 400]
        _REC = (terasort.generate_records(1500, seed=3),
                word_count.pack_words(words),
                page_rank.zipf_graph(200, 1200, seed=4))
    return _REC


def _word(t):
    """WordCount's key, a module function: the exchange's capacity plan
    is cached by the key function's identity, so a second run of the
    same pipeline at the same W hits it."""
    return t["w"]


def _jobs(ctx, pkg):
    ts, wc, pr = _examples(pkg)
    recs, packed, edges = _inputs()
    out = ts.terasort(ctx, recs).AllGather()
    sort = [bytes(np.asarray(r["key"])) + bytes(np.asarray(r["value"]))
            for r in out]
    api = ctx.__class__.__module__.split(".")[0]
    FieldReduce = __import__(api + ".api", fromlist=["FieldReduce"]) \
        .FieldReduce
    d = ctx.Distribute({"w": packed,
                        "c": np.ones(len(packed), dtype=np.int64)})
    counts = sorted((bytes(np.asarray(t["w"])), int(t["c"]))
                    for t in d.ReduceByKey(_word, FieldReduce(
                        {"w": "first", "c": "sum"})).AllGather())
    ranks = [float(v) for v in pr.page_rank(ctx, edges, 200, 3)]
    return {"sort": sort, "wc": counts, "pr": ranks}


def _port_ctx(W):
    import thrill_tpu_torch as tt
    return tt.Context(num_workers=W, device="cpu")


def _ref_ctx(W):
    import jax

    from thrill_tpu.api import Context as JContext
    from thrill_tpu.parallel.mesh import MeshExec as JMeshExec
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]))


def _fresh(W, pkg):
    ctx = _port_ctx(W) if pkg == "port" else _ref_ctx(W)
    try:
        return _jobs(ctx, pkg)
    finally:
        ctx.close()


def _same(got, want, exact_pr):
    assert got["sort"] == want["sort"]
    assert got["wc"] == want["wc"]
    if exact_pr:
        assert got["pr"] == want["pr"]
    else:
        assert len(got["pr"]) == len(want["pr"])
        assert max(abs(a - b) for a, b in zip(got["pr"], want["pr"])) \
            <= PR_TOL


def _counters(ctx):
    s = ctx.overall_stats()
    return {k: s[k] for k in COUNTERS}


def _sequence(ctx, pkg, kept):
    """4 -> 2 -> 4 -> 3 with the jobs after each step; returns each
    step's results, the counters the return to W = 4 moved, and the
    kept result's items after each step."""
    steps, items = {}, {}
    steps[4] = _jobs(ctx, pkg)
    for W in (2, 4, 3):
        ctx.resize(W)
        assert ctx.num_workers == W
        items[W] = sorted(int(x) for x in kept.AllGather())
        c0 = _counters(ctx)
        steps[W if W != 4 else "4b"] = _jobs(ctx, pkg)
        if W == 4:
            c1 = _counters(ctx)
            back = {k: c1[k] - c0[k] for k in COUNTERS}
    return steps, back, items


def test_context_resize_4_2_4_3_is_fresh_w_in_both_packages(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    vals = np.arange(300, dtype=np.int64)
    ctx = _port_ctx(4)
    try:
        kept = ctx.Distribute(vals).Map(lambda x: x * 7 + 1).Keep(8)
        kept.Execute()
        steps, back, items = _sequence(ctx, "port", kept)
        stats = ctx.overall_stats()
        assert stats["resizes"] == 3 and stats["resize_time_s"] > 0
        # the kept result's layout is a fresh W' Distribute's, with
        # zeros past the counts (C4: the reference's buffers hold zeros)
        shards = kept.node._shards
        fresh = _port_ctx(3)
        try:
            want = fresh.Distribute(vals).Execute().node._shards
            assert shards.counts.tolist() == want.counts.tolist()
            assert shards.cap == want.cap
            assert shards.tree.tolist() == \
                want.zero_beyond_count().tree.tolist()
        finally:
            fresh.close()
    finally:
        ctx.close()
    rctx = _ref_ctx(4)
    try:
        rkept = rctx.Distribute(vals).Map(lambda x: x * 7 + 1)
        rkept.Keep(8)
        rkept.Execute()
        rsteps, rback, ritems = _sequence(rctx, "ref", rkept)
    finally:
        rctx.close()
    assert items == ritems
    assert all(v == sorted(int(x) * 7 + 1 for x in vals)
               for v in items.values())
    for key, W in ((4, 4), (2, 2), ("4b", 4), (3, 3)):
        _same(steps[key], _fresh(W, "port"), exact_pr=True)
        _same(steps[key], rsteps[key], exact_pr=False)
    # the return to W = 4 is warm as the reference's: the same hits,
    # misses and builds of plans and loops
    assert back == rback, (back, rback)
    assert back["cap_cache_hits"] > 0


def test_a_resize_of_host_storage_is_the_reference_s():
    items = [f"s{i}" for i in range(50)]
    ctx = _port_ctx(4)
    rctx = _ref_ctx(4)
    try:
        d = ctx.Distribute(items, storage="host").Keep(4)
        d.Execute()
        rd = rctx.Distribute(items, storage="host")
        rd.Keep(4)
        rd.Execute()
        for W in (3, 2):
            ctx.resize(W)
            rctx.resize(W)
            assert d.node._shards.lists == rd.node._shards.lists
    finally:
        ctx.close()
        rctx.close()


def test_mid_resize_fault_changes_nothing_and_the_retry_moves():
    ctx = _port_ctx(2)
    try:
        d = ctx.Distribute(np.arange(48, dtype=np.int64)).Map(
            lambda x: x * 7 + 1).Keep(4)
        want = sorted(int(x) for x in d.AllGather())
        gen0, w0 = ctx.generation, ctx.num_workers
        with faults.inject("ckpt.repartition", n=1, seed=7):
            with pytest.raises(IOError):
                ctx.resize(3)
        assert ctx.num_workers == w0 == ctx.mesh_exec.num_workers
        assert ctx.generation == gen0
        assert sorted(int(x) for x in d.AllGather()) == want
        ctx.resize(3)
        assert ctx.num_workers == 3
        assert sorted(int(x) for x in d.AllGather()) == want
        assert ctx.overall_stats()["resizes"] == 1
    finally:
        ctx.close()


def test_resize_disabled_is_loud(monkeypatch):
    from thrill_tpu_torch.net.mock import MockNetwork
    monkeypatch.setenv("THRILL_TPU_RESIZE", "0")
    ctx = _port_ctx(2)
    try:
        with pytest.raises(RuntimeError, match="THRILL_TPU_RESIZE"):
            ctx.resize(3)
        assert ctx.num_workers == 2
    finally:
        ctx.close()
    with pytest.raises(RuntimeError, match="THRILL_TPU_RESIZE"):
        MockNetwork.construct(2)[0].resize(3, 1)


# ----------------------------------------------------------------------
# the mock transport: the width sweep on threads
# ----------------------------------------------------------------------

def _run_phase(jobs):
    """One lockstep phase: ``jobs[rank]()`` on a thread per rank."""
    results, errors = {}, {}

    def target(r, fn):
        try:
            results[r] = fn()
        except Exception as e:
            errors[r] = e

    threads = [threading.Thread(target=target, args=(r, fn), daemon=True)
               for r, fn in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for e in errors.values():
        raise e
    assert len(results) == len(jobs), "resize phase deadlocked"
    return results


def _sweep_mock_path(path):
    from thrill_tpu_torch.net.mock import MockNetwork
    net = MockNetwork(path[0])
    groups = {r: net.group(r) for r in range(path[0])}
    gen = 1
    _run_phase({r: (lambda g=g: g.begin_generation(1))
                for r, g in groups.items()})
    for w_new in path[1:]:
        w_old = len(groups)
        gen += 1
        if w_new > w_old:
            joiners = dict(zip(range(w_old, w_new),
                               net.grow(w_new, from_hosts=w_old)))
            jobs = {r: (lambda g=g: g.resize(w_new, gen))
                    for r, g in groups.items()}
            jobs.update({r: (lambda g=g: g.begin_generation(gen))
                         for r, g in joiners.items()})
            _run_phase(jobs)
            groups.update(joiners)
        else:
            _run_phase({r: (lambda g=g: g.resize(w_new, gen))
                        for r, g in groups.items()})
            groups = {r: g for r, g in groups.items() if r < w_new}
        sums = _run_phase({r: (lambda g=g: g.all_reduce(
            g.my_rank + 1, lambda a, b: a + b)) for r, g in groups.items()})
        assert set(sums.values()) == {w_new * (w_new + 1) // 2}, path
        gathers = _run_phase({r: (lambda g=g: g.all_gather(g.my_rank))
                              for r, g in groups.items()})
        assert set(map(tuple, gathers.values())) == {tuple(range(w_new))}


@pytest.mark.parametrize("path", [
    (2, 3, 2),
    pytest.param((1, 3, 1), marks=pytest.mark.slow),
    pytest.param((2, 4, 3, 2), marks=pytest.mark.slow),
    pytest.param((3, 5, 2, 4, 1), marks=pytest.mark.slow)])
def test_mock_resize_width_sweep(path):
    _sweep_mock_path(path)


N_RESIZE_SEEDS = int(os.environ.get("THRILL_TPU_CHAOS_SEEDS", "2"))


@pytest.mark.chaos
@pytest.mark.parametrize("seed", range(N_RESIZE_SEEDS))
def test_chaos_resize_sites_recover_exactly(seed, monkeypatch):
    """Seeded fires at both resize sites land before anything changed,
    so a bounded retry reaches the resized state with the same data:
    ``ckpt.repartition`` under ``Context.resize``, and
    ``net.group.resize_handshake`` on a lockstep mock group."""
    import random
    rng = random.Random(9000 + seed)
    n_ck, n_net = rng.randint(1, 2), rng.randint(1, 2)
    monkeypatch.setenv(faults.ENV_VAR,
                       f"ckpt.repartition:n={n_ck}:seed={seed};"
                       f"net.group.resize_handshake:n={n_net}:seed={seed}")
    ctx = _port_ctx(2)
    try:
        d = ctx.Distribute(np.arange(40, dtype=np.int64)).Map(
            lambda x: x * 5 + seed).Keep(8)
        want = sorted(int(x) for x in d.AllGather())
        w = 2
        for target in (3, 2):
            for _ in range(4):
                try:
                    ctx.resize(target)
                    break
                except faults.InjectedFault:
                    assert ctx.num_workers == w
            w = target
            assert ctx.num_workers == w
            assert sorted(int(x) for x in d.AllGather()) == want
    finally:
        ctx.close()

    from thrill_tpu_torch.net.mock import MockNetwork
    net = MockNetwork(2)
    groups = {r: net.group(r) for r in range(2)}

    def _retrying(fn):
        def run():
            for _ in range(6):
                try:
                    return fn()
                except faults.InjectedFault:
                    continue
            raise AssertionError("fire budget outlived the retries")
        return run

    _run_phase({r: (lambda g=g: g.begin_generation(1))
                for r, g in groups.items()})
    joiners = dict(zip([2], net.grow(3, from_hosts=2)))
    jobs = {r: _retrying(lambda g=g: g.resize(3, 2))
            for r, g in groups.items()}
    jobs.update({r: (lambda g=g: g.begin_generation(2))
                 for r, g in joiners.items()})
    _run_phase(jobs)
    groups.update(joiners)
    sums = _run_phase({r: (lambda g=g: g.all_reduce(
        g.my_rank + 1, lambda a, b: a + b)) for r, g in groups.items()})
    assert set(sums.values()) == {6}
    _run_phase({r: _retrying(lambda g=g: g.resize(2, 3))
                for r, g in groups.items()})
    groups = {r: g for r, g in groups.items() if r < 2}
    sums = _run_phase({r: (lambda g=g: g.all_reduce(
        g.my_rank + 1, lambda a, b: a + b)) for r, g in groups.items()})
    assert set(sums.values()) == {3}
    assert faults.REGISTRY.injected >= 1


# ----------------------------------------------------------------------
# real processes: a SIGKILL in the middle of a resize, heal, retry
# ----------------------------------------------------------------------

SECRET = b"elastic-test-secret"


def test_rank_join_and_leave_on_real_tcp_with_sigkill_mid_resize(tmp_path):
    """Two members admit a joiner that SIGKILLs itself after the
    authenticated handshake, before the commit barrier: the members
    roll the membership back and settle the generation; the next resize
    admits a replacement joiner (collectives exact at W = 3); the
    graceful shrink drains the departing rank."""
    from thrill_tpu_torch.common.timeouts import scaled

    def run(flags):
        os.makedirs(flags, exist_ok=True)
        hostlist = " ".join(f"127.0.0.1:{p}" for p in _free_ports(4))
        procs = []
        for rank in range(4):
            env = dict(os.environ, THRILL_TPU_ELASTIC_HOSTS=hostlist,
                       THRILL_TPU_ELASTIC_FLAGS=flags,
                       THRILL_TPU_HEAL_TIMEOUT_S="6",
                       THRILL_TPU_RESIZE_TIMEOUT_S="60",
                       PYTHONPATH=REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(rank)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env))
        try:
            outs = [p.communicate(timeout=scaled(150)) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        res = {}
        for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
            if rank == 2:
                assert p.returncode == -9, err[-2000:]
                continue
            assert p.returncode == 0, f"rank {rank}:\n{err[-3000:]}"
            line = [l for l in out.splitlines() if l.startswith("RESULT ")]
            res[rank] = json.loads(line[-1][len("RESULT "):])
        return res

    try:
        res = run(str(tmp_path / "f1"))
    except (AssertionError, subprocess.TimeoutExpired) as e:
        print(f"first attempt failed; retrying once:\n{e}", flush=True)
        res = run(str(tmp_path / "f2"))
    m0, m1, r3 = res[0], res[1], res[3]
    for m in (m0, m1):
        assert m["doomed"] != "NO-ERROR"
        assert m["healed_w"] == 2 and m["healed_gen"] == 2
        assert m["sum_w2"] == m["sum_after_rollback"] == 3
        assert m["grown_w"] == 3 and m["grown_gen"] == 3
        assert m["sum_w3"] == 6 and m["gather_w3"] == [0, 10, 20]
        assert m["shrunk_w"] == 2 and m["sum_w2_again"] == 3
    assert m0 == {**m1, "rank": 0}
    assert r3["sum_w3"] == 6 and r3["gather_w3"] == [0, 10, 20]
    assert r3["grown_gen"] == 3


def _touch(flags, name):
    with open(os.path.join(flags, name), "w") as f:
        f.write("1")


def _await(flags, names, timeout_s=120.0):
    import time
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if all(os.path.exists(os.path.join(flags, n)) for n in names):
            return
        time.sleep(0.05)
    raise TimeoutError(f"flags {names} never appeared in {flags}")


def _member(rank, hosts, flags):
    from thrill_tpu_torch.net.tcp import construct_tcp_group
    out = {"rank": rank}
    g = construct_tcp_group(rank, hosts[:2], timeout=120, secret=SECRET)
    g.begin_generation(1)
    out["sum_w2"] = g.all_reduce(g.my_rank + 1, lambda a, b: a + b)
    _touch(flags, f"m{rank}.w2")
    try:
        g.resize(3, 2)
        out["doomed"] = "NO-ERROR"
    except Exception as e:
        out["doomed"] = type(e).__name__
    out["healed_w"] = g.num_hosts
    out["healed_gen"] = g.generation
    out["sum_after_rollback"] = g.all_reduce(g.my_rank + 1,
                                             lambda a, b: a + b)
    _touch(flags, f"m{rank}.healed")
    g.resize(3, 3)
    out["grown_w"] = g.num_hosts
    out["grown_gen"] = g.generation
    out["sum_w3"] = g.all_reduce(g.my_rank + 1, lambda a, b: a + b)
    out["gather_w3"] = g.all_gather(g.my_rank * 10)
    g.resize(2, 4)
    out["shrunk_w"] = g.num_hosts
    out["sum_w2_again"] = g.all_reduce(g.my_rank + 1, lambda a, b: a + b)
    g.close()
    return out


def _doomed_joiner(hosts, flags):
    from thrill_tpu_torch.net.tcp import join_tcp_group
    _await(flags, ["m0.w2", "m1.w2"])
    join_tcp_group(2, hosts[:3], generation=2, timeout=120, secret=SECRET)
    os.kill(os.getpid(), signal.SIGKILL)


def _replacement_joiner(hosts, flags):
    from thrill_tpu_torch.net.tcp import join_tcp_group
    _await(flags, ["m0.healed", "m1.healed"])
    g = join_tcp_group(2, [hosts[0], hosts[1], hosts[3]], generation=3,
                       timeout=120, secret=SECRET)
    g.begin_generation(3)
    out = {"rank": 3, "grown_gen": g.generation,
           "sum_w3": g.all_reduce(g.my_rank + 1, lambda a, b: a + b),
           "gather_w3": g.all_gather(g.my_rank * 10)}
    g.resize(2, 4)
    g.close()
    return out


def _child(rank):
    from thrill_tpu_torch.net.tcp import parse_hostlist
    hosts = parse_hostlist(os.environ["THRILL_TPU_ELASTIC_HOSTS"])
    flags = os.environ["THRILL_TPU_ELASTIC_FLAGS"]
    if rank in (0, 1):
        out = _member(rank, hosts, flags)
    elif rank == 2:
        _doomed_joiner(hosts, flags)
        return
    else:
        out = _replacement_joiner(hosts, flags)
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    _child(int(sys.argv[1]))
