"""The service plane on a mesh of two real processes (gloo on the CPU),
the counterpart of the reference's ``tests/net/service_child.py`` and
``tests/net/test_distributed.py:265``.

* Lockstep: both processes submit the same jobs in the same per-tenant
  order from their main threads (three device WordCounts and a failing
  job); rank 0's dispatcher fixes the order and the other process runs
  the job it announces. Every result equals the port's one-process
  W = 4 run and the reference's; the failing job's future raises a
  ``PipelineError`` with its root cause in both processes, and the jobs
  after it run. ``overall_stats`` runs no collective once a Context has
  served (a gather would race the follower's wait for ordering frames).
* An order that differs between the processes fails loudly: the
  follower's dispatcher raises "cross-rank admission divergence" into
  the job's future and poisons its scheduler.
* The plan store: rank 0 alone reads it and broadcasts the entries;
  both processes record ``store_broadcast``, install the same number of
  seeds with the attestation (``_plan_seed_symmetric``), and a warm
  launch builds no plan for its first served job; rank 0 alone writes
  the store at close.
* ``resize_processes`` of a serving mesh under ``run-scripts/
  supervise.sh -w 2``: the drain (``_quiesce_service``) closes the
  schedulers collectively before the move seals, 2 -> 3 processes, and
  the relaunch serves again with the kept result restored.

This file is also the child: run as ``__main__`` it is one process.

Tolerance: exact.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUPERVISE = os.path.join(REPO, "run-scripts", "supervise.sh")
LIMIT_S = 300
N = 96


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


# -- the jobs (module level: both processes and the parent run them) ---------

def _wordcount(mod):
    def fn(ctx):
        vals = np.arange(400, dtype=np.int64)
        hist = ctx.Distribute(vals).Map(lambda x: (x % mod, 1)) \
            .ReducePair(lambda a, b: a + b)
        return sorted([int(k), int(v)] for k, v in hist.AllGather())
    fn.__name__ = f"wordcount_{mod}"
    return fn


def _const(value):
    def fn(ctx):
        return value
    return fn


def _boom(ctx):
    ctx.Distribute(np.arange(8, dtype=np.int64)).Sum()
    raise RuntimeError("boom: injected job failure")


def _kv(x):
    return (x % 11, x)


def _add(a, b):
    return a + b


def _store_job(ctx):
    mex = ctx.mesh_exec
    b0 = mex.stats_plan_builds
    pairs = sorted([int(k), int(v)] for k, v in ctx.Distribute(
        np.arange(128, dtype=np.int64)).Map(_kv).ReducePair(_add).AllGather())
    return {"pairs": pairs, "plan_builds": mex.stats_plan_builds - b0}


LOCKSTEP = (("a1", "alpha", 5), ("b1", "beta", 7), ("bad", "alpha", None),
            ("a2", "alpha", 3))


def _lockstep(ctx, order):
    futs = {}
    for name, tenant, mod in order:
        fn = (_boom if mod is None else _const(mod) if isinstance(mod, str)
              else _wordcount(mod))
        futs[name] = ctx.submit(fn, tenant=tenant, name=name)
    from thrill_tpu_torch.common.timeouts import scaled
    out = {}
    for name, _, mod in order:
        err = futs[name].exception(timeout=scaled(120))
        if err is None:
            out[name] = futs[name].result()
        else:
            out[name] = [type(err).__name__, str(err)[:200],
                         type(getattr(err, "root", None)).__name__,
                         futs[name].generation is not None]
    return out


# -- the child --------------------------------------------------------------

def _child():
    import thrill_tpu_torch as tt
    rank = int(os.environ["THRILL_TPU_RANK"])
    nproc = int(os.environ["THRILL_TPU_NPROC"])
    mode = os.environ["TEST_MODE"]
    out_dir = os.environ["TEST_OUT"]
    phase = int(os.environ.get("THRILL_TPU_SUPERVISE_ROUND", "0"))
    ports = os.environ["TEST_PORTS"].split()[4 * phase:4 * phase + 4]
    os.environ["THRILL_TPU_HOSTLIST"] = " ".join(
        f"127.0.0.1:{p}" for p in ports[1:1 + nproc])
    w = int(os.environ.get("THRILL_TPU_RESIZE_W", str(2 * nproc)))
    resumed = os.environ.get("THRILL_TPU_RESUME") == "1"

    def job(ctx):
        res = {"rank": rank, "phase": phase, "procs": nproc,
               "w": ctx.num_workers}
        if mode == "lockstep":
            gathers = []
            real = ctx.net.all_gather
            ctx.net.all_gather = lambda v: (gathers.append(1), real(v))[1]
            res["results"] = _lockstep(ctx, LOCKSTEP)
            st = ctx.overall_stats()
            ctx.net.all_gather = real
            res["stats"] = [st["jobs_submitted"], st["jobs_failed"],
                            st["pipeline_aborts"], "hosts" in st]
            res["gathers"] = len(gathers)
        elif mode == "diverge":
            # host-only jobs: rank 0 runs its order without the other
            # process, which refuses the slot
            order = [("x1", "alpha", "x1"), ("x2", "alpha", "x2")]
            if rank == 1:
                order = order[::-1]
            res["results"] = _lockstep(ctx, order)
            res["alive"] = ctx.service.alive
        elif mode == "store":
            res["first"] = ctx.submit(_store_job, name="store").result(120)
            recs = [r for r in ctx.decisions.records
                    if r.kind in ("store_broadcast", "store_skip")]
            res["records"] = [[r.kind, r.chosen, r.inputs.get("entries")]
                              for r in recs]
            res["symmetric"] = bool(ctx.mesh_exec._plan_seed_symmetric)
            res["holds_store"] = ctx.plan_store is not None
        elif mode == "resize":
            d = ctx.Distribute(np.arange(N, dtype=np.int64)) \
                .Map(lambda x: x * 3 + 1).Checkpoint("stage").Keep(4)
            d.Execute()
            res["resumed"] = resumed
            res["kept"] = sorted(int(x) for x in d.AllGather())
            res["served"] = ctx.submit(_wordcount(5), tenant="t",
                                       name=f"r{phase}").result(120)
            with open(os.path.join(out_dir, f"phase-{phase}-{rank}.json"),
                      "w") as f:
                json.dump(res, f)
            if phase == 0:
                ctx.resize_processes(3, state=d)       # exits 75
            return res
        with open(os.path.join(out_dir, f"result-{rank}.json"), "w") as f:
            json.dump(res, f)
        return res

    tt.RunDistributed(job, coordinator_address=f"127.0.0.1:{ports[0]}",
                      num_processes=nproc, process_id=rank,
                      workers_per_process=max(1, w // nproc), device="cpu",
                      resume=resumed)


# -- the parent -----------------------------------------------------------------

def _free_ports(n):
    import socket
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _env(tmp_path, mode, extra=None):
    env = dict(os.environ)
    for k in ("THRILL_TPU_RESUME", "THRILL_TPU_RESIZE_W", "THRILL_TPU_FAULTS",
              "THRILL_TPU_PLAN_STORE", "THRILL_TPU_SERVE_PORT",
              "THRILL_TPU_AUTOSCALE_S", "THRILL_TPU_LOG"):
        env.pop(k, None)
    env.update({"PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
                "TEST_MODE": mode, "TEST_OUT": str(tmp_path),
                "THRILL_TPU_SECRET": "test-cluster-secret",
                "THRILL_TPU_HANG_TIMEOUT_S": "30",
                "THRILL_TPU_HOST_RADIX": "0"})
    env.update(extra or {})
    return env


def _pair(tmp_path, mode, extra=None):
    """Two processes of two workers each: their result files."""
    from thrill_tpu_torch.common.timeouts import scaled
    env0 = _env(tmp_path, mode, extra)
    env0["TEST_PORTS"] = " ".join(map(str, _free_ports(4)))
    procs = []
    for rank in range(2):
        env = dict(env0, THRILL_TPU_RANK=str(rank), THRILL_TPU_NPROC="2")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=scaled(150)) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = []
    for rank, (p, (o, e)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}: {o[-2000:]}\n{e[-3000:]}"
        with open(os.path.join(str(tmp_path), f"result-{rank}.json")) as f:
            res.append(json.load(f))
    return res


def _one_process(side):
    """The lockstep jobs serially, one process at W = 4."""
    if side == "t":
        import thrill_tpu_torch as tt
        ctx = tt.Context(num_workers=4, device="cpu")
    else:
        from thrill_tpu.api import Context as JContext
        from thrill_tpu.parallel.mesh import MeshExec as JMeshExec
        ctx = JContext(JMeshExec(num_workers=4))
    try:
        return {name: _wordcount(mod)(ctx) for name, _, mod in LOCKSTEP
                if mod is not None}
    finally:
        ctx.close()


def test_lockstep_submits_with_a_failing_job_equal_one_process(
        tmp_path, monkeypatch):
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    res = _pair(tmp_path, "lockstep")
    one, ref = _one_process("t"), _one_process("j")
    assert one == ref
    for r in res:
        for name, want in one.items():
            assert r["results"][name] == want, (r["rank"], name)
        kind, text, root, has_gen = r["results"]["bad"]
        assert kind == "PipelineError" and root == "RuntimeError"
        assert "boom: injected job failure" in text and has_gen
        # served: the stats stay this process's own, gathered by no one
        assert r["stats"] == [4, 1, 1, False] and r["gathers"] == 0
        assert r["w"] == 4


def test_an_order_that_differs_between_processes_fails_loudly(tmp_path):
    res = _pair(tmp_path, "diverge")
    r0, r1 = res
    # rank 0 ran its order; the follower's dispatcher refused the slot
    assert (r0["results"]["x1"], r0["results"]["x2"]) == ("x1", "x2")
    kind, text, _, _ = r1["results"]["x2"]
    assert kind == "RuntimeError"
    assert text.startswith("cross-rank admission divergence: rank 0 "
                           "announced (alpha, 1) = 'x1', this rank holds "
                           "'x2'")
    assert r1["results"]["x1"][1].startswith(
        "job never ran: scheduler died after an unrecoverable abort")
    assert not r1["alive"]


def test_the_plan_store_is_read_by_rank_0_and_broadcast(tmp_path):
    store = str(tmp_path / "plans")
    cold = _pair(tmp_path, "store", {"THRILL_TPU_PLAN_STORE": store})
    assert os.path.exists(os.path.join(store, "plans.json"))
    warm = _pair(tmp_path, "store", {"THRILL_TPU_PLAN_STORE": store})
    for launch, chosen in ((cold, "cold"), (warm, "warm-start")):
        entries = {r["records"][0][2] for r in launch}
        assert len(entries) == 1             # the same seeds everywhere
        for r in launch:
            assert r["records"] == [["store_broadcast", chosen,
                                     r["records"][0][2]]]
            assert r["symmetric"]
            assert r["holds_store"] == (r["rank"] == 0)
    assert cold[0]["records"][0][2] == 0 and warm[0]["records"][0][2] > 0
    assert cold[0]["first"]["plan_builds"] >= 1
    for r in warm:
        assert r["first"]["plan_builds"] == 0, r
        assert r["first"]["pairs"] == cold[0]["first"]["pairs"]


def test_resize_processes_of_a_serving_mesh_under_supervise(tmp_path):
    from thrill_tpu_torch.common.timeouts import scaled
    env = _env(tmp_path, "resize", {
        "THRILL_TPU_CKPT_DIR": str(tmp_path / "ck"),
        "TEST_PORTS": " ".join(map(str, _free_ports(8))),
        "THRILL_TPU_RESIZE_W": "2"})
    p = subprocess.run(["bash", SUPERVISE, "-n", "1", "-w", "2", "--",
                        sys.executable, os.path.abspath(__file__)],
                       env=env, capture_output=True, text=True,
                       timeout=scaled(240))
    assert p.returncode == 0, f"{p.stdout[-2000:]}\n{p.stderr[-3000:]}"
    phases = []
    for name in sorted(os.listdir(str(tmp_path))):
        if name.startswith("phase-"):
            with open(os.path.join(str(tmp_path), name)) as f:
                phases.append(json.load(f))
    phases.sort(key=lambda ph: (ph["phase"], ph["rank"]))
    assert [(ph["phase"], ph["rank"], ph["procs"], ph["w"])
            for ph in phases] == [(0, 0, 2, 2), (0, 1, 2, 2), (1, 0, 3, 3),
                                  (1, 1, 3, 3), (1, 2, 3, 3)], phases
    want = sorted(i * 3 + 1 for i in range(N))
    import thrill_tpu_torch as tt
    served = tt.Run(_wordcount(5), 4, device="cpu")
    for ph in phases:
        assert ph["kept"] == want
        assert ph["resumed"] == (ph["phase"] == 1)
        assert ph["served"] == served
    assert "relaunching at W=3 (procs=3" in p.stderr


if __name__ == "__main__":
    _child()
