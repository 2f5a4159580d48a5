"""Checkpoints across two real processes on the CPU (the reference's
``tests/net/test_checkpoint_resume.py`` and its child
``tests/net/checkpoint_child.py``, on the port).

Two processes, each a port controller with 2 workers (W = 4), gloo for
the device plane and the authenticated TCP group for the host plane,
share one checkpoint directory. This file is also the child: run as
``__main__`` it is one process of the mesh.

* The host-storage PageRank of the reference's child, one
  ``Checkpoint()`` an iteration; process 1 SIGKILLs itself entering
  epoch 3's save. The survivor ends non-zero within a bound (the host
  group's watchdog, ``THRILL_TPU_HANG_TIMEOUT_S``, far under gloo's
  300 s), exactly epochs 0-2 are committed, and a relaunch with resume
  ends bit-identical to an uninterrupted run with
  ``resume_skipped_ops`` >= 1.
* The same with a device PageRank (``Iterate(checkpoint_every=1)``) and
  a device TeraSort kept past ``Checkpoint()``: killed in the second
  loop epoch's save, resumed from the first; a second resume restores
  the Sort's epoch.
* An epoch written by two processes is byte-equal to one process's at
  W = 4 (a device epoch's files and manifest; a host epoch's files, its
  manifest's counts a list as the reference's across processes), and a
  uint64 and an int16 column come back from it with the reference's
  values.
* The resume epoch when one process cannot see the newest epoch's
  manifest: both resume from the epoch before it.
* A restore that fails on one process only (a CRC mismatch in a file
  only process 1 reads, or ``ckpt.read`` failing there): both compute
  the node, ``ckpt.restore_abandoned`` noted on process 0.
* A survivor waiting in a gloo collective (the Sort's all-to-all) when
  its peer is SIGKILLed ends within the same bound.
* An external Sort's run stores (``_h<rank>``) reused by both processes
  after process 1 was killed mid-sort.

Tolerance: exact (floats compared by ``repr``).
"""

import hashlib
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 420
HANG_S = 10                    # THRILL_TPU_HANG_TIMEOUT_S of the children
SURVIVOR_BOUND_S = 3 * HANG_S  # the survivor's exit after its peer's kill
N = 24                         # host PageRank pages
K = 5                          # its iterations (one epoch each)
PAGES = 64                     # device PageRank pages
EDGES = 512
DEV_ITERS = 4
SORT_N = 1 << 10
EM_N = 1200                    # external Sort items (runs of 100)


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


# ----------------------------------------------------------------------
# the jobs (a job of tt.Run or tt.RunDistributed)
# ----------------------------------------------------------------------

def host_pagerank(ctx):
    """The reference child's PageRank: host storage, page i links to
    (7i+1)%N and (3i+2)%N, one Checkpoint() an iteration."""
    ranks = ctx.Distribute([(i, 1.0 / N) for i in range(N)], storage="host")
    for it in range(K):
        ranks.Keep()
        c1 = ranks.Map(lambda t: ((t[0] * 7 + 1) % N, t[1] / 2))
        c2 = ranks.Map(lambda t: ((t[0] * 3 + 2) % N, t[1] / 2))
        summed = c1.Concat(c2).ReduceToIndex(
            lambda t: t[0], lambda a, b: (a[0], a[1] + b[1]), size=N,
            neutral=(0, 0.0))
        ranks = summed.Map(lambda t: (t[0], 0.15 / N + 0.85 * t[1])) \
            .Checkpoint(f"pr{it}")
    out = sorted(ranks.AllGather())
    return {"ranks": [[int(p), repr(float(r))] for p, r in out],
            **_stats(ctx)}


def _stats(ctx):
    s = ctx.overall_stats()
    mgr = ctx.checkpoint
    return {"epochs": s.get("checkpoint_epochs", 0),
            "resume_skipped_ops": s.get("resume_skipped_ops", 0),
            "resume_skipped_runs": s.get("resume_skipped_runs", 0),
            "resume_epoch": mgr.resume_epoch if mgr is not None else None,
            "hosts": s.get("hosts", 1)}


def graph():
    rng = np.random.default_rng(22)
    return np.stack([rng.integers(0, PAGES, EDGES),
                     rng.integers(0, PAGES, EDGES)], axis=1).astype(np.int64)


def sort_records():
    rng = np.random.default_rng(23)
    return {"key": rng.integers(0, 256, (SORT_N, 10), dtype=np.uint8),
            "val": np.arange(SORT_N, dtype=np.int64)}


def _digest(tree) -> str:
    h = hashlib.sha256()
    for k in sorted(tree):
        h.update(np.ascontiguousarray(tree[k]).tobytes())
    return h.hexdigest()


def device_pagerank_sort(ctx):
    """The port's PageRank example with ``Iterate(checkpoint_every=1)``
    (an epoch after each iteration but the last), then a TeraSort kept
    past ``Checkpoint()``."""
    from thrill_tpu_torch.examples import page_rank as tpr
    real = tpr.Iterate

    def iterate(ctx_, body, carry, n, **kw):
        return real(ctx_, body, carry, n, checkpoint_every=1, **kw)

    tpr.Iterate = iterate
    try:
        ranks = tpr.page_rank(ctx, graph(), PAGES, DEV_ITERS)
    finally:
        tpr.Iterate = real
    srt = ctx.Distribute(sort_records()).Sort(
        key_fn=lambda r: r["key"]).Checkpoint("sort").Keep()
    out = {k: v.cpu().numpy() for k, v in srt.AllGatherArrays().items()}
    return {"ranks": [repr(float(r)) for r in ranks],
            "sort": _digest(out), **_stats(ctx)}


def columns():
    rng = np.random.default_rng(24)
    return {"u": rng.integers(0, 2 ** 64 - 1, 203, dtype=np.uint64),
            "s": rng.integers(-2 ** 15, 2 ** 15 - 1, 203, dtype=np.int16),
            "k": np.arange(203, dtype=np.int64)}


def epochs_job(ctx):
    """A host epoch (0), then a device epoch of uint64, int16 and int64
    columns (1); its columns in worker order."""
    words = ctx.Distribute([f"w{i % 13}-{i}" for i in range(90)],
                           storage="host").Checkpoint("words").Keep()
    n_words = int(words.Size())
    cols = ctx.Distribute(columns()).Map(
        lambda t: {"u": t["u"], "s": t["s"], "k": t["k"] * 3}) \
        .Checkpoint("cols").Keep()
    got = {k: v.cpu().numpy() for k, v in cols.AllGatherArrays().items()}
    return {"words": n_words, "u": [str(int(x)) for x in got["u"]],
            "s": got["s"].tolist(), "k": got["k"].tolist(), **_stats(ctx)}


def three_epochs(ctx):
    """Three device epochs in a chain; the result and stats."""
    d = ctx.Distribute(np.arange(401, dtype=np.int64))
    for i in range(3):
        d = d.Map(lambda x, i=i: x * 3 + i).Checkpoint(f"c{i}")
    out = sorted(int(x) for x in d.AllGather())
    return {"sum": sum(out), "n": len(out), **_stats(ctx)}


def em_items():
    return [(f"k{(i * 7919) % EM_N:05d}", float(i)) for i in range(EM_N)]


def em_sort(ctx):
    out = ctx.Distribute(em_items(), storage="host").Sort(
        key_fn=lambda t: t[0]).AllGather()
    return {"out": [[k, repr(v)] for k, v in out], **_stats(ctx)}


def exchange_sort(ctx):
    out = ctx.Distribute(sort_records()).Sort(
        key_fn=lambda r: r["key"]).AllGatherArrays()
    return {"sort": _digest({k: v.cpu().numpy() for k, v in out.items()})}


JOBS = {"hostpr": host_pagerank, "devpr": device_pagerank_sort,
        "epochs": epochs_job, "three": three_epochs, "em": em_sort,
        "xsort": exchange_sort}


# ----------------------------------------------------------------------
# launching two processes
# ----------------------------------------------------------------------

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


def _launch(job, ck, extra_env=None, rank_env=None):
    ports = _free_ports(3)
    hostlist = " ".join(f"127.0.0.1:{p}" for p in ports[1:])
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        for k in ("THRILL_TPU_RESUME", "THRILL_TPU_FAULTS"):
            env.pop(k, None)
        env.update({"THRILL_TPU_HOSTLIST": hostlist,
                    "THRILL_TPU_RANK": str(rank),
                    "THRILL_TPU_SECRET": "test-cluster-secret",
                    "THRILL_TPU_CKPT_DIR": ck,
                    "THRILL_TPU_HANG_TIMEOUT_S": str(HANG_S),
                    "PYTHONPATH": REPO + os.pathsep
                    + os.environ.get("PYTHONPATH", "")})
        env.update(extra_env or {})
        env.update((rank_env or {}).get(rank, {}))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             f"127.0.0.1:{ports[0]}", str(rank), job],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
    return procs


def _drain(procs, timeout_s=150, expect_ok=True):
    import concurrent.futures as cf

    from thrill_tpu_torch.common.timeouts import scaled
    timeout_s = scaled(timeout_s)
    t0 = time.monotonic()
    with cf.ThreadPoolExecutor(len(procs)) as ex:
        def wait(p):
            out, err = p.communicate(timeout=timeout_s)
            return out, err, time.monotonic() - t0
        futs = [ex.submit(wait, p) for p in procs]
        try:
            drained = [f.result(timeout=timeout_s + 20) for f in futs]
        except (cf.TimeoutError, subprocess.TimeoutExpired):
            for q in procs:
                q.kill()
            raise AssertionError(f"children timed out ({timeout_s:.0f} s): "
                                 f"a process hung")
    results = []
    for p, (out, err, secs) in zip(procs, drained):
        lines = [l for l in out.splitlines() if l.startswith("RESULT ")]
        res = json.loads(lines[-1][len("RESULT "):]) if lines else None
        if expect_ok:
            assert p.returncode == 0 and res is not None, \
                f"child failed ({p.returncode}):\n{out[-1000:]}\n{err[-3000:]}"
            results.append(res)
        else:
            results.append((p.returncode, res, err, secs))
    return results


def _committed(ck):
    return sorted(d for d in os.listdir(ck) if d.startswith("epoch_")
                  and os.path.isfile(os.path.join(ck, d, "MANIFEST.json")))


def _one(job, ck=None, resume=False, W=4):
    """``job`` in this process, one controller of W workers."""
    import thrill_tpu_torch as tt
    from thrill_tpu_torch.common.config import Config
    return json.loads(json.dumps(tt.Run(
        JOBS[job], W, device="cpu", config=Config(ckpt_dir=ck) if ck
        else Config(), resume=resume)))


def _kill_run(job, ck, epoch):
    """Process 1 SIGKILLs itself entering epoch ``epoch``'s save: (the
    survivor's exit code, its seconds from the kill to its exit)."""
    outs = _drain(_launch(job, ck, rank_env={1: {
        "TEST_KILL_AT_EPOCH": str(epoch)}}), expect_ok=False)
    (rc0, _, err0, t0), (rc1, _, err1, t1) = outs
    assert rc1 == -signal.SIGKILL, f"process 1 not killed ({rc1}):\n{err1}"
    assert rc0 != 0, "the survivor exited 0 despite losing its peer"
    return rc0, t0 - t1, err0


def test_host_pagerank_sigkill_resumes_bit_identical(tmp_path):
    want = _one("hostpr")
    ck = str(tmp_path / "ck")
    rc0, secs, err0 = _kill_run("hostpr", ck, 3)
    # the survivor waited in the host group (the file tables' all_gather
    # or the barrier after them) and ended within the bound
    assert secs < SURVIVOR_BOUND_S, (secs, err0[-2000:])
    assert _committed(ck) == ["epoch_000000", "epoch_000001",
                              "epoch_000002"]
    res = _drain(_launch("hostpr", ck, {"THRILL_TPU_RESUME": "1"}))
    for r in res:
        assert r["ranks"] == want["ranks"]
        assert r["resume_skipped_ops"] >= 1 and r["resume_epoch"] == 2
        assert r["hosts"] == 2
    # the incomplete epoch 3 was swept
    assert not os.path.isdir(os.path.join(ck, "epoch_000003")) or \
        os.path.isfile(os.path.join(ck, "epoch_000003", "MANIFEST.json"))


def test_device_pagerank_and_sort_sigkill_resume(tmp_path):
    want = _one("devpr")
    ck = str(tmp_path / "ck")
    rc0, secs, err0 = _kill_run("devpr", ck, 1)   # the second loop epoch
    assert secs < SURVIVOR_BOUND_S, (secs, err0[-2000:])
    assert _committed(ck) == ["epoch_000000"]
    res = _drain(_launch("devpr", ck, {"THRILL_TPU_RESUME": "1"}))
    for r in res:
        assert r["ranks"] == want["ranks"] and r["sort"] == want["sort"]
        assert r["resume_epoch"] == 0
    # the survivor dropped its half-written epoch 1 as it aborted, so
    # the resumed run sealed iterations 1 and 2 into epochs 1 and 2 and
    # the Sort into epoch 3, the newest: a second resume restores it
    assert _committed(ck) == [f"epoch_{i:06d}" for i in range(4)]
    with open(os.path.join(ck, "epoch_000003", "MANIFEST.json")) as f:
        assert json.load(f)["node"]["label"] == "Checkpoint[sort]"
    res = _drain(_launch("devpr", ck, {"THRILL_TPU_RESUME": "1"}))
    for r in res:
        assert r["ranks"] == want["ranks"] and r["sort"] == want["sort"]
        assert r["resume_skipped_ops"] >= 1 and r["resume_epoch"] == 3


def _tree(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def test_epochs_of_two_processes_are_one_process_s(tmp_path):
    """Byte-equal epochs, and the uint64 and int16 columns restored."""
    import jax

    from thrill_tpu.api import Context as JContext
    from thrill_tpu.parallel.mesh import MeshExec as JMeshExec
    ck1, ck2 = str(tmp_path / "one"), str(tmp_path / "two")
    one = _one("epochs", ck1)
    two = _drain(_launch("epochs", ck2))
    assert _tree(ck1) == _tree(ck2)
    assert _committed(ck1) == ["epoch_000000", "epoch_000001"]
    for rel in _tree(ck1):
        with open(os.path.join(ck1, rel), "rb") as a, \
                open(os.path.join(ck2, rel), "rb") as b:
            x, y = a.read(), b.read()
        if rel == os.path.join("epoch_000000", "MANIFEST.json"):
            # the host epoch: per-worker counts a dict in one process, a
            # list across processes, as the reference's
            mx, my = json.loads(x), json.loads(y)
            cx = mx["node"].pop("counts")
            assert my["node"].pop("counts") == [cx[str(w)] for w in range(4)]
            assert mx == my
        else:
            assert x == y, rel
    # the restore of the device epoch gives the reference's values
    jctx = JContext(JMeshExec(devices=jax.devices("cpu")[:4]))
    try:
        c = columns()
        got = jctx.Distribute(c).Map(
            lambda t: {"u": t["u"], "s": t["s"], "k": t["k"] * 3}) \
            .AllGatherArrays()
        want = {"u": [str(int(x)) for x in np.asarray(got["u"])],
                "s": np.asarray(got["s"]).tolist(),
                "k": np.asarray(got["k"]).tolist()}
    finally:
        jctx.close()
    res = _drain(_launch("epochs", ck2, {"THRILL_TPU_RESUME": "1"}))
    for r in [one] + two + res:
        assert {k: r[k] for k in want} == want
    for r in res:
        assert r["resume_epoch"] == 1 and r["resume_skipped_ops"] >= 1


@pytest.fixture(scope="module")
def three_epochs_dir(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("three") / "ck")
    res = _drain(_launch("three", ck))
    assert _committed(ck) == [f"epoch_{i:06d}" for i in range(3)]
    return ck, res[0]


def test_resume_epoch_agreed_when_a_process_sees_an_older_one(
        tmp_path, three_epochs_dir):
    src, want = three_epochs_dir
    ck = str(tmp_path / "ck")
    shutil.copytree(src, ck)
    res = _drain(_launch("three", ck, {"THRILL_TPU_RESUME": "1"},
                         rank_env={1: {"TEST_HIDE_EPOCH": "2"}}))
    for r in res:
        assert (r["sum"], r["n"]) == (want["sum"], want["n"])
        assert r["resume_epoch"] == 1 and r["resume_skipped_ops"] >= 1


@pytest.mark.parametrize("how", ["crc", "read"])
def test_a_restore_failing_on_one_process_recomputes_on_both(
        tmp_path, three_epochs_dir, how):
    src, want = three_epochs_dir
    ck = str(tmp_path / "ck")
    shutil.copytree(src, ck)
    rank_env = {1: {"TEST_NOTES": "1"}}
    if how == "crc":
        # worker 3's file: only process 1 reads it
        shard = [f for f in os.listdir(os.path.join(ck, "epoch_000002"))
                 if f.endswith(".w3.bin")][0]
        path = os.path.join(ck, "epoch_000002", shard)
        with open(path, "r+b") as f:
            f.seek(8)
            f.write(b"\xff\xff\xff\xff")
    else:
        rank_env[1]["THRILL_TPU_FAULTS"] = "ckpt.read:n=0"
    res = _drain(_launch("three", ck, {"THRILL_TPU_RESUME": "1",
                                       "TEST_NOTES": "1"}, rank_env=rank_env))
    for r in res:
        assert (r["sum"], r["n"]) == (want["sum"], want["n"])
        assert r["resume_epoch"] == 2 and r["resume_skipped_ops"] == 0
    assert "ckpt.restore_abandoned" in res[0]["notes"]
    assert "ckpt.restore_failed" in res[1]["notes"]
    assert "ckpt.restore_abandoned" not in res[1]["notes"]


def test_a_survivor_waiting_in_gloo_ends_at_once(tmp_path):
    """Process 1 SIGKILLed as it enters the Sort's all-to-all, where
    process 0 waits: gloo's read fails as the kernel closes the dead
    process's sockets, so the survivor ends far inside gloo's 300 s."""
    outs = _drain(_launch("xsort", str(tmp_path / "ck"), rank_env={1: {
        "TEST_KILL_IN_EXCHANGE": "1"}}), expect_ok=False)
    (rc0, _, err0, t0), (rc1, _, _, t1) = outs
    assert rc1 == -signal.SIGKILL and rc0 != 0
    assert t0 - t1 < SURVIVOR_BOUND_S, (t0 - t1, err0[-2000:])
    assert "Connection reset by peer" in err0 or "Connection closed" in err0


def test_external_sort_runs_reused_by_both_processes_after_a_kill(tmp_path):
    env = {"THRILL_TPU_HOST_SORT_RUN": "100",
           "THRILL_TPU_SPILL_RESIDENT": "64K"}
    ck = str(tmp_path / "ck")
    outs = _drain(_launch("em", ck, env, rank_env={1: {
        "TEST_KILL_AFTER_RUNS": "2"}}), expect_ok=False)
    assert outs[1][0] == -signal.SIGKILL and outs[0][0] != 0
    stores = sorted(os.listdir(os.path.join(ck, "em_runs")))
    assert [s[-3:] for s in stores] == ["_h0", "_h1"], stores
    res = _drain(_launch("em", ck, dict(env, THRILL_TPU_RESUME="1")))
    want = sorted(em_items(), key=lambda t: t[0])
    for r in res:
        assert r["out"] == [[k, repr(v)] for k, v in want]
    # each process reloaded the runs its own store committed
    assert all(r["resume_skipped_runs"] >= 1 for r in res)


# ----------------------------------------------------------------------
# the child: one process of the mesh
# ----------------------------------------------------------------------

def _hooks(rank):
    from thrill_tpu_torch.api import checkpoint as ck_mod
    from thrill_tpu_torch.core import em_runs
    kill_epoch = int(os.environ.get("TEST_KILL_AT_EPOCH", "-1"))
    if kill_epoch >= 0:
        orig = ck_mod.CheckpointManager.save

        def save(self, node, shards):
            if self._next_epoch == kill_epoch:
                sys.stdout.flush()
                os.kill(os.getpid(), signal.SIGKILL)
            return orig(self, node, shards)

        ck_mod.CheckpointManager.save = save
    hide = int(os.environ.get("TEST_HIDE_EPOCH", "-1"))
    if hide >= 0:
        orig_load = ck_mod.CheckpointManager._try_load_manifest

        def load(self, edir):
            if edir.rstrip("/").endswith(f"epoch_{hide:06d}"):
                return None          # as if this process could not read it
            return orig_load(self, edir)

        ck_mod.CheckpointManager._try_load_manifest = load
    if os.environ.get("TEST_KILL_IN_EXCHANGE"):
        from thrill_tpu_torch.parallel import mesh

        def transpose(self, blocks):
            sys.stdout.flush()
            os.kill(os.getpid(), signal.SIGKILL)

        mesh.MeshExec.worker_transpose = transpose
    runs = int(os.environ.get("TEST_KILL_AFTER_RUNS", "-1"))
    if runs >= 0:
        orig_commit = em_runs.RunStore.commit
        done = [0]

        def commit(self, *a, **kw):
            ok = orig_commit(self, *a, **kw)
            done[0] += 1
            if done[0] >= runs:
                os.kill(os.getpid(), signal.SIGKILL)
            return ok

        em_runs.RunStore.commit = commit


def _child(coordinator, rank, job):
    import thrill_tpu_torch as tt
    from thrill_tpu_torch.common import faults
    _hooks(rank)

    def run(ctx):
        out = JOBS[job](ctx)
        if os.environ.get("TEST_NOTES"):
            out["notes"] = sorted({e.get("what") for e in
                                   faults.REGISTRY.events if e.get("what")})
        return out

    res = tt.RunDistributed(run, coordinator_address=coordinator,
                            num_processes=2, process_id=rank,
                            workers_per_process=2, device="cpu",
                            resume=os.environ.get("THRILL_TPU_RESUME") == "1")
    print("RESULT " + json.dumps(res), flush=True)


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), sys.argv[3])
