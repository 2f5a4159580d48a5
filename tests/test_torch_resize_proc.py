"""The supervised process-level move (the reference's
``tests/net/test_resize_proc.py``) on the port: ``resize_processes`` in
one controller under ``run-scripts/supervise.sh``, 2 -> 3 -> 2.

* Each phase is one launch of this file as ``__main__`` under the
  supervisor. Phase 0 (W = 2) computes a checkpointed result and calls
  ``ctx.resize_processes(3, state=...)``: the RESIZE epoch is sealed,
  the marker committed and the process exits 75. The supervisor
  relaunches at W = 3 with resume; the relaunch restores the RESIZE
  epoch (bit-identical result, the layout of a fresh W = 3 run),
  consumes the marker and moves back to 2 the same way. (The
  reference's autoscale policy that picks the target is ROADMAP.md item
  6, its service-plane part: the child calls ``resize_processes`` itself.)
* A SIGKILL between the marker's commit and the exit is completed by
  the supervisor on its crash path: the move lands at W = 3.
* The chaos sweep over the move's sites: whichever fires, nothing
  changed (W, generation, no marker) and the clean retry commits.
* The RESIZE epoch's files and manifest are the reference's, byte for
  byte; across processes ``resize_processes`` raises naming item 6, its
  checkpoint part.

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


def _run_supervised(tmp_path, extra_env=None):
    from thrill_tpu_torch.common.timeouts import scaled
    state, ck = str(tmp_path / "state"), str(tmp_path / "ck")
    os.makedirs(state, exist_ok=True)
    env = dict(os.environ)
    for k in ("THRILL_TPU_RESUME", "THRILL_TPU_RESIZE_W",
              "THRILL_TPU_FAULTS"):
        env.pop(k, None)
    env.update({"PYTHONPATH": REPO + os.pathsep
                + env.get("PYTHONPATH", ""),
                "THRILL_TPU_CKPT_DIR": ck, "TEST_STATE_DIR": state})
    env.update(extra_env or {})
    p = subprocess.run(["bash", SUPERVISE, "-n", "2", "--",
                        sys.executable, os.path.abspath(__file__)],
                       env=env, capture_output=True, text=True,
                       timeout=scaled(180))
    phases = [json.loads(l[len("PHASE "):])
              for l in p.stdout.splitlines() if l.startswith("PHASE ")]
    return p, phases


def _layout(w):
    """Counts and rows of ``N`` items re-split over ``w`` workers, as a
    fresh W-wide Distribute lays them out."""
    from thrill_tpu_torch.common.partition import dense_range_bounds
    b = dense_range_bounds(N, w)
    vals = [i * 3 + 1 for i in range(N)]
    return [int(c) for c in np.diff(b)], \
        [vals[b[i]:b[i + 1]] for i in range(w)]


def test_supervised_resize_2_3_2_is_bit_identical(tmp_path):
    p, phases = _run_supervised(tmp_path)
    assert p.returncode == 0, f"{p.stdout[-2000:]}\n{p.stderr[-3000:]}"
    assert [ph["phase"] for ph in phases] == [0, 1, 2], phases
    assert [ph["w"] for ph in phases] == [2, 3, 2]
    assert [ph["resumed"] for ph in phases] == [False, True, True]
    want = sorted(i * 3 + 1 for i in range(N))
    assert all(ph["result"] == want for ph in phases)
    assert all(ph["resume_skipped_ops"] >= 1 for ph in phases[1:])
    assert not any(ph["marker_pending"] for ph in phases)
    # each relaunch restored the RESIZE epoch in a fresh W' layout
    for ph in phases[1:]:
        assert [ph["counts"], ph["rows"]] == list(_layout(ph["w"]))
    assert "resize move committed; relaunching at W=3" in p.stderr
    assert "resize move committed; relaunching at W=2" in p.stderr
    assert "restart" not in p.stdout


def test_sigkill_between_marker_and_exit_is_completed(tmp_path):
    p, phases = _run_supervised(tmp_path,
                                extra_env={"TEST_KILL_AFTER_MARKER": "1"})
    assert p.returncode == 0, f"{p.stdout[-2000:]}\n{p.stderr[-3000:]}"
    assert [ph["phase"] for ph in phases] == [0, 1], phases
    assert phases[1]["w"] == 3 and phases[1]["resumed"]
    assert phases[1]["result"] == sorted(i * 3 + 1 for i in range(N))
    assert phases[1]["resume_skipped_ops"] >= 1
    assert not phases[1]["marker_pending"]
    assert "completing move to W=3 on restart 1/2" in p.stderr


N_ELASTIC_SEEDS = int(os.environ.get("THRILL_TPU_ELASTIC_SEEDS", "2"))


@pytest.mark.chaos
@pytest.mark.parametrize("seed", range(max(N_ELASTIC_SEEDS, 3)))
def test_chaos_process_move_sites_nothing_changed_then_commit(
        seed, tmp_path, monkeypatch):
    import thrill_tpu_torch as tt
    from thrill_tpu_torch.api.checkpoint import pending_resize_target
    from thrill_tpu_torch.common import faults
    from thrill_tpu_torch.common.config import Config
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    faults.REGISTRY.reset()
    site = ["ckpt.resize_manifest", "net.group.relaunch",
            "ckpt.resize_manifest"][seed % 3]
    after = 1 if seed % 3 == 2 else 0        # the marker's stage
    ck = str(tmp_path / "ck")
    ctx = tt.Context(num_workers=2, device="cpu",
                     config=Config(ckpt_dir=ck))
    try:
        d = ctx.Distribute(np.arange(48, dtype=np.int64)).Map(
            lambda x: x * 5 + seed).Keep(4)
        d.Execute()
        want = sorted(int(x) for x in d.AllGather())
        gen0, w0 = ctx.generation, ctx.num_workers
        with faults.inject(site, n=1, seed=seed, after=after):
            with pytest.raises(faults.InjectedFault):
                ctx.resize_processes(3, state=d)
        assert ctx.num_workers == w0
        # a fire at the marker's stage comes after the gate, which
        # settled the move's generation, as in the reference
        assert ctx.generation == gen0 if not after else \
            ctx.generation == gen0 + 1
        assert pending_resize_target(ck) is None
        assert ctx.stats_resizes_proc == 0
        assert sorted(int(x) for x in d.AllGather()) == want
        with pytest.raises(tt.ResizeRelaunch) as ei:
            ctx.resize_processes(3, state=d)
        assert ei.value.code == 75 and ei.value.target_w == 3
        assert pending_resize_target(ck)["target_w"] == 3
        assert ctx.stats_resizes_proc == 1
        assert faults.REGISTRY.injected >= 1
    finally:
        ctx.close()
        faults.REGISTRY.reset()


def test_resize_epoch_files_are_the_reference_s(tmp_path):
    import jax

    import thrill_tpu_torch as tt
    from thrill_tpu.api import Context as JContext
    from thrill_tpu.common.config import Config as JConfig
    from thrill_tpu.parallel.mesh import MeshExec as JMeshExec
    from thrill_tpu_torch.common.config import Config
    vals = {"k": np.arange(50, dtype=np.int64),
            "v": np.arange(50, dtype=np.float32) * 0.5}
    words = [f"w{i}" for i in range(30)]
    dirs = {}
    for pkg in ("port", "ref"):
        ck = str(tmp_path / pkg)
        if pkg == "port":
            ctx = tt.Context(num_workers=2, device="cpu",
                             config=Config(ckpt_dir=ck))
        else:
            ctx = JContext(JMeshExec(devices=jax.devices("cpu")[:2]),
                           config=JConfig(ckpt_dir=ck))
        try:
            for src, storage in ((vals, None), (words, "host")):
                d = ctx.Distribute(src, storage=storage)
                d.Keep(2)
                d.Execute()
                ctx.checkpoint.seal_resize(d.node, d.node._shards, 3)
            ctx.checkpoint.commit_resize_marker(3, epoch=1, generation=2,
                                                procs=1)
        finally:
            ctx.close()
        dirs[pkg] = ck
    listing = {pkg: sorted(os.path.relpath(os.path.join(r, f), d)
                           for r, _, fs in os.walk(d) for f in fs)
               for pkg, d in dirs.items()}
    assert listing["port"] == listing["ref"]
    for rel in listing["port"]:
        with open(os.path.join(dirs["port"], rel), "rb") as a, \
                open(os.path.join(dirs["ref"], rel), "rb") as b:
            assert a.read() == b.read(), rel


def test_across_processes_it_raises_naming_the_checkpoint_part():
    import thrill_tpu_torch as tt
    from thrill_tpu_torch.parallel.mesh import MeshExec
    mex = MeshExec(num_workers=4, device="cpu", process_index=0,
                   num_processes=2)
    ctx = tt.Context(mex)
    try:
        with pytest.raises(NotImplementedError,
                           match="item 6, its checkpoint part"):
            ctx.resize_processes(2)
        assert ctx.num_workers == 4 and ctx.stats_resizes_proc == 0
    finally:
        ctx.close()


# ----------------------------------------------------------------------
# the child: one phase of the move a launch
# ----------------------------------------------------------------------

def _bump_phase(state_dir):
    path = os.path.join(state_dir, "phase")
    try:
        with open(path) as f:
            phase = int(f.read())
    except (OSError, ValueError):
        phase = -1
    with open(path, "w") as f:
        f.write(str(phase + 1))
    return phase + 1


def _child():
    import thrill_tpu_torch as tt
    from thrill_tpu_torch.api import checkpoint as ck_mod
    from thrill_tpu_torch.common.config import Config
    ck = os.environ["THRILL_TPU_CKPT_DIR"]
    phase = _bump_phase(os.environ["TEST_STATE_DIR"])
    w = int(os.environ.get("THRILL_TPU_RESIZE_W", "2"))
    resumed = os.environ.get("THRILL_TPU_RESUME") == "1"
    kill = os.environ.get("TEST_KILL_AFTER_MARKER") == "1"
    if kill and phase == 0:
        orig = ck_mod.CheckpointManager.commit_resize_marker

        def commit_then_die(self, *a, **kw):
            path = orig(self, *a, **kw)
            sys.stdout.flush()
            os.kill(os.getpid(), signal.SIGKILL)
            return path

        ck_mod.CheckpointManager.commit_resize_marker = commit_then_die
    ctx = tt.Context(num_workers=w, device="cpu",
                     config=Config(ckpt_dir=ck), resume=resumed)
    d = ctx.Distribute(np.arange(N, dtype=np.int64)) \
        .Map(lambda x: x * 3 + 1).Checkpoint("stage").Keep(4)
    d.Execute()
    sh = d.node._shards
    layout = ([int(c) for c in sh.counts],
              [sh.tree[i, :int(c)].tolist() for i, c in
               enumerate(sh.counts)])
    out = sorted(int(x) for x in d.AllGather())
    stats = ctx.overall_stats()
    print("PHASE " + json.dumps({
        "phase": phase, "w": w, "resumed": resumed, "result": out,
        "counts": layout[0], "rows": layout[1],
        "resume_skipped_ops": stats.get("resume_skipped_ops", 0),
        "marker_pending": os.path.isfile(os.path.join(ck, "RESIZE.json")),
    }), flush=True)
    if phase == 0:
        ctx.resize_processes(3, state=d)      # exits 75
        raise AssertionError("resize_processes returned")
    if phase == 1:
        if kill:
            ctx.close()
            return
        ctx.resize_processes(2, state=d)
        raise AssertionError("resize_processes returned")
    ctx.close()


if __name__ == "__main__":
    _child()
