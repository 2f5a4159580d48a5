"""The port's resumable external-memory runs (``thrill_tpu_torch/core/
em_runs.py`` in the host Sort) against the reference package's on the
CPU, at W = 1, 2 and 4.

Host items go through an external Sort (runs of 100 items) in both
packages, each with a checkpoint directory of its own; then the job runs
again with ``resume=True``. The run stores must hold the same files
(every run's bin byte for byte, every manifest equal), the outputs must
equal ``sorted()`` and each other, and the counters must be equal:
``spill_runs`` and ``runs_reused`` (each package's I/O ledger) and
``resume_skipped_runs``. The cases are the single-controller cases of
the reference's ``tests/api/test_em_resume.py``: reuse of every run,
no store without a checkpoint directory or with
``THRILL_TPU_EM_RESUME=0``, corrupt manifests and bins formed again
loudly, the ``em.run.manifest`` fault site at commit and at load, and a
SIGKILL mid-sort whose relaunch reuses the committed runs.
"""

import glob
import json
import os
import shutil
import signal
import subprocess
import sys

import pytest

from thrill_tpu.api import Context as JContext
from thrill_tpu.common import faults as jfaults
from thrill_tpu.common.config import Config as JConfig
from thrill_tpu.common.iostats import IO as JIO
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.common import faults as tfaults
from thrill_tpu_torch.common.config import Config as TConfig
from thrill_tpu_torch.common.iostats import IO as TIO

WIDTHS = [1, 2, 4]
N = 2000


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_HOST_SORT_RUN", "100")
    for var in ("THRILL_TPU_EM_RESUME", "THRILL_TPU_CKPT_DIR",
                "THRILL_TPU_RESUME", tfaults.ENV_VAR):
        monkeypatch.delenv(var, raising=False)
    for reg in (jfaults.REGISTRY, tfaults.REGISTRY):
        reg.reset()
    yield
    for reg in (jfaults.REGISTRY, tfaults.REGISTRY):
        reg.reset()


def _data():
    return [(f"k{(i * 7919) % N:05d}", float(i)) for i in range(N)]


def _expect():
    return sorted(_data(), key=lambda t: t[0])


def _job(ctx):
    out = ctx.Distribute(_data(), storage="host").Sort(
        key_fn=lambda t: t[0]).AllGather()
    return out, ctx.overall_stats().get("resume_skipped_runs")


def _run(side, W, ckpt=None, resume=False, job=_job):
    """(result, ledger deltas) of one run of ``job`` in one package."""
    io = JIO if side == "j" else TIO
    s0 = io.snapshot()
    if side == "j":
        ctx = JContext(JMeshExec(num_workers=W),
                       config=JConfig(ckpt_dir=ckpt or ""), resume=resume)
        try:
            out = job(ctx)
        finally:
            ctx.close()
    else:
        out = tt.Run(job, W, device="cpu",
                     config=TConfig(ckpt_dir=ckpt or ""), resume=resume)
    s1 = io.snapshot()
    return out, {k: s1[k] - s0[k] for k in ("spill_runs", "runs_reused")}


def _both(tmp_path, W, resume=False, ckpt=True):
    return [_run(side, W, str(tmp_path / side) if ckpt else None, resume)
            for side in ("j", "t")]


def _manifests(ck):
    return sorted(glob.glob(os.path.join(ck, "em_runs", "*", "run_*.json")))


def _assert_same_stores(tmp_path):
    trees = []
    for side in ("j", "t"):
        root = tmp_path / side / "em_runs"
        trees.append(sorted(
            os.path.relpath(os.path.join(d, f), root)
            for d, _, fs in os.walk(root) for f in fs
            if f != "OWNER.json"))       # the reference's adoption record
    assert trees[0] == trees[1] and trees[0]
    for rel in trees[0]:
        a = (tmp_path / "j" / "em_runs" / rel).read_bytes()
        b = (tmp_path / "t" / "em_runs" / rel).read_bytes()
        if rel.endswith(".json"):
            a, b = json.loads(a), json.loads(b)
        assert a == b, rel


@pytest.mark.parametrize("W", WIDTHS)
def test_runs_commit_and_resume_reuses_all(tmp_path, W):
    (jout, jio), (tout, tio) = _both(tmp_path, W)
    assert tout == jout and tio == jio
    assert tout[0] == _expect() and tout[1] == 0
    formed = tio["spill_runs"]
    assert formed > 0 and tio["runs_reused"] == 0
    mans = _manifests(str(tmp_path / "t"))
    assert len(mans) == formed           # every spilled run committed
    man = json.loads(open(mans[0]).read())
    assert {"slot", "pos0", "n", "fp", "crc", "bin_bytes",
            "has_keys"} <= set(man)
    _assert_same_stores(tmp_path)

    # the relaunch forms no run: every one is reused
    (jout2, jio2), (tout2, tio2) = _both(tmp_path, W, resume=True)
    assert tout2 == jout2 and tio2 == jio2
    assert tout2[0] == _expect()
    assert tio2 == {"spill_runs": 0, "runs_reused": formed}
    assert tout2[1] == formed            # resume_skipped_runs


@pytest.mark.parametrize("W", [1, 4])
def test_no_store_without_checkpoint_dir(tmp_path, W):
    (jout, jio), (tout, tio) = _both(tmp_path, W, ckpt=False)
    assert tout == jout and tio == jio
    assert tout[0] == _expect() and tout[1] is None
    assert tio["runs_reused"] == 0


def test_em_resume_knob_disables_store(tmp_path, monkeypatch):
    monkeypatch.setenv("THRILL_TPU_EM_RESUME", "0")
    (jout, _), (tout, _) = _both(tmp_path, 2)
    assert tout == jout and tout[0] == _expect()
    assert _manifests(str(tmp_path / "t")) == []
    assert _manifests(str(tmp_path / "j")) == []


@pytest.mark.parametrize("W", WIDTHS)
def test_corrupt_manifest_reforms_loudly(tmp_path, W):
    _both(tmp_path, W)
    for side in ("j", "t"):
        mans = _manifests(str(tmp_path / side))
        with open(mans[0], "w") as f:
            f.write("{not json")                       # a corrupt manifest
        with open(mans[1].replace(".json", ".bin"), "r+b") as f:
            f.truncate(10)                             # a corrupt bin
    evs = [len(jfaults.REGISTRY.events), len(tfaults.REGISTRY.events)]
    (jout, jio), (tout, tio) = _both(tmp_path, W, resume=True)
    assert tout == jout and tio == jio
    assert tout[0] == _expect()                        # never wrong data
    assert tio["spill_runs"] == 2
    assert tio["runs_reused"] == len(mans) - 2
    for reg, e0 in zip((jfaults.REGISTRY, tfaults.REGISTRY), evs):
        loud = [e for e in reg.events[e0:]
                if e.get("what") == "em_runs.manifest_invalid"]
        assert len(loud) == 2


@pytest.mark.parametrize("W", WIDTHS)
def test_manifest_fault_at_commit_leaves_run_nonresumable(tmp_path, W):
    outs = []
    for side, faults_ in (("j", jfaults), ("t", tfaults)):
        with faults_.inject("em.run.manifest", n=2):
            first = _run(side, W, str(tmp_path / side))
        outs.append((first, _run(side, W, str(tmp_path / side),
                                 resume=True)))
    assert outs[0] == outs[1]
    (first, (again, io)) = outs[1]
    assert first[0][0] == again[0] == _expect()
    # the two runs left uncommitted are formed again silently
    assert io["spill_runs"] == 2
    assert io["runs_reused"] == first[1]["spill_runs"] - 2


@pytest.mark.parametrize("W", WIDTHS)
def test_manifest_fault_at_load_reforms_loudly(tmp_path, W):
    _both(tmp_path, W)
    formed = len(_manifests(str(tmp_path / "t")))
    outs = []
    for side, faults_ in (("j", jfaults), ("t", tfaults)):
        e0 = len(faults_.REGISTRY.events)
        with faults_.inject("em.run.manifest", n=1):
            outs.append(_run(side, W, str(tmp_path / side), resume=True))
        assert any(e.get("what") == "em_runs.manifest_invalid"
                   for e in faults_.REGISTRY.events[e0:])
    assert outs[0] == outs[1]
    out, io = outs[1]
    assert out[0] == _expect()
    assert io == {"spill_runs": 1, "runs_reused": formed - 1}
    assert out[1] == formed - 1


@pytest.mark.parametrize("W", [2, 4])
def test_resume_skipped_runs_in_ctx_stats(tmp_path, W):
    _both(tmp_path, W)
    (jout, _), (tout, _) = _both(tmp_path, W, resume=True)
    assert tout == jout
    assert tout[1] > 0


_CHILD = """
import os, signal
import thrill_tpu_torch as tt
from thrill_tpu_torch.common.config import Config
from thrill_tpu_torch.core import em_runs

orig = em_runs.RunStore.commit
count = [0]
def killing_commit(self, *a, **kw):
    ok = orig(self, *a, **kw)
    count[0] += 1
    if count[0] >= 4:            # four committed runs
        os.kill(os.getpid(), signal.SIGKILL)
    return ok
em_runs.RunStore.commit = killing_commit

N = 2000
data = [(f"k{(i * 7919) % N:05d}", float(i)) for i in range(N)]
def job(ctx):
    return ctx.Distribute(data, storage="host").Sort(
        key_fn=lambda t: t[0]).AllGather()
tt.Run(job, 2, device="cpu", config=Config(ckpt_dir=CKPT))
"""


def test_sigkill_midsort_relaunch_reuses_committed_runs(tmp_path):
    """A process SIGKILLed after four runs committed; the relaunch
    reuses every committed run and forms the rest, and the reference
    relaunched on a copy of the same store gives the same output and
    counters."""
    ck = str(tmp_path / "t")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, THRILL_TPU_HOST_SORT_RUN="100",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    p = subprocess.run(
        [sys.executable, "-c", _CHILD.replace("CKPT", repr(ck))],
        env=env, capture_output=True, timeout=240)
    assert p.returncode == -signal.SIGKILL, p.stderr.decode()[-2000:]
    committed = len(_manifests(ck))
    assert committed >= 4
    # every committed manifest has its whole bin beside it
    assert all(os.path.isfile(m.replace(".json", ".bin"))
               for m in _manifests(ck))

    # the reference resumes from a copy of the same store (its run
    # files are the reference's bytes)
    jck = str(tmp_path / "j")
    shutil.copytree(ck, jck)
    (out, io) = _run("t", 2, ck, resume=True)
    assert out[0] == _expect()
    assert io["runs_reused"] == committed
    assert out[1] == committed
    assert _run("j", 2, jck, resume=True) == (out, io)
