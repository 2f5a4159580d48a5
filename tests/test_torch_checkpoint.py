"""The port's checkpoints and resume (``thrill_tpu_torch/api/checkpoint.py``)
against the reference package's on the CPU, at W = 1, 2 and 4.

Each case runs one job through both packages, each with a checkpoint
directory of its own, then runs it again with ``resume=True``. The
epoch directories must hold the same files: every shard file byte for
byte (so the same CRCs), every manifest equal key for key (the pickled
skeleton compared after unpickling). Results, first and resumed, must
be equal, and so must the counters ``checkpoint_epochs``,
``ckpt_bytes_written``, ``resume_skipped_ops`` and
``resume_skipped_runs``. The cases are the single-controller cases of
the reference's ``tests/api/test_checkpoint.py`` (corrupt, incomplete
and wrong-W epochs, the atomic commit, the automatic seals, the
subsystem off by default) and the ``ckpt.write``, ``ckpt.read`` and
``ckpt.manifest`` fault sites.
"""

import base64
import json
import os
import pickle

import numpy as np
import pytest

from thrill_tpu.api import Context as JContext
from thrill_tpu.common import faults as jfaults
from thrill_tpu.common.config import Config as JConfig
from thrill_tpu.data import serializer as jser
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.common import faults as tfaults
from thrill_tpu_torch.common.config import Config as TConfig
from thrill_tpu_torch.data import serializer as tser

WIDTHS = [1, 2, 4]
COUNTERS = ("checkpoint_epochs", "ckpt_bytes_written", "resume_skipped_ops",
            "resume_skipped_runs")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("THRILL_TPU_CKPT_DIR", "THRILL_TPU_RESUME",
                "THRILL_TPU_CKPT_AUTO", tfaults.ENV_VAR):
        monkeypatch.delenv(var, raising=False)
    for reg in (jfaults.REGISTRY, tfaults.REGISTRY):
        reg.reset()
    yield
    for reg in (jfaults.REGISTRY, tfaults.REGISTRY):
        reg.reset()


def _jrun(job, W, ckpt, resume=False, **kw):
    ctx = JContext(JMeshExec(num_workers=W),
                   config=JConfig(ckpt_dir=ckpt, **kw), resume=resume)
    try:
        return job(ctx)
    finally:
        ctx.close()


def _trun(job, W, ckpt, resume=False, **kw):
    return tt.Run(job, W, device="cpu", config=TConfig(ckpt_dir=ckpt, **kw),
                  resume=resume)


def _both(job, W, tmp_path, resume=False, **kw):
    """(reference's result, port's result), each under its own dir."""
    return (_jrun(job, W, str(tmp_path / "j"), resume, **kw),
            _trun(job, W, str(tmp_path / "t"), resume, **kw))


def _counters(ctx):
    s = ctx.overall_stats()
    return {k: s[k] for k in COUNTERS}


def _manifest(path):
    m = json.loads(open(path, "rb").read())
    if "skeleton" in m["node"]:
        m["node"]["skeleton"] = pickle.loads(
            base64.b64decode(m["node"]["skeleton"]))
    return m


def _assert_same_epochs(tmp_path):
    """Both checkpoint directories hold the same files, shard files
    byte-equal and manifests equal key for key."""
    trees = []
    for side in ("j", "t"):
        root = tmp_path / side
        trees.append(sorted(os.path.relpath(os.path.join(d, f), root)
                            for d, _, fs in os.walk(root) for f in fs))
    assert trees[0] == trees[1]
    assert trees[0], "no epoch was written"
    for rel in trees[0]:
        a, b = tmp_path / "j" / rel, tmp_path / "t" / rel
        if rel.endswith("MANIFEST.json"):
            assert _manifest(a) == _manifest(b), rel
        else:
            assert a.read_bytes() == b.read_bytes(), rel


def _epochs(d):
    return sorted(p.name for p in d.iterdir()) if d.exists() else []


# -- the codec ---------------------------------------------------------------

@pytest.mark.parametrize("leaves", [
    [np.arange(7, dtype=np.int64)],
    [np.arange(12, dtype=np.float32).reshape(4, 3),
     np.array([True, False, True, True]), np.zeros((4, 2, 2), np.uint8)],
    [np.zeros((0,), np.float64), np.zeros((0, 3), np.int32)],
    [],
])
def test_serialize_leaves_gives_the_references_bytes(leaves):
    blob = tser.serialize_leaves(leaves)
    assert blob == jser.serialize_leaves(leaves)
    back = tser.deserialize_leaves(blob)
    assert len(back) == len(leaves)
    for a, b in zip(back, leaves):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert [x.tobytes() for x in jser.deserialize_leaves(blob)] == \
        [x.tobytes() for x in back]


# -- save and resume ---------------------------------------------------------

def _device_job(calls):
    def job(ctx):
        def spy(x):
            calls.append(1)
            return x * 3

        d = ctx.Distribute(np.arange(64, dtype=np.int64)).Map(spy) \
            .Checkpoint()
        return sorted(int(x) for x in d.AllGather()), _counters(ctx)
    return job


@pytest.mark.parametrize("W", WIDTHS)
def test_device_checkpoint_resume_skips_upstream(tmp_path, W):
    calls = []
    job = _device_job(calls)
    want, got = _both(job, W, tmp_path)
    assert got == want
    assert got[0] == [x * 3 for x in range(64)]
    assert got[1]["checkpoint_epochs"] == 1
    assert got[1]["ckpt_bytes_written"] > 0
    assert _epochs(tmp_path / "t") == ["epoch_000000"]
    _assert_same_epochs(tmp_path)

    calls.clear()
    want2, got2 = _both(job, W, tmp_path, resume=True)
    assert got2 == want2 and got2[0] == want[0]
    assert calls == [], "upstream Map computed despite the resume"
    assert got2[1]["resume_skipped_ops"] >= 1


@pytest.mark.parametrize("W", WIDTHS)
def test_device_pytree_epoch_and_restore(tmp_path, W):
    def job(ctx):
        d = ctx.Distribute({"k": np.arange(37, dtype=np.int64) % 5,
                            "v": np.arange(37, dtype=np.float64) * 0.5,
                            "w": np.arange(111, dtype=np.int32).reshape(37, 3)
                            }).Checkpoint("tree")
        out = d.AllGather()
        return ([(int(t["k"]), float(t["v"]), [int(x) for x in t["w"]])
                 for t in out], _counters(ctx))

    want, got = _both(job, W, tmp_path)
    assert got == want
    _assert_same_epochs(tmp_path)
    m = _manifest(tmp_path / "t" / "epoch_000000" / "MANIFEST.json")
    assert m["node"]["skeleton"] == {"k": 0, "v": 1, "w": 2}
    want2, got2 = _both(job, W, tmp_path, resume=True)
    assert got2 == want2 and got2[0] == want[0]
    assert got2[1]["resume_skipped_ops"] == 1


@pytest.mark.parametrize("W", WIDTHS)
def test_host_storage_checkpoint_resume(tmp_path, W):
    def job(ctx):
        d = ctx.Distribute([(f"k{i % 5}", i) for i in range(40)],
                           storage="host").Checkpoint("host-stage")
        return sorted(d.AllGather()), _counters(ctx)

    want, got = _both(job, W, tmp_path)
    assert got == want
    want2, got2 = _both(job, W, tmp_path, resume=True)
    assert got2 == want2 and got2[0] == want[0]
    _assert_same_epochs(tmp_path)
    m = json.loads((tmp_path / "t" / "epoch_000000" /
                    "MANIFEST.json").read_text())
    assert m["node"]["kind"] == "host"
    assert all("crc" in f for f in m["node"]["files"].values())


@pytest.mark.parametrize("W", WIDTHS)
def test_iterative_checkpoints_resume_from_newest(tmp_path, W):
    """A PageRank-shaped chain sealed every step: the resume restores
    the newest epoch and computes no step."""
    K = 4
    computed = []

    def job(ctx):
        d = ctx.Distribute(np.arange(32, dtype=np.float64))
        for it in range(K):
            def step(x, it=it):
                computed.append(it)
                return x * 0.5 + 1.0

            d = d.Map(step).Checkpoint(f"iter{it}")
        return [float(x) for x in d.AllGather()], _counters(ctx)

    want, got = _both(job, W, tmp_path)
    assert got == want and got[1]["checkpoint_epochs"] == K
    _assert_same_epochs(tmp_path)
    computed.clear()
    want2, got2 = _both(job, W, tmp_path, resume=True)
    assert got2 == want2 and got2[0] == want[0]
    assert computed == []
    assert got2[1]["resume_skipped_ops"] >= K


@pytest.mark.parametrize("W", WIDTHS)
def test_ckpt_auto_saves_stage_barriers(tmp_path, W, monkeypatch):
    """Every computed op is sealed. The reference reduces on its jitted
    engine, as on the card (its native CPU engine narrows the output's
    capacity, which the manifest records)."""
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")

    def job(ctx):
        d = ctx.Distribute(np.arange(16, dtype=np.int64)) \
            .Map(lambda x: {"k": x % 4, "v": x}) \
            .ReduceByKey(lambda t: t["k"],
                         lambda a, b: {"k": a["k"], "v": a["v"] + b["v"]})
        return (sorted((int(t["k"]), int(t["v"])) for t in d.AllGather()),
                _counters(ctx))

    want, got = _both(job, W, tmp_path, ckpt_auto=True)
    assert got == want
    assert got[0] == [(k, sum(x for x in range(16) if x % 4 == k))
                      for k in range(4)]
    assert len(_epochs(tmp_path / "t")) >= 1
    _assert_same_epochs(tmp_path)
    want2, got2 = _both(job, W, tmp_path, resume=True, ckpt_auto=True)
    assert got2 == want2 and got2[0] == want[0]


# -- durability edge cases ---------------------------------------------------

def _plain_job(n=32, dtype=np.int64):
    def job(ctx):
        d = ctx.Distribute(np.arange(n, dtype=dtype)).Checkpoint()
        return sorted(int(x) for x in d.AllGather()), _counters(ctx)
    return job


@pytest.mark.parametrize("W", WIDTHS)
def test_corrupt_shard_falls_back_to_recompute(tmp_path, W):
    job = _plain_job()
    want, got = _both(job, W, tmp_path)
    for side in ("j", "t"):
        edir = tmp_path / side / "epoch_000000"
        shard = next(p for p in sorted(edir.iterdir()) if p.suffix == ".bin")
        shard.write_bytes(b"\xff" * shard.stat().st_size)
    want2, got2 = _both(job, W, tmp_path, resume=True)
    assert got2 == want2 and got2[0] == want[0]
    assert got2[1]["resume_skipped_ops"] == 0
    for reg in (jfaults.REGISTRY, tfaults.REGISTRY):
        assert any(e.get("what") == "ckpt.restore_failed" for e in reg.events)


@pytest.mark.parametrize("W", WIDTHS)
def test_incomplete_epoch_is_cleaned_and_skipped(tmp_path, W):
    job = _plain_job(8)
    want, got = _both(job, W, tmp_path)
    bad = []
    for side in ("j", "t"):
        # a crashed run's half-written newer epoch: no manifest
        d = tmp_path / side / "epoch_000007"
        d.mkdir()
        (d / "n1.w0.bin").write_bytes(b"partial")
        bad.append(d)
    want2, got2 = _both(job, W, tmp_path, resume=True)
    assert got2 == want2 and got2[0] == want[0]
    assert got2[1]["resume_skipped_ops"] == 1      # epoch 0 restored
    assert not any(d.exists() for d in bad)
    _assert_same_epochs(tmp_path)


@pytest.mark.parametrize("W", WIDTHS)
def test_manifest_commit_is_atomic(tmp_path, W):
    def job(ctx):
        return ctx.Distribute(
            np.arange(16, dtype=np.int32)).Checkpoint().Size()

    want, got = _both(job, W, tmp_path)
    assert got == want == 16
    edir = tmp_path / "t" / "epoch_000000"
    assert not [p for p in edir.iterdir() if ".tmp" in p.name]
    m = _manifest(edir / "MANIFEST.json")
    assert m["format"] == 1 and m["epoch"] == 0 and m["workers"] == W
    n = m["node"]
    assert n["kind"] == "device" and n["cap"] >= 1
    assert len(n["counts"]) == W and n["skeleton"] == 0
    _assert_same_epochs(tmp_path)


@pytest.mark.parametrize("W", WIDTHS)
def test_mesh_size_mismatch_refuses_resume(tmp_path, W, capsys):
    job = _plain_job(8)
    want, got = _both(job, W, tmp_path)
    for side in ("j", "t"):
        mpath = tmp_path / side / "epoch_000000" / "MANIFEST.json"
        m = json.loads(mpath.read_text())
        m["workers"] = m["workers"] + 1
        mpath.write_text(json.dumps(m))
    capsys.readouterr()
    want2, got2 = _both(job, W, tmp_path, resume=True)
    assert got2 == want2 and got2[0] == want[0]
    assert got2[1]["resume_skipped_ops"] == 0      # computed again
    err = capsys.readouterr().err
    assert "thrill_tpu.checkpoint: skipping epoch" in err
    assert "thrill_tpu_torch.checkpoint: skipping epoch epoch_000000: " \
        f"epoch was written by a {W + 1}-worker mesh; this run has {W}" in err


@pytest.mark.parametrize("W", WIDTHS)
def test_resume_into_an_epoch_of_another_width_recomputes(tmp_path, W):
    """An epoch of W' workers is not restored at W (the workers check),
    the result is the one computed from the lineage."""
    job = _plain_job(24)
    other = 3 if W != 3 else 2
    _trun(job, other, str(tmp_path / "t"))
    got = _trun(job, W, str(tmp_path / "t"), resume=True)
    assert got[0] == list(range(24))
    assert got[1]["resume_skipped_ops"] == 0
    assert got[1]["checkpoint_epochs"] == 1        # epoch 1, at W
    assert _epochs(tmp_path / "t") == ["epoch_000000", "epoch_000001"]


def test_off_by_default_no_manager_no_dirs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)

    def job(ctx):
        assert ctx.checkpoint is None
        assert "checkpoint_epochs" not in ctx.overall_stats()
        d = ctx.Distribute(np.arange(8, dtype=np.int64)).Checkpoint()
        return sorted(int(x) for x in d.AllGather())

    # Checkpoint() is a plain materialization barrier then
    assert tt.Run(job, 2, device="cpu") == list(range(8))
    assert os.listdir(tmp_path) == []


def test_config_reads_the_references_variables(monkeypatch, tmp_path):
    monkeypatch.setenv("THRILL_TPU_CKPT_DIR", str(tmp_path / "c"))
    monkeypatch.setenv("THRILL_TPU_RESUME", "1")
    monkeypatch.setenv("THRILL_TPU_CKPT_AUTO", "1")
    t, j = TConfig.from_env(), JConfig.from_env()
    assert (t.ckpt_dir, t.resume, t.ckpt_auto) == \
        (j.ckpt_dir, j.resume, j.ckpt_auto) == (str(tmp_path / "c"), True,
                                                True)
    ctx = tt.Context(num_workers=2, device="cpu")
    assert ctx.checkpoint is not None and ctx.checkpoint.resume
    assert ctx.checkpoint.auto
    ctx.close()


def test_a_remote_checkpoint_directory_is_the_references(tmp_path,
                                                        monkeypatch):
    """A checkpoint directory on an object server: the epochs are the
    reference's objects, the resume skips the upstream op as in the
    reference, the resize marker is read from the server and not
    consumed, and no local directory is made for the URL."""
    from thrill_tpu_torch.api import checkpoint as tck
    from thrill_tpu_torch.tools.object_server import ObjectServer
    monkeypatch.chdir(tmp_path)
    calls = []
    job = _device_job(calls)
    with ObjectServer() as srv:
        want = _jrun(job, 2, f"{srv.url}/b/j")
        got = _trun(job, 2, f"{srv.url}/b/t")
        assert got == want and got[0] == [x * 3 for x in range(64)]
        keys = {side: sorted(k[4:] for k in srv.objects
                             if k.startswith(f"b/{side}/"))
                for side in ("j", "t")}
        assert keys["t"] == keys["j"] and keys["t"]
        for k in keys["t"]:
            if k.endswith("MANIFEST.json"):
                continue             # its skeleton pickles each package
            assert srv.objects[f"b/t/{k}"] == srv.objects[f"b/j/{k}"], k
        calls.clear()
        again = _trun(job, 2, f"{srv.url}/b/t", resume=True)
        assert again[0] == got[0] and calls == []
        assert again[1]["resume_skipped_ops"] >= 1
        srv.put("b/t/RESIZE.json", b'{"target_w": 3}')
        assert tck.pending_resize_target(f"{srv.url}/b/t")["target_w"] == 3
        assert not tck.clear_resize_marker(f"{srv.url}/b/t")
        assert tck.pending_resize_target(f"{srv.url}/b/none") is None
    assert os.listdir(tmp_path) == []


def test_a_failed_job_drops_its_uncommitted_epoch(tmp_path):
    """A job that raises while an epoch is in flight: close() removes
    the epoch's directory; the next resume finds nothing to restore."""
    ck = str(tmp_path / "t")
    with tfaults.inject("ckpt.manifest", n=0):
        with pytest.raises(tfaults.InjectedFault):
            _trun(_plain_job(), 2, ck)
    assert _epochs(tmp_path / "t") == []
    got = _trun(_plain_job(), 2, ck, resume=True)
    assert got[0] == list(range(32)) and got[1]["resume_skipped_ops"] == 0


# -- fault sites ---------------------------------------------------------------

@pytest.mark.parametrize("site", ["ckpt.write", "ckpt.read", "ckpt.manifest"])
@pytest.mark.parametrize("W", [1, 4])
def test_a_transient_fault_retries_as_in_the_reference(tmp_path, W, site):
    """One fire at each site: the shared retry policy runs the step
    again, the epochs and the resumed results stay the reference's, and
    both registries count one fault and one retry."""
    job = _plain_job(20)
    results = []
    for run, faults_, side in ((_jrun, jfaults, "j"), (_trun, tfaults, "t")):
        faults_.REGISTRY.reset()
        with faults_.inject(site, n=1):
            first = run(job, W, str(tmp_path / side))
            again = run(job, W, str(tmp_path / side), resume=True)
        st = faults_.REGISTRY.stats()
        results.append((first, again, st["faults_injected"], st["retries"]))
    assert results[0] == results[1]
    assert results[1][2:] == (1, 1)
    assert results[1][1][1]["resume_skipped_ops"] == 1
    _assert_same_epochs(tmp_path)


@pytest.mark.parametrize("W", [1, 4])
def test_a_read_that_keeps_failing_recomputes_as_in_the_reference(tmp_path, W):
    job = _plain_job(20)
    want, got = _both(job, W, tmp_path)
    outs = []
    for run, faults_, side in ((_jrun, jfaults, "j"), (_trun, tfaults, "t")):
        faults_.REGISTRY.reset()
        with faults_.inject("ckpt.read", n=0):
            outs.append(run(job, W, str(tmp_path / side), resume=True))
        assert any(e.get("what") == "ckpt.restore_failed"
                   for e in faults_.REGISTRY.events)
    assert outs[0] == outs[1] and outs[1][0] == want[0]
    assert outs[1][1]["resume_skipped_ops"] == 0


@pytest.mark.parametrize("site", ["ckpt.write", "ckpt.manifest"])
def test_a_write_that_keeps_failing_raises_as_in_the_reference(tmp_path,
                                                               site):
    job = _plain_job(20)
    for run, faults_, side in ((_jrun, jfaults, "j"), (_trun, tfaults, "t")):
        with faults_.inject(site, n=0):
            with pytest.raises(faults_.InjectedFault):
                run(job, 2, str(tmp_path / side))
        # nothing was committed: a resume computes
        got = run(job, 2, str(tmp_path / side), resume=True)
        assert got[0] == list(range(20))
        assert got[1]["resume_skipped_ops"] == 0
