"""The dataflow over an object store: the port against the reference
package and against the same pipeline over ``file://``, at W = 1, 2, 4.

The pipelines of the reference's ``tests/vfs/test_object_store.py:
229-294`` on one object server (the port's) that serves both packages:
ReadLines -> Sort -> Checkpoint -> AllGather with the checkpoint
directory on the server, then the resume from the remote epoch;
ReadBinary of two objects; and the flaky server (5 % of requests answer
503). The port's results must be bit-equal to the reference's and to
the same pipeline over local files, and the port's ``remote_gets`` and
``remote_puts`` (each package's I/O ledger) the reference's, with the
readahead off (``THRILL_TPU_PREFETCH=0``) and at its default. Then the
stores above the vfs: an external host Sort whose run store is on the
server, resumed with every run reused (the reference's counters and
results), and a plan store on ``s3://`` through the REST transport whose
warm restart is the reference's. Nothing makes a local directory for a
remote path. The reference's 20 ms-a-request case runs here; its latency
sweep is ``slow``, as in the reference.
"""

import builtins
import dataclasses
import os

import numpy as np
import pytest

import jax
from thrill_tpu.api import Context as JContext
from thrill_tpu.common.config import Config as JConfig
from thrill_tpu.common.iostats import IO as JIO
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.common.config import Config as TConfig
from thrill_tpu_torch.common.iostats import IO as TIO
from thrill_tpu_torch.tools.object_server import ObjectServer

WIDTHS = [1, 2, 4]


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    for var in ("THRILL_TPU_OBJECT_STORE_ENDPOINT", "AWS_ENDPOINT_URL",
                "THRILL_TPU_OBJECT_STORE_PART", "THRILL_TPU_PREFETCH",
                "THRILL_TPU_CKPT_DIR", "THRILL_TPU_RESUME",
                "THRILL_TPU_PLAN_STORE", "THRILL_TPU_EM_RESUME"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("THRILL_TPU_RETRY_BASE_S", "0.005")
    # a stray local directory named after a scheme would show here
    monkeypatch.chdir(tmp_path)
    yield
    assert not [p for p in os.listdir(tmp_path) if p.endswith(":")]


def _run(side, W, job, **cfg):
    """(result, (remote_gets, remote_puts)) of ``job`` on one package."""
    io = JIO if side == "j" else TIO
    s0 = io.snapshot()
    resume = cfg.pop("resume", False)
    if side == "j":
        ctx = JContext(JMeshExec(devices=jax.devices("cpu")[:W]),
                       config=JConfig(**cfg), resume=resume)
        try:
            out = job(ctx)
        finally:
            ctx.close()
    else:
        out = tt.Run(job, W, device="cpu", config=TConfig(**cfg),
                     resume=resume)
    s1 = io.snapshot()
    return out, (s1["remote_gets"] - s0["remote_gets"],
                 s1["remote_puts"] - s0["remote_puts"])


def _seed_lines(srv, n=400, shards=4):
    lines = [f"line-{(i * 7919) % n:06d}" for i in range(n)]
    per = n // shards
    for s in range(shards):
        body = "\n".join(lines[s * per:(s + 1) * per]) + "\n"
        srv.put(f"b/input-{s:02d}.txt", body.encode())
    return sorted(lines)


def _to_disk(srv, root):
    for k, v in srv.objects.items():
        p = root / k
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(v)


def _pipeline(glob_url):
    def job(ctx):
        return ctx.ReadLines(glob_url).Sort().Checkpoint().AllGather()
    return job


@pytest.mark.parametrize("prefetch", ["0", "4"])
@pytest.mark.parametrize("W", WIDTHS)
def test_read_sort_checkpoint_over_http(W, prefetch, tmp_path, monkeypatch):
    """The flagship pipeline at 20 ms a request, its checkpoint epoch on
    the server, then resumed from it: bit-equal to the reference and to
    ``file://``, with the reference's requests."""
    monkeypatch.setenv("THRILL_TPU_PREFETCH", prefetch)
    with ObjectServer(latency_s=0.02) as srv:
        expect = _seed_lines(srv)
        _to_disk(srv, tmp_path / "in")
        glob_url = f"{srv.url}/b/input-*"
        got = {}
        for side in ("j", "t"):
            got[side] = _run(side, W, _pipeline(glob_url),
                             ckpt_dir=f"{srv.url}/b/ck-{side}")
        local, _ = _run("t", W, _pipeline(str(tmp_path / "in/b/input-*")),
                        ckpt_dir=str(tmp_path / "ck"))
        assert got["t"][0] == got["j"][0] == local == expect
        assert got["t"][1] == got["j"][1]
        assert got["t"][1][0] >= 4 and got["t"][1][1] >= W + 1
        for side in ("j", "t"):
            keys = sorted(k[len(f"b/ck-{side}/"):] for k in srv.objects
                          if k.startswith(f"b/ck-{side}/"))
            got[side + "keys"] = keys
        assert got["tkeys"] == got["jkeys"]
        assert any(k.startswith("epoch_") for k in got["tkeys"])
        # the shards and the manifest are the reference's bytes
        for k in got["tkeys"]:
            assert srv.objects[f"b/ck-t/{k}"] == srv.objects[f"b/ck-j/{k}"], k
        resumed = {side: _run(side, W, _pipeline(glob_url),
                              ckpt_dir=f"{srv.url}/b/ck-{side}", resume=True)
                   for side in ("j", "t")}
        assert resumed["t"][0] == resumed["j"][0] == expect
        assert resumed["t"][1] == resumed["j"][1]


@pytest.mark.slow
@pytest.mark.parametrize("latency_ms", [5, 20, 50])
def test_latency_sweep_read_sort_checkpoint(latency_ms):
    with ObjectServer(latency_s=latency_ms / 1e3) as srv:
        expect = _seed_lines(srv)
        got, _ = _run("t", 2, _pipeline(f"{srv.url}/b/input-*"),
                      ckpt_dir=f"{srv.url}/b/ck")
        assert got == expect


@pytest.mark.parametrize("prefetch", ["0", "4"])
@pytest.mark.parametrize("W", WIDTHS)
def test_readbinary_over_http(W, prefetch, tmp_path, monkeypatch):
    monkeypatch.setenv("THRILL_TPU_PREFETCH", prefetch)
    arr = np.arange(3000, dtype=np.int64) * 7 - 1000
    with ObjectServer() as srv:
        srv.put("b/data-00.bin", arr[:1100].tobytes())
        srv.put("b/data-01.bin", arr[1100:].tobytes())
        _to_disk(srv, tmp_path / "in")

        def job(pattern):
            def run(ctx):
                return [int(x) for x in ctx.ReadBinary(
                    pattern, dtype=np.int64).AllGather()]
            return run
        j = _run("j", W, job(f"{srv.url}/b/data-*"))
        t = _run("t", W, job(f"{srv.url}/b/data-*"))
        local, _ = _run("t", W, job(str(tmp_path / "in/b/data-*")))
        assert t[0] == j[0] == local == arr.tolist()
        assert t[1] == j[1] and t[1][1] == 0


@pytest.mark.parametrize("W", WIDTHS)
def test_flaky_server_e2e(W):
    """5 % of requests answer 503: the pipeline completes bit-correct
    through the shared retry policy, on both packages."""
    with ObjectServer() as srv:
        expect = _seed_lines(srv, n=200, shards=2)
        srv.set_fail_rate(0.05, seed=11)

        def job(ctx):
            return ctx.ReadLines(f"{srv.url}/b/input-*").Sort().AllGather()
        for side in ("j", "t"):
            r0 = srv.stats()["requests"]
            assert _run(side, W, job)[0] == expect
            assert srv.stats()["requests"] > r0


@pytest.mark.parametrize("W", WIDTHS)
def test_remote_run_store_resumes_every_run(W, monkeypatch):
    """An external host Sort (runs of 100 items) with its checkpoint
    directory, so its run store, on the server: the bins and manifests
    are the reference's objects, and the resume reuses every run."""
    monkeypatch.setenv("THRILL_TPU_HOST_SORT_RUN", "100")
    data = [(f"k{(i * 7919) % 1200:05d}", float(i)) for i in range(1200)]

    def job(ctx):
        out = ctx.Distribute(data, storage="host").Sort(
            key_fn=lambda t: t[0]).AllGather()
        return out, ctx.overall_stats().get("resume_skipped_runs")

    def runs(side):
        io = JIO if side == "j" else TIO
        return io.snapshot()["spill_runs"], io.snapshot()["runs_reused"]

    with ObjectServer() as srv:
        out = {}
        for side in ("j", "t"):
            r0 = runs(side)
            res = _run(side, W, job, ckpt_dir=f"{srv.url}/b/ck-{side}")
            r1 = runs(side)
            out[side] = res, (r1[0] - r0[0], r1[1] - r0[1])
        assert out["t"] == out["j"]
        (res, reqs), (formed, reused) = out["t"]
        assert res[0] == sorted(data, key=lambda t: t[0])
        assert formed > 1 and reused == 0
        keys = {side: sorted(k.split("/", 3)[3] for k in srv.objects
                             if k.startswith(f"b/ck-{side}/em_runs/"))
                for side in ("j", "t")}
        # the reference's adoption record is local-only too
        assert keys["t"] == keys["j"] and len(
            [k for k in keys["t"] if k.endswith(".json")]) == formed
        for k in keys["t"]:
            assert srv.objects[f"b/ck-t/em_runs/{k}"] == \
                srv.objects[f"b/ck-j/em_runs/{k}"], k
        again = {}
        for side in ("j", "t"):
            r0 = runs(side)
            res = _run(side, W, job, ckpt_dir=f"{srv.url}/b/ck-{side}",
                       resume=True)
            r1 = runs(side)
            again[side] = res, (r1[0] - r0[0], r1[1] - r0[1])
        assert again["t"] == again["j"]
        (res, _), counts = again["t"]
        assert res == (out["t"][0][0][0], formed)
        assert counts == (0, formed)


def _kv(x):
    return x % 7, x


def _add(a, b):
    return a + b


@pytest.mark.parametrize("W", WIDTHS)
def test_plan_store_on_s3_warm_restart(W, monkeypatch):
    """A plan store on ``s3://`` (the REST transport): a second Context
    of the pipeline plans from the stored state as the reference's does
    over the same server."""
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    real_import = builtins.__import__

    def no_boto3(name, *a, **kw):
        if name == "boto3":
            raise ImportError("no boto3")
        return real_import(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_boto3)
    keys = ("plan_builds", "plan_store_hits", "exchanges")

    def run(side, store):
        if side == "t":
            ctx = tt.Context(num_workers=W, device="cpu", config=dataclasses.
                             replace(TConfig.from_env(), plan_store=store))
        else:
            ctx = JContext(JMeshExec(devices=jax.devices("cpu")[:W]),
                           dataclasses.replace(JConfig.from_env(),
                                               plan_store=store))
        res = sorted((int(k), int(v)) for k, v in ctx.Distribute(
            np.arange(128, dtype=np.int64)).Map(_kv).ReducePair(
                _add).AllGather())
        s = ctx.overall_stats()
        ctx.close()
        return res, {k: s[k] for k in keys}

    with ObjectServer() as srv:
        monkeypatch.setenv("THRILL_TPU_OBJECT_STORE_ENDPOINT", srv.url)
        out = {}
        for side in ("j", "t"):
            cold = run(side, f"s3://b/plans-{side}")
            warm = run(side, f"s3://b/plans-{side}")
            out[side] = cold, warm
        assert out["t"] == out["j"]
        assert "b/plans-t/plans.json" in srv.objects
        if W > 1:
            assert out["t"][1][1]["plan_builds"] == 0
            assert out["t"][1][1]["plan_store_hits"] > 0
