"""The plan store (``thrill_tpu_torch/service/plan_store.py``) against
the reference package on the CPU: the single-controller cases of the
reference's ``tests/service/test_plan_store.py``.

Tolerance: results are compared exactly (sorted item lists of ints);
``plan_builds``, ``plan_store_hits``, ``exchanges_overlapped`` and the
cache counters equal the reference's on the warm restart. Each package
writes and reads its own store (their digests differ by design).
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax
from thrill_tpu.api import Context as JContext
from thrill_tpu.common import faults as jfaults
from thrill_tpu.common.config import Config as JConfig
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.common import faults
from thrill_tpu_torch.common.config import Config
from thrill_tpu_torch.data.exchange import _ident_digest
from thrill_tpu_torch.service.plan_store import (STORE_VERSION, PlanStore,
                                                 install_entries)

WS = [1, 2, 4]
KEYS = ("plan_builds", "plan_store_hits", "exchanges_overlapped",
        "exchanges", "cap_cache_hits", "cap_cache_misses",
        "device_fetches")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    for var in (faults.ENV_VAR, "THRILL_TPU_PLAN_STORE",
                "THRILL_TPU_PLANNER"):
        monkeypatch.delenv(var, raising=False)
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()
    yield
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()


def _kv(x):
    return (x % 11, x)


def _add(a, b):
    return a + b


def _wc(ctx):
    """A WordCount-shaped pipeline: a hash exchange and a pre-shuffle
    verdict, both data-driven plan builds."""
    return sorted((int(k), int(v)) for k, v in ctx.Distribute(
        np.arange(128, dtype=np.int64)).Map(_kv).ReducePair(
            _add).AllGather())


def _run(pkg, td, W=2, runs=1):
    if pkg == "port":
        ctx = tt.Context(num_workers=W, device="cpu", config=dataclasses.
                         replace(Config.from_env(), plan_store=str(td)))
    else:
        ctx = JContext(JMeshExec(devices=jax.devices("cpu")[:W]),
                       dataclasses.replace(JConfig.from_env(),
                                           plan_store=str(td)))
    results = [_wc(ctx) for _ in range(runs)]
    s = ctx.overall_stats()
    ctx.close()
    return results, {k: s[k] for k in KEYS}


@pytest.mark.parametrize("W", WS)
def test_warm_restart_is_the_reference_s(W, tmp_path):
    """A second Context of the same pipeline builds no plan: the first
    exchange runs on the stored capacities with no host read of its send
    matrix. Results and counters equal the reference's."""
    out = {}
    for pkg in ("port", "ref"):
        td = tmp_path / pkg
        cold_res, cold = _run(pkg, td, W, runs=2)
        warm_res, warm = _run(pkg, td, W)
        assert warm_res[0] == cold_res[0] == cold_res[1]
        out[pkg] = (cold_res[0], cold, warm)
    assert out["port"] == out["ref"]
    warm = out["port"][2]
    if W > 1:
        assert warm["plan_builds"] == 0 and warm["plan_store_hits"] > 0
        assert warm["exchanges_overlapped"] == warm["exchanges"] >= 1
        assert warm["cap_cache_misses"] == 0
    assert os.path.exists(tmp_path / "port" / "plans.json")


def test_warm_restart_fewer_host_syncs_before_first_result(tmp_path):
    ctx = tt.Context(num_workers=2, device="cpu",
                     config=Config(plan_store=str(tmp_path)))
    _wc(ctx)
    cold_first = ctx.mesh_exec.stats_fetches
    _wc(ctx)
    ctx.close()
    ctx = tt.Context(num_workers=2, device="cpu",
                     config=Config(plan_store=str(tmp_path)))
    _wc(ctx)
    assert ctx.mesh_exec.stats_fetches < cold_first
    ctx.close()


def test_corrupt_store_starts_cold_with_a_log_line(tmp_path, capsys):
    _run("port", tmp_path)
    (tmp_path / "plans.json").write_bytes(b"{ this is not json")
    base = faults.REGISTRY.stats()["recoveries"]
    results, stats = _run("port", tmp_path)
    assert "plan store" in capsys.readouterr().err
    assert faults.REGISTRY.stats()["recoveries"] > base
    assert stats["plan_store_hits"] == 0 and stats["plan_builds"] >= 1
    fresh = tt.Context(num_workers=2, device="cpu")
    assert results[0] == _wc(fresh)
    fresh.close()
    # the close wrote a valid store again: the next restart is warm
    results2, stats2 = _run("port", tmp_path)
    assert stats2["plan_builds"] == 0 and results2[0] == results[0]


def test_corrupt_store_records_a_store_skip(tmp_path):
    _run("port", tmp_path)
    (tmp_path / "plans.json").write_bytes(b"[]")
    ctx = tt.Context(num_workers=2, device="cpu",
                     config=Config(plan_store=str(tmp_path)))
    recs = [d for d in ctx.decisions.snapshot() if d["kind"] == "store_skip"]
    ctx.close()
    assert recs and "corrupt" in recs[0]["reason"]


def test_version_skew_is_refused_wholesale(tmp_path):
    _run("port", tmp_path)
    path = tmp_path / "plans.json"
    payload = json.loads(path.read_bytes())
    assert payload["version"] == STORE_VERSION
    payload["version"] = STORE_VERSION + 999
    path.write_bytes(json.dumps(payload).encode())
    _, stats = _run("port", tmp_path)
    assert stats["plan_store_hits"] == 0 and stats["plan_builds"] >= 1


def test_crc_mismatch_is_corrupt(tmp_path):
    _run("port", tmp_path)
    path = tmp_path / "plans.json"
    payload = json.loads(path.read_bytes())
    payload["crc"] = (payload["crc"] + 1) & 0xFFFFFFFF
    path.write_bytes(json.dumps(payload).encode())
    store = PlanStore(str(tmp_path))
    assert store.load() == {}
    assert "CRC" in store._last_corrupt


def test_injected_corrupt_site_degrades(tmp_path):
    _run("port", tmp_path)
    with faults.inject("service.plan_store.corrupt", n=1, seed=5):
        results, stats = _run("port", tmp_path)
    assert stats["plan_store_hits"] == 0 and stats["plan_builds"] >= 1
    assert faults.REGISTRY.stats()["faults_injected"] >= 1
    fresh = tt.Context(num_workers=2, device="cpu")
    assert results[0] == _wc(fresh)
    fresh.close()


class _Mex:
    num_workers = 2
    _sticky_caps = {("site_a",): (4, 8)}
    _xchg_plan = {("site_a",): "dense"}


def test_save_merges_and_ratchets_capacities(tmp_path):
    """Two savers sharing one store only ratchet capacities and keep
    each other's digests; keys carry the mesh width, and a mesh of
    another width installs none of them."""
    store = PlanStore(str(tmp_path))
    store.save(_Mex())
    m2 = _Mex()
    m2._sticky_caps = {("site_a",): (16, 4), ("site_b",): (2, 2)}
    m2._xchg_plan = {("site_a",): "dense", ("site_b",): "sync"}
    store.save(m2)
    entries = store.load()
    assert entries["caps"]["w2:" + _ident_digest(("site_a",))] == [16, 8]
    assert entries["caps"]["w2:" + _ident_digest(("site_b",))] == [2, 2]
    assert entries["plan"]["w2:" + _ident_digest(("site_b",))] == "sync"

    class _Mex3(_Mex):
        num_workers = 3
        _sticky_caps = {("site_c",): (1, 1, 1)}
        _xchg_plan = {}

    m3 = _Mex3()
    assert install_entries(m3, entries) == 0
    store.save(m3)
    entries = store.load()
    assert entries["caps"]["w2:" + _ident_digest(("site_a",))] == [16, 8]
    assert entries["caps"]["w3:" + _ident_digest(("site_c",))] == [1, 1, 1]


def test_unconsumed_seeds_survive_a_save_cycle(tmp_path):
    _run("port", tmp_path)
    ctx = tt.Context(num_workers=2, device="cpu",
                     config=Config(plan_store=str(tmp_path)))
    ctx.close()                       # runs nothing, saves
    _, stats = _run("port", tmp_path)
    assert stats["plan_builds"] == 0


@pytest.mark.parametrize("scheme", ["s3", "http"])
def test_a_remote_store_saves_and_warms_a_restart(scheme, tmp_path,
                                                  monkeypatch):
    """A store on an object server (``s3://`` through the REST transport,
    or ``http://``): the save lands as one object, last writer wins
    without a lock, and a warm restart builds no plan, as over a local
    directory; no local directory is made for the URL."""
    import builtins

    from thrill_tpu_torch.tools.object_server import ObjectServer
    real_import = builtins.__import__

    def no_boto3(name, *a, **kw):
        if name == "boto3":
            raise ImportError("no boto3")
        return real_import(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_boto3)
    monkeypatch.chdir(tmp_path)
    with ObjectServer() as srv:
        monkeypatch.setenv("THRILL_TPU_OBJECT_STORE_ENDPOINT", srv.url)
        path = "s3://b/plans" if scheme == "s3" else f"{srv.url}/b/plans"
        cold_res, cold = _run("port", path, runs=2)
        assert "b/plans/plans.json" in srv.objects
        assert PlanStore(path).load()["caps"]
        warm_res, warm = _run("port", path)
        assert warm_res[0] == cold_res[0]
        assert warm["plan_builds"] == 0 and warm["plan_store_hits"] > 0
        local_res, local = _run("port", tmp_path / "local", runs=2)
        assert local_res == cold_res and local == cold
    assert os.listdir(tmp_path) == ["local"]


def test_env_names_the_store(tmp_path, monkeypatch):
    monkeypatch.setenv("THRILL_TPU_PLAN_STORE", str(tmp_path))
    assert Config.from_env().plan_store == str(tmp_path)
    ctx = tt.Context(num_workers=2, device="cpu")
    assert ctx.plan_store is not None
    _wc(ctx)
    ctx.close()
    assert (tmp_path / "plans.json").exists()
