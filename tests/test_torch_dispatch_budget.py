"""The exchange's part of the dispatch budget against the reference
package on the CPU: the counterpart of the exchange cases of the
reference's ``tests/api/test_dispatch_budget.py``, as counts equal to
the reference's at W = 1, 2 and 4.

Tolerance: counts are compared exactly; results exactly, except the
PageRank and k-means ranks and centres, compared to 1e-12 relative (the
reference's float sums are unordered).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from thrill_tpu.api import Context as JContext
from thrill_tpu.api import FieldReduce as JFieldReduce
from thrill_tpu.data import exchange as jex
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.data import exchange as ex
from thrill_tpu_torch.examples import k_means as tkm
from thrill_tpu_torch.examples import page_rank as tpr

WS = [1, 2, 4]
_REF_EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    for var in ("THRILL_TPU_XCHG_CAP_CACHE", "THRILL_TPU_OVERLAP",
                "THRILL_TPU_EXCHANGE", "THRILL_TPU_XCHG_NARROW",
                "THRILL_TPU_LOOP_REPLAY"):
        monkeypatch.delenv(var, raising=False)


def _ref_example(name):
    if _REF_EXAMPLES not in sys.path:
        sys.path.insert(0, _REF_EXAMPLES)
    return __import__(name)


def _make(pkg, W):
    if pkg == "port":
        return tt.Context(num_workers=W, device="cpu")
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]))


def _snap(mex):
    return (mex.stats_dispatches, mex.stats_fetches)


def _delta(a, b):
    return tuple(y - x for x, y in zip(a, b))


def _xk(t):
    return t["k"]


@pytest.mark.parametrize("W", WS)
def test_exchange_overlap_budget(W):
    """A repeated ReduceByKey: the first run plans from the send matrix,
    the next four run on the cached plan. Every run's dispatches and
    counted fetches equal the reference's; at W > 1 the steady runs make
    no counted fetch at all."""
    vals = np.random.default_rng(11).integers(0, 64, 4096).astype(np.int64)
    out = {}
    for pkg in ("port", "ref"):
        ctx = _make(pkg, W)
        mex = ctx.mesh_exec
        red = (tt.FieldReduce if pkg == "port" else JFieldReduce)(
            {"k": "first", "c": "sum"})
        runs, res = [], None
        for _ in range(5):
            s0 = _snap(mex)
            sh = ctx.Distribute({"k": vals, "c": np.ones_like(vals)}
                                ).ReduceByKey(_xk, red).node.materialize()
            runs.append(_delta(s0, _snap(mex)))
            g = sh.to_global_numpy()
            res = sorted(zip(np.asarray(g["k"]).tolist(),
                             np.asarray(g["c"]).tolist()))
        s = ctx.overall_stats()
        out[pkg] = (runs, res, s["exchanges_overlapped"],
                    s["cap_cache_hits"], s["cap_cache_misses"])
        ctx.close()
    assert out["port"] == out["ref"]
    if W > 1:
        runs, _, overlapped, hits, misses = out["port"]
        assert all(f == 0 for _, f in runs[1:])
        assert overlapped == hits == 4 and misses == 0


@pytest.mark.parametrize("W", WS)
def test_pagerank_full_run_budget(W):
    """A warm four-iteration PageRank (the plain loop): its counted
    fetches equal the reference's, and the ranks agree."""
    monkey = os.environ.get("THRILL_TPU_LOOP_REPLAY")
    os.environ["THRILL_TPU_LOOP_REPLAY"] = "0"
    try:
        jpr = _ref_example("page_rank")
        edges = tpr.zipf_graph(512, 4096)
        out = {}
        for pkg, mod in (("port", tpr), ("ref", jpr)):
            ctx = _make(pkg, W)
            mod.page_rank(ctx, edges, 512, iterations=4)   # warm
            s0 = _snap(ctx.mesh_exec)
            got = np.asarray(mod.page_rank(ctx, edges, 512, iterations=4))
            out[pkg] = (_delta(s0, _snap(ctx.mesh_exec))[1], got)
            ctx.close()
    finally:
        if monkey is None:
            os.environ.pop("THRILL_TPU_LOOP_REPLAY", None)
        else:
            os.environ["THRILL_TPU_LOOP_REPLAY"] = monkey
    assert out["port"][0] == out["ref"][0]
    np.testing.assert_allclose(out["port"][1], out["ref"][1], rtol=1e-12)


@pytest.mark.parametrize("W", WS)
def test_kmeans_full_run_fetches(W):
    """A warm three-iteration k-means: counted fetches equal the
    reference's."""
    jkm = _ref_example("k_means")
    pts = np.random.default_rng(0).random((2048, 8))
    out = {}
    for pkg, mod in (("port", tkm), ("ref", jkm)):
        ctx = _make(pkg, W)
        mod.k_means(ctx, pts, 4, iterations=3, seed=3)        # warm
        s0 = _snap(ctx.mesh_exec)
        got = np.asarray(mod.k_means(ctx, pts, 4, iterations=3, seed=3))
        out[pkg] = (_delta(s0, _snap(ctx.mesh_exec))[1], got)
        ctx.close()
    assert out["port"][0] == out["ref"][0]
    np.testing.assert_allclose(out["port"][1], out["ref"][1], rtol=1e-12)


@pytest.mark.parametrize("W", [2, 4])
def test_bytes_wire_device_is_the_reference_s(W):
    """A ReduceByKey's padded phase-B bytes: the dense plan's W (W - 1)
    M_pad rows times the item bytes, in both packages: equal to the
    reference's for one padded row (a CPU mesh rounds M_pad as the
    reference, the card by ``exchange.round_cap``)."""
    vals = np.arange(2048, dtype=np.int64)
    got = {}
    for pkg in ("port", "ref"):
        ctx = _make(pkg, W)
        red = (tt.FieldReduce if pkg == "port" else JFieldReduce)(
            {"k": "first", "c": "sum"})
        ctx.Distribute({"k": vals, "c": np.ones_like(vals)}).ReduceByKey(
            _xk, red).node.materialize()
        s = ctx.overall_stats()
        m_pad = [v[0] for k, v in ctx.mesh_exec._sticky_caps.items()
                 if k[0] == "xchg_caps"]
        assert len(m_pad) == 1
        got[pkg] = (s["bytes_wire_device"] / m_pad[0],
                    s["bytes_wire_device_raw"] / m_pad[0])
        ctx.close()
    assert got["port"] == got["ref"]
    # full width 16 bytes an item (two int64 columns), narrowed below it
    assert got["port"][1] == W * (W - 1) * 16 > got["port"][0]


def test_onefactor_narrowed_bytes_lower(monkeypatch):
    """The 1-factor plan with learned narrow specs copies fewer bytes
    than the same plan at full width; the raw counter keeps the full
    width; rows bit-equal; the narrowed share of the bytes equal to the
    reference's."""
    def run(pkg, narrow):
        monkeypatch.setenv("THRILL_TPU_XCHG_NARROW", narrow)
        monkeypatch.setenv("THRILL_TPU_EXCHANGE", "onefactor")
        ctx = _make(pkg, 4)
        vals = (np.arange(6000, dtype=np.int64) * 11) % 1000
        outs = []
        for _ in range(2):
            shards = ctx.Distribute({"k": vals}).node.materialize()
            if pkg == "port":
                out = ex.exchange(shards, lambda t, m, w: torch.remainder(
                    t["k"], 4), ("of_narrow_budget",))
            else:
                out = jex.exchange(shards, lambda t, m, w: (
                    t["k"] % 4).astype(jnp.int32), ("of_narrow_budget",))
            outs.append([np.asarray(t["k"]) for t in out.to_worker_arrays()])
        s = ctx.overall_stats()
        ctx.close()
        return outs, (s["bytes_wire_device"], s["bytes_wire_device_raw"])

    on, won = run("port", "1")
    off, woff = run("port", "0")
    ref, wref = run("ref", "1")
    for a, b, c in zip(on, off, ref):
        for ta, tb, tc in zip(a, b, c):
            assert np.array_equal(ta, tb) and np.array_equal(ta, tc)
    assert won[0] < woff[0] == won[1] == woff[1]
    assert won[0] / won[1] == wref[0] / wref[1]
