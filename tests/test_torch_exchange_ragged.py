"""The ragged exchange (``THRILL_TPU_EXCHANGE=ragged``,
``thrill_tpu_torch/data/exchange.py`` ``_exchange_ragged``) against the
reference package on the CPU.

XLA:CPU cannot run the reference's ``lax.ragged_all_to_all``, so the
port's ragged results are held against the reference's dense results
(its own docstring gives both paths one order: by sender in rank order),
and the ragged plan's bookkeeping against the reference's: its
``_exchange_ragged`` counts the bytes and records the decision before
its program fails to compile here, so those counters are read from the
failed reference call on the same data.

Tolerance: none, except PageRank's f64 ranks against the reference,
within 1e-12 as every cross-package PageRank test (ROADMAP.md fault
C15); the port's ragged ranks are bit-equal to its dense ones.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from thrill_tpu.api import Context as JContext
from thrill_tpu.api import FieldReduce as JFieldReduce
from thrill_tpu.api import InnerJoin as JInnerJoin
from thrill_tpu.api import Zip as JZip
from thrill_tpu.data import exchange as jex
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.data import exchange as ex

WS = [1, 2, 4]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    for var in ("THRILL_TPU_EXCHANGE", "THRILL_TPU_REDUCE_STREAM",
                "THRILL_TPU_XCHG_NARROW", "THRILL_TPU_SORT_FUSED"):
        monkeypatch.delenv(var, raising=False)


def _port(W):
    return tt.Context(num_workers=W, device="cpu")


def _ref(W):
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]))


def _ragged_port(W, monkeypatch):
    monkeypatch.setenv("THRILL_TPU_EXCHANGE", "ragged")
    ctx = _port(W)
    monkeypatch.delenv("THRILL_TPU_EXCHANGE")
    return ctx


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64),
            "small": rng.integers(0, 200, n).astype(np.int64),
            "f": rng.normal(size=n),
            "row": rng.integers(-3, 90, (n, 3)).astype(np.int32)}


def _arrays(shards):
    return [{k: np.asarray(v) for k, v in t.items()}
            for t in shards.to_worker_arrays()]


def _same(a, b):
    assert len(a) == len(b)
    for wa, wb in zip(a, b):
        assert wa.keys() == wb.keys()
        for k in wa:
            assert wa[k].dtype == wb[k].dtype, k
            assert np.array_equal(wa[k], wb[k]), k


def _exchange(ctx, cols, W, site=("ragged_direct",)):
    shards = ctx.Distribute(cols).node.materialize()
    if isinstance(ctx, tt.Context):
        return ex.exchange(shards, lambda t, m, w: torch.remainder(
            t["small"], W), site)
    return jex.exchange(shards, lambda t, m, w: (
        t["small"] % W).astype(jnp.int32), site)


def _ref_ragged_books(W, cols, monkeypatch):
    """The reference's ragged bookkeeping for one exchange of ``cols``:
    the device bytes, full-width bytes, plan builds, dispatches (its
    ragged program's counted before it runs) and counted fetches, and
    its strategy record, read after its program fails to compile on
    XLA:CPU (W = 1 moves nothing and runs)."""
    monkeypatch.setenv("THRILL_TPU_EXCHANGE", "ragged")
    ctx = _ref(W)
    monkeypatch.delenv("THRILL_TPU_EXCHANGE")
    try:
        _exchange(ctx, cols, W)
    except Exception as e:          # XLA:CPU lacks ragged-all-to-all
        assert "ragged" in str(e).lower()
    st = ctx.overall_stats()
    recs = [(d["kind"], d["chosen"], d["reason"])
            for d in ctx.decisions.snapshot()
            if d["kind"] == "xchg_strategy"]
    out = ({k: st[k] for k in ("bytes_wire_device", "bytes_wire_device_raw",
                               "plan_builds", "exchanges", "items_moved",
                               "device_dispatches", "device_fetches")},
           recs)
    ctx.close()
    return out


@pytest.mark.parametrize("W", WS + [3])
def test_ragged_exchange_rows_are_the_reference_dense_rows(W, monkeypatch):
    """Every receiver's rows by sender in rank order, each run in its
    sender's order: the reference's dense rows, and the port's dense
    ones, bit for bit."""
    cols = _columns(3000, W)
    ref = _ref(W)
    want = _arrays(_exchange(ref, cols, W))
    ref.close()
    dense = _port(W)
    _same(_arrays(_exchange(dense, cols, W)), want)
    dense.close()
    ctx = _ragged_port(W, monkeypatch)
    for _ in range(2):              # the plan is synced every time
        _same(_arrays(_exchange(ctx, cols, W)), want)
    st = ctx.overall_stats()
    assert st["cap_cache_hits"] == 0 and st["exchanges_overlapped"] == 0
    ctx.close()


@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("narrow", ["1", "0"])
def test_ragged_bytes_and_record_are_the_reference_s(W, narrow,
                                                     monkeypatch):
    """``bytes_wire_device`` is the off-diagonal items times the narrowed
    item bytes, ``_raw`` the same items at full width (the reference's
    formula, on the same send matrix: equal to its counters); the
    dispatches and counted fetches are the reference's; the strategy
    record says ragged, by configured mode, and the site's plan kind
    stays synced."""
    monkeypatch.setenv("THRILL_TPU_XCHG_NARROW", narrow)
    cols = _columns(4000, W + 10)
    want = _ref_ragged_books(W, cols, monkeypatch)
    ctx = _ragged_port(W, monkeypatch)
    _exchange(ctx, cols, W)
    st = ctx.overall_stats()
    got = ({k: st[k] for k in want[0]},
           [(d["kind"], d["chosen"], d["reason"])
            for d in ctx.decisions.snapshot()
            if d["kind"] == "xchg_strategy"])
    plans = dict(getattr(ctx.mesh_exec, "_xchg_plan", {}))
    ctx.close()
    assert got == want
    # the formula itself: off-diagonal items of S times the item bytes
    from thrill_tpu_torch.common.partition import dense_range_bounds
    dest = cols["small"] % W
    sender = np.searchsorted(dense_range_bounds(4000, W)[1:],
                             np.arange(4000), side="right")
    moved = int((dest != sender).sum())
    full = 8 + 8 + 8 + 12
    assert got[0]["bytes_wire_device_raw"] == moved * full
    if W > 1:
        assert got[1] == [("xchg_strategy", "ragged", "configured mode")]
        assert list(plans.values()) == ["sync"]
        if narrow == "1":
            assert got[0]["bytes_wire_device"] < moved * full
        else:
            assert got[0]["bytes_wire_device"] == moved * full


def _wkey(t):
    return t["w"]


def _wc(ctx, red_cls, W):
    rng = np.random.default_rng(W)
    w = (rng.zipf(1.3, 6000) % 900).astype(np.int64)
    return ctx.Distribute({"w": w, "c": np.ones_like(w)}).ReduceByKey(
        _wkey, red_cls({"w": "first", "c": "sum"})).node.materialize()


@pytest.mark.parametrize("W", WS)
def test_ragged_reduce_by_key_is_the_reference_s(W, monkeypatch):
    ref = _ref(W)
    want = _arrays(_wc(ref, JFieldReduce, W))
    ref.close()
    ctx = _ragged_port(W, monkeypatch)
    got = _arrays(_wc(ctx, tt.FieldReduce, W))
    ctx.close()
    _same(got, want)


@pytest.mark.parametrize("W", WS)
def test_ragged_pagerank_is_the_reference_s(W, monkeypatch):
    """ReduceToIndex's exchange under the ragged plan (PageRank): ranks
    bit-equal to the port's dense run, within 1e-12 of the
    reference's."""
    import os
    import sys
    from thrill_tpu_torch.examples import page_rank as tpr
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "examples"))
    import page_rank as jpr
    edges = tpr.zipf_graph(512, 4096)
    ref = _ref(W)
    want = np.asarray(jpr.page_rank(ref, edges, 512, iterations=4))
    ref.close()
    dense = _port(W)
    base = np.asarray(tpr.page_rank(dense, edges, 512, iterations=4))
    dense.close()
    ctx = _ragged_port(W, monkeypatch)
    got = np.asarray(tpr.page_rank(ctx, edges, 512, iterations=4))
    ctx.close()
    assert np.array_equal(got, base)
    assert np.abs(got - want).max() <= 1e-12


def _okey(t):
    return t["key"]


def _lkey(t):
    return t["orderkey"]


def _pair(o, li):
    return {"k": o["key"], "p": li["price"]}


@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("ld", [False, True])
def test_ragged_join_is_the_reference_s(W, ld, monkeypatch):
    from thrill_tpu_torch.examples import tpch as ttp
    orders, lineitem = ttp.generate_tables(600, 4, seed=W)

    def job(ctx, join):
        return join(ctx.Distribute(orders), ctx.Distribute(lineitem),
                    _okey, _lkey, _pair, location_detection=ld
                    ).node.materialize()

    ref = _ref(W)
    want = _arrays(job(ref, JInnerJoin))
    ref.close()
    ctx = _ragged_port(W, monkeypatch)
    got = _arrays(job(ctx, tt.InnerJoin))
    ctx.close()
    _same(got, want)


def _skey(t):
    return t["k"]


@pytest.mark.parametrize("W", WS)
def test_ragged_generic_sort_is_the_reference_s(W, monkeypatch):
    """Under ragged mode the Sort's fused path is off
    (``dense_all_to_all_applies``), as in the reference: the classified
    rows take the ragged exchange and a final merge; rows equal the
    reference's."""
    cols = _columns(3000, W + 20)

    def job(ctx):
        return ctx.Distribute(cols).Sort(key_fn=_skey).node.materialize()

    ref = _ref(W)
    want = _arrays(job(ref))
    ref.close()
    ctx = _ragged_port(W, monkeypatch)
    got = job(ctx)
    progs = {k[0] for k in ctx.mesh_exec._cache if isinstance(k, tuple)}
    got = _arrays(got)
    ctx.close()
    _same(got, want)
    if W > 1:
        assert "sort_final" in progs and "sort_fused" not in progs
        assert "xchg_ragged" in progs


@pytest.mark.parametrize("W", [2, 4])
def test_ragged_zip_and_rebalance_are_the_reference_s(W, monkeypatch):
    """Zip's realign and Rebalance take the ragged exchange too."""
    a = np.arange(70, dtype=np.int64)
    b = np.arange(100, 147, dtype=np.int64)    # 47: the filtered size

    def job(ctx, zip_):
        x = ctx.Distribute(a).Filter(lambda v: (v % 3 != 0) | (v < 3))
        z = zip_(x, ctx.Distribute(b), zip_fn=lambda u, t: {"u": u, "t": t})
        r = ctx.Distribute(a).Filter(lambda v: v > 50).Rebalance()
        return _arrays(z.node.materialize()), [
            np.asarray(x).tolist() for x in
            r.node.materialize().to_worker_arrays()]

    ref = _ref(W)
    want = job(ref, JZip)
    ref.close()
    ctx = _ragged_port(W, monkeypatch)
    got = job(ctx, tt.Zip)
    progs = {k[0] for k in ctx.mesh_exec._cache if isinstance(k, tuple)}
    ctx.close()
    _same(got[0], want[0])
    assert got[1] == want[1]
    assert "xchg_ragged" in progs
