"""Program stitching (``thrill_tpu_torch/api/fusion.py``) against the
reference package on the CPU.

Each case of the reference's ``tests/api/test_fusion.py`` runs at W = 1,
2 and 4 in both packages, stitched and with ``THRILL_TPU_FUSE=0``: the
results are equal item for item in all four runs, the stitched runs make
as many fused dispatches, of the same ops in the same stages, as the
reference's, and the per-op runs make none. The hinted join's overflow
cases are in ``test_torch_join.py``, the ladder's in
``test_torch_pressure.py``. ``THRILL_TPU_HOST_RADIX=0`` keeps the
reference on its jitted engines: its native CPU engine is a barrier, and
the port has none.
"""

import json
import types

import numpy as np
import pytest
import torch

import jax
from thrill_tpu.api import Context as JContext
from thrill_tpu.api import FieldReduce as JFieldReduce
from thrill_tpu.api import InnerJoin as JInnerJoin
from thrill_tpu.api.dia import Zip as JZip
from thrill_tpu.common import faults as jfaults
from thrill_tpu.common.config import Config as JConfig
from thrill_tpu.core import rowmove as jrowmove
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.common import faults
from thrill_tpu_torch.common.config import Config
from thrill_tpu_torch.core import rowmove

WS = [1, 2, 4]

PORT = types.SimpleNamespace(Zip=tt.Zip, InnerJoin=tt.InnerJoin,
                             FieldReduce=tt.FieldReduce)
REF = types.SimpleNamespace(Zip=JZip, InnerJoin=JInnerJoin,
                            FieldReduce=JFieldReduce)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    for var in ("THRILL_TPU_FUSE", faults.ENV_VAR, "THRILL_TPU_JOIN_RECOVER"):
        monkeypatch.delenv(var, raising=False)
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()
    yield
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()


def _port(W, config=None):
    return tt.Context(num_workers=W, device="cpu", config=config)


def _ref(W, config=None):
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]), config)


def _run(W, fuse, build, monkeypatch):
    """``build(ctx, ns)`` in both packages under ``THRILL_TPU_FUSE=fuse``:
    {package: (result, fused dispatches, fused ops, dispatches, stages)}."""
    monkeypatch.setenv("THRILL_TPU_FUSE", fuse)
    out = {}
    for name, ns, make in (("port", PORT, _port), ("ref", REF, _ref)):
        ctx = make(W)
        res = build(ctx, ns)
        mex = ctx.mesh_exec
        out[name] = (res, mex.stats_fused_dispatches, mex.stats_fused_ops,
                     mex.stats_dispatches, dict(mex.fused_stage_counts))
        ctx.close()
    return out


def _both_modes(W, build, monkeypatch):
    """Both packages, stitched and per op: equal results, the
    reference's fused counts, none per op. Returns the port's dispatches
    (stitched, per op) and the stitched runs."""
    fused = _run(W, "1", build, monkeypatch)
    plain = _run(W, "0", build, monkeypatch)
    pf, rf = fused["port"], fused["ref"]
    assert pf[0] == rf[0] == plain["port"][0] == plain["ref"][0]
    assert pf[1:3] == rf[1:3], (pf[1:3], rf[1:3])
    assert pf[4] == rf[4]
    assert pf[1] >= 1
    assert plain["port"][1:3] == plain["ref"][1:3] == (0, 0)
    assert plain["port"][4] == {}
    return pf[3], plain["port"][3], fused


def _k5(t):
    return t["k"]


def _mk(x):
    return {"k": x % 5, "v": x}


def _even(t):
    return t["v"] % 2 == 0


def _x3(x):
    return x * 3


def _idk(x):
    return x


def _addp(a, b):
    return a + b


def _items(got):
    return sorted(tuple((k, int(v)) for k, v in sorted(t.items()))
                  for t in got)


@pytest.mark.parametrize("W", WS)
def test_stack_reduce_chain_parity(W, monkeypatch):
    def build(ctx, ns):
        d = ctx.Distribute(np.arange(200, dtype=np.int64))
        r = d.Map(_mk).Filter(_even).ReduceByKey(
            _k5, ns.FieldReduce({"k": "first", "v": "sum"}))
        return _items(r.AllGather())

    df, du, fused = _both_modes(W, build, monkeypatch)
    assert df < du
    stage = ("Stack", "ReduceLocal")
    assert fused["port"][4][stage] == 1


@pytest.mark.parametrize("W", WS)
def test_prefix_zwi_sort_chain_parity(W, monkeypatch):
    def build(ctx, ns):
        d = ctx.Distribute(np.arange(100, dtype=np.int64))
        return [int(x) for x in d.Map(_x3).PrefixSum()
                .ZipWithIndex(lambda x, i: x + i).AllGather()]

    df, du, fused = _both_modes(W, build, monkeypatch)
    assert df < du
    assert fused["port"][4] == {("Stack", "PrefixSum", "ZipWithIndex"): 1}


@pytest.mark.parametrize("W", WS)
def test_filter_zipwithindex_positions(W, monkeypatch):
    """Indices follow the positions after the Filter, stitched or not
    (the segment takes them from the mask, not the layout)."""
    def build(ctx, ns):
        d = ctx.Distribute(np.arange(57, dtype=np.int64))
        return [(int(x), int(i)) for x, i in d.Filter(
            lambda x: x % 3 != 0).ZipWithIndex(lambda x, i: (x, i))
            .AllGather()]

    _, _, fused = _both_modes(W, build, monkeypatch)
    got = fused["port"][0]
    assert sorted(i for _, i in got) == list(range(len(got)))


def test_sort_w1_chain_single_dispatch(monkeypatch):
    vals = np.random.default_rng(0).integers(0, 1000, 500)
    per = {}
    for name, ctx in (("port", _port(1)), ("ref", _ref(1))):
        mex = ctx.mesh_exec

        def run():
            dd = ctx.Distribute(vals).Map(_x3).Sort(key_fn=lambda x: x)
            d0 = mex.stats_dispatches
            got = [int(x) for x in dd.AllGather()]
            return got, mex.stats_dispatches - d0

        run()                                       # warm
        per[name] = run()
        assert per[name][0] == sorted((vals * 3).tolist())
    # the stack and the sort, one program in both packages
    assert per["port"][1] == per["ref"][1] == 1


@pytest.mark.parametrize("W", WS)
def test_window_chain_parity(W, monkeypatch):
    def dev_win(t):
        return t.sum(axis=1)

    def build(ctx, ns):
        d = ctx.Distribute(np.arange(64, dtype=np.int64))
        return [int(x) for x in d.Map(_x3).Window(
            4, fn=lambda i, w: sum(w), device_fn=dev_win).AllGather()]

    df, du, fused = _both_modes(W, build, monkeypatch)
    assert df <= du
    assert fused["port"][4] == {("Stack", "Window"): 1}


@pytest.mark.parametrize("W", WS)
def test_zip_downstream_fusion_parity(W, monkeypatch):
    def build(ctx, ns):
        a = ctx.Distribute(np.arange(40, dtype=np.int64))
        b = ctx.Distribute(np.arange(40, dtype=np.int64) * 2)
        z = ns.Zip(a, b, zip_fn=lambda x, y: x + y)
        return [int(x) for x in z.Map(_x3).PrefixSum().AllGather()]

    df, du, fused = _both_modes(W, build, monkeypatch)
    assert df < du
    assert fused["port"][4] == {("Zip", "Stack", "PrefixSum"): 1}


@pytest.mark.parametrize("W", WS)
def test_filter_reduce_to_index_chain_parity(W, monkeypatch):
    """ReduceToIndex's dense phase stitched after a Filter: at W = 1 over
    the chain's mask (the counts unknown), after the exchange over the
    exchange's host-known valid rows."""
    def build(ctx, ns):
        n = np.arange(300, dtype=np.int64)
        d = ctx.Distribute({"i": n % 37, "v": (n * 0.25).astype(np.float32),
                            "n": n})
        r = d.Filter(lambda t: t["n"] % 3 != 0).ReduceToIndex(
            lambda t: t["i"],
            ns.FieldReduce({"i": "first", "v": "sum", "n": "max"}), 40,
            neutral={"i": 0, "v": 0.0, "n": -1})
        return [(int(t["i"]), float(t["v"]), int(t["n"]))
                for t in r.AllGather()]

    df, du, fused = _both_modes(W, build, monkeypatch)
    # at W > 1 the exchange parts them: two programs either way
    assert df < du if W == 1 else df == du
    want = {1: {("Stack", "ReduceToIndex"): 1}}.get(
        W, {("Stack",): 1, ("ReduceToIndex",): 1})
    assert fused["port"][4] == want


@pytest.mark.parametrize("W", WS)
def test_hinted_join_fused_single_dispatch_and_chain(W, monkeypatch):
    """The hinted join's two phases are one program, and the ops after
    it run in the same one (at W = 1 the whole pipeline is one
    dispatch)."""
    disp = {}

    def build(ctx, ns):
        mex = ctx.mesh_exec

        def run():
            l = ctx.Distribute(np.arange(32, dtype=np.int64))
            r = ctx.Distribute(np.arange(16, 48, dtype=np.int64))
            j = ns.InnerJoin(l, r, _idk, _idk, _addp, out_size_hint=32)
            d0 = mex.stats_dispatches
            got = sorted(int(x) for x in j.Map(_x3).AllGather())
            return got, mex.stats_dispatches - d0

        run()                                       # warm
        got, disp[ns is PORT] = run()
        assert got == sorted((x + x) * 3 for x in range(16, 32))
        assert mex.stats_join_overflow_retries == 0
        return got

    _both_modes(W, build, monkeypatch)
    if W == 1:
        _run(W, "1", build, monkeypatch)
        assert disp[True] == disp[False] == 1


@pytest.mark.parametrize("W", [2, 4])
def test_keep_prevents_deferral(W, monkeypatch):
    """A node with two consumers materializes: stitching it into one
    would lose its result for the other."""
    def build(ctx, ns):
        base = ctx.Distribute(np.arange(30, dtype=np.int64)).Map(
            _x3).Cache().Keep(1)
        a = [int(x) for x in base.PrefixSum().AllGather()]
        b = [int(x) for x in base.PrefixSum().AllGather()]
        assert a == b
        return a, base.node.state

    _, _, fused = _both_modes(W, build, monkeypatch)
    assert fused["port"][0][1] == fused["ref"][0][1] == "DISPOSED"


@pytest.mark.parametrize("W", [2, 4])
def test_fused_stats_and_log_events(W, monkeypatch, tmp_path):
    stats, events = {}, {}
    for name, make, cfg in (("port", _port, Config), ("ref", _ref, JConfig)):
        log = tmp_path / f"{name}.json"
        ctx = make(W, cfg(log_path=str(log)))
        d = ctx.Distribute(np.arange(64, dtype=np.int64))
        ns = PORT if name == "port" else REF
        d.Map(_mk).ReduceByKey(_k5, ns.FieldReduce(
            {"k": "first", "v": "sum"})).AllGather()
        stats[name] = ctx.overall_stats()
        ctx.close()
        evs = [json.loads(l) for l in
               (tmp_path / f"{name}-host0.json").read_text().splitlines()
               if l.strip()]
        events[name] = [e["ops"] for e in evs
                        if e.get("event") == "fused_dispatch"]
    for s in stats.values():
        assert s["fused_dispatches"] >= 1
        assert s["fused_ops"] >= s["fused_dispatches"]
    for k in ("fused_dispatches", "fused_ops", "fused_stages"):
        assert stats["port"][k] == stats["ref"][k]
    assert events["port"] == events["ref"]
    assert all(isinstance(ops, list) for ops in events["port"])


@pytest.mark.parametrize("W", WS)
def test_fuse_fault_site_recovers(W):
    """A transient fault at a stitched op's site retries the (pure)
    program, and the pipeline's result is exact."""
    want = {}
    for x in range(100):
        if x % 2 == 0:
            want[x % 5] = want.get(x % 5, 0) + x
    injected = []
    for ns, make, reg in ((PORT, _port, faults.REGISTRY),
                          (REF, _ref, jfaults.REGISTRY)):
        reg.reset()
        ctx = make(W)
        # n=1 per matched site: a k-segment chain fires k times, within
        # the 4-attempt budget
        with faults.inject("api.fuse.*", n=1, seed=3):
            d = ctx.Distribute(np.arange(100, dtype=np.int64))
            got = d.Map(_mk).Filter(_even).ReduceByKey(
                _k5, ns.FieldReduce({"k": "first", "v": "sum"})).AllGather()
        assert sorted((int(t["k"]), int(t["v"])) for t in got) \
            == sorted(want.items())
        injected.append(reg.injected)
        ctx.close()
    assert injected[0] == injected[1] >= 1


def test_take_rows_multi_parity(monkeypatch):
    """The payload gathers move every leaf like a per-leaf take."""
    monkeypatch.setenv("THRILL_TPU_PACK_MOVE", "1")
    rng = np.random.default_rng(1)
    n = 64
    leaves = [
        rng.integers(0, 256, size=(n, 10)).astype(np.uint8),
        rng.integers(0, 256, size=(n, 90)).astype(np.uint8),
        rng.integers(-1000, 1000, size=n).astype(np.int64),
        rng.random(n).astype(np.float64),
        rng.random((n, 3)).astype(np.float32),
        rng.integers(0, 2, size=n).astype(bool),
        rng.integers(0, 9000, size=n).astype(np.int16),
    ]
    perm = rng.permutation(n)
    got = rowmove.take_rows_multi([torch.as_tensor(l) for l in leaves],
                                  torch.as_tensor(perm))
    ref = jax.jit(lambda ls: jrowmove.take_rows_multi(
        ls, jax.numpy.asarray(perm)))([jax.numpy.asarray(l)
                                       for l in leaves])
    for l, g, r in zip(leaves, got, ref):
        assert np.array_equal(g.numpy(), l[perm]), l.dtype
        assert np.array_equal(g.numpy(), np.asarray(r)), l.dtype
    # per worker: [W, n] permutations gather each worker's rows
    w2 = torch.as_tensor(np.stack([leaves[2][:32], leaves[2][32:]]))
    p2 = torch.as_tensor(np.stack([perm[:32] % 32, perm[32:] % 32]))
    out = rowmove.take_rows_multi([w2], p2)[0].numpy()
    assert np.array_equal(out, np.take_along_axis(w2.numpy(), p2.numpy(), 1))


@pytest.mark.parametrize("W", WS)
def test_stitched_chain_makes_no_host_fetch_between_source_and_action(
        W, monkeypatch):
    """Map, Filter, ZipWithIndex, PrefixSum, Filter, Map: one stitched
    program, and the whole pipeline fetches only what AllGather itself
    reads (the counts and the one leaf); per op, each Filter's
    compaction reads its counts on the host."""
    def run(ctx):
        d = ctx.Generate(1000)
        out = d.Map(_x3).Filter(lambda x: x % 2 == 0).ZipWithIndex(
            lambda x, i: x + i).PrefixSum().Filter(
            lambda x: x % 3 != 0).Map(lambda x: x - 1)
        return [int(x) for x in out.AllGather()]

    ctx = _port(W)
    got = run(ctx)
    mex = ctx.mesh_exec
    assert mex.stats_fused_dispatches == 1
    assert mex.stats_fetches == 2
    pre = np.cumsum([x * 3 + i for i, x in enumerate(
        x for x in range(1000) if (x * 3) % 2 == 0)])
    assert got == (pre[pre % 3 != 0] - 1).tolist()
    monkeypatch.setenv("THRILL_TPU_FUSE", "0")
    plain = _port(W)
    assert run(plain) == got
    assert plain.mesh_exec.stats_fetches > 2


@pytest.mark.parametrize("fuse", ["1", "0"])
def test_chip_smoke_f1_chain_counts_are_the_reference_s(fuse, monkeypatch):
    """Phase F1's chain of ``chip_smoke.py`` at 2^12 rows: both packages
    equal numpy, and the stitched runs make the fused dispatches, ops,
    stages and counted host fetches that the smoke holds the card's run
    to (``F1_REF``); per op none fused, the same fetches."""
    import chip_smoke as cs
    monkeypatch.setenv("THRILL_TPU_FUSE", fuse)
    n = 1 << 12
    want_s, want_v = cs.f1_np(np, n)
    for ctx in (_port(1), _ref(1)):
        out = cs.f1_chain(ctx, n).AllGatherArrays()
        assert np.array_equal(np.asarray(out["s"]), want_s)
        assert np.array_equal(np.asarray(out["v"]).astype(np.float64),
                              want_v)
        mex = ctx.mesh_exec
        got = {"fused_dispatches": mex.stats_fused_dispatches,
               "fused_ops": mex.stats_fused_ops,
               "fused_stages": {" + ".join(o): c for o, c in
                                mex.fused_stage_counts.items()},
               "fetches": mex.stats_fetches}
        if fuse == "1":
            assert got == cs.F1_REF
        else:
            assert got == dict(cs.F1_REF, fused_dispatches=0, fused_ops=0,
                               fused_stages={})
        ctx.close()
