"""The planned exchange (``thrill_tpu_torch/data/exchange.py``) against
the reference package on the CPU: the counterparts of the reference's
``tests/data/test_exchange_overlap.py``, ``test_exchange_skew.py``,
``test_exchange_pack.py`` and ``test_exchange_narrow_paths.py``.

Tolerance: every comparison of rows is bit-equal (``np.array_equal``
of the raw arrays; the exchange copies rows and never computes on
them). The plan counters (capacity-cache hits and misses, overlapped
exchanges, plan builds, counted host fetches) equal the reference's at
W = 1, 2 and 4; the site digests differ by design (each package's
identity tuples hold its own treedefs and dtypes).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from thrill_tpu.api import Context as JContext
from thrill_tpu.common import faults as jfaults
from thrill_tpu.data import exchange as jex
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.common import faults
from thrill_tpu_torch.data import exchange as ex

WS = [1, 2, 4]
PLAN_KEYS = ("cap_cache_hits", "cap_cache_misses", "exchanges_overlapped",
             "plan_builds", "device_fetches")
_SWITCHES = ("THRILL_TPU_OVERLAP", "THRILL_TPU_XCHG_CAP_CACHE",
             "THRILL_TPU_XCHG_NARROW", "THRILL_TPU_WIRE_COMPRESS",
             "THRILL_TPU_XCHG_CHUNKS", "THRILL_TPU_EXCHANGE",
             "THRILL_TPU_PLANNER", "THRILL_TPU_XCHG_BYTES_EQ",
             "THRILL_TPU_XCHG_BYTES_EQ_CAL", "THRILL_TPU_SORT_FUSED",
             "THRILL_TPU_DECISIONS")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    for var in _SWITCHES + (faults.ENV_VAR,):
        monkeypatch.delenv(var, raising=False)
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()
    yield
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()


def _port(W):
    return tt.Context(num_workers=W, device="cpu")


def _ref(W):
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]))


def _stats(ctx):
    s = ctx.overall_stats()
    return {k: s[k] for k in PLAN_KEYS}


def _columns(rng, n):
    """Leaves that narrow to every width of the ladder, and ones that
    must not: negative keys, values past 32 bits, a float, an array
    column."""
    return {
        "k": rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64),
        "i8": rng.integers(-100, 100, n).astype(np.int64),
        "u16": rng.integers(0, 60000, n).astype(np.int64),
        "i32": rng.integers(-70000, 70000, n).astype(np.int32),
        "f": rng.normal(size=n),
        "row": rng.integers(-3, 200, (n, 3)).astype(np.int64),
    }


def _port_dest(W):
    def dest(tree, mask, widx):
        return torch.remainder(tree["k"], W)
    return dest


def _ref_dest(W):
    def dest(tree, mask, widx):
        return (tree["k"] % W).astype(jnp.int32)
    return dest


def _direct(ctx, cols, runs, site=("plan_direct",)):
    """``runs`` exchanges of ``cols`` at one call site; each run's
    per-worker arrays (the counts read, so a deferred check drains)."""
    is_port = isinstance(ctx, tt.Context)
    W = ctx.num_workers
    mod, dest = (ex, _port_dest(W)) if is_port else (jex, _ref_dest(W))
    outs = []
    for c in (cols if isinstance(cols, list) else [cols] * runs):
        shards = ctx.Distribute(c).node.materialize()
        out = mod.exchange(shards, dest, site)
        outs.append([{k: np.asarray(v) for k, v in t.items()}
                     for t in out.to_worker_arrays()])
    return outs


def _same(a, b):
    assert len(a) == len(b)
    for wa, wb in zip(a, b):
        assert wa.keys() == wb.keys()
        for k in wa:
            assert wa[k].dtype == wb[k].dtype, k
            assert np.array_equal(wa[k], wb[k]), k


@pytest.mark.parametrize("W", WS)
def test_exchange_plan_stats_are_the_reference_s(W):
    """Three exchanges at one site: the first plans from the host send
    matrix, the later ones run on the cached plan; rows equal the
    reference's worker for worker, and so do the plan counters."""
    cols = _columns(np.random.default_rng(W), 3000)
    got, stats = {}, {}
    for name, make in (("port", _port), ("ref", _ref)):
        ctx = make(W)
        got[name] = _direct(ctx, cols, 3)
        stats[name] = _stats(ctx)
        ctx.close()
    for a, b in zip(got["port"], got["ref"]):
        for wa, wb in zip(a, b):
            for k in wa:
                assert np.array_equal(wa[k], wb[k]), k
    assert stats["port"] == stats["ref"]
    if W > 1:
        assert stats["port"]["cap_cache_hits"] == 2
        assert stats["port"]["plan_builds"] == 1


def _baseline(W, cols, monkeypatch):
    for var, v in (("THRILL_TPU_XCHG_CAP_CACHE", "0"),
                   ("THRILL_TPU_OVERLAP", "0"),
                   ("THRILL_TPU_XCHG_NARROW", "0")):
        monkeypatch.setenv(var, v)
    ctx = _port(W)
    out = _direct(ctx, cols, 1)[0]
    ctx.close()
    for var in ("THRILL_TPU_XCHG_CAP_CACHE", "THRILL_TPU_OVERLAP",
                "THRILL_TPU_XCHG_NARROW"):
        monkeypatch.delenv(var)
    return out


@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("mode", ["dense", "onefactor"])
@pytest.mark.parametrize("planner", ["1", "0"])
def test_every_mode_is_bit_equal_to_the_bulk_run(W, K, mode, planner,
                                                 monkeypatch):
    """Chunks K, dense or 1-factor, planner on or off, narrowing on and
    the cached plan on a second run: every row bit-equal to the bulk,
    synced, full-width exchange."""
    cols = _columns(np.random.default_rng(10 + W), 3000)
    want = _baseline(W, cols, monkeypatch)
    monkeypatch.setenv("THRILL_TPU_XCHG_CHUNKS", str(K))
    monkeypatch.setenv("THRILL_TPU_EXCHANGE", mode)
    monkeypatch.setenv("THRILL_TPU_PLANNER", planner)
    ctx = _port(W)
    runs = _direct(ctx, cols, 2)
    s = ctx.overall_stats()
    ctx.close()
    for got in runs:
        _same(got, want)
    if W > 1:
        # narrowing copied fewer bytes than full-width rows would
        assert 0 < s["bytes_wire_device"] < s["bytes_wire_device_raw"]
        assert s["cap_cache_hits"] == (1 if mode == "dense" else 0)


def test_narrow_round_trip_is_exact():
    """Every ladder type narrows its extreme values and widens them back
    bit for bit, from int64 and int32 leaves."""
    for nd in ex._NARROW_LADDER:
        info = np.iinfo(nd)
        for wide in (torch.int64, torch.int32):
            if np.dtype(nd).itemsize >= torch.tensor([], dtype=wide
                                                     ).element_size():
                continue
            x = torch.tensor([info.min, info.max, 0, info.max // 2 + 1,
                              -1 if info.min < 0 else 1], dtype=wide)
            y = ex._from_narrow(ex._to_narrow(x, nd.str), nd.str, wide)
            assert torch.equal(x, y), nd
    assert ex.narrow_dtype(-1, 1 << 33, 8) is None
    assert ex.narrow_dtype(-129, 5, 8) == np.dtype(np.int16)
    assert ex.narrow_dtype(0, 65535, 8) == np.dtype(np.uint16)


@pytest.mark.parametrize("W", [2, 4])
def test_capacity_miss_heals_as_the_reference(W):
    """A cached capacity the next input outgrows: the flag routes the
    exchange to the synced re-run from the retained phase-A output; one
    miss, rows bit-equal to the reference, and the retained bytes leave
    the governor's ledger once the check has run."""
    n = 4096
    bal = {"k": np.arange(n, dtype=np.int64),
           "v": np.arange(n, dtype=np.int64) * 3}
    hot = {"k": np.zeros(n, dtype=np.int64) + W,
           "v": np.arange(n, dtype=np.int64)}
    got, stats = {}, {}
    for name, make in (("port", _port), ("ref", _ref)):
        ctx = make(W)
        got[name] = _direct(ctx, [bal, hot, hot], 0)
        stats[name] = _stats(ctx)
        ctx.close()
    for a, b in zip(got["port"], got["ref"]):
        _same(a, b)
    assert stats["port"] == stats["ref"]
    assert stats["port"]["cap_cache_misses"] == 1
    assert got["port"][1][0]["k"].shape[0] == n


def test_miss_is_counted_in_the_governor_until_the_check():
    """While an optimistic exchange's check is pending its phase-A
    output stays alive, and the governor's ledger holds its bytes."""
    W = 2
    ctx = _port(W)
    cols = {"k": np.arange(2048, dtype=np.int64)}
    _direct(ctx, cols, 1)
    shards = ctx.Distribute(cols).node.materialize()
    base = ctx.hbm.mem.total            # the cached source's bytes
    out = ex.exchange(shards, _port_dest(W), ("plan_direct",))
    assert out._counts_check is not None and ctx.hbm.mem.total > base
    out.validate_pending()
    assert ctx.hbm.mem.total == base
    ctx.close()


def test_range_miss_heals():
    """Learned narrow ranges the next input outgrows (same capacities):
    a miss like a capacity overflow, healed to bit-equal rows."""
    W = 2
    rng = np.random.default_rng(3)
    small = {"k": np.arange(4096, dtype=np.int64),
             "v": rng.integers(0, 100, 4096).astype(np.int64)}
    wide = {"k": np.arange(4096, dtype=np.int64),
            "v": rng.integers(-(1 << 50), 1 << 50, 4096).astype(np.int64)}
    ctx = _port(W)
    outs = _direct(ctx, [small, wide], 0)
    assert ctx.mesh_exec.stats_cap_cache_misses == 1
    ctx.close()
    ref = _ref(W)
    want = _direct(ref, [small, wide], 0)
    assert ref.mesh_exec.stats_cap_cache_misses == 1
    ref.close()
    for a, b in zip(outs, want):
        _same(a, b)


def test_overlap_skips_counted_fetches(monkeypatch):
    """The second run of a site reads no send matrix: fewer counted
    fetches than a run with the cache off, in both packages."""
    deltas = {}
    for name, make in (("port", _port), ("ref", _ref)):
        ctx = make(2)
        mex = ctx.mesh_exec
        cols = {"k": np.arange(512, dtype=np.int64)}
        _direct(ctx, cols, 1)
        f0 = mex.stats_fetches
        _direct(ctx, cols, 1)
        opt = mex.stats_fetches - f0
        monkeypatch.setenv("THRILL_TPU_XCHG_CAP_CACHE", "0")
        f1 = mex.stats_fetches
        _direct(ctx, cols, 1)
        deltas[name] = (opt, mex.stats_fetches - f1)
        monkeypatch.delenv("THRILL_TPU_XCHG_CAP_CACHE")
        ctx.close()
    assert deltas["port"] == deltas["ref"]
    assert deltas["port"][0] < deltas["port"][1]


def test_chunk_count_policy(monkeypatch):
    """OVERLAP=0 forces one dispatch, XCHG_CHUNKS pins K (clamped to
    the padded capacity), the auto policy chunks only volumes worth
    pipelining; the reference's numbers."""
    mex = _port(2).mesh_exec
    jmex = JMeshExec(devices=jax.devices("cpu")[:2])
    cases = [(2, 1 << 20, 8), (2, 4, 8), (2, 64, 8)]
    for env in ({"THRILL_TPU_OVERLAP": "0"}, {"THRILL_TPU_XCHG_CHUNKS": "6"},
                {}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert [ex._chunk_count(mex, *c) for c in cases] == \
            [jex._chunk_count(jmex, *c) for c in cases]
        for k in env:
            monkeypatch.delenv(k)
    assert ex._chunk_count(mex, 2, 1 << 20, 8) == ex._CHUNK_DEFAULT


@pytest.mark.parametrize("fits", [True, False])
def test_chunk_policy_on_one_card(fits, monkeypatch):
    """On the card (one device, nothing to overlap) the auto policy
    chunks only a phase B whose bulk buffers cannot fit under the HBM
    budget; a pin and the overlap switch behave as on the CPU."""
    seen = []

    def inadmissible(nbytes):
        seen.append(nbytes)
        return not fits
    big = (4, 1 << 20, 8)
    assert ex.chunk_policy(*big, "cuda", inadmissible) == (
        1 if fits else ex._CHUNK_DEFAULT)
    assert seen == [2 * 4 * 4 * (1 << 20) * 8]
    assert ex.chunk_policy(*big, "cuda", None) == 1
    assert ex.chunk_policy(4, 64, 8, "cuda", inadmissible) == 1
    monkeypatch.setenv("THRILL_TPU_XCHG_CHUNKS", "3")
    assert ex.chunk_policy(*big, "cuda", inadmissible) == 3
    monkeypatch.setenv("THRILL_TPU_OVERLAP", "0")
    assert ex.chunk_policy(*big, "cuda", inadmissible) == 1


def _skewed_S(W):
    S = np.zeros((W, W), dtype=np.int64)
    S[:, 0] = 100
    S[min(3, W - 1), 0] = 10_000          # 100:1 on one pair
    return S


def test_skew_flips_to_onefactor_at_the_reference_constants():
    """The cost model of both packages on a 100:1 skewed and on a
    balanced neighbour-shift send matrix (the CPU constants)."""
    for W in (4, 8):
        mex = _port(W).mesh_exec
        jmex = JMeshExec(devices=jax.devices("cpu")[:W])
        Sb = np.zeros((W, W), dtype=np.int64)
        for w in range(W):
            Sb[w, (w + 1) % W] = 100
        for S in (_skewed_S(W), Sb, Sb * 1000):
            assert ex._strategy_costs(mex, S, 16) == \
                jex._strategy_costs(jmex, S, 16)
            assert ex._skewed(S, 16, mex) == jex._skewed(S, 16, jmex)
        assert ex._skewed(_skewed_S(W), 16, mex)
        assert not ex._skewed(Sb, 16, mex)


def _skewed_cols(W, n_hot=10_000):
    """Every worker sends 100 rows to worker 0 and one of them 10_000
    more: the 100:1 matrix of ``_skewed_S`` as data (distinct values,
    all multiples of W)."""
    return [W * (np.arange(100 + (n_hot if w == min(3, W - 1) else 0),
                           dtype=np.int64) + 100_000 * w)
            for w in range(W)]


@pytest.mark.parametrize("W", [4, 8])
def test_onefactor_rounds_land_rows_where_dense_does(W, monkeypatch):
    """Under the 100:1 matrix the planner sends the exchange to the
    1-factor rounds (the decision the reference records too), and every
    row lands where the forced dense plan puts it. (At W = 2 the two
    plans pad alike: there is nothing to choose.)"""
    per = _skewed_cols(W)

    def run(ctx):
        if isinstance(ctx, tt.Context):
            mod = ex

            def dest(x, mask, widx):
                return torch.remainder(x, W)
        else:
            mod = jex

            def dest(x, mask, widx):
                return (x % W).astype(jnp.int32)
        shards = ctx.ConcatToDIA(per, storage="device").node.materialize()
        out = mod.exchange(shards, dest, ("skew",))
        rows = [{"x": np.asarray(t)} for t in out.to_worker_arrays()]
        chosen = [r.chosen for r in ctx.decisions.records
                  if r.kind == "xchg_strategy"]
        return rows, chosen, ctx.mesh_exec.stats_padded_rows

    got = {}
    for name, make in (("port", _port), ("ref", _ref)):
        ctx = make(W)
        got[name] = run(ctx)
        ctx.close()
    monkeypatch.setenv("THRILL_TPU_XCHG_BYTES_EQ", str(1 << 60))
    ctx = _port(W)
    dense = run(ctx)
    ctx.close()
    _same(got["port"][0], got["ref"][0])
    _same(got["port"][0], dense[0])
    assert got["port"][1] == got["ref"][1] == ["onefactor"]
    assert dense[1] == ["dense"]
    assert got["port"][2] < dense[2]


def test_pack_fault_degrades_to_full_width():
    """An armed ``data.exchange.pack`` ships that exchange at full
    width: bit-equal rows, device bytes equal to the raw ones."""
    W = 2
    cols = _columns(np.random.default_rng(5), 3000)
    ctx = _port(W)
    want = _direct(ctx, cols, 1)[0]
    ctx.close()
    with faults.inject("data.exchange.pack", p=1.0, n=100):
        ctx = _port(W)
        got = _direct(ctx, cols, 1)[0]
        s = ctx.overall_stats()
        ctx.close()
    _same(got, want)
    assert s["bytes_wire_device"] == s["bytes_wire_device_raw"] > 0


def test_chunk_fault_retries_transient(monkeypatch):
    """A transient fire at ``data.exchange.chunk`` (before the chunk's
    program launches) is retried: bit-equal rows."""
    monkeypatch.setenv("THRILL_TPU_XCHG_CHUNKS", "2")
    monkeypatch.setenv("THRILL_TPU_RETRY_BASE_S", "0")
    W = 2
    cols = _columns(np.random.default_rng(6), 3000)
    ctx = _port(W)
    want = _direct(ctx, cols, 1)[0]
    ctx.close()
    with faults.inject("data.exchange.chunk", p=1.0, n=1):
        ctx = _port(W)
        got = _direct(ctx, cols, 1)[0]
        ctx.close()
    _same(got, want)
    assert faults.REGISTRY.stats()["faults_injected"] >= 1


@pytest.mark.parametrize("mode", ["ragged", "stream"])
@pytest.mark.parametrize("W", [2, 4])
def test_configured_modes_run_against_the_reference(mode, W, monkeypatch):
    """``THRILL_TPU_EXCHANGE=ragged`` and ``=stream`` run (no mode of the
    reference's raises): three exchanges at one site give the
    reference's dense rows worker for worker, each plans from the host
    send matrix (no cached plan, no overlapped exchange), and under
    ``stream``, which the reference takes as a synced dense plan, the
    plan counters are the reference's under the same setting."""
    cols = _columns(np.random.default_rng(W + 40), 3000)
    want = _direct(_ref(W), cols, 3)
    monkeypatch.setenv("THRILL_TPU_EXCHANGE", mode)
    ctx = _port(W)
    got = _direct(ctx, cols, 3)
    st = _stats(ctx)
    ctx.close()
    for g, w in zip(got, want):
        _same(g, w)
    assert st["cap_cache_hits"] == st["exchanges_overlapped"] == 0
    assert st["plan_builds"] == 3
    if mode == "stream":
        jctx = _ref(W)
        _direct(jctx, cols, 3)
        assert st == _stats(jctx)
        jctx.close()


def test_bytes_eq_live_calibration(monkeypatch):
    """A fresh mesh keeps the static constant (the reference's on the
    CPU); a warmed dispatch-latency spine calibrates it within [static
    / 4, static * 4]; the pin and the escape as in the reference."""
    for W in (2,):
        mex = _port(W).mesh_exec
        jmex = JMeshExec(devices=jax.devices("cpu")[:W])
        assert ex._bytes_eq(mex) == jex._bytes_eq(jmex) == 45_000
        for m in (mex, jmex):
            m._disp_lat_n = ex._BYTES_EQ_MIN_SAMPLES
            m._disp_lat_min = 1e-6
        assert ex._bytes_eq(mex) == jex._bytes_eq(jmex) == 45_000 // 4
        for m in (mex, jmex):
            m._disp_lat_min = 1.0
        assert ex._bytes_eq(mex) == jex._bytes_eq(jmex) == 45_000 * 4
        monkeypatch.setenv("THRILL_TPU_XCHG_BYTES_EQ_CAL", "0")
        assert ex._bytes_eq(mex) == 45_000
        monkeypatch.setenv("THRILL_TPU_XCHG_BYTES_EQ", "777")
        assert ex._bytes_eq(mex) == 777


@pytest.mark.parametrize("warm", [False, True])
def test_the_card_keeps_the_dense_plan(warm):
    """On the card (a mesh whose device is ``cuda``; a stand-in here,
    since the choice reads only the device type, the worker count and
    the dispatch-latency spine) the strategy is dense for a 100:1
    hot-pair send matrix, fresh or past the spine's sample count, with
    the planner and without; a configured mode passes through. The CPU
    mesh takes the 1-factor rounds for the same matrix."""
    from types import SimpleNamespace
    from thrill_tpu_torch.api.planner import Planner
    S = _skewed_S(4) * 400                 # 4M rows on the hot pair
    card = SimpleNamespace(device=torch.device("cuda"), num_workers=4,
                           exchange_mode="dense", _env_exchange=None,
                           _disp_lat_n=0, _disp_lat_min=float("inf"))
    if warm:
        card._disp_lat_n = ex._BYTES_EQ_MIN_SAMPLES + 1
        card._disp_lat_min = 1e-6
    assert not ex._skewed(S, 16, card)
    assert ex.dense_all_to_all_applies(card, S, 16)
    pl = Planner(card, enabled=True)
    assert pl.exchange_strategy(S, 16, "dense")[0] == "dense"
    assert not pl.skew_developed(S, 16)
    assert pl.exchange_strategy(S, 16, "onefactor")[0] == "onefactor"
    cpu = _port(4)
    assert ex._skewed(S, 16, cpu.mesh_exec)
    assert cpu.planner.exchange_strategy(S, 16, "dense")[0] == "onefactor"
    cpu.close()


def test_dispatch_spine_counts_every_dispatch():
    ctx = _port(2)
    mex = ctx.mesh_exec
    n0 = mex._disp_lat_n
    ctx.Distribute(np.arange(100)).Map(lambda x: x + 1).Size()
    assert mex._disp_lat_n - n0 == mex.stats_dispatches > 0
    assert 0 < mex._disp_lat_min < 1.0
    ctx.close()


def _key_of(t):
    return t["k"]


@pytest.mark.parametrize("W", [2, 4])
def test_sort_presorted_narrowed_bit_equal(W, monkeypatch):
    """The Sort's generic path (``THRILL_TPU_SORT_FUSED=0``) narrows its
    carrier: bit-equal to full width and to the reference, fewer device
    bytes than raw."""
    monkeypatch.setenv("THRILL_TPU_SORT_FUSED", "0")
    rng = np.random.default_rng(11)
    cols = {"k": rng.integers(0, 900, 12000).astype(np.int64),
            "p": rng.integers(0, 100, 12000).astype(np.int32)}

    def run(make):
        ctx = make(W)
        outs = []
        for _ in range(2):
            g = ctx.Distribute(cols).Sort(_key_of).node.materialize(
            ).to_global_numpy()
            outs.append((np.asarray(g["k"]).tobytes(),
                         np.asarray(g["p"]).tobytes()))
        wire = ctx.overall_stats()
        ctx.close()
        return outs, (wire["bytes_wire_device"],
                      wire["bytes_wire_device_raw"])

    on, wire_on = run(_port)
    ref, _ = run(_ref)
    monkeypatch.setenv("THRILL_TPU_XCHG_NARROW", "0")
    off, wire_off = run(_port)
    assert on == off == ref
    assert wire_on[0] < wire_on[1] == wire_off[0] == wire_off[1]


@pytest.mark.parametrize("overlap", ["1", "0"])
@pytest.mark.parametrize("var", ["THRILL_TPU_PREFETCH", "THRILL_TPU_WRITEBACK",
                                 "THRILL_TPU_XCHG_CAP_CACHE",
                                 "THRILL_TPU_XCHG_NARROW"])
def test_overlap_master_switch_is_the_reference_s(overlap, var, monkeypatch):
    """THRILL_TPU_OVERLAP, read again, switches what it switches in the
    reference: the readahead depth, the write-behind queue and the
    capacity-plan cache; the wire switches narrowing."""
    from thrill_tpu.common import config as jcfg
    from thrill_tpu.data import writeback as jwb
    from thrill_tpu.vfs import file_io as jfio
    from thrill_tpu_torch.common import config as cfg
    from thrill_tpu_torch.data import writeback as wb
    from thrill_tpu_torch.vfs import file_io as fio
    monkeypatch.setenv("THRILL_TPU_OVERLAP", overlap)
    for v in ("1", "0", "3", ""):
        monkeypatch.setenv(var, v)
        assert fio.prefetch_depth() == jfio.prefetch_depth()
        assert wb.writeback_enabled() == jwb.writeback_enabled()
        assert cfg.cap_cache_enabled() == jcfg.cap_cache_enabled()
        assert cfg.xchg_narrow_enabled() == jcfg.xchg_narrow_enabled()
        monkeypatch.setenv("THRILL_TPU_WIRE_COMPRESS", "0")
        assert cfg.xchg_narrow_enabled() == jcfg.xchg_narrow_enabled() \
            is False
        monkeypatch.delenv("THRILL_TPU_WIRE_COMPRESS")
