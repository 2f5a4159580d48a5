"""The streamed exchange (``thrill_tpu_torch/data/exchange.py``
``exchange_stream``) and ReduceByKey's streamed post phase
(``THRILL_TPU_REDUCE_STREAM=1``) against the reference package on the
CPU: the counterparts of the reference's
``tests/data/test_exchange_stream.py``.

Tolerance: none against the reference. Every round's rows and counts
equal the reference's, the streamed ReduceByKey's rows equal the
reference's streamed ones worker for worker, bit for bit (its f64 sums
fold the rounds in the reference's order), and the plan counters,
padded rows, device bytes, dispatches and counted fetches equal the
reference's. Against the port's default path the keys and integer sums
are bit-equal and the f64 sums agree within 1e-12 relative: the streamed
phase adds the rounds in their schedule's order, the default in rank
order, in both packages.
"""

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

STATS = ("device_dispatches", "device_fetches", "plan_builds",
         "bytes_wire_device", "bytes_wire_device_raw", "exchanges",
         "items_moved")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    for var in ("THRILL_TPU_REDUCE_STREAM", "THRILL_TPU_EXCHANGE",
                "THRILL_TPU_FUSE", "THRILL_TPU_XCHG_CAP_CACHE"):
        monkeypatch.delenv(var, raising=False)


def _port(W):
    return tt.Context(num_workers=W, device="cpu")


def _ref(W):
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]))


def _stats(ctx):
    s = ctx.overall_stats()
    out = {k: s[k] for k in STATS}
    out["padded_rows"] = ctx.mesh_exec.stats_padded_rows
    return out


def _rounds(ctx, vals, W):
    """Every round of one streamed exchange of ``vals`` by ``v % W``:
    (per-worker rows, counts) a round."""
    is_port = isinstance(ctx, tt.Context)
    shards = ctx.Distribute(vals).node.materialize()
    if is_port:
        gen = ex.exchange_stream(shards, lambda t, m, w: torch.remainder(
            t, W), ("stream_test", W))
    else:
        gen = jex.exchange_stream(shards, lambda t, m, w: (
            t % W).astype(jnp.int32), ("stream_test", W))
    out = []
    for block in gen:
        arr = np.asarray(ctx.mesh_exec.fetch(block.tree))
        counts = np.asarray(block.counts).reshape(-1)
        out.append(([arr[w][:int(counts[w])].tolist() for w in range(W)],
                     counts.tolist()))
    return out


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_exchange_stream_delivers_every_item_once(W):
    """Each item once, on its destination; W rounds (the identity round
    first); every round's rows and counts the reference's, and the
    stream's plan counters too."""
    rng = np.random.default_rng(W)
    vals = rng.integers(0, 1 << 40, 97 * W + 5).astype(np.int64)
    got = {}
    for name, make in (("port", _port), ("ref", _ref)):
        ctx = make(W)
        got[name] = (_rounds(ctx, vals, W), _stats(ctx))
        ctx.close()
    rounds, st = got["port"]
    assert len(rounds) == W
    seen = []
    for rows, _ in rounds:
        for w, r in enumerate(rows):
            assert all(v % W == w for v in r)
            seen += r
    assert sorted(seen) == sorted(vals.tolist())
    assert got["port"] == got["ref"]


def _key(t):
    return t["k"]


def _red(pkg):
    return (tt.FieldReduce if pkg == "port" else JFieldReduce)(
        {"k": "first", "c": "sum", "f": "sum"})


def _reduce_runs(ctx, pkg, W, runs=2):
    rng = np.random.default_rng(W)
    n = 5000
    d = {"k": (rng.zipf(1.3, n) % 700).astype(np.int64),
         "c": np.ones(n, np.int64), "f": rng.normal(size=n)}
    outs = []
    for _ in range(runs):
        out = ctx.Distribute(d).ReduceByKey(_key, _red(pkg)).node.materialize()
        outs.append([{k: np.asarray(v) for k, v in t.items()}
                     for t in out.to_worker_arrays()])
    return outs


def _same(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for wa, wb in zip(ra, rb):
            for k in wa:
                assert wa[k].dtype == wb[k].dtype, k
                assert np.array_equal(wa[k], wb[k]), k


@pytest.mark.parametrize("W", [1, 2, 4])
def test_streamed_reduce_is_the_reference_s(W, monkeypatch):
    """Two streamed ReduceByKeys on one Context: rows bit-equal to the
    reference's streamed ones and to the port's default path; the plan
    builds, padded rows, device bytes, dispatches and counted fetches the
    reference's."""
    monkeypatch.setenv("THRILL_TPU_REDUCE_STREAM", "1")
    got = {}
    for name, make in (("port", _port), ("ref", _ref)):
        ctx = make(W)
        got[name] = (_reduce_runs(ctx, name, W), _stats(ctx))
        ctx.close()
    _same(got["port"][0], got["ref"][0])
    assert got["port"][1] == got["ref"][1]
    monkeypatch.delenv("THRILL_TPU_REDUCE_STREAM")
    ctx = _port(W)
    default = _reduce_runs(ctx, "port", W)
    ctx.close()
    for rs, rd in zip(got["port"][0], default):
        for ws, wd in zip(rs, rd):
            assert np.array_equal(ws["k"], wd["k"])
            assert np.array_equal(ws["c"], wd["c"])
            np.testing.assert_allclose(ws["f"], wd["f"], rtol=1e-12,
                                       atol=1e-12)


@pytest.mark.parametrize("W", [2, 4])
def test_streamed_reduce_per_op_path_is_the_stitched_one(W, monkeypatch):
    """``THRILL_TPU_FUSE=0`` takes the same streamed post phase: the same
    rows and dispatches as the reference's per-op path."""
    monkeypatch.setenv("THRILL_TPU_REDUCE_STREAM", "1")
    monkeypatch.setenv("THRILL_TPU_FUSE", "0")
    got = {}
    for name, make in (("port", _port), ("ref", _ref)):
        ctx = make(W)
        got[name] = (_reduce_runs(ctx, name, W, runs=1),
                     _stats(ctx)["device_dispatches"])
        ctx.close()
    _same(got["port"][0], got["ref"][0])
    assert got["port"][1] == got["ref"][1]


def test_streamed_reduce_cap_stays_linear(monkeypatch):
    """The streamed post phase folds the rounds as a binary counter: at
    W = 8 the result's capacity stays linear in the rows received (a
    linear fold through one accumulator doubles it every round), and
    equals the reference's."""
    monkeypatch.setenv("THRILL_TPU_REDUCE_STREAM", "1")
    vals = np.arange(20000, dtype=np.int64)
    caps = {}
    for name, make in (("port", _port), ("ref", _ref)):
        ctx = make(8)
        out = ctx.Distribute(vals).Map(lambda x: (x % 1000, 1)).ReducePair(
            lambda a, b: a + b)
        sh = out.node.materialize(consume=False)
        caps[name] = sh.cap
        got = dict((int(k), int(v)) for k, v in out.AllGather())
        assert len(got) == 1000 and all(v == 20 for v in got.values())
        ctx.close()
    assert caps["port"] == caps["ref"] <= 8192


@pytest.mark.parametrize("mode", ["stream", "nonesuch"])
def test_a_mode_string_the_reference_knows_no_plan_for(mode, monkeypatch):
    """``THRILL_TPU_EXCHANGE=stream`` (or any string but dense,
    onefactor and ragged) takes the synced dense plan, as the reference
    does with it: rows, plan counters and the decision record equal."""
    monkeypatch.setenv("THRILL_TPU_EXCHANGE", mode)
    got = {}
    for name, make in (("port", _port), ("ref", _ref)):
        ctx = make(4)
        rows = _reduce_runs(ctx, name, 4)
        st = ctx.overall_stats()
        recs = [(d["kind"], d["chosen"]) for d in ctx.decisions.snapshot()
                if d["kind"] in ("xchg_strategy", "xchg_optimistic")]
        got[name] = (rows, {k: st[k] for k in STATS + (
            "cap_cache_hits", "exchanges_overlapped")}, recs)
        ctx.close()
    _same(got["port"][0], got["ref"][0])
    assert got["port"][1:] == got["ref"][1:]
    assert got["port"][1]["exchanges_overlapped"] == 0
    assert ("xchg_strategy", "dense") in got["port"][2]


def _step(kv):
    return ((kv[0] * 3 + 1) % 61, kv[1] + 1)


@pytest.mark.parametrize("W", [2, 4])
def test_a_streamed_reduce_in_a_loop_is_the_reference_s(W, monkeypatch):
    """``Iterate`` over a body with a streamed ReduceByKey, which reads
    the send matrix on the host in every iteration: the loop layer keeps
    that tape on its host-reading path (no whole-loop program), and the
    result and the loop stats equal the reference's loop."""
    from thrill_tpu.api.loop import Iterate as JIterate
    monkeypatch.setenv("THRILL_TPU_REDUCE_STREAM", "1")
    keys = (np.arange(3000, dtype=np.int64) * 7919) % 61
    res = {}
    for name, make, it in (("port", _port, tt.Iterate),
                           ("ref", _ref, JIterate)):
        ctx = make(W)
        src = ctx.Distribute({"k": keys, "v": np.ones_like(keys)})
        src = src.Map(lambda t: (t["k"], t["v"]))
        out = it(ctx, lambda d: d.Map(_step).ReducePair("sum"), src, 4,
                 name="stream_loop")
        got = out.AllGatherArrays() if hasattr(out, "AllGatherArrays") \
            else out
        st = ctx.overall_stats()
        res[name] = (sorted(zip(np.asarray(got[0]).tolist(),
                                np.asarray(got[1]).tolist())),
                     {k: st[k] for k in ("loop_fori_iters",
                                         "loop_replay_fallbacks")})
        ctx.close()
    assert res["port"] == res["ref"]
    assert res["port"][1]["loop_fori_iters"] == 0
