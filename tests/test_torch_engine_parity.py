"""The native CPU engine against the reference's, and against the port's
device engine (counterpart of the reference's
``tests/api/test_engine_parity.py``).

On a CPU mesh, with ``THRILL_TPU_HOST_RADIX`` at its default, Sort at
W = 1 and the local phases of ReduceByKey, ReduceToIndex (generic
``reduce_fn``) and GroupByKey take the native engine
(``core/host_radix.py``) in both packages. At W = 1, 2 and 4 each job's
results are the reference's bit for bit, GroupByKey's groups in the
reference's per-worker order (first appearance), and the dispatch,
upload, fetch and fused counts are the reference's. The port's device
engine (``THRILL_TPU_HOST_RADIX=0``, what the card runs) gives the same
results: equal for Sort, integer sums and groups; float sums within
``F64_TOL``/``F32_TOL``, since the native fold groups a run in log-depth
order (and a FieldReduce f32 sum accumulates in f64) where the device
engine folds left to right. A build failure of ``hostsort.cpp`` prints
the compiler's message once and leaves the engine unavailable; a
:class:`NativeEngineError` of a loaded engine propagates.
"""

import numpy as np
import pytest

import jax
from thrill_tpu.api import Context as JContext
from thrill_tpu.api import FieldReduce as JFieldReduce
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.common import native_build
from thrill_tpu_torch.core import host_radix

WS = [1, 2, 4]
COUNTERS = ("device_dispatches", "device_uploads", "device_fetches",
            "fused_dispatches", "fused_ops")
#: native engine against the device engine: (rtol, atol) of float sums
F64_TOL = (1e-12, 1e-12)
F32_TOL = (1e-5, 1e-5)


@pytest.fixture(autouse=True)
def _default_engine(monkeypatch):
    for var in ("THRILL_TPU_HOST_RADIX", "THRILL_TPU_FUSE"):
        monkeypatch.delenv(var, raising=False)
    assert host_radix.available()


def _port(W):
    return tt.Context(num_workers=W, device="cpu")


def _ref(W):
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]))


def _kv(dt, n=3000):
    rng = np.random.default_rng(9)
    k = rng.integers(0, 97, size=n).astype(np.int64)
    if np.issubdtype(dt, np.floating):
        v = rng.standard_normal(n).astype(dt)
    else:
        v = rng.integers(0, 1000, size=n).astype(dt)
    return {"k": k, "v": v}


def _key(t):
    return t["k"]


def _add(a, b):
    return {"k": a["k"], "v": a["v"] + b["v"]}


def _rows(out):
    """Items as (k, v) with v's bytes: equal rows are bit-equal."""
    return [(int(i["k"]), np.asarray(i["v"]).tobytes()) for i in out]


def _sort(ctx, FR):
    rng = np.random.default_rng(9)
    d = {"key": rng.integers(0, 256, size=(3000, 10)).astype(np.uint8),
         "pay": rng.integers(0, 255, size=(3000, 4)).astype(np.uint8)}
    out = ctx.Distribute(d).Sort(key_fn=lambda t: t["key"]).AllGather()
    return [(bytes(np.asarray(i["key"])), bytes(np.asarray(i["pay"])))
            for i in out]


def _reduce_field(dt):
    def job(ctx, FR):
        return _rows(ctx.Distribute(_kv(dt)).ReduceByKey(
            _key, FR({"k": "first", "v": "sum"})).AllGather())
    return job


def _reduce_generic(dt):
    def job(ctx, FR):
        return _rows(ctx.Distribute(_kv(dt)).ReduceByKey(
            _key, _add).AllGather())
    return job


def _reduce_to_index(ctx, FR):
    return _rows(ctx.Distribute(_kv(np.int64)).ReduceToIndex(
        _key, _add, 100).AllGather())


def _group(ctx, FR):
    # item types are part of the contract: scalar fields come to
    # group_fn as Python ints on both engines
    node = ctx.Distribute(_kv(np.int64)).GroupByKey(
        _key, lambda k, its: (k, len(its), sum(i["v"] for i in its),
                              type(its[0]["v"]).__name__)).node
    return [list(lst) for lst in node.materialize().lists]


JOBS = {
    "sort": _sort,
    "reduce_field_i64": _reduce_field(np.int64),
    "reduce_field_f64": _reduce_field(np.float64),
    "reduce_field_f32": _reduce_field(np.float32),
    "reduce_generic_i64": _reduce_generic(np.int64),
    "reduce_generic_f64": _reduce_generic(np.float64),
    "reduce_generic_f32": _reduce_generic(np.float32),
    "reduce_to_index_generic": _reduce_to_index,
    "group_by_key": _group,
}


def _run(make, job, FR):
    ctx = make()
    res = job(ctx, FR)
    st = ctx.overall_stats()
    ctx.close()
    return res, {k: st[k] for k in COUNTERS}


def _close_rows(native, device, dt):
    """Reduce rows of the two engines: the same keys, integer values
    equal, float values within the stated tolerance."""
    a, b = sorted(native), sorted(device)
    assert [k for k, _ in a] == [k for k, _ in b]

    def values(rows):
        # a scalar column comes out as a Python number: int64 or f64 bytes
        return np.array([np.frombuffer(v, np.float64 if np.issubdtype(
            dt, np.floating) and len(v) == 8 else dt)[0] for _, v in rows])

    va, vb = values(a), values(b)
    if np.issubdtype(dt, np.floating):
        rtol, atol = F64_TOL if dt == np.float64 else F32_TOL
        np.testing.assert_allclose(va, vb, rtol=rtol, atol=atol)
    else:
        assert np.array_equal(va, vb)


@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("name", list(JOBS))
def test_native_engine_is_the_reference_s_and_the_device_engine_s(
        name, W, monkeypatch):
    job = JOBS[name]
    port, port_counts = _run(lambda: _port(W), job, tt.FieldReduce)
    ref, ref_counts = _run(lambda: _ref(W), job, JFieldReduce)
    assert port == ref
    assert port_counts == ref_counts
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    device, _ = _run(lambda: _port(W), job, tt.FieldReduce)
    if name == "sort":
        assert device == port
    elif name == "group_by_key":
        # the device engine groups in key order, the native one in
        # first-appearance order: the same groups on each worker
        assert [sorted(w) for w in device] == [sorted(w) for w in port]
    else:
        dt = {"f64": np.float64, "f32": np.float32}.get(name[-3:],
                                                        np.int64)
        _close_rows(port, device, dt)


def test_a_native_engine_error_propagates(monkeypatch):
    """A broken engine raises; it never gives way to the device engine."""
    def broken(words):
        raise host_radix.NativeEngineError("hash_group_u64 failed (rc=-1)")

    monkeypatch.setattr(host_radix, "hash_group", broken)
    for build in (
            lambda c: c.Distribute(_kv(np.int64)).ReduceByKey(_key, _add),
            lambda c: c.Distribute(_kv(np.int64)).ReduceToIndex(
                _key, _add, 100),
            lambda c: c.Distribute(_kv(np.int64)).GroupByKey(
                _key, lambda k, its: len(its))):
        ctx = _port(2)
        with pytest.raises(host_radix.NativeEngineError):
            build(ctx).AllGather()
        ctx.close()


def test_a_failed_build_prints_once_and_leaves_the_engine_off(
        monkeypatch, tmp_path, capsys):
    src = tmp_path / "native"
    src.mkdir()
    (src / "hostsort.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "NATIVE_DIR", str(src))
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.delitem(native_build._host_libs, "hostsort", raising=False)
    monkeypatch.setattr(host_radix, "_LIB", None)
    monkeypatch.setattr(host_radix, "_TRIED", False)
    assert not host_radix.available()
    assert not host_radix.available()
    err = capsys.readouterr().err
    assert err.count("building native/hostsort.cpp failed") == 1
    # the mesh is not eligible, and the device engine runs
    ctx = _port(1)
    assert not host_radix.eligible(ctx.mesh_exec)
    got = ctx.Distribute(np.arange(10, dtype=np.int64)[::-1].copy()) \
        .Sort().AllGather()
    assert [int(x) for x in got] == list(range(10))
    assert ctx.overall_stats()["device_dispatches"] >= 1
    ctx.close()


def _lk(t):
    return t["k"]


def _lstep(t):
    return {"k": (t["k"] * 7 + 3) % 50, "v": t["v"] + 1}


@pytest.mark.parametrize("W", [1, 2])
def test_a_loop_body_on_the_native_engine_is_the_plain_loop_s(W,
                                                            monkeypatch):
    """Fault C28: the native engine reads the columns on the host, so a
    loop capture must see the read (``MeshExec.host_view``), miss, and
    run the plain loop, not replay a tape that froze the engine's output
    at the first iteration. The reference replays such a tape (its sums
    come out short: 550 against 850 here); the port's replayed run is
    its plain run and the reference's plain run."""
    data = {"k": np.arange(200, dtype=np.int64) % 97,
            "v": np.ones(200, dtype=np.int64)}

    def run(ctx, Iterate, FR, replay):
        monkeypatch.setenv("THRILL_TPU_LOOP_REPLAY", replay)

        def body(d):
            return d.Map(_lstep).ReduceByKey(
                _lk, FR({"k": "first", "v": "sum"})).Map(_lstep)

        out = Iterate(ctx, body, ctx.Distribute(data), 5)
        rows = sorted((int(i["k"]), int(i["v"])) for i in out.AllGather())
        st = ctx.overall_stats()
        ctx.close()
        return rows, st["loop_replays"]

    from thrill_tpu.api import Iterate as JIterate
    replayed, n_replays = run(_port(W), tt.Iterate, tt.FieldReduce, "1")
    plain, _ = run(_port(W), tt.Iterate, tt.FieldReduce, "0")
    ref_plain, _ = run(_ref(W), JIterate, JFieldReduce, "0")
    ref_replayed, ref_replays = run(_ref(W), JIterate, JFieldReduce, "1")
    assert replayed == plain == ref_plain
    assert n_replays == 0
    assert sum(v for _, v in plain) == 850
    # the reference's fault, at its exact value
    assert ref_replays > 0 and sum(v for _, v in ref_replayed) == 550
