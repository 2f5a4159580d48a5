"""The port's Sort slice against the reference package on the CPU.

The same records, made from a numpy seed, go through
``thrill_tpu``'s ``Context(MeshExec(devices=cpu[:W]))`` and
``thrill_tpu_torch``'s ``Context(num_workers=W, device="cpu")``; the
sorted rows and the per-worker counts must be identical at W in
{1, 2, 4}. A last test proves that the port imports neither jax nor
the reference package.
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from thrill_tpu.api import Context as JContext
from thrill_tpu.api.ops import sort as jsort
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.api.ops import sort as tsort
from thrill_tpu_torch.data import shards as tshards

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = [1, 2, 4]


def _jax_ctx(W):
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]))


def _both(W, job):
    """(reference shards, port shards) of ``job(ctx).node.materialize()``."""
    jctx = _jax_ctx(W)
    try:
        j = job(jctx).node.materialize()
        jrows, jcounts = j.to_global_numpy(), j.counts.copy()
    finally:
        jctx.close()
    t = job(tt.Context(num_workers=W, device="cpu")).node.materialize()
    return (jrows, jcounts), (t.to_global_numpy(), t.counts)


def _assert_same(ref, port):
    (jrows, jcounts), (trows, tcounts) = ref, port
    assert np.array_equal(jcounts, tcounts)
    if isinstance(jrows, dict):
        assert sorted(jrows) == sorted(trows)
        for k in jrows:
            assert trows[k].dtype == jrows[k].dtype, k
            assert np.array_equal(trows[k], jrows[k]), k
    else:
        assert np.array_equal(trows, np.asarray(jrows))


def _terarecs(n, seed):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 256, (n, 10)).astype(np.uint8)
    key[: n // 4, :9] = 0            # duplicate keys: ties by global index
    return {"key": key,
            "value": rng.integers(0, 256, (n, 90)).astype(np.uint8)}


@pytest.mark.parametrize("W", WIDTHS)
def test_terasort_rows_match_reference(W):
    recs = _terarecs(3000, W)
    ref, port = _both(W, lambda c: c.Distribute(recs).Sort(
        key_fn=lambda r: r["key"]))
    _assert_same(ref, port)
    # and the rows are np.lexsort's order of the records, stable by index
    kp = np.zeros((3000, 16), np.uint8)
    kp[:, :10] = recs["key"]
    kw = kp.view(">u8").astype(np.uint64)
    order = np.lexsort((kw[:, 1], kw[:, 0]))
    assert np.array_equal(port[0]["value"], recs["value"][order])


@pytest.mark.parametrize("W", WIDTHS)
def test_filtered_int_key_sort_matches_reference(W):
    """Ragged shards (a Filter) bring in the validity word; many equal
    keys test the global-index tie-break across workers."""
    rng = np.random.default_rng(10 + W)
    recs = {"k": rng.integers(-5, 5, 2500).astype(np.int64),
            "v": np.arange(2500, dtype=np.int64)}
    ref, port = _both(W, lambda c: c.Distribute(recs)
                      .Filter(lambda r: r["v"] % 3 != 0)
                      .Map(lambda r: {"k": r["k"], "v": r["v"] * 2})
                      .Sort(key_fn=lambda r: r["k"]))
    _assert_same(ref, port)


@pytest.mark.parametrize("W", WIDTHS)
def test_float_and_tuple_key_sort_matches_reference(W):
    rng = np.random.default_rng(20 + W)
    x = rng.normal(size=2000)
    x[::7] = -0.0
    x[::11] = 0.0
    recs = {"x": x, "t": rng.integers(0, 3, 2000).astype(np.int32)}
    ref, port = _both(W, lambda c: c.Distribute(recs).Sort(
        key_fn=lambda r: (r["t"], r["x"])))
    _assert_same(ref, port)


@pytest.mark.parametrize("W", WIDTHS)
def test_generate_sort_size_and_allgather_match_reference(W):
    def job(ctx):
        d = ctx.Generate(1000, lambda i: (i * 7919) % 1009).Sort().Keep()
        return d.Size(), d.AllGather()

    jctx = _jax_ctx(W)
    try:
        jsize, jitems = job(jctx)
    finally:
        jctx.close()
    tsize, titems = job(tt.Context(num_workers=W, device="cpu"))
    assert tsize == jsize == 1000
    assert titems == jitems


@pytest.mark.parametrize("W", WIDTHS)
def test_same_shards_through_both_sample_sorts(W):
    """Reference shards, fetched as numpy and carried over with
    ``from_numpy_shards``, sort to the same rows in both packages."""
    recs = _terarecs(2000, 30 + W)
    jctx = _jax_ctx(W)
    try:
        jsh = jctx.Distribute(recs).Filter(
            lambda r: r["key"][:, 9] % 5 != 0).node.materialize()
        tree = {k: np.asarray(v) for k, v in jsh.tree.items()}
        counts = jsh.counts.copy()
        key_fn = lambda r: r["key"]
        jout = jsort._device_sample_sort(jsh, key_fn, (key_fn,))
        ref = (jout.to_global_numpy(), jout.counts.copy())
    finally:
        jctx.close()
    tsh = tshards.from_numpy_shards(tree, counts, device="cpu")
    assert tsh.cap == tree["key"].shape[1]
    tout = tsort._device_sample_sort(tsh, key_fn)
    _assert_same(ref, (tout.to_global_numpy(), tout.counts))


def test_all_gather_arrays_and_run_local_tests():
    recs = _terarecs(500, 7)

    def job(ctx):
        out = ctx.Distribute(recs).Sort(
            key_fn=lambda r: r["key"]).AllGatherArrays()
        mex = ctx.mesh_exec
        return ({k: v.numpy() for k, v in out.items()},
                mex.stats_exchanges, mex.stats_items_moved)

    res = tt.RunLocalTests(job, worker_counts=WIDTHS, device="cpu")
    assert [r[1] for r in res] == [0, 1, 1]     # W = 1 ships nothing
    assert res[0][2] == 0 and res[1][2] > 0 and res[2][2] > res[1][2]
    for r in res[1:]:
        for k in recs:
            assert np.array_equal(r[0][k], res[0][0][k])


def test_entry_points_refuse_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tt.Context(num_workers=2)
    with pytest.raises(RuntimeError):
        tt.Run(lambda ctx: None, num_workers=1)


def test_port_imports_neither_jax_nor_reference():
    pkg = os.path.join(REPO, "thrill_tpu_torch")
    bad = re.compile(r"^\s*(import|from)\s+(jax|thrill_tpu)(\s|\.|$)",
                     re.M)
    sources = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
               if f.endswith(".py")]
    assert len(sources) > 10
    # the chip smoke runs the port alone too (it imports the op battery
    # from the package's examples, not from the tests)
    sources.append(os.path.join(REPO, "chip_smoke.py"))
    for path in sources:
        with open(path) as f:
            assert not bad.search(f.read()), path
    probe = (
        "import importlib, pkgutil, sys\n"
        "import thrill_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'thrill_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'thrill_tpu' or m.startswith('thrill_tpu.')]\n"
        "print(len(sys.modules)); assert not bad, bad\n"
        # the modules of the mesh of several processes among them
        "new = ['thrill_tpu_torch.' + m for m in ('net.group', 'net.mock',"
        " 'net.flow', 'net.tcp', 'net.wire', 'common.platform',"
        " 'common.timeouts', 'api.device_exec', 'data.multiplexer')]\n"
        "assert all(m in sys.modules for m in new), new\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                   check=True, timeout=120, capture_output=True)


# -- the W > 1 sort's programs (ROADMAP.md fault C19) ------------------------

def _tkey(r):
    return r["key"]


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("n", [1 << 12, 1 << 16])
def test_sample_sort_dispatches_the_reference_s_programs(W, n, monkeypatch):
    """A W > 1 Sort of TeraSort records runs the reference's three
    programs (``sort_keys``, ``sort_classify``, ``sort_fused``: 3
    dispatches, where an eager classify and a ship program a leaf made
    5) and makes its counted fetches (the samples and the send matrix);
    rows equal."""
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    sys.path.insert(0, os.path.join(REPO, "examples"))
    import terasort as jts
    recs = jts.generate_records(n, seed=5)
    out = {}
    for pkg, make in (("ref", _jax_ctx), ("port", lambda W: tt.Context(
            num_workers=W, device="cpu"))):
        ctx = make(W)
        src = ctx.Distribute(recs).Cache()
        src.Keep().Size()
        s0 = ctx.overall_stats()
        got = src.Sort(key_fn=_tkey).node.materialize()
        s1 = ctx.overall_stats()
        out[pkg] = ({k: s1[k] - s0[k] for k in ("device_dispatches",
                                                  "device_fetches")},
                    got.to_global_numpy())
        if pkg == "port":
            progs = sorted(k[0] for k in ctx.mesh_exec._cache
                           if isinstance(k, tuple) and k
                           and str(k[0]).startswith("sort_"))
        ctx.close()
    assert out["port"][0] == out["ref"][0]
    assert out["port"][0]["device_dispatches"] == 3
    assert progs == ["sort_classify", "sort_fused", "sort_keys"]
    for k in out["ref"][1]:
        assert np.array_equal(out["port"][1][k], np.asarray(out["ref"][1][k]))


@pytest.mark.parametrize("W", [2, 4])
def test_percentiles_dispatches_are_the_reference_s(W, monkeypatch):
    """``examples/percentiles.py`` (a W > 1 Sort, then ZipWithIndex and a
    Filter): the reference's answer, dispatches and counted fetches."""
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    sys.path.insert(0, os.path.join(REPO, "examples"))
    import percentiles as jp
    from thrill_tpu_torch.examples import percentiles as tp
    v = np.random.default_rng(2).integers(0, 1 << 40, 1 << 14)
    out = {}
    for pkg, mod, make in (("ref", jp, _jax_ctx),
                           ("port", tp, lambda W: tt.Context(
                               num_workers=W, device="cpu"))):
        ctx = make(W)
        res = mod.percentiles(ctx, v)
        st = ctx.overall_stats()
        out[pkg] = (res, st["device_dispatches"], st["device_fetches"])
        ctx.close()
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("W", [2, 4])
def test_generic_path_runs_a_final_merge_program(W, monkeypatch):
    """``THRILL_TPU_SORT_FUSED=0``: the classify program, the planned
    exchange's phase B and one ``sort_final`` program; rows equal to the
    reference's generic path and to the fused one."""
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    rng = np.random.default_rng(W)
    items = {"k": rng.integers(0, 1 << 20, 3000).astype(np.int64),
             "v": np.arange(3000, dtype=np.int64)}
    fused = _both(W, lambda c: c.Distribute(items).Sort(key_fn=_tkey_k))
    monkeypatch.setenv("THRILL_TPU_SORT_FUSED", "0")
    ref, port = _both(W, lambda c: c.Distribute(items).Sort(key_fn=_tkey_k))
    _assert_same(ref, port)
    _assert_same(fused[1], port)


def _tkey_k(r):
    return r["k"]
