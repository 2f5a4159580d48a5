"""The port's external-memory host Sort against the reference package on
the CPU.

Host items go through ``Sort`` in ``thrill_tpu`` and ``thrill_tpu_torch``
at W = 1-4 with ``THRILL_TPU_HOST_SORT_RUN=500`` (runs of 500 items,
spilled) and ``THRILL_TPU_SPILL_RESIDENT=64K`` (the store keeps 64 KiB in
RAM, the rest goes to disk, so the merge reads runs back from files).
Per worker the lists must be equal, and so must the sort's counters:
``runs``, ``engine``, ``records_blocks`` and ``writeback_bytes`` (the
bytes the spill wrote, equal only if every block's bytes are). Timings
are left out. The item kinds: ints, ASCII strings, ``(int, float, str)``
tuples, a ``compare_fn`` sort, a stream whose keys turn from int to
float part way (the key engine demotes to Python comparisons and the
records encoder to pickle), and strings with a trailing NUL (which the
records refuse).
"""

import functools

import numpy as np
import pytest

from thrill_tpu.api import Context as JContext
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt

N = 3100
STATS = ("runs", "engine", "records_blocks", "runs_reused",
         "writeback_bytes", "writeback_sync")


@pytest.fixture(autouse=True)
def _em_env(monkeypatch):
    for var in ("THRILL_TPU_PREFETCH", "THRILL_TPU_WRITEBACK",
                "THRILL_TPU_NATIVE_RECORDS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("THRILL_TPU_HOST_SORT_RUN", "500")
    monkeypatch.setenv("THRILL_TPU_SPILL_RESIDENT", "64K")


def _items(kind, n=N, seed=7):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 400, n).tolist()          # many equal keys
    if kind in ("int", "compare_fn"):
        return v
    if kind == "str":
        return [f"k{x:05d}-{x % 7}" for x in v]
    if kind == "tuple":
        f = rng.standard_normal(n).tolist()
        return [(x, y, f"s{x % 13}") for x, y in zip(v, f)]
    if kind == "deviation":
        cut = int(0.6 * n)
        return v[:cut] + [x + 0.5 for x in v[cut:]]
    if kind == "nul":
        return [f"w{x % 50}" + "\x00" * (x % 3) for x in v]
    raise ValueError(kind)


def _desc(a, b):
    return a > b


def _sort(dia, kind):
    if kind == "compare_fn":
        return dia.Sort(compare_fn=_desc)
    if kind == "tuple":
        return dia.Sort(key_fn=lambda t: (t[2], t[0]))
    return dia.Sort()


def _run(ctx, items, kind):
    node = _sort(ctx.Distribute(list(items), storage="host"), kind).node
    hs = node.materialize()
    stats = getattr(node, "_em_stats", {})
    return [list(l) for l in hs.lists], {k: stats.get(k) for k in STATS}


KINDS = ["int", "str", "tuple", "compare_fn", "deviation", "nul"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_em_sort_matches_the_reference(W, kind):
    items = _items(kind)
    jctx = JContext(JMeshExec(num_workers=W))
    try:
        want, jstats = _run(jctx, items, kind)
    finally:
        jctx.close()
    got, tstats = _run(tt.Context(num_workers=W, device="cpu"), items, kind)
    assert got == want
    assert tstats == jstats
    assert tstats["runs"] == -(-N // 500)
    assert tstats["records_blocks"] > 0 and tstats["writeback_bytes"] > 0
    assert tstats["engine"] == ("py" if kind in ("compare_fn", "deviation")
                                else "native")
    flat = [it for l in got for it in l]
    if kind == "compare_fn":
        key = functools.cmp_to_key(
            lambda a, b: -1 if _desc(a, b) else (1 if _desc(b, a) else 0))
        assert flat == sorted(items, key=key)
    elif kind == "tuple":
        assert flat == sorted(items, key=lambda t: (t[2], t[0]))
    else:
        assert flat == sorted(items)


@pytest.mark.parametrize("off", ["THRILL_TPU_WRITEBACK", "THRILL_TPU_PREFETCH",
                                 "THRILL_TPU_NATIVE_RECORDS"])
def test_em_sort_settings_change_no_result(monkeypatch, off):
    """Write-behind, readahead and the columnar records off: the same
    lists as the reference under the same setting; without the records
    no block is columnar."""
    monkeypatch.setenv(off, "0")
    items = _items("tuple", seed=3)
    jctx = JContext(JMeshExec(num_workers=3))
    try:
        want, jstats = _run(jctx, items, "tuple")
    finally:
        jctx.close()
    got, tstats = _run(tt.Context(num_workers=3, device="cpu"), items,
                       "tuple")
    assert got == want and tstats == jstats
    if off == "THRILL_TPU_NATIVE_RECORDS":
        assert tstats["records_blocks"] == 0
    if off == "THRILL_TPU_WRITEBACK":
        assert tstats["writeback_sync"] is True


def test_a_short_host_sort_stays_in_memory():
    items = _items("str", n=400)
    node = tt.Context(num_workers=2, device="cpu").Distribute(
        items, storage="host").Sort().node
    hs = node.materialize()
    assert not hasattr(node, "_em_stats")
    assert [it for l in hs.lists for it in l] == sorted(items)


def test_em_sort_of_unpicklable_items_sorts_in_memory():
    """A local lambda cannot be pickled: the first run's spill fails. A
    kept input is still whole, so its items sort in memory, as in the
    reference; a consumed one had lists emptied, so the error is raised
    (the reference would sort what was left)."""
    fns = [(i % 37, lambda: 0) for i in range(1200)]
    ctx = tt.Context(num_workers=2, device="cpu")
    src = ctx.Distribute(fns, storage="host").Keep()
    node = src.Sort(key_fn=lambda t: t[0]).node
    got = [it for l in node.materialize().lists for it in l]
    assert [t[0] for t in got] == sorted(t[0] for t in fns)
    with pytest.raises(AttributeError, match="local object"):
        src.Sort(key_fn=lambda t: t[0]).node.materialize()
