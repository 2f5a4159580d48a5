"""The port's external-memory host tables (``core/em_table.py``) and the
host ReduceByKey/GroupByKey that stand on them, against the reference
package on the CPU.

``THRILL_TPU_HOST_TABLE_CAP`` forces a small in-RAM entry cap, so a few
thousand keys spill and recurse. The tables must emit what the
reference's emit, in the same order, with the same spill statistics;
results must equal a Counter; spills, recursion depth and peak in-RAM
entries are bounded; no spill file outlives its pool, also when
``reduce_fn`` raises. Nothing here reads a clock."""

import collections
import os
import random

import jax
import numpy as np
import pytest

from thrill_tpu.api import Context as JContext
from thrill_tpu.core import em_table as jem
from thrill_tpu.data.block_pool import BlockPool as JBlockPool
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.common.config import Config
from thrill_tpu_torch.core import em_table as tem
from thrill_tpu_torch.data.block_pool import BlockPool

CAP = 128
WIDTHS = [1, 2, 3, 4]


@pytest.fixture
def tiny_cap(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_HOST_TABLE_CAP", str(CAP))


@pytest.fixture
def spill_dir(tmp_path, monkeypatch):
    """A spill directory of the test's own, with every spill store
    keeping at most 64 KiB resident, so spills reach the disk."""
    d = tmp_path / "spill"
    d.mkdir()
    monkeypatch.setenv("THRILL_TPU_SPILL_DIR", str(d))
    monkeypatch.setenv("THRILL_TPU_SPILL_RESIDENT", "64K")
    return d


def _add(a, b):
    return (a[0], a[1] + b[1])


def _reduce_emit(mod, pool_cls, keys, values=None, reduce_fn=_add):
    pool = pool_cls(soft_limit=1 << 20)
    t = mod.EMReduceTable(reduce_fn, pool, mem_limit=1 << 20)
    try:
        for i, k in enumerate(keys):
            t.insert(k, (k, 1) if values is None else values[i])
        out = list(t.emit())
        t.close()
    finally:
        pool.close()
    return out, t.stats


def _group_emit(mod, pool_cls, items, mem_limit=1 << 20):
    pool = pool_cls(soft_limit=1 << 20)
    buf = mod.EMGroupBuffer(pool, mem_limit=mem_limit)
    try:
        for k, v in items:
            buf.add(k, (k, v))
        out = [(k, [v for _, v in vs]) for k, vs in buf.groups()]
        buf.close()
    finally:
        pool.close()
    return out, buf.stats


# -- the tables against the reference's ------------------------------------------

@pytest.mark.parametrize("distinct", [100, 3000, 20000])
def test_em_reduce_table_emits_the_references_order(tiny_cap, distinct):
    rng = random.Random(distinct)
    keys = [f"k{rng.randrange(distinct)}" for _ in range(40_000)]
    got, stats = _reduce_emit(tem, BlockPool, keys)
    want, jstats = _reduce_emit(jem, JBlockPool, keys)
    assert got == want
    assert stats == jstats
    assert dict(got) == collections.Counter(keys)
    assert stats["peak_entries"] <= CAP
    if distinct > CAP:
        # far more keys than in-RAM entries: spilled and recursed
        assert stats["spills"] > 0 and stats["max_depth"] >= 1
        assert stats["max_depth"] <= tem.MAX_DEPTH
    else:
        assert stats["spills"] == 0


def test_em_reduce_table_partial_aggregates_exact(tiny_cap):
    rng = random.Random(5)
    keys = [rng.randrange(1500) for _ in range(20_000)]
    vals = [rng.randrange(100) for _ in keys]
    want = collections.defaultdict(int)
    for k, v in zip(keys, vals):
        want[k] += v
    got, stats = _reduce_emit(tem, BlockPool, keys, vals,
                              lambda a, b: a + b)
    ref, _ = _reduce_emit(jem, JBlockPool, keys, vals, lambda a, b: a + b)
    assert got == ref
    assert sorted(got) == sorted(want.values())
    assert stats["spills"] > 0


def test_em_reduce_table_growing_aggregates_spill(monkeypatch):
    """Aggregates that grow spill on the RSS trigger at a constant entry
    count, and re-reduce exactly."""
    pool = BlockPool(soft_limit=1 << 20)
    t = tem.EMReduceTable(lambda a, b: a + b, pool, mem_limit=1 << 20)
    monkeypatch.setattr(t.budget, "exceeded", lambda: True)
    want = collections.defaultdict(int)
    try:
        for i in range(5000):
            want[i % 20] += i
            t.insert(i % 20, i)
        got = sorted(t.emit())
        t.close()
    finally:
        pool.close()
    assert got == sorted(want.values())
    assert t.stats["spills"] > 0


@pytest.mark.parametrize("groups", [5, 200, 3000])
def test_em_group_buffer_matches_reference_in_arrival_order(tiny_cap,
                                                            groups):
    rng = random.Random(groups)
    items = [(f"g{rng.randrange(groups)}", i) for i in range(15_000)]
    want: dict = {}
    for k, v in items:
        want.setdefault(k, []).append(v)
    got, stats = _group_emit(tem, BlockPool, items)
    ref, jstats = _group_emit(jem, JBlockPool, items)
    assert got == ref and stats == jstats
    assert dict(got) == want
    assert stats["spills"] > 0 and stats["peak_entries"] <= CAP


def test_em_group_buffer_without_spill_is_insertion_ordered():
    got, stats = _group_emit(tem, BlockPool, [("b", 1), ("a", 2), ("b", 3)],
                             mem_limit=0)
    assert got == [("b", [1, 3]), ("a", [2])]
    assert stats["spills"] == 0


@pytest.mark.parametrize("mem_limit,sample,want", [
    (0, ("w", 1), 1 << 22), (1 << 20, ("w", 1), None),
    (100, ("w", 1), 64), (1 << 40, ("w", 1), 1 << 26)])
def test_entry_cap_matches_reference(mem_limit, sample, want):
    got = tem.entry_cap(mem_limit, sample)
    assert got == jem.entry_cap(mem_limit, sample)
    if want is not None:
        assert got == want


# -- host ReduceByKey / GroupByKey under a forced cap ------------------------------

def _ref(W, job):
    jctx = JContext(JMeshExec(devices=jax.devices("cpu")[:W]))
    try:
        return job(jctx)
    finally:
        jctx.close()


def _lists_and_stats(dia):
    shards = dia.node.materialize()
    return [list(l) for l in shards.lists], dia.node._em_stats


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("dup", [True, False])
def test_host_reduce_by_key_spills_like_the_reference(tiny_cap, W, dup):
    rng = random.Random(3)
    words = [f"w{rng.randrange(2000)}" for _ in range(20_000)]

    def job(ctx):
        d = ctx.Distribute([(w, 1) for w in words], storage="host")
        return _lists_and_stats(d.ReduceByKey(lambda kv: kv[0], _add,
                                              dup_detection=dup))

    got, stats = job(tt.Context(num_workers=W, device="cpu"))
    want, jstats = _ref(W, job)
    assert got == want
    assert dict(it for l in got for it in l) == collections.Counter(words)
    assert stats["spills"] > 0 and stats["max_depth"] >= 1
    assert stats["peak_entries"] <= CAP
    assert {k: stats[k] for k in jstats} == jstats


@pytest.mark.parametrize("W", WIDTHS)
def test_host_group_by_key_spills_like_the_reference(tiny_cap, W):
    rng = random.Random(9)
    items = [rng.randrange(1000) for _ in range(20_000)]

    def job(ctx):
        d = ctx.Distribute(items, storage="host")
        return _lists_and_stats(d.GroupByKey(lambda x: x,
                                             lambda k, vs: (k, len(vs))))

    got, stats = job(tt.Context(num_workers=W, device="cpu"))
    want, jstats = _ref(W, job)
    assert got == want
    assert dict(it for l in got for it in l) == collections.Counter(items)
    assert stats["spills"] > 0 and stats["peak_entries"] <= CAP
    assert {k: stats[k] for k in jstats} == jstats


@pytest.mark.parametrize("W", [2, 4])
def test_a_small_ram_grant_spills_to_disk_and_equals_the_unspilled_run(
        W, spill_dir):
    """THRILL_TPU_RAM cut to 3 MiB: a grant of 512 KiB sizes a table of a
    few thousand entries, the spill store keeps 64 KiB resident and
    writes the rest into the spill directory, which is empty afterwards.
    The RSS trigger may spill at other points than the reference's, so
    the lists are held as multisets."""
    rng = random.Random(7)
    words = [f"word{rng.randrange(30_000)}" for _ in range(60_000)]

    def run(config):
        ctx = tt.Context(num_workers=W, device="cpu", config=config)
        d = ctx.Distribute([(w, 1) for w in words], storage="host")
        return _lists_and_stats(d.ReduceByKey(lambda kv: kv[0], _add))

    plain, plain_stats = run(Config())
    small, stats = run(Config(ram=3 << 20, spill_dir=str(spill_dir)))
    assert plain_stats["spills"] == 0
    assert stats["spills"] > 0 and stats["max_depth"] >= 1
    assert stats["disk_bytes"] > 0
    assert [collections.Counter(l) for l in small] == \
        [collections.Counter(l) for l in plain]
    assert dict(it for l in small for it in l) == collections.Counter(words)
    assert os.listdir(spill_dir) == []


class Boom(Exception):
    pass


@pytest.mark.parametrize("op", ["ReduceByKey", "GroupByKey"])
def test_no_spill_file_is_left_when_the_user_function_raises(
        tiny_cap, spill_dir, op, monkeypatch):
    rng = random.Random(1)
    words = [f"w{rng.randrange(5000)}" for _ in range(20_000)]
    calls = [0]

    def bad(a, b):
        calls[0] += 1
        if calls[0] > 12_000:
            raise Boom()
        return _add(a, b)

    def bad_group(k, vs):
        calls[0] += 1
        if calls[0] > 1000:
            raise Boom()
        return k, len(vs)

    ctx = tt.Context(num_workers=2, device="cpu")
    d = ctx.Distribute([(w, 1) for w in words], storage="host")
    out = (d.ReduceByKey(lambda kv: kv[0], bad) if op == "ReduceByKey"
           else d.GroupByKey(lambda kv: kv[0], bad_group))
    seen = []
    real_close = BlockPool.close

    def spy(self):
        seen.append(len(os.listdir(spill_dir)))
        real_close(self)

    monkeypatch.setattr(BlockPool, "close", spy)
    with pytest.raises(Boom):
        out.AllGather()
    assert seen and seen[0] > 0          # spills had reached the disk
    assert os.listdir(spill_dir) == []


def test_reduce_to_index_and_dup_detection_with_a_tiny_cap(tiny_cap):
    words = [f"k{i % 400}" for i in range(8_000)]
    ctx = tt.Context(num_workers=3, device="cpu")
    d = ctx.Distribute([(w, 1) for w in words], storage="host")
    red = d.ReduceByKey(lambda kv: kv[0], _add, dup_detection=True)
    assert dict(red.AllGather()) == collections.Counter(words)
    assert np.sum(ctx.Distribute(list(range(50)), storage="host")
                  .ReduceToIndex(lambda x: x, lambda a, b: a, 50)
                  .AllGather()) == sum(range(50))
