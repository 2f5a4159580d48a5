"""The port's spill store and what stands under the host tables, against
the reference package on the CPU: ``data/serializer.py`` (payload bytes
equal to the reference's with its columnar records off, round trips,
slices), ``data/block_pool.py`` (spill to disk and restore under a
64 KiB soft limit, pins, refcounts, file naming, stale-file purge),
``data/file.py`` (writer and readers), ``common/config.py``,
``mem/manager.py`` and the Context's memory grants."""

import os
import pickle
import struct

import numpy as np
import pytest

from thrill_tpu.common import config as jconfig
from thrill_tpu.data import block_pool as jbp
from thrill_tpu.data import file as jfile
from thrill_tpu.data import serializer as jser
from thrill_tpu.mem import manager as jmanager

import thrill_tpu_torch as tt
from thrill_tpu_torch.common import config as tconfig
from thrill_tpu_torch.data import block_pool as tbp
from thrill_tpu_torch.data import file as tfile
from thrill_tpu_torch.data import serializer as tser
from thrill_tpu_torch.mem import manager as tmanager

SOFT = 64 << 10

BATCHES = {
    "empty": [],
    "ints": list(range(100)),
    "mixed": [1, "a", (2, 3.5), None, {"k": [1, 2]}, b"\x00x"],
    "pairs": [("word", i) for i in range(50)],
    "rows": [np.arange(4, dtype=np.int32) + i for i in range(30)],
    "matrices": [np.full((2, 3), i, dtype=np.float64) for i in range(9)],
    "ragged": [np.arange(3), np.arange(4)],
    "dtypes": [np.arange(3, dtype=np.int64), np.arange(3, dtype=np.int32)],
}


def _same(a, b):
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_serialize_batch_writes_the_references_bytes(name, monkeypatch):
    monkeypatch.setenv("THRILL_TPU_NATIVE_RECORDS", "0")
    items = BATCHES[name]
    data = tser.serialize_batch(items)
    assert data == jser.serialize_batch(items)
    assert _same(tser.deserialize_batch(data), jser.deserialize_batch(data))
    assert _same(tser.deserialize_batch(data), list(items))
    n = len(items)
    for lo, hi in [(0, n), (n // 3, n // 2), (n, n)]:
        want = jser.deserialize_slice(data, lo, hi)
        assert _same(tser.deserialize_slice(data, lo, hi), want)
        assert _same(list(tser.deserialize_iter(data, lo, hi)), want)


def test_a_columnar_payload_is_refused_by_name():
    """The columnar kind reads since the host Sort's spill came; a kind
    neither package writes is refused by name."""
    data = jser.serialize_batch([("word", 1), ("more", 2)])
    assert tser.deserialize_batch(data) == [("word", 1), ("more", 2)]
    header = pickle.dumps((7, None, 2))
    data = struct.pack("<I", len(header)) + header + b"\0" * 8
    with pytest.raises(ValueError, match="only raw, pickled and columnar"):
        tser.deserialize_batch(data)


def _fill(pool, n, size=16 << 10):
    rng = np.random.default_rng(n)
    blocks = [rng.bytes(size) for _ in range(n)]
    return blocks, [pool.put(b) for b in blocks]


def test_block_pool_spills_past_its_soft_limit_and_restores(tmp_path):
    pool = tbp.BlockPool(spill_dir=str(tmp_path), soft_limit=SOFT)
    blocks, ids = _fill(pool, 20)
    pool.flush()                           # the store spills behind put
    assert pool.mem_usage == SOFT and pool.num_blocks == 20
    names = sorted(os.listdir(tmp_path))
    assert len(names) == 20 - SOFT // (16 << 10)
    assert pool.bytes_put == 20 * (16 << 10)
    assert pool.bytes_spilled == len(names) * (16 << 10)
    host = tbp._sanitized_host()
    for n in names:
        assert n.startswith(f"ttpu-blk-{os.getpid()}-") and \
            n.endswith(f"-{host}.spill")
    # the oldest blocks went first; every block reads back
    assert {int(n.split("-")[4]) for n in names} == set(ids[:len(names)])
    assert [pool.get(i) for i in ids] == blocks
    pool.drop(ids[0])
    with pytest.raises(KeyError):
        pool.get(ids[0])
    assert len(os.listdir(tmp_path)) == len(names) - 1
    pool.close()
    assert os.listdir(tmp_path) == [] and pool.num_blocks == 0


def test_block_pool_pins_and_shared_views(tmp_path):
    pool = tbp.BlockPool(spill_dir=str(tmp_path), soft_limit=SOFT)
    first = pool.put(b"x" * (16 << 10))
    pool.pin(first)
    blocks, ids = _fill(pool, 8)

    def on_disk():
        pool.flush()
        return {int(n.split("-")[4]) for n in os.listdir(tmp_path)}

    assert first not in on_disk()          # pinned: never evicted
    pool.unpin(first)                      # the most recently used now
    for _ in range(SOFT // (16 << 10)):
        pool.put(b"y" * (16 << 10))
    assert first in on_disk()
    pool.addref(ids[-1])
    pool.release(ids[-1])
    assert pool.get(ids[-1]) == blocks[-1]
    pool.release(ids[-1])
    with pytest.raises(KeyError):
        pool.get(ids[-1])
    pool.close()
    assert os.listdir(tmp_path) == []


def test_spill_pool_sizing_and_the_resident_override(monkeypatch):
    monkeypatch.delenv("THRILL_TPU_SPILL_RESIDENT", raising=False)
    for grant in (None, 1 << 20, 1 << 30):
        assert tbp.spill_pool("x", grant)._soft == \
            max((grant or 256 << 20) // 4, 8 << 20)
    for env in ("64K", "1Mi", "1K", "junk"):
        monkeypatch.setenv("THRILL_TPU_SPILL_RESIDENT", env)
        assert tbp.resident_override() == jbp.resident_override()
    monkeypatch.setenv("THRILL_TPU_SPILL_RESIDENT", "1M")
    assert tbp.spill_pool("x", 1 << 30)._soft == 1 << 20


def test_purge_stale_spills_reclaims_dead_owners_only(tmp_path):
    host = tbp._sanitized_host()
    dead = 2 ** 22 + 12345               # above any pid the kernel hands out
    names = [f"ttpu-blk-{dead}-0x1-1-{host}.spill",
             f"ttpu-blk-{os.getpid()}-0x1-1-{host}.spill",
             f"ttpu-blk-{dead}-0x1-2-otherhost.spill", "unrelated.spill"]
    for n in names:
        (tmp_path / n).write_bytes(b"z")
    assert tbp.purge_stale_spills(str(tmp_path)) == 1
    assert sorted(os.listdir(tmp_path)) == sorted(names[1:])


@pytest.mark.parametrize("block_items", [1, 7, 4096])
def test_file_writer_and_readers_match_reference(tmp_path, block_items):
    items = [("w", i, float(i)) for i in range(100)]
    files = []
    for mod, pool in ((tfile, tbp.BlockPool(spill_dir=str(tmp_path),
                                            soft_limit=1024)),
                      (jfile, jbp.BlockPool(spill_dir=str(tmp_path),
                                            soft_limit=1 << 20))):
        f = mod.File(pool=pool, block_items=block_items)
        with f.writer() as w:
            for it in items:
                w.put(it)
        files.append((f, pool))
    (tf, tpool), (jf, jpool) = files
    assert [b.num_items for b in tf.blocks] == jf.block_counts
    assert list(tf.keep_reader()) == list(jf.keep_reader()) == items
    assert tf.num_items == 100
    if block_items < 100:                  # past the 1 KiB soft limit
        tpool.flush()
        assert os.listdir(tmp_path)
    assert list(tf.consume_reader()) == items and tf.blocks == []
    assert tpool.num_blocks == 0
    tf.close()
    jf.close()
    tpool.close()
    jpool.close()
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("text", ["100", "64K", "1Gi", "2GB", " 3 kib",
                                  "1.5M", "7b", "12T"])
def test_parse_si_iec_units_matches_reference(text):
    assert tconfig.parse_si_iec_units(text) == \
        jconfig.parse_si_iec_units(text)


def test_config_from_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("THRILL_TPU_RAM", "3Mi")
    monkeypatch.setenv("THRILL_TPU_HOST_RAM", "1G")
    monkeypatch.setenv("THRILL_TPU_SPILL_DIR", str(tmp_path))
    c = tconfig.Config.from_env()
    j = jconfig.Config.from_env()
    assert (c.ram, c.host_ram, c.spill_dir) == (j.ram, j.host_ram,
                                                j.spill_dir)
    for name in ("THRILL_TPU_RAM", "THRILL_TPU_HOST_RAM",
                 "THRILL_TPU_SPILL_DIR"):
        monkeypatch.delenv(name)
    monkeypatch.setenv("TMPDIR", str(tmp_path / "t"))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    c = tconfig.Config.from_env()
    assert (c.ram, c.host_ram) == (0, 0)
    assert c.spill_dir == tempfile.gettempdir()


def test_memory_split_and_the_rss_budget(monkeypatch):
    for total in (0, 10, 3 << 30, 12345678901):
        assert tmanager.MemoryConfig.split(total) == \
            tmanager.MemoryConfig(**vars(jmanager.MemoryConfig.split(total)))
    assert tmanager.process_rss() > 0
    rss = [1000]
    monkeypatch.setattr(tmanager, "process_rss", lambda: rss[0])
    b = tmanager.RssBudget(100, stride=2)
    rss[0] = 1200
    assert b.exceeded() is False         # not a stride call
    assert b.exceeded() is True and b.exceeded_now() is True
    b.reset()
    assert b.exceeded_now() is False
    assert tmanager.RssBudget(0).exceeded_now() is False


class _Node:
    label = "n"

    def __init__(self, req):
        self.req = req
        self._mem_grant = 0

    def mem_use(self):
        return self.req


def test_context_memory_grants(capsys):
    ctx = tt.Context(num_workers=2, device="cpu",
                     config=tconfig.Config(ram=3 << 30))
    assert ctx.ram_workers == 1 << 30
    a, b, c, d = _Node("max"), _Node("max"), _Node(4 << 30), _Node(None)
    assert ctx.negotiate_mem(a) and a.mem_limit == 512 << 20
    assert ctx.negotiate_mem(b) and b.mem_limit == 256 << 20
    assert ctx.negotiate_mem(c) and c.mem_limit == 256 << 20
    assert "short grant" in capsys.readouterr().err
    assert not ctx.negotiate_mem(d) and d.mem_limit is None
    for n in (c, b, a):
        ctx.release_mem(n)
    assert ctx._mem_reserved == 0
    # a reduce node holds its grant while it computes, and gives it back
    red = ctx.Distribute(["a", "b", "a"]).Map(lambda w: (w, 1)) \
        .ReducePair("sum")
    assert sorted(red.AllGather()) == [("a", 2), ("b", 1)]
    assert red.node.mem_limit == 512 << 20 and ctx._mem_reserved == 0
