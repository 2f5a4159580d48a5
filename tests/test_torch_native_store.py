"""The port's native spill store (``native/blockstore.cpp`` through
``data/block_pool.py``), built with g++ at first use, against the
Python store and the reference package's native store: put, get and
``get_into``, spill to disk and read back under a 64 KiB soft limit,
pins, drops, refcounts, close, and the bytes of every block and spill
file equal across the three."""

import os

import numpy as np
import pytest

from thrill_tpu.data import block_pool as jbp

from thrill_tpu_torch.common import native_build
from thrill_tpu_torch.data import block_pool as tbp

SOFT = 64 << 10
BLOCK = 16 << 10


def _blocks(n, size=BLOCK, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.bytes(size) for _ in range(n)]


def _block_of(name):
    """The block id in a spill file's name: ``<block>`` in the
    reference's, ``<block>.<seq>`` in the port's."""
    return int(name.split("-")[4].split(".")[0])


def _pools(tmp_path):
    """(name, pool) of the port's native and Python stores and the
    reference's store, each in a directory of its own."""
    out = []
    for name, make in (
            ("native", lambda d: tbp.BlockPool(spill_dir=d, soft_limit=SOFT)),
            ("python", lambda d: tbp.BlockPool(spill_dir=d, soft_limit=SOFT,
                                               use_native=False)),
            ("reference", lambda d: jbp.BlockPool(spill_dir=d,
                                                  soft_limit=SOFT))):
        d = tmp_path / name
        d.mkdir()
        out.append((name, make(str(d)), d))
    return out


def test_the_native_store_builds_here():
    pool = tbp.BlockPool(soft_limit=SOFT)
    assert pool.native
    assert tbp.BlockPool(soft_limit=SOFT, use_native=False).native is False
    pool.close()


def test_put_get_spill_and_read_back_equal_across_stores(tmp_path):
    blocks = _blocks(20)
    seen = {}
    for name, pool, d in _pools(tmp_path):
        ids = [pool.put(b) for b in blocks]
        pool.flush()
        files = sorted(os.listdir(d))
        # the soft limit holds four blocks; the rest went to disk, oldest
        # first, named as the reference names them
        assert pool.mem_usage == SOFT and pool.num_blocks == 20
        assert len(files) == 16 and pool.pending_spills == 0
        host = tbp._sanitized_host()
        assert all(f.startswith(f"ttpu-blk-{os.getpid()}-")
                   and f.endswith(f"-{host}.spill") for f in files)
        on_disk = {_block_of(f): (d / f).read_bytes() for f in files}
        assert set(on_disk) == set(ids[:16])
        assert all(on_disk[i] == blocks[ids.index(i)] for i in on_disk)
        assert [pool.get(i) for i in ids] == blocks
        if name != "reference":
            assert pool.bytes_spilled == 16 * BLOCK
            assert not pool.resident(ids[0]) and pool.resident(ids[-1])
            out = np.zeros(BLOCK + 7, dtype=np.uint8)
            pool.get_into(ids[3], out)
            assert out[:BLOCK].tobytes() == blocks[3]
            with pytest.raises(ValueError):
                pool.get_into(ids[3], np.zeros(BLOCK - 1, dtype=np.uint8))
        seen[name] = sorted(on_disk.values())
        pool.drop(ids[0])
        with pytest.raises(KeyError):
            pool.get(ids[0])
        assert len(os.listdir(d)) == 15
        pool.close()
        assert os.listdir(d) == []
    assert seen["native"] == seen["python"] == seen["reference"]


def test_arrays_go_in_by_pointer_and_come_back_byte_equal(tmp_path):
    pool = tbp.BlockPool(spill_dir=str(tmp_path), soft_limit=SOFT)
    arrays = [np.arange(5000, dtype=np.int64),
              np.linspace(0, 1, 3000).astype(np.float32).reshape(100, 30),
              np.arange(20, dtype=np.int64)[::2]]          # not contiguous
    ids = [pool.put(a) for a in arrays]
    for a, i in zip(arrays, ids):
        assert pool.get(i) == np.ascontiguousarray(a).tobytes()
        assert pool.size(i) == a.nbytes
    assert pool.bytes_put == sum(a.nbytes for a in arrays)
    pool.close()
    assert pool.bytes_spilled == 0          # 52 KiB fit the soft limit


@pytest.mark.parametrize("native", [True, False])
def test_pins_keep_blocks_in_ram_and_refcounts_share_them(tmp_path, native):
    pool = tbp.BlockPool(spill_dir=str(tmp_path), soft_limit=SOFT,
                         use_native=native)

    def on_disk():
        pool.flush()
        return {_block_of(n) for n in os.listdir(tmp_path)}

    first = pool.put(b"x" * BLOCK)
    pool.pin(first)
    blocks = _blocks(8, seed=1)
    ids = [pool.put(b) for b in blocks]
    assert first not in on_disk() and ids[0] in on_disk()
    # pinning a spilled block reads it back and keeps it
    pool.pin(ids[0])
    assert ids[0] not in on_disk() and pool.resident(ids[0])
    assert pool.get(ids[0]) == blocks[0]
    pool.unpin(first)
    pool.unpin(ids[0])
    for b in _blocks(SOFT // BLOCK, seed=2):
        pool.put(b)
    assert {first, ids[0]} <= on_disk()
    pool.addref(ids[-1])
    pool.release(ids[-1])
    assert pool.get(ids[-1]) == blocks[-1]
    pool.release(ids[-1])
    with pytest.raises(KeyError):
        pool.get(ids[-1])
    pool.close()
    assert os.listdir(tmp_path) == []


def test_the_python_store_writes_behind_or_in_turn(tmp_path, monkeypatch):
    for wb in ("1", "0"):
        monkeypatch.setenv("THRILL_TPU_WRITEBACK", wb)
        d = tmp_path / wb
        pool = tbp.BlockPool(spill_dir=str(d), soft_limit=SOFT,
                             use_native=False)
        blocks = _blocks(10)
        ids = [pool.put(b) for b in blocks]
        assert (pool._writer is not None) == (wb == "1")
        pool.flush()
        assert len(os.listdir(d)) == 6 and pool.mem_usage == SOFT
        assert [pool.get(i) for i in ids] == blocks
        pool.close()
        assert os.listdir(d) == []


def test_a_failed_build_says_why_once_and_the_python_store_runs(
        tmp_path, monkeypatch, capsys):
    (tmp_path / "broken.cpp").write_text("int main( {\n")
    monkeypatch.setattr(native_build, "NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(native_build, "_host_libs", {})
    assert native_build.load_host("broken") is None
    err = capsys.readouterr().err
    assert "native/broken.cpp failed" in err and "error" in err
    assert native_build.load_host("broken") is None
    assert capsys.readouterr().err == ""
    monkeypatch.setattr(tbp, "_LIB", None)
    monkeypatch.setattr(tbp, "_LIB_TRIED", False)
    monkeypatch.setattr(tbp, "load_host", lambda name: None)
    pool = tbp.BlockPool(spill_dir=str(tmp_path), soft_limit=SOFT)
    assert pool.native is False
    i = pool.put(b"abc")
    assert pool.get(i) == b"abc"
    pool.close()


def test_the_library_is_named_by_the_sources_hash():
    lib = native_build.load_host("blockstore")
    assert lib is not None
    name = os.path.basename(lib._name)
    assert name.startswith("libblockstore-") and name.endswith(".so")
    assert os.path.dirname(lib._name) == native_build.BUILD_DIR


@pytest.mark.parametrize("native", [True, False])
def test_concurrent_puts_gets_and_drops_keep_every_block(tmp_path, native):
    """More threads than cores put, read back, pin and drop blocks under
    a soft limit of four blocks while the store's writer spills behind
    them; every read must give the block's own bytes."""
    import sys
    import threading

    pool = tbp.BlockPool(spill_dir=str(tmp_path), soft_limit=4 * 4096,
                         use_native=native)
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        mine = {}
        try:
            for i in range(60):
                data = rng.bytes(4096)
                mine[pool.put(data)] = data
                bid = list(mine)[int(rng.integers(len(mine)))]
                if i % 7 == 0:
                    pool.pin(bid)
                    assert pool.get(bid) == mine[bid]
                    pool.unpin(bid)
                assert pool.get(bid) == mine[bid]
                if i % 5 == 4:
                    pool.drop(bid)
                    del mine[bid]
            for bid, data in mine.items():
                assert pool.get(bid) == data
        except BaseException as e:         # reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(s,))
                   for s in range(2 * (os.cpu_count() or 2) + 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    pool.close()
    assert os.listdir(tmp_path) == []


def test_a_respill_while_the_cancelled_write_is_in_flight_keeps_its_file(
        tmp_path):
    """Fault C13: a block whose spill is in flight is pinned (the write
    is cancelled), unpinned and spilled again before the writer thread
    finishes the first write. The writer then deletes the cancelled
    request's file, which must not be the new spill's. The store's
    writer hold makes the window deterministic."""
    import time

    pool = tbp.BlockPool(spill_dir=str(tmp_path), soft_limit=BLOCK)
    lib, h = pool._lib, pool._h
    a_bytes, b_bytes, c_bytes = _blocks(3, seed=5)
    lib.bs_hold_writer(h, 1)
    a = pool.put(a_bytes)
    b = pool.put(b_bytes)                  # over the limit: a's write
    deadline = time.monotonic() + 10
    while lib.bs_hold_writer(h, -1) != 1:  # ... is taken by the writer
        assert time.monotonic() < deadline
        time.sleep(0.001)
    pool.pin(a)                            # cancels the write in flight
    pool.unpin(a)                          # b goes to disk in its place
    pool.put(c_bytes)                      # a again, on this thread
    assert not pool.resident(a)
    lib.bs_hold_writer(h, 0)
    pool.flush()
    files_of_a = [f for f in os.listdir(tmp_path) if _block_of(f) == a]
    assert len(files_of_a) == 1
    assert (tmp_path / files_of_a[0]).read_bytes() == a_bytes
    assert pool.get(a) == a_bytes and pool.get(b) == b_bytes
    pool.close()
    assert os.listdir(tmp_path) == []
