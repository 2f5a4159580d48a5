"""The port's file sources and sinks against the reference package's
(``tests/api/test_read_write.py``, case for case, plus straddling
boundaries). Per-worker lists and counts must equal the reference's
``RunLocalMock`` runs, and written files must equal the reference's byte
for byte. All comparisons are exact."""

import gzip
import os

import numpy as np
import pytest

from thrill_tpu.api import RunLocalMock

import thrill_tpu_torch as tt
from thrill_tpu_torch.api.ops.read_write import _worker_path
from thrill_tpu_torch.vfs import file_io

WIDTHS = [1, 2, 4]
SPLIT_WIDTHS = [1, 2, 3, 4, 5]


def _per_worker(shards):
    """Host lists, or device shards as per-worker numpy pytrees."""
    if hasattr(shards, "lists"):
        return [list(l) for l in shards.lists]
    return shards.to_worker_arrays()


def _ref(W, make):
    return RunLocalMock(lambda c: _per_worker(make(c).node.materialize()), W)


def _port(W, make):
    return _per_worker(make(tt.Context(num_workers=W, device="cpu"))
                       .node.materialize())


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and \
            np.array_equal(a, b)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def _same_per_worker(W, make):
    want, got = _ref(W, make), _port(W, make)
    assert len(got) == len(want) == W
    for w in range(W):
        assert _same(want[w], got[w]), (w, want[w], got[w])
    return got


def _files(d):
    return {p: open(os.path.join(d, p), "rb").read()
            for p in sorted(os.listdir(d))}


# -- the reference's cases --------------------------------------------------

def test_glob_psum(tmp_path):
    for i, content in enumerate([b"aa", b"bbbb", b"c"]):
        (tmp_path / f"f{i}.txt").write_bytes(content)
    fl = file_io.Glob(str(tmp_path / "*.txt"))
    assert len(fl) == 3
    assert [f.size for f in fl.files] == [2, 4, 1]
    assert [f.size_ex_psum for f in fl.files] == [0, 2, 6]
    assert fl.total_size == 7


@pytest.mark.parametrize("W", WIDTHS)
def test_read_lines_range_split(tmp_path, W):
    lines = [f"line-{i:04d}" for i in range(1000)]
    path = str(tmp_path / "in.txt")
    (tmp_path / "in.txt").write_text("\n".join(lines) + "\n")
    got = _same_per_worker(W, lambda c: c.ReadLines(path))
    assert [x for l in got for x in l] == lines
    ctx = tt.Context(num_workers=W, device="cpu")
    assert ctx.ReadLines(path).AllGather() == lines


@pytest.mark.parametrize("W", WIDTHS)
def test_read_lines_multifile_and_unicode(tmp_path, W):
    all_lines = []
    for i in range(3):
        ls = [f"f{i}-ünï-{j}" for j in range(50)]
        all_lines.extend(ls)
        (tmp_path / f"part{i}.txt").write_text("\n".join(ls) + "\n")
    pat = str(tmp_path / "part*.txt")
    got = _same_per_worker(W, lambda c: c.ReadLines(pat))
    assert [x for l in got for x in l] == all_lines


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_read_lines_gzip(tmp_path, W):
    lines = [f"zipped {i}" for i in range(100)]
    for k in range(3):
        with gzip.open(tmp_path / f"in{k}.txt.gz", "wt") as f:
            f.write("\n".join(lines[k::3]) + "\n")
    pat = str(tmp_path / "in*.txt.gz")
    got = _same_per_worker(W, lambda c: c.ReadLines(pat))
    assert sorted(x for l in got for x in l) == sorted(lines)


@pytest.mark.parametrize("W", WIDTHS)
def test_write_lines_roundtrip(tmp_path, W):
    for mod, root in (("port", tmp_path / "port"), ("ref", tmp_path / "ref")):
        pat = str(root / "out-$$$$$.txt")

        def job(ctx, pat=pat):
            ctx.Generate(100, fn=lambda i: i, storage="host").Map(
                lambda x: f"v{x}").WriteLines(pat)
            return ctx.ReadLines(pat.replace("$$$$$", "*")).AllGather()
        back = (job(tt.Context(num_workers=W, device="cpu")) if mod == "port"
                else RunLocalMock(job, W))
        assert sorted(back) == sorted(f"v{i}" for i in range(100))
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    assert len(_files(tmp_path / "port")) == W


@pytest.mark.parametrize("W", WIDTHS)
def test_write_lines_one(tmp_path, W):
    for mod, p in (("port", tmp_path / "p.txt"), ("ref", tmp_path / "r.txt")):
        def job(ctx, p=str(p)):
            ctx.Generate(50, storage="host").Map(str).WriteLinesOne(p)
        (job(tt.Context(num_workers=W, device="cpu")) if mod == "port"
         else RunLocalMock(job, W))
    assert (tmp_path / "p.txt").read_text().splitlines() == [
        str(i) for i in range(50)]
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "r.txt").read_bytes()


@pytest.mark.parametrize("W", WIDTHS)
def test_binary_roundtrip(tmp_path, W):
    recs = np.random.default_rng(0).integers(
        0, 255, size=(500, 8)).astype(np.uint8)
    for mod, root in (("port", tmp_path / "port"), ("ref", tmp_path / "ref")):
        pat = str(root / "bin-$$$$$.dat")

        def job(ctx, pat=pat):
            ctx.Distribute(recs).WriteBinary(pat)
        (job(tt.Context(num_workers=W, device="cpu")) if mod == "port"
         else RunLocalMock(job, W))
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    pat = str(tmp_path / "port" / "bin-*.dat")
    got = _same_per_worker(W, lambda c: c.ReadBinary(
        pat, dtype=np.uint8, record_shape=(8,)))
    assert np.array_equal(np.concatenate(got), recs)
    ctx = tt.Context(num_workers=W, device="cpu")
    back = ctx.ReadBinary(pat, dtype=np.uint8, record_shape=(8,))
    assert np.array_equal(np.stack(back.AllGather()), recs)


def test_read_lines_missing_file():
    ctx = tt.Context(num_workers=2, device="cpu")
    with pytest.raises(FileNotFoundError):
        ctx.ReadLines("/nonexistent/nowhere-*.txt").AllGather()
    with pytest.raises(FileNotFoundError):
        ctx.ReadWordsPacked("/nonexistent/nowhere-*.txt").AllGather()


# -- items straddling every boundary ------------------------------------------

def _straddle_files(tmp_path):
    """Tiny files whose lines and words cross the byte-range edges of
    every W up to 5: long and empty lines, no final newline, CRLF,
    separator runs and a file that is one word."""
    rng = np.random.default_rng(11)
    texts = [
        b"alpha beta\ngamma\n\ndelta epsilon zeta eta theta\n",
        b"iota",
        b"  kappa\tlambda\r\nmu nu\x0bxi\x0comicron  ",
        b"\n\n\n",
        b"pi rho sigma tau upsilon phi chi psi omega " * 3 + b"end",
        bytes(rng.choice(list(b"ab \n"), size=97).tolist()),
    ]
    for i, t in enumerate(texts):
        (tmp_path / f"s{i}.txt").write_bytes(t)
    return str(tmp_path / "s*.txt"), texts


@pytest.mark.parametrize("W", SPLIT_WIDTHS)
def test_read_lines_straddling_boundaries(tmp_path, W):
    pat, texts = _straddle_files(tmp_path)
    got = _same_per_worker(W, lambda c: c.ReadLines(pat))
    assert [x for l in got for x in l] == [
        line for t in texts for line in t.decode().splitlines()]


@pytest.mark.parametrize("W", SPLIT_WIDTHS)
@pytest.mark.parametrize("max_word", [3, 16])
def test_read_words_packed_straddling_boundaries(tmp_path, W, max_word):
    pat, texts = _straddle_files(tmp_path)
    got = _same_per_worker(W, lambda c: c.ReadWordsPacked(pat, max_word))
    words = [w[:max_word] for t in texts for w in t.split()]
    flat = np.concatenate([g["w"] for g in got])
    assert [bytes(r).rstrip(b"\0") for r in flat] == words


@pytest.mark.parametrize("W", SPLIT_WIDTHS)
def test_read_words_packed_compressed_whole_files(tmp_path, W):
    for k in range(4):
        with gzip.open(tmp_path / f"z{k}.txt.gz", "wb") as f:
            f.write(b" ".join(b"w%d_%d" % (k, j) for j in range(k * 7 + 1)))
    pat = str(tmp_path / "z*.gz")
    _same_per_worker(W, lambda c: c.ReadWordsPacked(pat))


@pytest.mark.parametrize("W", SPLIT_WIDTHS)
def test_read_binary_records_across_files(tmp_path, W):
    # int32 records of 3, files cut mid-record; the tail is dropped
    data = np.arange(3 * 37, dtype=np.int32).tobytes() + b"\x01\x02"
    cuts = [0, 10, 11, 60, 200, 301, len(data)]
    for i in range(len(cuts) - 1):
        (tmp_path / f"r{i}.bin").write_bytes(data[cuts[i]:cuts[i + 1]])
    pat = str(tmp_path / "r*.bin")
    got = _same_per_worker(W, lambda c: c.ReadBinary(
        pat, dtype=np.int32, record_shape=(3,)))
    assert np.array_equal(np.concatenate(got),
                          np.arange(3 * 37, dtype=np.int32).reshape(-1, 3))


@pytest.mark.parametrize("W", WIDTHS)
def test_read_binary_scalar_records(tmp_path, W):
    vals = np.random.default_rng(W).normal(size=41)
    (tmp_path / "f.bin").write_bytes(vals.tobytes())
    got = _same_per_worker(W, lambda c: c.ReadBinary(
        str(tmp_path / "f.bin"), dtype=np.float64))
    assert np.array_equal(np.concatenate(got), vals)


# -- writers of every storage ------------------------------------------------

WRITE_SOURCES = {
    "device dict": lambda c: c.Distribute({
        "k": np.arange(13, dtype=np.int64),
        "v": np.arange(26, dtype=np.float32).reshape(13, 2)}),
    "device after filter": lambda c: c.Generate(40).Filter(
        lambda x: x % 3 == 0),
    "host ints": lambda c: c.Generate(17, storage="host"),
    "host tuples": lambda c: c.Distribute(
        [(i, "s%d" % i) for i in range(9)]),
}


# strings have no fixed record size: no WriteBinary of host tuples
WRITES = [(src, sink) for src in sorted(WRITE_SOURCES)
          for sink in ("WriteLines", "WriteLinesOne", "WriteBinary")
          if (src, sink) != ("host tuples", "WriteBinary")]


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("src,sink", WRITES)
def test_writers_bytes_equal_reference(tmp_path, W, src, sink):
    name = "out.txt" if sink == "WriteLinesOne" else "out-$$$$$.bin"
    for mod in ("port", "ref"):
        path = str(tmp_path / mod / name)

        def job(ctx, path=path):
            getattr(WRITE_SOURCES[src](ctx), sink)(path)
        (job(tt.Context(num_workers=W, device="cpu")) if mod == "port"
         else RunLocalMock(job, W))
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")


@pytest.mark.parametrize("pattern,w,want", [
    ("out-$$$$$.txt", 3, "out-00003.txt"),
    ("part{}.txt", 12, "part12.txt"),
    ("dir/out.txt", 0, "dir/out-00000.txt"),
    ("noext", 7, "noext-00007"),
])
def test_worker_path_patterns(pattern, w, want):
    from thrill_tpu.api.ops.read_write import _worker_path as ref
    assert _worker_path(pattern, w) == ref(pattern, w) == want
