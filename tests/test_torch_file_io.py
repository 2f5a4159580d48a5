"""The port's ``vfs/file_io.py`` against the reference package's on the
same file trees. Everything is compared exactly: file lists, sizes,
prefix sums and bytes."""

import bz2
import dataclasses
import gzip
import lzma
import os

import numpy as np
import pytest

from thrill_tpu.vfs import file_io as jfio

from thrill_tpu_torch.vfs import file_io as tfio


@pytest.fixture
def tree(tmp_path):
    rng = np.random.default_rng(3)
    (tmp_path / "sub").mkdir()
    for name in ("a.txt", "b.txt", "c.dat", "sub/d.txt", "sub/e.txt"):
        (tmp_path / name).write_bytes(rng.bytes(int(rng.integers(0, 300))))
    for name, opener in (("f.txt.gz", gzip.open), ("g.txt.bz2", bz2.open),
                         ("h.txt.xz", lzma.open)):
        with opener(tmp_path / name, "wb") as f:
            f.write(b"compressed " + name.encode() + b"\n" * 40)
    return tmp_path


def _plain(fl):
    return [dataclasses.astuple(f) for f in fl.files], fl.total_size, \
        fl.contains_compressed, len(fl)


@pytest.mark.parametrize("pattern", [
    "*.txt", "*", "sub", "sub/*.txt", "*.t?t*", "file://{}/*.txt",
    "a.txt", "missing*", "*.gz", "[ab].txt"])
def test_glob_matches_reference(tree, pattern):
    pat = (pattern.format(tree) if "{}" in pattern
           else str(tree / pattern))
    got, want = tfio.Glob(pat), jfio.Glob(pat)
    assert _plain(got) == _plain(want)
    sizes = [f.size for f in got.files]
    assert [f.size_ex_psum for f in got.files] == list(
        np.cumsum([0] + sizes)[:-1])


def test_directory_glob_of_the_root(tree):
    assert _plain(tfio.Glob(str(tree))) == _plain(jfio.Glob(str(tree)))
    assert tfio.Glob(str(tree)).contains_compressed


@pytest.mark.parametrize("offset", [0, 1, 17, 299, 300, 10_000])
def test_open_read_stream_at_offsets(tmp_path, offset):
    data = np.random.default_rng(offset).bytes(300)
    p = tmp_path / "x.bin"
    p.write_bytes(data)
    with tfio.OpenReadStream(str(p), offset) as f:
        assert f.read() == data[offset:]
    with tfio.OpenReadStream(str(p), offset, readahead_to=5) as f:
        assert f.read(7) == data[offset:offset + 7]


@pytest.mark.parametrize("suffix,opener", [
    (".gz", gzip.open), (".bz2", bz2.open), (".xz", lzma.open)])
def test_compressed_read_and_seek_error(tmp_path, suffix, opener):
    p = str(tmp_path / ("t.txt" + suffix))
    with opener(p, "wb") as f:
        f.write(b"hello\nworld\n")
    with tfio.OpenReadStream(p) as f:
        assert f.read() == b"hello\nworld\n"
    with pytest.raises(ValueError) as want:
        jfio.OpenReadStream(p, 3)
    with pytest.raises(ValueError) as got:
        tfio.OpenReadStream(p, 3)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["out.txt", "deep/er/out.txt",
                                  "deep/z.gz", "q/r.xz", "b/c.bz2"])
def test_open_write_stream_makes_directories(tmp_path, name):
    payload = b"line one\nline two\n" * 5
    for mod, root in ((tfio, tmp_path / "port"), (jfio, tmp_path / "ref")):
        with mod.OpenWriteStream(str(root / name)) as f:
            f.write(payload)
    with tfio.OpenReadStream(str(tmp_path / "port" / name)) as f:
        assert f.read() == payload
    if not name.endswith((".gz", ".xz", ".bz2")):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "ref" / name).read_bytes())


def test_write_file_atomic(tmp_path):
    p = tmp_path / "m" / "manifest.json"
    tfio.write_file_atomic(str(p), b"first")
    tfio.write_file_atomic(str(p), b"second")
    assert p.read_bytes() == b"second"
    assert os.listdir(tmp_path / "m") == ["manifest.json"]


@pytest.mark.parametrize("url", ["s3://bucket/key", "hdfs://nn/x",
                                 "http://host/x", "https://host/x"])
def test_remote_schemes_name_the_roadmap(url):
    for call in (lambda: tfio.Glob(url), lambda: tfio.OpenReadStream(url),
                 lambda: tfio.OpenWriteStream(url)):
        with pytest.raises(NotImplementedError, match="queue A"):
            call()
