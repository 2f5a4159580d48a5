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


@pytest.mark.parametrize("scheme", ["s3", "hdfs", "http", "https"])
def test_remote_schemes_reach_their_backends(scheme, tmp_path, monkeypatch):
    """Each remote scheme lists, reads at an offset, writes and writes
    atomically through its backend, as the reference's does on the same
    store: ``s3://`` through the REST transport, ``hdfs://`` through
    pyarrow's LocalFileSystem in the HadoopFileSystem's place, ``http://``
    on the object server and ``https://`` on it too (its connection
    class swapped for a plain one). No local directory is made."""
    import builtins
    import http.client

    from thrill_tpu.vfs import hdfs_file as jhdfs
    from thrill_tpu_torch.tools.object_server import ObjectServer
    from thrill_tpu_torch.vfs import hdfs_file as thdfs
    real_import = builtins.__import__

    def no_boto3(name, *a, **kw):
        if name == "boto3":
            raise ImportError("no boto3")
        return real_import(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_boto3)
    root = tmp_path / "root"
    root.mkdir()
    monkeypatch.chdir(root)
    with ObjectServer() as srv:
        monkeypatch.setenv("THRILL_TPU_OBJECT_STORE_ENDPOINT", srv.url)
        if scheme == "hdfs":
            from pyarrow import fs as pafs
            for mod in (thdfs, jhdfs):
                monkeypatch.setattr(mod, "_connect",
                                    lambda h, p: pafs.LocalFileSystem())
            base = f"hdfs://nn:9000{tmp_path}/data"
            (tmp_path / "data").mkdir()
        elif scheme == "https":
            port = srv.port

            def plain(host, p, timeout=None, **kw):
                return http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=timeout)
            monkeypatch.setattr(http.client, "HTTPSConnection", plain)
            base = "https://objects.test/b/data"
        elif scheme == "s3":
            base = "s3://b/data"
        else:
            base = f"{srv.url}/b/data"
        got = []
        for side, fio in (("j", jfio), ("t", tfio)):
            payload = bytes(range(256)) * 9
            with fio.OpenWriteStream(f"{base}/{side}-0.bin") as f:
                f.write(payload)
            fio.write_file_atomic(f"{base}/{side}-1.bin", b"manifest")
            fl = fio.Glob(f"{base}/{side}-*")
            with fio.OpenReadStream(f"{base}/{side}-0.bin", offset=300) as f:
                tail = f.read()
            got.append(([(f.size, f.size_ex_psum) for f in fl.files],
                        fl.total_size, tail))
        assert got[0] == got[1] == ([(2304, 0), (8, 2304)], 2312,
                                    payload[300:])
    assert os.listdir(root) == []
