"""The port's ``s3://`` and ``hdfs://`` backends (``thrill_tpu_torch/vfs/
s3_file.py``, ``hdfs_file.py``) against stub SDKs, as the reference's
``tests/vfs/test_s3.py`` tests its own: boto3 is a module made here, and
HDFS is a fake ``HadoopFileSystem`` client or pyarrow's real
``LocalFileSystem`` behind the same interface. Neither SDK runs a real
connection here. Each round trip runs on the port and on the reference
over the same stub and must list, read and write the same bytes.
Tolerance: exact.
"""

import io
import sys
import types

import pytest

from thrill_tpu.vfs import file_io as jfio
from thrill_tpu.vfs import hdfs_file as jhdfs

from thrill_tpu_torch.vfs import file_io, hdfs_file, s3_file


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("THRILL_TPU_OBJECT_STORE_ENDPOINT", "AWS_ENDPOINT_URL"):
        monkeypatch.delenv(var, raising=False)


def test_s3_gated_without_sdk(monkeypatch):
    monkeypatch.setitem(sys.modules, "boto3", None)
    with pytest.raises(NotImplementedError, match="boto3"):
        file_io.Glob("s3://bucket/prefix*")
    with pytest.raises(NotImplementedError, match="ENDPOINT"):
        file_io.OpenWriteStream("s3://bucket/key")


def test_parse_s3_path():
    assert s3_file.parse_s3_path("s3://b/k/ey.txt") == ("b", "k/ey.txt")
    assert s3_file.parse_s3_path("s3://b") == ("b", "")
    with pytest.raises(ValueError):
        s3_file.parse_s3_path("s3:///nope")


class _StubBody(io.BytesIO):
    pass


def _stub_boto3(objects):
    """A boto3 of one bucket: a dict of key to bytes."""
    mod = types.ModuleType("boto3")

    class Paginator:
        def paginate(self, Bucket, Prefix):
            contents = [{"Key": k, "Size": len(v)}
                        for k, v in sorted(objects.items())
                        if k.startswith(Prefix)]
            yield {"Contents": contents}

    uploads = {}

    class Client:
        def get_paginator(self, name):
            return Paginator()

        def get_object(self, Bucket, Key, Range=None):
            data = objects[Key]
            if Range:
                start = int(Range.split("=")[1].rstrip("-"))
                data = data[start:]
            return {"Body": _StubBody(data)}

        def put_object(self, Bucket, Key, Body):
            objects[Key] = bytes(Body)

        def create_multipart_upload(self, Bucket, Key):
            uid = f"up-{len(uploads)}"
            uploads[uid] = {}
            return {"UploadId": uid}

        def upload_part(self, Bucket, Key, UploadId, PartNumber, Body):
            uploads[UploadId][PartNumber] = bytes(Body)
            mod._part_sizes.append(len(bytes(Body)))
            return {"ETag": f"etag-{UploadId}-{PartNumber}"}

        def complete_multipart_upload(self, Bucket, Key, UploadId,
                                      MultipartUpload):
            parts = MultipartUpload["Parts"]
            nums = [p["PartNumber"] for p in parts]
            assert nums == list(range(1, len(nums) + 1)), \
                "part numbers not contiguous"
            for p in parts:
                assert p["ETag"] == f"etag-{UploadId}-{p['PartNumber']}"
            objects[Key] = b"".join(uploads[UploadId][n] for n in nums)
            del uploads[UploadId]

        def abort_multipart_upload(self, Bucket, Key, UploadId):
            del uploads[UploadId]

    mod.client = lambda name: Client()
    mod._uploads = uploads
    mod._part_sizes = []
    return mod


def _s3_round_trip(fio, objects):
    fl = fio.Glob("s3://bkt/data/part-*.txt")
    out = [[(f.path, f.size, f.size_ex_psum) for f in fl.files],
           fl.total_size]
    with fio.OpenReadStream("s3://bkt/data/part-0.txt") as f:
        out.append(f.read())
    with fio.OpenReadStream("s3://bkt/data/part-0.txt", offset=6) as f:
        out.append(f.read())
    with fio.OpenWriteStream("s3://bkt/out/res.txt") as f:
        f.write(b"abc")
    out.append(objects.pop("out/res.txt"))
    return out


def test_s3_glob_read_write_roundtrip(monkeypatch):
    objects = {"data/part-0.txt": b"hello\nworld\n",
               "data/part-1.txt": b"more\n",
               "data/part-1.bin": b"\x00\x01"}
    monkeypatch.setitem(sys.modules, "boto3", _stub_boto3(objects))
    got = _s3_round_trip(file_io, objects)
    assert got[0] == [("s3://bkt/data/part-0.txt", 12, 0),
                      ("s3://bkt/data/part-1.txt", 5, 12)]
    assert got[1:] == [17, b"hello\nworld\n", b"world\n", b"abc"]
    assert got == _s3_round_trip(jfio, objects)


def test_s3_multipart_upload(monkeypatch):
    objects = {}
    stub = _stub_boto3(objects)
    monkeypatch.setitem(sys.modules, "boto3", stub)
    payload = bytes(range(256)) * 50_000     # 12.8 MB: two parts
    with file_io.OpenWriteStream("s3://bkt/out/big.bin") as f:
        for i in range(0, len(payload), 1 << 16):
            f.write(payload[i:i + (1 << 16)])
    assert objects["out/big.bin"] == payload
    assert stub._part_sizes == [8 << 20, len(payload) - (8 << 20)]
    assert not stub._uploads
    with file_io.OpenWriteStream("s3://bkt/out/small.bin") as f:
        f.write(b"tiny")
    assert objects["out/small.bin"] == b"tiny"
    assert len(stub._part_sizes) == 2 and not stub._uploads


def test_s3_multipart_abort_on_failure(monkeypatch):
    objects = {"out/fail.bin": b"previous-good-output"}
    stub = _stub_boto3(objects)
    monkeypatch.setitem(sys.modules, "boto3", stub)
    with pytest.raises(RuntimeError, match="producer died"):
        with file_io.OpenWriteStream("s3://bkt/out/fail.bin") as f:
            f.write(b"x" * (9 << 20))
            assert stub._uploads
            raise RuntimeError("producer died")
    assert not stub._uploads
    assert objects["out/fail.bin"] == b"previous-good-output"


def test_s3_single_write_larger_than_part_is_sliced(monkeypatch):
    objects = {}
    stub = _stub_boto3(objects)
    monkeypatch.setitem(sys.modules, "boto3", stub)
    w = s3_file._S3WriteStream("bkt", "out/huge.bin", part_size=5 << 20)
    payload = bytes(range(256)) * 70_000     # about 17.9 MB in one write
    w.write(payload)
    w.close()
    assert objects["out/huge.bin"] == payload
    assert stub._part_sizes[:3] == [5 << 20] * 3
    assert len(stub._part_sizes) == 4
    assert all(s <= (5 << 20) for s in stub._part_sizes)
    assert not stub._uploads


def test_s3_read_fault_site_reopens_at_the_position(monkeypatch):
    """``vfs.s3.read`` fires inside boto3's stream; the retrying reader
    reopens the range where it stood (a ranged ``get_object``)."""
    from thrill_tpu_torch.common import faults
    data = bytes(range(256)) * 40
    objects = {"k": data}
    stub = _stub_boto3(objects)
    monkeypatch.setitem(sys.modules, "boto3", stub)
    monkeypatch.setenv("THRILL_TPU_PREFETCH", "0")
    monkeypatch.setenv("THRILL_TPU_RETRY_BASE_S", "0.001")
    faults.REGISTRY.reset()
    with file_io.OpenReadStream("s3://bkt/k") as f:
        head = f.read(1000)
        with faults.inject("vfs.s3.read", n=1):
            rest = f.read()
    assert head + rest == data
    assert faults.REGISTRY.stats()["faults_injected"] == 1
    faults.REGISTRY.reset()


def test_hdfs_gated_without_runtime():
    with pytest.raises(NotImplementedError, match="hdfs"):
        file_io.Glob("hdfs://namenode:9000/data/part-*")
    with pytest.raises(NotImplementedError, match="Hadoop"):
        file_io.OpenWriteStream("hdfs://namenode:9000/out/x")


def test_hdfs_path_parse():
    assert hdfs_file.parse_hdfs_path("hdfs://nn:9000/a/b.txt") == \
        ("nn", 9000, "/a/b.txt")
    assert hdfs_file.parse_hdfs_path("hdfs:///a/b.txt") == ("", 0, "/a/b.txt")


class _FakeHdfsClient:
    """A ``pyarrow.fs.HadoopFileSystem`` of one dict."""

    def __init__(self, objects):
        self.objects = objects

    def get_file_info(self, sel_or_paths):
        from pyarrow import fs as pafs
        if isinstance(sel_or_paths, list):
            out = []
            for p in sel_or_paths:
                key = p.lstrip("/")
                if key in self.objects:
                    out.append(types.SimpleNamespace(
                        type=pafs.FileType.File, path=p,
                        size=len(self.objects[key])))
                elif any(k.startswith(key.rstrip("/") + "/")
                         for k in self.objects):
                    out.append(types.SimpleNamespace(
                        type=pafs.FileType.Directory, path=p, size=0))
                else:
                    out.append(types.SimpleNamespace(
                        type=pafs.FileType.NotFound, path=p, size=0))
            return out
        base = sel_or_paths.base_dir.strip("/")
        out = []
        for k, v in sorted(self.objects.items()):
            parent = k.rsplit("/", 1)[0] if "/" in k else ""
            if sel_or_paths.recursive:
                if not k.startswith(base + "/") and parent != base:
                    continue
            elif parent != base:
                continue
            out.append(types.SimpleNamespace(
                type=pafs.FileType.File, path="/" + k, size=len(v)))
        return out

    def open_input_stream(self, path):
        return io.BytesIO(self.objects[path.lstrip("/")])

    def open_output_stream(self, path):
        client = self

        class W(io.BytesIO):
            def close(w):
                client.objects[path.lstrip("/")] = w.getvalue()
                io.BytesIO.close(w)

        return W()


def _hdfs_round_trip(fio, url, read_back):
    fl = fio.Glob(url + "/part-*.txt")
    out = [[(f.path, f.size, f.size_ex_psum) for f in fl.files],
           fl.total_size]
    with fio.OpenReadStream(url + "/part-0.txt") as f:
        out.append(f.read())
    with fio.OpenReadStream(url + "/part-0.txt", offset=6) as f:
        out.append(f.read())
    with fio.OpenWriteStream(url + "/out.txt") as f:
        f.write(b"abc")
    out.append(read_back())
    return out


def test_hdfs_against_real_pyarrow_filesystem(monkeypatch, tmp_path):
    """Every code path against pyarrow's real ``LocalFileSystem`` (the
    interface ``HadoopFileSystem`` implements); only the connection is
    substituted."""
    pafs = pytest.importorskip("pyarrow.fs")
    base = tmp_path / "data"
    base.mkdir()
    (base / "part-0.txt").write_bytes(b"hello\nworld\n")
    (base / "part-1.txt").write_bytes(b"more\n")
    (base / "part-1.bin").write_bytes(b"\x00\x01")
    for mod in (hdfs_file, jhdfs):
        monkeypatch.setattr(mod, "_connect",
                            lambda h, p: pafs.LocalFileSystem())
    url = f"hdfs://nn:9000{base}"

    def read_back():
        return (base / "out.txt").read_bytes()
    got = _hdfs_round_trip(file_io, url, read_back)
    assert got[0] == [(url + "/part-0.txt", 12, 0),
                      (url + "/part-1.txt", 5, 12)]
    assert got[1:] == [17, b"hello\nworld\n", b"world\n", b"abc"]
    assert got == _hdfs_round_trip(jfio, url, read_back)
    assert len(file_io.Glob(url).files) == 4


def test_hdfs_glob_read_write_roundtrip(monkeypatch):
    objects = {"data/part-0.txt": b"hello\nworld\n",
               "data/part-1.txt": b"more\n",
               "data/part-1.bin": b"\x00\x01"}
    client = _FakeHdfsClient(objects)
    for mod in (hdfs_file, jhdfs):
        monkeypatch.setattr(mod, "_connect", lambda h, p: client)
    url = "hdfs://nn:9000/data"
    got = _hdfs_round_trip(file_io, url, lambda: objects.pop("data/out.txt"))
    assert got[0] == [(url + "/part-0.txt", 12, 0),
                      (url + "/part-1.txt", 5, 12)]
    assert got[1:] == [17, b"hello\nworld\n", b"world\n", b"abc"]
    assert got == _hdfs_round_trip(jfio, url,
                                   lambda: objects.pop("data/out.txt"))


def test_hdfs_open_fault_site_retries(monkeypatch):
    """``vfs.hdfs.open`` fires at the ranged open; the retrying reader
    opens again and reads the same bytes."""
    from thrill_tpu_torch.common import faults
    objects = {"d/x.txt": b"0123456789" * 10}
    client = _FakeHdfsClient(objects)
    monkeypatch.setattr(hdfs_file, "_connect", lambda h, p: client)
    monkeypatch.setenv("THRILL_TPU_RETRY_BASE_S", "0.001")
    faults.REGISTRY.reset()
    with faults.inject("vfs.hdfs.open", n=2):
        with file_io.OpenReadStream("hdfs://nn:1/d/x.txt", offset=15) as f:
            assert f.read() == objects["d/x.txt"][15:]
    assert faults.REGISTRY.stats()["faults_injected"] == 2
    faults.REGISTRY.reset()
