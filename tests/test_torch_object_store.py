"""The port's object-store transport (``thrill_tpu_torch/vfs/
object_store.py``) and its object server (``thrill_tpu_torch/tools/
object_server.py``) against the reference package's.

The reference's ``tests/vfs/test_object_store.py`` transport cases, case
for case, on the port's client and server: ranged GETs, listings,
multipart writes, aborted writes, a 503 retried, a 404 not, a server
that ignores ``Range`` refused, a reopen at the position after a broken
stream, the counters and the latency ledger, ``s3://`` through the REST
transport without boto3. Then each package's client against the other's
server (the same requests and bytes), and the retry classification by
``http_status`` against the reference's. Tolerance: exact.
"""

import builtins
import os

import pytest

from thrill_tpu.common import retry as jretry
from thrill_tpu.common.iostats import IO as JIO
from thrill_tpu.tools.object_server import ObjectServer as JServer
from thrill_tpu.vfs import file_io as jfio

from thrill_tpu_torch.common import faults, iostats
from thrill_tpu_torch.common import retry as tretry
from thrill_tpu_torch.tools.object_server import ObjectServer
from thrill_tpu_torch.vfs import file_io, object_store

_ENV = ("THRILL_TPU_OBJECT_STORE_ENDPOINT", "THRILL_TPU_OBJECT_STORE_PART",
        "THRILL_TPU_OBJECT_STORE_TIMEOUT", "AWS_ENDPOINT_URL",
        "THRILL_TPU_PREFETCH")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("THRILL_TPU_RETRY_BASE_S", "0.01")
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    faults.REGISTRY.reset()
    object_store.latency_reset()
    yield
    faults.REGISTRY.reset()


@pytest.fixture()
def srv():
    with ObjectServer() as s:
        yield s


def _no_boto3(monkeypatch):
    real_import = builtins.__import__

    def no_boto3(name, *a, **kw):
        if name == "boto3":
            raise ImportError("no boto3")
        return real_import(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_boto3)


# -- the reference's transport cases -------------------------------------------

def test_put_get_roundtrip_and_ranged_read(srv):
    data = bytes(range(256)) * 64
    with file_io.OpenWriteStream(f"{srv.url}/b/obj.bin") as w:
        w.write(data)
    assert srv.objects["b/obj.bin"] == data
    with object_store.http_open_read(f"{srv.url}/b/obj.bin") as r:
        assert r.read() == data
    with object_store.http_open_read(f"{srv.url}/b/obj.bin",
                                     offset=1000) as r:
        assert r.read() == data[1000:]


def test_glob_lists_keys_with_sizes(srv):
    for i in range(3):
        srv.put(f"b/in-{i:02d}.txt", b"x" * (10 + i))
    srv.put("b/other.txt", b"zz")
    infos = file_io.Glob(f"{srv.url}/b/in-*")
    assert [i.path for i in infos] == \
        [f"{srv.url}/b/in-{k:02d}.txt" for k in range(3)]
    assert [i.size for i in infos] == [10, 11, 12]
    assert [i.size_ex_psum for i in infos] == [0, 10, 21]
    assert srv.stats()["lists"] == 1


def test_retry_through_503(srv):
    srv.put("b/k", b"payload-bytes")
    srv.fail_next(2)
    with file_io.OpenReadStream(f"{srv.url}/b/k") as r:
        assert r.read() == b"payload-bytes"
    # two answered 503 before the GET counter, one served
    assert srv.stats()["requests"] == 3
    assert srv.stats()["gets"] == 1


def test_404_is_permanent(srv):
    with pytest.raises(FileNotFoundError):
        object_store.http_open_read(f"{srv.url}/b/missing")
    assert srv.stats()["gets"] == 1
    # through the vfs: no retry; the readahead's failed open, then the
    # demand read's, as in the reference
    for fio in (jfio, file_io):
        g0 = srv.stats()["gets"]
        with pytest.raises(FileNotFoundError):
            fio.OpenReadStream(f"{srv.url}/b/missing").read()
        assert srv.stats()["gets"] - g0 == 2


def test_range_ignored_is_loud(srv):
    srv.put("b/k", b"0123456789")
    srv.set_honor_range(False)
    with pytest.raises(object_store.HTTPStatusError):
        object_store.http_open_read(f"{srv.url}/b/k", offset=4)
    # through the vfs: permanent, so no retry; the readahead's GET, then
    # the demand read's, as in the reference
    for fio in (jfio, file_io):
        g0 = srv.stats()["gets"]
        with pytest.raises(OSError, match="ignored Range"):
            with fio.OpenReadStream(f"{srv.url}/b/k", offset=4) as r:
                r.read()
        assert srv.stats()["gets"] - g0 == 2


def _raise_reset(*a, **kw):
    raise ConnectionResetError("connection died mid-stream")


def test_reader_reopens_at_offset_through_vfs_seam(srv, monkeypatch):
    monkeypatch.setenv("THRILL_TPU_PREFETCH", "0")
    data = os.urandom(1 << 16)
    srv.put("b/k", data)
    got = b""
    with file_io.OpenReadStream(f"{srv.url}/b/k") as r:
        got += r.read(100)
        # the next read fails in the middle of the stream and must go
        # on from one ranged GET at the position, not from byte 0
        r._f.raw._resp.read = _raise_reset
        got += r.read()
    assert got == data
    assert srv.stats()["gets"] == 2


def test_multipart_upload(srv, monkeypatch):
    monkeypatch.setenv("THRILL_TPU_OBJECT_STORE_PART", str(1 << 16))
    data = os.urandom(5 * (1 << 16) + 123)
    with file_io.OpenWriteStream(f"{srv.url}/b/big.bin") as w:
        for off in range(0, len(data), 1000):
            w.write(data[off:off + 1000])
    assert srv.objects["b/big.bin"] == data
    assert srv.stats()["puts"] == 6          # 5 full parts and the last


def test_aborted_write_publishes_nothing(srv, monkeypatch):
    monkeypatch.setenv("THRILL_TPU_OBJECT_STORE_PART", str(1 << 16))
    with pytest.raises(RuntimeError, match="boom"):
        with file_io.OpenWriteStream(f"{srv.url}/b/never.bin") as w:
            w.write(os.urandom(1 << 17))
            raise RuntimeError("boom")
    assert "b/never.bin" not in srv.objects
    assert not srv._httpd.uploads            # the upload was aborted


def test_write_file_atomic_over_http(srv):
    file_io.write_file_atomic(f"{srv.url}/b/at.bin", b"atomic-bytes")
    assert srv.objects["b/at.bin"] == b"atomic-bytes"
    assert not os.path.exists("http:")       # no local directory


def test_remote_counters_and_latency(srv):
    srv.put("b/k", b"abc")
    srv.set_latency(0.005)
    io0 = iostats.IO.snapshot()
    with object_store.http_open_read(f"{srv.url}/b/k") as r:
        r.read()
    with file_io.OpenWriteStream(f"{srv.url}/b/k2") as w:
        w.write(b"def")
    d = iostats.IO.delta(iostats.IO.snapshot(), io0)
    assert d["remote_gets"] == 1 and d["remote_puts"] == 1
    assert object_store.get_p50_ms() >= 5.0
    object_store.latency_reset()
    assert object_store.get_p50_ms() == 0.0


def test_the_settings(monkeypatch):
    assert object_store.endpoint() is None
    monkeypatch.setenv("AWS_ENDPOINT_URL", "http://h:1/")
    assert object_store.endpoint() == "http://h:1"
    monkeypatch.setenv("THRILL_TPU_OBJECT_STORE_ENDPOINT", "http://h:2")
    assert object_store.endpoint() == "http://h:2"
    assert object_store.s3_rest_url("s3://b/k/x") == "http://h:2/b/k/x"
    assert object_store.part_size() == 8 << 20
    monkeypatch.setenv("THRILL_TPU_OBJECT_STORE_PART", "100")
    assert object_store.part_size() == 1 << 16
    monkeypatch.setenv("THRILL_TPU_OBJECT_STORE_TIMEOUT", "2.5")
    assert object_store.timeout_s() == 2.5


# -- s3:// without the SDK --------------------------------------------------------

def test_s3_scheme_via_rest_fallback(srv, monkeypatch):
    _no_boto3(monkeypatch)
    monkeypatch.setenv("THRILL_TPU_OBJECT_STORE_ENDPOINT", srv.url)
    with file_io.OpenWriteStream("s3://b/via-rest.txt") as w:
        w.write(b"hello s3\n")
    assert srv.objects["b/via-rest.txt"] == b"hello s3\n"
    with file_io.OpenReadStream("s3://b/via-rest.txt") as r:
        assert r.read() == b"hello s3\n"
    with file_io.OpenReadStream("s3://b/via-rest.txt", offset=6) as r:
        assert r.read() == b"s3\n"
    infos = file_io.Glob("s3://b/via-*")
    assert [i.path for i in infos] == ["s3://b/via-rest.txt"]


def test_s3_still_gated_without_endpoint(monkeypatch):
    _no_boto3(monkeypatch)
    with pytest.raises(NotImplementedError, match="boto3"):
        file_io.Glob("s3://bucket/prefix*")


# -- across the packages ----------------------------------------------------------

@pytest.mark.parametrize("server", ["port", "ref"])
def test_both_clients_on_each_server(server, monkeypatch):
    """Each package's client writes, lists and reads ranges on the other
    package's server and its own: the same objects, listings, bytes and
    requests."""
    monkeypatch.setenv("THRILL_TPU_OBJECT_STORE_PART", str(1 << 16))
    data = os.urandom(3 * (1 << 16) + 77)
    with (ObjectServer() if server == "port" else JServer()) as s:
        seen = {}
        for side, fio in (("ref", jfio), ("port", file_io)):
            r0 = s.stats()
            with fio.OpenWriteStream(f"{s.url}/b/{side}.bin") as w:
                w.write(data)
            fio.write_file_atomic(f"{s.url}/b/{side}.txt", b"small")
            listing = [(os.path.basename(f.path), f.size, f.size_ex_psum)
                       for f in fio.Glob(f"{s.url}/b/{side}*")]
            with fio.OpenReadStream(f"{s.url}/b/{side}.bin",
                                    offset=12345) as r:
                tail = r.read()
            r1 = s.stats()
            seen[side] = (listing, tail,
                          {k: r1[k] - r0[k] for k in r1})
        assert s.objects["b/ref.bin"] == s.objects["b/port.bin"] == data
        (jl, jt, jc), (tl, tt_, tc) = seen["ref"], seen["port"]
        assert [x[1:] for x in jl] == [x[1:] for x in tl]
        assert jt == tt_ == data[12345:]
        assert jc == tc


@pytest.mark.parametrize("status,want", [
    (500, "transient"), (502, "transient"), (503, "transient"),
    (408, "transient"), (429, "transient"), (400, "permanent"),
    (401, "permanent"), (405, "permanent"), (416, "permanent"),
    (200, "permanent")])
def test_http_status_classification_is_the_references(status, want):
    e = object_store.HTTPStatusError(status, "http://h/b/k")
    je = OSError("x")
    je.http_status = status
    assert tretry.default_policy().classify(e) == want
    assert jretry.default_policy().classify(je) == want


def test_the_remote_counters_are_the_references():
    assert set(iostats.IO.snapshot()) == set(JIO.snapshot())
    assert {"remote_gets", "remote_puts"} <= set(iostats._COUNTERS)


def test_the_object_server_counts_as_the_references():
    """The same requests give the same counters on both servers."""
    got = []
    for cls in (JServer, ObjectServer):
        with cls(latency_s=0.0) as s:
            s.put("b/k", b"abcdef")
            s.fail_next(1)
            for fio in (jfio, file_io):
                with fio.OpenReadStream(f"{s.url}/b/k", offset=2) as r:
                    r.read()
                fio.Glob(f"{s.url}/b/*")
            got.append(s.stats())
    assert got[0] == got[1]
