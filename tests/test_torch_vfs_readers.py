"""The port's healing and readahead readers (``thrill_tpu_torch/vfs/
file_io.py`` ``RetryingReader``, ``PrefetchingReader``,
``OpenReadStream``) against the reference package's, over the same
files and objects, under every fault site of the vfs.

Sources: a local file, an object of the port's object server over
``http://``, the same object as ``s3://`` through the REST transport.
Readers: the demand reader (``THRILL_TPU_PREFETCH=0``) and the
readahead (depth 2, 4 KiB blocks, so a read spans many blocks). Faults
(``THRILL_TPU_FAULTS``, armed in both packages): none, ``vfs.open_read``,
``vfs.read``, ``vfs.read.delay`` (latency), ``vfs.prefetch`` (the
readahead thread fails and falls back to demand reads) and, on the
remote sources, ``vfs.http.read`` (the GET itself). Each reads the
source six ways (whole, in chunks, by lines, with seeks, past a
readahead horizon, into a buffer): the bytes must be the source's and the reference's,
exactly. Where no thread runs, the fires and retries are the
reference's too.
"""

import builtins
import os

import numpy as np
import pytest

from thrill_tpu.common import faults as jfaults
from thrill_tpu.vfs import file_io as jfio

from thrill_tpu_torch.common import faults as tfaults
from thrill_tpu_torch.tools.object_server import ObjectServer
from thrill_tpu_torch.vfs import file_io as tfio

SIZE = 50_000
FAULTS = {
    "none": "",
    "open_read": "vfs.open_read:n=2",
    "read": "vfs.read:p=0.2:n=4:seed=3",
    "read_delay": "vfs.read.delay:delay=1ms:n=3",
    "prefetch": "vfs.prefetch:n=1",
    "http_read": "vfs.http.read:n=2",
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(24)
    words = [b"w%d" % v for v in rng.integers(0, 10 ** 6, SIZE // 4)]
    lines, n = [], 0
    while n < SIZE:
        ln = b" ".join(words[n % 900:(n % 900) + int(rng.integers(1, 12))])
        lines.append(ln + b"\n")
        n += len(ln) + 1
    return b"".join(lines)


@pytest.fixture(scope="module")
def server(data):
    with ObjectServer() as s:
        s.put("b/src.txt", data)
        yield s


@pytest.fixture()
def sources(tmp_path, server, data, monkeypatch):
    p = tmp_path / "src.txt"
    p.write_bytes(data)
    real_import = builtins.__import__

    def no_boto3(name, *a, **kw):
        if name == "boto3":
            raise ImportError("no boto3")
        return real_import(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_boto3)
    monkeypatch.setenv("THRILL_TPU_OBJECT_STORE_ENDPOINT", server.url)
    return {"file": str(p), "http": f"{server.url}/b/src.txt",
            "s3": "s3://b/src.txt"}


def _reads(fio, path):
    """The six ways to read ``path``: each one's bytes."""
    out = []
    with fio.OpenReadStream(path) as f:
        out.append(f.read())
    with fio.OpenReadStream(path, offset=123) as f:
        chunks = []
        while True:
            b = f.read(777)
            if not b:
                break
            chunks.append(b)
        out.append(b"".join(chunks))
    with fio.OpenReadStream(path, offset=1000) as f:
        out.append(b"".join(list(f)[:200]))
    with fio.OpenReadStream(path) as f:
        f.seek(40_000)
        a = f.read(100)
        f.seek(5)                       # outside the window: restart
        b = f.read(3000)
        f.seek(f.tell() + 10)           # inside it
        c = f.readline()
        out.append(a + b + c + f.read(50).ljust(50, b"."))
    with fio.OpenReadStream(path, offset=2000, readahead_to=9000) as f:
        out.append(f.read(20_000))      # past the horizon on demand
    with fio.OpenReadStream(path, offset=77, readahead_to=30_077) as f:
        buf, n = bytearray(30_000), 0
        head = f.read(10)               # part of a block stays buffered
        while n < len(buf):
            k = f.readinto(memoryview(buf)[n:n + 7001])
            if not k:
                break
            n += k
        out.append(head + bytes(buf[:n]))
    return out


def _want(data):
    lines = data[1000:].splitlines(keepends=True)[:200]
    seek = data[40_000:40_100] + data[5:3005]
    nl = data.find(b"\n", 3015)
    seek += data[3015:nl + 1] + data[nl + 1:nl + 51].ljust(50, b".")
    return [data, data[123:], b"".join(lines), seek, data[2000:22_000],
            data[77:30_087]]


def _run(side, path, spec):
    reg = (jfaults if side == "j" else tfaults).REGISTRY
    reg.reset()
    os.environ[tfaults.ENV_VAR] = spec
    try:
        got = _reads(jfio if side == "j" else tfio, path)
        stats = reg.stats()
    finally:
        os.environ.pop(tfaults.ENV_VAR, None)
        reg.reset()
    return got, stats


# vfs.http.read fires on the remote sources only, vfs.prefetch on the
# readahead thread only
CASES = [(s, r, f) for s in ("file", "http", "s3")
         for r in ("demand", "readahead") for f in FAULTS
         if not (f == "http_read" and s == "file")
         and not (f == "prefetch" and r == "demand")]


@pytest.mark.parametrize("source,reader,fault", CASES)
def test_readers_deliver_the_references_bytes(source, reader, fault,
                                              sources, data, monkeypatch):
    monkeypatch.setenv("THRILL_TPU_RETRY_BASE_S", "0.001")
    monkeypatch.setenv("THRILL_TPU_PREFETCH",
                       "0" if reader == "demand" else "2")
    monkeypatch.setenv("THRILL_TPU_PREFETCH_BLOCK", "4096")
    path = sources[source]
    want = _want(data)
    jgot, jst = _run("j", path, FAULTS[fault])
    tgot, tst = _run("t", path, FAULTS[fault])
    for k, (w, j, t) in enumerate(zip(want, jgot, tgot)):
        assert j == w, (k, "reference")
        assert t == w, (k, "port")
    if fault != "none":
        assert tst["faults_injected"] + tst["faults_delayed"] >= 1
    if reader == "demand":
        # one thread, in order: the same fires and recoveries
        for key in ("faults_injected", "faults_delayed", "retries",
                    "recoveries"):
            assert tst[key] == jst[key], key


def test_prefetch_failure_degrades_with_a_note(sources, data, monkeypatch):
    monkeypatch.setenv("THRILL_TPU_PREFETCH", "2")
    monkeypatch.setenv("THRILL_TPU_PREFETCH_BLOCK", "4096")
    tfaults.REGISTRY.reset()
    with tfaults.inject("vfs.prefetch", n=1):
        with tfio.OpenReadStream(sources["http"]) as f:
            assert isinstance(f, tfio.PrefetchingReader)
            assert f.read() == data
    ev = [e for e in tfaults.REGISTRY.events
          if e.get("what") == "vfs.prefetch_degraded"]
    assert len(ev) == 1 and tfaults.REGISTRY.stats()["recoveries"] == 1
    tfaults.REGISTRY.reset()


@pytest.mark.parametrize("depth", ["0", "4"])
def test_the_horizon_bounds_the_readahead_requests(server, data, depth,
                                                   monkeypatch):
    """A range read with ``readahead_to`` sends the reference's GETs:
    the thread never streams past the horizon."""
    monkeypatch.setenv("THRILL_TPU_PREFETCH", depth)
    monkeypatch.setenv("THRILL_TPU_PREFETCH_BLOCK", "4096")
    url = f"{server.url}/b/src.txt"
    got = []
    for fio in (jfio, tfio):
        g0 = server.stats()["gets"]
        with fio.OpenReadStream(url, offset=100, readahead_to=9000) as f:
            b = f.read(8900)
        got.append((b, server.stats()["gets"] - g0))
    assert got[0] == got[1] == (data[100:9000], 1)


def test_a_retrying_reader_proxies_like_the_references(tmp_path, data):
    p = tmp_path / "x.txt"
    p.write_bytes(data)
    for fio in (jfio, tfio):
        r = fio.RetryingReader(str(p), 10)
        assert r.tell() == 10 and r.readable() and not r.closed
        assert r.readline() == data[10:data.find(b"\n", 10) + 1]
        buf = bytearray(5)
        assert r.readinto(buf) == 5
        assert r.seek(-5, os.SEEK_END) == len(data) - 5
        assert r.read() == data[-5:]
        r.close()
        assert r.closed and not hasattr(r, "name")
        with pytest.raises(ValueError):
            r.read()
