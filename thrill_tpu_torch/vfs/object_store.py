"""Object-store transport on the standard library's HTTP client: ranged
GETs, listings and streamed PUTs (counterpart of the reference package's
``vfs/object_store.py``; Thrill: vfs/s3_file.cpp, whose libs3 speaks the
same protocol).

The protocol is S3's REST subset: ListObjectsV2 for ``Glob``, a
``Range: bytes=N-`` GET for a read at an offset, and a PUT for a write,
one request below :func:`part_size` bytes and the multipart protocol
(initiate, one PUT a part, complete) from there on.

* ``http://`` and ``https://`` paths come here through the vfs
  (``vfs/file_io.py`` ``Glob``, ``_open_at``, ``OpenWriteStream``), so
  ReadLines, ReadBinary, the writers, checkpoints, run stores and plan
  stores read and write objects unchanged above it;
* ``s3://`` paths come here when boto3 is missing and
  ``THRILL_TPU_OBJECT_STORE_ENDPOINT`` names an S3-compatible endpoint
  (path style: ``<endpoint>/<bucket>/<key>``, ``vfs/s3_file.py``).

This layer classifies and the shared policy retries: a failed answer
raises with its ``http_status`` (``common/retry.py``: 5xx, 408 and 429
transient; 404 and 403 become ``FileNotFoundError`` and
``PermissionError``, which are permanent). A read that fails in the
middle is reopened at its position by the ``RetryingReader`` around
this stream, one ranged GET; a server that answers a ranged GET with
the whole object raises, because a restart from byte 0 would corrupt
the resumed stream.

Each GET adds one to ``remote_gets`` and its time to the first byte to
the latency ledger (:func:`get_p50_ms`); each PUT or part adds one to
``remote_puts`` (``common/iostats.py``). Settings:
``THRILL_TPU_OBJECT_STORE_ENDPOINT`` (or ``AWS_ENDPOINT_URL``),
``THRILL_TPU_OBJECT_STORE_PART`` (8 MiB, at least 64 KiB) and
``THRILL_TPU_OBJECT_STORE_TIMEOUT`` (60 s a request). Fault sites:
``vfs.http.read`` (the GET), ``vfs.http.write`` (every PUT and POST of
a write) and ``vfs.http.list``; a ``delay=`` arm fires once a request,
the latency of a real store.
"""

from __future__ import annotations

import collections
import http.client
import io
import os
import threading
import time
import urllib.parse
import xml.etree.ElementTree as ET
from typing import IO, List, Optional, Tuple

from ..common import faults
from ..common.iostats import IO as _IOSTATS
from ..common.retry import default_policy

_F_READ = faults.declare("vfs.http.read")
_F_WRITE = faults.declare("vfs.http.write")
_F_LIST = faults.declare("vfs.http.list")


def endpoint() -> Optional[str]:
    """The S3 REST endpoint ``s3://`` paths use without boto3:
    ``THRILL_TPU_OBJECT_STORE_ENDPOINT`` or ``AWS_ENDPOINT_URL``, e.g.
    ``http://127.0.0.1:9000``."""
    ep = os.environ.get("THRILL_TPU_OBJECT_STORE_ENDPOINT") \
        or os.environ.get("AWS_ENDPOINT_URL")
    return ep.rstrip("/") if ep else None


def part_size() -> int:
    """``THRILL_TPU_OBJECT_STORE_PART``: the buffered bytes at which a
    write turns multipart, so a write holds one part in RAM and never the
    whole object. 8 MiB by default, at least 64 KiB (S3 itself wants
    non-final parts of 5 MiB or more)."""
    try:
        v = int(os.environ.get("THRILL_TPU_OBJECT_STORE_PART", "")
                or (8 << 20))
    except ValueError:
        v = 8 << 20
    return max(1 << 16, v)


def timeout_s() -> float:
    """``THRILL_TPU_OBJECT_STORE_TIMEOUT``: a request's socket timeout."""
    try:
        return float(os.environ.get("THRILL_TPU_OBJECT_STORE_TIMEOUT",
                                    "") or 60.0)
    except ValueError:
        return 60.0


class HTTPStatusError(OSError):
    """An answer outside 2xx; ``http_status`` classifies it for the
    retry policy."""

    def __init__(self, status: int, url: str, detail: str = "") -> None:
        super().__init__(f"HTTP {status} for {url}"
                         + (f": {detail}" if detail else ""))
        self.http_status = status
        self.url = url


# -- the GET latency ledger (time to the first byte) --------------------------
_LAT_LOCK = threading.Lock()
_LAT_MS: collections.deque = collections.deque(maxlen=4096)


def _record_get(ms: float) -> None:
    with _LAT_LOCK:
        _LAT_MS.append(ms)


def get_p50_ms() -> float:
    """Median time to the first byte of the last 4096 GETs, in ms; 0.0
    when none ran."""
    with _LAT_LOCK:
        lat = sorted(_LAT_MS)
    return lat[len(lat) // 2] if lat else 0.0


def latency_reset() -> None:
    with _LAT_LOCK:
        _LAT_MS.clear()


# -- requests -----------------------------------------------------------------
def _parse(url: str) -> Tuple[bool, str, int, str]:
    """(https?, host, port, path with query) of an absolute URL."""
    u = urllib.parse.urlsplit(url)
    if u.scheme not in ("http", "https"):
        raise ValueError(f"not an http(s) url: {url!r}")
    if not u.hostname:
        raise ValueError(f"http url has no host: {url!r}")
    secure = u.scheme == "https"
    port = u.port or (443 if secure else 80)
    path = u.path or "/"
    if u.query:
        path += "?" + u.query
    return secure, u.hostname, port, path


def _connect(secure: bool, host: str, port: int) -> http.client.HTTPConnection:
    cls = http.client.HTTPSConnection if secure \
        else http.client.HTTPConnection
    return cls(host, port, timeout=timeout_s())


def _raise_for_status(status: int, url: str, body: bytes = b"") -> None:
    """404 and 403 as the permanent OSErrors the stack knows; any other
    status as :class:`HTTPStatusError`. Each carries ``http_status``."""
    if status == 404:
        e: OSError = FileNotFoundError(f"object not found: {url}")
    elif status == 403:
        e = PermissionError(f"access denied: {url}")
    else:
        e = HTTPStatusError(status, url, body[:200].decode(
            "utf-8", "replace"))
    e.http_status = status  # type: ignore[attr-defined]
    raise e


def _request(method: str, url: str, body: bytes = b"",
             headers: Optional[dict] = None,
             ok: Tuple[int, ...] = (200,)) -> Tuple[int, dict, bytes]:
    """One buffered request on a connection of its own (so any thread
    may send one); (status, lower-cased headers, body)."""
    secure, host, port, path = _parse(url)
    conn = _connect(secure, host, port)
    try:
        hdrs = {"Content-Length": str(len(body))}
        if headers:
            hdrs.update(headers)
        conn.request(method, path, body=body or None, headers=hdrs)
        resp = conn.getresponse()
        data = resp.read()
        status = resp.status
        rhdrs = {k.lower(): v for k, v in resp.getheaders()}
    except http.client.HTTPException as e:
        # a broken exchange is a broken connection: transient
        raise ConnectionResetError(f"{method} {url}: {e!r}") from e
    finally:
        conn.close()
    if status not in ok:
        _raise_for_status(status, url, data)
    return status, rhdrs, data


# -- ranged reads -------------------------------------------------------------
class _HttpReadStream(io.RawIOBase):
    """One object from ``offset`` on, streamed from one ranged GET."""

    def __init__(self, url: str, offset: int = 0) -> None:
        faults.check(_F_READ, url=url, offset=offset)
        self._url = url
        secure, host, port, path = _parse(url)
        self._conn = _connect(secure, host, port)
        t0 = time.perf_counter()
        try:
            headers = {}
            if offset:
                headers["Range"] = f"bytes={offset}-"
            self._conn.request("GET", path, headers=headers)
            resp = self._conn.getresponse()
        except http.client.HTTPException as e:
            self._conn.close()
            raise ConnectionResetError(f"GET {url}: {e!r}") from e
        except BaseException:
            self._conn.close()
            raise
        _IOSTATS.add(remote_gets=1)
        _record_get((time.perf_counter() - t0) * 1e3)
        if offset and resp.status == 416:
            # at or past the end: empty, as a local file reads there
            # (the delimited-range scanners probe the end legitimately)
            resp.read()
            self._conn.close()
            self._resp = None
            return
        if resp.status not in (200, 206):
            body = resp.read()
            self._conn.close()
            _raise_for_status(resp.status, url, body)
        if offset and resp.status != 206:
            # the whole object instead of the range: fail, never read
            # from byte 0 (a 200 is permanent, so no retries follow)
            self._conn.close()
            raise HTTPStatusError(
                200, url, f"server ignored Range: bytes={offset}-")
        self._resp = resp

    def readable(self) -> bool:
        return True

    def read(self, n: int = -1) -> bytes:
        if self._resp is None:
            return b""
        try:
            return self._resp.read(None if n is None or n < 0 else n)
        except http.client.HTTPException as e:
            raise ConnectionResetError(
                f"read {self._url}: {e!r}") from e

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[:len(data)] = data
        return len(data)

    def close(self) -> None:
        try:
            self._conn.close()
        finally:
            super().close()


def http_open_read(url: str, offset: int = 0) -> IO[bytes]:
    return io.BufferedReader(_HttpReadStream(url, offset))


# -- listing (ListObjectsV2) ---------------------------------------------------
def _split_bucket(url: str) -> Tuple[str, str, str]:
    """``http://host:port/bucket/key`` as (base, bucket, key)."""
    u = urllib.parse.urlsplit(url)
    base = f"{u.scheme}://{u.netloc}"
    rest = u.path.lstrip("/")
    bucket, _, key = rest.partition("/")
    if not bucket:
        raise ValueError(f"object url has no bucket: {url!r}")
    return base, bucket, key


def _xml_text(elem, tag: str, default: str = "") -> str:
    # S3's XML comes with and without its namespace: match the local name
    for child in elem.iter():
        if child.tag == tag or child.tag.endswith("}" + tag):
            return child.text or default
    return default


def list_objects(base: str, bucket: str,
                 prefix: str) -> List[Tuple[str, int]]:
    """(key, size) of every object under ``prefix``, page by page,
    sorted by key."""
    out: List[Tuple[str, int]] = []
    token = None
    policy = default_policy()
    while True:
        q = {"list-type": "2", "prefix": prefix}
        if token:
            q["continuation-token"] = token
        url = f"{base}/{bucket}?{urllib.parse.urlencode(q)}"

        def op(url=url):
            faults.check(_F_LIST, url=url)
            return _request("GET", url)
        _, _, body = policy.run(op, what="vfs.http.list")
        root = ET.fromstring(body)
        for elem in root.iter():
            if elem.tag == "Contents" or elem.tag.endswith("}Contents"):
                k = _xml_text(elem, "Key")
                if k:
                    out.append((k, int(_xml_text(elem, "Size", "0"))))
        if _xml_text(root, "IsTruncated") != "true":
            break
        token = _xml_text(root, "NextContinuationToken")
        if not token:
            break
    out.sort()
    return out


def http_glob(path_or_glob: str) -> List[Tuple[str, int]]:
    """(url, size) of the object at the path, or of every object that
    matches a glob with one ``*``, sorted."""
    base, bucket, key = _split_bucket(path_or_glob)
    if "*" in key:
        star = key.index("*")
        if "*" in key[star + 1:]:
            raise ValueError(
                "object-store glob supports a single trailing '*'")
        prefix, suffix = key[:star], key[star + 1:]
    else:
        prefix, suffix = key, ""
    out = [(f"{base}/{bucket}/{k}", sz)
           for k, sz in list_objects(base, bucket, prefix)
           if not suffix or k.endswith(suffix)]
    out.sort()
    return out


# -- streamed writes ----------------------------------------------------------
class _ObjectWriteStream(io.RawIOBase):
    """A streamed PUT that holds at most one part in RAM. Below one part,
    one PUT at close; from one part on, the multipart protocol, each
    request under the retry policy (a part's PUT is idempotent).
    :meth:`abort` drops the upload, so a failed writer publishes
    nothing."""

    def __init__(self, url: str, part: Optional[int] = None) -> None:
        self._url = url
        self._part_size = part_size() if part is None else max(1 << 16,
                                                               int(part))
        self._pending = bytearray()
        self._upload_id: Optional[str] = None
        self._parts: List[Tuple[int, str]] = []   # (number, etag)
        self._aborted = False
        self._policy = default_policy()

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        if self._aborted:
            # dropped, not raised: the buffered writer's close flushes
            # after an abort, and a raise would hide the abort's cause
            return len(b)
        self._pending += b
        # cut whole parts off the front, then drop them in one move: a
        # ``del`` a part would move the rest of a large write each time
        off = 0
        while len(self._pending) - off >= self._part_size:
            n = self._part_size          # the upload may grow it
            self._upload_part(bytes(self._pending[off:off + n]))
            off += n
        if off:
            del self._pending[:off]
        return len(b)

    def _put(self, url: str, body: bytes, what: str,
             headers: Optional[dict] = None) -> dict:
        def op():
            faults.check(_F_WRITE, url=url, nbytes=len(body))
            _, hdrs, _ = _request("PUT", url, body=body, headers=headers,
                                  ok=(200, 201, 204))
            return hdrs
        hdrs = self._policy.run(op, what=what)
        _IOSTATS.add(remote_puts=1)
        return hdrs

    def _upload_part(self, data: bytes) -> None:
        if self._upload_id is None:
            def op():
                faults.check(_F_WRITE, url=self._url, op="initiate")
                _, _, body = _request("POST", self._url + "?uploads")
                return _xml_text(ET.fromstring(body), "UploadId")
            self._upload_id = self._policy.run(op, what="vfs.http.write")
            if not self._upload_id:
                raise HTTPStatusError(
                    500, self._url, "initiate returned no UploadId")
        num = len(self._parts) + 1
        q = urllib.parse.urlencode(
            {"partNumber": str(num), "uploadId": self._upload_id})
        hdrs = self._put(f"{self._url}?{q}", data, "vfs.http.write")
        self._parts.append((num, hdrs.get("etag", f'"{num}"')))
        # S3 takes 10,000 parts: from part 5000 on the part size doubles
        # every 500 parts, up to 5 GiB, so the cap covers 5 TiB objects
        if num >= 5000 and num % 500 == 0 \
                and self._part_size < (5 << 30):
            self._part_size = min(self._part_size * 2, 5 << 30)

    def abort(self) -> None:
        self._aborted = True
        self._pending = bytearray()
        if self._upload_id is not None:
            uid, self._upload_id = self._upload_id, None
            try:
                q = urllib.parse.urlencode({"uploadId": uid})
                _request("DELETE", f"{self._url}?{q}", ok=(200, 204))
            except Exception:
                pass                 # best effort: never hide the cause

    def close(self) -> None:
        if self.closed:
            return
        try:
            if self._aborted:
                return
            if self._upload_id is None:
                self._put(self._url, bytes(self._pending),
                          "vfs.http.write")
                self._pending = bytearray()
            else:
                try:
                    if self._pending:
                        self._upload_part(bytes(self._pending))
                        self._pending = bytearray()
                    parts = "".join(
                        f"<Part><PartNumber>{n}</PartNumber>"
                        f"<ETag>{etag}</ETag></Part>"
                        for n, etag in self._parts)
                    body = (f"<CompleteMultipartUpload>{parts}"
                            f"</CompleteMultipartUpload>").encode("utf-8")
                    q = urllib.parse.urlencode(
                        {"uploadId": self._upload_id})

                    def op():
                        faults.check(_F_WRITE, url=self._url,
                                     op="complete")
                        _request("POST", f"{self._url}?{q}", body=body)
                    self._policy.run(op, what="vfs.http.write")
                    self._upload_id = None
                except Exception:
                    self.abort()
                    raise
        finally:
            super().close()


class AbortingWriter(io.BufferedWriter):
    """A buffered writer whose ``with`` block aborts the upload when its
    body raises: a failed writer never publishes a truncated object."""

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            try:
                self.raw.abort()
            except Exception:
                pass                 # the body's error is the one raised
        return super().__exit__(exc_type, exc, tb)


def http_open_write(url: str) -> IO[bytes]:
    return AbortingWriter(_ObjectWriteStream(url))


# -- s3:// without boto3 --------------------------------------------------------
def s3_rest_url(path: str) -> str:
    """``s3://bucket/key`` as ``<endpoint>/bucket/key``; raises
    NotImplementedError when no endpoint is set (boto3's gate speaks
    then)."""
    ep = endpoint()
    if ep is None:
        raise NotImplementedError(
            "s3:// REST fallback needs THRILL_TPU_OBJECT_STORE_ENDPOINT")
    assert path.startswith("s3://"), path
    return f"{ep}/{path[len('s3://'):]}"
