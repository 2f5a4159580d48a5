"""An S3-compatible object server in the process (counterpart of the
reference package's ``tools/object_server.py``): the stand-in for slow
remote storage that the tests and ``chip_smoke.py`` read and write
through ``vfs/object_store.py``, with no network beyond the loopback.

A ``ThreadingHTTPServer`` that speaks the part of S3's REST protocol the
transport uses: ListObjectsV2, ranged GET (206 and ``Content-Range``),
PUT, the multipart protocol (initiate, a PUT a part, complete, abort),
HEAD and DELETE. Its settings make it a latency rig as well:

* ``latency_s``: every request sleeps this long before it answers (a
  store at 20 ms a GET);
* ``fail_rate`` (seeded) and ``fail_next(n)``: requests answer 503, so
  the retry policy's classification and the reader's reopen at its
  position run over a real socket;
* ``honor_range=False``: ranged GETs answer with the whole object, which
  the client must refuse.

``objects`` maps ``bucket/key`` to bytes; ``gets``, ``puts``, ``lists``
and ``requests`` count what reached the server. In the process::

    with ObjectServer(latency_s=0.02) as srv:
        ctx.ReadLines(f"{srv.url}/bucket/input-*") ...

or alone: ``python -m thrill_tpu_torch.tools.object_server
--latency-ms 20`` prints its URL and serves until interrupted.
"""

from __future__ import annotations

import argparse
import random
import threading
import time
import urllib.parse
import uuid
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from xml.sax.saxutils import escape


def _etag(body: bytes) -> str:
    # a CRC, not S3's MD5: no client here checks it, and an MD5 of every
    # part costs a GB/s-class host most of a large write's time
    return f'"{zlib.crc32(body):08x}"'


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "thrill-tpu-object-server/1"

    # -- plumbing -------------------------------------------------------
    def log_message(self, fmt, *args):  # pragma: no cover - quiet
        pass

    def _split(self) -> Tuple[str, Dict[str, str]]:
        u = urllib.parse.urlsplit(self.path)
        q = dict(urllib.parse.parse_qsl(u.query,
                                        keep_blank_values=True))
        return urllib.parse.unquote(u.path).lstrip("/"), q

    def _pre(self) -> bool:
        """Injection gate: per-request latency, then scripted/random
        failures. False = a 503 was sent, stop handling."""
        srv = self.server
        with srv.lock:
            srv.requests += 1
            lat = srv.latency_s
            fail = srv.fail_next > 0
            if fail:
                srv.fail_next -= 1
            elif srv.fail_rate > 0.0:
                fail = srv.rng.random() < srv.fail_rate
        if lat > 0.0:
            time.sleep(lat)
        if fail:
            self._reply(503, b"injected failure")
            return False
        return True

    def _reply(self, status: int, body: bytes = b"",
               headers: Optional[Dict[str, str]] = None,
               head_only: bool = False) -> None:
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        if body and not head_only:
            self.wfile.write(body)

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length", "0") or 0)
        return self.rfile.read(n) if n else b""

    # -- verbs ----------------------------------------------------------
    def do_GET(self) -> None:
        if not self._pre():
            return
        key, q = self._split()
        srv = self.server
        if "list-type" in q:
            with srv.lock:
                srv.lists += 1
            self._list(key.strip("/"), q.get("prefix", ""))
            return
        with srv.lock:
            srv.gets += 1
            data = srv.objects.get(key)
        if data is None:
            self._reply(404, b"<Error><Code>NoSuchKey</Code></Error>")
            return
        rng = self.headers.get("Range")
        if rng and srv.honor_range:
            try:
                spec = rng.split("=", 1)[1]
                lo_s, _, hi_s = spec.partition("-")
                lo = int(lo_s)
                hi = int(hi_s) if hi_s else len(data) - 1
            except (IndexError, ValueError):
                self._reply(416, b"bad range")
                return
            if lo >= len(data):
                self._reply(416, b"range out of bounds")
                return
            hi = min(hi, len(data) - 1)
            part = data[lo:hi + 1]
            self._reply(206, part, {
                "Content-Range": f"bytes {lo}-{hi}/{len(data)}"})
            return
        self._reply(200, data)

    def do_HEAD(self) -> None:
        if not self._pre():
            return
        key, _ = self._split()
        with self.server.lock:
            data = self.server.objects.get(key)
        if data is None:
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        # HEAD: size rides in Content-Length, no body follows
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()

    def do_PUT(self) -> None:
        if not self._pre():
            return
        key, q = self._split()
        body = self._body()
        srv = self.server
        if "partNumber" in q and "uploadId" in q:
            uid = q["uploadId"]
            num = int(q["partNumber"])
            with srv.lock:
                srv.puts += 1
                up = srv.uploads.get(uid)
                if up is None or up[0] != key:
                    self._reply(404, b"<Error><Code>NoSuchUpload"
                                     b"</Code></Error>")
                    return
                up[1][num] = body
            etag = _etag(body)
            self._reply(200, b"", {"ETag": etag})
            return
        with srv.lock:
            srv.puts += 1
            srv.objects[key] = body
        self._reply(200, b"", {"ETag": _etag(body)})

    def do_POST(self) -> None:
        if not self._pre():
            return
        key, q = self._split()
        srv = self.server
        if "uploads" in q:
            uid = uuid.uuid4().hex
            with srv.lock:
                srv.uploads[uid] = (key, {})
            body = (f"<InitiateMultipartUploadResult>"
                    f"<Key>{escape(key)}</Key>"
                    f"<UploadId>{uid}</UploadId>"
                    f"</InitiateMultipartUploadResult>").encode()
            self._reply(200, body)
            return
        if "uploadId" in q:
            self._body()             # CompleteMultipartUpload XML
            uid = q["uploadId"]
            with srv.lock:
                up = srv.uploads.pop(uid, None)
                if up is None or up[0] != key:
                    self._reply(404, b"<Error><Code>NoSuchUpload"
                                     b"</Code></Error>")
                    return
                srv.objects[key] = b"".join(
                    up[1][n] for n in sorted(up[1]))
            body = (f"<CompleteMultipartUploadResult>"
                    f"<Key>{escape(key)}</Key>"
                    f"</CompleteMultipartUploadResult>").encode()
            self._reply(200, body)
            return
        self._reply(400, b"unsupported POST")

    def do_DELETE(self) -> None:
        if not self._pre():
            return
        key, q = self._split()
        srv = self.server
        if "uploadId" in q:
            with srv.lock:
                srv.uploads.pop(q["uploadId"], None)
            self._reply(204)
            return
        with srv.lock:
            srv.objects.pop(key, None)
        self._reply(204)

    # -- ListObjectsV2 --------------------------------------------------
    def _list(self, bucket: str, prefix: str) -> None:
        srv = self.server
        want = f"{bucket}/{prefix}"
        with srv.lock:
            hits = sorted((k, len(v)) for k, v in srv.objects.items()
                          if k.startswith(want))
        rows = "".join(
            f"<Contents><Key>{escape(k.split('/', 1)[1])}</Key>"
            f"<Size>{sz}</Size></Contents>"
            for k, sz in hits)
        body = (f"<ListBucketResult>"
                f"<Name>{escape(bucket)}</Name>"
                f"<Prefix>{escape(prefix)}</Prefix>"
                f"<KeyCount>{len(hits)}</KeyCount>"
                f"<IsTruncated>false</IsTruncated>"
                f"{rows}</ListBucketResult>").encode()
        self._reply(200, body)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def handle_error(self, request, client_address):
        # keep-alive clients drop connections mid-wait constantly
        # (each transport request opens a fresh connection and closes
        # it after the response) — that is not an error worth a
        # traceback on the test's stderr
        import sys
        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionError, BrokenPipeError,
                            TimeoutError)):
            return
        super().handle_error(request, client_address)


class ObjectServer:
    """One in-process object store on 127.0.0.1:<ephemeral>.

    ``objects`` maps ``bucket/key`` → bytes and may be seeded/inspected
    directly. ``latency_s``/``fail_rate``/``fail_next()`` inject the
    slow-and-flaky regime; ``gets``/``puts``/``lists``/``requests``
    count what actually hit the wire. ``honor_range=False`` simulates a
    server that ignores Range (the client must then fail loudly rather
    than silently restart from byte 0)."""

    def __init__(self, latency_s: float = 0.0, fail_rate: float = 0.0,
                 seed: int = 0) -> None:
        self._httpd = _Server(("127.0.0.1", 0), _Handler)
        h = self._httpd
        h.lock = threading.Lock()
        h.objects = {}
        h.uploads = {}
        h.latency_s = float(latency_s)
        h.fail_rate = float(fail_rate)
        h.fail_next = 0
        h.rng = random.Random(seed)
        h.honor_range = True
        h.requests = h.gets = h.puts = h.lists = 0
        self._thread = threading.Thread(
            target=h.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True, name="thrill-tpu-object-server")
        self._thread.start()

    # -- addressing -----------------------------------------------------
    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    # -- state ----------------------------------------------------------
    @property
    def objects(self) -> Dict[str, bytes]:
        return self._httpd.objects

    def put(self, key: str, data: bytes) -> None:
        with self._httpd.lock:
            self._httpd.objects[key] = data

    def stats(self) -> Dict[str, int]:
        h = self._httpd
        with h.lock:
            return {"requests": h.requests, "gets": h.gets,
                    "puts": h.puts, "lists": h.lists}

    # -- injection ------------------------------------------------------
    def set_latency(self, latency_s: float) -> None:
        with self._httpd.lock:
            self._httpd.latency_s = float(latency_s)

    def set_fail_rate(self, rate: float, seed: int = 0) -> None:
        with self._httpd.lock:
            self._httpd.fail_rate = float(rate)
            self._httpd.rng = random.Random(seed)

    def fail_next(self, n: int) -> None:
        """The next ``n`` requests answer 503, deterministically."""
        with self._httpd.lock:
            self._httpd.fail_next += int(n)

    def set_honor_range(self, honor: bool) -> None:
        with self._httpd.lock:
            self._httpd.honor_range = bool(honor)

    # -- lifecycle ------------------------------------------------------
    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)

    def __enter__(self) -> "ObjectServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def main(argv=None) -> int:          # pragma: no cover - manual tool
    ap = argparse.ArgumentParser(
        description="standalone S3-compatible mock object server")
    ap.add_argument("--latency-ms", type=float, default=0.0)
    ap.add_argument("--fail-rate", type=float, default=0.0)
    args = ap.parse_args(argv)
    srv = ObjectServer(latency_s=args.latency_ms / 1e3,
                       fail_rate=args.fail_rate)
    print(srv.url, flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.close()
    return 0


if __name__ == "__main__":           # pragma: no cover
    raise SystemExit(main())
