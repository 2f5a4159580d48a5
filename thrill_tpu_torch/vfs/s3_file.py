"""``s3://`` for the vfs (counterpart of the reference package's
``vfs/s3_file.py``; Thrill: vfs/s3_file.cpp over libs3): listings for
``Glob``, ranged GETs for reads at an offset, streamed PUTs for writes.

Two transports. With boto3 importable it is boto3, which owns the
credentials, the region's signing and the addressing modes. Without it,
and with ``THRILL_TPU_OBJECT_STORE_ENDPOINT`` set, it is the standard
library's REST transport (``vfs/object_store.py``), path style
``<endpoint>/<bucket>/<key>``. With neither, every call raises
NotImplementedError naming both ways out.

Paths: ``s3://bucket/key``, or ``s3://bucket/prefix*suffix`` (one
``*``). Fault site: ``vfs.s3.read``, each read of boto3's GET stream;
the ``vfs.read`` and ``vfs.open_read`` sites of ``vfs/file_io.py`` wrap
it and reopen the range at the position reached.
"""

from __future__ import annotations

import io
from typing import IO, List, Tuple

from ..common import faults

_F_S3_READ = faults.declare("vfs.s3.read")


def _boto3():
    try:
        import boto3  # type: ignore
        return boto3
    except ImportError as e:
        raise NotImplementedError(
            "vfs scheme 's3' needs the boto3 SDK, which is not "
            "installed; install boto3 and configure AWS credentials, or "
            "point THRILL_TPU_OBJECT_STORE_ENDPOINT at an S3-compatible "
            "endpoint to use the SDK-free REST transport") from e


def _rest():
    """``vfs/object_store`` when boto3 is missing and an endpoint is
    set; None otherwise (boto3, when there, decides)."""
    try:
        import boto3  # type: ignore # noqa: F401
        return None
    except ImportError:
        from . import object_store
        return object_store if object_store.endpoint() else None


def parse_s3_path(path: str) -> Tuple[str, str]:
    assert path.startswith("s3://"), path
    rest = path[len("s3://"):]
    bucket, _, key = rest.partition("/")
    if not bucket:
        raise ValueError(f"s3 path has no bucket: {path!r}")
    return bucket, key


def s3_glob(path_or_glob: str) -> List[Tuple[str, int]]:
    """(``s3://bucket/key``, size) of every object that matches, sorted
    by key."""
    rest = _rest()
    if rest is not None:
        ep = rest.endpoint()
        out = [(f"s3://{url[len(ep) + 1:]}", sz)
               for url, sz in rest.http_glob(rest.s3_rest_url(path_or_glob))]
        out.sort()
        return out
    boto3 = _boto3()
    bucket, key = parse_s3_path(path_or_glob)
    client = boto3.client("s3")
    if "*" in key:
        star = key.index("*")
        if "*" in key[star + 1:]:
            raise ValueError("s3 glob supports a single trailing '*'")
        prefix, suffix = key[:star], key[star + 1:]
    else:
        prefix, suffix = key, ""
    out: List[Tuple[str, int]] = []
    paginator = client.get_paginator("list_objects_v2")
    for page in paginator.paginate(Bucket=bucket, Prefix=prefix):
        for obj in page.get("Contents", ()):
            k = obj["Key"]
            if suffix and not k.endswith(suffix):
                continue
            out.append((f"s3://{bucket}/{k}", int(obj["Size"])))
    out.sort()
    return out


class _S3ReadStream(io.RawIOBase):
    """One object from ``offset`` on, read from one ranged
    ``get_object``."""

    def __init__(self, bucket: str, key: str, offset: int = 0) -> None:
        client = _boto3().client("s3")
        kwargs = {"Bucket": bucket, "Key": key}
        if offset:
            kwargs["Range"] = f"bytes={offset}-"
        self._body = client.get_object(**kwargs)["Body"]

    def readable(self) -> bool:
        return True

    def read(self, n: int = -1) -> bytes:
        faults.check(_F_S3_READ)
        return self._body.read(None if n is None or n < 0 else n)

    def readinto(self, b) -> int:
        faults.check(_F_S3_READ)
        data = self._body.read(len(b))
        b[:len(data)] = data
        return len(data)

    def close(self) -> None:
        try:
            self._body.close()
        finally:
            super().close()


#: the streamed PUT's part size: below it one ``put_object``, from it on
#: the multipart protocol (S3's least non-final part is 5 MiB)
MULTIPART_PART_SIZE = 8 << 20


class _S3WriteStream(io.RawIOBase):
    """A streamed object write that holds at most one part in RAM.

    Below one part, one ``put_object`` at close. From one part on,
    ``create_multipart_upload``, one ``upload_part`` for each slice of
    ``part_size`` bytes (a large single write is sliced too) and
    ``complete_multipart_upload`` at a clean close. :meth:`abort` drops
    the upload; after it, writes are dropped and close commits
    nothing."""

    def __init__(self, bucket: str, key: str,
                 part_size: int = MULTIPART_PART_SIZE) -> None:
        self._bucket = bucket
        self._key = key
        self._part_size = max(int(part_size), 5 << 20)
        self._pending = bytearray()
        self._client = _boto3().client("s3")
        self._upload_id = None
        self._parts: List[dict] = []
        self._aborted = False

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        if self._aborted:
            return len(b)        # see _ObjectWriteStream.write
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

    def _upload_part(self, data: bytes) -> None:
        if self._upload_id is None:
            resp = self._client.create_multipart_upload(
                Bucket=self._bucket, Key=self._key)
            self._upload_id = resp["UploadId"]
        num = len(self._parts) + 1
        resp = self._client.upload_part(
            Bucket=self._bucket, Key=self._key,
            UploadId=self._upload_id, PartNumber=num, Body=data)
        self._parts.append({"ETag": resp["ETag"], "PartNumber": num})
        # 10,000 parts at most: from part 5000 the size doubles every
        # 500 parts, up to S3's 5 GiB a part
        if num >= 5000 and num % 500 == 0 and self._part_size < (5 << 30):
            self._part_size = min(self._part_size * 2, 5 << 30)

    def abort(self) -> None:
        """Drop the output: abort an open multipart upload, and make
        close commit nothing."""
        self._aborted = True
        self._pending = bytearray()
        if self._upload_id is not None:
            try:
                self._client.abort_multipart_upload(
                    Bucket=self._bucket, Key=self._key,
                    UploadId=self._upload_id)
            finally:
                self._upload_id = None

    def close(self) -> None:
        if self.closed:
            return
        try:
            if self._aborted:
                return
            if self._upload_id is None:
                self._client.put_object(Bucket=self._bucket,
                                        Key=self._key,
                                        Body=bytes(self._pending))
            else:
                try:
                    if self._pending:
                        self._upload_part(bytes(self._pending))
                        self._pending = bytearray()
                    self._client.complete_multipart_upload(
                        Bucket=self._bucket, Key=self._key,
                        UploadId=self._upload_id,
                        MultipartUpload={"Parts": self._parts})
                    self._upload_id = None
                except Exception:
                    self.abort()
                    raise
        finally:
            super().close()


def s3_open_read(path: str, offset: int = 0) -> IO[bytes]:
    rest = _rest()
    if rest is not None:
        return rest.http_open_read(rest.s3_rest_url(path), offset)
    bucket, key = parse_s3_path(path)
    return io.BufferedReader(_S3ReadStream(bucket, key, offset))


def s3_open_write(path: str) -> IO[bytes]:
    rest = _rest()
    if rest is not None:
        return rest.http_open_write(rest.s3_rest_url(path))
    from .object_store import AbortingWriter
    bucket, key = parse_s3_path(path)
    return AbortingWriter(_S3WriteStream(bucket, key))
