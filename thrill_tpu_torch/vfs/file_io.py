"""Virtual file system, POSIX part: glob, ranged reads, compressed
streams (counterpart of the reference package's ``vfs/file_io.py``).

``Glob`` expands a plain path, a ``file://`` URL, a glob or a directory
into a FileList with exclusive size prefix sums, which split byte
ranges over workers. Streams decompress ``.gz``, ``.bz2`` and ``.xz``
by suffix. ``OpenReadStream`` is a plain demand reader.
``prefetch_depth`` is the readahead depth the spill restores read.

Waiting in ROADMAP.md queue A "Still to port" item 6, its remote-vfs
part: the ``s3://``,
``hdfs://`` and ``http(s)://`` schemes (they raise here), the retrying
and prefetching readers, fault injection and the I/O statistics.
"""

from __future__ import annotations

import bz2
import dataclasses
import glob as _glob
import gzip
import lzma
import os
from typing import IO, List, Optional

COMPRESSED_SUFFIXES = (".gz", ".bz2", ".xz")

_REMOTE = ("s3", "hdfs", "http", "https")


def prefetch_depth() -> int:
    """``THRILL_TPU_PREFETCH``: blocks a readahead keeps in flight ahead
    of its consumer (default 4; 0 reads on demand, as the
    ``THRILL_TPU_OVERLAP=0`` master switch does)."""
    from ..common.config import overlap_enabled
    if not overlap_enabled():
        return 0
    try:
        return max(0, int(os.environ.get("THRILL_TPU_PREFETCH", "4") or 4))
    except ValueError:
        return 4


@dataclasses.dataclass
class FileInfo:
    path: str
    size: int              # uncompressed size unknown for compressed
    size_ex_psum: int      # exclusive prefix sum of sizes
    is_compressed: bool


@dataclasses.dataclass
class FileList:
    files: List[FileInfo]

    @property
    def total_size(self) -> int:
        if not self.files:
            return 0
        last = self.files[-1]
        return last.size_ex_psum + last.size

    @property
    def contains_compressed(self) -> bool:
        return any(f.is_compressed for f in self.files)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int) -> FileInfo:
        return self.files[i]


def _scheme(path: str) -> str:
    if "://" in path:
        return path.split("://", 1)[0]
    return "file"


def _local(path: str) -> str:
    """The POSIX path of ``path``; remote schemes raise."""
    scheme = _scheme(path)
    if scheme in _REMOTE:
        raise NotImplementedError(
            f"vfs scheme '{scheme}' is not ported yet; it is ROADMAP.md "
            f"queue A 'Still to port' item 6, its remote-vfs part. Plain "
            f"paths and file:// are")
    if scheme != "file":
        raise NotImplementedError(
            f"vfs scheme '{scheme}' is not implemented; file://, s3://, "
            f"hdfs:// and http(s):// are")
    return path[len("file://"):] if path.startswith("file://") else path


def Glob(path_or_glob: str) -> FileList:
    """Expand a path, glob or directory into a FileList with size prefix
    sums (reference: vfs::Glob, file_io.hpp:105; FileList::size_ex_psum
    :79-99). Files come in sorted path order."""
    pat = _local(path_or_glob)
    if os.path.isdir(pat):
        paths = sorted(
            os.path.join(pat, p) for p in os.listdir(pat)
            if os.path.isfile(os.path.join(pat, p)))
    else:
        paths = sorted(p for p in _glob.glob(pat) if os.path.isfile(p))
    files: List[FileInfo] = []
    psum = 0
    for p in paths:
        sz = os.path.getsize(p)
        files.append(FileInfo(p, sz, psum, p.endswith(COMPRESSED_SUFFIXES)))
        psum += sz
    return FileList(files)


def OpenReadStream(path: str, offset: int = 0,
                   readahead_to: Optional[int] = None) -> IO[bytes]:
    """Open for reading at ``offset``, decompressing by suffix.

    Compressed files do not support nonzero offsets (whole-file
    granularity, like the reference's ReadLines on compressed input).
    ``readahead_to`` is accepted for the reference's signature; this
    reader reads on demand only."""
    path = _local(path)
    if offset and path.endswith(COMPRESSED_SUFFIXES):
        raise ValueError("cannot seek into compressed file")
    f = _open_filtered(path, "rb")
    if offset:
        f.seek(offset)
    return f


def write_file_atomic(path: str, data: bytes) -> None:
    """Write ``data`` so readers see either the old file or the whole
    new one, never a torn prefix: write to a same-directory temp name,
    fsync, then ``os.replace``."""
    path = _local(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def OpenWriteStream(path: str) -> IO[bytes]:
    """Open for writing, compressing by suffix; missing directories are
    made."""
    path = _local(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    return _open_filtered(path, "wb")


def _open_filtered(path: str, mode: str) -> IO[bytes]:
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    if path.endswith(".bz2"):
        return bz2.open(path, mode)
    if path.endswith(".xz"):
        return lzma.open(path, mode)
    return open(path, mode)
