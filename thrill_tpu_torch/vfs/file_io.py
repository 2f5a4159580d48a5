"""The virtual file system: glob, ranged reads that heal and read ahead,
compressed streams, and the remote schemes (counterpart of the reference
package's ``vfs/file_io.py``; Thrill: vfs/file_io.hpp:79-164).

``Glob`` expands a plain path, a ``file://`` URL, a glob or a directory,
or an ``s3://``, ``hdfs://`` or ``http(s)://`` path or one-``*`` glob,
into a FileList with exclusive size prefix sums, which split byte
ranges over workers. ``_open_at`` opens any scheme at an offset:
``vfs/s3_file.py`` (boto3, or the REST transport when an endpoint is
set), ``vfs/hdfs_file.py`` (pyarrow) and ``vfs/object_store.py`` (the
standard library's HTTP). Streams decompress ``.gz``, ``.bz2`` and
``.xz`` by suffix; compressed remote objects are read whole.

A ranged read can be sent again, so every read stream here can be
reopened at an offset: :class:`RetryingReader` keeps its position and,
after a transient fault, reopens there under the shared retry policy.
:class:`PrefetchingReader` reads blocks ahead on a thread of its own
(``THRILL_TPU_PREFETCH`` deep, ``THRILL_TPU_PREFETCH_BLOCK`` bytes
each), delivers the bytes a demand read would, and falls back to demand
reads at the consumed position when the thread fails. Fault sites:
``vfs.open_read``, ``vfs.read``, ``vfs.read.delay`` (its ``delay=``
arm makes every read slow) and ``vfs.prefetch`` (the readahead thread;
``data/writeback.py`` declares the same site for the spill store's
readahead).
"""

from __future__ import annotations

import bz2
import collections
import dataclasses
import glob as _glob
import gzip
import lzma
import os
import threading
import time
from typing import IO, List, Optional, Tuple

from ..common import faults
from ..common.iostats import IO as _IOSTATS
from ..common.retry import default_policy

COMPRESSED_SUFFIXES = (".gz", ".bz2", ".xz")

_F_OPEN = faults.declare("vfs.open_read")
_F_READ = faults.declare("vfs.read")
_F_READ_DELAY = faults.declare("vfs.read.delay")
_F_PREFETCH = faults.declare("vfs.prefetch")


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


def _prefetch_block_bytes() -> int:
    """``THRILL_TPU_PREFETCH_BLOCK``: a readahead block (default 1 MiB,
    at least 4 KiB)."""
    try:
        return max(1 << 12, int(os.environ.get(
            "THRILL_TPU_PREFETCH_BLOCK", "") or (1 << 20)))
    except ValueError:
        return 1 << 20


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


_REMOTE = ("s3", "hdfs", "http", "https")


def is_remote(path: str) -> bool:
    """An object store's or HDFS's path: no directories to make or
    remove, no POSIX stat; listings go through :func:`Glob` and a missing
    object shows as the read's FileNotFoundError."""
    return _scheme(path) in _REMOTE


def _local(path: str) -> str:
    """The POSIX path of a plain path or ``file://`` URL; any scheme
    this module does not know raises."""
    scheme = _scheme(path)
    if scheme != "file":
        raise NotImplementedError(
            f"vfs scheme '{scheme}' is not implemented; file://, s3://, "
            f"hdfs:// and http(s):// are")
    return path[len("file://"):] if path.startswith("file://") else path


def _file_list(listing: List[Tuple[str, int]]) -> FileList:
    files: List[FileInfo] = []
    psum = 0
    for p, sz in listing:
        files.append(FileInfo(p, sz, psum, p.endswith(COMPRESSED_SUFFIXES)))
        psum += sz
    return FileList(files)


def Glob(path_or_glob: str) -> FileList:
    """Expand a path, glob or directory into a FileList with size prefix
    sums (reference: vfs::Glob, file_io.hpp:105; FileList::size_ex_psum
    :79-99). Files come in sorted path order."""
    scheme = _scheme(path_or_glob)
    if scheme == "s3":
        from . import s3_file
        return _file_list(s3_file.s3_glob(path_or_glob))
    if scheme == "hdfs":
        from . import hdfs_file
        return _file_list(hdfs_file.hdfs_glob(path_or_glob))
    if scheme in ("http", "https"):
        from . import object_store
        return _file_list(object_store.http_glob(path_or_glob))
    pat = _local(path_or_glob)
    if os.path.isdir(pat):
        paths = sorted(
            os.path.join(pat, p) for p in os.listdir(pat)
            if os.path.isfile(os.path.join(pat, p)))
    else:
        paths = sorted(p for p in _glob.glob(pat) if os.path.isfile(p))
    return _file_list([(p, os.path.getsize(p)) for p in paths])


def _open_at(path: str, offset: int) -> IO[bytes]:
    """One stream of any scheme at ``offset``: what the retrying reader
    reopens."""
    faults.check(_F_OPEN, path=path, offset=offset)
    scheme = _scheme(path)
    if scheme == "s3":
        if path.endswith(COMPRESSED_SUFFIXES):
            raise ValueError("compressed s3 objects are read whole-file")
        from . import s3_file
        return s3_file.s3_open_read(path, offset)
    if scheme == "hdfs":
        from . import hdfs_file
        return hdfs_file.hdfs_open_read(path, offset)
    if scheme in ("http", "https"):
        if path.endswith(COMPRESSED_SUFFIXES):
            raise ValueError("compressed http objects are read whole-file")
        from . import object_store
        return object_store.http_open_read(path, offset)
    path = _local(path)
    f = _open_filtered(path, "rb")
    if offset:
        if path.endswith(COMPRESSED_SUFFIXES):
            # a reopen after a fault may land inside a compressed
            # stream: skip that many decompressed bytes
            skipped = 0
            while skipped < offset:
                b = f.read(min(offset - skipped, 1 << 20))
                if not b:
                    break
                skipped += len(b)
        else:
            f.seek(offset)
    return f


class RetryingReader:
    """A read stream that heals: it keeps its absolute (decompressed)
    position and, when an open or read fails transiently, reopens the
    source there and goes on (Thrill's ReadStream dies with the job,
    vfs/file_io.hpp:140).

    A proxy, not an io class. Every consuming read (``read``,
    ``readinto``, ``readline``, ``readlines``, ``read1``, iteration) and
    ``seek`` are its own, so the position stays exact: a delegated read
    would move the stream behind it, and a reopen would then give bytes
    twice. Other attributes go to the open stream."""

    def __init__(self, path: str, offset: int = 0) -> None:
        self._path = path
        self._pos = offset
        self._closed = False
        # one policy a reader: the settings hold for a stream's life
        self._policy = default_policy()
        self._f = self._policy.run(
            lambda: _open_at(path, offset), what="vfs.open_read")

    def _consume(self, read_fn) -> bytes:
        """One consuming read under the policy: the fault sites, a reopen
        at the kept position after any failure, the position moved by
        what was returned. Every consuming method comes here."""
        if self._closed:
            raise ValueError("I/O operation on closed file")

        def op():
            faults.check(_F_READ, path=self._path, pos=self._pos)
            # with delay= a slow disk on demand; without, a fault that
            # raises before anything was read
            faults.check(_F_READ_DELAY, path=self._path, pos=self._pos)
            if self._f is None:
                self._f = _open_at(self._path, self._pos)
            try:
                return read_fn(self._f)
            except Exception:
                # after any failure the handle is suspect: the next try
                # opens a new stream at self._pos
                self._drop()
                raise
        data = self._policy.run(op, what="vfs.read")
        self._pos += len(data)
        return data

    def read(self, n: int = -1) -> bytes:
        # to the end is read() (pyarrow's streams refuse read(-1))
        if n is None or n < 0:
            return self._consume(lambda f: f.read())
        return self._consume(lambda f: f.read(n))

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[:len(data)] = data
        return len(data)

    def readline(self, n: int = -1) -> bytes:
        return self._consume(lambda f: f.readline(n))

    def readlines(self, hint: int = -1) -> list:
        out = []
        total = 0
        while True:
            line = self.readline()
            if not line:
                return out
            out.append(line)
            total += len(line)
            if 0 < hint <= total:
                return out

    def read1(self, n: int = -1) -> bytes:
        return self.read(n if n is not None and n >= 0 else 1 << 16)

    def __iter__(self) -> "RetryingReader":
        return self

    def __next__(self) -> bytes:
        line = self.readline()
        if not line:
            raise StopIteration
        return line

    def seek(self, pos: int, whence: int = os.SEEK_SET) -> int:
        if self._closed:
            raise ValueError("I/O operation on closed file")
        if whence == os.SEEK_CUR:
            pos, whence = self._pos + pos, os.SEEK_SET
        if whence == os.SEEK_SET:
            if pos == self._pos:
                return pos                  # a probe: keep the handle
            if self._f is not None and self._f.seekable():
                self._pos = self._f.seek(pos)
            else:
                # no handle, or a stream that cannot seek (http): move
                # the position and drop it; the next read opens there
                # (for http, one ranged GET)
                self._drop()
                self._pos = pos
            return self._pos
        # relative to the end: needs a handle
        if self._f is None:
            self._f = _open_at(self._path, self._pos)
        out = self._f.seek(pos, whence)
        self._pos = out
        return out

    def tell(self) -> int:
        return self._pos

    def _drop(self) -> None:
        f, self._f = self._f, None
        if f is not None:
            try:
                f.close()
            except Exception:
                pass

    def close(self) -> None:
        self._closed = True
        self._drop()

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "RetryingReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __getattr__(self, name):
        # private names never delegate (nor recurse while unpickling)
        if name.startswith("_"):
            raise AttributeError(name)
        # no handle (closed, or dropped after a fault): AttributeError,
        # so hasattr probes behave and never reopen the stream
        f = self.__dict__.get("_f")
        if f is None:
            raise AttributeError(name)
        return getattr(f, name)


class _FillState:
    """One readahead generation: its queue, lock and thread. A seek or
    a close abandons the whole generation, so a thread stuck in a hung
    read past the join's timeout touches only its own queue, never a
    successor's."""

    __slots__ = ("chunks", "cv", "stop", "err", "thread")

    def __init__(self) -> None:
        self.chunks: collections.deque = collections.deque()
        self.cv = threading.Condition()
        self.stop = False
        self.err: Optional[BaseException] = None
        self.thread: Optional[threading.Thread] = None


class PrefetchingReader:
    """Readahead on a thread of its own over a :class:`RetryingReader`.

    The thread reads blocks of ``THRILL_TPU_PREFETCH_BLOCK`` bytes into a
    queue ``THRILL_TPU_PREFETCH`` deep, so a sequential consumer (a
    ReadLines or ReadBinary range, a checkpoint shard, a committed run)
    decodes while the next blocks arrive (Thrill: the BlockPool's
    prefetch, data/block_pool.hpp:177). What holds:

    * the bytes are those of demand reads: the thread runs the same
      retrying reader in order from the same offset;
    * a failure on the thread (site ``vfs.prefetch``) falls back to
      demand reads at the consumed position, recorded by
      ``faults.note``; queued bytes stay valid;
    * a seek outside the buffered window restarts the readahead there;
    * ``readahead_to`` is a horizon the thread never reads past; reads
      beyond it go on as demand reads.

    A block taken from the queue is a ``prefetch_hit``; a wait for the
    thread is a miss and adds to ``io_wait_s`` (``common/iostats.py``).
    """

    def __init__(self, path: str, offset: int = 0,
                 depth: Optional[int] = None,
                 tracer=None, readahead_to: Optional[int] = None) -> None:
        self._path = path
        self._pos = offset          # absolute offset of _buf[0]
        self._closed = False
        self._depth = prefetch_depth() if depth is None else depth
        self._block = _prefetch_block_bytes()
        self._limit = readahead_to
        self._buf = bytearray()     # taken from the queue, not returned
        self._demand: Optional[RetryingReader] = None
        self._tracer = tracer
        self._parent = (tracer.current_id()
                        if tracer is not None and tracer.enabled else None)
        self._hits = 0
        self._misses = 0
        self._wait_s = 0.0
        # the thread starts at the first consuming read: open, seek,
        # read (the delimiter probe) would waste a block a seek
        self._st: Optional[_FillState] = None
        self._eof = False

    # -- the readahead thread -------------------------------------------------
    def _start_thread(self, offset: int) -> None:
        st = _FillState()
        self._st = st
        self._eof = False
        st.thread = threading.Thread(target=self._fill, args=(st, offset),
                                     daemon=True, name="thrill-tpu-prefetch")
        st.thread.start()

    def _fill(self, st: _FillState, offset: int) -> None:
        inner = None
        tr = self._tracer
        span = (tr.span("io", "prefetch_reader", parent=self._parent,
                        path=self._path)
                if tr is not None and tr.enabled else None)
        try:
            if span is not None:
                span.__enter__()
            inner = RetryingReader(self._path, offset)
            fill_pos = offset
            while True:
                with st.cv:
                    while len(st.chunks) >= self._depth and not st.stop:
                        st.cv.wait(0.1)
                    if st.stop:
                        return
                take = self._block
                if self._limit is not None:
                    take = min(take, self._limit - fill_pos)
                    if take <= 0:
                        with st.cv:
                            if not st.stop:
                                # the horizon, not the end: None tells
                                # the consumer to read on demand
                                st.chunks.append(None)
                                st.cv.notify_all()
                        return
                if faults.REGISTRY.active():
                    faults.check(_F_PREFETCH, path=self._path)
                t0 = time.perf_counter()
                data = inner.read(take)
                _IOSTATS.add(io_busy_s=time.perf_counter() - t0)
                fill_pos += len(data)
                with st.cv:
                    if st.stop:
                        return
                    st.chunks.append(data)      # b"" is the end
                    st.cv.notify_all()
                if not data:
                    return
        except BaseException as e:
            with st.cv:
                st.err = e
                st.cv.notify_all()
        finally:
            if inner is not None:
                inner.close()
            if span is not None:
                span.__exit__(None, None, None)

    def _teardown_thread(self) -> None:
        st = self._st
        if st is None:
            return
        with st.cv:
            st.stop = True
            st.cv.notify_all()
        # a thread hung past the timeout is left with its generation
        st.thread.join(timeout=30)
        self._st = None

    def _degrade(self, err: BaseException) -> None:
        """The thread failed: demand reads from the first unread byte."""
        self._teardown_thread()
        faults.note("recovery", what="vfs.prefetch_degraded",
                    path=self._path, error=repr(err)[:200])
        self._demand = RetryingReader(self._path, self._pos + len(self._buf))

    def _next_chunk(self) -> bytes:
        """The next block for ``_buf`` (b"" at the end): from the queue,
        or from the demand reader past the horizon or after a failure."""
        if self._demand is not None:
            return self._demand.read(self._block)
        if self._eof:
            return b""
        if self._st is None:
            self._start_thread(self._pos + len(self._buf))
        st = self._st
        waited = False
        with st.cv:
            if not st.chunks:
                err = st.err
                if err is None and st.thread.is_alive():
                    t0 = time.perf_counter()
                    while not st.chunks and st.err is None \
                            and st.thread.is_alive():
                        st.cv.wait(0.1)
                    dt = time.perf_counter() - t0
                    self._wait_s += dt
                    _IOSTATS.add(io_wait_s=dt, prefetch_misses=1)
                    self._misses += 1
                    waited = True
                err = st.err
                if not st.chunks:
                    if err is None:       # the thread ended with nothing
                        err = RuntimeError("prefetch thread exited "
                                           "without data or EOF")
                    st.err = None
            if st.chunks:
                data = st.chunks.popleft()
                st.cv.notify_all()
                if data is None:
                    horizon = True        # nothing failed: no note
                else:
                    if not data:
                        self._eof = True
                    elif not waited:
                        self._hits += 1
                        _IOSTATS.add(prefetch_hits=1)
                    return bytes(data)
            else:
                horizon = False
        if horizon:
            self._teardown_thread()
            self._demand = RetryingReader(self._path,
                                          self._pos + len(self._buf))
            return self._demand.read(self._block)
        self._degrade(err)
        return self._demand.read(self._block)

    # -- the consuming reads (as RetryingReader's) ----------------------------
    def read(self, n: int = -1) -> bytes:
        if self._closed:
            raise ValueError("I/O operation on closed file")
        if n is None or n < 0:
            while True:
                data = self._next_chunk()
                if not data:
                    break
                self._buf += data
            out = bytes(self._buf)
            self._buf.clear()
            self._pos += len(out)
            return out
        while len(self._buf) < n:
            data = self._next_chunk()
            if not data:
                break
            self._buf += data
        out = bytes(self._buf[:n])
        del self._buf[:n]
        self._pos += len(out)
        return out

    def readinto(self, b) -> int:
        """Fill ``b`` from the buffer, then block by block straight into
        it (a large range read makes no whole copies on the way)."""
        if self._closed:
            raise ValueError("I/O operation on closed file")
        mv = memoryview(b).cast("B")
        got = min(len(self._buf), len(mv))
        mv[:got] = self._buf[:got]
        del self._buf[:got]
        # _pos stays the offset of _buf[0]: a fall back to demand reads
        # opens there
        self._pos += got
        while got < len(mv):
            data = self._next_chunk()
            if not data:
                break
            k = min(len(data), len(mv) - got)
            mv[got:got + k] = memoryview(data)[:k]
            if k < len(data):
                self._buf += memoryview(data)[k:]
            self._pos += k
            got += k
        return got

    def readline(self, n: int = -1) -> bytes:
        if self._closed:
            raise ValueError("I/O operation on closed file")
        limit = n if (n is not None and n >= 0) else None
        scanned = 0
        while True:
            idx = self._buf.find(b"\n", scanned)
            if idx >= 0:
                end = idx + 1
                break
            scanned = len(self._buf)
            if limit is not None and scanned >= limit:
                end = limit
                break
            data = self._next_chunk()
            if not data:
                end = len(self._buf)
                break
            self._buf += data
        if limit is not None:
            end = min(end, limit)
        out = bytes(self._buf[:end])
        del self._buf[:end]
        self._pos += len(out)
        return out

    def readlines(self, hint: int = -1) -> list:
        out = []
        total = 0
        while True:
            line = self.readline()
            if not line:
                return out
            out.append(line)
            total += len(line)
            if 0 < hint <= total:
                return out

    def read1(self, n: int = -1) -> bytes:
        return self.read(n if n is not None and n >= 0 else 1 << 16)

    def __iter__(self) -> "PrefetchingReader":
        return self

    def __next__(self) -> bytes:
        line = self.readline()
        if not line:
            raise StopIteration
        return line

    def seek(self, pos: int, whence: int = os.SEEK_SET) -> int:
        if self._closed:
            raise ValueError("I/O operation on closed file")
        if whence == os.SEEK_CUR:
            pos, whence = self._pos + pos, os.SEEK_SET
        if whence == os.SEEK_SET \
                and self._pos <= pos <= self._pos + len(self._buf):
            # inside the buffered window: drop the prefix
            del self._buf[:pos - self._pos]
            self._pos = pos
            return pos
        # outside it (or from the end): restart at the target
        if self._demand is None:
            self._teardown_thread()
        self._buf.clear()
        if whence != os.SEEK_SET:
            if self._demand is None:
                self._demand = RetryingReader(self._path, 0)
            self._pos = self._demand.seek(pos, whence)
            return self._pos
        self._pos = pos
        self._eof = False
        if self._demand is not None:
            self._demand.seek(pos)
        # else the readahead restarts at _pos on the next read
        return pos

    def tell(self) -> int:
        return self._pos

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._demand is None:
            self._teardown_thread()
        else:
            self._demand.close()
        if self._hits or self._misses:
            faults.REGISTRY.log_line(
                "prefetch", path=self._path, hits=self._hits,
                misses=self._misses, wait_s=round(self._wait_s, 4),
                depth=self._depth)

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "PrefetchingReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def OpenReadStream(path: str, offset: int = 0, tracer=None,
                   readahead_to: Optional[int] = None) -> IO[bytes]:
    """Open any scheme for reading at ``offset``, decompressing by
    suffix, with transient faults healed by a reopen at the position.

    With ``THRILL_TPU_PREFETCH`` above 0 (the default 4) the stream reads
    ahead on a thread (:class:`PrefetchingReader`, its span a child of
    ``tracer``'s current one, never past ``readahead_to``); with 0 it is
    the demand reader, with the same bytes. A compressed local file
    cannot be opened at an offset (whole-file granularity, as the
    reference's ReadLines on compressed input)."""
    if offset and path.endswith(COMPRESSED_SUFFIXES) \
            and _scheme(path) == "file":
        raise ValueError("cannot seek into compressed file")
    depth = prefetch_depth()
    if depth <= 0:
        return RetryingReader(path, offset)
    return PrefetchingReader(path, offset, depth=depth, tracer=tracer,
                             readahead_to=readahead_to)


def write_file_atomic(path: str, data: bytes) -> None:
    """Write ``data`` so readers see either the old file or the whole
    new one, never a torn prefix: write to a same-directory temp name,
    fsync, then ``os.replace``. A remote path is one write: an object
    store's PUT is already all or nothing."""
    if is_remote(path):
        with OpenWriteStream(path) as f:
            f.write(data)
        return
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
    """Open any scheme for writing, compressing a local file by suffix;
    a local file's missing directories are made. An object's write
    commits at close and publishes nothing when its ``with`` block
    raises."""
    scheme = _scheme(path)
    if scheme == "s3":
        from . import s3_file
        return s3_file.s3_open_write(path)
    if scheme == "hdfs":
        from . import hdfs_file
        return hdfs_file.hdfs_open_write(path)
    if scheme in ("http", "https"):
        from . import object_store
        return object_store.http_open_write(path)
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
