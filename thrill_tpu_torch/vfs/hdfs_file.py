"""``hdfs://`` for the vfs, through pyarrow's ``HadoopFileSystem``
(counterpart of the reference package's ``vfs/hdfs_file.py``; Thrill:
vfs/hdfs3_file.cpp over libhdfs3): listings, reads at an offset and
streamed writes.

The connection needs libhdfs and a Hadoop runtime (``HADOOP_HOME``,
``CLASSPATH``); without them every call raises NotImplementedError
saying so.

Paths: ``hdfs://host:port/path``, or ``hdfs:///path`` for the default
name node of ``HADOOP_CONF_DIR``; a directory lists its files, and a
glob may hold one ``*``. Fault site: ``vfs.hdfs.open``, each ranged
open; the retrying reader of ``vfs/file_io.py`` reopens at the position
reached after a transient fire.
"""

from __future__ import annotations

from typing import IO, List, Tuple
from urllib.parse import urlparse

from ..common import faults

_F_HDFS_OPEN = faults.declare("vfs.hdfs.open")


def _connect(host: str, port: int):
    try:
        from pyarrow import fs as pafs
        return pafs.HadoopFileSystem(host=host or "default",
                                     port=port or 0)
    except Exception as e:
        raise NotImplementedError(
            "vfs scheme 'hdfs' needs pyarrow's HadoopFileSystem with "
            "libhdfs and a Hadoop runtime configured (HADOOP_HOME, "
            "CLASSPATH); neither is present here") from e


def parse_hdfs_path(path: str) -> Tuple[str, int, str]:
    u = urlparse(path)
    assert u.scheme == "hdfs", path
    return u.hostname or "", u.port or 0, u.path


def hdfs_glob(path_or_glob: str) -> List[Tuple[str, int]]:
    """(``hdfs://.../path``, size) of the file, of a directory's files,
    or of every file that matches a glob with one ``*``, sorted."""
    host, port, p = parse_hdfs_path(path_or_glob)
    client = _connect(host, port)
    from pyarrow import fs as pafs

    authority = f"hdfs://{host}:{port}" if host else "hdfs://"

    def _list(selector_base, prefix, suffix, recursive):
        sel = pafs.FileSelector(selector_base, recursive=recursive,
                                allow_not_found=True)
        out = []
        for info in client.get_file_info(sel):
            if info.type != pafs.FileType.File:
                continue
            path_n = "/" + info.path.lstrip("/")
            if prefix and not path_n.startswith(prefix):
                continue
            if suffix and not path_n.endswith(suffix):
                continue
            out.append((f"{authority}{path_n}", int(info.size)))
        out.sort()
        return out

    if "*" in p:
        star = p.index("*")
        if "*" in p[star + 1:]:
            raise ValueError("hdfs glob supports a single trailing '*'")
        prefix, suffix = p[:star], p[star + 1:]
        base = prefix.rsplit("/", 1)[0] or "/"
        return _list(base, prefix, suffix, recursive=True)
    info = client.get_file_info([p])[0]
    if info.type == pafs.FileType.Directory:
        return _list(p, "", "", recursive=False)
    if info.type != pafs.FileType.File:
        return []
    return [(path_or_glob, int(info.size))]


def hdfs_open_read(path: str, offset: int = 0) -> IO[bytes]:
    faults.check(_F_HDFS_OPEN, path=path, offset=offset)
    host, port, p = parse_hdfs_path(path)
    client = _connect(host, port)
    if offset:
        # a random-access open and a seek: ReadLines opens each worker's
        # range at its offset, and reading up to it would read the whole
        # prefix once a worker
        f = None
        try:
            f = client.open_input_file(p)
            f.seek(offset)
            return f
        except (NotImplementedError, AttributeError):
            if f is not None:
                # opened but cannot seek: close it before the stream
                try:
                    f.close()
                except Exception:
                    pass
            f = client.open_input_stream(p)
            remaining = offset
            while remaining > 0:
                chunk = f.read(min(remaining, 1 << 20))
                if not chunk:
                    break
                remaining -= len(chunk)
            return f
    return client.open_input_stream(p)


def hdfs_open_write(path: str) -> IO[bytes]:
    host, port, p = parse_hdfs_path(path)
    client = _connect(host, port)
    return client.open_output_stream(p)
