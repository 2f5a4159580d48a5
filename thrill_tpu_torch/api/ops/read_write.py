"""File sources and sinks: ReadLines, ReadWordsPacked, ReadBinary,
WriteLines, WriteLinesOne and WriteBinary (counterpart of the reference
package's ``api/ops/read_write.py``; Thrill: api/read_lines.hpp:41,
read_binary.hpp:45, write_lines.hpp:33, write_lines_one.hpp:31,
write_binary.hpp:36).

The global byte stream of the files (in ``Glob`` order) is split evenly
over the workers. A line or word belongs to the worker whose byte range
holds its first byte; a file boundary ends every item. Compressed input
is read whole-file, each file placed by its size prefix sum. Across
processes each process reads its own workers' byte ranges only, and a
device source's capacity comes from every worker's count
(``DeviceShards.from_worker_arrays``); each process writes its own
workers' files, and WriteLinesOne's file is process 0's; a writer
returns when every process has written.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from ...common import tree as pt
from ...common.partition import dense_range_bounds
from ...core import text as textmod
from ...data import multiplexer
from ...data.shards import DeviceShards, HostShards
from ...vfs import file_io
from ..dia import DIA
from ..dia_base import DIABase

_STEP = 1 << 16           # bytes a read while looking for a delimiter
_LINES_A_WRITE = 1 << 16


def _glob_nonempty(pattern: str, op: str) -> file_io.FileList:
    fl = file_io.Glob(pattern)
    if len(fl) == 0:
        raise FileNotFoundError(f"{op}: no files match {pattern!r}")
    return fl


def _whole_file_worker(fi: file_io.FileInfo, total: int, W: int) -> int:
    """The worker that reads compressed file ``fi``: the one whose even
    share of the total size holds the file's first byte."""
    return min(W - 1, (fi.size_ex_psum * W) // max(total, 1))


def _read_whole(path: str) -> bytes:
    with file_io.OpenReadStream(path) as f:
        return f.read()


class ReadLinesNode(DIABase):
    def __init__(self, ctx, path_or_glob: str) -> None:
        super().__init__(ctx, "ReadLines")
        self.pattern = path_or_glob

    def compute(self) -> HostShards:
        W = self.context.num_workers
        local = multiplexer.local_worker_set(self.context.mesh_exec)
        fl = _glob_nonempty(self.pattern, "ReadLines")
        lists: List[List[str]] = [[] for _ in range(W)]
        if fl.contains_compressed:
            for fi in fl.files:
                w = _whole_file_worker(fi, fl.total_size, W)
                if w in local:
                    lists[w].extend(
                        _read_whole(fi.path).decode("utf-8").splitlines())
            return HostShards(W, lists)
        bounds = dense_range_bounds(fl.total_size, W).tolist()
        for w in sorted(local):
            for data in _read_delimited_range(
                    fl, bounds[w], bounds[w + 1], lambda b: b == b"\n",
                    lambda b: b.find(b"\n"), include_delim=True):
                lists[w].extend(data.decode("utf-8").splitlines())
        return HostShards(W, lists)


def _read_delimited_range(fl: file_io.FileList, lo: int, hi: int,
                          is_delim, find_delim,
                          include_delim: bool) -> List[bytes]:
    """Byte chunks covering every delimited item whose first byte lies
    in ``[lo, hi)`` of the global stream, one chunk per file it
    overlaps (a file boundary ends an item).

    The one boundary scanner behind ReadLines (delimiter '\\n', kept in
    the chunk) and ReadWordsPacked (any separator, dropped):
    ``is_delim(byte)`` probes the byte before the range,
    ``find_delim(bytes) -> offset | -1`` scans forward, and
    ``include_delim`` says whether the last item's delimiter is kept. A
    range that starts inside an item skips past the next delimiter; the
    last item is finished past ``hi``."""
    out: List[bytes] = []
    if lo >= hi:
        return out
    for fi in fl.files:
        f_lo, f_hi = fi.size_ex_psum, fi.size_ex_psum + fi.size
        if f_hi <= lo or f_lo >= hi:
            continue
        start = max(lo, f_lo) - f_lo
        end = min(hi, f_hi) - f_lo
        with file_io.OpenReadStream(fi.path, readahead_to=end) as f:
            if start > 0:
                f.seek(start - 1)
                if is_delim(f.read(1)):
                    chunk_start = start
                else:
                    # the item holding byte ``start`` began earlier and
                    # belongs to the previous range
                    pos = start
                    while True:
                        b = f.read(_STEP)
                        if not b:
                            chunk_start = f_hi - f_lo
                            break
                        d = find_delim(b)
                        if d >= 0:
                            chunk_start = pos + d + 1
                            break
                        pos += len(b)
            else:
                chunk_start = 0
            if chunk_start >= end:
                continue
            f.seek(chunk_start)
            data = f.read(end - chunk_start)
            # finish the last item, which starts in range
            if data and not is_delim(data[-1:]):
                while True:
                    b = f.read(_STEP)
                    if not b:
                        break
                    d = find_delim(b)
                    if d >= 0:
                        data += b[:d + 1] if include_delim else b[:d]
                        break
                    data += b
            out.append(data)
    return out


def _read_word_bytes_range(fl: file_io.FileList, lo: int,
                           hi: int) -> List[bytes]:
    """Byte chunks covering every word whose first byte lies in ``[lo,
    hi)`` of the global stream."""
    return _read_delimited_range(
        fl, lo, hi, lambda b: bool(textmod.sep_mask(
            np.frombuffer(b, np.uint8))[0]),
        textmod.find_first_sep, include_delim=False)


def _upload_chunks(chunks: List[List[bytes]], device: torch.device
                   ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Every worker's byte chunks, back to back, as one uint8 tensor on
    ``device`` (staged in pinned memory for the card: one copy), plus
    each chunk's start offset (int64, on ``device``) and each worker's
    first byte (``W + 1`` host offsets)."""
    sizes = [[len(c) for c in cs] for cs in chunks]
    worker_start = np.concatenate(
        [[0], np.cumsum([sum(s) for s in sizes])]).astype(np.int64)
    chunk_start = np.concatenate(
        [[0], np.cumsum([n for s in sizes for n in s])])[:-1]
    host = torch.empty(int(worker_start[-1]), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    view = host.numpy()
    pos = 0
    for cs in chunks:
        for c in cs:
            view[pos:pos + len(c)] = np.frombuffer(c, dtype=np.uint8)
            pos += len(c)
    data = host.to(device, non_blocking=True)
    return (data, torch.as_tensor(chunk_start.astype(np.int64),
                                  device=device), worker_start)


class ReadWordsPackedNode(DIABase):
    """Text to a device DIA of ``{"w": [max_word] uint8}`` rows: the
    bytes are uploaded once and tokenized on the device
    (``core/text.py``), each word on the worker whose byte range holds
    its first byte, the ownership rule of ReadLines."""

    def __init__(self, ctx, path_or_glob: str, max_word: int) -> None:
        super().__init__(ctx, "ReadWordsPacked")
        self.pattern = path_or_glob
        self.max_word = int(max_word)

    def compute(self) -> DeviceShards:
        mex = self.context.mesh_exec
        W = mex.num_workers
        fl = _glob_nonempty(self.pattern, "ReadWordsPacked")
        local = set(mex.local_workers)
        chunks: List[List[bytes]] = [[] for _ in range(W)]
        if fl.contains_compressed:
            for fi in fl.files:
                w = _whole_file_worker(fi, fl.total_size, W)
                if w in local:
                    chunks[w].append(_read_whole(fi.path))
        else:
            bounds = dense_range_bounds(fl.total_size, W).tolist()
            for w in sorted(local):
                chunks[w] = _read_word_bytes_range(fl, bounds[w],
                                                   bounds[w + 1])
        data, chunk_start, worker_start = _upload_chunks(chunks, mex.device)
        del chunks
        words, starts = textmod.tokenize_chunks(data, chunk_start,
                                                self.max_word)
        del data
        cut = mex.fetch(torch.searchsorted(
            starts, mex.put_small(worker_start))).astype(np.int64)
        return DeviceShards.from_worker_arrays(
            mex, [{"w": words[cut[w]:cut[w + 1]]} for w in range(W)])


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


class ReadBinaryNode(DIABase):
    """Fixed-size records straight into device shards: each worker's
    records are read into page-locked memory and uploaded once."""

    def __init__(self, ctx, path_or_glob: str, dtype, record_shape) -> None:
        super().__init__(ctx, "ReadBinary")
        self.pattern = path_or_glob
        self.dtype = np.dtype(dtype)
        self.record_shape = tuple(record_shape)

    def compute(self) -> DeviceShards:
        mex = self.context.mesh_exec
        W = mex.num_workers
        fl = file_io.Glob(self.pattern)
        rec_bytes = (int(np.prod(self.record_shape, dtype=np.int64))
                     * self.dtype.itemsize)
        bounds = dense_range_bounds(fl.total_size // rec_bytes, W).tolist()
        native = self.dtype.newbyteorder("=")
        local = set(mex.local_workers)
        per_worker = []
        for w in range(W):
            if w not in local:
                # another process reads this worker's byte range
                per_worker.append(np.empty((0,) + self.record_shape,
                                           dtype=native))
                continue
            buf = torch.empty((bounds[w + 1] - bounds[w]) * rec_bytes,
                              dtype=torch.uint8,
                              pin_memory=mex.device.type == "cuda")
            _read_records_into(fl, bounds[w] * rec_bytes, buf.numpy())
            if self.dtype == native:
                recs = buf.view(_torch_dtype(native))
            else:
                recs = torch.from_numpy(buf.numpy().view(self.dtype)
                                        .astype(native))
            per_worker.append(recs.reshape((-1,) + self.record_shape))
        return DeviceShards.from_worker_arrays(
            mex, per_worker, counts=np.diff(bounds))


def _read_records_into(fl: file_io.FileList, lo: int,
                       out: np.ndarray) -> None:
    """Fill ``out`` (uint8) with the global stream's bytes from ``lo``."""
    hi = lo + len(out)
    for fi in fl.files:
        f_lo, f_hi = fi.size_ex_psum, fi.size_ex_psum + fi.size
        if f_hi <= lo or f_lo >= hi:
            continue
        start = max(lo, f_lo) - f_lo
        end = min(hi, f_hi) - f_lo
        dst = memoryview(out)[start + f_lo - lo:end + f_lo - lo]
        with file_io.OpenReadStream(fi.path, offset=start,
                                    readahead_to=end) as f:
            got = 0
            while got < len(dst):
                n = f.readinto(dst[got:])
                if not n:
                    raise EOFError(f"ReadBinary: {fi.path} ended at byte "
                                   f"{start + got} of {end}")
                got += n


# ----------------------------------------------------------------------
# sinks
# ----------------------------------------------------------------------

def _worker_path(pattern: str, w: int) -> str:
    """Worker ``w``'s file: ``$$$$$`` (the reference's wildcard,
    api/dia.hpp:813) or ``{}`` replaced by the worker, else ``-%05d``
    before the suffix."""
    if "$$$$$" in pattern:
        return pattern.replace("$$$$$", f"{w:05d}")
    if "{}" in pattern:
        return pattern.format(w)
    base, ext = os.path.splitext(pattern)
    return f"{base}-{w:05d}{ext}"


def _host_lists(dia) -> HostShards:
    shards = dia._link().pull()
    if isinstance(shards, DeviceShards):
        shards = shards.to_host_shards("writelines")
    return shards


def _write_lines(f, items) -> None:
    """``str(item)`` and a newline for every item, in batches."""
    for i in range(0, len(items), _LINES_A_WRITE):
        batch = items[i:i + _LINES_A_WRITE]
        f.write(("\n".join(map(str, batch)) + "\n").encode("utf-8"))


def WriteLines(dia, path_pattern: str) -> None:
    """One text file per worker, empty ones included; across processes
    each process writes its own workers' files."""
    local = multiplexer.local_worker_set(dia.context.mesh_exec)
    for w, items in enumerate(_host_lists(dia).lists):
        if w not in local:
            continue
        with file_io.OpenWriteStream(_worker_path(path_pattern, w)) as f:
            _write_lines(f, items)
    multiplexer.barrier(dia.context.mesh_exec)


def WriteLinesOne(dia, path: str) -> None:
    """One text file of every worker's lines, in worker-rank order;
    across processes the lines gather to process 0, which writes the
    file alone."""
    shards = _host_lists(dia)
    mex = dia.context.mesh_exec
    if multiplexer.multiprocess(mex):
        items = multiplexer.all_items(mex, shards)
        if mex.process_index == 0:
            with file_io.OpenWriteStream(path) as f:
                _write_lines(f, items)
        multiplexer.barrier(mex)
        return
    with file_io.OpenWriteStream(path) as f:
        for items in shards.lists:
            _write_lines(f, items)


def WriteBinary(dia, path_pattern: str) -> None:
    """Raw records, one file per worker. Device storage writes each
    leaf's valid rows in turn (leaf order of the item pytree); host
    storage writes each item's bytes. Across processes each process
    writes its own workers' files."""
    shards = dia._link().pull()
    mex = dia.context.mesh_exec
    for w in sorted(multiplexer.local_worker_set(mex)):
        with file_io.OpenWriteStream(_worker_path(path_pattern, w)) as f:
            if isinstance(shards, HostShards):
                for it in shards.lists[w]:
                    f.write(np.asarray(it).tobytes())
                continue
            lw = w - mex.worker_base
            c = int(shards.counts[lw])
            for leaf in pt.leaves(shards.tree):
                f.write(np.ascontiguousarray(
                    leaf[lw, :c].cpu().numpy()).data)
    multiplexer.barrier(mex)


def ReadLines(ctx, path_or_glob: str) -> DIA:
    return DIA(ReadLinesNode(ctx, path_or_glob))


def ReadWordsPacked(ctx, path_or_glob: str, max_word: int = 16) -> DIA:
    return DIA(ReadWordsPackedNode(ctx, path_or_glob, max_word))


def ReadBinary(ctx, path_or_glob: str, dtype, record_shape=()) -> DIA:
    return DIA(ReadBinaryNode(ctx, path_or_glob, dtype, record_shape))
