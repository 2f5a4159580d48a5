"""vfs_tool: list, print and copy through the virtual file system
(counterpart of the reference's ``examples/vfs_tool.py``; Thrill:
examples/vfs_tool). Every scheme of ``vfs/file_io.py`` works: plain
paths and ``file://``, ``s3://`` (boto3, or the REST transport with
``THRILL_TPU_OBJECT_STORE_ENDPOINT`` set), ``hdfs://`` and
``http(s)://``, compressed suffixes included.

Usage::

    python -m thrill_tpu_torch.examples.vfs_tool glob 'PATH_OR_GLOB'
    python -m thrill_tpu_torch.examples.vfs_tool cat  'PATH' [--offset N]
    python -m thrill_tpu_torch.examples.vfs_tool copy 'SRC' 'DST'

``glob`` prints each file's size, its size prefix sum, ``Z`` for a
compressed file and its path, then the totals.
"""

from __future__ import annotations

import argparse
import shutil
import sys

from thrill_tpu_torch.vfs import file_io


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("glob")
    g.add_argument("pattern")
    c = sub.add_parser("cat")
    c.add_argument("path")
    c.add_argument("--offset", type=int, default=0)
    cp = sub.add_parser("copy")
    cp.add_argument("src")
    cp.add_argument("dst")
    args = p.parse_args(argv)

    if args.cmd == "glob":
        fl = file_io.Glob(args.pattern)
        for f in fl.files:
            print(f"{f.size:>12}  {f.size_ex_psum:>12}  "
                  f"{'Z' if f.is_compressed else ' '}  {f.path}")
        print(f"total: {len(fl)} files, {fl.total_size} bytes")
    elif args.cmd == "cat":
        with file_io.OpenReadStream(args.path, offset=args.offset) as f:
            shutil.copyfileobj(f, sys.stdout.buffer)
        sys.stdout.buffer.flush()
    else:
        with file_io.OpenReadStream(args.src) as src, \
                file_io.OpenWriteStream(args.dst) as dst:
            shutil.copyfileobj(src, dst)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
