"""WordCount: the canonical FlatMap + ReduceByKey pipeline (the port's
copy of the reference package's ``examples/word_count.py``).

    python -m thrill_tpu_torch.examples.word_count FILE --device cpu
    python -m thrill_tpu_torch.examples.word_count FILE --text-device --device cpu

* ``word_count``: the faithful text pipeline over host strings; its
  ReduceByKey runs on host storage, in Python, with the external-memory
  post table (``core/em_table.py``).
* ``word_count_text_device``: words tokenized on the device straight
  from the file (``ctx.ReadWordsPacked``), then a device ReduceByKey.
* ``word_count_fixed``: the same reduce over pre-packed words.
"""

from __future__ import annotations

import numpy as np
import torch

from thrill_tpu_torch.api import Context, FieldReduce

MAX_WORD = 16   # device variants: words clipped and padded to 16 bytes


def word_count(ctx: Context, path_or_lines):
    """A DIA of (word, count) pairs from text, on host storage."""
    if isinstance(path_or_lines, str):
        lines = ctx.ReadLines(path_or_lines)
    else:
        lines = ctx.Distribute(list(path_or_lines), storage="host")
    return (lines
            .FlatMap(lambda line: line.split())
            .Map(lambda w: (w, 1))
            .ReduceByKey(lambda kv: kv[0],
                         lambda a, b: (a[0], a[1] + b[1])))


def pack_words(words) -> np.ndarray:
    """Strings as ``[n, MAX_WORD]`` uint8 rows (zero padded); row ``i``
    is ``words[i]``, an empty string an all-zero row."""
    enc = [w.encode("utf-8")[:MAX_WORD] for w in words]
    lens = np.fromiter((len(b) for b in enc), np.int64, count=len(enc))
    buf = np.frombuffer(b"".join(enc), dtype=np.uint8)
    if buf.size == 0:
        return np.zeros((len(words), MAX_WORD), dtype=np.uint8)
    offs = np.concatenate(([0], np.cumsum(lens)))[:-1]
    idx = offs[:, None] + np.arange(MAX_WORD)[None, :]
    valid = np.arange(MAX_WORD)[None, :] < lens[:, None]
    return np.where(valid, buf[np.where(valid, idx, 0)],
                    0).astype(np.uint8)


def _with_one(t):
    return {"w": t["w"], "c": torch.ones_like(t["w"][..., 0],
                                              dtype=torch.int64)}


def word_count_text_device(ctx: Context, path: str,
                           max_word: int = MAX_WORD):
    """WordCount straight from text files: tokenized on the device into
    packed byte rows (``ctx.ReadWordsPacked``), then a device
    ReduceByKey. A DIA of ``{"w": [max_word] u8, "c": count}`` rows
    (``thrill_tpu_torch.core.text.unpack_words`` gives the strings)."""
    words = ctx.ReadWordsPacked(path, max_word=max_word)
    return words.Map(_with_one).ReduceByKey(
        lambda t: t["w"], FieldReduce({"w": "first", "c": "sum"}))


def word_count_fixed(ctx: Context, packed: np.ndarray):
    """WordCount over pre-packed fixed-width words, on the device."""
    d = ctx.Distribute({"w": packed,
                        "c": np.ones(len(packed), dtype=np.int64)})
    return d.ReduceByKey(lambda t: t["w"],
                         FieldReduce({"w": "first", "c": "sum"}))


def main():
    import argparse
    parser = argparse.ArgumentParser(description="thrill_tpu_torch WordCount")
    parser.add_argument("input", help="text file, glob or directory")
    parser.add_argument("--top", type=int, default=10)
    parser.add_argument("--workers", type=int, default=1)
    parser.add_argument("--text-device", action="store_true",
                        help="tokenize and count on the device "
                             "(word_count_text_device); without it the "
                             "host pipeline (word_count) counts")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args()

    from thrill_tpu_torch.api import Run
    from thrill_tpu_torch.core.text import unpack_words

    def job(ctx):
        if not args.text_device:
            counts = word_count(ctx, args.input).AllGather()
        else:
            out = word_count_text_device(ctx, args.input).AllGatherArrays()
            counts = list(zip(unpack_words(out["w"]),
                              out["c"].cpu().tolist()))
        counts.sort(key=lambda kv: (-kv[1], kv[0]))
        for w, c in counts[:args.top]:
            print(f"{c:8d}  {w}")

    Run(job, num_workers=args.workers, device=args.device)


if __name__ == "__main__":
    main()
