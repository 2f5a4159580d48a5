"""Text tokenization: raw bytes to a fixed-width word matrix
(counterpart of the reference package's ``core/text.py``).

Variable-length words become ``[n, max_word]`` zero-padded uint8 rows,
the byte-key layout that ``core/keys.py`` sorts and hashes. The
tokenizer is a few elementwise passes, one ``nonzero`` and one gather a
byte column, on the tensor's own device: over text uploaded once, the
words never exist as Python objects.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

#: ASCII whitespace only. Unicode whitespace (U+00A0, U+2028, ...) does
#: not separate words here, so UTF-8 text that uses it tokenizes unlike
#: ``str.split()``: the contract is what a per-byte scan can evaluate.
SEPARATORS = b" \t\n\r\x0b\x0c"

_SEP = np.zeros(256, dtype=bool)
_SEP[list(SEPARATORS)] = True


def sep_mask(data):
    """bool per byte: is it a word separator. A numpy array gives a
    numpy mask; a uint8 tensor gives a tensor mask on its device."""
    if isinstance(data, torch.Tensor):
        mask = data == SEPARATORS[0]
        for s in SEPARATORS[1:]:
            mask |= data == s
        return mask
    return _SEP[np.asarray(data, dtype=np.uint8)]


def find_first_sep(data: bytes) -> int:
    """Offset of the first separator byte, or -1."""
    hits = np.flatnonzero(_SEP[np.frombuffer(data, dtype=np.uint8)])
    return int(hits[0]) if len(hits) else -1


def _as_bytes_tensor(data) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        if data.dtype != torch.uint8 or data.dim() != 1:
            raise ValueError(f"tokenize: a 1-D uint8 tensor is needed, got "
                             f"{data.dtype} {tuple(data.shape)}")
        return data
    return torch.from_numpy(np.frombuffer(bytes(data), dtype=np.uint8).copy())


def tokenize_chunks(data, chunk_starts: Optional[torch.Tensor] = None,
                    max_word: int = 16
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Words of ``data`` (a 1-D uint8 tensor) as ``[n_words, max_word]``
    uint8 rows on its device, plus each word's first byte offset (int64,
    ascending). ``chunk_starts`` (int64 byte offsets, the first 0) cut
    ``data`` into chunks whose boundaries separate words, as file
    boundaries do."""
    a = _as_bytes_tensor(data)
    n, dev = a.numel(), a.device
    if n == 0:
        return (torch.zeros((0, max_word), dtype=torch.uint8, device=dev),
                torch.zeros(0, dtype=torch.int64, device=dev))
    sep = sep_mask(a)
    word = ~sep
    # a word starts at a non-separator after a separator or a chunk
    # start, and ends before a separator or a chunk end
    after_sep = torch.ones(n, dtype=torch.bool, device=dev)
    after_sep[1:] = sep[:-1]
    before_sep = torch.ones(n, dtype=torch.bool, device=dev)
    before_sep[:-1] = sep[1:]
    del sep
    if chunk_starts is not None:
        cs = chunk_starts.to(device=dev, dtype=torch.int64)
        after_sep[cs[cs < n]] = True
        before_sep[cs[cs > 0] - 1] = True
    starts = torch.nonzero(word & after_sep).reshape(-1)
    ends = torch.nonzero(word & before_sep).reshape(-1) + 1
    del word, after_sep, before_sep
    m = starts.numel()
    out = torch.zeros((m, max_word), dtype=torch.uint8, device=dev)
    if m == 0:
        return out, starts
    # int32 offsets while the text is under 2 GiB: half the index bytes
    idx_t = torch.int32 if n < (1 << 31) - max_word else torch.int64
    s = starts.to(idx_t)
    lens = (ends - starts).clamp_(max=max_word).to(idx_t)
    del ends
    zero = torch.zeros((), dtype=torch.uint8, device=dev)
    for j in range(max_word):
        idx = (s + j).clamp_(max=n - 1)
        out[:, j] = torch.where(lens > j, a.index_select(0, idx), zero)
    return out, starts


def tokenize_packed(data, max_word: int = 16) -> torch.Tensor:
    """Pack every whitespace-delimited word of ``data`` (a 1-D uint8
    tensor, or bytes) into a ``[n_words, max_word]`` uint8 matrix on the
    tensor's device: zero padded, clipped at ``max_word`` bytes.

    Contract (byte-level, see SEPARATORS): words split on ASCII
    whitespace only, and clipping at ``max_word`` bytes may cut a
    multi-byte UTF-8 sequence (``unpack_words`` decodes with
    errors='replace')."""
    return tokenize_chunks(data, None, max_word)[0]


def unpack_words(packed) -> list:
    """``[n, L]`` uint8 rows to strings (zero padding stripped)."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    return [bytes(row).rstrip(b"\x00").decode("utf-8", "replace")
            for row in np.asarray(packed)]
