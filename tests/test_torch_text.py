"""The port's ``core/text.py`` against the reference package's.

``tokenize_packed`` must be bit-equal to the reference's on any bytes:
hypothesis draws byte strings weighted towards separators, and the edge
cases are listed. Exact comparison (uint8)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from thrill_tpu.core import text as jtext

from thrill_tpu_torch.core import text as ttext

EDGES = {
    "empty": b"",
    "only separators": b" \t\n\r\x0b\x0c  \n",
    "one word": b"word",
    "longer than max_word": b"abcdefghijklmnopqrstuvwxyz0123456789 ab",
    "cut utf-8": "ééééééééé x".encode(),
    "crlf": b"one\r\ntwo\r\n\r\nthree",
    "vt and ff": b"a\x0bb\x0cc\x0b\x0cd",
    "unicode space is no separator": "a b c d".encode(),
    "zero bytes": b"a\x00b \x00\x00 c",
    "leading and trailing": b"  lead trail  ",
}

_BYTES = st.lists(st.one_of(st.sampled_from(list(b" \t\n\r\x0b\x0c")),
                            st.integers(0, 255)), max_size=300).map(bytes)


def _port(data, max_word):
    return ttext.tokenize_packed(
        torch.tensor(list(data), dtype=torch.uint8), max_word).numpy()


def test_separators_are_the_reference_s():
    assert ttext.SEPARATORS == jtext.SEPARATORS
    a = np.arange(256, dtype=np.uint8)
    assert np.array_equal(ttext.sep_mask(a), jtext.sep_mask(a))
    assert np.array_equal(ttext.sep_mask(torch.from_numpy(a)).numpy(),
                          jtext.sep_mask(a))


@pytest.mark.parametrize("case", sorted(EDGES))
@pytest.mark.parametrize("max_word", [1, 3, 16])
def test_tokenize_edge_cases_equal_reference(case, max_word):
    data = EDGES[case]
    got = _port(data, max_word)
    want = jtext.tokenize_packed(data, max_word)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert np.array_equal(ttext.tokenize_packed(data, max_word).numpy(), want)
    assert ttext.unpack_words(got) == jtext.unpack_words(want)


@settings(max_examples=200, deadline=None)
@given(data=_BYTES, max_word=st.integers(1, 20))
def test_tokenize_equals_reference_on_random_bytes(data, max_word):
    assert np.array_equal(_port(data, max_word),
                          jtext.tokenize_packed(data, max_word))


@settings(max_examples=60, deadline=None)
@given(parts=st.lists(_BYTES, min_size=1, max_size=6),
       max_word=st.integers(1, 12))
def test_chunk_boundaries_separate_words(parts, max_word):
    # each chunk tokenized alone and concatenated: what a boundary means
    want = [jtext.tokenize_packed(p, max_word) for p in parts]
    data = b"".join(parts)
    starts = torch.tensor(np.cumsum([0] + [len(p) for p in parts])[:-1])
    got, first = ttext.tokenize_chunks(
        torch.tensor(list(data), dtype=torch.uint8), starts, max_word)
    assert np.array_equal(got.numpy(), np.concatenate(want, axis=0))
    assert first.tolist() == sorted(first.tolist())
    assert torch.equal(torch.searchsorted(first, starts),
                       torch.tensor(np.cumsum([0] + [len(w) for w in want])
                                    [:-1]))


def test_find_first_sep_equals_reference():
    for data in list(EDGES.values()) + [b"abc\x0cdef", b"xyz"]:
        assert ttext.find_first_sep(data) == jtext.find_first_sep(data)


def test_unpack_words_of_a_tensor():
    packed = ttext.tokenize_packed(b"hello wor\xc3\xa9ld", 10)
    assert ttext.unpack_words(packed) == ["hello", "woréld"]
    assert ttext.unpack_words(packed) == jtext.unpack_words(packed.numpy())


def test_tokenize_refuses_other_dtypes():
    with pytest.raises(ValueError, match="uint8"):
        ttext.tokenize_packed(torch.zeros(4, dtype=torch.int32))
