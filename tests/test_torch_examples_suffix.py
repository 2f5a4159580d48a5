"""The port's copy of ``examples/suffix_sorting.py`` against the
reference package's on the CPU, at W in {1, 2, 4}: prefix doubling and
quadrupling equal to the reference's and to ``suffix_array_dense``; the
wavelet matrix, the BWT and its run-length form equal to the
reference's; the checkers copied with them agree with the reference's.
(DC3 and DC7 are in ``test_torch_examples_dc.py``.)
"""

import os
import sys

import jax
import numpy as np
import pytest

from thrill_tpu.api import Context as JContext
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.examples import suffix_sorting as tss

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import suffix_sorting as jss  # noqa: E402

WIDTHS = [1, 2, 4]
CONSTRUCTIONS = ["suffix_array", "suffix_array_quadrupling"]


def _text(kind):
    rng = np.random.default_rng(5)
    if kind == "dna":
        return rng.integers(97, 101, 200).astype(np.uint8)
    if kind == "periodic":        # long repeats: deep recursion, many rounds
        return np.frombuffer(b"abaabaab" * 14 + b"c", dtype=np.uint8)
    return rng.integers(0, 256, 120).astype(np.uint8)


def _ref(W, job):
    jctx = JContext(JMeshExec(devices=jax.devices("cpu")[:W]))
    try:
        return job(jctx)
    finally:
        jctx.close()


def _ctx(W):
    return tt.Context(num_workers=W, device="cpu")


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("kind", ["dna", "periodic", "bytes"])
@pytest.mark.parametrize("name", CONSTRUCTIONS)
def test_suffix_array_matches_reference(W, kind, name):
    text = _text(kind)
    want = _ref(W, lambda c: getattr(jss, name)(c, text))
    got = getattr(tss, name)(_ctx(W), text)
    assert np.array_equal(np.asarray(got, dtype=np.int64), want)
    assert np.array_equal(got, tss.suffix_array_dense(text))
    assert tss.check_sa(text, got)


@pytest.mark.parametrize("name", CONSTRUCTIONS)
def test_suffix_array_of_tiny_texts(name):
    for text in (b"", b"a", b"ab", b"ba", b"aaaa", b"banana"):
        t = np.frombuffer(text, dtype=np.uint8)
        got = getattr(tss, name)(_ctx(2), t)
        assert np.array_equal(got, tss.suffix_array_dense(t))


@pytest.mark.parametrize("W", WIDTHS)
def test_wavelet_tree_matches_reference(W):
    text = _text("bytes")
    want = _ref(W, lambda c: jss.wavelet_tree(c, text))
    got = tss.wavelet_tree(_ctx(W), text)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    for i in range(0, len(text), 7):
        assert tss.wavelet_access(got, len(text), i) == text[i]


@pytest.mark.parametrize("W", WIDTHS)
def test_bwt_and_rl_bwt_match_reference(W):
    text = _text("periodic")
    want = _ref(W, lambda c: (jss.bwt(c, text), jss.rl_bwt(c, text)))
    ctx = _ctx(W)
    got_b, (chars, lens) = tss.bwt(ctx, text), tss.rl_bwt(ctx, text)
    assert np.array_equal(got_b, want[0])
    assert np.array_equal(chars, want[1][0])
    assert np.array_equal(lens, want[1][1])
    assert lens.sum() == len(text) and len(chars) < len(text) // 4


def test_checkers_agree_with_reference():
    text = _text("dna")
    sa = tss.suffix_array_dense(text)
    assert np.array_equal(tss.lcp_from_sa(text, sa),
                          jss.lcp_from_sa(text, sa))
    bad = sa.copy()
    bad[[3, 4]] = bad[[4, 3]]
    for s in (sa, bad, sa[:-1]):
        assert tss.check_sa(text, s) == jss.check_sa(text, s)
    assert not tss.check_sa(text, bad)
