"""The DC3 and DC7 suffix-array constructions of the port's copy of
``examples/suffix_sorting.py`` against the reference package's on the
CPU, at W in {1, 2, 4}: equal to the reference's and to
``suffix_array_dense``, and passing ``check_sa``.
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
CONSTRUCTIONS = ["dc3_suffix_array", "dc7_suffix_array"]


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
