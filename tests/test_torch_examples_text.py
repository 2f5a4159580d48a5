"""The port's copy of ``examples/word_count.py`` against the reference
package's on the CPU, at W in {1, 2, 4}: ``word_count_text_device`` from
text files and ``word_count_fixed`` from packed words. Counts are int64
and must be equal; rows are compared sorted by word (the reference runs
its jitted engine, ``THRILL_TPU_HOST_RADIX=0``, whose row order the
port's need not share across workers). ``word_count``, the host
pipeline over strings, must give the reference's per-worker lists
exactly, at W in {1, 2, 3, 4}."""

import collections
import os
import sys

import jax
import numpy as np
import pytest

from thrill_tpu.api import Context as JContext
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.core.text import unpack_words
from thrill_tpu_torch.examples import word_count as twc

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import word_count as jwc  # noqa: E402

WIDTHS = [1, 2, 4]


@pytest.fixture(autouse=True)
def _jitted_reference(monkeypatch):
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")


def _ref(W, job):
    jctx = JContext(JMeshExec(devices=jax.devices("cpu")[:W]))
    try:
        return job(jctx)
    finally:
        jctx.close()


def _rows(out):
    w = np.asarray(out["w"].cpu() if hasattr(out["w"], "cpu") else out["w"])
    c = np.asarray(out["c"].cpu() if hasattr(out["c"], "cpu") else out["c"])
    order = np.lexsort(w.T[::-1])
    return w[order], c[order]


def _text(tmp_path, n_files=3, seed=0):
    rng = np.random.default_rng(seed)
    vocab = ["the", "a", "thrill", "ünïcode", "x" * 20, "word", "b", "zeta"]
    for i in range(n_files):
        words = rng.choice(vocab, size=200, p=[.3, .2, .1, .1, .05, .1,
                                                .1, .05])
        seps = rng.choice([" ", "  ", "\n", "\t", "\r\n"], size=200)
        (tmp_path / f"t{i}.txt").write_bytes(
            "".join(w + s for w, s in zip(words, seps)).encode())
    return str(tmp_path / "t*.txt")


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("max_word", [4, 16])
def test_word_count_text_device_matches_reference(tmp_path, W, max_word):
    path = _text(tmp_path, seed=W)
    want = _ref(W, lambda c: jwc.word_count_text_device(
        c, path, max_word).AllGatherArrays())
    got = twc.word_count_text_device(
        tt.Context(num_workers=W, device="cpu"), path,
        max_word).AllGatherArrays()
    gw, gc = _rows(got)
    ww, wc = _rows(want)
    assert gw.dtype == np.uint8 and gc.dtype == np.int64
    assert np.array_equal(gw, ww) and np.array_equal(gc, wc)
    # and against a plain count of the clipped words
    text = b"".join(open(p, "rb").read() for p in sorted(
        __import__("glob").glob(path)))
    plain = {}
    for wd in text.split():
        plain[wd[:max_word]] = plain.get(wd[:max_word], 0) + 1
    assert dict(zip(unpack_words(gw), gc.tolist())) == {
        k.decode("utf-8", "replace"): v for k, v in plain.items()}


@pytest.mark.parametrize("W", WIDTHS)
def test_word_count_fixed_matches_reference(W):
    words = [f"w{i % 37}" for i in range(500)] + ["", "longer-than-16-bytes!"]
    packed = twc.pack_words(words)
    assert np.array_equal(packed, jwc.pack_words(words))
    want = _ref(W, lambda c: jwc.word_count_fixed(c, packed)
                .AllGatherArrays())
    got = twc.word_count_fixed(tt.Context(num_workers=W, device="cpu"),
                               packed).AllGatherArrays()
    for g, w in zip(_rows(got), _rows(want)):
        assert np.array_equal(g, w)


def _host_lists(dia):
    return [list(l) for l in dia.node.materialize().lists]


def _word_count_both(W, source):
    want = _ref(W, lambda c: _host_lists(jwc.word_count(c, source)))
    got = _host_lists(twc.word_count(tt.Context(num_workers=W,
                                                device="cpu"), source))
    assert got == want
    assert all(type(w) is str and type(c) is int for l in got for w, c in l)
    return got


def test_word_count_host_pipeline_raises_naming_reduce_by_key(tmp_path):
    """The host pipeline does not raise: from a file and from a list of
    lines it gives the reference's (word, count) lists at W = 2."""
    path = _text(tmp_path, n_files=1)
    text = open(path.replace("*", "0"), encoding="utf-8").read()
    got = _word_count_both(2, path)
    assert dict(it for l in got for it in l) == \
        collections.Counter(text.split())
    got = _word_count_both(2, ["a b", "b", "", "c  a b"])
    assert sorted(it for l in got for it in l) == [("a", 2), ("b", 3),
                                                    ("c", 1)]


@pytest.mark.parametrize("W", [1, 3, 4])
def test_word_count_host_pipeline_matches_reference(tmp_path, W):
    path = _text(tmp_path, seed=W)
    got = _word_count_both(W, path)
    text = b"".join(open(p, "rb").read() for p in sorted(
        __import__("glob").glob(path))).decode()
    assert dict(it for l in got for it in l) == \
        collections.Counter(text.split())


def test_main_counts_a_file_on_the_text_device_path(tmp_path, capsys,
                                                    monkeypatch):
    (tmp_path / "in.txt").write_text("b a b\nc b a\n")
    monkeypatch.setattr(sys, "argv", [
        "word_count", str(tmp_path / "in.txt"), "--text-device",
        "--device", "cpu", "--workers", "2"])
    twc.main()
    assert capsys.readouterr().out.split() == ["3", "b", "2", "a", "1", "c"]
    # the host pipeline counts the same
    monkeypatch.setattr(sys, "argv", [
        "word_count", str(tmp_path / "in.txt"), "--device", "cpu",
        "--workers", "3"])
    twc.main()
    assert capsys.readouterr().out.split() == ["3", "b", "2", "a", "1", "c"]
