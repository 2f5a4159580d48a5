"""The port's copies of ``examples/percentiles.py``,
``examples/select_kth.py``, ``examples/terasort.py`` and
``examples/tutorial.py`` against the reference package's on the CPU, at
W in {1, 2, 4}. Everything is integer and must be equal; select_kth also
to ``np.partition``; the tutorial's printed lines too, but for
``stats:``, where the port keeps fewer counters: there ``workers`` and
``exchanges`` must be equal.
"""

import ast
import contextlib
import io
import os
import sys

import jax
import numpy as np
import pytest

from thrill_tpu.api import Context as JContext
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.examples import percentiles as tpc
from thrill_tpu_torch.examples import select_kth as tsk
from thrill_tpu_torch.examples import terasort as tts
from thrill_tpu_torch.examples import tutorial as ttu

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import percentiles as jpc  # noqa: E402
import select_kth as jsk  # noqa: E402
import terasort as jts  # noqa: E402
import tutorial as jtu  # noqa: E402

WIDTHS = [1, 2, 4]


def _jax_ctx(W):
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]))


def _ref(W, job):
    jctx = _jax_ctx(W)
    try:
        return job(jctx)
    finally:
        jctx.close()


def _ctx(W):
    return tt.Context(num_workers=W, device="cpu")


@pytest.mark.parametrize("W", WIDTHS)
def test_percentiles_match_reference(W):
    vals = np.random.default_rng(W).integers(0, 10 ** 9, 5000)
    qs = (1, 25, 50, 90, 95, 99)
    want = _ref(W, lambda c: jpc.percentiles(c, vals, qs))
    got = tpc.percentiles(_ctx(W), vals, qs)
    assert got == want
    srt = np.sort(vals)
    assert got == {q: int(srt[int(q / 100 * len(vals))]) for q in qs}


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("k", [0, 2999, 6000, 11999])
def test_select_kth_matches_reference(W, k):
    vals = np.random.default_rng(100 + W).integers(0, 1 << 40, 12000)
    want = _ref(W, lambda c: jsk.select_kth(c, vals, k, gather_limit=512))
    got = tsk.select_kth(_ctx(W), vals, k, gather_limit=512)
    assert got == want == int(np.partition(vals, k)[k])


@pytest.mark.parametrize("W", WIDTHS)
def test_select_kth_with_ties(W):
    vals = np.random.default_rng(7).integers(0, 40, 9000)
    for k in (0, 4500, 8999):
        assert tsk.select_kth(_ctx(W), vals, k, gather_limit=256) == int(
            np.partition(vals, k)[k])


@pytest.mark.parametrize("W", WIDTHS)
def test_terasort_matches_reference(W):
    recs = tts.generate_records(3000, seed=W)
    for k in recs:
        assert np.array_equal(recs[k], jts.generate_records(3000, seed=W)[k])

    def job(mod, c):
        d = mod.terasort(c, recs).Keep()
        return d.Size(), d.AllGatherArrays()

    n_ref, want = _ref(W, lambda c: job(jts, c))
    n, got = job(tts, _ctx(W))
    assert n == n_ref == 3000
    for k in recs:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    assert tts.verify_sorted({"key": got["key"].numpy()})
    assert not tts.verify_sorted({"key": recs["key"]})


def _lines(job, ctx):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        job(ctx)
    return out.getvalue().splitlines()


@pytest.mark.parametrize("W", WIDTHS)
def test_tutorial_prints_the_reference_s_lines(W):
    want = _ref(W, lambda c: _lines(jtu.job, c))
    got = _lines(ttu.job, _ctx(W))
    assert len(got) == len(want) == 6
    assert got[:-1] == want[:-1]
    stats = [ast.literal_eval(l.split(":", 1)[1].strip())
             for l in (got[-1], want[-1])]
    for key in ("workers", "exchanges"):
        assert stats[0][key] == stats[1][key], key
    assert stats[0]["workers"] == W
