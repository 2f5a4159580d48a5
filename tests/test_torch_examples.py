"""The port's copies of ``examples/page_rank.py`` and ``examples/tpch.py``
against the reference package's on the CPU, at W in {1, 2, 4}.

PageRank (200 pages, 2000 edges, 5 iterations, f64) must be within
``1e-12`` absolute of the reference (each page's sum of contributions may
associate differently; ranks are at most about 0.1); TPC-H Q3-lite is
int64 and must be equal.
"""

import os
import sys

import jax
import numpy as np
import pytest

from thrill_tpu.api import Context as JContext
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.examples import page_rank as tpr
from thrill_tpu_torch.examples import tpch as ttp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import page_rank as jpr  # noqa: E402
import tpch as jtp  # noqa: E402

WIDTHS = [1, 2, 4]


def _jax_ctx(W):
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]))


def test_generators_are_the_reference_s():
    assert np.array_equal(tpr.zipf_graph(300, 999, seed=5),
                          jpr.zipf_graph(300, 999, seed=5))
    to, tl = ttp.generate_tables(111, 3, seed=2)
    jo, jl = jtp.generate_tables(111, 3, seed=2)
    for t, j in ((to, jo), (tl, jl)):
        assert t.keys() == j.keys()
        assert all(np.array_equal(t[k], j[k]) for k in t)


@pytest.mark.parametrize("W", WIDTHS)
def test_page_rank_matches_reference(W):
    edges = jpr.zipf_graph(200, 2000, seed=W)
    jctx = _jax_ctx(W)
    try:
        want = jpr.page_rank(jctx, edges, 200, 5)
    finally:
        jctx.close()
    got = tpr.page_rank(tt.Context(num_workers=W, device="cpu"), edges, 200,
                        5)
    assert got.dtype == np.float64 and got.shape == (200,)
    assert np.abs(got - want).max() <= 1e-12
    dense = tpr.page_rank_dense(None, edges, 200, 5)
    assert np.abs(got - dense).max() <= 1e-9


@pytest.mark.parametrize("W", WIDTHS)
def test_q3_lite_matches_reference(W):
    orders, lineitem = jtp.generate_tables(400, seed=W)
    jctx = _jax_ctx(W)
    try:
        want = jtp.q3_lite(jctx, orders, lineitem)
    finally:
        jctx.close()
    for ld in (None, True, False):
        got = ttp.q3_lite(tt.Context(num_workers=W, device="cpu"), orders,
                          lineitem, location_detection=ld)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(want, jtp.q3_dense(orders, lineitem))
