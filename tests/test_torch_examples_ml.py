"""The port's copies of ``examples/k_means.py`` and
``examples/logistic_regression.py`` against the reference package's on
the CPU, at W in {1, 2, 4}.

Results are f64 sums taken in another order, so they must agree within
``1e-12`` absolute (centers and weights are of order 1); the labels of
every point must be equal.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from thrill_tpu.api import Bind as JBind
from thrill_tpu.api import Context as JContext
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.examples import k_means as tkm
from thrill_tpu_torch.examples import logistic_regression as tlr

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import k_means as jkm  # noqa: E402
import logistic_regression as jlr  # noqa: E402

WIDTHS = [1, 2, 4]
TOL = 1e-12


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
def test_k_means_matches_reference(W):
    rng = np.random.default_rng(10 + W)
    pts = np.concatenate([rng.normal(loc=c, size=(400, 3))
                          for c in (-4.0, 0.0, 5.0)])
    pts = pts[rng.permutation(len(pts))]
    want = _ref(W, lambda c: jkm.k_means(c, pts, 5, iterations=6, seed=W))
    got = tkm.k_means(_ctx(W), pts, 5, iterations=6, seed=W)
    assert got.dtype == np.float64 and got.shape == (5, 3)
    assert np.abs(got - want).max() <= TOL
    c0 = pts[np.random.default_rng(W).choice(len(pts), 5, replace=False)]
    assert np.abs(got - jkm.k_means_dense(pts, c0, 6)).max() <= 1e-9

    # the labels of every point under the final centers, each package's
    # classify functor through its own pipeline
    def labels_ref(c):
        return np.asarray(c.Distribute(pts).Map(JBind(jkm._label, want))
                          .AllGatherArrays()["i"])

    lab = (_ctx(W).Distribute(pts).Map(tt.Bind(tkm._label, want))
           .AllGatherArrays()["i"].numpy())
    assert np.array_equal(lab, _ref(W, labels_ref))


def test_k_means_counts_its_update_calls():
    rng = np.random.default_rng(3)
    ctx = _ctx(2)
    tkm.k_means(ctx, rng.normal(size=(64, 2)), 3, iterations=4)
    upd = ctx.mesh_exec.jit_cached(("kmeans_center_update",), None)
    assert upd.fn is tkm._center_update and upd.calls == 4


def test_k_means_keeps_an_empty_cluster_s_center():
    sums = torch.tensor([[2.0, 4.0], [0.0, 0.0]], dtype=torch.float64)
    cnt = torch.tensor([2.0, 0.0], dtype=torch.float64)
    old = torch.tensor([[9.0, 9.0], [7.0, -7.0]], dtype=torch.float64)
    assert tkm._center_update(sums, cnt, old).tolist() == [[1.0, 2.0],
                                                            [7.0, -7.0]]


@pytest.mark.parametrize("W", WIDTHS)
def test_logistic_regression_matches_reference(W):
    rng = np.random.default_rng(20 + W)
    n, dim = 600, 4
    true_w = rng.normal(size=dim)
    X = rng.normal(size=(n, dim))
    y = (X @ true_w + 0.1 * rng.normal(size=n) > 0).astype(np.float64)
    want = _ref(W, lambda c: jlr.logistic_regression(c, X, y, iterations=15))
    got = tlr.logistic_regression(_ctx(W), X, y, iterations=15)
    assert got.dtype == np.float64 and got.shape == (dim,)
    assert np.abs(got - want).max() <= TOL
