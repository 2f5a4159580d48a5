"""The port's copy of ``examples/sgd.py`` against the reference
package's on the CPU, at W in {1, 2, 4}.

With every row in the batch the descent is f64 sums taken in another
order, so the weights must agree within ``1e-12`` absolute. At a batch
fraction below one the port draws other batches than the reference (it
cannot reproduce ``jax.random``), so there it must come as close to the
true weights: within 0.01 of the reference's error.
"""

import os
import sys

import jax
import numpy as np
import pytest

from thrill_tpu.api import Context as JContext
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.examples import sgd as tsg

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import sgd as jsg  # noqa: E402

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


def _sgd_data(seed, n=3000, dim=6):
    rng = np.random.default_rng(seed)
    true_w = rng.normal(size=dim)
    X = rng.normal(size=(n, dim))
    return true_w, X, X @ true_w + 0.01 * rng.normal(size=n)


@pytest.mark.parametrize("W", WIDTHS)
def test_sgd_full_batch_matches_reference(W):
    true_w, X, y = _sgd_data(30 + W)
    want = _ref(W, lambda c: jsg.sgd_linear(c, X, y, iterations=12,
                                            batch_fraction=1.0))
    got = tsg.sgd_linear(_ctx(W), X, y, iterations=12, batch_fraction=1.0)
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("W", WIDTHS)
def test_sgd_sampled_batches_come_as_close_as_reference(W):
    true_w, X, y = _sgd_data(40 + W)
    want = _ref(W, lambda c: jsg.sgd_linear(c, X, y, iterations=40,
                                            batch_fraction=0.25))
    got = tsg.sgd_linear(_ctx(W), X, y, iterations=40, batch_fraction=0.25)
    err_ref = np.linalg.norm(want - true_w)
    err = np.linalg.norm(got - true_w)
    assert abs(err - err_ref) <= 0.01, (err, err_ref)
    # and the batches were sampled: not the full-batch descent
    full = tsg.sgd_linear(_ctx(W), X, y, iterations=40, batch_fraction=1.0)
    assert np.abs(got - full).max() > 1e-6
