"""The port's copies of ``examples/triangles.py`` and ``examples/bfs.py``
against the reference package's on the CPU, at W in {1, 2, 4}: the
triangle counts and the BFS levels must be equal, and equal to the
dense checkers copied with the examples.
"""

import os
import sys

import jax
import numpy as np
import pytest

from thrill_tpu.api import Context as JContext
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.examples import bfs as tbfs
from thrill_tpu_torch.examples import triangles as ttri

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import bfs as jbfs  # noqa: E402
import triangles as jtri  # noqa: E402

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


def _oriented_edges(seed, nodes, m):
    raw = np.random.default_rng(seed).integers(0, nodes, (m, 2))
    raw = raw[raw[:, 0] != raw[:, 1]]
    return np.unique(np.sort(raw, axis=1), axis=0).astype(np.int64)


@pytest.mark.parametrize("W", WIDTHS)
def test_triangles_match_reference(W):
    edges = _oriented_edges(W, 40, 260)
    want = _ref(W, lambda c: jtri.count_triangles(c, edges))
    got = ttri.count_triangles(_ctx(W), edges)
    assert got == want == ttri.count_triangles_dense(edges) > 0


@pytest.mark.parametrize("W", WIDTHS)
def test_triangles_without_any(W):
    # a star has no triangle: the closing join finds no partner
    edges = np.stack([np.zeros(30, np.int64), np.arange(1, 31)], axis=1)
    assert ttri.count_triangles(_ctx(W), edges) == 0


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("nodes,m", [(120, 300), (300, 280)])
def test_bfs_matches_reference(W, nodes, m):
    edges = np.random.default_rng(nodes + W).integers(
        0, nodes, (m, 2)).astype(np.int64)
    src = int(edges[0, 0])
    want = _ref(W, lambda c: jbfs.bfs_levels(c, edges, nodes, source=src))
    got = tbfs.bfs_levels(_ctx(W), edges, nodes, source=src)
    assert got.dtype == np.int64
    assert np.array_equal(got, want)
    assert np.array_equal(got, tbfs.bfs_dense(edges, nodes, source=src))
    assert (got == -1).any() and got.max() >= 2
