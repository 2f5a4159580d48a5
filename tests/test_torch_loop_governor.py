"""The HBM governor under a replayed loop, against the reference
package on the CPU (the question ROADMAP.md item 8b left open: does the
governor see a replayed loop?).

PageRank W = 4 runs under a cut ``hbm_limit`` in both packages, loop
replay on (the captured first iteration, then the whole-loop program)
and off. With the port's governor given the reference's spill rule
(``held_storages`` empty) the spills and restores equal the reference's
in both loop modes; with the port's own rule, which never spills a
cached result that a running compute holds (ROADMAP.md fault C16,
recorded), it makes no more of either. The ranks agree within 1e-12
relative (ROADMAP.md fault C15).
"""

import os
import sys

import numpy as np
import pytest

import jax
from thrill_tpu.api import Context as JContext
from thrill_tpu.common.config import Config as JConfig
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.common.config import Config
from thrill_tpu_torch.examples import page_rank as tpr
from thrill_tpu_torch.mem import hbm as thbm

_REF_EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
LIMIT = 60_000          # under the unpressured ledger peak, 147456 bytes


def _ref_pr():
    if _REF_EXAMPLES not in sys.path:
        sys.path.insert(0, _REF_EXAMPLES)
    import page_rank
    return page_rank


def _run(pkg, tmp_path):
    edges = tpr.zipf_graph(1024, 8192, seed=5)
    if pkg == "port":
        ctx = tt.Context(num_workers=4, device="cpu", config=Config(
            hbm_limit=LIMIT, spill_dir=str(tmp_path)))
        mod = tpr
    else:
        ctx = JContext(JMeshExec(devices=jax.devices("cpu")[:4]),
                       JConfig(hbm_limit=LIMIT, spill_dir=str(tmp_path)))
        mod = _ref_pr()
    ranks = np.asarray(mod.page_rank(ctx, edges, 1024, iterations=6))
    s = ctx.overall_stats()
    ctx.close()
    return ranks, (s["hbm_spills"], s["hbm_restores"]), (
        s["loop_plan_builds"], s["loop_replays"], s["loop_fori_iters"])


@pytest.mark.parametrize("replay", ["1", "0"])
def test_pagerank_under_a_cut_limit_spills_as_the_reference(
        replay, tmp_path, monkeypatch):
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    monkeypatch.setenv("THRILL_TPU_LOOP_REPLAY", replay)
    ref_ranks, ref_io, ref_loop = _run("ref", tmp_path)
    ranks, io, loop = _run("port", tmp_path)
    np.testing.assert_allclose(ranks, ref_ranks, rtol=1e-12)
    assert loop == ref_loop
    assert io[0] <= ref_io[0] and io[1] <= ref_io[1]
    # the reference's rule: every spill and restore equal
    monkeypatch.setattr(thbm.HbmGovernor, "held_storages",
                        lambda self: set())
    ranks2, io2, loop2 = _run("port", tmp_path)
    assert np.array_equal(ranks2, ranks)
    assert (io2, loop2) == (ref_io, ref_loop)
    assert ref_io[0] > 0
