"""Concat, ConcatMany, Union, UnionMany and Rebalance in the port against
the reference package on the CPU, on device, host and mixed storage:
per-worker items and counts must equal the reference's exactly. Rows
past the counts hold zeros (the exchange leaves copies there, ROADMAP.md
fault C4), and no op reads them."""

import jax
import numpy as np
import pytest
import torch

import thrill_tpu.api as japi
from thrill_tpu.api import Context as JContext
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.api.dia import DIA
from thrill_tpu_torch.api.dia_base import DIABase
from thrill_tpu_torch.common.partition import dense_range_bounds
from thrill_tpu_torch.data.shards import DeviceShards

WIDTHS = [1, 2, 4]


def _ref(W, job):
    jctx = JContext(JMeshExec(devices=jax.devices("cpu")[:W]))
    try:
        return job(jctx, japi)
    finally:
        jctx.close()


def _port(W, job):
    return job(tt.Context(num_workers=W, device="cpu"), tt)


def _per_worker(dia):
    shards = dia.node.materialize()
    if hasattr(shards, "lists"):
        return "host", [list(l) for l in shards.lists]
    return "device", [
        {k: v.tolist() for k, v in t.items()} if isinstance(t, dict)
        else t.tolist() for t in shards.to_worker_arrays()]


def _both(W, job):
    want, got = _ref(W, job), _port(W, job)
    assert want == got, (want, got)
    return got


# each source at every W; the filter leaves the items skewed
SOURCES = {
    "device": lambda c: c.Generate(23, lambda i: i * 10),
    "device skewed": lambda c: c.Generate(40).Filter(lambda x: x >= 29),
    "device dict": lambda c: c.Distribute({
        "a": np.arange(9, dtype=np.int64),
        "b": np.arange(18, dtype=np.float32).reshape(9, 2)}),
    "host": lambda c: c.Generate(13, lambda i: -i, storage="host"),
    "host skewed": lambda c: c.Generate(30, storage="host").Filter(
        lambda x: x < 5),
}
PAIRS = [("device", "device skewed"), ("device skewed", "device"),
         ("host", "host skewed"), ("device", "host"),
         ("host skewed", "device skewed")]


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("src", sorted(SOURCES))
def test_rebalance_matches_reference(W, src):
    got = _both(W, lambda c, m: _per_worker(SOURCES[src](c).Rebalance()))
    n = sum(len(l) for l in got[1])
    assert [len(l) for l in got[1]] == np.diff(
        dense_range_bounds(n, W)).tolist()


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("a,b", PAIRS)
def test_concat_matches_reference(W, a, b):
    _both(W, lambda c, m: _per_worker(SOURCES[a](c).Concat(SOURCES[b](c))))


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("a,b", PAIRS)
def test_union_matches_reference(W, a, b):
    _both(W, lambda c, m: _per_worker(SOURCES[a](c).Union(SOURCES[b](c))))


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("storage", ["device", "host", "mixed"])
def test_concat_many_and_union_many(W, storage):
    names = {"device": ["device", "device skewed", "device"],
             "host": ["host", "host skewed", "host"],
             "mixed": ["host skewed", "device", "device skewed"]}[storage]

    def job(c, m):
        parts = [SOURCES[n](c) for n in names]
        many = [SOURCES[n](c) for n in names]
        return (_per_worker(m.Concat(*parts)), _per_worker(m.Union(*many)))
    _both(W, job)


@pytest.mark.parametrize("W", WIDTHS)
def test_concat_of_dicts_keeps_schema(W):
    def job(c, m):
        a, b = SOURCES["device dict"](c), SOURCES["device dict"](c)
        return _per_worker(a.Concat(b.Filter(lambda t: t["a"] % 2 == 0)))
    _both(W, job)


@pytest.mark.parametrize("W", WIDTHS)
def test_rebalance_after_a_sort(W):
    # the sort's exchange leaves copies past the counts
    def job(c, m):
        d = c.Distribute(np.random.default_rng(W).permutation(50)).Sort()
        return _per_worker(d.Filter(lambda x: x < 20).Rebalance())
    _both(W, job)


class _Given(DIABase):
    """A node that yields the shards it is given."""

    def __init__(self, ctx, shards) -> None:
        super().__init__(ctx, "Given")
        self.shards = shards

    def compute(self):
        return self.shards


def _garbage_padded(ctx, counts, base):
    """Shards whose rows past the counts hold nonzero garbage."""
    W, cap = len(counts), 8
    vals = base + torch.arange(W * cap, dtype=torch.int64).reshape(W, cap)
    return DIA(_Given(ctx, DeviceShards(ctx.mesh_exec, {"v": vals},
                                        np.asarray(counts))))


@pytest.mark.parametrize("op", ["Concat", "Union", "Rebalance"])
def test_rows_past_the_counts_are_neither_read_nor_kept(op):
    ctx = tt.Context(num_workers=4, device="cpu")
    a = _garbage_padded(ctx, [3, 0, 8, 1], 100)
    b = _garbage_padded(ctx, [0, 2, 1, 0], 1000)
    out = {"Concat": lambda: a.Concat(b), "Union": lambda: a.Union(b),
           "Rebalance": lambda: a.Rebalance()}[op]().node.materialize()
    va = [100 + w * 8 + i for w, c in enumerate([3, 0, 8, 1])
          for i in range(c)]
    vb = [1000 + w * 8 + i for w, c in enumerate([0, 2, 1, 0])
          for i in range(c)]
    per = [t["v"].tolist() for t in out.to_worker_arrays()]
    if op == "Union":
        assert per == [[100, 101, 102], [1008, 1009],
                       [116 + i for i in range(8)] + [1016], [124]]
    else:
        want = va + (vb if op == "Concat" else [])
        assert [x for l in per for x in l] == want
        assert out.counts.tolist() == np.diff(
            dense_range_bounds(len(want), 4)).tolist()
    v = out.tree["v"]
    past = torch.arange(out.cap)[None, :] >= torch.as_tensor(out.counts)[:, None]
    assert not v[past].any()
