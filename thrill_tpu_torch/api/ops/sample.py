"""BernoulliSample and Sample(k) (counterpart of the reference package's
``api/ops/sample.py``).

Both draw on the mesh's device exactly the reference's bits:
``common/threefry.py`` is jax's default PRNG (threefry2x32, partitionable
counters, f64 uniforms as under x64) in masked int64 arithmetic, so the
CPU and the card draw the same. Worker ``w`` draws from
``fold_in(PRNGKey(seed), w)``: BernoulliSample keeps an item when its
uniform is below p; Sample scores its items with the uniforms of
``fold_in(PRNGKey(seed ^ 0x5A), w)``, its per-worker takes the
reference's numpy hypergeometric split, and keeps the ``t`` best scores,
in their original order. So both keep the reference's items. Each runs
as one program whose counts stay on the device, as the reference's.

On host storage both draw with numpy as the reference does, so they
keep the reference's items exactly: BernoulliSample one
``np.random.default_rng(seed)`` across the workers in order, Sample the
hypergeometric split and then ``rng.choice`` a worker from the same
generator.
"""

from __future__ import annotations

import numpy as np
import torch

from ...common import threefry
from ...common import tree as pt
from ...common.sampling import hypergeometric_split
from ...core import keys as keymod
from ...core.device_sort import argsort_words
from ...data import multiplexer
from ...data.shards import DeviceShards, HostShards, compact_valid
from ..dia import DIA
from ..dia_base import DIABase

_SAMPLE_SALT = 0x5A   # Sample's seed is the reference's seed ^ 0x5A


def uniforms(seed: int, W: int, cap: int, device) -> torch.Tensor:
    """``[W, cap]`` f64 uniforms in [0, 1) on ``device``: row ``w`` is
    ``jax.random.uniform(fold_in(PRNGKey(seed), w), (cap,))``, bit for
    bit."""
    keys = threefry.fold_in(threefry.prng_key(seed),
                            torch.arange(W, device=device))
    return threefry.uniform(keys, (cap,))


def worker_uniforms(mex, seed: int, cap: int) -> torch.Tensor:
    """:func:`uniforms` of the mesh's workers on its device."""
    return uniforms(seed, mex.num_workers, cap, mex.device)


def _valid(tree, counts: torch.Tensor) -> torch.Tensor:
    cap = pt.leaves(tree)[0].shape[1]
    return torch.arange(cap, device=counts.device)[None, :] < counts[:, None]


def _bernoulli_prog(tree, counts: torch.Tensor, p: float, seed: int):
    """Program: keep each valid item whose uniform is below ``p``,
    compacted; (tree, ``[W]`` counts)."""
    mask = _valid(tree, counts)
    W, cap = mask.shape
    return compact_valid(tree, mask & (uniforms(seed, W, cap, mask.device)
                                       < p))


class BernoulliSampleNode(DIABase):
    def __init__(self, ctx, link, p: float, seed: int) -> None:
        super().__init__(ctx, f"BernoulliSample({p})", [link])
        self.p = float(p)
        self.seed = seed

    def compute(self):
        shards = self.parents[0].pull()
        if isinstance(shards, HostShards):
            rng = np.random.default_rng(self.seed)
            return HostShards(shards.num_workers,
                              [[it for it in items if rng.random() < self.p]
                               for items in shards.lists])
        mex = shards.mesh_exec
        prog = mex.program(("bernoulli", self.p, self.seed), _bernoulli_prog)
        tree, counts = prog(shards.tree, shards.counts_device(), self.p,
                            self.seed)
        return DeviceShards(mex, tree, counts)


def _sample_prog(tree, counts: torch.Tensor, takes: torch.Tensor,
                 seed: int, passes: list):
    """Program: score each worker's items with its uniforms, push the
    padding last (2.0), keep the ``takes[w]`` best in their original
    order; (tree, ``[W]`` counts)."""
    mask = _valid(tree, counts)
    W, cap = mask.shape
    dev = mask.device
    scores = torch.where(mask, uniforms(seed ^ _SAMPLE_SALT, W, cap, dev),
                         torch.full((), 2.0, dtype=torch.float64, device=dev))
    order = argsort_words(keymod.encode_key_words(scores), passes=passes)
    ranked = torch.arange(cap, device=dev)[None, :] < takes[:, None]
    keep = torch.zeros_like(mask).scatter_(1, order, ranked)
    return compact_valid(tree, keep & mask)


class SampleNode(DIABase):
    def __init__(self, ctx, link, k: int, seed: int) -> None:
        super().__init__(ctx, f"Sample({k})", [link])
        self.k = int(k)
        self.seed = seed

    def compute(self):
        shards = self.parents[0].pull()
        if isinstance(shards, HostShards):
            return self._compute_host(shards)
        mex = shards.mesh_exec
        takes = hypergeometric_split(np.random.default_rng(self.seed),
                                     self.k, shards.counts)
        prog = mex.program(("sample_k", self.seed), _sample_prog)
        tree, counts = prog(shards.tree, shards.counts_device(),
                            mex.put_small(takes.astype(np.int64)),
                            self.seed, mex.radix_passes)
        return DeviceShards(mex, tree, counts)

    def _compute_host(self, shards: HostShards) -> HostShards:
        """Reference: ``thrill_tpu/api/ops/sample.py:70-87``."""
        rng = np.random.default_rng(self.seed)
        takes = hypergeometric_split(
            rng, self.k, multiplexer.global_counts(self.context.mesh_exec,
                                                   shards))
        out = []
        for items, t in zip(shards.lists, takes):
            idx = (rng.choice(len(items), size=int(t), replace=False)
                   if len(items) else np.array([], dtype=np.int64))
            idx.sort()
            out.append([items[i] for i in idx])
        return HostShards(shards.num_workers, out)


def BernoulliSample(dia: DIA, p: float, seed: int = 0) -> DIA:
    return DIA(BernoulliSampleNode(dia.context, dia._link(), p, seed))


def Sample(dia: DIA, k: int, seed: int = 0) -> DIA:
    return DIA(SampleNode(dia.context, dia._link(), k, seed))
