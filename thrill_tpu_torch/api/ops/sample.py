"""BernoulliSample and Sample(k) (counterpart of the reference package's
``api/ops/sample.py``).

Both draw on the mesh's device from one ``torch.Generator`` a worker,
seeded from (seed, worker) through ``np.random.SeedSequence``. The port
cannot reproduce ``jax.random``'s bits, so it holds the reference's
contract, not its draws: BernoulliSample keeps each item with
probability p, in order; Sample's per-worker takes are the reference's
for the same seed (the same numpy hypergeometric split), and each
worker keeps a uniform subset of that size, in order.

On host storage both draw with numpy as the reference does, so they
keep the reference's items exactly: BernoulliSample one
``np.random.default_rng(seed)`` across the workers in order, Sample the
hypergeometric split and then ``rng.choice`` a worker from the same
generator.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ...common.sampling import hypergeometric_split
from ...core import keys as keymod
from ...core.device_sort import argsort_words
from ...data import multiplexer
from ...data.shards import DeviceShards, HostShards, compact_valid
from ..dia import DIA
from ..dia_base import DIABase

_SAMPLE_STREAM = 0x5A   # Sample's draws are not BernoulliSample's


def worker_uniforms(mex, seed: int, cap: int, stream: int = 0
                    ) -> torch.Tensor:
    """``[W, cap]`` f64 uniforms in [0, 1) on the mesh's device, worker
    ``w``'s from its own generator: the w-th child of
    ``SeedSequence([stream, seed])``."""
    children = np.random.SeedSequence(
        [stream, int(seed) % (1 << 64)]).spawn(mex.num_workers)
    rows: List[torch.Tensor] = []
    for child in children:
        gen = torch.Generator(device=mex.device)
        gen.manual_seed(int(child.generate_state(1, np.uint64)[0]))
        rows.append(torch.rand(cap, dtype=torch.float64, generator=gen,
                               device=mex.device))
    return torch.stack(rows)


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
        keep = shards.valid_mask() & (
            worker_uniforms(mex, self.seed, shards.cap) < self.p)
        tree, counts = compact_valid(shards.tree, keep)
        return DeviceShards(mex, tree, mex.fetch(counts))


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
        cap = shards.cap
        takes = hypergeometric_split(np.random.default_rng(self.seed),
                                     self.k, shards.counts)
        # each worker scores its items, pushes the padding last (2.0) and
        # keeps the t best, in their original order; f64 scores, as the
        # reference's x64 draws, so ties stay rare at millions of rows
        mask = shards.valid_mask()
        scores = torch.where(
            mask, worker_uniforms(mex, self.seed, cap, _SAMPLE_STREAM),
            torch.full((), 2.0, dtype=torch.float64, device=mex.device))
        order = argsort_words(keymod.encode_key_words(scores),
                              passes=mex.radix_passes)
        ranked = (torch.arange(cap, device=mex.device)[None, :]
                  < mex.put_small(takes)[:, None])
        keep = torch.zeros_like(mask).scatter_(1, order, ranked)
        tree, counts = compact_valid(shards.tree, keep & mask)
        return DeviceShards(mex, tree, mex.fetch(counts))

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
