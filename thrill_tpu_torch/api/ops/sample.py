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
generator. Across processes a process draws for its own workers only
(``fold_in(PRNGKey(seed), w)`` of their global ids on the device; on
the host the generator is advanced by the other workers' counts), so
every process keeps its share of the one-process items.
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
from ...parallel.mesh import current_mex
from ..dia import DIA
from ..dia_base import DIABase

_SAMPLE_SALT = 0x5A   # Sample's seed is the reference's seed ^ 0x5A


def uniforms(seed: int, W: int, cap: int, device,
             base: int = 0) -> torch.Tensor:
    """``[W, cap]`` f64 uniforms in [0, 1) on ``device``: row ``w`` is
    ``jax.random.uniform(fold_in(PRNGKey(seed), base + w), (cap,))``,
    bit for bit (``base`` the first local worker's global id)."""
    keys = threefry.fold_in(threefry.prng_key(seed),
                            torch.arange(base, base + W, device=device))
    return threefry.uniform(keys, (cap,))


def worker_uniforms(mex, seed: int, cap: int) -> torch.Tensor:
    """:func:`uniforms` of the mesh's local workers on its device."""
    return uniforms(seed, mex.num_local, cap, mex.device, mex.worker_base)


def _base() -> int:
    """The global id of the running program's first local worker."""
    mex = current_mex()
    return mex.worker_base if mex is not None else 0


def _valid(tree, counts: torch.Tensor) -> torch.Tensor:
    cap = pt.leaves(tree)[0].shape[1]
    return torch.arange(cap, device=counts.device)[None, :] < counts[:, None]


def _bernoulli_prog(tree, counts: torch.Tensor, p: float, seed: int):
    """Program: keep each valid item whose uniform is below ``p``,
    compacted; (tree, ``[W]`` counts)."""
    mask = _valid(tree, counts)
    W, cap = mask.shape
    return compact_valid(tree, mask & (uniforms(seed, W, cap, mask.device,
                                                _base()) < p))


class BernoulliSampleNode(DIABase):
    def __init__(self, ctx, link, p: float, seed: int) -> None:
        super().__init__(ctx, f"BernoulliSample({p})", [link])
        self.p = float(p)
        self.seed = seed

    def compute(self):
        shards = self.parents[0].pull()
        if isinstance(shards, HostShards):
            rng = np.random.default_rng(self.seed)
            # one generator across the workers in order: another
            # process's worker advances it by its count
            counts = multiplexer.global_counts(self.context.mesh_exec,
                                               shards)
            local = multiplexer.local_worker_set(self.context.mesh_exec)
            out = []
            for w, items in enumerate(shards.lists):
                if w in local:
                    out.append([it for it in items if rng.random() < self.p])
                else:
                    rng.random(int(counts[w]))
                    out.append([])
            return HostShards(shards.num_workers, out)
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
    scores = torch.where(mask, uniforms(seed ^ _SAMPLE_SALT, W, cap, dev,
                                        _base()),
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
        takes = mex.local(hypergeometric_split(
            np.random.default_rng(self.seed), self.k, shards.global_counts))
        prog = mex.program(("sample_k", self.seed), _sample_prog)
        tree, counts = prog(shards.tree, shards.counts_device(),
                            mex.put_small(takes.astype(np.int64)),
                            self.seed, mex.radix_passes)
        return DeviceShards(mex, tree, counts)

    def _compute_host(self, shards: HostShards) -> HostShards:
        """Reference: ``thrill_tpu/api/ops/sample.py:70-87``."""
        rng = np.random.default_rng(self.seed)
        counts = multiplexer.global_counts(self.context.mesh_exec, shards)
        takes = hypergeometric_split(rng, self.k, counts)
        local = multiplexer.local_worker_set(self.context.mesh_exec)
        out = []
        for w, (items, t) in enumerate(zip(shards.lists, takes)):
            # another process's worker draws too, from its count: the
            # generator stays in step with one process's
            n = int(counts[w])
            idx = (rng.choice(n, size=int(t), replace=False)
                   if n else np.array([], dtype=np.int64))
            idx.sort()
            out.append([items[i] for i in idx] if w in local else [])
        return HostShards(shards.num_workers, out)


def BernoulliSample(dia: DIA, p: float, seed: int = 0) -> DIA:
    return DIA(BernoulliSampleNode(dia.context, dia._link(), p, seed))


def Sample(dia: DIA, k: int, seed: int = 0) -> DIA:
    return DIA(SampleNode(dia.context, dia._link(), k, seed))
