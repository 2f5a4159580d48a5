"""PageRank: Zip with the degree table, a dense-index join of the edges,
ReduceToIndex by target, iterated (the port's copy of the reference
package's ``examples/page_rank.py``, user functions in torch).

    python -m thrill_tpu_torch.examples.page_rank --pages 1000 --edges 10000

One iteration: Zip the ranks with the out-degree table and divide (each
page's outgoing contribution); gather it to every edge by its source
(``InnerJoin`` with ``dense_right_index``); scatter-add by target
(ReduceToIndex's FieldReduce engine) and dampen. The ranks are f64.
"""

from __future__ import annotations

import numpy as np
import torch

from thrill_tpu_torch.api import (Bind, Context, FieldReduce, InnerJoin,
                                  Iterate, Zip)

DAMPENING = 0.85


# module-level functors, as in the reference (whose compiled programs key
# on function identity)

def _src_one(s):
    return (s, 1)


def _page_first(kv):
    return kv[0]


# the degree count: (page, 1) pairs scatter-added per page
_ADD_PAIRS = FieldReduce(("first", "sum"))


def _fill(x, v):
    return torch.zeros_like(x, dtype=v.dtype) + v[0]


def _edge_src(e):
    return e["s"]


def _scale_rank(r, kv):
    # rank / out-degree, degree clamped so dangling pages divide by 1
    return r / torch.clamp_min(kv[1], 1)


def _join_scaled(e, s):
    return {"d": e["d"], "v": s}


def _contrib_dst(c):
    return c["d"]


# "d" carries the key, "v" accumulates
_SUM_V = FieldReduce({"d": "first", "v": "sum"})


def _dampen(t, base):
    return base[0] + DAMPENING * t["v"]


def page_rank(ctx: Context, edges: np.ndarray, num_pages: int,
              iterations: int = 10):
    """edges: [m, 2] int64 (src, dst). Returns np.ndarray of ranks."""
    src = edges[:, 0].astype(np.int64)
    dst = edges[:, 1].astype(np.int64)

    # out-degree per page (dangling pages keep degree 0)
    deg_dia = ctx.Distribute(src).Map(_src_one).ReduceToIndex(
        _page_first, _ADD_PAIRS, num_pages,
        neutral=(0, 0)).Cache().Keep(iterations + 1)

    edges_dia = ctx.Distribute({"s": src, "d": dst}).Cache() \
        .Keep(iterations + 1)

    inv_n = np.array([1.0 / num_pages])
    base = np.array([(1.0 - DAMPENING) / num_pages])
    ranks = ctx.Generate(num_pages).Map(Bind(_fill, inv_n)).Cache()

    def body(ranks):
        scaled = Zip(ranks, deg_dia, zip_fn=_scale_rank)
        contrib = InnerJoin(edges_dia, scaled, _edge_src, None,
                            _join_scaled, dense_right_index=num_pages)
        sums = contrib.ReduceToIndex(
            _contrib_dst, _SUM_V, num_pages, neutral={"d": 0, "v": 0.0})
        return sums.Map(Bind(_dampen, base))

    ranks = Iterate(ctx, body, ranks, iterations, name="page_rank")

    return np.asarray(ranks.AllGather(), dtype=np.float64)


def page_rank_dense(ctx: Context, edges: np.ndarray, num_pages: int,
                    iterations: int = 10):
    """Reference implementation in numpy for verification."""
    r = np.full(num_pages, 1.0 / num_pages)
    deg = np.bincount(edges[:, 0], minlength=num_pages)
    for _ in range(iterations):
        contrib = np.zeros(num_pages)
        vals = r[edges[:, 0]] / np.maximum(deg[edges[:, 0]], 1)
        np.add.at(contrib, edges[:, 1], vals)
        r = (1 - DAMPENING) / num_pages + DAMPENING * contrib
    return r


def zipf_graph(num_pages: int, num_edges: int, seed: int = 0) -> np.ndarray:
    """Zipf-distributed targets like the reference's generator."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_pages, num_edges)
    ranks = np.arange(1, num_pages + 1, dtype=np.float64)
    p = (1.0 / ranks)
    p /= p.sum()
    dst = rng.choice(num_pages, size=num_edges, p=p)
    return np.stack([src, dst], axis=1).astype(np.int64)


def main():
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--pages", type=int, default=1000)
    parser.add_argument("--edges", type=int, default=10000)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args()

    from thrill_tpu_torch.api import Run

    def job(ctx):
        edges = zipf_graph(args.pages, args.edges)
        r = page_rank(ctx, edges, args.pages, args.iters)
        top = np.argsort(-r)[:10]
        for p in top:
            print(f"page {p}: {r[p]:.6f}")

    Run(job, device=args.device)


if __name__ == "__main__":
    main()
