"""Triangle counting via a double InnerJoin (the port's copy of the
reference package's ``examples/triangles.py``).

    python -m thrill_tpu_torch.examples.triangles --device cpu

Edges join themselves to form wedges; wedges join the edges to close
triangles.
"""

from __future__ import annotations

import numpy as np

from thrill_tpu_torch.api import Context, InnerJoin


def count_triangles(ctx: Context, edges: np.ndarray) -> int:
    """edges: [m, 2] int64 with src < dst (oriented, deduplicated)."""
    e = {"s": edges[:, 0].astype(np.int64),
         "d": edges[:, 1].astype(np.int64)}
    edges_dia = ctx.Distribute(e).Cache().Keep(2)

    # wedges: (a<b) join (b<c) on b -> (a, b, c)
    wedges = InnerJoin(edges_dia, edges_dia,
                       lambda x: x["d"], lambda y: y["s"],
                       lambda x, y: {"a": x["s"], "b": x["d"],
                                     "c": y["d"]})
    # close the wedge: need edge (a, c)
    closed = InnerJoin(wedges, edges_dia,
                       lambda w: w["a"] * (1 << 32) + w["c"],
                       lambda x: x["s"] * (1 << 32) + x["d"],
                       lambda w, x: {"a": w["a"]})
    return closed.Size()


def count_triangles_dense(edges: np.ndarray) -> int:
    s = set(map(tuple, edges.tolist()))
    cnt = 0
    for a, b in edges:
        for b2, c in edges:
            if b2 == b and (a, c) in s:
                cnt += 1
    return cnt


def main():
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--nodes", type=int, default=100)
    parser.add_argument("--edges", type=int, default=500)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args()

    from thrill_tpu_torch.api import Run

    def job(ctx):
        rng = np.random.default_rng(0)
        raw = rng.integers(0, args.nodes, (args.edges, 2))
        raw = raw[raw[:, 0] != raw[:, 1]]
        raw = np.unique(np.sort(raw, axis=1), axis=0)
        print("triangles:", count_triangles(ctx, raw))

    Run(job, device=args.device)


if __name__ == "__main__":
    main()
