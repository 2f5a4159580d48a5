"""Breadth-first search over an edge-list graph (the port's copy of the
reference package's ``examples/bfs.py``).

    python -m thrill_tpu_torch.examples.bfs --device cpu

Level-synchronous: the frontier joins the edge list to produce the next
level's candidates, the host keeps the unvisited ones, iterate.
"""

from __future__ import annotations

import numpy as np

from thrill_tpu_torch.api import Context, InnerJoin


def bfs_levels(ctx: Context, edges: np.ndarray, num_nodes: int,
               source: int = 0, max_iters: int = 0) -> np.ndarray:
    """edges: [m, 2] directed int64. Returns level per node (-1 =
    unreachable)."""
    levels = np.full(num_nodes, -1, dtype=np.int64)
    levels[source] = 0
    frontier = np.array([source], dtype=np.int64)
    max_iters = max_iters or num_nodes

    edges_dia = ctx.Distribute({"s": edges[:, 0].astype(np.int64),
                                "d": edges[:, 1].astype(np.int64)}) \
        .Cache().Keep(max_iters + 1)

    level = 0
    while len(frontier) and level < max_iters:
        f = ctx.Distribute({"n": frontier})
        nxt = InnerJoin(edges_dia, f,
                        lambda e: e["s"], lambda t: t["n"],
                        lambda e, t: {"d": e["d"]})
        cand = np.unique(np.asarray(
            [int(t["d"]) for t in nxt.AllGather()], dtype=np.int64))
        new = cand[levels[cand] < 0] if len(cand) else cand
        level += 1
        levels[new] = level
        frontier = new
    return levels


def bfs_dense(edges: np.ndarray, num_nodes: int, source: int = 0):
    from collections import deque
    adj = [[] for _ in range(num_nodes)]
    for s, d in edges:
        adj[s].append(d)
    lv = np.full(num_nodes, -1, dtype=np.int64)
    lv[source] = 0
    q = deque([source])
    while q:
        u = q.popleft()
        for v in adj[u]:
            if lv[v] < 0:
                lv[v] = lv[u] + 1
                q.append(v)
    return lv


def main():
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--nodes", type=int, default=1000)
    parser.add_argument("--edges", type=int, default=5000)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args()

    from thrill_tpu_torch.api import Run

    def job(ctx):
        rng = np.random.default_rng(0)
        edges = rng.integers(0, args.nodes, (args.edges, 2)).astype(np.int64)
        lv = bfs_levels(ctx, edges, args.nodes)
        reach = int((lv >= 0).sum())
        print(f"reachable {reach}/{args.nodes}, max level {lv.max()}")

    Run(job, device=args.device)


if __name__ == "__main__":
    main()
