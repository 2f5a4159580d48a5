"""k-means clustering: classify, ReduceToIndex by cluster, iterate (the
port's copy of the reference package's ``examples/k_means.py``, user
functions in torch).

    python -m thrill_tpu_torch.examples.k_means --points 10000 --device cpu

Points are a device ``[n, dim]`` column; classification is a batched
distance matmul, the per-cluster sums are ReduceToIndex's FieldReduce
scatters, and the centers travel to the next iteration as a small
tensor on the device (the reference's AllReduce/broadcast step).
"""

from __future__ import annotations

import numpy as np
import torch

from thrill_tpu_torch.api import Bind, Context, FieldReduce, Iterate


# module-level functors, as in the reference (the moving centers enter
# through Bind as an operand)

def _label(x, c):                       # x: [n_local, dim] batched
    d2 = ((x * x).sum(dim=1, keepdim=True)
          - 2.0 * x @ c.T
          + (c * c).sum(dim=1)[None, :])
    return {"i": torch.argmin(d2, dim=1).to(torch.int64), "x": x,
            "cnt": x[:, 0] * 0 + 1.0}


def _cluster_i(t):
    return t["i"]


# "i" carries the key, "x" and "cnt" accumulate: ReduceToIndex's
# sort-free scatter engine
_CLUSTER_SUM = FieldReduce({"i": "first", "x": "sum", "cnt": "sum"})


def _center_update(sum_x, cnt, centers):
    return torch.where((cnt > 0)[:, None],
                       sum_x / torch.clamp_min(cnt, 1.0)[:, None],
                       centers)


def k_means(ctx: Context, points: np.ndarray, k: int, iterations: int = 10,
            seed: int = 0) -> np.ndarray:
    """points: [n, dim] float64. Returns the centers [k, dim]."""
    n, dim = points.shape
    rng = np.random.default_rng(seed)
    centers = points[rng.choice(n, size=k, replace=False)].copy()

    pts = ctx.Distribute(points.astype(np.float64)).Cache() \
        .Keep(2 * iterations + 1)

    # AllGatherArrays returns the per-cluster sums on the device and the
    # update stays there: no host sync per iteration
    update = ctx.mesh_exec.jit_cached(("kmeans_center_update",),
                                      _center_update)

    def body(centers):
        labeled = pts.Map(Bind(_label, centers))
        sums = labeled.ReduceToIndex(
            _cluster_i, _CLUSTER_SUM,
            k, neutral={"i": 0, "x": np.zeros(dim), "cnt": 0.0})
        cols = sums.AllGatherArrays()
        return update(cols["x"], cols["cnt"], centers)

    centers = Iterate(ctx, body, torch.as_tensor(centers), iterations,
                      name="k_means")
    return centers.cpu().numpy()


def k_means_dense(points: np.ndarray, centers0: np.ndarray,
                  iterations: int) -> np.ndarray:
    centers = centers0.copy()
    for _ in range(iterations):
        d2 = ((points[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        lab = d2.argmin(1)
        for j in range(len(centers)):
            sel = points[lab == j]
            if len(sel):
                centers[j] = sel.mean(0)
    return centers


def main():
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--points", type=int, default=10000)
    parser.add_argument("--dim", type=int, default=8)
    parser.add_argument("--clusters", type=int, default=10)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args()

    from thrill_tpu_torch.api import Run

    def job(ctx):
        rng = np.random.default_rng(1)
        pts = rng.normal(size=(args.points, args.dim))
        centers = k_means(ctx, pts, args.clusters, args.iters)
        print(centers)

    Run(job, device=args.device)


if __name__ == "__main__":
    main()
