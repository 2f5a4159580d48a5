"""Mini-batch SGD linear regression over a distributed dataset (the
port's copy of the reference package's ``examples/sgd.py``).

    python -m thrill_tpu_torch.examples.sgd --device cpu

Each iteration's gradient is taken on a Bernoulli-sampled mini batch,
summed on the device and applied to the model there.
"""

from __future__ import annotations

import numpy as np
import torch

from thrill_tpu_torch.api import Bind, Context


def _sgd_grad(tr, w):
    # module-level + Bind (see logistic_regression._lr_grad)
    err = tr["x"] @ w - tr["y"]
    return err[:, None] * tr["x"]


def sgd_linear(ctx: Context, X: np.ndarray, y: np.ndarray,
               iterations: int = 40, lr: float = 0.1,
               batch_fraction: float = 0.25, seed: int = 0):
    n, dim = X.shape
    data = ctx.Distribute({"x": X.astype(np.float64),
                           "y": y.astype(np.float64)}).Cache() \
        .Keep(iterations + 1)
    # Sum returns a device vector, the update is device math
    w = torch.zeros(dim, dtype=torch.float64, device=ctx.mesh_exec.device)
    m = max(int(n * batch_fraction), 1)
    for t in range(iterations):
        batch = data.BernoulliSample(batch_fraction, seed=seed + t)
        gsum = batch.Map(Bind(_sgd_grad, w)).Sum(device=True)
        w = w - lr * gsum / m
    return w.cpu().numpy()


def main():
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args()

    from thrill_tpu_torch.api import Run

    def job(ctx):
        rng = np.random.default_rng(0)
        n, dim = 20000, 6
        true_w = rng.normal(size=dim)
        X = rng.normal(size=(n, dim))
        y = X @ true_w + 0.01 * rng.normal(size=n)
        w = sgd_linear(ctx, X, y)
        print("err:", float(np.linalg.norm(w - true_w)))

    Run(job, device=args.device)


if __name__ == "__main__":
    main()
