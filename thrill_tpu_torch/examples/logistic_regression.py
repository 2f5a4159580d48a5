"""Distributed logistic regression by batch gradient descent (the port's
copy of the reference package's ``examples/logistic_regression.py``).

    python -m thrill_tpu_torch.examples.logistic_regression --device cpu

Each round's gradient is a batched matmul over the device columns,
summed by the Sum action; the model vector stays on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from thrill_tpu_torch.api import Bind, Context


def _lr_grad(t, w):
    # module-level + Bind: the model vector is an operand
    z = t["x"] @ w
    p = 1.0 / (1.0 + torch.exp(-z))
    return (p - t["y"])[:, None] * t["x"]


def logistic_regression(ctx: Context, X: np.ndarray, y: np.ndarray,
                        iterations: int = 50, lr: float = 0.5):
    n, dim = X.shape
    data = ctx.Distribute({"x": X.astype(np.float64),
                           "y": y.astype(np.float64)}).Cache() \
        .Keep(iterations + 1)
    # Sum returns a device vector and w re-enters through Bind: no host
    # sync per iteration
    w = torch.zeros(dim, dtype=torch.float64, device=ctx.mesh_exec.device)
    for _ in range(iterations):
        gsum = data.Map(Bind(_lr_grad, w)).Sum(device=True)
        w = w - lr * gsum / n
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
        n, dim = 5000, 5
        true_w = rng.normal(size=dim)
        X = rng.normal(size=(n, dim))
        y = (X @ true_w + 0.1 * rng.normal(size=n) > 0).astype(np.float64)
        w = logistic_regression(ctx, X, y)
        acc = np.mean((X @ w > 0) == (y > 0.5))
        print(f"train acc {acc:.3f}, w = {np.round(w, 3)}")

    Run(job, device=args.device)


if __name__ == "__main__":
    main()
