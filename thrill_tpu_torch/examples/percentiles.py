"""Percentiles of a distributed dataset via Sort + ZipWithIndex (the
port's copy of the reference package's ``examples/percentiles.py``).

    python -m thrill_tpu_torch.examples.percentiles --device cpu
"""

from __future__ import annotations

import numpy as np
import torch

from thrill_tpu_torch.api import Context


def percentiles(ctx: Context, values: np.ndarray, qs=(50, 90, 95, 99)):
    n = len(values)
    wanted = {int(np.clip(int(q / 100.0 * n), 0, n - 1)): q for q in qs}
    tgt = torch.as_tensor(np.array(sorted(wanted), dtype=np.int64),
                          device=ctx.mesh_exec.device)

    s = ctx.Distribute(np.asarray(values, dtype=np.int64)).Sort()
    ranked = s.ZipWithIndex(lambda v, i: (i, v))
    picked = ranked.Filter(lambda t: torch.isin(t[0], tgt))
    out = {}
    for i, v in picked.AllGather():
        out[wanted[int(i)]] = int(v)
    return out


def main():
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args()

    from thrill_tpu_torch.api import Run

    def job(ctx):
        rng = np.random.default_rng(0)
        vals = rng.integers(0, 10 ** 9, 100000)
        print(percentiles(ctx, vals))

    Run(job, device=args.device)


if __name__ == "__main__":
    main()
