"""Distributed selection (k-th smallest) by iterative sampling (the
port's copy of the reference package's ``examples/select_kth.py``).

    python -m thrill_tpu_torch.examples.select_kth --device cpu

Sample + Filter + Size rounds until the candidate set fits in one
gather.
"""

from __future__ import annotations

import numpy as np

from thrill_tpu_torch.api import Context


def select_kth(ctx: Context, values: np.ndarray, k: int,
               gather_limit: int = 4096) -> int:
    """k-th smallest (0-based) of values."""
    assert 0 <= k < len(values)
    dia = ctx.Distribute(np.asarray(values, dtype=np.int64)).Cache()
    lo_rank = 0
    while True:
        n = dia.Keep().Size()
        if n <= gather_limit:
            items = sorted(int(x) for x in dia.AllGather())
            return items[k - lo_rank]
        sample = sorted(int(x) for x in
                        dia.Keep().Sample(64, seed=n).AllGather())
        target = (k - lo_rank) / n
        pivot_idx = min(len(sample) - 1, max(0, int(target * len(sample))))
        lo_p = sample[max(0, pivot_idx - 1)]
        hi_p = sample[min(len(sample) - 1, pivot_idx + 1)]
        below = dia.Keep().Filter(lambda x: x < lo_p).Size()
        inside = dia.Keep().Filter(
            lambda x: (x >= lo_p) & (x <= hi_p)).Size()
        if below <= k - lo_rank < below + inside:
            dia = dia.Filter(lambda x: (x >= lo_p) & (x <= hi_p)).Cache()
            lo_rank += below
        elif k - lo_rank < below:
            dia = dia.Filter(lambda x: x < lo_p).Cache()
        else:
            dia = dia.Filter(lambda x: x > hi_p).Cache()
            lo_rank += below + inside


def main():
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", type=int, default=100000)
    parser.add_argument("--k", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args()
    k = args.k if args.k is not None else args.size // 2

    from thrill_tpu_torch.api import Run

    def job(ctx):
        rng = np.random.default_rng(0)
        vals = rng.integers(0, 1 << 40, args.size)
        got = select_kth(ctx, vals, k)
        print(f"k={k}: {got} (expected {int(np.partition(vals, k)[k])})")

    Run(job, device=args.device)


if __name__ == "__main__":
    main()
