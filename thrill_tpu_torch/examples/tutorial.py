"""Tutorial: a guided tour of thrill_tpu_torch's DIA pipelines (the
port's copy of the reference package's ``examples/tutorial.py``).

    python -m thrill_tpu_torch.examples.tutorial --device cpu
"""

from __future__ import annotations

import numpy as np

from thrill_tpu_torch.api import Run, Zip


def job(ctx):
    # 1. Sources: Generate produces 0..n-1; Distribute ships your data.
    nums = ctx.Generate(1000)

    # 2. Local ops chain lazily and run as batched torch ops.
    evens = nums.Map(lambda x: x * 3).Filter(lambda x: x % 2 == 0)

    # 3. Actions trigger execution. Keep() lets a DIA be reused.
    evens.Keep()
    print("count:", evens.Keep().Size())
    print("sum:  ", int(evens.Sum()))

    # 4. Distributed ops: ReducePair aggregates (key, value) pairs
    #    through a hash exchange between the workers.
    hist = (ctx.Generate(10_000)
               .Map(lambda x: (x % 7, 1))
               .ReducePair(lambda a, b: a + b))
    print("histogram:", sorted((int(k), int(v))
                               for k, v in hist.AllGather()))

    # 5. Sort is a distributed sample sort; equal keys keep their
    #    original order (always stable).
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 100, 5000).astype(np.int64)
    srt = ctx.Distribute(vals).Sort()
    head = [int(x) for x in srt.AllGather()][:5]
    print("sorted head:", head)

    # 6. Zip aligns two DIAs element-wise (with realignment exchange).
    a = ctx.Generate(100)
    b = ctx.Generate(100, fn=lambda i: i * i)
    z = Zip(a, b, zip_fn=lambda x, y: y - x)
    print("zip tail:", [int(v) for v in z.AllGather()][-3:])

    # 7. overall_stats summarizes traffic and memory.
    print("stats:", ctx.overall_stats())


def main():
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args()
    Run(job, device=args.device)


if __name__ == "__main__":
    main()
