"""Fused-vs-unfused dispatch report over the example pipelines
(counterpart of the reference package's ``tools/fusion_report.py``).

Runs WordCount (text -> packed words -> Map -> ReduceByKey) and PageRank
(the iterative join/reduce pipeline) twice each, program stitching on
(the default) and ``THRILL_TPU_FUSE=0``, and prints the device dispatch
counts and their difference, then the fused stage compositions. Each
dispatch costs the host a program call and its launches, so the
difference is host work the stitching saves a run.

Usage::

    python -m thrill_tpu_torch.tools.fusion_report [--pages N]
        [--edges M] [--iters K] [--words N] [--workers W] [--device D]

``--device`` defaults to ``cuda`` (``cpu`` runs it without a card).
Both modes' results are compared exactly before any number is printed.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def _run_wordcount(ctx, path):
    import numpy as np

    from ..examples import word_count as wc
    out = wc.word_count_text_device(ctx, path).AllGatherArrays()
    cols = {k: v.detach().cpu().numpy() for k, v in out.items()}
    order = np.lexsort(tuple(cols["w"].T))
    return {k: v[order] for k, v in sorted(cols.items())}


def _measure(name, job, mex):
    """Run ``job()`` in both modes (one warm run each, so building the
    programs does not count) and return the row."""
    import numpy as np
    counts = {}
    results = {}
    prev = os.environ.get("THRILL_TPU_FUSE")
    try:
        for fuse in ("1", "0"):
            os.environ["THRILL_TPU_FUSE"] = fuse
            job()
            d0 = mex.stats_dispatches
            results[fuse] = job()
            counts[fuse] = mex.stats_dispatches - d0
    finally:
        if prev is None:
            os.environ.pop("THRILL_TPU_FUSE", None)
        else:
            os.environ["THRILL_TPU_FUSE"] = prev
    assert np.allclose(np.asarray(results["1"], dtype=np.float64),
                       np.asarray(results["0"], dtype=np.float64)), \
        f"{name}: fused and unfused results diverge"
    return (name, counts["0"], counts["1"],
            counts["0"] - counts["1"],
            counts["0"] / max(counts["1"], 1))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pages", type=int, default=256)
    ap.add_argument("--edges", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--words", type=int, default=4096)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np

    from ..api.context import Context
    from ..examples import page_rank as pr

    ctx = Context(num_workers=args.workers, device=args.device)
    mex = ctx.mesh_exec

    rng = np.random.default_rng(0)
    vocab = ["w%03d" % i for i in range(97)]
    text = " ".join(rng.choice(vocab, size=args.words))
    edges = pr.zipf_graph(args.pages, args.edges)

    rows = []
    with tempfile.NamedTemporaryFile("w", suffix=".txt",
                                     delete=False) as f:
        f.write(text + "\n")
        path = f.name
    try:
        def wc_leaves():
            cols = _run_wordcount(ctx, path)
            return np.concatenate([np.asarray(v, np.float64).reshape(-1)
                                   for v in cols.values()])

        rows.append(_measure("WordCount", wc_leaves, mex))
        rows.append(_measure(
            "PageRank",
            lambda: pr.page_rank(ctx, edges, args.pages,
                                 iterations=args.iters), mex))
    finally:
        os.unlink(path)

    print(f"{'pipeline':<12} {'unfused':>8} {'fused':>8} "
          f"{'delta':>8} {'ratio':>7}")
    for name, unf, fus, delta, ratio in rows:
        print(f"{name:<12} {unf:>8} {fus:>8} {delta:>8} {ratio:>6.2f}x")
    stats = ctx.overall_stats()
    stages = stats.get("fused_stages") or {}
    if stages:
        print("\nfused stage compositions (this process):")
        for ops, n in sorted(stages.items(), key=lambda kv: -kv[1]):
            print(f"  {n:>5}x  {ops}")
    ctx.close()


if __name__ == "__main__":
    main()
