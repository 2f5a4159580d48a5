"""Loop-replay report over the iterative example pipelines (counterpart
of the reference package's ``tools/loop_report.py``).

Runs PageRank and k-means with the loop layer on (the default) and with
``THRILL_TPU_LOOP_REPLAY=0``, checks that the results are equal, and
prints per loop the replay hit rate, plan builds, whole-loop iterations,
released loop bytes, and the host seconds of the capture iteration
against the replayed ones.

Usage::

    python -m thrill_tpu_torch.tools.loop_report [--pages N] [--edges M]
        [--iters K] [--points N] [--clusters K] [--workers W]
        [--device D]

``--device`` defaults to ``cuda`` (``cpu`` runs it without a card).
"""

from __future__ import annotations

import argparse
import os
import time


def _measure(name, job, mex):
    """``job()`` with replay on and off (one warm run each); returns the
    row and the loop report of the replayed run."""
    import numpy as np
    results, wall = {}, {}
    report = None
    prev = os.environ.get("THRILL_TPU_LOOP_REPLAY")
    try:
        for replay in ("1", "0"):
            os.environ["THRILL_TPU_LOOP_REPLAY"] = replay
            job()
            n0 = len(mex.loop_reports)
            t0 = time.perf_counter()
            results[replay] = np.asarray(job(), dtype=np.float64)
            wall[replay] = time.perf_counter() - t0
            if replay == "1":
                reps = [r for r in mex.loop_reports[n0:]
                        if r["name"] == name]
                report = reps[-1] if reps else None
    finally:
        if prev is None:
            os.environ.pop("THRILL_TPU_LOOP_REPLAY", None)
        else:
            os.environ["THRILL_TPU_LOOP_REPLAY"] = prev
    assert np.array_equal(results["1"], results["0"]), \
        f"{name}: replayed and per-iteration results diverge"
    return (name, report, wall["1"], wall["0"])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pages", type=int, default=1024)
    ap.add_argument("--edges", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--clusters", type=int, default=16)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np

    from ..api.context import Context
    from ..examples import k_means as km
    from ..examples import page_rank as pr

    ctx = Context(num_workers=args.workers, device=args.device)
    mex = ctx.mesh_exec

    edges = pr.zipf_graph(args.pages, args.edges)
    rng = np.random.default_rng(7)
    points = rng.normal(size=(args.points, 8))

    rows = [
        _measure("page_rank",
                 lambda: pr.page_rank(ctx, edges, args.pages,
                                      iterations=args.iters), mex),
        _measure("k_means",
                 lambda: km.k_means(ctx, points, args.clusters,
                                    iterations=args.iters), mex),
    ]
    print(f"{'loop':<10} {'iters':>5} {'hit':>5} {'plans':>5} "
          f"{'fori':>5} {'donatedB':>9} {'capture_s':>10} "
          f"{'replay_s':>9} {'wall':>7} {'noreplay':>9}")
    for name, r, w1, w0 in rows:
        if r is None:
            print(f"{name:<10} (no LoopPlan captured — see "
                  f"event=loop_capture_miss)")
            continue
        hit = (r["replays"] + r["fori_iters"]) / max(r["iters"], 1)
        print(f"{name:<10} {r['iters']:>5} {hit:>5.0%} "
              f"{r['captures']:>5} {r['fori_iters']:>5} "
              f"{r['donated_bytes']:>9} {r['capture_s']:>10.4f} "
              f"{r['replay_s']:>9.4f} {w1:>7.3f} {w0:>9.3f}")
    stats = ctx.overall_stats()
    print(f"\nprocess totals: {stats['loop_plan_builds']} plan builds, "
          f"{stats['loop_replays']} replays + "
          f"{stats['loop_fori_iters']} fori iters, "
          f"{stats['loop_replay_fallbacks']} fallbacks, "
          f"{stats['loop_donated_bytes']} B donated")
    ctx.close()


if __name__ == "__main__":
    main()
