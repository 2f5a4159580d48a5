"""TPC-H-style join query over generated order/lineitem tables (the
port's copy of the reference package's ``examples/tpch.py``).

    python -m thrill_tpu_torch.examples.tpch

Query (Q3-lite): revenue per order priority for orders in a date range:
  SELECT o.priority, SUM(l.extendedprice * (1 - l.discount))
  FROM orders o JOIN lineitem l ON o.key = l.orderkey
  WHERE o.date < CUTOFF GROUP BY o.priority
"""

from __future__ import annotations

import numpy as np

from thrill_tpu_torch.api import Context, InnerJoin

NUM_PRIORITIES = 5


def generate_tables(num_orders: int, lines_per_order: int = 4,
                    seed: int = 0):
    rng = np.random.default_rng(seed)
    orders = {
        "key": np.arange(num_orders, dtype=np.int64),
        "date": rng.integers(0, 2500, num_orders).astype(np.int64),
        "prio": rng.integers(0, NUM_PRIORITIES, num_orders).astype(np.int64),
    }
    m = num_orders * lines_per_order
    lineitem = {
        "orderkey": rng.integers(0, num_orders, m).astype(np.int64),
        "price": rng.integers(1, 1000, m).astype(np.int64),
        "discount_pct": rng.integers(0, 10, m).astype(np.int64),
    }
    return orders, lineitem


def q3_lite(ctx: Context, orders, lineitem, cutoff: int = 1250,
            location_detection=None):
    """``location_detection`` as InnerJoin takes it: None leaves it to
    the cost model."""
    o = ctx.Distribute(orders).Filter(lambda t: t["date"] < cutoff)
    l = ctx.Distribute(lineitem)
    joined = InnerJoin(
        o, l, lambda t: t["key"], lambda t: t["orderkey"],
        lambda ot, lt: {"prio": ot["prio"],
                        "rev": lt["price"] * (100 - lt["discount_pct"])},
        location_detection=location_detection)
    per_prio = joined.ReduceToIndex(
        lambda t: t["prio"], lambda a, b: {"prio": a["prio"],
                                           "rev": a["rev"] + b["rev"]},
        NUM_PRIORITIES, neutral={"prio": 0, "rev": 0})
    return np.array([int(t["rev"]) for t in per_prio.AllGather()])


def q3_dense(orders, lineitem, cutoff: int = 1250):
    sel = orders["date"] < cutoff
    okey = set(orders["key"][sel].tolist())
    prio = {int(k): int(p) for k, p in zip(orders["key"], orders["prio"])}
    out = np.zeros(NUM_PRIORITIES, dtype=np.int64)
    for k, pr, dc in zip(lineitem["orderkey"], lineitem["price"],
                         lineitem["discount_pct"]):
        if int(k) in okey:
            out[prio[int(k)]] += int(pr) * (100 - int(dc))
    return out


def main():
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args()

    from thrill_tpu_torch.api import Run

    def job(ctx):
        orders, lineitem = generate_tables(10000)
        rev = q3_lite(ctx, orders, lineitem)
        for p, r in enumerate(rev):
            print(f"priority {p}: revenue {r}")

    Run(job, device=args.device)


if __name__ == "__main__":
    main()
