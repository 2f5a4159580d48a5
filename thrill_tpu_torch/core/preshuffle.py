"""Plan-time pre-shuffle reduction decisions (counterpart of the
reference package's ``core/preshuffle.py``, single controller):
DuplicateDetection for ReduceByKey and LocationDetection for InnerJoin.

Duplicate detection keeps the rows of globally unique keys on their
worker instead of shipping them; location detection drops the rows of a
join whose key hash has no presence on the other side. Either is
switched on when the rows it is expected to prune outweigh the presence
registers it costs (one side for the reduce, two for the join):

    est_pruned_row_bytes  >  margin * est_fingerprint_bytes

with the pruned bytes estimated as rows x item bytes x the prune
fraction x the off-diagonal share (W-1)/W, and the registers as one
byte each. The row estimate prefers host-known counts, then the learned
capacities of the site's exchanges (data/exchange.py), then the padded
capacity. The prune fraction starts at a neutral prior and is learned
per site from observed counts where both are already on the host
(``record_prune``; no sync is added to learn it).

Verdicts stick per (mesh, site) and are re-evaluated every
``_DECIDE_RESYNC_EVERY``-th use; with the planner attached
(api/planner.py) the verdict is the planner's (the same inequality) and
an audited prune fraction far from its prediction re-evaluates at the
next use. ``THRILL_TPU_LOCATION_DETECT=0/1`` and
``THRILL_TPU_DUP_DETECT=0/1`` force either way (unset or ``auto``: the
cost model). Across processes the host paths' row counts are summed over
the processes first and every verdict is process 0's
(``MeshExec.agree``), so all processes run the same collectives.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from ..common import tree as pt
from ..common.config import round_up_pow2

# register-width clamps: below the floor the register pass costs a
# launch anyway; above the ceiling false positives are already rare
_REG_MIN = 1 << 12
_REG_MAX = 1 << 17

# expected prune fraction before a site has taught anything
_DEFAULT_PRUNE_FRAC = 0.5

# enable only when the pruned bytes clear the register cost by this
_MARGIN = 2.0

# every Nth use of a site's verdict re-runs the cost model, so a learned
# prune fraction gets its vote
_DECIDE_RESYNC_EVERY = 16


def _env_mode(name: str) -> Optional[bool]:
    v = os.environ.get(name)
    if v in (None, "", "auto"):
        return None
    return v not in ("0", "off", "false")


def _planner_of(mex):
    pl = getattr(mex, "planner", None)
    if pl is not None and pl.enabled:
        return pl
    return None


def location_mode() -> Optional[bool]:
    """THRILL_TPU_LOCATION_DETECT: 1 forces the join's location filter
    on, 0 off, unset or ``auto`` leaves it to the cost model."""
    return _env_mode("THRILL_TPU_LOCATION_DETECT")


def dup_mode() -> Optional[bool]:
    """THRILL_TPU_DUP_DETECT: 1 forces ReduceByKey's duplicate detection
    on, 0 off, unset or ``auto`` leaves it to the cost model."""
    return _env_mode("THRILL_TPU_DUP_DETECT")


def register_width(est_rows: int) -> int:
    """Presence-register count adapted to the global row estimate."""
    return max(_REG_MIN, min(_REG_MAX,
                             round_up_pow2(8 * max(int(est_rows), 1))))


def _prune_site(token) -> str:
    from ..data.exchange import _ident_digest
    return "prune:" + _ident_digest(token)[:10]


def record_prune(mex, token, pre_rows: int, post_rows: int) -> None:
    """Teach the site its observed prune fraction (where both counts are
    on the host already); also the prune decision's audit join."""
    if pre_rows <= 0:
        return
    hist = getattr(mex, "_prune_history", None)
    if hist is None:
        hist = mex._prune_history = {}
    frac = max(0.0, min(1.0, 1.0 - post_rows / pre_rows))
    from ..common import decisions as _decisions
    led = _decisions.ledger_of(mex)
    if led is not None:
        led.resolve_site("prune", _prune_site(token), max(frac, 1e-6))
    prev = hist.get(token)
    hist[token] = frac if prev is None else 0.5 * (prev + frac)


def prune_fraction(mex, token) -> float:
    """The site's learned prune fraction (a plan store may seed it), or
    the neutral prior."""
    hist = getattr(mex, "_prune_history", None)
    if hist is None:
        hist = mex._prune_history = {}
    frac = hist.get(token)
    if frac is None:
        from ..data.exchange import plan_seed
        v = plan_seed(mex, "prune_history", token)
        if v is not None:
            try:
                frac = hist[token] = max(0.0, min(1.0, float(v)))
            except (TypeError, ValueError):
                frac = None
    return _DEFAULT_PRUNE_FRAC if frac is None else frac


def learned_site_rows(mex, xchg_ident) -> Optional[int]:
    """The largest learned output capacity of the exchange site
    ``xchg_ident`` (data/exchange.py's sticky capacities)."""
    caps = getattr(mex, "_sticky_caps", None)
    if not caps:
        return None
    best = None
    for key, v in caps.items():
        if (isinstance(key, tuple) and len(key) >= 2
                and key[0] == "xchg_caps" and key[1] == xchg_ident
                and len(v) == 2):
            best = max(best or 0, int(v[1]))
    return best


def _decay_fraction(mex, token) -> None:
    """Pull a site's learned fraction halfway back to the prior: a site
    whose filter is off observes nothing, and must probe again."""
    hist = getattr(mex, "_prune_history", None)
    if hist and token in hist:
        hist[token] = 0.5 * (hist[token] + _DEFAULT_PRUNE_FRAC)


def _sticky_decision(mex, kind: str, token, compute) -> bool:
    """The verdict of site (``kind``, ``token``): a plan-store seed, or
    ``compute()``; then kept, re-evaluated on a replan mark or every
    ``_DECIDE_RESYNC_EVERY``-th use. ``mex.prune_verdicts`` mirrors the
    verdicts."""
    from ..data.exchange import count_plan_build, plan_seed
    store = getattr(mex, "_prune_decisions", None)
    if store is None:
        store = mex._prune_decisions = {}
    key = (kind, token)
    entry = store.get(key)
    if entry is None:
        seeded = plan_seed(mex, "prune_decisions", key)
        if seeded is not None:
            entry = (bool(seeded), 1)
        else:
            count_plan_build(mex)
            entry = (bool(compute()), 1)
    else:
        verdict, uses = entry
        pl = _planner_of(mex)
        # a replan mark is a process's own: across processes a verdict
        # is only re-evaluated on the use count, the same everywhere
        why = pl.take_replan(_prune_site(token)) \
            if pl is not None and not mex.multiprocess else None
        if why is not None:
            # the observed fraction contradicted the prediction:
            # re-evaluate now from it (a correction, no decay)
            count_plan_build(mex)
            new = bool(compute())
            if new != verdict:
                pl.note_switch()
                from ..common import decisions as _decisions
                pl.record_replan(
                    _decisions.ledger_of(mex), _prune_site(token),
                    f"{kind}:{'on' if new else 'off'}", predicted=None,
                    rejected=[(f"{kind}:{'on' if verdict else 'off'}",
                               None)],
                    reason=why)
            verdict = new
        elif uses % _DECIDE_RESYNC_EVERY == 0:
            _decay_fraction(mex, token)
            count_plan_build(mex)
            verdict = bool(compute())
        entry = (verdict, uses + 1)
    store[key] = entry
    mex.prune_verdicts[key] = entry[0]
    return entry[0]


# -- plan-state persistence (service/plan_store.py) --------------------

def export_plan_state(mex) -> dict:
    """Verdicts and learned prune fractions as digest maps."""
    from ..data.exchange import _ident_digest, merge_unconsumed_seeds
    return merge_unconsumed_seeds(mex, {
        "prune_decisions": {
            _ident_digest(k): bool(v[0])
            for k, v in getattr(mex, "_prune_decisions", {}).items()},
        "prune_history": {
            _ident_digest(k): float(v)
            for k, v in getattr(mex, "_prune_history", {}).items()},
    })


def import_plan_state(mex, state: dict, *,
                      symmetric: bool = False) -> int:
    """Install pre-shuffle seeds into the mesh's seed table."""
    from ..data.exchange import install_plan_seeds
    return install_plan_seeds(mex, state,
                              ("prune_decisions", "prune_history"),
                              symmetric=symmetric)


def _pays_est(rows: int, item_bytes: int, W: int, sides: int, M: int,
              frac: float) -> Tuple[float, float]:
    """(est_pruned_row_bytes, est_fingerprint_bytes)."""
    pruned = max(rows, 0) * item_bytes * frac * max(W - 1, 0) / max(W, 1)
    return pruned, sides * M


def _pays(rows: int, item_bytes: int, W: int, sides: int, M: int,
          frac: float) -> bool:
    pruned, fingerprint = _pays_est(rows, item_bytes, W, sides, M, frac)
    if W <= 1 or rows <= 0:
        return False
    return pruned > _MARGIN * fingerprint


def _record_verdict(mex, which: str, token, verdict: bool, rows: int,
                    item_bytes: int, sides: int, frac: Optional[float],
                    reason: str) -> bool:
    """The ledger's record of one prune verdict, kept open for
    :func:`record_prune`'s audit join when a fraction was predicted."""
    from ..common import decisions as _decisions
    led = _decisions.ledger_of(mex)
    if led is not None:
        W = mex.num_workers
        M = register_width(rows)
        pruned, fp = _pays_est(rows, item_bytes, W, sides, M,
                               frac if frac is not None else 0.0)
        chosen = f"{which}:on" if verdict else f"{which}:off"
        other = f"{which}:off" if verdict else f"{which}:on"
        led.record("prune", _prune_site(token), chosen,
                   predicted=frac, join=frac is not None,
                   rejected=[(other, fp if verdict else pruned)],
                   reason=reason, rows=int(rows), unit="frac",
                   est_pruned_bytes=int(pruned),
                   est_fingerprint_bytes=int(fp))
    return verdict


def _auto_verdict(mex, which: str, kind: str, token, rows_global: int,
                  item_bytes: int, sides: int) -> bool:
    def compute():
        W = mex.num_workers
        frac = prune_fraction(mex, token)
        M = register_width(rows_global)
        pl = _planner_of(mex)
        verdict = (pl.prune_verdict(rows_global, item_bytes, W, sides, M,
                                    frac)
                   if pl is not None
                   else _pays(rows_global, item_bytes, W, sides, M, frac))
        # one verdict on every process: a learned fraction is a
        # process's own, and the verdict decides the collectives run
        verdict = mex.agree(verdict)
        return _record_verdict(mex, which, token, verdict, rows_global,
                               item_bytes, sides, frac, "cost model")
    return _sticky_decision(mex, kind, token, compute)


def auto_location_detect(mex, rows_global: int, item_bytes: int,
                         token, local_rows: bool = False) -> bool:
    """The verdict of the join's location filter (two register sides).
    ``local_rows`` marks a count of this process's rows (the host
    paths), which the processes of a mesh sum first."""
    if local_rows and mex.multiprocess:
        rows_global = sum(mex.allgather_object(int(rows_global)))
    forced = location_mode()
    if forced is not None:
        return _record_verdict(
            mex, "location", token, forced, rows_global, item_bytes, 2,
            None, "THRILL_TPU_LOCATION_DETECT forced")
    return _auto_verdict(mex, "location", "ld", token, rows_global,
                         item_bytes, 2)


def auto_dup_detect(mex, rows_global: int, item_bytes: int, token,
                    local_rows: bool = False) -> bool:
    """The verdict of ReduceByKey's duplicate detection (one register
    side); ``local_rows`` as for :func:`auto_location_detect`."""
    if local_rows and mex.multiprocess:
        rows_global = sum(mex.allgather_object(int(rows_global)))
    forced = dup_mode()
    if forced is not None:
        return _record_verdict(
            mex, "dup", token, forced, rows_global, item_bytes, 1, None,
            "THRILL_TPU_DUP_DETECT forced")
    return _auto_verdict(mex, "dup", "dup", token, rows_global,
                         item_bytes, 1)


def join_rows_estimate(left, right, token_l=None,
                       token_r=None) -> Tuple[int, int]:
    """(rows_global, item_bytes) for a device join's decision: counts
    on the host where they are, else the learned capacities of the
    side's exchange site (``token_l``, ``token_r``), else the padded
    capacity; the item bytes are the mean of the two sides'."""
    from ..data.exchange import leaf_item_bytes
    mex = left.mesh_exec

    def side_rows(shards, ident):
        if getattr(shards, "_counts_host", None) is not None:
            # every process's rows, so the verdict is one process's
            return int(shards.global_counts.sum())
        learned = learned_site_rows(mex, ident)
        if learned is not None:
            return learned * mex.num_workers
        return shards.cap * mex.num_workers

    rows = side_rows(left, token_l) + side_rows(right, token_r)
    bytes_l = leaf_item_bytes(pt.leaves(left.tree))
    bytes_r = leaf_item_bytes(pt.leaves(right.tree))
    return rows, max((bytes_l + bytes_r) // 2, 1)
