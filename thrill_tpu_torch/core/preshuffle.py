"""Plan-time pre-shuffle reduction decisions (counterpart of the
reference package's ``core/preshuffle.py``): DuplicateDetection for
ReduceByKey and LocationDetection for InnerJoin.

Duplicate detection keeps the rows of globally unique keys on their
worker instead of shipping them; location detection drops the rows of a
join whose key hash has no presence on the other side. Either is
switched on when the rows it is expected to prune outweigh the presence
registers it costs (one side for the reduce, two for the join):

    est_pruned_row_bytes  >  margin * est_fingerprint_bytes

with the pruned bytes estimated as rows x item bytes x the prune
fraction x the off-diagonal share (W-1)/W, and the registers as one
byte each. The verdict sticks per (mesh, site). The prune fraction is
the reference's neutral default; learning it from observed counts, the
decision ledger and the environment override are not ported.
"""

from __future__ import annotations

from typing import Tuple

from ..common import tree as pt
from ..data.shards import round_up_pow2

# register-width clamps: below the floor the register pass costs a
# launch anyway; above the ceiling false positives are already rare
_REG_MIN = 1 << 12
_REG_MAX = 1 << 17

# expected prune fraction before a site has taught anything
_DEFAULT_PRUNE_FRAC = 0.5

# enable only when the pruned bytes clear the register cost by this
_MARGIN = 2.0


def register_width(est_rows: int) -> int:
    """Presence-register count adapted to the global row estimate."""
    return max(_REG_MIN, min(_REG_MAX,
                             round_up_pow2(8 * max(int(est_rows), 1))))


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


def _sticky_verdict(mex, kind: str, token, rows_global: int,
                    item_bytes: int, sides: int) -> bool:
    """The cost model's verdict, sticky per (mesh, ``kind``, ``token``)
    in ``mex.prune_verdicts``."""
    key = (kind, token)
    verdict = mex.prune_verdicts.get(key)
    if verdict is None:
        verdict = mex.prune_verdicts[key] = _pays(
            rows_global, item_bytes, mex.num_workers, sides,
            register_width(rows_global), _DEFAULT_PRUNE_FRAC)
    return verdict


def auto_dup_detect(mex, rows_global: int, item_bytes: int, token) -> bool:
    """Cost-model verdict for ReduceByKey duplicate detection (one
    register side)."""
    return _sticky_verdict(mex, "dup", token, rows_global, item_bytes, 1)


def auto_location_detect(mex, rows_global: int, item_bytes: int,
                         token) -> bool:
    """Cost-model verdict for the join's location filter (two register
    sides)."""
    return _sticky_verdict(mex, "ld", token, rows_global, item_bytes, 2)


def join_rows_estimate(left, right) -> Tuple[int, int]:
    """(rows_global, item_bytes) for a join's decision: the port's counts
    are always host-known, so the rows are exact; the item bytes are the
    mean of the two sides'."""
    from ..data.exchange import leaf_item_bytes
    rows = left.total + right.total
    bytes_l = leaf_item_bytes(pt.leaves(left.tree))
    bytes_r = leaf_item_bytes(pt.leaves(right.tree))
    return rows, max((bytes_l + bytes_r) // 2, 1)
