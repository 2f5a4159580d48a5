"""Per-tenant HBM budgets and tenant activation (counterpart of the
reference package's ``service/tenancy.py``).

Enforcement lives in the HBM governor's tenant ledger (mem/hbm.py):
every cached DIA result is stamped with the tenant that was active when
its node was made (``Context.current_tenant``, set by the scheduler
around each job), and the governor keeps per-tenant byte counts beside
its global ledger. When a tenant crosses its budget the governor spills
that tenant's coldest results, and only that tenant's, to the host
block store; its next pull pays the restore. Another tenant's cached
results are never evicted for this tenant's pressure; global pressure
still goes through the tenant-blind paths (``maybe_spill``, the
pressure monitor), because a full card is full whoever's bytes fill it.

This module is the thin policy layer: budget parsing
(``THRILL_TPU_SERVE_HBM_BUDGETS="a=512Mi,b=1Gi"``), explicit
``set_budget``, and the ``activate`` context manager for callers that
run pipelines under a tenant without the scheduler.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional, Union

from ..common.config import parse_kv_spec, parse_si_iec_units

ENV_BUDGETS = "THRILL_TPU_SERVE_HBM_BUDGETS"


def _budget(v: str) -> int:
    nb = parse_si_iec_units(v)
    if nb <= 0:
        raise ValueError(v)
    return nb


def parse_budgets(spec: str) -> Dict[str, int]:
    """Parse "tenant=SIZE,..." (SI/IEC units per parse_si_iec_units);
    malformed entries are skipped loudly."""
    return parse_kv_spec(spec, _budget, ENV_BUDGETS)


def configure(ctx, budgets: Optional[Dict[str, int]] = None) -> None:
    """Install tenant budgets on the Context's governor. Env budgets
    fill only tenants without an explicit budget (idempotent — the
    scheduler calls this on construction)."""
    explicit = budgets or {}
    ctx.hbm.tenant_budgets.update(explicit)
    for tenant, nb in parse_budgets(
            os.environ.get(ENV_BUDGETS, "")).items():
        ctx.hbm.tenant_budgets.setdefault(tenant, nb)


def set_budget(ctx, tenant: str, limit: Union[int, str]) -> None:
    """Set one tenant's HBM budget (bytes, or an SI/IEC size string)."""
    nb = parse_si_iec_units(limit) if isinstance(limit, str) else int(limit)
    if nb <= 0:
        raise ValueError(f"tenant budget must be positive, got {limit!r}")
    ctx.hbm.tenant_budgets[tenant] = nb


@contextlib.contextmanager
def activate(ctx, tenant: str):
    """Run a block with ``tenant`` as the active tenant: nodes created
    inside are stamped and accounted against its budget. The scheduler
    does this around every job; this is the direct-use form (tests,
    single-tenant batch jobs that still want a budget)."""
    prev = ctx.current_tenant
    ctx.current_tenant = tenant
    try:
        yield
    finally:
        ctx.current_tenant = prev
