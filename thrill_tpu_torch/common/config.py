"""Runtime configuration (counterpart of the reference package's
``common/config.py``, the part the port reads): the RAM and HBM
budgets, the spill directory and the event log, from the environment
as the reference reads them.

    THRILL_TPU_RAM        RAM the operators may split (0 = detect)
    THRILL_TPU_HOST_RAM   host RAM when THRILL_TPU_RAM is unset
    THRILL_TPU_HBM_LIMIT  budget of the cached device results (0 = none)
    THRILL_TPU_SPILL_DIR  directory of the spill store's files
    THRILL_TPU_LOG        JSON event-log path pattern (unset = off)
    THRILL_TPU_CKPT_DIR   checkpoint epochs' directory (unset = off)
    THRILL_TPU_RESUME     1: resume from the newest committed epoch
    THRILL_TPU_CKPT_AUTO  1: seal every freshly computed op's result
    THRILL_TPU_EXCHANGE   exchange mode: dense (default), onefactor
    THRILL_TPU_PLAN_STORE plan store directory (unset = off)
    THRILL_TPU_OVERLAP    0: bulk-synchronous exchanges (master switch)
    THRILL_TPU_XCHG_CAP_CACHE  0: no optimistic capacity-plan reuse
    THRILL_TPU_WIRE_COMPRESS   0: full-width rows (master of NARROW)
    THRILL_TPU_XCHG_NARROW     0: no phase-B row narrowing
    THRILL_TPU_PROFILE    1: sample CPU, RAM and device memory into the
                          log every 0.5 s (common/profile.py)

Sizes take SI and IEC suffixes ("64K", "1Gi", "2GB"). The spill
directory defaults to the temporary directory (``TMPDIR``), not the
reference's fixed ``/tmp``.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional


def parse_si_iec_units(s: str) -> int:
    """Bytes of a size string such as '100', '64K', '1Gi' or '2GB' (a
    bare K, M, G, T is binary, as tlx's parser reads them)."""
    s = s.strip()
    mult = 1
    low = s.lower()
    for suffix, m in (
        ("kib", 1024), ("mib", 1024 ** 2), ("gib", 1024 ** 3),
        ("tib", 1024 ** 4),
        ("kb", 1000), ("mb", 1000 ** 2), ("gb", 1000 ** 3), ("tb", 1000 ** 4),
        ("ki", 1024), ("mi", 1024 ** 2), ("gi", 1024 ** 3), ("ti", 1024 ** 4),
        ("k", 1024), ("m", 1024 ** 2), ("g", 1024 ** 3), ("t", 1024 ** 4),
        ("b", 1),
    ):
        if low.endswith(suffix):
            mult = m
            s = s[: -len(suffix)]
            break
    return int(float(s.strip()) * mult)


def parse_kv_spec(spec: str, parse_value, what: str) -> dict:
    """Parse a "name=value,name=value" env spec, skipping malformed
    entries with a notice (a typo must not silently drop a tenant's
    weight or budget). ``parse_value`` converts and validates one value
    (raise ValueError to reject); the service plane's weight, rate and
    budget knobs parse with it (service/scheduler.py,
    service/tenancy.py)."""
    out: dict = {}
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, _, v = entry.partition("=")
        try:
            out[name.strip()] = parse_value(v)
        except (ValueError, IndexError):
            import sys
            print(f"thrill_tpu: malformed {what} entry {entry!r} "
                  f"ignored", file=sys.stderr)
    return out


def _env_size(name: str) -> int:
    v = os.environ.get(name)
    return parse_si_iec_units(v) if v else 0


def _env_int(name: str, default: int = 0) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def _env_flag(name: str, default: bool = True) -> bool:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v not in ("0", "off", "false")


def overlap_enabled() -> bool:
    """THRILL_TPU_OVERLAP=0 restores the bulk-synchronous exchange
    exactly: one phase-B dispatch and a host read of every send matrix.
    Master switch over THRILL_TPU_XCHG_CHUNKS and
    THRILL_TPU_XCHG_CAP_CACHE."""
    return _env_flag("THRILL_TPU_OVERLAP", True)


def cap_cache_enabled() -> bool:
    """THRILL_TPU_XCHG_CAP_CACHE=0 turns off the optimistic reuse of a
    call site's capacity plan: every exchange then reads its ``[W, W]``
    send matrix on the host before phase B."""
    return overlap_enabled() and _env_flag("THRILL_TPU_XCHG_CAP_CACHE",
                                           True)


def wire_compress_enabled() -> bool:
    """THRILL_TPU_WIRE_COMPRESS=0 ships every exchanged row at its
    declared dtype (the master switch of phase-B narrowing; the host
    frame codec it also switches in the reference is not ported)."""
    return _env_flag("THRILL_TPU_WIRE_COMPRESS", True)


def xchg_narrow_enabled() -> bool:
    """THRILL_TPU_XCHG_NARROW=0 turns off phase-B row narrowing alone;
    results are bit-equal either way (an exact integer cast chosen from
    observed ranges)."""
    return wire_compress_enabled() and _env_flag(
        "THRILL_TPU_XCHG_NARROW", True)


def round_up_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    if n <= 1:
        return 1
    return 1 << (int(n) - 1).bit_length()


def round_up(n: int, granularity: int) -> int:
    return ((n + granularity - 1) // granularity) * granularity


@dataclasses.dataclass
class Config:
    """Host-level configuration of one Context."""

    # bytes of RAM the operators split (0 = THRILL_TPU_HOST_RAM, else
    # the physical RAM)
    ram: int = 0
    host_ram: int = 0
    # bytes of cached device results before the coldest spill to the
    # host store (0 = unlimited; mem/hbm.py)
    hbm_limit: int = 0
    # directory of the spill store's files
    spill_dir: str = dataclasses.field(default_factory=tempfile.gettempdir)
    # JSON event-log path pattern (None = off; common/logger.py)
    log_path: Optional[str] = None
    # checkpoint epochs' directory ("" = the checkpoint manager is off;
    # api/checkpoint.py)
    ckpt_dir: str = ""
    # resume from the newest committed epoch (Run(resume=True) also)
    resume: bool = False
    # seal every freshly computed op's result, not only Checkpoint()s
    ckpt_auto: bool = False
    # exchange mode: "dense" (one padded all-to-all, switched to the
    # 1-factor rounds by the cost model when the send matrix is skewed),
    # "onefactor" (always W - 1 rounds, each padded to its own pair
    # maximum) or "ragged" (no padding: every row written straight to
    # its receiver's slot); another string takes the synced dense plan
    exchange: str = "dense"
    # plan store directory ("" = off; service/plan_store.py): learned
    # capacities, narrow ranges, plan kinds, pre-shuffle verdicts and
    # loop tape outcomes survive a restart
    plan_store: str = ""
    # sample host CPU and RAM and the card's memory into the JSON log
    # (common/profile.py; needs a log path)
    profile: bool = False

    @staticmethod
    def from_env() -> "Config":
        return Config(ram=_env_size("THRILL_TPU_RAM"),
                      host_ram=_env_size("THRILL_TPU_HOST_RAM"),
                      hbm_limit=_env_size("THRILL_TPU_HBM_LIMIT"),
                      spill_dir=(os.environ.get("THRILL_TPU_SPILL_DIR")
                                 or tempfile.gettempdir()),
                      log_path=os.environ.get("THRILL_TPU_LOG") or None,
                      ckpt_dir=os.environ.get("THRILL_TPU_CKPT_DIR") or "",
                      resume=bool(_env_int("THRILL_TPU_RESUME")),
                      ckpt_auto=bool(_env_int("THRILL_TPU_CKPT_AUTO")),
                      exchange=os.environ.get("THRILL_TPU_EXCHANGE")
                      or "dense",
                      plan_store=os.environ.get("THRILL_TPU_PLAN_STORE")
                      or "",
                      profile=bool(_env_int("THRILL_TPU_PROFILE", 0)))
