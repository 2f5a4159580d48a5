"""Runtime configuration, the part the host phases read (counterpart of
the reference package's ``common/config.py``): the RAM budgets and the
spill directory, from the environment as the reference reads them.

    THRILL_TPU_RAM        RAM the operators may split (0 = detect)
    THRILL_TPU_HOST_RAM   host RAM when THRILL_TPU_RAM is unset
    THRILL_TPU_SPILL_DIR  directory of the spill store's files

Sizes take SI and IEC suffixes ("64K", "1Gi", "2GB"). The spill
directory defaults to the temporary directory (``TMPDIR``), not the
reference's fixed ``/tmp``.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile


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


def _env_size(name: str) -> int:
    v = os.environ.get(name)
    return parse_si_iec_units(v) if v else 0


@dataclasses.dataclass
class Config:
    """Host-level configuration of one Context."""

    # bytes of RAM the operators split (0 = THRILL_TPU_HOST_RAM, else
    # the physical RAM)
    ram: int = 0
    host_ram: int = 0
    # directory of the spill store's files
    spill_dir: str = dataclasses.field(default_factory=tempfile.gettempdir)

    @staticmethod
    def from_env() -> "Config":
        return Config(ram=_env_size("THRILL_TPU_RAM"),
                      host_ram=_env_size("THRILL_TPU_HOST_RAM"),
                      spill_dir=(os.environ.get("THRILL_TPU_SPILL_DIR")
                                 or tempfile.gettempdir()))
