"""The plan store: learned plan state across restarts (counterpart of
the reference package's ``service/plan_store.py``).

A Context learns its plans in-process: sticky exchange capacities,
narrow ranges and plan kinds (data/exchange.py), pre-shuffle verdicts
and prune fractions (core/preshuffle.py), loop tape outcomes
(api/loop.py) and programs' output sizes (parallel/mesh.py). A restart
used to throw them away, so every exchange site read its send matrix on
the host again. This store keeps them in one file, ``plans.json``, under
a directory (``Config.plan_store`` or ``THRILL_TPU_PLAN_STORE``), so a
warm restart of a known pipeline makes no data-driven plan build
(``plan_builds == 0``).

* Keys are SHA-1 digests of the identity tuples, prefixed with the
  mesh width they were learned at (``w{W}:``): a capacity vector is
  W-shaped, and a load installs only the current width's entries. The
  port writes its own digests and reads no store of the reference
  package.
* Values are correctness-neutral: a lying capacity or range is caught
  by the exchange's flag and healed; a wrong kind or verdict costs time.
  So any parse, CRC or version failure starts cold, with a line on
  stderr, never from a partial read.
* Writes go through ``vfs.write_file_atomic``, merged with what is
  stored (capacities element-wise max), under an ``flock`` on a local
  directory. The directory may be remote (``s3://``, ``http(s)://``,
  ``hdfs://``, reference: ``service/plan_store.py:180-200``): an object
  store has no lock, so there the last writer wins.
* ``save_ledger`` writes the decision ledger's accuracy summary beside
  the plans (``decisions.json``).

On a mesh of several processes rank 0 alone opens and reads the store
and broadcasts the entries over the host group; every process installs
them with ``install_entries(..., symmetric=True)``, the attestation
that keeps the optimistic exchange open, and rank 0 alone saves at
close (``Context._plan_store_broadcast``). Without a host group that
spans the processes the store is skipped with a notice.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import sys
import zlib
from typing import Optional

from ..common import faults

STORE_VERSION = 2
_FILE = "plans.json"
_LEDGER_FILE = "decisions.json"

# at load time: a fire reads the store as corrupt (a cold start)
_F_CORRUPT = faults.declare("service.plan_store.corrupt")

#: entry kinds and their owners (data/exchange.py, core/preshuffle.py,
#: parallel/mesh.py, api/loop.py)
_KINDS = ("caps", "plan", "ranges", "prune_decisions", "prune_history",
          "out_bytes", "loop_tape")


def _crc(entries: dict) -> int:
    return zlib.crc32(json.dumps(entries, sort_keys=True).encode())


def _for_width(entries: dict, w: int) -> dict:
    """The entries learned at mesh width ``w``, prefix stripped."""
    pre = f"w{w}:"
    return {kind: {k[len(pre):]: v for k, v in m.items()
                   if isinstance(k, str) and k.startswith(pre)}
            for kind, m in entries.items() if isinstance(m, dict)}


def install_entries(mex, entries: dict, *,
                    symmetric: bool = False) -> int:
    """Install loaded entries of the mesh's width into its seed tables;
    the number that arrived. Each site takes its seed at first use.
    ``symmetric`` attests that every process of the mesh installs these
    same entries (``exchange.install_plan_seeds``); a store this
    process read for itself passes none, which keeps the optimistic
    dispatch off across processes."""
    from ..api import loop
    from ..core import preshuffle
    from ..data import exchange
    entries = _for_width(entries, mex.num_workers)
    n = exchange.import_plan_state(mex, entries, symmetric=symmetric)
    n += preshuffle.import_plan_state(mex, entries, symmetric=symmetric)
    n += loop.import_plan_state(mex, entries, symmetric=symmetric)
    ob = entries.get("out_bytes")
    if isinstance(ob, dict) and hasattr(mex, "import_learned_sizes"):
        n_ob = mex.import_learned_sizes(ob)
        if n_ob and not symmetric:
            # learned sizes follow the seeds' provenance rule
            mex._plan_seed_symmetric = False
        n += n_ob
    return n


class PlanStore:
    """One plan-state file under a directory."""

    def __init__(self, path: str, logger=None) -> None:
        from ..vfs import file_io
        self.path = path
        self.remote = file_io.is_remote(path)
        self.dir = path.rstrip("/") if self.remote else file_io._local(path)
        self.file = os.path.join(self.dir, _FILE)
        self.logger = logger
        self._last_corrupt: Optional[str] = None

    # -- reading --------------------------------------------------------
    def load(self) -> dict:
        """Entries by kind; {} when cold. Never raises: any failure but
        a missing file starts cold, loudly."""
        from ..vfs import file_io
        self._last_corrupt = None
        try:
            faults.check(_F_CORRUPT, path=self.file)
            with file_io.OpenReadStream(self.file) as f:
                raw = f.read()
        except FileNotFoundError:
            return {}
        except Exception as e:
            return self._corrupt(f"unreadable: {e!r}")
        try:
            payload = json.loads(raw.decode())
            if not isinstance(payload, dict):
                return self._corrupt("not a JSON object")
            if payload.get("version") != STORE_VERSION:
                return self._corrupt(
                    f"version skew: {payload.get('version')!r} != "
                    f"{STORE_VERSION}")
            entries = payload.get("entries")
            if not isinstance(entries, dict):
                return self._corrupt("entries missing")
            if _crc(entries) != payload.get("crc"):
                return self._corrupt("CRC mismatch")
        except Exception as e:
            return self._corrupt(f"parse failure: {e!r}")
        return {k: dict(v) for k, v in entries.items()
                if k in _KINDS and isinstance(v, dict)}

    def _corrupt(self, why: str) -> dict:
        self._last_corrupt = why
        faults.note("recovery", what="plan_store.corrupt", path=self.file,
                    why=why[:200])
        print(f"thrill_tpu_torch.service: plan store {self.file} ignored "
              f"({why}); planning cold", file=sys.stderr)
        return {}

    def attach(self, mex) -> int:
        """Seed a mesh from the store; the number of entries."""
        return install_entries(mex, self.load())

    # -- writing --------------------------------------------------------
    def save(self, mex) -> None:
        """Write the mesh's plan state, merged with the file's under an
        ``flock`` (capacities element-wise max, other sites' entries
        kept), so concurrent savers only ratchet; a remote store has no
        lock, and its last writer wins. A corrupt file is replaced
        whole."""
        with self._save_lock():
            self._save_locked(mex)

    @contextlib.contextmanager
    def _save_lock(self):
        if self.remote:
            yield
            return
        os.makedirs(self.dir, exist_ok=True)
        with open(os.path.join(self.dir, ".plans.lock"), "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lk, fcntl.LOCK_UN)

    def _save_locked(self, mex) -> None:
        from ..api import loop
        from ..core import preshuffle
        from ..data import exchange
        from ..vfs import file_io
        entries = exchange.export_plan_state(mex)
        entries.update(preshuffle.export_plan_state(mex))
        entries.update(loop.export_plan_state(mex))
        if hasattr(mex, "export_learned_sizes"):
            entries["out_bytes"] = mex.export_learned_sizes()
        pre = f"w{mex.num_workers}:"
        entries = {kind: {pre + dg: v for dg, v in m.items()}
                   for kind, m in entries.items()}
        prev = self.load()
        if self._last_corrupt is None:
            for kind, old in prev.items():
                new = entries.setdefault(kind, {})
                for dg, v in old.items():
                    if dg not in new:
                        new[dg] = v
                    elif kind == "caps":
                        try:
                            if len(new[dg]) == len(v):
                                new[dg] = [max(int(a), int(b))
                                           for a, b in zip(new[dg], v)]
                        except (TypeError, ValueError):
                            pass
        payload = {"version": STORE_VERSION, "crc": _crc(entries),
                   "entries": entries}
        file_io.write_file_atomic(
            self.file, json.dumps(payload, sort_keys=True).encode())
        if self.logger is not None and self.logger.enabled:
            self.logger.line(event="plan_store_save", path=self.file,
                             entries=sum(len(v) for v in entries.values()))

    def save_ledger(self, summary: dict) -> None:
        """The decision ledger's accuracy summary beside the plans (an
        overwrite: the newest run's audit is the one that matters)."""
        from ..vfs import file_io
        path = os.path.join(self.dir, _LEDGER_FILE)
        file_io.write_file_atomic(
            path, json.dumps(summary, sort_keys=True).encode())
        if self.logger is not None and self.logger.enabled:
            self.logger.line(event="decision_ledger_save", path=path,
                             decisions=summary.get("decisions", 0))
