"""The exchange between the mesh's virtual workers: the planned data
plane (counterpart of the reference package's ``data/exchange.py``).

Every helper works on all W workers at once: row ``w`` of a ``[W, ...]``
tensor is worker ``w``'s local value, and the reference's
``all_to_all`` over the mesh axis becomes a transpose of the worker
dimension.

  Phase A (one program): each item's destination, a stable sort of
      every worker's rows by it (the radix engine on the card), the
      ``[W, W]`` send matrix (the histogram kernel) and, where rows
      are worth narrowing, the ``[min, max]`` of each integer leaf.
  Plan: the padded per-pair capacity ``M_pad`` and the output capacity
      from the send matrix, read on the host, or taken from the call
      site's capacity-plan cache with no host read (below).
  Phase B (K programs): scatter the rows into ``[W, W, M]`` padded
      blocks, exchange them, and compact each receiver's runs in sender
      rank order into its output rows.

The plan layer on top:

* **Capacity-plan cache, optimistic dispatch.** A call site's padded
  capacities only grow (``_sticky_caps``) and double as a cache: once a
  site has a dense plan, phase B runs on it straight off the device send
  matrix, the counts stay on the device, and a flag computed in phase B
  rides a deferred check (``MeshExec.drain_checks``). A miss re-runs the
  synced plan from the retained phase-A output and heals the shards in
  place. ``THRILL_TPU_XCHG_CAP_CACHE=0`` reads every send matrix.
* **Chunked phase B.** The slot range ``[0, M_pad)`` splits into K row
  ranges, each its own dispatch into a shared accumulator; every row
  lands where the single dispatch puts it, so any K is bit-equal. On
  the card there is nothing to overlap, and the auto policy chunks only
  a phase B too large for the HBM budget (``chunk_policy``).
  ``THRILL_TPU_XCHG_CHUNKS`` pins K; ``THRILL_TPU_OVERLAP=0`` restores
  one dispatch and a host read of every send matrix.
* **Row narrowing.** Integer leaves whose learned range fits a narrower
  type cross phase B in it and widen back bit for bit; a learned range
  the data outgrew is a miss like a capacity overflow.
  ``THRILL_TPU_XCHG_NARROW=0`` (or ``THRILL_TPU_WIRE_COMPRESS=0``)
  ships full-width rows.
* **Dense against the 1-factor rounds.** A skewed send matrix pads
  every pair to the global maximum; W - 1 rounds, each padded to its own
  pair maximum, copy less. The cost model (``_strategy_costs``, owned by
  the planner when one is attached) chooses; ``THRILL_TPU_EXCHANGE``
  (or ``Config.exchange``) forces ``dense`` or ``onefactor``.
* **The ragged exchange** (``THRILL_TPU_EXCHANGE=ragged``): no per-pair
  padding. One program writes each phase-A row straight to its
  receiver's slot (the exclusive prefix of its sender's send row and
  ``landing[s, d] = sum(S[0:s, d])``), in the dense path's order; a
  synced plan every time (``_exchange_ragged``).
* **The streamed exchange** (:func:`exchange_stream`): the identity
  round, then one program a 1-factor round, each yielded as its own
  shards for a consumer that folds them as they come (ReduceByKey's
  streamed post phase, ``THRILL_TPU_REDUCE_STREAM=1``).
* **Plan state** (capacities, plan kinds, ranges) exports to and
  imports from the plan store (``service/plan_store.py``) by digest.

Every value of the plan layer is correctness-neutral: a lying capacity
or range is caught by the flag and healed, so results are bit-equal to
the bulk, synced, full-width exchange for any setting.

Any other mode string takes the synced dense plan, as the reference's
(``stream`` as a mode is such a string: the streamed delivery is the
consumer's choice, not the exchange's).

Across processes (parallel/mesh.py) a process holds its local workers'
rows of one global plan, and every mode runs. Phase A's send rows are
the local ones; a synced plan reads the global ``[W, W]`` send matrix
(:meth:`MeshExec.fetch_global`: the local rows, gathered), so every
process builds the same plan. The dense phase B's transpose is
:meth:`MeshExec.worker_transpose` (one ``all_to_all_single`` of the
padded blocks bound for each process); the ragged exchange packs each
local sender's rows by receiving process and ships them with
:meth:`MeshExec.exchange_rows` (uneven splits from the global matrix),
and the 1-factor and streamed rounds ship each round's blocks the same
way, one collective a round on every process, its own blocks empty or
not. Receivers keep source-worker order, so results are bit-equal to
the one-process run of W workers (the streamed delivery promises no
order, in one process or several). Every choice reads global numbers:
the skew flip reads the global ``S`` with the static ``bytes_eq`` (a
calibration is a process's own); narrowing folds each leaf's ``[min,
max]`` over the processes (``worker_min``, ``worker_max``) before a
spec is made; the optimistic dispatch gathers the global send matrix on
the device, so its overflow flag is a function of that matrix and of a
range verdict max-folded over the processes, the same on every process,
and every process heals or none does, at the drain points the processes
share. Seeds installed without the ``symmetric`` attestation (a store
read by each process) turn optimism off across processes, as in the
reference (``install_plan_seeds``). The chunk count stays the volume
rule's: a per-process HBM budget would give the processes different
chunk counts, and so different collectives.

Observability (common/trace.py, common/doctor.py): ``exchange`` spans
``phase_a``, ``phase_b`` (``chunks``, ``narrowed``), ``optimistic``
(``m_pad``, ``out_cap``) and ``synced`` (``mode``); the deferred
check's ``cap_hit``/``capacity_miss`` instant once its flag is read;
the doctor's waits at the plan sync and the deferred check, and its skew
record in :func:`account_traffic`, where the send matrix is on the host.
"""

from __future__ import annotations

import hashlib
import os
import time
import weakref
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import decisions as _decisions
from ..common import faults
from ..common import tree as pt
from ..common.config import (cap_cache_enabled, overlap_enabled,
                             round_up_pow2, xchg_narrow_enabled)
from ..common.partition import dense_range_bounds
from ..common.retry import default_policy
from ..common.trace import instant_of, span_of
from ..core.device_sort import argsort_words
from ..core.pallas_kernels import partition_histogram
from ..core.rowmove import scatter_slots, take_rows_multi
from ..parallel.mesh import MeshExec, current_mex, worker_max, worker_min
from .shards import DeviceShards

# a chunk of phase B, before its program launches (nothing dispatched
# yet, so a transient retry is safe)
_F_CHUNK = faults.declare("data.exchange.chunk")
# before a learned narrow spec is applied: a fire ships this exchange
# at full width (always right), never a wrong result
_F_PACK = faults.declare("data.exchange.pack")


def send_counts(dest: torch.Tensor, W: int) -> torch.Tensor:
    """``[W, W]`` int32 send matrix: ``S[s, d]`` items of worker ``s``
    go to worker ``d``. ``dest`` ``[W, cap]`` (int32 or int64, read as it
    is) uses ``W`` for invalid items, which the histogram kernel does not
    count."""
    return partition_histogram(dest, W)


# ----------------------------------------------------------------------
# plan state and its persistence (service/plan_store.py)
# ----------------------------------------------------------------------
# Learned plan state is keyed by identity tuples (call-site ident,
# capacity, treedef, dtypes). For the store they digest to strings that
# are stable across processes for the same program, so a warm restart of
# the same pipeline finds its state and a changed one misses and learns.


def _canon(x) -> str:
    """An address-free repr for digesting: a function becomes its
    module, qualname and a hash of its bytecode, constants and closure
    cells (``lambda x: x % 7`` and ``lambda x: x % 11`` differ); another
    object whose repr holds an address becomes its class, which can only
    merge two sites' plan state (correctness-neutral)."""
    if isinstance(x, tuple):
        return "(" + ",".join(_canon(e) for e in x) + ")"
    if callable(x) and not isinstance(x, type):
        qn = getattr(x, "__qualname__", None)
        if qn:
            code = getattr(x, "__code__", None)
            if code is not None:
                consts = tuple(
                    c.co_code.hex() if hasattr(c, "co_code")
                    else repr(c) for c in code.co_consts)
                try:
                    cells = tuple(_canon(c.cell_contents)
                                  for c in (x.__closure__ or ()))
                except Exception:
                    cells = ("<?>",)
                h = hashlib.sha1(repr((consts, cells)).encode()
                                 + b"|" + code.co_code).hexdigest()[:8]
                return f"<fn {getattr(x, '__module__', '?')}.{qn}:{h}>"
            return f"<fn {getattr(x, '__module__', '?')}.{qn}>"
    r = repr(x)
    if " at 0x" in r:
        return f"<{type(x).__module__}.{type(x).__qualname__}>"
    return r


def _ident_digest(ident: Tuple) -> str:
    return hashlib.sha1(_canon(ident).encode()).hexdigest()


def _site(ident: Tuple) -> str:
    return "xchg:" + _ident_digest(ident)[:10]


def plan_seed(mex: MeshExec, kind: str, ident: Tuple):
    """Take the imported plan-store seed for ``ident`` (None without a
    store or for an unknown key). Taken once: the live per-mesh tables
    take over from the first lookup. Shared with core/preshuffle.py and
    api/loop.py."""
    seeds = getattr(mex, "_plan_seed", None)
    if not seeds:
        return None
    m = seeds.get(kind)
    if not m:
        return None
    dg = _ident_digest(ident)
    v = m.pop(dg, None)
    if v is not None:
        mex.stats_plan_store_hits += 1
        led = _decisions.ledger_of(mex)
        if led is not None:
            led.record("store_seed", site="xchg:" + dg[:10],
                       chosen=kind, reason="warm-start seed consumed")
    return v


def count_plan_build(mex: MeshExec) -> None:
    """One data-driven plan construction (a synced exchange plan, a
    pre-shuffle verdict): what a warm plan-store restart makes none of."""
    mex.stats_plan_builds += 1


def merge_unconsumed_seeds(mex, out: dict) -> dict:
    """Add the imported seeds no site took to an export, so the plans
    of pipelines not run this time survive the save."""
    seeds = getattr(mex, "_plan_seed", None) or {}
    for kind in out:
        for dg, v in (seeds.get(kind) or {}).items():
            out[kind].setdefault(dg, v)
    return out


def install_plan_seeds(mex, state: dict, kinds, *,
                       symmetric: bool = False) -> int:
    """Merge digest maps of ``kinds`` into the mesh's seed table; the
    number of entries that arrived. ``symmetric`` attests that every
    process of the mesh installs these same entries; seeds that arrive
    without it (a store each process read for itself) turn
    ``mex._plan_seed_symmetric`` off, and with it the optimistic
    dispatch across processes (:func:`_optimistic_ok`): seeds that may
    differ between processes would give them different plans, and so
    different collectives. State learned in the run derives from the
    global send matrix and needs no attestation (the flag's default)."""
    seeds = getattr(mex, "_plan_seed", None)
    if seeds is None:
        seeds = mex._plan_seed = {}
    n = 0
    for kind in kinds:
        m = state.get(kind)
        if isinstance(m, dict) and m:
            seeds.setdefault(kind, {}).update(m)
            n += len(m)
    if n and not symmetric:
        mex._plan_seed_symmetric = False
    return n


def export_plan_state(mex: MeshExec) -> dict:
    """The exchange's plan state as digest maps (the store's form)."""
    return merge_unconsumed_seeds(mex, {
        "caps": {_ident_digest(k): [int(x) for x in v]
                 for k, v in getattr(mex, "_sticky_caps", {}).items()},
        "plan": {_ident_digest(k): str(v)
                 for k, v in getattr(mex, "_xchg_plan", {}).items()},
        "ranges": {_ident_digest(k):
                   [list(map(int, r)) if r is not None else None
                    for r in v]
                   for k, v in getattr(mex, "_sticky_ranges",
                                       {}).items()},
    })


def import_plan_state(mex: MeshExec, state: dict, *,
                      symmetric: bool = False) -> int:
    """Install exchange seeds (:func:`export_plan_state`'s form)."""
    return install_plan_seeds(mex, state, ("caps", "plan", "ranges"),
                              symmetric=symmetric)


def _seeded_caps(mex: MeshExec, ident: Tuple) -> Optional[Tuple[int, ...]]:
    v = plan_seed(mex, "caps", ident)
    if not v:
        return None
    try:
        return tuple(int(x) for x in v)
    except (TypeError, ValueError):
        return None


#: MeshExec attributes owned by this module whose values are shaped by
#: the worker count W (per-worker capacity vectors, W-specific plan
#: kinds and narrow ranges, unconsumed store seeds learned at this W):
#: ``MeshExec.resize`` parks them per W (reference:
#: ``data/exchange.py:232``), so a W' pipeline never reads a W-long
#: capacity vector
W_STATE_ATTRS = ("_sticky_caps", "_sticky_ranges", "_xchg_plan",
                 "_xchg_plan_uses", "_plan_seed")


def round_cap(n: int) -> int:
    """``n`` rounded up to five significant bits, at most 1/16 more: the
    padded capacities of phase B on the card. The reference rounds them
    to powers of two, so XLA compiles one program a power; an eager
    program has no compile to save, and a power of two doubled the
    phase-B buffers of every W = 4 exchange whose per-pair counts sit
    just past one (2^20 + a few rows a pair)."""
    n = max(int(n), 1)
    shift = max(n.bit_length() - 5, 0)
    return -(-n >> shift) << shift


def _sticky_caps(mex: MeshExec, ident: Tuple, needed: Tuple[int, ...],
                 pow2_out: bool = True) -> Tuple[int, ...]:
    """Capacities per program identity that only grow: a loop reaches a
    steady plan and its shapes stop changing, and a small wiggle of the
    counts stays under the cached capacity. A plan-store seed ratchets a
    site to its remembered capacities.

    The rounding rule: on a CPU mesh every capacity rounds up to a power
    of two, as the reference's do, so the capacity-plan cache's hits and
    misses, the chunk rule's volume and the dispatches are the
    reference's. On the card the padded ones round by :func:`round_cap`
    (at most 1/16 headroom, which saved the Sort's memory) and the last,
    the output shards' capacity, to a power of two as the reference's
    (checkpoint manifests record it) unless ``pow2_out`` is off (the
    Sort's merged output, which keeps its own)."""
    cache = getattr(mex, "_sticky_caps", None)
    if cache is None:
        cache = mex._sticky_caps = {}
    prev = cache.get(ident)
    if prev is None:
        prev = _seeded_caps(mex, ident)
    if mex.device.type == "cuda":
        grown = tuple(round_cap(n) for n in needed)
        if pow2_out:
            grown = grown[:-1] + (round_up_pow2(needed[-1]),)
    else:
        grown = tuple(round_up_pow2(n) for n in needed)
    if prev is not None and len(prev) == len(grown):
        grown = tuple(max(p, g) for p, g in zip(prev, grown))
    cache[ident] = grown
    return grown


def _sticky_range_get(mex: MeshExec, cap_ident: Tuple):
    """The site's remembered per-leaf range union, seeded from a plan
    store on first use."""
    store = getattr(mex, "_sticky_ranges", None)
    if store is None:
        store = mex._sticky_ranges = {}
    prev = store.get(cap_ident)
    if prev is None:
        v = plan_seed(mex, "ranges", cap_ident)
        if v is not None:
            try:
                prev = tuple(tuple(int(x) for x in r)
                             if r is not None else None for r in v)
            except (TypeError, ValueError):
                prev = None
            if prev is not None:
                store[cap_ident] = prev
    return prev


# ----------------------------------------------------------------------
# phase-B row narrowing
# ----------------------------------------------------------------------
# A narrow type crosses phase B in the signed torch type of its width (a
# truncating cast keeps the low bits) and widens back by sign extension
# or, for an unsigned type, by masking: exact for every value in range.

_NARROW_LADDER = (np.dtype(np.uint8), np.dtype(np.int8),
                  np.dtype(np.uint16), np.dtype(np.int16),
                  np.dtype(np.uint32), np.dtype(np.int32))
_CONTAINER = {1: torch.int8, 2: torch.int16, 4: torch.int32}
_NARROWABLE = (torch.int16, torch.int32, torch.int64)
# below this padded volume (W * cap * item bytes) the range analysis
# costs more than thinner rows save
_NARROW_MIN_BYTES = 1 << 15


def narrow_dtype(lo: int, hi: int, itemsize: int) -> Optional[np.dtype]:
    """The first ladder type holding ``[lo, hi]`` that is strictly
    narrower than ``itemsize`` bytes."""
    for d in _NARROW_LADDER:
        if d.itemsize >= itemsize:
            return None
        info = np.iinfo(d)
        if info.min <= lo and hi <= info.max:
            return d
    return None


def _narrowable_leaves(leaves) -> Tuple[int, ...]:
    """Leaves eligible for range analysis: signed integers of two bytes
    or more (floats never narrow; bit parity would break)."""
    return tuple(i for i, l in enumerate(leaves) if l.dtype in _NARROWABLE)


def _to_narrow(x: torch.Tensor, nd: str) -> torch.Tensor:
    return x.to(_CONTAINER[np.dtype(nd).itemsize])


def _from_narrow(y: torch.Tensor, nd: str, wide: torch.dtype
                 ) -> torch.Tensor:
    d = np.dtype(nd)
    out = y.to(wide)
    if d.kind == "u":
        out = out & ((1 << (8 * d.itemsize)) - 1)
    return out


def _spec_of(ranges_by_leaf, leaves, nidx) -> Optional[Tuple]:
    spec: list = [None] * len(leaves)
    any_narrow = False
    for j, li in enumerate(nidx):
        if j >= len(ranges_by_leaf) or ranges_by_leaf[j] is None:
            continue
        nd = narrow_dtype(ranges_by_leaf[j][0], ranges_by_leaf[j][1],
                          leaves[li].element_size())
        if nd is not None:
            spec[li] = nd.str
            any_narrow = True
    return tuple(spec) if any_narrow else None


def _spec_from_ranges(mex: MeshExec, cap_ident: Tuple, leaves,
                      nidx: Tuple[int, ...],
                      ranges: Optional[np.ndarray]):
    """The site's narrow spec after merging this exchange's ranges into
    its remembered union (which only widens): per leaf a dtype string or
    None; None when nothing narrows."""
    if ranges is None or not nidx:
        return None
    prev = _sticky_range_get(mex, cap_ident)
    merged = []
    for j in range(len(nidx)):
        lo, hi = int(ranges[j, 0]), int(ranges[j, 1])
        if lo > hi:                       # no valid row: no information
            if prev is not None and prev[j] is not None:
                lo, hi = prev[j]
            else:
                merged.append(None)
                continue
        elif prev is not None and prev[j] is not None:
            lo, hi = min(lo, prev[j][0]), max(hi, prev[j][1])
        merged.append((lo, hi))
    mex._sticky_ranges[cap_ident] = tuple(merged)
    return _spec_of(merged, leaves, nidx)


def _sticky_spec(mex: MeshExec, cap_ident: Tuple, leaves):
    """The narrow spec an optimistic dispatch trusts: the remembered
    ranges alone, no fetch. Phase B's flag catches data that outgrew
    them."""
    prev = _sticky_range_get(mex, cap_ident)
    if prev is None:
        return None
    return _spec_of(prev, leaves, _narrowable_leaves(leaves))


def _pack_degraded(spec):
    """The ``data.exchange.pack`` site: a fire drops the narrow spec of
    this exchange (full-width rows are always right)."""
    if spec is None or not faults.REGISTRY.active():
        return spec
    try:
        faults.check(_F_PACK)
    except faults.InjectedFault:
        faults.note("recovery", what="xchg.pack_degrade")
        return None
    return spec


def _narrow_item_bytes(leaves, spec) -> int:
    """Bytes of one item as phase B copies it under a narrow spec."""
    total = 0
    for i, l in enumerate(leaves):
        isz = (np.dtype(spec[i]).itemsize
               if spec is not None and spec[i] is not None
               else l.element_size())
        total += isz * int(np.prod(tuple(l.shape[2:]), dtype=np.int64))
    return total


def leaf_ranges_traced(xs: Sequence[torch.Tensor], mask: torch.Tensor
                ) -> torch.Tensor:
    """``[len(xs), 2]`` int64 ``[min, max]`` of each ``[W, cap, ...]``
    leaf's valid rows over all workers (``lo > hi`` with none). Phase A
    and the Sort's classify step share it (the reference's name: there
    it is traced into those programs)."""
    rows = []
    for x in xs:
        info = torch.iinfo(x.dtype)
        m = mask.reshape(mask.shape + (1,) * (x.dim() - 2))
        lo = torch.where(m, x, torch.full((), info.max, dtype=x.dtype,
                                          device=x.device)).amin()
        hi = torch.where(m, x, torch.full((), info.min, dtype=x.dtype,
                                          device=x.device)).amax()
        rows.append(torch.stack([lo.to(torch.int64), hi.to(torch.int64)]))
    return torch.stack(rows)


def _narrow_worth(mex: MeshExec, cap: int, leaves) -> bool:
    """Range analysis pays on volume, at W > 1, with narrowing on and
    no loop capture recording (ranges are values of loop data)."""
    W = mex.num_workers
    return (W > 1 and xchg_narrow_enabled()
            and mex.loop_recorder is None
            and W * cap * leaf_item_bytes(leaves) >= _NARROW_MIN_BYTES)


def fetch_ranges(mex: MeshExec, range_mat: Optional[torch.Tensor]
                 ) -> Optional[np.ndarray]:
    """The ``[L, 2]`` leaf ranges on the host (an uncounted read that
    rides the plan sync), across processes every process's folded first
    (``worker_min`` of the lows, ``worker_max`` of the highs), so every
    process makes the same narrow spec."""
    if range_mat is None:
        return None
    if mex.multiprocess:
        range_mat = torch.stack([worker_min(range_mat[None, :, 0], mex),
                                 worker_max(range_mat[None, :, 1], mex)],
                                dim=1)
    return mex._fetch_raw(range_mat)


def presorted_range_leaves(mex: MeshExec, cap: int,
                           leaves) -> Tuple[int, ...]:
    """Narrowable leaves when a presorted classify program should add
    the range analysis (phase A's policy)."""
    if not _narrow_worth(mex, cap, leaves):
        return ()
    return _narrowable_leaves(leaves)


# ----------------------------------------------------------------------
# mode, costs and the strategy choice
# ----------------------------------------------------------------------

def _planner_of(mex):
    pl = getattr(mex, "planner", None)
    if pl is not None and pl.enabled:
        return pl
    return None


def resolve_mode(mex: MeshExec) -> str:
    """The exchange mode: THRILL_TPU_EXCHANGE (read once, when the mesh
    was made), then the mesh's configured mode, then dense. ``dense``
    lets the cost model choose the 1-factor rounds; ``onefactor`` and
    ``ragged`` force theirs, in one process or several; any other
    string, ``stream`` among them, takes the synced dense plan, as in
    the reference."""
    env = getattr(mex, "_env_exchange", None)
    return env or getattr(mex, "exchange_mode", "dense") or "dense"


def leaf_item_bytes(leaves: Sequence[torch.Tensor]) -> int:
    """Bytes of one item across ``[W, cap, ...]`` leaves."""
    return sum(l.element_size() * int(np.prod(tuple(l.shape[2:]),
                                              dtype=np.int64))
               for l in leaves)


def one_factor_rounds(mex: MeshExec) -> List[np.ndarray]:
    """The partner permutations of the pairwise exchange: round ``r``
    sends worker ``w``'s rows to ``(w + r) % W``, every ordered pair
    once (the identity round is the local copy)."""
    W = mex.num_workers
    return [np.array([(w + r) % W for w in range(W)])
            for r in range(1, W)]


# The break-even padded bytes per extra launch: the dense plan is one
# launch padded to the global cell maximum, the 1-factor plan W - 1
# rounds padded per round; the rounds win when the padding they save
# beats their extra launches times BYTES_EQ = launch overhead x copy
# bandwidth. The CPU constant is the reference's (its 8-device virtual
# CPU mesh: 119 us a round at 378 MB/s), kept so the CPU tests make the
# reference's choices. The card has no constant and no calibration: its
# W workers share one device, so the rounds save no link time, and the
# dense plan won every case of `python3 kernel_times.py --xchg-crossover`
# at W = 4, hot pairs of 4M rows included (PERF.md section 6); there the
# strategy is dense (:func:`_one_card`). THRILL_TPU_XCHG_BYTES_EQ
# overrides the CPU's.
_BYTES_EQ_MEASURED = {"cpu": 45_000}
_BYTES_EQ_FALLBACK = 1 << 20
_BYTES_EQ_BANDWIDTH = {"cpu": 378e6}
_BYTES_EQ_BANDWIDTH_FALLBACK = 4e9
_BYTES_EQ_MIN_SAMPLES = 256


def _one_card(mex: MeshExec) -> bool:
    """The W workers share one card: the exchange is dense, with no
    cost model between the plans."""
    return mex.device.type == "cuda"


def _bytes_eq(mex: MeshExec) -> int:
    env = os.environ.get("THRILL_TPU_XCHG_BYTES_EQ")
    if env:
        try:
            return int(env)
        except ValueError:
            pass
    platform = mex.device.type
    static = _BYTES_EQ_MEASURED.get(platform, _BYTES_EQ_FALLBACK)
    # live calibration from the dispatch-latency spine once it has
    # enough samples (fresh meshes, and so every plan-choice test, keep
    # the static constant), clamped to [static / 4, static * 4];
    # THRILL_TPU_XCHG_BYTES_EQ_CAL=0 pins the static value. Across
    # processes the static value: a latency is a process's own, and a
    # cost read from it could flip one process's plan only
    if (os.environ.get("THRILL_TPU_XCHG_BYTES_EQ_CAL", "1") != "0"
            and not mex.multiprocess
            and mex._disp_lat_n >= _BYTES_EQ_MIN_SAMPLES):
        bw = _BYTES_EQ_BANDWIDTH.get(platform,
                                     _BYTES_EQ_BANDWIDTH_FALLBACK)
        cal = int(mex._disp_lat_min * bw)
        cal = max(static // 4, min(cal, static * 4))
        led = _decisions.ledger_of(mex)
        if led is not None and not getattr(mex, "_bytes_eq_logged",
                                           False):
            mex._bytes_eq_logged = True
            rec = led.record(
                "bytes_eq", "xchg:bytes_eq", "calibrated",
                predicted=cal, rejected=[("static", static)],
                reason="launch-min %.0fus x %s bw"
                       % (mex._disp_lat_min * 1e6, platform),
                samples=int(mex._disp_lat_n))
            led.resolve(rec, static)
        return cal
    return static


def _strategy_costs(mex: MeshExec, S: np.ndarray,
                    row_bytes: int) -> Tuple[int, int, int]:
    """(dense bytes, 1-factor bytes, rounds): the padded volume each
    plan copies between workers for this send matrix (the diagonal and
    the identity round are local on both sides)."""
    W = S.shape[0]
    M_dense = int(S.max())
    rounds = one_factor_rounds(mex)
    M_rounds = [max(int(S[np.arange(W), to].max()), 1) for to in rounds]
    rb = max(row_bytes, 1)
    return (W * (W - 1) * M_dense * rb, W * sum(M_rounds) * rb,
            len(rounds))


def _skewed(S: np.ndarray, row_bytes: int, mex: MeshExec) -> bool:
    """Does the cost model prefer the 1-factor rounds for ``S``? Never
    on the card. Across processes ``S`` is the global matrix and
    ``bytes_eq`` the static constant, so every process flips alike."""
    if _one_card(mex):
        return False
    dense_b, of_b, n_rounds = _strategy_costs(mex, S, row_bytes)
    return dense_b - of_b > n_rounds * _bytes_eq(mex)


def dense_all_to_all_applies(mex: MeshExec, S: np.ndarray,
                             row_bytes: int = 8) -> bool:
    """Would the exchange take the dense plan for ``S``? The Sort's
    fused path runs exactly when it would."""
    return resolve_mode(mex) == "dense" and not _skewed(S, row_bytes,
                                                        mex)


def account_traffic(mex: MeshExec, S: np.ndarray, item_bytes: int,
                    site: str = "", **log_extra: Any) -> None:
    """Count one logical exchange of send matrix ``S``: items and bytes
    that leave their worker (the diagonal stays). An optimistic exchange
    counts at its deferred check, or its healed re-run does. The
    performance doctor's skew record rides here, where ``S`` is already
    on the host: each worker's receive rows, the diagonal included."""
    # the items this process's workers send to another worker (every
    # worker's in one process): the processes' counts sum to the global
    lo, Wl = mex.worker_base, mex.num_local
    rows = S[lo:lo + Wl]
    moved = int(rows.sum()) - int(np.trace(S[lo:lo + Wl, lo:lo + Wl]))
    mex.stats_exchanges += 1
    mex.stats_items_moved += moved
    mex.stats_bytes_moved += moved * item_bytes
    skew = None
    doc = mex.doctor
    if doc is not None and S.shape[0] > 1:
        skew = doc.record_exchange(site or "xchg:?", S.sum(axis=0),
                                   item_bytes, tracer=mex.tracer,
                                   ledger=_decisions.ledger_of(mex))
    log = mex.logger
    if log is not None and log.enabled and S.shape[0] > 1:
        extra = {"site": site} if site else {}
        if skew is not None:
            extra.update(skew_ratio=round(skew[0], 3),
                         hot_worker=skew[1], hot_rows=skew[2])
        log.line(event="exchange", items=moved, bytes=moved * item_bytes,
                 per_worker_sent=(S.sum(axis=1) - np.diag(S)).tolist(),
                 per_worker_recv=(S.sum(axis=0) - np.diag(S)).tolist(),
                 **extra, **log_extra)


# ----------------------------------------------------------------------
# phase A
# ----------------------------------------------------------------------

def _leaf_sig(leaves: Sequence[torch.Tensor]) -> Tuple:
    return tuple((l.dtype, tuple(l.shape[2:])) for l in leaves)


def _phase_a_prog(mex: MeshExec, leaves: List[torch.Tensor],
                  counts: torch.Tensor, dest_builder: Callable, treedef,
                  nidx: Tuple[int, ...]):
    """Program: destinations, each worker's rows sorted stably by them,
    the ``[W, W]`` send matrix and the ranges of leaves ``nidx``."""
    W = mex.num_workers
    dev = leaves[0].device
    cap = leaves[0].shape[1]
    mask = torch.arange(cap, device=dev)[None, :] < counts[:, None]
    widx = mex.local_ids()
    dest = torch.as_tensor(dest_builder(pt.unflatten(treedef, leaves), mask,
                                        widx), device=dev).to(torch.int64)
    dest = torch.where(mask, dest.clamp(0, W - 1), torch.full_like(dest, W))
    # the destination's bits are known: every digit sorts, no host read
    perm = argsort_words([dest], [W.bit_length()], passes=mex.radix_passes,
                         sync_free=True)
    sorted_dest = torch.gather(dest, 1, perm)
    out = (sorted_dest, send_counts(sorted_dest, W),
           take_rows_multi(leaves, perm))
    if nidx:
        out = out + (leaf_ranges_traced([leaves[i] for i in nidx], mask),)
    return out


def _phase_a(shards: DeviceShards, dest_builder: Callable,
             cache_key: Tuple, want_ranges: bool = True):
    """Phase A. Returns (treedef, sorted_dest, sorted leaves, the send
    matrix on the device, the ranges on the device or None); whether the
    send matrix is read on the host is the caller's choice."""
    mex = shards.mesh_exec
    # an upstream optimistic exchange may owe its check: heal it before
    # its rows feed another shuffle
    shards.validate_pending()
    leaves, td = pt.flatten(shards.tree)
    cap = shards.cap
    nidx = (_narrowable_leaves(leaves)
            if want_ranges and _narrow_worth(mex, cap, leaves) else ())
    prog = mex.program(("xchg_a", cache_key, cap, td, nidx,
                        _leaf_sig(leaves)), _phase_a_prog)
    with span_of(mex.tracer, "exchange", "phase_a",
                 rows=mex.num_workers * cap):
        out = prog(mex, leaves, shards.counts_device(), dest_builder, td,
                   nidx)
    return td, out[0], list(out[2]), out[1], (out[3] if nidx else None)


# ----------------------------------------------------------------------
# phase B
# ----------------------------------------------------------------------

def _ex_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x, dim=dim) - x


def _chunk_prog(sdest: torch.Tensor, smat: torch.Tensor,
                leaves: List[torch.Tensor], accs: Optional[List],
                M_pad: int, out_cap: int, lo: int, hi: int, M_c: int,
                narrow, first: bool, last: bool, in_place: bool):
    """Program: chunk ``[lo, hi)`` of the dense phase B. Each sender's
    rows of slots ``[lo, hi)`` of every destination go into ``[W, W,
    hi - lo]`` padded blocks, the blocks are exchanged (a transpose of
    the worker dimensions), and receiver ``r`` writes its block from
    sender ``s`` at rows ``roff[r, s] + slot``: the positions the single
    dispatch uses, so any K is bit-equal. Unused block rows go to dump
    rows of their own past ``out_cap``. The first chunk makes the
    accumulators and also returns the receive counts and the overflow
    flag (capacities, and learned ranges the values outgrew), both
    functions of ``smat``; the last widens and trims them."""
    # across processes: the local workers' rows [b, b + Wl) of the W
    mex = current_mex()
    Wl, cap = sdest.shape
    W = smat.shape[0]
    b = mex.worker_base if mex is not None else 0
    dev = sdest.device
    M_j = hi - lo
    S = smat.to(torch.int64)
    off = _ex_cumsum(S, 1)[b:b + Wl]                       # [src, dst]
    roff = _ex_cumsum(S.T, 1)[b:b + Wl]                    # [dst, src]
    d = sdest
    dc = d.clamp(0, W - 1)
    slot = torch.arange(cap, device=dev)[None, :] - torch.gather(off, 1, dc)
    sel = (d < W) & (slot >= lo) & (slot < hi)
    send_idx = scatter_slots(dc * M_j + (slot - lo), sel, W * M_j)
    # receiver r's rows from sender s: j < S[s, r] - lo of this chunk
    j = torch.arange(M_j, device=dev)
    n_from = (S.T[b:b + Wl] - lo).clamp(0, M_j)            # [dst, src]
    pos = roff[:, :, None] + lo + j[None, None, :]         # [dst, src, M_j]
    keep = (j[None, None, :] < n_from[:, :, None]) & (pos < out_cap)
    dump = out_cap + torch.arange(W, device=dev)[:, None] * M_c + j[None, :]
    pos = torch.where(keep, pos, dump[None, :, :])
    region = out_cap + W * M_c
    flat_pos = (pos + torch.arange(Wl, device=dev)[:, None, None] * region
                ).reshape(-1)
    range_bad = torch.zeros((), dtype=torch.bool, device=dev)
    outs = []
    for li, l in enumerate(leaves):
        trail = tuple(l.shape[2:])
        nd = narrow[li] if narrow is not None else None
        x = l
        if nd is not None:
            if first:
                info = np.iinfo(np.dtype(nd))
                vm = (d < W).reshape((Wl, cap) + (1,) * len(trail))
                range_bad = range_bad | (vm & ((x < info.min)
                                               | (x > info.max))).any()
            x = _to_narrow(x, nd)
        per = W * M_j + cap
        buf = torch.zeros((Wl * per,) + trail, dtype=x.dtype, device=dev)
        buf.index_put_((send_idx,), x.reshape((-1,) + trail))
        blocks = buf.reshape((Wl, per) + trail)[:, :W * M_j].reshape(
            (Wl, W, M_j) + trail)                     # [src, dst, M_j]
        recv = (mex.worker_transpose(blocks) if mex is not None
                else blocks.transpose(0, 1)).reshape((-1,) + trail)
        if first:
            acc = torch.zeros((Wl * region,) + trail, dtype=x.dtype,
                              device=dev)
        else:
            acc = accs[li]
        if in_place:
            acc.index_put_((flat_pos,), recv)
        else:
            acc = acc.index_put((flat_pos,), recv)
        if last:
            y = acc.reshape((Wl, region) + trail)[:, :out_cap]
            if nd is not None:
                y = _from_narrow(y, nd, l.dtype)
            outs.append(y.contiguous())
        else:
            outs.append(acc)
    if not first:
        return outs
    if narrow is not None and mex is not None and mex.multiprocess:
        # a learned range any process's rows outgrew: every process's
        # verdict, so every process heals or none does
        range_bad = worker_max(range_bad.reshape(1, 1).to(torch.int32),
                               mex).reshape(()) > 0
    counts = S.sum(dim=0)
    ovf = (S.max() > M_pad) | (counts.max() > out_cap) | range_bad
    return counts[b:b + Wl], ovf.reshape(1), outs


_CHUNK_DEFAULT = 4
_CHUNK_MIN_BYTES = 1 << 20
# every Nth use of a cached capacity plan takes the synced path, so a
# site whose data became skewed regains the 1-factor plan
_CAP_RESYNC_EVERY = 32


def chunk_policy(W: int, M_pad: int, item_bytes: int,
                 platform: str = "cpu", inadmissible=None) -> int:
    """Phase-B chunks: 1 with overlap off, THRILL_TPU_XCHG_CHUNKS when
    pinned, else 4 for volumes worth pipelining (one shared policy for
    the planner and the planner-off path). On the card all W workers
    share one device and no collective runs, so there is nothing to
    overlap: every chunk scatters every input row once more, and chunks
    pay only where the bulk phase B's buffers (``2 W^2 M_pad`` rows)
    cannot fit under the HBM budget (``inadmissible``; TeraSort's
    generic path peaked 4.65 GB at K = 1 against 3.05 GB at K = 4)."""
    if not overlap_enabled():
        return 1
    env = os.environ.get("THRILL_TPU_XCHG_CHUNKS")
    if env:
        try:
            return max(1, min(int(env), M_pad))
        except ValueError:
            pass
    if W * M_pad * item_bytes < _CHUNK_MIN_BYTES:
        return 1
    if platform == "cuda" and not (
            inadmissible is not None
            and inadmissible(2 * W * W * M_pad * item_bytes)):
        return 1
    return max(1, min(_CHUNK_DEFAULT, M_pad))


def _chunk_count(mex: MeshExec, W: int, M_pad: int,
                 item_bytes: int) -> int:
    if mex.multiprocess:
        # the volume rule alone: every process must make as many chunk
        # dispatches, each one all-to-all, whatever its own HBM budget
        return chunk_policy(W, M_pad, item_bytes, mex.device.type, None)
    pl = _planner_of(mex)
    if pl is not None:
        return pl.chunk_count(W, M_pad, item_bytes)
    pres = mex.pressure
    return chunk_policy(W, M_pad, item_bytes, mex.device.type,
                        pres.inadmissible if pres is not None else None)


def _dispatch_chunked(mex: MeshExec, treedef, sorted_dest, sorted_leaves,
                      smat: torch.Tensor, M_pad: int, out_cap: int,
                      narrow=None, ident: Tuple = ()):
    """The dense phase B as K chunk dispatches (:func:`_chunk_prog`).
    Returns (out leaves, receive counts on the device, flag)."""
    W = mex.num_workers
    cap = sorted_dest.shape[1]
    sig = _leaf_sig(sorted_leaves)
    item_bytes = leaf_item_bytes(sorted_leaves)
    K = _chunk_count(mex, W, M_pad, item_bytes)
    led = _decisions.ledger_of(mex)
    if led is not None:
        site = _site(ident)
        env_k = os.environ.get("THRILL_TPU_XCHG_CHUNKS")
        try:
            int(env_k)
            pinned = True
        except (TypeError, ValueError):
            pinned = False
        vol = W * M_pad * item_bytes
        led.record(
            "xchg_chunks", site, str(K), predicted=vol,
            reason=("bulk: overlap off" if not overlap_enabled()
                    else "forced" if pinned
                    else "bulk: volume below pipelining break-even"
                    if K == 1 and vol < _CHUNK_MIN_BYTES
                    else "bulk: one device, nothing to overlap" if K == 1
                    else "chunked: volume worth pipelining"))
        if narrow is not None:
            led.record(
                "xchg_narrow", site, "narrow",
                predicted=W * (W - 1) * M_pad
                * _narrow_item_bytes(sorted_leaves, narrow),
                rejected=[("wide", W * (W - 1) * M_pad * item_bytes)],
                reason="learned integer ranges fit narrower dtypes",
                leaves=sum(1 for s in narrow if s is not None))
    bounds = dense_range_bounds(M_pad, K)
    ranges = [(int(bounds[j]), int(bounds[j + 1])) for j in range(K)
              if bounds[j + 1] > bounds[j]]
    M_c = max(hi - lo for lo, hi in ranges)
    armed = faults.REGISTRY.active()
    # a loop capture rejects an in-place update of a program argument:
    # under one the accumulators are copied from chunk to chunk
    in_place = mex.loop_recorder is None
    counts_dev = flag = None
    accs: Optional[List] = None
    with span_of(mex.tracer, "exchange", "phase_b", chunks=len(ranges),
                 narrowed=narrow is not None or None):
        for j, (lo, hi) in enumerate(ranges):
            first, last = j == 0, j == len(ranges) - 1
            prog = mex.program(("xchg_chunk", cap, M_pad, out_cap, lo, hi,
                                first, last, W, treedef, sig, narrow),
                               _chunk_prog)
            if armed:
                default_policy().run(
                    lambda j=j: faults.check(_F_CHUNK, chunk=j,
                                             chunks=len(ranges)),
                    what="xchg.chunk")
            out = prog(sorted_dest, smat, sorted_leaves, accs, M_pad,
                       out_cap, lo, hi, M_c, narrow, first, last, in_place)
            if first:
                counts_dev, flag, accs = out
            else:
                accs = out
    mex.stats_padded_rows += W * M_pad
    wire_rows = W * (W - 1) * M_pad
    mex.stats_bytes_wire_device += wire_rows * _narrow_item_bytes(
        sorted_leaves, narrow)
    mex.stats_bytes_wire_device_raw += wire_rows * item_bytes
    return accs, counts_dev, flag


def _round_blocks(blocks: torch.Tensor, to: np.ndarray) -> torch.Tensor:
    """One round of the pairwise schedule: ``blocks`` ``[W_local, M,
    ...]`` holds local sender ``w``'s block bound for worker ``to[w]``
    (``to`` the round's global permutation); the result ``[W_local, M,
    ...]`` holds each local receiver's block from the worker that sends
    to it. One process: a gather of the worker dimension. Several: the
    local senders' blocks ordered by receiving process, one
    :meth:`MeshExec.exchange_rows`, and the received blocks (every
    process's senders in rank order) ordered by receiver."""
    to = np.asarray(to, dtype=np.int64)
    W = len(to)
    inv = np.empty(W, dtype=np.int64)
    inv[to] = np.arange(W)
    mex = current_mex()
    dev = blocks.device
    if mex is None or not mex.multiprocess:
        return blocks[torch.as_tensor(inv, device=dev)]
    P, Wl, b, me = (mex.num_processes, mex.num_local, mex.worker_base,
                    mex.process_index)
    M = blocks.shape[1]
    trail = tuple(blocks.shape[2:])
    dst_proc = to // Wl
    order = np.argsort(dst_proc[b:b + Wl], kind="stable")
    send = np.bincount(dst_proc[b:b + Wl], minlength=P) * M
    # the senders whose partner is local here, in rank order: the order
    # the received blocks come in
    senders = np.flatnonzero(dst_proc == me)
    recv = np.bincount(senders // Wl, minlength=P) * M
    rank_of = {int(s): k for k, s in enumerate(senders)}
    recv_order = [rank_of[int(inv[b + v])] for v in range(Wl)]
    x = blocks if np.array_equal(order, np.arange(Wl)) else \
        blocks[torch.as_tensor(order, device=dev)]
    y = mex.exchange_rows(x.reshape((Wl * M,) + trail), send.tolist(),
                          recv.tolist()).reshape((Wl, M) + trail)
    if recv_order == list(range(Wl)):
        return y
    return y[torch.as_tensor(recv_order, device=dev)]


def _onefactor_prog(sdest: torch.Tensor, srow: torch.Tensor,
                    leaves: List[torch.Tensor], rounds: Tuple,
                    M_rounds: Tuple[int, ...], out_cap: int, narrow):
    """Program: the 1-factor exchange. The identity round copies each
    worker's own rows; round ``r`` ships worker ``w``'s rows bound for
    ``rounds[r][w]`` in a block padded to that round's pair maximum
    (:func:`_round_blocks`), and the partner writes them at the dense
    plan's positions. Across processes the local workers' rows ``[b, b
    + W_local)`` of the W; every process runs every round."""
    mex = current_mex()
    Wl, cap = sdest.shape
    W = srow.shape[0]
    b = mex.worker_base if mex is not None else 0
    dev = sdest.device
    S = srow.to(torch.int64)
    off = _ex_cumsum(S, 1)[b:b + Wl]                       # [src, dst]
    roff = _ex_cumsum(S.T, 1)[b:b + Wl]                    # [dst, src]
    d = sdest
    i = torch.arange(cap, device=dev)[None, :]
    lw = torch.arange(Wl, device=dev)
    gw = lw + b                                  # the local workers' ids
    xs = [l if narrow is None or narrow[li] is None
          else _to_narrow(l, narrow[li]) for li, l in enumerate(leaves)]
    region = out_cap + max(cap, max(M_rounds, default=0))
    outs = [torch.zeros((Wl * region,) + tuple(x.shape[2:]), dtype=x.dtype,
                        device=dev) for x in xs]
    base = lw[:, None] * region

    def place(pos, keep, rows):
        dump = out_cap + torch.arange(pos.shape[1], device=dev)[None, :]
        flat = (torch.where(keep & (pos < out_cap), pos, dump) + base
                ).reshape(-1)
        for o, r in zip(outs, rows):
            o.index_put_((flat,), r.reshape((-1,) + tuple(r.shape[2:])))

    # identity round: worker w's rows for itself, no exchange
    slot0 = i - off[lw, gw][:, None]
    place(roff[lw, gw][:, None] + slot0, d == gw[:, None], xs)
    for r, to in enumerate(rounds):
        to = np.asarray(to, dtype=np.int64)
        inv = np.empty(W, dtype=np.int64)
        inv[to] = np.arange(W)
        to_t = torch.as_tensor(to, device=dev)[gw]
        src_t = torch.as_tensor(inv, device=dev)[gw]
        M_r = M_rounds[r]
        sel = d == to_t[:, None]
        slot = i - off[lw, to_t][:, None]
        send = scatter_slots(slot, sel & (slot < M_r), M_r)
        blocks = []
        for x in xs:
            trail = tuple(x.shape[2:])
            per = M_r + cap
            buf = torch.zeros((Wl * per,) + trail, dtype=x.dtype, device=dev)
            buf.index_put_((send,), x.reshape((-1,) + trail))
            blocks.append(_round_blocks(
                buf.reshape((Wl, per) + trail)[:, :M_r], to))
        jj = torch.arange(M_r, device=dev)[None, :]
        n_recv = S[src_t, gw][:, None]
        pos = roff[lw, src_t][:, None] + jj
        place(pos, jj < n_recv, blocks)
    res = []
    for li, (o, l) in enumerate(zip(outs, leaves)):
        y = o.reshape((Wl, region) + tuple(o.shape[1:]))[:, :out_cap]
        if narrow is not None and narrow[li] is not None:
            y = _from_narrow(y, narrow[li], l.dtype)
        res.append(y.contiguous())
    return res


def _exchange_onefactor(mex: MeshExec, treedef, sorted_dest, sorted_leaves,
                        S: np.ndarray, min_cap: int = 1,
                        ident: Tuple = (), narrow=None) -> DeviceShards:
    """The skew-proof exchange (reference: 1-factor scheduling,
    thrill/net/group.hpp:90-107): W - 1 rounds, each padded to its own
    pair maximum, so bytes follow the data under a hot key."""
    W = mex.num_workers
    cap = sorted_dest.shape[1]
    R = S.sum(axis=0)
    rounds = one_factor_rounds(mex)
    cap_ident = ("xchg_of_caps", ident, cap, treedef,
                 _leaf_sig(sorted_leaves))
    needed = tuple(max(int(S[np.arange(W), to].max()), 1)
                   for to in rounds) + (max(int(R.max()), min_cap, 1),)
    caps = _sticky_caps(mex, cap_ident, needed)
    M_rounds, out_cap = caps[:-1], caps[-1]
    mex.stats_padded_rows += sum(M_rounds)
    of_rows = W * sum(M_rounds)
    mex.stats_bytes_wire_device += of_rows * _narrow_item_bytes(
        sorted_leaves, narrow)
    mex.stats_bytes_wire_device_raw += of_rows * leaf_item_bytes(
        sorted_leaves)
    rounds_key = tuple(tuple(int(x) for x in to) for to in rounds)
    prog = mex.program(("xchg_of", cap, M_rounds, out_cap, treedef, narrow,
                        _leaf_sig(sorted_leaves)), _onefactor_prog)
    srow = mex.put_small(S.astype(np.int32))
    out = prog(sorted_dest, srow, sorted_leaves, rounds_key, M_rounds,
               out_cap, narrow)
    return DeviceShards(mex, pt.unflatten(treedef, out),
                        mex.local(R.astype(np.int64)))


def _ragged_prog(sdest: torch.Tensor, srow: torch.Tensor,
                 landing: torch.Tensor, leaves: List[torch.Tensor],
                 out_cap: int, narrow):
    """Program: the ragged exchange on one card, one scatter a leaf
    straight into the receivers' rows. Row ``i`` of sender ``s``, bound
    for ``d``, lands at row ``landing[s, d] + i - off[s, d]`` of receiver
    ``d`` (``off`` the exclusive prefix of ``s``'s send row): each
    receiver's rows by sender in rank order, each run in its sender's
    order, as the dense path. The senders' runs partition every
    receiver's rows, so no slot is written twice; an invalid row goes to
    a dump slot of its own past the ``W * out_cap`` rows."""
    W, cap = sdest.shape
    dev = sdest.device
    S = srow.to(torch.int64)
    off = _ex_cumsum(S, 1)                                 # [src, dst]
    d = sdest.to(torch.int64)
    dc = d.clamp(0, W - 1)
    i = torch.arange(cap, device=dev)[None, :]
    pos = torch.gather(landing.to(torch.int64), 1, dc) + i - torch.gather(
        off, 1, dc)
    dump = W * out_cap + torch.arange(W, device=dev)[:, None] * cap + i
    flat = torch.where((d < W) & (pos < out_cap), dc * out_cap + pos,
                       dump).reshape(-1)
    outs = []
    for li, l in enumerate(leaves):
        trail = tuple(l.shape[2:])
        nd = narrow[li] if narrow is not None else None
        x = _to_narrow(l, nd) if nd is not None else l
        buf = torch.zeros((W * (out_cap + cap),) + trail, dtype=x.dtype,
                          device=dev)
        buf.index_put_((flat,), x.reshape((-1,) + trail))
        y = buf[:W * out_cap].reshape((W, out_cap) + trail)
        if nd is not None:
            y = _from_narrow(y, nd, l.dtype)
        outs.append(y.contiguous())
    return outs


def _ragged_mp_prog(sdest: torch.Tensor, srow: torch.Tensor,
                    landing: torch.Tensor, leaves: List[torch.Tensor],
                    out_cap: int, narrow, send: Tuple[int, ...],
                    recv: Tuple[int, ...]):
    """Program: the ragged exchange across processes. Each local
    sender's valid rows are packed by receiving process ``q`` (within
    it by sender, then by receiver: the order they lie in, sorted by
    destination) into ``send[q]`` rows, one
    :meth:`MeshExec.exchange_rows` ships them, and each receiver writes
    the rows it got from sender ``s`` at ``landing[s, d] + j``: the
    one-card program's positions, so the result is its result."""
    mex = current_mex()
    P, b = mex.num_processes, mex.worker_base
    Wl, cap = sdest.shape
    W = srow.shape[0]
    dev = sdest.device
    S = srow.to(torch.int64)
    Sl = S[b:b + Wl]                                       # [src, dst]
    d = sdest.to(torch.int64)
    dc = d.clamp(0, W - 1)
    q = dc // Wl                                 # the receiving process
    Sq = Sl.reshape(Wl, P, Wl).sum(2)                      # [src, proc]
    start = (_ex_cumsum(Sq.sum(0), 0)[None, :]
             + _ex_cumsum(Sq, 0))                          # [src, proc]
    off = _ex_cumsum(Sl, 1)
    i = torch.arange(cap, device=dev)[None, :]
    pos = torch.gather(start, 1, q) + i - torch.gather(off, 1, q * Wl)
    n_send, n_recv = sum(send), sum(recv)
    dump = n_send + torch.arange(Wl, device=dev)[:, None] * cap + i
    flat = torch.where(d < W, pos, dump).reshape(-1)
    # the received rows: by sender in rank order, by local receiver,
    # each run in its sender's order
    runs = S[:, b:b + Wl].reshape(-1)                      # [src * dst]
    first = (landing.to(torch.int64)[:, b:b + Wl]
             + torch.arange(Wl, device=dev)[None, :] * out_cap).reshape(-1)
    run = torch.repeat_interleave(torch.arange(runs.numel(), device=dev),
                                  runs, output_size=n_recv)
    rpos = first[run] + torch.arange(n_recv, device=dev) \
        - _ex_cumsum(runs, 0)[run]
    outs = []
    for li, l in enumerate(leaves):
        trail = tuple(l.shape[2:])
        nd = narrow[li] if narrow is not None else None
        x = _to_narrow(l, nd) if nd is not None else l
        buf = torch.zeros((n_send + Wl * cap,) + trail, dtype=x.dtype,
                          device=dev)
        buf.index_put_((flat,), x.reshape((-1,) + trail))
        got = mex.exchange_rows(buf[:n_send], list(send), list(recv))
        y = torch.zeros((Wl * out_cap,) + trail, dtype=x.dtype, device=dev)
        y.index_put_((rpos,), got)
        y = y.reshape((Wl, out_cap) + trail)
        if nd is not None:
            y = _from_narrow(y, nd, l.dtype)
        outs.append(y)
    return outs


def _exchange_ragged(mex: MeshExec, treedef, sorted_dest, sorted_leaves,
                     S: np.ndarray, min_cap: int = 1,
                     narrow=None) -> DeviceShards:
    """The ragged exchange (reference: ``lax.ragged_all_to_all``): no
    per-pair padding, so the bytes counted are the off-diagonal items
    (narrowed on ``bytes_wire_device``, full width on ``_raw``). The
    output capacity is the power of two of the largest receive count,
    not sticky, as the reference's. Across processes
    :func:`_ragged_mp_prog`, whose split sizes come from the global
    ``S``."""
    R = S.sum(axis=0)
    ragged_items = int(S.sum()) - int(np.trace(S))
    mex.stats_bytes_wire_device += ragged_items * _narrow_item_bytes(
        sorted_leaves, narrow)
    mex.stats_bytes_wire_device_raw += ragged_items * leaf_item_bytes(
        sorted_leaves)
    out_cap = round_up_pow2(max(int(R.max()), min_cap, 1))
    # landing[s, d]: rows of senders before s at receiver d
    landing = np.cumsum(S, axis=0) - S
    srow = mex.put_small(S.astype(np.int64))
    land = mex.put_small(landing.astype(np.int64))
    if mex.multiprocess:
        P, Wl, b = mex.num_processes, mex.num_local, mex.worker_base
        send = tuple(int(n) for n in
                     S[b:b + Wl].reshape(Wl, P, Wl).sum(axis=(0, 2)))
        recv = tuple(int(n) for n in
                     S[:, b:b + Wl].reshape(P, Wl, Wl).sum(axis=(1, 2)))
        prog = mex.program(("xchg_ragged_mp", out_cap, treedef, narrow,
                            _leaf_sig(sorted_leaves)), _ragged_mp_prog)
        out = prog(sorted_dest, srow, land, sorted_leaves, out_cap, narrow,
                   send, recv)
    else:
        prog = mex.program(("xchg_ragged", out_cap, treedef, narrow,
                            _leaf_sig(sorted_leaves)), _ragged_prog)
        out = prog(sorted_dest, srow, land, sorted_leaves, out_cap, narrow)
    return DeviceShards(mex, pt.unflatten(treedef, out),
                        mex.local(R.astype(np.int64)))


def _stream_round_prog(sdest: torch.Tensor, srow: torch.Tensor,
                       leaves: List[torch.Tensor], r: int, M_r: int):
    """Program: round ``r`` of the streamed exchange (the schedule of
    :func:`one_factor_rounds`; 0 the identity round). Worker ``w`` sends
    its rows bound for ``(w + r) % W`` in a block of ``M_r`` rows, zeros
    past them, and receives the block of ``(w - r) % W``
    (:func:`_round_blocks`; across processes the local workers')."""
    mex = current_mex()
    Wl, cap = sdest.shape
    W = srow.shape[0]
    b = mex.worker_base if mex is not None else 0
    dev = sdest.device
    S = srow.to(torch.int64)
    off = _ex_cumsum(S, 1)[b:b + Wl]
    lw = torch.arange(Wl, device=dev)
    d_r = (lw + b + r) % W
    slot = torch.arange(cap, device=dev)[None, :] - off[lw, d_r][:, None]
    sel = sdest.to(torch.int64) == d_r[:, None]
    send = scatter_slots(slot, sel & (slot < M_r), M_r)
    to = (np.arange(W) + r) % W
    outs = []
    for x in leaves:
        trail = tuple(x.shape[2:])
        buf = torch.zeros((Wl * (M_r + cap),) + trail, dtype=x.dtype,
                          device=dev)
        buf.index_put_((send,), x.reshape((-1,) + trail))
        blocks = buf.reshape((Wl, M_r + cap) + trail)[:, :M_r]
        outs.append((blocks if r == 0 else _round_blocks(blocks, to))
                    .contiguous())
    return outs


def exchange_stream(shards: DeviceShards, dest_builder: Callable,
                    cache_key: Tuple):
    """Yield the received rows round by round instead of one compacted
    shard (reference: MixStream, thrill/data/mix_stream.hpp:126): the
    identity round first, then the 1-factor schedule, one program a
    round, each yielded as its own ``DeviceShards`` with host counts, so
    the consumer folds one while the next is queued. No rank-order
    guarantee. The plan syncs the host send matrix (per-round capacities
    need it), and rounds ship full width: no range analysis. Across
    processes each round is one exchange of the round's blocks on every
    process, and each yield holds the local receivers' rows."""
    mex = shards.mesh_exec
    W = mex.num_workers
    treedef, sorted_dest, sorted_leaves, send_mat, _ = _phase_a(
        shards, dest_builder, cache_key, want_ranges=False)
    S = _plan_sync(mex, send_mat)
    item_bytes = leaf_item_bytes(sorted_leaves)
    account_traffic(mex, S, item_bytes, site=_site(cache_key))
    cap = sorted_dest.shape[1]
    if W == 1:
        yield DeviceShards(mex, pt.unflatten(treedef, sorted_leaves),
                           np.diag(S).astype(np.int64).copy())
        return
    widx = np.arange(mex.worker_base, mex.worker_base + mex.num_local)
    count_plan_build(mex)
    led = _decisions.ledger_of(mex)
    if led is not None:
        rec = led.record("xchg_strategy", _site(cache_key), "stream",
                         reason="MixStream delivery requested",
                         items=int(S.sum()))
        led.resolve(rec, (int(S.sum()) - int(np.trace(S))) * item_bytes)
    rounds = one_factor_rounds(mex)
    cap_ident = ("xchg_stream_caps", cache_key, cap, treedef,
                 _leaf_sig(sorted_leaves))
    needed = (max(int(np.diag(S).max()), 1),) + tuple(
        max(int(S[np.arange(W), to].max()), 1) for to in rounds)
    caps = _sticky_caps(mex, cap_ident, needed, pow2_out=False)
    mex.stats_padded_rows += sum(caps)
    # the identity round is a local copy; the rounds after it cross
    stream_bytes = W * sum(caps[1:]) * item_bytes
    mex.stats_bytes_wire_device += stream_bytes
    mex.stats_bytes_wire_device_raw += stream_bytes
    srow = mex.put_small(S.astype(np.int32))
    sig = _leaf_sig(sorted_leaves)
    for r in range(W):
        prog = mex.program(("xchg_stream_round", cap, caps[r], r, treedef,
                            sig), _stream_round_prog)
        out = prog(sorted_dest, srow, sorted_leaves, r, caps[r])
        # receiver w's rows came from (w - r) % W
        yield DeviceShards(mex, pt.unflatten(treedef, out),
                           S[(widx - r) % W, widx].astype(np.int64))


def _dense_cap_ident(ident: Tuple, cap: int, treedef,
                     sorted_leaves) -> Tuple:
    """The capacity-plan cache's key for the dense plan: per call site,
    so two unrelated exchanges of one shape keep their own capacities."""
    return ("xchg_caps", ident, cap, treedef, _leaf_sig(sorted_leaves))


def _exchange_planned(mex: MeshExec, treedef, sorted_dest, sorted_leaves,
                      S: np.ndarray, min_cap: int = 1, ident: Tuple = (),
                      smat_dev: Optional[torch.Tensor] = None,
                      ranges: Optional[np.ndarray] = None
                      ) -> DeviceShards:
    """Plan and phase B from the host send matrix ``S``. ``smat_dev`` is
    its device copy when phase A made one; ``ranges`` the fetched leaf
    ranges when phase A computed them."""
    W = mex.num_workers
    cap = sorted_dest.shape[1]
    R = S.sum(axis=0)
    # the local receivers' counts (every worker's in one process)
    new_counts = R.astype(np.int64)[mex.worker_base:
                                    mex.worker_base + mex.num_local]
    item_bytes = leaf_item_bytes(sorted_leaves)
    account_traffic(mex, S, item_bytes, site=_site(ident))
    if W == 1:
        # no movement: the rows are sorted by destination, valid first
        return DeviceShards(mex, pt.unflatten(treedef, sorted_leaves),
                            new_counts)
    count_plan_build(mex)
    cap_ident = _dense_cap_ident(ident, cap, treedef, sorted_leaves)
    mode = resolve_mode(mex)
    dense_b, of_b, n_rounds = _strategy_costs(mex, S, item_bytes)
    pl = _planner_of(mex)
    if pl is not None:
        chosen_mode, _, _, _ = pl.exchange_strategy(S, item_bytes, mode)
        skew = mode == "dense" and chosen_mode == "onefactor"
    else:
        skew = mode == "dense" and _skewed(S, item_bytes, mex)
    led = _decisions.ledger_of(mex)
    if led is not None:
        if mode == "ragged":
            chosen, pred, rej, why = "ragged", (
                (int(S.sum()) - int(np.trace(S))) * item_bytes), \
                [("dense", dense_b)], "configured mode"
        elif mode == "onefactor" or skew:
            chosen, pred, rej = "onefactor", of_b, [("dense", dense_b)]
            why = "skewed send matrix" if skew else "configured mode"
        else:
            chosen, pred, rej = "dense", dense_b, [("onefactor", of_b)]
            why = ("one card: the workers share one device"
                   if _one_card(mex) else "balanced send matrix")
        rec = led.record("xchg_strategy", _site(ident), chosen,
                         predicted=pred, rejected=rej, reason=why,
                         items=int(S.sum()))
        led.resolve(rec, (int(S.sum()) - int(np.trace(S))) * item_bytes)
    # one narrow spec for every phase-B flavor, keyed by the dense
    # capacity identity; a synced plan unions this exchange's ranges in,
    # so the spec covers its data by construction
    narrow = _pack_degraded(_spec_from_ranges(
        mex, cap_ident, sorted_leaves, _narrowable_leaves(sorted_leaves),
        ranges))
    plans = getattr(mex, "_xchg_plan", None)
    if plans is None:
        plans = mex._xchg_plan = {}
    with span_of(mex.tracer, "exchange", "synced", mode=mode):
        if mode == "ragged":
            plans[cap_ident] = "sync"
            return _exchange_ragged(mex, treedef, sorted_dest,
                                    sorted_leaves, S, min_cap,
                                    narrow=narrow)
        if mode == "onefactor" or skew:
            # a skew-flipped site stays synced: the choice needs the
            # host S
            plans[cap_ident] = "sync"
            return _exchange_onefactor(mex, treedef, sorted_dest,
                                       sorted_leaves, S, min_cap,
                                       ident=ident, narrow=narrow)
        M_pad, out_cap = _sticky_caps(
            mex, cap_ident, (max(int(S.max()), 1),
                             max(int(R.max()), min_cap, 1)))
        plans[cap_ident] = "dense"
        # across processes phase A's device matrix holds the local rows
        smat = (smat_dev if smat_dev is not None and not mex.multiprocess
                else mex.put_small(S.astype(np.int32)))
        out, _, _ = _dispatch_chunked(mex, treedef, sorted_dest,
                                      sorted_leaves, smat, M_pad, out_cap,
                                      narrow=narrow, ident=ident)
        return DeviceShards(mex, pt.unflatten(treedef, out), new_counts)


def _optimistic_ok(mex: MeshExec, cap_ident: Tuple, min_cap: int,
                   ident: Tuple = (),
                   counts=None) -> Optional[Tuple[int, int]]:
    """The cached (M_pad, out_cap) when this site may run phase B with
    no host read of the send matrix, else None: the switches are on, no
    loop capture is recording (a capture keeps the synced plan, so tapes
    bake the plan they always did), the site's last synced plan was
    dense and its capacities are cached. With a planner, a site marked
    for re-optimization or host-known ``counts`` that prove the cached
    capacities cannot hold re-plan synced from current data. Every
    ``_CAP_RESYNC_EVERY``-th use re-syncs anyway. Across processes every
    input of the verdict is global (the caller passes no local counts),
    and seeds of unattested provenance keep the synced plan
    (:func:`install_plan_seeds`)."""
    if not cap_cache_enabled() or mex.loop_recorder is not None:
        return None
    if mex.multiprocess and not getattr(mex, "_plan_seed_symmetric", True):
        return None
    if resolve_mode(mex) != "dense":
        return None
    plans = getattr(mex, "_xchg_plan", None)
    if plans is None:
        plans = mex._xchg_plan = {}
    kind = plans.get(cap_ident)
    if kind is None:
        kind = plan_seed(mex, "plan", cap_ident)
        if kind is not None:
            kind = plans[cap_ident] = str(kind)
    if kind != "dense":
        return None
    cache = getattr(mex, "_sticky_caps", None)
    if cache is None:
        cache = mex._sticky_caps = {}
    seeded = False
    caps = cache.get(cap_ident)
    if caps is None:
        caps = _seeded_caps(mex, cap_ident)
        if caps is not None:
            cache[cap_ident] = caps
            seeded = True
    if not caps or len(caps) != 2 or caps[1] < min_cap:
        return None
    pl = _planner_of(mex)
    if pl is not None:
        site = _site(ident)
        if seeded:
            pl.note_seeded(site)
        ok, why = pl.optimistic_verdict(site, caps, counts,
                                        mex.num_workers)
        if not ok:
            # drop the learned state the lie lives in, so the synced
            # plan ratchets from the current data
            cache.pop(cap_ident, None)
            getattr(mex, "_sticky_ranges", {}).pop(cap_ident, None)
            pl.note_switch()
            need = None
            if counts is not None:
                need = -(-int(np.asarray(counts).sum())
                         // max(mex.num_workers, 1))
            pl.record_replan(
                _decisions.ledger_of(mex), site, "synced",
                predicted=need, rejected=[("optimistic", float(caps[1]))],
                reason=why, unit="rows")
            faults.note("recovery", what="planner.replan", site=site,
                        why=why[:120], _quiet=True)
            return None
    uses = getattr(mex, "_xchg_plan_uses", None)
    if uses is None:
        uses = mex._xchg_plan_uses = {}
    n = uses.get(cap_ident, 0) + 1
    uses[cap_ident] = n
    if n % _CAP_RESYNC_EVERY == 0:
        return None
    return caps


def _governor_of(mex):
    pres = mex.pressure
    return getattr(pres, "governor", None) if pres is not None else None


def _exchange_optimistic(mex: MeshExec, treedef, sorted_dest,
                         sorted_leaves, send_mat: torch.Tensor,
                         caps: Tuple[int, int], ident: Tuple,
                         min_cap: int = 1,
                         range_mat: Optional[torch.Tensor] = None
                         ) -> DeviceShards:
    """Phase B on the cached capacity plan: no host read, counts on the
    device, and a deferred check (drained before the next host fetch or
    by the next consumer) that the plan held. A miss re-runs the synced
    plan from the retained phase-A output and heals the shards in place.
    The retained rows are counted in the HBM governor's ledger until the
    check has run. Across processes phase B reads the global send matrix
    gathered on the device (no host read), so the flag is the same on
    every process and the check needs no collective unless it heals."""
    M_pad, out_cap = caps
    cap = sorted_dest.shape[1]
    # the global [W, W] matrix (phase A's own in one process)
    send_mat = mex.gather_workers(send_mat)
    item_bytes = leaf_item_bytes(sorted_leaves)
    cap_ident = _dense_cap_ident(ident, cap, treedef, sorted_leaves)
    narrow = None
    if range_mat is not None:
        narrow = _pack_degraded(_sticky_spec(mex, cap_ident, sorted_leaves))
    dec = _decisions.record_of(
        mex, "xchg_optimistic", _site(ident), "optimistic",
        predicted=out_cap, rejected=[("synced", None)], unit="rows",
        reason="capacity plan cached; host sync elided", m_pad=M_pad)
    with span_of(mex.tracer, "exchange", "optimistic", m_pad=M_pad,
                 out_cap=out_cap):
        out_leaves, counts_dev, flag = _dispatch_chunked(
            mex, treedef, sorted_dest, sorted_leaves, send_mat, M_pad,
            out_cap, narrow=narrow, ident=ident)
    shards = DeviceShards(mex, pt.unflatten(treedef, out_leaves),
                          counts_dev)
    gov = _governor_of(mex)
    held = [0]
    if gov is not None:
        held[0] = sum(t.numel() * t.element_size()
                      for t in [sorted_dest, send_mat, *sorted_leaves])
        gov.mem.add(held[0])

    def release():
        if held[0]:
            gov.mem.subtract(held[0])
            held[0] = 0

    def check(counts: np.ndarray):
        doc = mex.doctor
        t0 = time.perf_counter() if doc is not None else 0.0
        overflowed = bool(mex._fetch_raw(flag).reshape(-1)[0])
        S = mex._fetch_raw(send_mat).astype(np.int64)
        if doc is not None:
            doc.record_wait("xchg.deferred_check", None,
                            time.perf_counter() - t0, lane="exchange")
        # the verdict, once the flag has been read
        instant_of(mex.tracer, "exchange",
                   "capacity_miss" if overflowed else "cap_hit",
                   m_pad=M_pad, out_cap=out_cap)
        _decisions.resolve_of(mex, dec, max(int(S.sum(axis=0).max()), 1),
                              verdict="miss" if overflowed else "hit")
        if not overflowed:
            release()
            # counted here: a miss counts the one synced exchange only
            mex.stats_cap_cache_hits += 1
            mex.stats_exchanges_overlapped += 1
            account_traffic(mex, S, item_bytes, site=_site(ident),
                            overlapped=True, cap_hit=True)
            pl = _planner_of(mex)
            if pl is not None and pl.skew_developed(S, item_bytes):
                pl.mark_replan(_site(ident), "deferred check observed a "
                                             "skewed send matrix")
            return None
        mex.stats_cap_cache_misses += 1
        faults.note("recovery", what="xchg.capacity_miss",
                    cached=(M_pad, out_cap))
        ranges = fetch_ranges(mex, range_mat)
        healed = _exchange_planned(mex, treedef, sorted_dest, sorted_leaves,
                                   S, min_cap=min_cap, ident=ident,
                                   smat_dev=send_mat, ranges=ranges)
        release()
        shards.tree = healed.tree
        return healed.counts

    shards._counts_check = check
    if held[0]:
        weakref.finalize(shards, release)
    # the backstop: any counted fetch heals an exchange whose output a
    # pipeline dropped unread; a weak reference, so the queue pins no
    # device memory
    ref = weakref.ref(shards)

    def backstop():
        s = ref()
        if s is not None:
            s.validate_pending()

    mex._pending_checks.append(backstop)
    return shards


def _plan_sync(mex: MeshExec, send_mat: torch.Tensor) -> np.ndarray:
    """The exchange barrier: phase A's send matrix read on the host (a
    counted fetch). The doctor charges the blocked time to
    ``xchg.plan_sync``: on the card, the host waiting for the device's
    queue to reach the read."""
    doc = mex.doctor
    t0 = time.perf_counter() if doc is not None else 0.0
    S = mex.fetch_global(send_mat).astype(np.int64)
    if doc is not None:
        doc.record_wait("xchg.plan_sync", None, time.perf_counter() - t0,
                        lane="exchange")
    return S


def exchange(shards: DeviceShards, dest_builder: Callable,
             cache_key: Tuple = (), min_cap: int = 1) -> DeviceShards:
    """Move every valid item to the worker ``dest_builder`` names.

    ``dest_builder(tree, mask, widx)`` sees the ``[W, cap, ...]`` leaves,
    the ``[W, cap]`` valid mask and the ``[W, 1]`` worker indices and
    returns ``[W, cap]`` destinations; invalid rows are dropped and
    valid ones clipped to ``[0, W)``. ``cache_key`` names the call site
    (its destination function and static parameters): the key of its
    capacity plan. Receivers keep their senders' runs in rank order,
    each run in its sender's order. Rows past a count are zeros. Once
    the site has a cached dense plan, phase B runs with no host read
    (see the module); else the send matrix is read once on the host.
    """
    mex = shards.mesh_exec
    td, sorted_dest, sorted_leaves, send_mat, range_mat = _phase_a(
        shards, dest_builder, cache_key,
        want_ranges=mex.loop_recorder is None)
    if mex.num_workers > 1:
        cap = sorted_dest.shape[1]
        cap_ident = _dense_cap_ident(cache_key, cap, td, sorted_leaves)
        # a process's own counts would make its verdict its own
        caps = _optimistic_ok(mex, cap_ident, min_cap, ident=cache_key,
                              counts=None if mex.multiprocess
                              else shards._counts_host)
        if caps is not None:
            return _exchange_optimistic(
                mex, td, sorted_dest, sorted_leaves, send_mat, caps,
                ident=cache_key, min_cap=min_cap, range_mat=range_mat)
    S = _plan_sync(mex, send_mat)
    # the tiny range matrix rides the same host read (uncounted)
    ranges = fetch_ranges(mex, range_mat)
    return _exchange_planned(mex, td, sorted_dest, sorted_leaves, S,
                             min_cap=min_cap, ident=cache_key,
                             smat_dev=send_mat, ranges=ranges)


def exchange_presorted(mex: MeshExec, treedef, dest: torch.Tensor,
                       leaves: Sequence[torch.Tensor], S: np.ndarray,
                       min_cap: int = 1, ident: Tuple = (),
                       ranges: Optional[np.ndarray] = None
                       ) -> DeviceShards:
    """Ship rows already grouped by destination: ``dest`` ``[W, cap]``
    holds each worker's valid rows contiguous per destination in rank
    order (monotone suffices) and ``W`` for invalid rows, ``leaves`` are
    in that order and ``S`` is the host send matrix. Operators whose
    upstream order makes destinations monotone (Sort, Merge) skip the
    destination sort. ``ranges`` (``[L, 2]`` over
    :func:`presorted_range_leaves`) opts into phase-B narrowing."""
    return _exchange_planned(mex, treedef, dest, list(leaves), S,
                             min_cap=min_cap, ident=ident, ranges=ranges)


# ----------------------------------------------------------------------
# the Sort's fused ship-and-merge
# ----------------------------------------------------------------------

def send_slot_index(dest: torch.Tensor, S: torch.Tensor, W: int,
                    M_pad: int, cap: int) -> torch.Tensor:
    """Flat scatter index of each item of ``dest`` ``[W, cap]`` into the
    W send buffers of ``W * M_pad`` rows plus ``cap`` dump rows
    (``scatter_slots``): block ``d``, slot ``i - start of d``; an invalid
    item goes to its dump row. ``dest`` must be grouped by destination
    per worker."""
    S = S.to(torch.int64)
    mex = current_mex()
    b = mex.worker_base if mex is not None else 0
    # the local senders' rows of the [W, W] exclusive offsets
    off = (torch.cumsum(S, dim=1) - S)[b:b + dest.shape[0]]
    dc = dest.to(torch.int64).clamp(0, W - 1)
    slot = torch.arange(cap, device=dest.device)[None, :] - torch.gather(
        off, 1, dc)
    return scatter_slots(dc * M_pad + slot, dest < W, W * M_pad)


def ship_blocks(x: torch.Tensor, send_idx: torch.Tensor, W: int,
                M_pad: int) -> torch.Tensor:
    """Scatter each worker's ``[cap, ...]`` rows of ``x`` into ``[W,
    M_pad]`` padded blocks, one per destination, and exchange them: the
    result ``[W, W * M_pad, ...]`` holds for each receiver the blocks of
    its senders in rank order. ``send_idx`` comes from
    :func:`send_slot_index`; no two rows share a slot."""
    trail = tuple(x.shape[2:])
    Wl = x.shape[0]
    per = W * M_pad + x.shape[1]
    buf = torch.zeros((Wl * per,) + trail, dtype=x.dtype, device=x.device)
    buf.index_put_((send_idx,), x.reshape((-1,) + trail))
    blocks = buf.reshape((Wl, per) + trail)[:, :W * M_pad].reshape(
        (Wl, W, M_pad) + trail)                       # [src, dst, M_pad]
    mex = current_mex()
    out = (mex.worker_transpose(blocks) if mex is not None
           else blocks.transpose(0, 1))
    return out.reshape((Wl, W * M_pad) + trail)


def plan_presorted(mex: MeshExec, S: np.ndarray, item_bytes: int,
                   cap_ident: Tuple = ()) -> Tuple[torch.Tensor, int, int]:
    """Plan the shipping of rows already grouped by destination for a
    consumer that ships and merges them in its own program (the Sort's
    fused path, :func:`send_slot_index` and :func:`ship_blocks`). ``S``
    is the host send matrix; ``item_bytes`` counts the traffic in
    ``bytes_moved`` (the reference's fused Sort leaves its padded blocks
    out of ``bytes_wire_device``, and so does this plan); ``cap_ident``
    keys the site's sticky capacities. Returns (the send matrix and its
    transpose on the device, ``M_pad``, the output capacity), as the
    reference's ``srow`` and ``scol``. The plan is built from the synced
    host matrix every time."""
    W = mex.num_workers
    count_plan_build(mex)
    M_pad, out_cap = _sticky_caps(
        mex, cap_ident, (max(int(S.max()), 1),
                         max(int(S.sum(axis=0).max()), 1)), pow2_out=False)
    mex.stats_padded_rows += W * M_pad
    account_traffic(mex, S, item_bytes, site=_site(cap_ident))
    return ((mex.put_small(S), mex.put_small(np.ascontiguousarray(S.T))),
            M_pad, out_cap)
