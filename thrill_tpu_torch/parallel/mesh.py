"""The worker mesh: W virtual workers on one device per process.

Counterpart of the reference package's ``parallel/mesh.py``. Every
worker's shard is one slice of the leading tensor dimension of a
``[W, cap, ...]`` leaf, so a per-worker program is one batched torch op
and an all-to-all between workers is a transpose of the worker
dimension.

A mesh of several processes (reference: ``parallel/mesh.py:403-460``)
splits the W workers into ``num_processes`` equal blocks: process ``p``
owns workers ``[p * W_local, (p + 1) * W_local)`` and holds only their
rows, ``[W_local, cap, ...]`` leaves on its device, with their counts.
Every plan decision reads global numbers, the same on every process:
:meth:`MeshExec.fetch_global` gathers the rows of a fetched per-worker
tensor from every process (the reference's
``multihost_utils.process_allgather``), :meth:`MeshExec.agree` hands
rank 0's value of a learned verdict to all. Inside programs the
cross-process data plane is ``torch.distributed`` over the default
process group (``common/platform.py`` names its backend):
:meth:`MeshExec.worker_transpose` is the all-to-all of the exchange
(``all_to_all_single`` of the padded blocks), :meth:`MeshExec.worker_sum`
the psum over workers (``all_reduce``) and :meth:`MeshExec.gather_workers`
the gather of per-worker rows (``all_gather``), and from the gather
:func:`worker_exscan` (the exclusive scan over the global worker order)
and :func:`worker_shift` (a row to the next worker); :func:`worker_max`
and :func:`worker_min` are the pmax and pmin (``all_reduce`` MAX, MIN);
:meth:`MeshExec.exchange_rows` is the uneven all-to-all of the ragged
exchange and the 1-factor rounds (``all_to_all_single`` with split
sizes from the global send matrix). In one process each is the local
transpose, sum, scan, shift, max, min or the rows themselves; the
four functions take the mesh as an argument and do the local op when it is
None. Each collective reports its edge to a loop capture
(``common/taint.py``): what another process sent arrives through no
aten op the capture sees. ``stats_collectives``
counts the collectives and ``stats_bytes_cross`` the bytes this process
sent to others through them.

The dispatch choke point (reference: ``_CountedJit``,
``thrill_tpu/parallel/mesh.py:77-260``): a device program is a plain
function of ``[W, cap, ...]`` tensors behind a :class:`Program`, one a
key (:meth:`MeshExec.program`). Every call of one goes through
:meth:`MeshExec.dispatch`, which counts it (``stats_dispatches``),
admits it against the HBM budget with its output-bytes hint (rung 1),
runs it under the shared retry policy when the ``api.mesh.dispatch``
or ``mem.oom`` sites are armed, and retries a device OOM after spilling
(rung 2, ``mem/pressure.py`` ``recover_dispatch``). The stitched
programs of ``api/fusion.py`` and the per-op programs of the ops they
stitch run here. It is neither ``torch.compile`` nor a CUDA graph: the
function runs eagerly, its kernels queued without a host round trip.

Host fetches go through :meth:`MeshExec.fetch`, which counts them
(``stats_fetches``) and first drains the deferred checks (the hinted
join's overflow check), so no result leaves the device past an unrun
check; :meth:`MeshExec._fetch_raw` is the transfer the checks themselves
use, outside ``stats_fetches``. Every transfer through the two, counted
or not, adds one to ``stats_transfers``: each waits for the card's queue
(the radix engine's live-digit read, ``pallas_sort.live_reads``, is a
sync outside both).

The loop layer (``api/loop.py``) records at the same choke point: while
a capture runs, ``loop_recorder`` sees every outermost dispatch after it
returns, every host fetch, and every host upload a program may read
(:meth:`MeshExec.bless`: ``put_small`` and the other uploads of plan
values), which are the tape's legitimate constants.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..common import faults, taint
from ..common.retry import default_policy
from ..core import unsigned

DeviceLike = Union[str, torch.device, None]

# the mesh whose node compute or dispatch is running on this thread
_TLS = threading.local()


def current_mex() -> Optional["MeshExec"]:
    """The mesh of the dispatch or node compute in progress, or None."""
    return getattr(_TLS, "mex", None)


def bind_current(mex: Optional["MeshExec"]) -> Optional["MeshExec"]:
    """Make ``mex`` the current mesh; returns the one it replaces."""
    prev = getattr(_TLS, "mex", None)
    _TLS.mex = mex
    return prev


def _reducible(x: torch.Tensor, ordered: bool):
    """``x`` in a type gloo's ``all_reduce`` takes, and the function that
    turns the reduced tensor back into ``x``'s type (fault C21: gloo
    refuses 16-bit and wide unsigned integers). Sums widen to int64 and
    narrow back with the reference's wrap; an ``ordered`` (MAX, MIN)
    uint64 flips its sign bit, so the signed order is the unsigned one."""
    dt = x.dtype
    if dt in _WIRE_TYPES:
        return x, lambda y: y
    if dt == torch.bool:
        return x.to(torch.uint8), lambda y: y.to(torch.bool)
    from ..core.unsigned import SIGNED_OF, unsigned_values
    if dt == torch.uint64:
        sign = -(1 << 63) if ordered else 0
        return (x.view(torch.int64) ^ sign,
                lambda y: (y ^ sign).view(torch.uint64))
    if dt in SIGNED_OF:
        return (unsigned_values(x),
                lambda y: y.to(SIGNED_OF[dt]).view(dt))
    return x.to(torch.int64), lambda y: y.to(dt)


def _worker_fold(t: torch.Tensor, mex: Optional["MeshExec"],
                 op: str) -> torch.Tensor:
    m = t.amax(dim=0) if op == "MAX" else t.amin(dim=0)
    if mex is None or not mex.multiprocess:
        return m
    import torch.distributed as dist
    r, back = _reducible(m.contiguous(), ordered=True)
    r = r.contiguous()
    mex.stats_bytes_cross += r.numel() * r.element_size()
    mex.stats_collectives += 1
    dist.all_reduce(r, op=getattr(dist.ReduceOp, op))
    m = back(r)
    taint.kernel_edge([t], [m])
    return m


# element types gloo's all-to-all moves as they are; every other type
# (bool, int16, the narrowed exchange's 16-bit containers) crosses as its
# bytes
_WIRE_TYPES = (torch.float32, torch.float64, torch.int32, torch.int64,
               torch.uint8, torch.int8)


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor gloo's all-to-all takes: itself, or its bytes
    as one more trailing dimension (undone by :func:`_from_bytes`)."""
    if x.dtype in _WIRE_TYPES:
        return x
    return x.contiguous().unsqueeze(-1).view(torch.uint8)


def _from_bytes(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype in _WIRE_TYPES:
        return y
    return y.view(dtype).squeeze(-1)


def worker_max(t: torch.Tensor,
               mex: Optional["MeshExec"] = None) -> torch.Tensor:
    """The elementwise max over every worker of ``t`` ``[W_local, ...]``
    (the reference's pmax: HyperLogLog's registers, the join's presence
    registers, the exchange's overflow verdict and ranges), in ``t``'s
    dtype. One process (or ``mex`` None): the local ``amax``; several:
    one ``all_reduce`` MAX."""
    return _worker_fold(t, mex, "MAX")


def worker_min(t: torch.Tensor,
               mex: Optional["MeshExec"] = None) -> torch.Tensor:
    """:func:`worker_max` with min (the low ends of the exchange's leaf
    ranges): the local ``amin``, or one ``all_reduce`` MIN."""
    return _worker_fold(t, mex, "MIN")


def worker_exscan(t: torch.Tensor,
                  mex: Optional["MeshExec"] = None) -> torch.Tensor:
    """Each local worker's sum of ``t`` ``[W_local, ...]`` over the
    workers before it in the global order (PrefixSum's carry, the
    offsets of ZipWithIndex and the Window family in a stitched
    program). One process (or ``mex`` None): the local exclusive
    ``cumsum``; several: every process sums every worker's rows in
    worker order, so the sums are bit-equal to one process's."""
    if mex is None or not mex.multiprocess:
        return torch.cumsum(t, dim=0) - t
    every = mex.gather_workers(t)
    return mex.local(torch.cumsum(every, dim=0) - every)


def worker_shift(t: torch.Tensor,
                 mex: Optional["MeshExec"] = None) -> torch.Tensor:
    """Each local worker's row of ``t`` ``[W_local, ...]`` from the
    worker before it, zeros for worker 0 (the reference's ring
    ``ppermute``: the Window family's halo). One process (or ``mex``
    None): a shift of the local rows; several: from every process's
    gathered rows."""
    if mex is not None and mex.multiprocess:
        t = mex.gather_workers(t)
    out = torch.cat([torch.zeros_like(t[:1]), t[:-1]], dim=0)
    return out if mex is None else mex.local(out)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another. Raises when CUDA is asked for and absent; there is no
    silent fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class Program:
    """A device program behind the mesh's dispatch choke point: calls
    go through :meth:`MeshExec.dispatch`. ``out_bytes`` is its output's
    size, learned on its first call while admission is on (the cost
    model's per-program estimate)."""

    __slots__ = ("mex", "fn", "key", "out_bytes", "calls", "engine_recs",
                 "_trace_label")

    def __init__(self, mex: "MeshExec", fn: Callable, key: Tuple) -> None:
        # the mesh caches its programs: a strong reference back would
        # keep both (and every tensor a mesh reaches) alive until the
        # cyclic collector ran
        self.mex = weakref.proxy(mex)
        self.fn = fn
        self.key = key
        self.out_bytes: Optional[int] = None
        self.calls = 0
        # sort-engine decisions made on the first call, joined with a
        # later call's host time (core/device_sort.py)
        self.engine_recs: List[Any] = []
        self._trace_label: Optional[str] = None

    def label(self) -> str:
        """The dispatch span's name: the key's first string ("xchg_a",
        "fused", ...), else the function's name (reference:
        ``_CountedJit._label``)."""
        lbl = self._trace_label
        if lbl is None:
            key = self.key
            if isinstance(key, tuple) and key and isinstance(key[0], str):
                lbl = key[0]
            else:
                lbl = getattr(self.fn, "__name__", None) or "jit"
            self._trace_label = lbl
        return lbl

    def __call__(self, *args, **kwargs):
        return self.mex.dispatch(self, args, kwargs)

    def __repr__(self) -> str:
        return f"<Program {self.key[0] if self.key else '?'}>"


def tensor_bytes(obj) -> int:
    """Bytes of the tensors in a nest of tuples, lists and dicts."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(tensor_bytes(v) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(tensor_bytes(v) for v in obj)
    return 0


class MeshExec:
    """W workers on one device, plus the mesh's traffic counters."""

    def __init__(self, num_workers: int = 1,
                 device: DeviceLike = None, process_index: int = 0,
                 num_processes: int = 1) -> None:
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if num_processes < 1 or num_workers % num_processes:
            raise ValueError(f"{num_workers} workers do not split evenly "
                             f"over {num_processes} processes")
        self.num_workers = int(num_workers)
        self.device = resolve_device(device)
        # controller topology: process p owns the contiguous block of
        # workers [p * num_local, (p + 1) * num_local)
        self.num_processes = int(num_processes)
        self.process_index = int(process_index)
        self.num_local = self.num_workers // self.num_processes
        self.worker_base = self.process_index * self.num_local
        self.worker_process = np.repeat(np.arange(self.num_processes),
                                        self.num_local)
        # the host control plane between the processes (a
        # FlowControlChannel over the TCP group), wired by the Context
        self.host_net = None
        # the device data plane across processes: its backend, the
        # collectives run and the bytes sent to other processes
        self.backend = None
        if self.num_processes > 1:
            from ..common.platform import backend_for
            self.backend = backend_for(self.device)
        self.stats_collectives = 0
        self.stats_bytes_cross = 0
        # exchange traffic (reference: net::Manager tx/rx counters)
        self.stats_exchanges = 0
        self.stats_items_moved = 0
        self.stats_bytes_moved = 0
        # (live passes, candidate passes) of every radix argsort run
        self.radix_passes: List[Tuple[int, int]] = []
        # sticky pre-shuffle verdicts by (kind, site) (core/preshuffle.py)
        self.prune_verdicts: Dict[Tuple, bool] = {}
        # device-path runs, by op label, of the ops whose contract falls
        # back to the host (the Window family)
        self.device_runs: Counter = Counter()
        self._cache: Dict[Tuple, Any] = {}
        # the dispatch choke point's counters: program calls, counted
        # host fetches (the reference's ``device_fetches``), every
        # device-to-host transfer (each a sync of the queue; the
        # deferred checks' too, which the reference leaves uncounted),
        # and program stitching's
        # (api/fusion.py) stitched dispatches, the op segments they
        # carried and each stage's composition (op labels -> launches)
        self.stats_dispatches = 0
        self.stats_fetches = 0
        self.stats_transfers = 0
        self.stats_fused_dispatches = 0
        self.stats_fused_ops = 0
        self.fused_stage_counts: Dict[Tuple[str, ...], int] = {}
        # hinted joins re-run at their true capacity after an overflow
        self.stats_join_overflow_retries = 0
        # deferred validations (the hinted join's overflow check): every
        # host fetch drains them first
        self._pending_checks: List[Callable[[], None]] = []
        # the loop layer (api/loop.py): plans captured, iterations
        # replayed, iterations run by a whole-loop program, loud replay
        # fallbacks, bytes released early on replay, one report a loop
        self.stats_loop_plan_builds = 0
        self.stats_loop_replays = 0
        self.stats_loop_fori_iters = 0
        self.stats_loop_fallbacks = 0
        self.stats_loop_donated_bytes = 0
        self.loop_reports: List[dict] = []
        # the capture in progress (None: the dispatch pays one read)
        self.loop_recorder = None
        self._depth = 0              # dispatches in progress on the stack
        # the memory-pressure monitor (mem/pressure.py), the JSON logger,
        # the tracer (common/trace.py) and the performance doctor
        # (common/doctor.py), attached by the Context; None on a bare
        # mesh. A None or disabled tracer costs the dispatch one
        # attribute read and one predicate, and allocates nothing
        self.pressure = None
        self.logger = None
        self.tracer = None
        self.doctor = None
        # the plan layer (data/exchange.py): exchanges whose phase B ran
        # with no host read of the send matrix, the capacity-plan
        # cache's hits and misses, padded rows, the bytes phase B copies
        # between workers (narrowed) beside their full-width equivalent
        self.stats_exchanges_overlapped = 0
        self.stats_cap_cache_hits = 0
        self.stats_cap_cache_misses = 0
        self.stats_padded_rows = 0
        self.stats_bytes_wire_device = 0
        self.stats_bytes_wire_device_raw = 0
        # host-to-device uploads (put_small and the sources' bless), and
        # the put_small calls its content cache served
        self.stats_uploads = 0
        self.stats_upload_cache_hits = 0
        self._put_small_cache: Dict[Tuple, torch.Tensor] = {}
        # data-driven plan constructions from a host send matrix or a
        # pre-shuffle cost model, and plan-store seeds consumed in their
        # place (service/plan_store.py): a warm restart makes no builds
        self.stats_plan_builds = 0
        self.stats_plan_store_hits = 0
        # the decision ledger (common/decisions.py) and the planner
        # (api/planner.py), attached by the Context
        self.decisions = None
        self.planner = None
        # exchange mode: the Context sets it from Config.exchange; the
        # THRILL_TPU_EXCHANGE override is read once, here
        self.exchange_mode = "dense"
        self._env_exchange = os.environ.get("THRILL_TPU_EXCHANGE") or None
        # the dispatch-latency spine: the least host time a dispatch
        # took to queue its work (a CUDA launch returns before the work
        # ends, so this is the launch overhead) and the samples seen;
        # data/exchange.py calibrates bytes_eq from it
        self._disp_lat_min = float("inf")
        self._disp_lat_n = 0
        # the outermost program running (core/device_sort.py records its
        # engine decision on a program's first call only)
        self.current_program: Optional[Program] = None

    def cached(self, key: Tuple, builder: Callable[[], Any]) -> Any:
        """``builder()``'s result, built once per key on this mesh."""
        if key not in self._cache:
            self._cache[key] = builder()
        return self._cache[key]

    def jit_cached(self, key: Tuple, fn: Callable) -> "Program":
        """``fn`` as a program behind the dispatch choke point, one per
        key (reference: a cached ``jax.jit`` of an iterative program's
        small update step, a ``_CountedJit``): its calls count in
        ``stats_dispatches`` and a loop capture records them."""
        return self.program(key, fn)

    def program(self, key: Tuple, fn: Callable) -> Program:
        """``fn`` behind the dispatch choke point, one :class:`Program`
        per key. A plan store's learned output size for the key seeds a
        new program's admission estimate."""
        prog = self._cache.get(key)
        if prog is None:
            prog = self._cache[key] = Program(self, fn, key)
            seed = getattr(self, "_out_bytes_seed", None)
            if seed:
                self._seed_out_bytes(prog, seed)
        return prog

    def _seed_out_bytes(self, prog: Program, seed: dict) -> None:
        from ..data.exchange import _ident_digest
        v = seed.pop(_ident_digest(prog.key), None)
        if v is None:
            return
        try:
            prog.out_bytes = int(v)
        except (TypeError, ValueError):
            return                   # a bad store value costs nothing
        self.stats_plan_store_hits += 1
        led = self.decisions
        if led is not None and led.enabled:
            led.record("store_seed", site="prog:" + str(prog.key[0]),
                       chosen="out_bytes", predicted=prog.out_bytes,
                       reason="warm-start learned size")

    # -- plan-state persistence (service/plan_store.py) -----------------
    def export_learned_sizes(self) -> dict:
        """Learned output sizes of the programs, by key digest, with
        the imported seeds not consumed."""
        from ..data.exchange import _ident_digest
        out = {}
        for key, prog in self._cache.items():
            ob = getattr(prog, "out_bytes", None)
            if isinstance(prog, Program) and ob:
                out[_ident_digest(key)] = int(ob)
        for dg, v in (getattr(self, "_out_bytes_seed", None)
                      or {}).items():
            out.setdefault(dg, v)
        return out

    def import_learned_sizes(self, m: dict) -> int:
        seed = getattr(self, "_out_bytes_seed", None)
        if seed is None:
            seed = self._out_bytes_seed = {}
        seed.update({str(k): v for k, v in m.items()})
        return len(m)

    def dispatch(self, prog: Program, args: tuple, kwargs: dict):
        """Run one program call: count it, admit it (rung 1), retry
        transient faults of the armed ``api.mesh.dispatch`` site under
        the shared policy, and hand a device OOM to rung 2. A loop
        capture records the outermost calls."""
        rec = self.loop_recorder
        if rec is not None:
            if self._depth == 0:
                rec.begin_call(args)
            self._depth += 1
            try:
                out = self._traced_dispatch(prog, args, kwargs)
            except BaseException:
                self._depth -= 1
                if self._depth == 0:
                    rec.abort_call()
                raise
            self._depth -= 1
            if self._depth == 0:
                rec.on_call(prog, args, kwargs, out)
            return out
        return self._traced_dispatch(prog, args, kwargs)

    def _traced_dispatch(self, prog: Program, args: tuple, kwargs: dict):
        """:meth:`_dispatch` inside a ``dispatch`` span named by the
        program's label (a host-time span: it ends when the work is
        queued). Tracing off: one attribute read and one predicate, and
        a scan of the arguments' leaves: arguments that hold a wide
        unsigned column compute as the reference's unsigned arrays
        (core/unsigned.py, fault C22)."""
        with unsigned.scope_for((args, kwargs)):
            return self._spanned_dispatch(prog, args, kwargs)

    def _spanned_dispatch(self, prog: Program, args: tuple, kwargs: dict):
        tr = self.tracer
        if tr is None or not tr.enabled:
            return self._dispatch(prog, args, kwargs)
        with tr.span("dispatch", prog.label()):
            return self._dispatch(prog, args, kwargs)

    def _dispatch(self, prog: Program, args: tuple, kwargs: dict):
        self.stats_dispatches += 1
        prog.calls += 1
        pres = self.pressure
        if pres is not None and pres.enabled:
            pres.admit_call(prog, args)
        outer = self.current_program
        if outer is None:
            self.current_program = prog
        prev_mex = bind_current(self)
        t0 = time.perf_counter()
        try:
            if not faults.REGISTRY.active():
                out = prog.fn(*args, **kwargs)
            else:
                from ..mem import pressure as _pressure

                def attempt():
                    faults.check(faults.F_DISPATCH)
                    faults.check(_pressure._F_OOM)
                    return prog.fn(*args, **kwargs)

                out = default_policy().run(attempt, what="mesh.dispatch")
        except Exception as e:
            from ..mem import pressure as _pressure
            if not (_pressure.retry_enabled() and _pressure.is_oom_error(e)):
                raise
            out = _pressure.recover_dispatch(prog, args, kwargs, e)
        finally:
            bind_current(prev_mex)
            if outer is None:
                self.current_program = None
        # the dispatch-latency spine: two clock reads, no sync
        dt = time.perf_counter() - t0
        if dt < self._disp_lat_min:
            self._disp_lat_min = dt
        self._disp_lat_n += 1
        if prog.engine_recs and prog.calls > 1:
            # the first call's time is the build's: a later one joins
            led = self.decisions
            if led is not None and led.enabled:
                for rec in prog.engine_recs:
                    led.resolve(rec, dt * 1e6)
            prog.engine_recs = []
        if pres is not None and pres.enabled and prog.out_bytes is None:
            prog.out_bytes = tensor_bytes(out)
        return out

    #: the largest array :meth:`put_small` keeps in its content cache
    PUT_SMALL_BYTES = 4096

    def put_small(self, arr) -> torch.Tensor:
        """A small host array (a plan's counts, offsets, bounds, send
        matrix) on the mesh's device, blessed (see :meth:`bless`).
        Content-cached, as the reference's ``MeshExec.put_small``: an
        iterative pipeline uploads the same tiny arrays again and again,
        and on the card each is a host-to-device copy, so one upload
        serves every equal value (counted in ``stats_upload_cache_hits``,
        not in ``stats_uploads``). Callers only read these tensors.
        Arrays above :data:`PUT_SMALL_BYTES` upload each time."""
        arr = np.asarray(arr)
        if arr.nbytes > self.PUT_SMALL_BYTES:
            return self.bless(torch.as_tensor(arr, device=self.device))
        key = (arr.shape, arr.dtype.str, arr.tobytes())
        buf = self._put_small_cache.get(key)
        if buf is None:
            if len(self._put_small_cache) >= 4096:   # bounded growth
                self._put_small_cache.clear()
            buf = self.bless(torch.as_tensor(arr, device=self.device))
            self._put_small_cache[key] = buf
        else:
            self.stats_upload_cache_hits += 1
        return buf

    def bless(self, t: torch.Tensor) -> torch.Tensor:
        """Mark ``t``, just uploaded from host values, as a legitimate
        tape constant (reference: ``MeshExec._bless``). A loop capture
        rejects a tensor made during the body by device math outside a
        program, which could hold loop data; an upload's host values
        were read through :meth:`fetch` (where the capture checks them)
        or never came from the device."""
        self.stats_uploads += 1
        rec = self.loop_recorder
        if rec is not None:
            rec.bless(t)
        return t

    def fetch(self, t: torch.Tensor) -> np.ndarray:
        """A device tensor on the host (waits for the device): counted
        in ``stats_fetches``, after the deferred checks have run."""
        self.stats_fetches += 1
        self.drain_checks()
        return self._fetch_raw(t)

    def host_view(self, t: torch.Tensor) -> np.ndarray:
        """A CPU mesh's tensor as numpy, without a copy, for host code
        that reads the columns in place (the native engine,
        ``core/host_radix.py``). Not a transfer and not counted, as the
        reference's native engine reads its buffers; a loop capture sees
        the read as a fetch's, so a carry-dependent read rejects the
        capture instead of freezing the engine's output in the tape."""
        rec = self.loop_recorder
        if rec is not None:
            rec.on_fetch(t, inside=self._depth > 0)
        return t.detach().numpy()

    def _fetch_raw(self, t: torch.Tensor) -> np.ndarray:
        """:meth:`fetch` without the count and the drain, for the
        deferred checks themselves (counted in ``stats_transfers`` only).
        A loop capture sees the read."""
        self.stats_transfers += 1
        rec = self.loop_recorder
        if rec is not None:
            rec.on_fetch(t, inside=self._depth > 0)
        return t.detach().cpu().numpy()

    def reset_run_state(self) -> int:
        """Drop an aborted pipeline's per-run state (reference:
        ``MeshExec.reset_run_state``): the deferred checks and a loop
        capture in progress. A CUDA graph capture needs nothing here:
        api/loop.py ``_graph_loop`` ends its capture in a ``finally``,
        whatever raised inside it. Returns the number of checks
        dropped."""
        dropped = len(self._pending_checks)
        self._pending_checks.clear()
        self.loop_recorder = None
        self._depth = 0
        self.current_program = None
        return dropped

    # -- elastic resize (api/context.py Context.resize) -----------------
    def _w_state_attrs(self) -> Tuple[str, ...]:
        """The attributes whose values are shaped by W and swap with
        the worker count: the exchange's plan state, the pre-shuffle
        verdicts and their history, the loop tapes' records, learned
        output sizes and the program cache (reference:
        ``MeshExec._w_state_attrs``)."""
        from ..data.exchange import W_STATE_ATTRS
        return W_STATE_ATTRS + ("_prune_decisions", "_prune_history",
                                "prune_verdicts", "_loop_tapes",
                                "_out_bytes_seed", "_cache")

    def resize(self, num_workers: int) -> None:
        """Re-point the mesh at ``num_workers`` workers at a generation
        boundary (reference: ``parallel/mesh.py:740-798``). The W
        workers are logical and all on this mesh's one device, so any W
        fits. The old W's learned state is parked in a per-W archive,
        not dropped, and the state last learned at the new W comes
        back, so a W = 4 -> 2 -> 4 cycle returns to warm plans. The
        archive holds host values and programs only (no tensor of a
        run): the per-run state (deferred checks, a capture in
        progress) is dropped. The caller re-splits the live shards;
        they must be staged before this call. One process only: across
        processes the membership changes in the host group and the job
        relaunches."""
        new_w = int(num_workers)
        if new_w < 1:
            raise ValueError("cannot resize to an empty mesh")
        if self.multiprocess:
            raise RuntimeError(
                "MeshExec.resize is one-process only: the processes of "
                "a mesh change through the host group "
                "(net.Group.resize, net.tcp.join_tcp_group) and a "
                "relaunch at the new W")
        old_w = self.num_workers
        if new_w == old_w:
            return
        self._put_small_cache.clear()
        arch = self.__dict__.setdefault("_w_archive", {})
        arch[old_w] = {a: self.__dict__.pop(a)
                       for a in self._w_state_attrs()
                       if a in self.__dict__}
        for a, v in arch.pop(new_w, {}).items():
            setattr(self, a, v)
        if "_cache" not in self.__dict__:
            self._cache = {}
        if "prune_verdicts" not in self.__dict__:
            self.prune_verdicts = {}
        self.num_workers = new_w
        self.num_local = new_w
        self.worker_base = 0
        self.worker_process = np.zeros(new_w, dtype=np.int64)
        self.reset_run_state()

    def drain_checks(self) -> None:
        """Run every queued deferred check. A check that raises keeps
        the unrun ones queued for the next drain."""
        if not self._pending_checks:
            return
        checks, self._pending_checks = self._pending_checks, []
        try:
            while checks:
                checks.pop(0)()
        except BaseException:
            self._pending_checks.extend(checks)
            raise

    # -- controller topology (reference: parallel/mesh.py:446-460) ------
    @property
    def multiprocess(self) -> bool:
        return self.num_processes > 1

    @property
    def local_workers(self) -> List[int]:
        """The worker ids whose rows this process holds (all of them in
        one process)."""
        return list(range(self.worker_base,
                          self.worker_base + self.num_local))

    def local_ids(self) -> torch.Tensor:
        """``[W_local, 1]`` int64 ids of the local workers, on the
        device."""
        return torch.arange(self.worker_base,
                            self.worker_base + self.num_local,
                            device=self.device)[:, None]

    # -- the data plane across processes --------------------------------
    def worker_transpose(self, blocks: torch.Tensor) -> torch.Tensor:
        """The all-to-all between workers: ``blocks`` ``[W_local, W,
        ...]`` (local senders by global receiver) become ``[W_local, W,
        ...]`` (local receivers by global sender, in rank order). One
        process: a transpose of the worker dimensions; several: one
        ``all_to_all_single`` of the blocks bound for each process."""
        if not self.multiprocess:
            return blocks.transpose(0, 1)
        import torch.distributed as dist
        P, Wl = self.num_processes, self.num_local
        dtype = blocks.dtype
        blocks = _as_bytes(blocks)
        trail = tuple(blocks.shape[2:])
        x = blocks.reshape((Wl, P, Wl) + trail).transpose(0, 1).contiguous()
        self.stats_bytes_cross += (x.numel() * x.element_size()
                                   * (P - 1) // P)

        self.stats_collectives += 1
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        taint.kernel_edge([x], [out])
        # out[p]: process p's senders' blocks for the local receivers
        return _from_bytes(out.reshape((P * Wl, Wl) + trail)
                           .transpose(0, 1), dtype)

    def exchange_rows(self, x: torch.Tensor, send_rows: List[int],
                      recv_rows: List[int]) -> torch.Tensor:
        """The uneven all-to-all between processes: ``x`` ``[N, ...]``
        holds ``send_rows[p]`` rows for each process ``p`` in process
        order (this process's own among them); the result holds
        ``recv_rows[p]`` rows from each process, in process order. The
        ragged exchange and the 1-factor and streamed rounds ride it.
        One process: ``x`` itself; several: one ``all_to_all_single``
        with the split sizes, which every process calls, its own rows
        empty or not. ``stats_bytes_cross`` counts the rows sent to
        other processes."""
        if not self.multiprocess:
            return x
        import torch.distributed as dist
        dtype = x.dtype
        x = _as_bytes(x).contiguous()
        trail = tuple(x.shape[1:])
        row = x.element_size() * int(np.prod(trail, dtype=np.int64))
        send_rows = [int(n) for n in send_rows]
        recv_rows = [int(n) for n in recv_rows]
        self.stats_bytes_cross += (sum(send_rows)
                                   - send_rows[self.process_index]) * row
        self.stats_collectives += 1
        out = x.new_empty((sum(recv_rows),) + trail)
        dist.all_to_all_single(out, x, output_split_sizes=recv_rows,
                               input_split_sizes=send_rows)
        taint.kernel_edge([x], [out])
        return _from_bytes(out, dtype)

    def worker_sum(self, t: torch.Tensor,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The sum over every worker of ``t`` ``[W_local, ...]`` (the
        reference's psum over the worker axis), in ``dtype`` if given."""
        s = t.sum(dim=0, dtype=dtype)
        if not self.multiprocess:
            return s
        import torch.distributed as dist
        r, back = _reducible(s.contiguous(), ordered=False)
        r = r.contiguous()
        self.stats_bytes_cross += r.numel() * r.element_size()
        self.stats_collectives += 1
        dist.all_reduce(r)
        s = back(r)
        taint.kernel_edge([t], [s])
        return s

    def gather_workers(self, t: torch.Tensor) -> torch.Tensor:
        """Every worker's rows of ``t`` ``[W_local, ...]`` as ``[W,
        ...]``, in worker order, on every process."""
        if not self.multiprocess:
            return t
        import torch.distributed as dist
        dtype = t.dtype
        x = _as_bytes(t).contiguous()
        self.stats_bytes_cross += (x.numel() * x.element_size()
                                   * (self.num_processes - 1))
        self.stats_collectives += 1
        parts = [torch.empty_like(x) for _ in range(self.num_processes)]
        dist.all_gather(parts, x)
        taint.kernel_edge([x], parts)
        return _from_bytes(torch.cat(parts, dim=0), dtype)

    def local(self, rows):
        """The local workers' entries of a per-worker ``[W, ...]`` array
        or tensor (all of it in one process)."""
        if not self.multiprocess:
            return rows
        return rows[self.worker_base:self.worker_base + self.num_local]

    # -- the host plane of plan values ----------------------------------
    def gather_host(self, arr) -> np.ndarray:
        """Host rows ``[W_local, ...]`` of every process as ``[W,
        ...]`` (the local rows themselves in one process)."""
        arr = np.ascontiguousarray(arr)
        if not self.multiprocess:
            return arr
        import torch.distributed as dist
        wire = arr.dtype in (np.float32, np.float64, np.int32, np.int64,
                             np.uint8, np.int8)
        # any other type (bool, 16-bit, wide unsigned) as its bytes
        t = torch.from_numpy(arr if wire else arr.reshape(
            arr.shape + (1,)).view(np.uint8))
        parts = [torch.empty_like(t) for _ in range(self.num_processes)]
        dist.all_gather(parts, t)
        out = torch.cat(parts, dim=0).numpy()
        return out if wire else out.view(arr.dtype)[..., 0]

    def fetch_global(self, t: torch.Tensor) -> np.ndarray:
        """:meth:`fetch` of a per-worker tensor ``[W_local, ...]``, with
        every process's rows: ``[W, ...]``."""
        return self.gather_host(self.fetch(t))

    def allgather_object(self, obj: Any) -> List[Any]:
        """Every process's ``obj``, in process order (``[obj]`` in one
        process)."""
        if not self.multiprocess:
            return [obj]
        import torch.distributed as dist
        out: List[Any] = [None] * self.num_processes
        dist.all_gather_object(out, obj)
        return out

    def agree(self, value: Any) -> Any:
        """Process 0's ``value`` on every process: a choice made from
        local state (a learned verdict, a timed calibration) must be
        one choice, or the processes would run different collectives."""
        if not self.multiprocess:
            return value
        import torch.distributed as dist
        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def __repr__(self) -> str:
        extra = (f", process {self.process_index} of "
                 f"{self.num_processes}" if self.multiprocess else "")
        return (f"MeshExec(num_workers={self.num_workers}, "
                f"device={self.device}{extra})")
