"""Device-resident iteration: LoopPlan capture, replay and release, and
the whole-loop CUDA graph (counterpart of the reference package's
``api/loop.py``).

``Iterate(ctx, body, carry, n)`` runs ``body`` ``n`` times with the
carry threaded through. The carry is a DIA (``body(dia) -> dia``, the
Collapse-loop idiom: each iteration's result is materialized and the
next iteration reads it through a source node) or a pytree of tensors
(``body(tree) -> tree``, the k-means idiom).

The first iteration runs through the pull recursion and the stitching
planner as a plain one, with a recorder installed at the mesh's
dispatch choke point (``MeshExec.dispatch``): the sequence of program
calls it makes becomes a :class:`LoopPlan` tape, and iterations 2..N
replay the tape with the carry threaded through. No DIA graph is built,
no plan is made and no plan value is fetched on replay.

How the tape stays correct:

* Each recorded call classifies its arguments by tensor identity: a
  carry leaf, the output of an earlier recorded call, or a constant (a
  tensor that lived before the capture, a blessed host upload, any
  Python object). The capture first copies every carry leaf, so a carry
  that shares a tensor with a constant of the body cannot make the
  constant look loop-varying.
* A dispatch mode follows every aten op of the capture iteration (the
  torch counterpart of the reference's jaxprs and ``jax.live_arrays``):
  a tensor made by device math outside a program from a loop value that
  then feeds one (math over constants only is a constant), a program
  reading a loop value it was not passed, an in-place update
  of a program's argument or of a loop value outside a program, and a
  numpy argument each reject the capture. Inside each call it records,
  for every output, which arguments reach it (``_Call.out_deps``); the
  hand-written kernels report their edges (``common/taint.py``) and a
  launch that reports none makes the call opaque (every output depends
  on every argument).
* Host plan logic that fetches a value during the capture (an exchange's
  send matrix) freezes it into the tape. :class:`_LeafTaint` decides per
  output whether the fetched value depends on the carry; if it does, the
  capture is rejected. A fixed topology's send matrix (PageRank's edge
  targets riding next to the changing ranks) captures.
* Calls whose outputs never reach the carry are dropped; calls that do
  not depend on the carry run once, and their outputs become constants.
* A carry-out that no recorded call produced (eager math in the body)
  rejects the capture.

A rejected capture falls back to the plain loop, loudly
(``event=loop_capture_miss``); two misses in a row and the rest of the
loop runs plain. ``THRILL_TPU_LOOP_REPLAY=0`` gives the plain loop.

KNOWN BLIND SPOT, as in the reference: Python control flow on a scalar
the body reads from a tensor directly (``if float(x.sum()) < eps``, or
``.numpy()`` of a CPU tensor) is frozen at its first value; keep
convergence checks outside ``Iterate``.

Release (the reference's donation): on a replayed iteration a loop-owned
tensor (a carry leaf or an intermediate) that is dead after a call is
dropped by the tape right after that call returns, so the caching
allocator can hand its block to a later output. ``loop_donated_bytes``
counts the reference's positions (whole arguments); intermediates read
through a list or dict argument, which the reference's donating twins
cannot donate, are dropped too, uncounted. Release is off while faults
are armed, on the first replay and after a checkpoint seal, and on the
CPU by default (``THRILL_TPU_LOOP_DONATE``); without it an iteration
holds its intermediates to its end. The capture iteration holds every
output it records until its analysis, as the reference's does.

Whole loop (``THRILL_TPU_LOOP_FORI``): the remaining iterations run as
ONE program through the choke point, the counterpart of the reference's
``lax.fori_loop``: on the card a ``torch.cuda.CUDAGraph`` of one tape
iteration over static carry buffers, the carry-out copied into the
carry-in at the graph's end, replayed ``k`` times; on the CPU the tape
``k`` times in a Python loop, the plain version beside the graph. A call
that read the host, or made a CPU tensor, during the capture keeps the
tape out of a graph; a capture of the graph that fails logs
``event=loop_fori_unavailable`` and the loop replays per iteration.

Failures: every replayed iteration passes the ``api.loop.replay`` fault
site; an injected or real failure logs ``event=loop_replay_fallback``,
counts in ``loop_replay_fallbacks`` and runs the iteration plain (which
captures again). ``checkpoint_every=k`` seals a DIA carry into a
checkpoint epoch after every k-th iteration but the last, when the
Context has a checkpoint manager (api/checkpoint.py); a resumed run
restores the newest loop epoch of ``name`` and goes on after it.

The plan store (service/plan_store.py) keeps each loop's capture
outcome under its tape token (name, the body's canonical identity and
the carry's signature): a loop that rejected capture twice runs plain
from its first iteration on a warm restart (``loop_seed_nocapture``), a
captured tape's program keys and wiring are compared with the fresh
capture's (``loop_seed_stale`` when they differ).

Across processes (a mesh of several processes) every process captures
its own tape, whose programs hold the collectives; the loop replays only
when every process captured (a ``loop_plan`` decision record says which
mode ran and why), so every process replays the same calls with the
same host fetches. On the card the whole-loop graph is off there: gloo's
collectives run on the host (``graph_off`` in the loop's report,
``loop_fori_unavailable`` in the log), and the replays run per
iteration.

Tracing (common/trace.py): a ``loop`` span ``capture`` for every capture
or plain iteration (``mode`` says which) and ``replay`` for every
replayed iteration, or one for the whole-loop window with its
``fori_iters``, as the reference's. The window's one dispatch span is
the ``loop_fori`` program's: on the card it holds the graph's capture
and replays, and the span code runs outside the capture, so the graph
records no host work of it.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..common import decisions as _decisions
from ..common import faults, taint
from ..common import tree as pt
from ..core import ordered_fold, pallas_kernels, pallas_sort
from ..data.shards import DeviceShards, HostShards
from .dia import DIA
from .dia_base import DIABase

_F_REPLAY = faults.F_LOOP_REPLAY


# -- plan-state persistence: the loop tapes' outcomes -------------------

def export_plan_state(mex) -> dict:
    """Each loop's tape metadata as a digest map (the store's
    ``loop_tape`` kind)."""
    from ..data.exchange import _ident_digest, merge_unconsumed_seeds
    return merge_unconsumed_seeds(mex, {
        "loop_tape": {_ident_digest(k): v for k, v in
                      getattr(mex, "_loop_tapes", {}).items()},
    })


def import_plan_state(mex, state: dict, *,
                      symmetric: bool = False) -> int:
    from ..data.exchange import install_plan_seeds
    return install_plan_seeds(mex, state, ("loop_tape",),
                              symmetric=symmetric)


def _note_tape(mex, token, meta: Optional[dict]) -> None:
    """Remember this loop's capture outcome for export."""
    if meta is None:
        return
    tapes = getattr(mex, "_loop_tapes", None)
    if tapes is None:
        tapes = mex._loop_tapes = {}
    tapes[token] = meta


def _tape_token(name: str, dia_mode: bool, state, body) -> Optional[Tuple]:
    """The plan-store identity of a loop's tape: its name, the body's
    canonical identity (two loops of the default name keep their own
    records) and the carry's signature; None when the carry cannot be
    signed (host storage)."""
    from ..data.exchange import _canon
    try:
        body_id = _canon(body)
        if dia_mode:
            if not isinstance(state, DeviceShards):
                return None
            sig = (_leaf_sig(pt.leaves(state.tree)), state.cap,
                   state._counts_host is not None)
        else:
            sig = (_leaf_sig(pt.leaves(state)),)
    except Exception:
        return None
    return ("loop_tape", name, bool(dia_mode), body_id, repr(sig))


def _tape_meta(plan: "LoopPlan") -> dict:
    """A captured tape's identity: its programs' key digests and a
    digest of its wiring."""
    import hashlib

    from ..data.exchange import _canon
    keys = [hashlib.sha1(_canon(getattr(c.fn, "key", ())).encode())
            .hexdigest() for c in plan.calls]

    def rsig(ref):
        if ref[0] == "const":
            return "c"
        if ref[0] == "tree":
            return ("t", tuple(rsig(x) for x in ref[2]))
        return ref

    wiring = repr((tuple(tuple(rsig(r) for r in c.arg_refs)
                         for c in plan.calls),
                   tuple(r if r[0] != "const" else "c"
                         for r in plan.carry_out)))
    return {"capture": True, "calls": keys,
            "wiring": hashlib.sha1(wiring.encode()).hexdigest()}


def replay_enabled() -> bool:
    """THRILL_TPU_LOOP_REPLAY=0 restores plain per-iteration planning."""
    return os.environ.get("THRILL_TPU_LOOP_REPLAY", "1") not in (
        "0", "off", "false")


def donation_enabled(device: Optional[torch.device] = None) -> bool:
    """THRILL_TPU_LOOP_DONATE overrides; default: on for the card, off on
    the CPU (as the reference's default is off on XLA:CPU)."""
    v = os.environ.get("THRILL_TPU_LOOP_DONATE")
    if v is not None:
        return v not in ("0", "off", "false")
    return device is not None and device.type == "cuda"


def fori_enabled() -> bool:
    """THRILL_TPU_LOOP_FORI=0 keeps replay per iteration instead of one
    whole-loop program (a CUDA graph on the card)."""
    return os.environ.get("THRILL_TPU_LOOP_FORI", "1") not in (
        "0", "off", "false")


def _launch_counters() -> list:
    """The kernel wrappers whose ``launches`` count their launches."""
    return [pallas_kernels.partition_histogram, pallas_kernels.segment_sum,
            pallas_kernels.presence_fill, pallas_sort.radix_upsweep,
            pallas_sort.radix_pass, pallas_sort.stable_partition_offsets,
            ordered_fold.ordered_segment_sum]


def _launches() -> int:
    return sum(f.launches for f in _launch_counters())


def _launch_snapshot() -> List[int]:
    return [f.launches for f in _launch_counters()]


def _launch_delta(before: List[int]) -> Dict[str, int]:
    """Kernel launches since ``before``, by wrapper (the log lines')."""
    return {f.__name__: f.launches - b
            for f, b in zip(_launch_counters(), before) if f.launches != b}


def _skey(t: torch.Tensor) -> Optional[int]:
    """The storage a tensor lives in (None: it holds no bytes)."""
    st = t.untyped_storage()
    return st.data_ptr() if st.nbytes() else None


def _tensors(obj) -> List[torch.Tensor]:
    """The tensors in a nest of lists, tuples and dicts."""
    return [l for l in pt.leaves(obj) if isinstance(l, torch.Tensor)]


def _view_key(t: torch.Tensor) -> Tuple:
    """What makes two tensor objects the same value: one storage, one
    offset, shape, strides and dtype (``reshape(-1)`` of a ``[W]``
    tensor is another object over the same value)."""
    return (_skey(t), t.storage_offset(), tuple(t.shape), t.stride(),
            t.dtype)


def _flat_arg(a) -> Tuple[List[Any], Any]:
    """(leaves, treedef) of one positional argument: a tensor or another
    object is one leaf (treedef None); lists, tuples and dicts are walked."""
    if isinstance(a, (list, tuple, dict)):
        return pt.flatten(a)
    return [a], None


# ----------------------------------------------------------------------
# tape capture
# ----------------------------------------------------------------------

@dataclasses.dataclass
class _Call:
    """One recorded dispatch: the program plus classified argument
    references. ``arg_refs``: ("carry", slot) | ("val", (call_idx,
    out_idx)) | ("const", object) | ("tree", treedef, [leaf refs]) for a
    list, tuple or dict argument that mixes loop-owned tensors with
    constants. ``donate_pos`` (set by the analysis): argument positions
    whose tensors are loop-owned and dead after this call.
    ``leaf_kinds``: the refs of every argument leaf in flatten order;
    ``out_deps``: for each output leaf, the indices of the argument
    leaves that reach it (None: unknown, every one). ``host_read``: the
    call read the host or made a CPU tensor during the capture, so it
    stays out of a CUDA graph, and its output shapes are checked on
    replay. ``out_sig``: its outputs' shapes and dtypes."""
    fn: Any
    arg_refs: List[Tuple]
    out_buffers: List[Any]
    donate_pos: Tuple[int, ...] = ()
    leaf_kinds: Optional[List[Tuple]] = None
    out_deps: Optional[List[frozenset]] = None
    host_read: bool = False
    out_sig: Optional[Tuple] = None


def _leaf_refs(refs):
    """Iterate the leaf-level refs of an arg_refs list (trees
    flattened)."""
    for ref in refs:
        if ref[0] == "tree":
            for s in ref[2]:
                yield s
        else:
            yield ref


def _program_label(prog) -> str:
    key = getattr(prog, "key", None)
    return str(key[0]) if isinstance(key, tuple) and key else repr(prog)


def _out_sig(out_leaves) -> Tuple:
    return tuple((tuple(o.shape), o.dtype) if isinstance(o, torch.Tensor)
                 else None for o in out_leaves)


_MUTATES: Dict[Any, Tuple[Tuple[int, str], ...]] = {}
_HOST_READS = ("_local_scalar_dense",)
# ops that copy between host and device: on a CPU operand, even a 0-dim
# one, a host transfer (elsewhere a 0-dim CPU operand is a scalar)
_COPIES = ("_to_copy", "copy_", "_copy_from", "_copy_from_and_resize",
           "lift_fresh", "lift_fresh_copy")


def _mutated(func, args, kwargs) -> List[torch.Tensor]:
    """The tensors an aten op writes in place (``a!`` in its schema)."""
    idx = _MUTATES.get(func)
    if idx is None:
        idx = _MUTATES[func] = tuple(
            (i, a.name) for i, a in enumerate(func._schema.arguments)
            if a.alias_info is not None and a.alias_info.is_write)
    out: List[torch.Tensor] = []
    for i, name in idx:
        v = args[i] if i < len(args) else kwargs.get(name)
        out.extend(_tensors(v))
    return out


class _TaintMode(TorchDispatchMode):
    """Sees every aten op of the capture iteration for the recorder."""

    def __init__(self, rec: "_Recorder") -> None:
        super().__init__()
        self.rec = rec

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # nothing here is compiled: without torch's compiler guard around
        # the handler, its first call does not import the compiler stack
        # (seconds on the card)
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rec = self.rec
        if rec.dirty is None:
            try:
                rec.on_op(func, args, kwargs, out)
            except Exception as e:       # the analysis never breaks the body
                rec.dirty = f"capture analysis failed ({e!r})"[:200]
        return out


class _CallState:
    """What the recorder follows inside one recorded dispatch."""

    __slots__ = ("local", "versions", "read", "host_ops", "edges",
                 "launches0")

    def __init__(self) -> None:
        self.local: Dict[int, frozenset] = {}
        self.versions: List[Tuple[torch.Tensor, int]] = []
        self.read = frozenset()
        self.host_ops: set = set()     # ops that read or wrote the host
        self.edges = 0
        self.launches0 = 0


class _Recorder:
    """Installed as ``mex.loop_recorder`` (and ``common.taint.TRACKER``)
    around the capture iteration's body run; sees every outermost
    dispatch, every fetch and upload, and, through :class:`_TaintMode`,
    every aten op."""

    def __init__(self, carry_ids: Dict[int, int], carry: Sequence,
                 device: torch.device) -> None:
        self.carry_ids = carry_ids
        self.calls: List[_Call] = []
        self.produced: Dict[int, Tuple[int, int]] = {}
        self.plan_reads: set = set()   # (call, out) leaves fetched to host
        self.dirty: Optional[str] = None
        self.device = device
        # storages of loop values (carry leaves, recorded outputs), by
        # storage address, and what each tensor made outside a program
        # was computed from: ("carry", slot) / ("val", (i, j)) atoms
        self.loop_keys: Dict[int, frozenset] = {}
        self.glob: Dict[int, frozenset] = {}
        # storages made outside a program during the capture (eager
        # device math), unless blessed as a host upload
        self.eager: set = set()
        self._held: List[Any] = []     # keeps addresses from being reused
        # (program, op names) of the calls that read or wrote the host
        self.host_ops: List[Tuple[str, List[str]]] = []
        # another tensor object over the whole of a loop value is that
        # value: view key -> ("carry", slot) / ("val", (i, j))
        self.views: Dict[Tuple, Tuple] = {}
        for s, t in enumerate(carry):
            k = _skey(t)
            if k is not None:
                atom = frozenset([("carry", s)])
                self.loop_keys[k] = atom
                self.glob[k] = atom
                self.views[_view_key(t)] = ("carry", s)
        self._cur: Optional[_CallState] = None

    # -- the choke point's hooks ----------------------------------------
    def bless(self, t: torch.Tensor) -> None:
        """A host upload made during the capture: a legitimate constant."""
        k = _skey(t)
        if k is not None:
            self.eager.discard(k)
            self.glob.pop(k, None)
        self._held.append(t)

    def on_fetch(self, t, inside: bool = False) -> None:
        """Host code read ``t``. Inside a recorded dispatch it is that
        call's host read (it runs again on replay, but keeps the call out
        of a graph). Between dispatches it is plan logic: a read of a
        carry leaf rejects the capture, a read of a recorded output is a
        plan read that the analysis checks (reference:
        ``_Recorder.on_fetch``)."""
        if inside:
            self.host_read(t)
            return
        if not isinstance(t, torch.Tensor):
            return
        if id(t) in self.carry_ids:
            self.dirty = ("host plan logic fetched a carry leaf "
                          "during capture (carry-dependent plan)")
            return
        src = self.produced.get(id(t))
        if src is None and _skey(t) is not None:
            same = self.views.get(_view_key(t))
            if same is not None and same[0] == "val":
                src = same[1]
        if src is not None:
            self.plan_reads.add(src)
            return
        k = _skey(t)
        for kind, ref in (self.glob.get(k, ()) if k is not None else ()):
            if kind == "carry":
                self.dirty = ("host plan logic fetched a carry leaf "
                              "during capture (carry-dependent plan)")
                return
            self.plan_reads.add(ref)

    def host_read(self, t) -> None:
        cur = self._cur
        if cur is None or not isinstance(t, torch.Tensor):
            return
        k = _skey(t)
        if k is not None:
            cur.read = cur.read | cur.local.get(k, frozenset())
        cur.host_ops.add("fetch")

    def kernel_edge(self, inputs, outputs) -> None:
        ins = [t for t in inputs if isinstance(t, torch.Tensor)]
        outs = [t for t in outputs if isinstance(t, torch.Tensor)]
        cur = self._cur
        if cur is None:
            self._eager_op(ins, outs, [])
            return
        cur.edges += 1
        lab = self._in_labels(cur, ins)
        for o in outs:
            k = _skey(o)
            if k is not None:
                cur.local[k] = cur.local.get(k, frozenset()) | lab

    def begin_call(self, args) -> None:
        """A recorded dispatch starts: its argument leaves, in flatten
        order, label what they reach."""
        cur = _CallState()
        leaves: List[Any] = []
        for a in args:
            leaves.extend(_flat_arg(a)[0])
        for i, l in enumerate(leaves):
            if isinstance(l, torch.Tensor):
                k = _skey(l)
                if k is not None:
                    cur.local[k] = cur.local.get(k, frozenset()) | {i}
                cur.versions.append((l, l._version))
        cur.launches0 = _launches()
        self._cur = cur

    def abort_call(self) -> None:
        self._cur = None

    def _leaf_ref(self, a) -> Optional[Tuple]:
        if isinstance(a, torch.Tensor):
            slot = self.carry_ids.get(id(a))
            if slot is not None:
                return ("carry", slot)
            src = self.produced.get(id(a))
            if src is not None:
                return ("val", src)
            k = _skey(a)
            if k is not None and k in self.loop_keys:
                same = self.views.get(_view_key(a))  # the same value
                if same is not None:
                    return same
                self.dirty = ("a view of a loop value fed a recorded "
                              "dispatch (eager device math in the body?)")
                return None
            if k is not None and k in self.eager and self.glob.get(k):
                # made during the body outside a recorded dispatch from a
                # loop value: eager device math over the carry, whose
                # frozen value would corrupt every replay. Eager math over
                # constants only (a valid mask of host-known counts) is a
                # constant itself
                self.dirty = ("eager device math fed a recorded dispatch "
                              "during capture (unrecorded torch op in the "
                              "body?)")
                return None
            return ("const", a)
        if isinstance(a, np.ndarray):
            # a host array feeding a dispatch may be a fetched copy of
            # loop data; a tape would freeze it
            self.dirty = ("numpy argument entered a recorded "
                          "dispatch (host round trip in the body)")
            return None
        return ("const", a)

    def on_call(self, prog, args, kwargs, out) -> None:
        cur, self._cur = self._cur, None
        if self.dirty is not None or cur is None:
            return
        if kwargs:
            self.dirty = "dispatch with keyword arguments"
            return
        for t, v in cur.versions:
            if t._version != v:
                self.dirty = ("a recorded dispatch updated an argument in "
                              "place (a tape would replay it against "
                              "another value)")
                return
        refs: List[Tuple] = []
        leaf_kinds: List[Tuple] = []
        for a in args:
            leaves, td = _flat_arg(a)
            if td is None:
                ref = self._leaf_ref(a)
                if ref is None:
                    return
                refs.append(ref)
                leaf_kinds.append(ref)
                continue
            subs = []
            for l in leaves:
                s = self._leaf_ref(l)
                if s is None:
                    return
                subs.append(s)
            leaf_kinds.extend(subs)
            if all(s[0] == "const" for s in subs):
                refs.append(("const", a))     # wholly constant argument
            else:
                refs.append(("tree", td, subs))
        out_leaves = pt.flatten(out)[0]
        opaque = _launches() - cur.launches0 > cur.edges
        deps: Optional[List[frozenset]] = None
        if not opaque:
            deps = []
            for o in out_leaves:
                k = _skey(o) if isinstance(o, torch.Tensor) else None
                deps.append((cur.local.get(k, frozenset())
                             if k is not None else frozenset()) | cur.read)
        idx = len(self.calls)
        for j, o in enumerate(out_leaves):
            if isinstance(o, torch.Tensor):
                self.produced[id(o)] = (idx, j)
                k = _skey(o)
                if k is not None:
                    atom = frozenset([("val", (idx, j))])
                    self.loop_keys[k] = atom
                    self.glob[k] = atom
                    self.eager.discard(k)
                    self.views.setdefault(_view_key(o), ("val", (idx, j)))
        self.calls.append(_Call(prog, refs, out_leaves, leaf_kinds=leaf_kinds,
                                out_deps=deps, host_read=bool(cur.host_ops),
                                out_sig=_out_sig(out_leaves)))
        if cur.host_ops:
            self.host_ops.append((_program_label(prog), sorted(cur.host_ops)))

    # -- every aten op ----------------------------------------------------
    def _in_labels(self, cur: _CallState, ins) -> frozenset:
        lab = frozenset()
        for t in ins:
            k = _skey(t)
            if k is None:
                continue
            got = cur.local.get(k)
            if got is not None:
                lab |= got
            elif k in self.loop_keys:
                self.dirty = ("a recorded dispatch read a loop value it was "
                              "not passed (a closure over the carry?)")
            elif k in self.eager and self.glob.get(k):
                self.dirty = ("eager device math fed a recorded dispatch "
                              "during capture (through a closure)")
        return lab

    def _eager_op(self, ins, outs, mutated, fresh: bool = False) -> None:
        """An op between dispatches: its new tensors are eager device
        math; writing into a tensor that lived before the capture, or into
        a loop value, rejects the capture."""
        atoms = frozenset()
        in_keys = set()
        for t in ins:
            k = _skey(t)
            if k is not None:
                in_keys.add(k)
                atoms |= self.glob.get(k, frozenset())
        for t in mutated:
            k = _skey(t)
            if k is not None and k not in self.eager:
                self.dirty = ("an in-place update outside a recorded "
                              "dispatch (a tape would not repeat it)")
                return
        for o in outs:
            k = _skey(o)
            if k is None:
                continue
            if fresh or k not in in_keys:
                self.eager.add(k)
                self.glob[k] = atoms
            else:                          # a view: the same data
                self.glob[k] = self.glob.get(k, frozenset()) | atoms

    def on_op(self, func, args, kwargs, out) -> None:
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        mutated = _mutated(func, args, kwargs)
        name = func._overloadpacket.__name__
        cur = self._cur
        if cur is None:
            self._eager_op(ins, outs, mutated, fresh=name == "lift_fresh")
            return
        lab = self._in_labels(cur, ins)
        if name in _HOST_READS:
            cur.read = cur.read | lab
            cur.host_ops.add(name)
        elif self.device.type == "cuda" and (
                any(o.device.type == "cpu" for o in outs)
                or any(t.device.type == "cpu"
                       and (t.dim() > 0 or name in _COPIES) for t in ins)):
            # a transfer between host and card: the call runs again on
            # replay, but a CUDA graph cannot hold it
            if any(t.device.type == "cuda" for t in ins):
                cur.read = cur.read | lab
            cur.host_ops.add(name)
        in_keys = {_skey(t) for t in ins}
        mut_keys = {_skey(t) for t in mutated}
        for o in outs + mutated:
            k = _skey(o)
            if k is None:
                continue
            if k in in_keys or k in mut_keys:
                # a view of an input, or a write into part of a storage:
                # the rest of the storage keeps what it held
                cur.local[k] = cur.local.get(k, frozenset()) | lab
            else:
                # a new tensor holds what its inputs made; its storage
                # may reuse a freed temporary's, whose labels are stale
                cur.local[k] = lab


# ----------------------------------------------------------------------
# per-output taint over the tape
# ----------------------------------------------------------------------

class _LeafTaint:
    """Transitive per-output carry dependence over a recorded tape:
    output (i, j) is carry-dependent iff one of the argument leaves that
    reach it (``_Call.out_deps``, followed through every aten op and the
    kernels' reported edges during the capture) is a carry leaf or a
    carry-dependent output of an earlier call. Conservative at every gap:
    a call without ``out_deps`` (an unreported kernel launch) falls back
    to its call-level verdict. The reference re-traces the call's jaxpr
    for the same sets."""

    def __init__(self, calls: List[_Call], dep: List[bool]) -> None:
        self.calls = calls
        self.dep = dep
        self._pair: Dict[Tuple[int, int], bool] = {}

    def pair_dep(self, i: int, j: int) -> bool:
        key = (i, j)
        hit = self._pair.get(key)
        if hit is not None:
            return hit
        if not self.dep[i]:
            self._pair[key] = False
            return False
        od = self.calls[i].out_deps
        kinds = self.calls[i].leaf_kinds
        r = True                        # conservative default
        if od is not None and kinds is not None and j < len(od):
            r = False
            for k in od[j]:
                if k >= len(kinds):
                    r = True
                    break
                ref = kinds[k]
                if ref[0] == "carry" or (
                        ref[0] == "val" and self.pair_dep(*ref[1])):
                    r = True
                    break
        self._pair[key] = r
        return r


# ----------------------------------------------------------------------
# the plan
# ----------------------------------------------------------------------

class LoopPlan:
    """A replayable tape over one loop iteration.

    ``carry_out``: per carry-leaf reference, ("val", (i, j)) into the
    live tape, ("carry", s) passthrough or ("const", tensor) folded.
    ``counts`` (shards mode): the iteration-invariant host counts of the
    carry, or None when the counts thread through the tape as its last
    carry leaf."""

    def __init__(self, mex, calls: List[_Call], carry_out: List[Tuple],
                 n_carry: int, plan_reads: Optional[set] = None,
                 name: Optional[str] = None) -> None:
        self.mex = mex
        self.calls = calls
        self.carry_out = carry_out
        self.n_carry = n_carry
        self.name = name
        self.plan_reads = plan_reads or set()
        # set by _analyze when the tape cannot be replayed safely
        self.invalid: Optional[str] = None
        self.counts: Optional[np.ndarray] = None
        self.pruned_invariant = 0
        self.pruned_dead = 0
        self.used_outputs: set = set()
        self.dead_after: List[List[Tuple[int, int]]] = []
        self.host_ops: List[Tuple[str, List[str]]] = []
        self._fori_failed = False
        self._analyze()

    # -- dataflow analysis ---------------------------------------------
    def _analyze(self) -> None:
        calls = self.calls
        n = len(calls)
        # carry dependence (forward)
        dep = [False] * n
        for i, c in enumerate(calls):
            for ref in _leaf_refs(c.arg_refs):
                if ref[0] == "carry" or (ref[0] == "val"
                                         and dep[ref[1][0]]):
                    dep[i] = True
                    break
        # host plan logic that read a carry-dependent value during the
        # capture would be frozen at iteration-1 values: reject, judged
        # per output leaf
        taint_ = _LeafTaint(calls, dep)
        for i, j in self.plan_reads:
            if dep[i] and taint_.pair_dep(i, j):
                self.invalid = ("host plan logic read a carry-dependent "
                                "value during capture (data-dependent "
                                "exchange plan?)")
                break
        # liveness (backward from the carry outputs)
        needed = [False] * n
        stack = [ref[1][0] for ref in self.carry_out if ref[0] == "val"]
        while stack:
            i = stack.pop()
            if needed[i]:
                continue
            needed[i] = True
            for ref in _leaf_refs(calls[i].arg_refs):
                if ref[0] == "val":
                    stack.append(ref[1][0])
        live_idx = [i for i in range(n) if needed[i] and dep[i]]
        self.pruned_invariant = sum(1 for i in range(n)
                                    if needed[i] and not dep[i])
        self.pruned_dead = n - sum(needed)
        remap = {old: new for new, old in enumerate(live_idx)}

        def rewrite(ref):
            if ref[0] == "val":
                src, j = ref[1]
                if src in remap:
                    return ("val", (remap[src], j))
                # invariant producer: its captured output IS the value
                # for every future iteration
                return ("const", calls[src].out_buffers[j])
            if ref[0] == "tree":
                return ("tree", ref[1], [rewrite(s) for s in ref[2]])
            return ref

        live: List[_Call] = []
        for i in live_idx:
            c = calls[i]
            live.append(_Call(c.fn, [rewrite(r) for r in c.arg_refs],
                              c.out_buffers, host_read=c.host_read,
                              out_sig=c.out_sig))
        # rewrite() refers to itself through its closure cell, a cycle
        # that would hold every recorded call (and the capture
        # iteration's outputs) until the garbage collector ran
        del rewrite
        out: List[Tuple] = []
        for ref in self.carry_out:
            if ref[0] == "val":
                src, j = ref[1]
                if src in remap:
                    out.append(("val", (remap[src], j)))
                else:
                    # invariant producer: this carry leaf is the SAME
                    # value every iteration; fold it, like rewrite()
                    out.append(("const", calls[src].out_buffers[j]))
            else:
                out.append(ref)
        self.calls = live
        self.carry_out = out
        self._mark_donations()
        # live calls must not pin the capture iteration's memory: their
        # recorded outputs are never read again
        for c in self.calls:
            c.out_buffers = None
        used: set = set()
        for c in self.calls:
            for ref in _leaf_refs(c.arg_refs):
                if ref[0] == "val":
                    used.add(ref[1])
        for ref in self.carry_out:
            if ref[0] == "val":
                used.add(ref[1])
        self.used_outputs = used
        # each call's last reads of earlier outputs (carry-outs excluded):
        # a releasing run drops them after it
        last: Dict[Tuple[int, int], int] = {}
        for i, c in enumerate(self.calls):
            for ref in _leaf_refs(c.arg_refs):
                if ref[0] == "val":
                    last[ref[1]] = i
        for ref in self.carry_out:
            if ref[0] == "val":
                last.pop(ref[1], None)
        self.dead_after: List[List[Tuple[int, int]]] = [
            [] for _ in self.calls]
        for key, i in last.items():
            self.dead_after[i].append(key)

    def _mark_donations(self) -> None:
        """Static release plan (the reference's donation plan): an
        argument is released when it is loop-owned (a carry leaf or a
        live call's output), this is its LAST use in the iteration, and
        it does not survive into the next carry. Tree arguments stay
        pinned."""
        survivors = set()
        for slot, ref in enumerate(self.carry_out):
            if ref[0] in ("carry", "val"):
                survivors.add((ref[0], ref[1]))
            else:
                # folded-const carry-out: the slot hands back the SAME
                # tensor every iteration and holds it on entry
                survivors.add(("carry", slot))
        by_ref: Dict[Tuple, List[int]] = {}
        for slot, ref in enumerate(self.carry_out):
            if ref[0] in ("carry", "val"):
                by_ref.setdefault((ref[0], ref[1]), []).append(slot)
        for slots in by_ref.values():
            if len(slots) > 1:
                # aliased carry-out: the next iteration's incoming carry
                # leaves are one tensor
                for s in slots:
                    survivors.add(("carry", s))
        last_use: Dict[Tuple, Tuple[int, int]] = {}
        for i, c in enumerate(self.calls):
            seen_here: Dict[Tuple, int] = {}
            for p, ref in enumerate(c.arg_refs):
                if ref[0] not in ("carry", "val"):
                    continue
                key = (ref[0], ref[1])
                seen_here[key] = seen_here.get(key, 0) + 1
                last_use[key] = (i, p)
            # passed twice to one call, or also read through a tree
            # argument of it: never released
            for key, k in seen_here.items():
                if k > 1:
                    last_use.pop(key, None)
            for ref in c.arg_refs:
                if ref[0] == "tree":
                    for s in ref[2]:
                        if s[0] != "const":
                            last_use[(s[0], s[1])] = (i, -1)
        for i, c in enumerate(self.calls):
            pos = tuple(sorted(
                p for p, ref in enumerate(c.arg_refs)
                if ref[0] in ("carry", "val")
                and (ref[0], ref[1]) not in survivors
                and last_use.get((ref[0], ref[1])) == (i, p)))
            c.donate_pos = pos

    # -- execution ------------------------------------------------------
    def _run_calls(self, carry: List[Any], raw: bool,
                   release: Optional[Callable] = None) -> List[Any]:
        """One tape iteration over ``carry``: through the dispatch choke
        point, or (``raw``) the programs' functions themselves, as the
        whole-loop program runs them. ``release(i, args, vals)`` drops
        call ``i``'s dead whole arguments after it returns (the counted
        positions). A raw or releasing run also drops every output after
        its last reader, those read through a list or dict argument too,
        so an iteration holds no more than the plain loop does; a run
        that releases nothing holds them to the iteration's end."""
        vals: Dict[Tuple[int, int], Any] = {}

        def resolve(ref):
            kind = ref[0]
            if kind == "const":
                return ref[1]
            if kind == "carry":
                return carry[ref[1]]
            if kind == "val":
                return vals[ref[1]]
            return pt.unflatten(ref[1], [resolve(s) for s in ref[2]])

        used = self.used_outputs
        for i, call in enumerate(self.calls):
            args = [resolve(ref) for ref in call.arg_refs]
            if raw:
                out = call.fn.fn(*args)
            else:
                # through the choke point with every argument still held:
                # a rung-2 retry (mem/pressure.py recover_dispatch) runs
                # again on the same tensors, and a call that raises
                # releases nothing, so the loop can still fall back to a
                # plain iteration (reference: ``_donate_base``,
                # thrill_tpu/mem/pressure.py:392-420)
                out = call.fn(*args)
                if release is not None and call.donate_pos:
                    release(i, args, vals)
            leaves = pt.flatten(out)[0]
            if call.host_read and _out_sig(leaves) != call.out_sig:
                raise RuntimeError(
                    f"loop '{self.name}': a replayed call made outputs of "
                    f"other shapes than at the capture")
            for j, o in enumerate(leaves):
                if (i, j) in used:
                    vals[(i, j)] = o
            del args, out, leaves
            if raw or release is not None:
                for key in self.dead_after[i]:
                    vals.pop(key, None)
        return [carry[ref[1]] if ref[0] == "carry"
                else ref[1] if ref[0] == "const"
                else vals[ref[1]] for ref in self.carry_out]

    def replay(self, carry: List[Any], donate: bool,
               donate_carry: bool = True) -> List[Any]:
        """Run one tape iteration over ``carry`` leaves; returns the
        next carry leaves. With ``donate`` each call's dead loop-owned
        arguments are dropped right after it returns (``carry`` entries
        become None); ``donate_carry=False`` pins the incoming carry
        (first replay; the iteration after a checkpoint seal)."""
        mex = self.mex
        if not donate:
            return self._run_calls(carry, raw=False)

        def release(i, args, vals):
            call = self.calls[i]
            for p in call.donate_pos:
                ref = call.arg_refs[p]
                if ref[0] == "carry":
                    if not donate_carry:
                        continue
                    carry[ref[1]] = None
                else:
                    vals.pop(ref[1], None)
                a = args[p]
                if isinstance(a, torch.Tensor):
                    mex.stats_loop_donated_bytes += a.numel() * a.element_size()
                args[p] = None

        return self._run_calls(carry, raw=False, release=release)

    # -- the whole loop as one program ------------------------------------
    def fori_eligible(self) -> bool:
        """The tape can run as one program: on the CPU any tape (a Python
        loop over its calls, as the reference lowers any all-device
        tape); on the card a tape whose every live call ran without a
        host read or a CPU tensor during the capture (a CUDA graph holds
        no host work), on a mesh of one process (see
        :func:`graph_off_reason`)."""
        if not self.calls:
            return False
        if self.mex.device.type != "cuda":
            return True
        return (graph_off_reason(self.mex) is None
                and not any(c.host_read for c in self.calls))

    def run_fori(self, carry: List[Any], k: int) -> Optional[List[Any]]:
        """The remaining ``k`` iterations as ONE dispatch through the
        choke point, or None when the tape cannot go into a graph (logged
        ``loop_fori_unavailable``). The incoming carry is never released
        here."""
        if self._fori_failed or not self.fori_eligible():
            return None
        mex = self.mex
        prog = mex.program(("loop_fori",), _whole_loop)
        try:
            return list(prog(self, list(carry), k))
        except _GraphUnavailable as e:          # a call a graph cannot hold
            self._fori_failed = True
            log = getattr(mex, "logger", None)
            if log is not None and log.enabled:
                log.line(event="loop_fori_unavailable", loop=self.name,
                         error=repr(e.__cause__)[:200])
            return None


class _GraphUnavailable(Exception):
    """The tape could not be captured in a CUDA graph."""


def graph_off_reason(mex) -> Optional[str]:
    """Why the whole-loop CUDA graph cannot run on this mesh, or None:
    across processes the collectives of the tape (gloo) run on the host,
    and a CUDA graph holds no host work."""
    if mex.multiprocess and mex.device.type == "cuda":
        return ("collectives across processes run on the host (gloo) "
                "and cannot be captured in a CUDA graph")
    return None


def _agree_plan(ctx, name: str, plan: Optional["LoopPlan"],
                info: Dict[str, str]) -> Optional["LoopPlan"]:
    """Across processes, replay only when every process captured: each
    replays its tape with its collectives, and a process running the
    plain body would run other ones. The choice is a ``loop_plan``
    decision record; one process's miss drops every plan."""
    mex = ctx.mesh_exec
    votes = mex.allgather_object(
        None if plan is not None else info.get("reason", "?"))
    missed = [(p, r) for p, r in enumerate(votes) if r is not None]
    if missed and plan is not None:
        plan = None
        info["reason"] = (f"process {missed[0][0]} missed its capture: "
                          f"{missed[0][1]}")[:200]
        if ctx.logger.enabled:
            ctx.logger.line(event="loop_capture_miss", loop=name,
                            reason=info["reason"])
    led = _decisions.ledger_of(mex)
    if led is not None:
        led.record("loop_plan", "loop:" + name,
                   "replay" if plan is not None else "plain",
                   rejected=[("plain" if plan is not None else "replay",
                              None)],
                   reason=("every process captured" if plan is not None
                           else info.get("reason", "?")),
                   processes=mex.num_processes,
                   graph_off=graph_off_reason(mex))
    return plan


def _whole_loop(plan: LoopPlan, carry: List[Any], k: int) -> List[Any]:
    """Program: ``k`` tape iterations, a CUDA graph's replays on the
    card or the tape's functions in a Python loop on the CPU."""
    if plan.mex.device.type == "cuda":
        return _graph_loop(plan, carry, k)
    for _ in range(k):
        carry = plan._run_calls(carry, raw=True)
    return carry


def _graph_loop(plan: LoopPlan, carry: List[Any], k: int) -> List[Any]:
    """``k`` tape iterations on the card: the first runs eagerly on a side
    stream (it warms the tape up for the capture), then one iteration is
    captured in a ``torch.cuda.CUDAGraph`` over static carry buffers,
    the carry-out copied into them at the graph's end, and replayed
    ``k - 1`` times. Every kernel wrapper launches on
    ``torch.cuda.current_stream()``, the capture stream during the
    capture. The wrappers' launch counts follow what runs: the capture
    launches nothing, each replay what the capture recorded. A failure
    before the replays raises :class:`_GraphUnavailable`; the carry is
    untouched."""
    counters = _launch_counters()
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    try:
        with torch.cuda.stream(side):
            out = plan._run_calls(list(carry), raw=True)
        cur.wait_stream(side)
        if k == 1:
            return out
        # the graph's carry buffers, made on the stream that reads them
        static = [o.clone() for o in out]
        del out
        keys = {_skey(t) for t in static}
        before = [f.launches for f in counters]
        graph = torch.cuda.CUDAGraph()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                outs = plan._run_calls(list(static), raw=True)
                # an output that is (a view of) a carry buffer is read
                # before the copies below overwrite it
                outs = [o.clone() if _skey(o) in keys else o for o in outs]
                for s, o in zip(static, outs):
                    s.copy_(o)
                del outs
            finally:
                per_iter = [f.launches - b for f, b in zip(counters, before)]
                for f, b in zip(counters, before):
                    f.launches = b
                graph.capture_end()
        cur.wait_stream(side)
    except Exception as e:
        raise _GraphUnavailable() from e
    _replay(graph, k - 1)
    for f, n in zip(counters, per_iter):
        f.launches += n * (k - 1)
    return static


def _replay(graph: "torch.cuda.CUDAGraph", n: int) -> None:
    """``n`` replays of ``graph`` (one function, so a measurement can
    wrap the replays alone)."""
    for _ in range(n):
        graph.replay()


# ----------------------------------------------------------------------
# carry plumbing
# ----------------------------------------------------------------------

class _LoopCarryNode(DIABase):
    """Source node over the materialized carry of one iteration."""

    def __init__(self, ctx, shards: DeviceShards) -> None:
        super().__init__(ctx, "LoopCarry")
        self._carry = shards

    def compute(self) -> DeviceShards:
        return self._carry

    def materialize(self, consume: bool = False):
        # the carry goes once the node holds its result (or has handed
        # it over): a retried compute still finds it
        out = super().materialize(consume)
        self._carry = None
        return out


def _carry_dia(ctx, shards) -> DIA:
    return DIA(_LoopCarryNode(ctx, shards))


def _shards_carry_ids(shards: DeviceShards) -> Tuple[Dict[int, int], int]:
    leaves = pt.leaves(shards.tree)
    ids = {id(l): s for s, l in enumerate(leaves)}
    n = len(leaves)
    if shards._counts_dev is not None and shards._counts_host is None:
        ids[id(shards._counts_dev)] = n
        n += 1
    return ids, n


def _leaf_sig(leaves: Sequence[Any]) -> Tuple:
    return tuple((l.dtype, tuple(l.shape)) for l in leaves)


# ----------------------------------------------------------------------
# Iterate
# ----------------------------------------------------------------------

def Iterate(ctx, body: Callable, carry: Any, n: int, *, name: str = "loop",
            checkpoint_every: Optional[int] = None) -> Any:
    """Run ``body`` ``n`` times with ``carry`` threaded through,
    replaying a captured LoopPlan for iterations 2..N.

    ``carry`` is a DIA / DeviceShards (``body(dia) -> dia``) or a pytree
    of tensors (``body(tree) -> tree``). The body must be
    iteration-index-independent: same graph, same shapes every iteration
    (a violation rejects the capture and the loop runs plain; it cannot
    corrupt, except through the blind spot of the module docstring).
    ``checkpoint_every`` needs a DIA carry. Returns the final carry in
    the form it was given (a DIA in, a DIA out)."""
    if n <= 0:
        return carry
    mex = ctx.mesh_exec
    log = ctx.logger
    mgr = getattr(ctx, "checkpoint", None)

    # -- normalize the carry -------------------------------------------
    dia_mode = isinstance(carry, (DIA, DIABase, DeviceShards, HostShards))
    if checkpoint_every and not dia_mode:
        # an epoch holds shards: a pytree carry cannot be sealed, and
        # skipping the seals would not give the durability asked for
        raise ValueError(
            "Iterate(checkpoint_every=...) requires a DIA/DeviceShards "
            "carry; pytree carries cannot be sealed into checkpoint "
            "epochs (wrap the state in a DIA, or drop checkpoint_every)")
    if isinstance(carry, DIABase):
        carry = DIA(carry)
    if isinstance(carry, DIA):
        state = carry._link().pull(consume=True)
    elif dia_mode:
        state = carry
    else:
        state = pt.tree_map(lambda x: torch.as_tensor(x, device=mex.device),
                            carry)

    start = 0
    if mgr is not None and checkpoint_every and dia_mode:
        restored = mgr.try_restore_loop(name)
        if restored is not None:
            state, start = restored
            start += 1                  # go on after the sealed iteration

    can_replay = (replay_enabled()
                  and not (mgr is not None and mgr.auto)
                  and (not dia_mode or isinstance(state, DeviceShards)))

    def run_body(st):
        """One plain iteration: st -> next st, through the full pull
        recursion and the stitching planner."""
        if dia_mode:
            out = body(_carry_dia(ctx, st))
            if isinstance(out, DIABase):
                out = DIA(out)
            return out._link().pull(consume=True)
        return body(st)

    def seal(st, i):
        if mgr is not None and checkpoint_every and dia_mode \
                and (i + 1) % checkpoint_every == 0 and i + 1 < n:
            mgr.save_loop_state(name, i, st)
            return True
        return False

    plan: Optional[LoopPlan] = None
    donate = donation_enabled(mex.device)
    # consecutive capture misses: a miss is almost always deterministic
    # (eager body math, a data-dependent plan); two strikes and the rest
    # of the loop runs plain
    miss_streak = 0
    # the plan store's record of this loop: a loop known not to capture
    # skips the capture probes; a captured tape is compared on capture
    tape_token = _tape_token(name, dia_mode, state, body) \
        if can_replay else None
    tape_seed = None
    # the store's outcome for the loop report: "tape" (the fresh tape
    # matched its record), "stale" (it did not), "nocapture" (probes
    # skipped)
    seed_mode: Optional[str] = None
    if tape_token is not None:
        from ..data.exchange import plan_seed as _plan_seed
        tape_seed = _plan_seed(mex, "loop_tape", tape_token)
        if isinstance(tape_seed, dict) \
                and tape_seed.get("capture") is False:
            miss_streak = 2
            seed_mode = "nocapture"
            _note_tape(mex, tape_token, tape_seed)
            if log.enabled:
                log.line(event="loop_seed_nocapture", loop=name,
                         reason=str(tape_seed.get("reason", "?"))[:200])
            tape_seed = None
    last_miss: Dict[str, str] = {}
    report = {"name": name, "iters": n - start, "captures": 0, "replays": 0,
              "fori_iters": 0, "fallbacks": 0, "capture_s": 0.0,
              "replay_s": 0.0, "calls": 0, "pruned": 0,
              "donated_bytes0": mex.stats_loop_donated_bytes}
    graph_off = graph_off_reason(mex) if can_replay else None
    if graph_off is not None:
        # the loop's stats say why the replays run per iteration
        report["graph_off"] = graph_off
        if log.enabled:
            log.line(event="loop_fori_unavailable", loop=name,
                     error=graph_off)
    tracer = getattr(ctx, "tracer", None)
    tr_on = tracer is not None and tracer.enabled
    i = start
    fresh_plan = ckpt = False
    while i < n:
        if plan is None:
            # ---- capture (or plain) iteration ------------------------
            t0 = time.perf_counter()
            d0, f0, l0 = mex.stats_dispatches, mex.stats_fetches, \
                _launch_snapshot()
            sp = (tracer.begin("loop", "capture", loop=name, iter=i)
                  if tr_on else None)
            try:
                if can_replay and miss_streak < 2:
                    state, plan = _capture(ctx, run_body, state, name=name,
                                           it=i, info=last_miss)
                    if mex.multiprocess:
                        plan = _agree_plan(ctx, name, plan, last_miss)
                    if plan is not None:
                        miss_streak = 0
                        mex.stats_loop_plan_builds += 1
                        report["captures"] += 1
                        report["calls"] = len(plan.calls)
                        report["pruned"] = (plan.pruned_invariant
                                            + plan.pruned_dead)
                        if tape_token is not None:
                            meta = _tape_meta(plan)
                            if isinstance(tape_seed, dict):
                                if (tape_seed.get("calls")
                                        == meta["calls"]
                                        and tape_seed.get("wiring")
                                        == meta["wiring"]):
                                    seed_mode = "tape"
                                else:
                                    seed_mode = "stale"
                                    if log.enabled:
                                        log.line(event="loop_seed_stale",
                                                 loop=name, iter=i)
                            tape_seed = None
                            _note_tape(mex, tape_token, meta)
                    else:
                        miss_streak += 1
                        if miss_streak >= 2 and tape_token is not None:
                            # a deterministic reject: a warm restart skips
                            # the capture probes
                            _note_tape(mex, tape_token, {
                                "capture": False,
                                "reason":
                                    last_miss.get("reason", "?")[:200]})
                else:
                    state = run_body(state)
            finally:
                if sp is not None:
                    tracer.end(sp, mode=("capture" if plan is not None
                                         else "plain"))
            dt = time.perf_counter() - t0
            report["capture_s"] += dt
            if log.enabled:
                log.line(event="iteration", loop=name, iter=i,
                         mode="capture" if plan is not None else "plain",
                         seconds=round(dt, 6),
                         dispatches=mex.stats_dispatches - d0,
                         fetches=mex.stats_fetches - f0,
                         launches=_launch_delta(l0),
                         plan_calls=(len(plan.calls)
                                     if plan is not None else None))
            ckpt = seal(state, i)
            i += 1
            fresh_plan = True
            continue

        # ---- replayed iterations -------------------------------------
        leaves, treedef = _carry_leaves(state, dia_mode, plan)
        if leaves is None:
            plan = None                      # carry shape drifted
            continue
        remaining = n - i
        # the whole loop only when no checkpoint epoch is due inside it
        fori_ok = fori_enabled() \
            and not (checkpoint_every and mgr is not None) \
            and plan.fori_eligible() and remaining > 1
        t0 = time.perf_counter()
        d0, f0, l0 = mex.stats_dispatches, mex.stats_fetches, \
            _launch_snapshot()
        donating = donate and not faults.REGISTRY.active()
        # one replay span a replayed iteration, or for the whole-loop
        # window (holding its one loop_fori dispatch span)
        sp = (tracer.begin("loop", "replay", loop=name, iter=i)
              if tr_on else None)
        try:
            try:
                if faults.REGISTRY.active():
                    faults.check(_F_REPLAY, loop=name, iter=i)
                if fori_ok:
                    out = plan.run_fori(leaves, remaining)
                    if out is not None:
                        mex.stats_loop_fori_iters += remaining
                        report["fori_iters"] += remaining
                        state = _rebuild_carry(out, treedef, dia_mode, mex,
                                               plan)
                        dt = time.perf_counter() - t0
                        report["replay_s"] += dt
                        if sp is not None:
                            sp.attrs["fori_iters"] = remaining
                        if log.enabled:
                            log.line(event="loop_replay", loop=name,
                                     iter=i, iters=remaining, fori=True,
                                     graph=mex.device.type == "cuda",
                                     seconds=round(dt, 6),
                                     dispatches=mex.stats_dispatches - d0,
                                     fetches=mex.stats_fetches - f0,
                                     launches=_launch_delta(l0))
                        i = n
                        continue
                if donating and not fresh_plan and not ckpt:
                    state = None             # the tape owns the carry now
                out = plan.replay(leaves, donating,
                                  donate_carry=not fresh_plan and not ckpt)
            except Exception as e:
                # LOUD degradation: a failed replayed iteration runs plain
                # (and captures again); the loop slows down, it never
                # lies. Unless the tape already dropped part of the
                # carry: then there is nothing to re-plan from
                if sp is not None:
                    sp.attrs["error"] = repr(e)[:200]
                if state is None:
                    if any(l is None for l in leaves):
                        raise RuntimeError(
                            f"loop '{name}' iteration {i}: a replayed "
                            f"dispatch failed after part of the loop carry "
                            f"was released; cannot degrade to re-planning. "
                            f"Re-run with THRILL_TPU_LOOP_DONATE=0 (or from "
                            f"the last checkpoint epoch).") from e
                    state = _rebuild_carry(leaves, treedef, dia_mode, mex,
                                           plan)
                mex.stats_loop_fallbacks += 1
                report["fallbacks"] += 1
                faults.note("recovery", what="loop_replay", loop=name,
                            iter=i, error=repr(e)[:200])
                if log.enabled:
                    log.line(event="loop_replay_fallback", loop=name,
                             iter=i, error=repr(e)[:200])
                plan = None
                continue
            mex.stats_loop_replays += 1
            report["replays"] += 1
            state = _rebuild_carry(out, treedef, dia_mode, mex, plan)
            out = leaves = None         # the state holds the carry alone
            dt = time.perf_counter() - t0
            report["replay_s"] += dt
            if log.enabled:
                log.line(event="loop_replay", loop=name, iter=i,
                         dispatches=mex.stats_dispatches - d0,
                         fetches=mex.stats_fetches - f0,
                         launches=_launch_delta(l0), seconds=round(dt, 6))
            ckpt = seal(state, i)
            fresh_plan = False
            i += 1
        finally:
            if sp is not None:
                tracer.end(sp)

    report["donated_bytes"] = (mex.stats_loop_donated_bytes
                               - report.pop("donated_bytes0"))
    if seed_mode is not None:
        report["seed"] = seed_mode
    mex.loop_reports.append(report)
    if log.enabled:
        log.line(event="loop_done", **{k: (round(v, 6)
                                           if isinstance(v, float) else v)
                                       for k, v in report.items()})
    return _carry_dia(ctx, state) if dia_mode else state


def _capture(ctx, run_body, state, name="loop", it=0, info=None):
    """Run one body iteration with the tape recorder installed. Returns
    (next_state, LoopPlan or None); a miss's reason goes into ``info``."""
    mex = ctx.mesh_exec
    log = ctx.logger

    def miss(reason, out_state):
        if info is not None:
            info["reason"] = reason
        if log.enabled:
            log.line(event="loop_capture_miss", loop=name, iter=it,
                     reason=reason)
        return out_state, None

    # De-alias the carry before recording: classification is by tensor
    # identity, so a carry leaf that is also a constant of the body (or
    # another carry slot) would record a lying ("carry", s) ref for the
    # constant. One copy per capture, nothing per replay.
    if isinstance(state, DeviceShards):
        state.tree = pt.tree_map(torch.clone, state.tree)
        if state._counts_dev is not None and state._counts_host is None:
            state._counts_dev = state._counts_dev.clone()
        carry_ids, n_carry = _shards_carry_ids(state)
        carry = pt.leaves(state.tree)
        if n_carry > len(carry):
            carry = carry + [state._counts_dev]
    else:
        leaves = pt.leaves(state)
        if not all(isinstance(l, torch.Tensor)
                   and l.device.type == mex.device.type for l in leaves):
            return miss("carry is not device-resident", run_body(state))
        state = pt.tree_map(torch.clone, state)
        carry = pt.leaves(state)
        carry_ids = {id(l): s for s, l in enumerate(carry)}
        n_carry = len(carry)
    rec = _Recorder(carry_ids, carry, mex.device)
    prev = mex.loop_recorder
    if prev is not None:
        # nested Iterate inside a capturing body: the inner loop's
        # dispatches bypass the OUTER recorder, so the outer tape would
        # skip the whole inner loop on replay; reject it loudly
        prev.dirty = "nested Iterate inside a capturing body"
    prev_tracker, prev_depth = taint.TRACKER, mex._depth
    mex.loop_recorder = rec
    taint.TRACKER = rec
    mex._depth = 0
    try:
        with _TaintMode(rec):
            out_state = run_body(state)
    finally:
        mex.loop_recorder = prev
        taint.TRACKER = prev_tracker
        mex._depth = prev_depth
    if rec.dirty is not None:
        return miss(rec.dirty, out_state)
    if mex._pending_checks:
        # an unresolved deferred validation (an undrained hinted-join
        # overflow check) cannot be replayed: it would never run
        return miss("pending deferred validations", out_state)

    # map the produced carry back onto the tape
    host_counts = None
    if isinstance(out_state, DeviceShards):
        if not isinstance(state, DeviceShards):
            return miss("carry storage changed", out_state)
        out_leaves = pt.leaves(out_state.tree)
        in_leaves = pt.leaves(state.tree)
        if _leaf_sig(out_leaves) != _leaf_sig(in_leaves) \
                or out_state.cap != state.cap \
                or pt.flatten(out_state.tree)[1] != pt.flatten(state.tree)[1]:
            return miss("carry schema/shape drifted", out_state)
        if state._counts_host is not None:
            # host-known input counts were baked into the tape's calls as
            # constants: the body must hand the same counts back, so
            # every replay's input matches them
            if out_state._counts_host is None:
                return miss("carry counts went device-resident across "
                            "the iteration (baked host count constants "
                            "cannot be checked)", out_state)
            if not np.array_equal(state._counts_host,
                                  out_state._counts_host):
                return miss("carry counts changed across the iteration "
                            "(baked count constants would lie on "
                            "replay)", out_state)
        if out_state._counts_host is not None:
            host_counts = out_state._counts_host
        else:
            out_leaves = out_leaves + [out_state._counts_dev]
    elif isinstance(out_state, HostShards):
        return miss("body produced host storage", out_state)
    else:
        out_leaves = pt.leaves(out_state)
        if not all(isinstance(l, torch.Tensor) for l in out_leaves) \
                or _leaf_sig(out_leaves) != _leaf_sig(pt.leaves(state)) \
                or pt.flatten(out_state)[1] != pt.flatten(state)[1]:
            return miss("carry schema/shape drifted", out_state)
    carry_out = []
    for leaf in out_leaves:
        same = (rec.views.get(_view_key(leaf))
                if _skey(leaf) is not None else None)
        if id(leaf) in rec.produced:
            carry_out.append(("val", rec.produced[id(leaf)]))
        elif id(leaf) in carry_ids:
            carry_out.append(("carry", carry_ids[id(leaf)]))
        elif same is not None:
            carry_out.append(same)
        else:
            return miss("carry leaf produced outside the recorded "
                        "dispatch stream (eager host math in the "
                        "body?)", out_state)
    plan = LoopPlan(mex, rec.calls, carry_out, n_carry, name=name,
                    plan_reads=rec.plan_reads)
    plan.host_ops = rec.host_ops
    if plan.invalid is not None:
        return miss(plan.invalid, out_state)
    if host_counts is not None:
        plan.counts = host_counts.copy()
    if log.enabled:
        log.line(event="loop_plan", loop=name, calls=len(plan.calls),
                 pruned_invariant=plan.pruned_invariant,
                 pruned_dead=plan.pruned_dead,
                 fori=plan.fori_eligible(),
                 donatable=sum(len(c.donate_pos) for c in plan.calls),
                 host_ops=plan.host_ops or None)
    return out_state, plan


def _carry_leaves(state, dia_mode, plan):
    """Current carry as tape-slot-ordered leaves (the capture's input
    convention); (None, None) when the state no longer matches."""
    if dia_mode:
        leaves = list(pt.leaves(state.tree))
        treedef = pt.flatten(state.tree)[1]
        if plan.n_carry == len(leaves) + 1:
            # the tape threads device-resident counts as a carry slot
            leaves.append(state.counts_device())
        elif plan.n_carry != len(leaves):
            return None, None
        return leaves, treedef
    leaves = list(pt.leaves(state))
    if len(leaves) != plan.n_carry:
        return None, None
    return leaves, pt.flatten(state)[1]


def _rebuild_carry(out_leaves, treedef, dia_mode, mex, plan):
    if not dia_mode:
        return pt.unflatten(treedef, list(out_leaves))
    if plan.counts is not None:
        return DeviceShards(mex, pt.unflatten(treedef, list(out_leaves)),
                            plan.counts.copy())
    return DeviceShards(mex, pt.unflatten(treedef, list(out_leaves[:-1])),
                        out_leaves[-1])
