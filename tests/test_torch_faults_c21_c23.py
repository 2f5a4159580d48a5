"""Faults C21-C23 (ROADMAP.md): element types the port refused.

* C23: a bool PrefixSum or ExPrefixSum raised (torch has no bool
  cumsum). It is the reference's scan now: a running OR per worker plus
  the count of earlier workers whose OR is true plus ``bool(initial)``,
  in int64. Held against the reference at W = 1, 2 and 4, inclusive and
  exclusive, with several initial values.
* C22: uint16, uint32 and uint64 columns raised in one process. They are
  held in torch's unsigned types and compute as the reference's
  unsigned arrays (core/unsigned.py). ``dtype_battery`` (the op battery's
  element-type part: AllGatherArrays, Gather, Sort, Min, Max, Sum,
  Size, PrefixSum, ExPrefixSum, Window, DisjointWindow, Zip, Merge,
  Sample, BernoulliSample, Rebalance, ReduceToIndex, ReduceByKey on the
  column and keyed by it, their min and max folds, GroupByKey, and Maps
  of ``x + 1``, ``x // 3``,
  the float64 conversion and a Filter of ``x > c`` over values above the
  signed maximum) runs at W = 4 against the reference, with the element
  types each egress returned.
* C21: 16-bit integers (and the wide unsigned types and bools) failed in
  the mesh's gathers and reductions across processes. Two real
  processes (gloo, two workers each) run the same battery, bit-equal to
  one process at W = 4 and to the reference. This file is the child.

Tolerance: exact everywhere (integer and bool columns).
"""

import functools
import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest

from thrill_tpu_torch.examples.op_battery import (
    DTYPE_COLUMNS, Port, dtype_battery)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LIMIT_S = 360


@pytest.fixture(autouse=True, scope="module")
def _file_time_limit():
    """This file's own time limit: a test still running past it fails."""
    def expired(*_):
        raise TimeoutError(f"{__name__}: past its {LIMIT_S} s limit")
    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


class _Ref:
    name = "ref"

    def __init__(self):
        import jax.numpy as jnp

        import thrill_tpu.api as api
        self.api = api
        self.xp = jnp

    def to_f64(self, x):
        return x.astype(self.xp.float64)


def _ref_ctx(W):
    import jax

    from thrill_tpu.api import Context as JContext
    from thrill_tpu.parallel.mesh import MeshExec as JMeshExec
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]))


@functools.lru_cache(maxsize=None)
def _ref_battery(name):
    ctx = _ref_ctx(4)
    try:
        return json.loads(json.dumps(dtype_battery(ctx, _Ref(), (name,))))
    finally:
        ctx.close()


@functools.lru_cache(maxsize=None)
def _port_battery(name):
    import thrill_tpu_torch as tt
    return json.loads(json.dumps(tt.Run(
        lambda ctx: dtype_battery(ctx, Port(), (name,)), 4, device="cpu")))


# ----------------------------------------------------------------------
# C23: bool PrefixSum
# ----------------------------------------------------------------------

@pytest.mark.parametrize("W", [1, 2, 4])
@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("initial", [0, 1, True])
def test_c23_bool_prefix_sum_is_the_reference_s(W, inclusive, initial):
    import thrill_tpu_torch as tt
    col = np.random.default_rng(W).random(37) < 0.3
    col[:9] = False                      # workers with no true item

    def job(ctx):
        d = ctx.Distribute(col)
        d = d.PrefixSum(initial=initial) if inclusive else \
            d.ExPrefixSum(initial=initial)
        return np.asarray(d.AllGatherArrays())

    port = tt.Run(job, W, device="cpu")
    ctx = _ref_ctx(W)
    try:
        ref = np.asarray(job(ctx))
    finally:
        ctx.close()
    assert port.tolist() == ref.tolist()
    assert str(port.dtype) == str(ref.dtype)


# ----------------------------------------------------------------------
# C22: unsigned columns in one process
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", DTYPE_COLUMNS)
def test_c22_the_element_type_battery_is_the_reference_s(name):
    port, ref = _port_battery(name), _ref_battery(name)
    assert set(port) == set(ref)
    for k in ref:
        assert port[k] == ref[k], k


def test_c22_unsigned_map_arithmetic_above_the_signed_maximum():
    """``x + 1``, ``x > c``, ``x // 3`` and the float conversion of
    values past each type's signed maximum, against numpy's unsigned
    arithmetic (the reference's), and the egress element type."""
    import torch

    import thrill_tpu_torch as tt
    for dt in (np.uint16, np.uint32, np.uint64):
        info = np.iinfo(dt)
        col = np.array([0, 1, info.max // 2, info.max // 2 + 1,
                        info.max - 2, info.max], dtype=dt)
        c = int(info.max // 2 + 1)

        def job(ctx):
            d = ctx.Distribute(col).Keep(4)
            return (np.asarray(d.Map(lambda x: x + 1).AllGatherArrays()),
                    np.asarray(d.Filter(lambda x: x > c).AllGatherArrays()),
                    np.asarray(d.Map(lambda x: x // 3).AllGatherArrays()),
                    np.asarray(d.Map(lambda x: x.to(torch.float64))
                               .AllGatherArrays()))

        add, gt, div, f64 = tt.Run(job, 4, device="cpu")
        assert add.dtype == dt and add.tolist() == (col + dt(1)).tolist()
        assert gt.tolist() == col[col > c].tolist()
        assert div.dtype == dt and div.tolist() == (col // dt(3)).tolist()
        assert f64.tolist() == col.astype(np.float64).tolist()


@pytest.mark.parametrize("name", ["uint16", "uint32", "uint64"])
def test_c22_ordering_and_in_place_ops_read_the_unsigned_value(name):
    """The ordering ops (the fold sites' ``scatter_reduce_`` of
    ``amin``/``amax`` from the type's extreme, max/min with and without
    a dim, clamp, sort, argsort, topk, searchsorted) and the in-place
    ops that do not only move bits (``clamp_``, ``//=``, ``>>=``) on
    values past the signed maximum, in :class:`UnsignedMode`, against
    numpy's unsigned arithmetic."""
    import torch

    from thrill_tpu_torch.core import unsigned
    info = np.iinfo(name)
    a = np.array([0, 1, info.max // 2, info.max // 2 + 1, info.max - 2,
                  info.max, 5, info.max // 2 + 7], dtype=name)
    seg = np.array([0, 1, 0, 1, 2, 2, 0, 1])
    c = int(info.max // 2 + 3)
    t = torch.as_tensor(a)
    idx = torch.as_tensor(seg)

    def ints(x):
        return [int(v) for v in np.asarray(x).reshape(-1).tolist()]

    with unsigned.scope_for(t):
        lo = torch.full((3,), int(info.max), dtype=t.dtype)
        lo.scatter_reduce_(0, idx, t, "amin")
        hi = torch.full((3,), 0, dtype=t.dtype).scatter_reduce_(
            0, idx, t, "amax")
        hi2 = torch.zeros(3, dtype=t.dtype).scatter_reduce(
            0, idx, t, "amax", include_self=False)
        mx, mn = t.max(), t.amin()
        by_dim = t.reshape(2, 4).max(dim=1)
        clamped = t.clamp(max=c)
        clamped_ = t.clone()
        clamped_.clamp_(min=c)
        srt = t.sort()
        order = torch.argsort(t, stable=True)
        top = t.topk(3).values
        pos = torch.searchsorted(t.sort().values, t)
        div = t.clone()
        div //= 3
        shr = t.clone()
        shr >>= 2
        one = int(t[5])
    want_lo = [int(a[seg == s].min()) for s in range(3)]
    want_hi = [int(a[seg == s].max()) for s in range(3)]
    assert ints(lo) == want_lo and lo.dtype == t.dtype
    assert ints(hi) == want_hi and ints(hi2) == want_hi
    assert mx.item() == int(a.max()) and mn.item() == int(a.min())
    assert ints(by_dim.values) == ints(a.reshape(2, 4).max(axis=1))
    assert ints(by_dim.indices) == ints(a.reshape(2, 4).argmax(axis=1))
    assert by_dim.indices.dtype == torch.int64
    assert ints(clamped) == ints(np.minimum(a, a.dtype.type(c)))
    assert ints(clamped_) == ints(np.maximum(a, a.dtype.type(c)))
    assert ints(srt.values) == ints(np.sort(a))
    assert ints(srt.indices) == ints(np.argsort(a, kind="stable"))
    assert ints(order) == ints(np.argsort(a, kind="stable"))
    assert ints(top) == ints(np.sort(a)[::-1][:3])
    assert ints(pos) == ints(np.searchsorted(np.sort(a), a))
    assert ints(div) == ints(a // a.dtype.type(3)) and div.dtype == t.dtype
    assert ints(shr) == ints(a >> a.dtype.type(2)) and shr.dtype == t.dtype
    assert one == int(a[5])


# ----------------------------------------------------------------------
# C21: the same battery on two real processes
# ----------------------------------------------------------------------

def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def test_c21_two_processes_are_one_process_and_the_reference(tmp_path):
    from thrill_tpu_torch.common.timeouts import scaled
    ports = _free_ports(3)
    coordinator = f"127.0.0.1:{ports[0]}"
    hostlist = " ".join(f"127.0.0.1:{p}" for p in ports[1:])
    procs = []
    for rank in range(2):
        env = dict(os.environ, THRILL_TPU_HOSTLIST=hostlist,
                   THRILL_TPU_RANK=str(rank),
                   THRILL_TPU_SECRET="test-cluster-secret",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), coordinator,
             str(rank), str(tmp_path)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env))
    try:
        # the one-process runs go on while the children work
        one = {k: v for n in DTYPE_COLUMNS
               for k, v in _port_battery(n).items()}
        ref = {k: v for n in ("int16", "uint16")
               for k, v in _ref_battery(n).items()}
        outs = [p.communicate(timeout=scaled(240)) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, (_o, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-3000:]
        with open(tmp_path / f"result-{rank}.json") as f:
            got = json.load(f)
        assert got == one
        for k, v in ref.items():
            assert got[k] == v, k


def _child(coordinator, rank, tmp):
    import thrill_tpu_torch as tt
    res = tt.RunDistributed(lambda ctx: dtype_battery(ctx, Port()),
                            coordinator_address=coordinator,
                            num_processes=2, process_id=rank,
                            workers_per_process=2, device="cpu")
    with open(os.path.join(tmp, f"result-{rank}.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), sys.argv[3])
