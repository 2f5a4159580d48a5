"""The port's loop layer (``thrill_tpu_torch/api/loop.py``: capture,
replay, release and the whole-loop program) against the reference
package's on the CPU.

Every test of the reference's ``tests/api/test_loop.py`` has its
counterpart here under the same name: the same inputs, made from numpy
seeds, run through the reference's ``Iterate`` on JAX's CPU and the
port's with ``device="cpu"``, at the worker counts the reference test
uses (and more where it is cheap). Results must be equal bit for bit,
except PageRank's f64 ranks across the two packages, which differ in the
last bit on some pages in every mode, replayed or not, and are held
within ``PR_ATOL`` (``test_torch_examples.py``'s bound); within the port
every mode is bit-equal to the plain loop. The five loop stats (``loop_plan_builds``, ``loop_replays``,
``loop_fori_iters``, ``loop_replay_fallbacks``, ``loop_donated_bytes``)
and the release positions of ``LoopPlan`` built from the same ``_Call``
wiring. Where the reference rejects a capture or falls back, the port
must too. The port's own cases follow: an in-place update, a kernel that
does not report its edge, ``jit_cached`` as a dispatch, the k-means
dispatch counts and the rung-2 retry of a replayed call.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thrill_tpu.api import Run as JRun
from thrill_tpu.api.context import Context as JContext
from thrill_tpu.api.loop import Iterate as JIterate
from thrill_tpu.api.loop import LoopPlan as JLoopPlan
from thrill_tpu.api.loop import _Call as JCall
from thrill_tpu.common import faults as jfaults
from thrill_tpu.common.config import Config as JConfig
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.api import loop as tloop
from thrill_tpu_torch.common import faults
from thrill_tpu_torch.common.config import Config
from thrill_tpu_torch.examples import k_means as tkm
from thrill_tpu_torch.examples import page_rank as tpr

_EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "examples")
PR_ATOL = 1e-12          # port vs reference f64 ranks (XLA's rounding)
LOOP_KEYS = ("loop_plan_builds", "loop_replays", "loop_fori_iters",
             "loop_replay_fallbacks", "loop_donated_bytes")
ENV = ("THRILL_TPU_LOOP_REPLAY", "THRILL_TPU_LOOP_FORI",
       "THRILL_TPU_LOOP_DONATE", "THRILL_TPU_FUSE", "THRILL_TPU_CKPT_DIR",
       "THRILL_TPU_RESUME", "THRILL_TPU_HBM_LIMIT", faults.ENV_VAR)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()
    yield
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()


def _ref_examples():
    if _EXAMPLES not in sys.path:
        sys.path.insert(0, _EXAMPLES)
    import k_means as jkm
    import page_rank as jpr
    return jpr, jkm


def _loop_stats(ctx) -> dict:
    s = ctx.overall_stats()
    return {k: s[k] for k in LOOP_KEYS}


def _both(W, run):
    """``run(ctx, pkg)`` on the reference and on the port; returns
    ((ref result, ref stats), (port result, port stats))."""
    out = []
    for pkg in ("ref", "port"):
        ctx = (JContext(JMeshExec(num_workers=W)) if pkg == "ref"
               else tt.Context(num_workers=W, device="cpu"))
        try:
            got = run(ctx, pkg)
            out.append((got, ctx.overall_stats()))
        finally:
            ctx.close()
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _edges(pages=512, m=4096):
    return tpr.zipf_graph(pages, m)


def _pagerank(pages=512, iters=5, edges=None):
    edges = _edges(pages, 8 * pages) if edges is None else edges
    jpr, _ = _ref_examples()

    def run(ctx, pkg):
        mod = jpr if pkg == "ref" else tpr
        return mod.page_rank(ctx, edges, pages, iterations=iters)

    return run


def _assert_same(ref, port, keys=LOOP_KEYS, atol=0.0):
    """Equal stats; equal values, bit for bit unless ``atol`` is given."""
    (rv, rs), (pv, ps) = ref, port
    assert {k: ps[k] for k in keys} == {k: rs[k] for k in keys}
    if atol:
        assert np.abs(_np(pv) - _np(rv)).max() <= atol
    else:
        assert np.array_equal(_np(pv), _np(rv))


# ----------------------------------------------------------------------
# capture-once / replay semantics
# ----------------------------------------------------------------------

@pytest.mark.parametrize("W", [1, 2, 4])
def test_pagerank_plan_once_replay_4x(W, monkeypatch):
    """One LoopPlan, replayed for iterations 2..5 (whole loop off); the
    ranks bit-equal to the reference's and to the un-replayed path."""
    monkeypatch.setenv("THRILL_TPU_LOOP_FORI", "0")
    ref, port = _both(W, _pagerank())
    _assert_same(ref, port, atol=PR_ATOL)
    assert port[1]["loop_plan_builds"] == 1
    assert port[1]["loop_replays"] == 4
    monkeypatch.setenv("THRILL_TPU_LOOP_REPLAY", "0")
    ref0, port0 = _both(W, _pagerank())
    _assert_same(ref0, port0, atol=PR_ATOL)
    assert port0[1]["loop_plan_builds"] == port0[1]["loop_replays"] == 0
    assert np.array_equal(port[0], port0[0])


@pytest.mark.parametrize("W", [1, 2, 4])
def test_pagerank_fori_whole_loop(W, monkeypatch):
    """Iterations 2..N as ONE whole-loop dispatch, as the reference's
    fori_loop, bit-equal to per-iteration replay."""
    ref, port = _both(W, _pagerank())
    _assert_same(ref, port, LOOP_KEYS + ("device_dispatches",), PR_ATOL)
    assert port[1]["loop_fori_iters"] == 4
    monkeypatch.setenv("THRILL_TPU_LOOP_FORI", "0")
    ref1, port1 = _both(W, _pagerank())
    _assert_same(ref1, port1, atol=PR_ATOL)
    assert np.array_equal(port[0], port1[0])


@pytest.mark.parametrize("W", [1, 2])
def test_pagerank_parity_vs_fuse0(W, monkeypatch):
    ref, port = _both(W, _pagerank())
    _assert_same(ref, port, atol=PR_ATOL)
    monkeypatch.setenv("THRILL_TPU_FUSE", "0")
    ref0, port0 = _both(W, _pagerank())
    _assert_same(ref0, port0, atol=PR_ATOL)
    assert port0[1]["loop_plan_builds"] == 1
    assert np.array_equal(port[0], port0[0])


def _step_half(x):
    return x * 0.5 + 1.0


def test_pytree_carry_fori():
    """The k-means idiom: a pytree carry whose body is a cached program
    lowers the whole loop into one dispatch."""
    def run(ctx, pkg):
        mex = ctx.mesh_exec
        step = mex.jit_cached(("test_loop_step",),
                              lambda t: {"x": t["x"] * 0.5 + 1.0,
                                         "n": t["n"] + 1})
        if pkg == "ref":
            carry = {"x": jnp.arange(8, dtype=jnp.float64),
                     "n": jnp.int64(0)}
            out = JIterate(ctx, step, carry, 6, name="pytree")
        else:
            carry = {"x": torch.arange(8, dtype=torch.float64),
                     "n": torch.tensor(0, dtype=torch.int64)}
            out = tt.Iterate(ctx, step, carry, 6, name="pytree")
        return np.concatenate([_np(out["x"]), [float(out["n"])]])

    ref, port = _both(1, run)
    _assert_same(ref, port)
    assert port[1]["loop_fori_iters"] == 5 and port[0][-1] == 6


@pytest.mark.parametrize("arm_oom", [False, True])
def test_fori_dispatch_rides_counted_jit_choke_point(arm_oom, monkeypatch):
    """The whole-loop program dispatches through the choke point:
    admission sees it under a budget, and an injected OOM at it recovers
    (rung 2 or the re-plan fallback) with exact results, the same
    counters as the reference's."""
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    if not arm_oom:
        monkeypatch.setenv("THRILL_TPU_HBM_LIMIT", "1Gi")

    def run(ctx, pkg):
        step = ctx.mesh_exec.jit_cached(
            ("fori_choke_step",), lambda t: {"x": t["x"] * 0.5 + 1.0})
        if pkg == "ref":
            carry, it, inj = ({"x": jnp.arange(8, dtype=jnp.float64)},
                              JIterate, jfaults.inject)
        else:
            carry, it, inj = ({"x": torch.arange(8, dtype=torch.float64)},
                              tt.Iterate, faults.inject)
        if arm_oom:
            with inj("mem.oom", n=1, seed=5):
                out = it(ctx, step, carry, 6, name="fori_choke")
        else:
            out = it(ctx, step, carry, 6, name="fori_choke")
        return _np(out["x"])

    want = np.arange(8, dtype=np.float64)
    for _ in range(6):
        want = want * 0.5 + 1.0
    ref, port = _both(1, run)
    keys = LOOP_KEYS + ("oom_retries",)
    _assert_same(ref, port, keys)
    assert np.allclose(port[0], want)
    if arm_oom:
        assert port[1]["oom_retries"] >= 1 \
            or port[1]["loop_replay_fallbacks"] >= 1
    else:
        assert port[1]["loop_fori_iters"] == 5
        assert port[1]["hbm_high_watermark"] > 0


@pytest.mark.parametrize("fori", ["0", "1"])
def test_invariant_producer_carry_leaf_folds_to_const(fori, monkeypatch):
    """A carry leaf recomputed each iteration from constants only folds:
    the tape returns the captured value."""
    monkeypatch.setenv("THRILL_TPU_LOOP_FORI", fori)

    def run(ctx, pkg):
        mex = ctx.mesh_exec
        base = (jnp.arange(4, dtype=jnp.float64) if pkg == "ref"
                else torch.arange(4, dtype=torch.float64))
        step_x = mex.jit_cached(("inv_step_x",), lambda x: x * 0.5 + 1.0)
        step_t = mex.jit_cached(("inv_step_t",), lambda t: t * 2.0)

        def body(c):
            return {"x": step_x(c["x"]), "t": step_t(base)}

        it = JIterate if pkg == "ref" else tt.Iterate
        out = it(ctx, body, {"x": base, "t": base}, 5, name="invariant")
        return np.concatenate([_np(out["x"]), _np(out["t"])])

    ref, port = _both(1, run)
    _assert_same(ref, port)
    assert port[1]["loop_plan_builds"] == 1
    assert np.array_equal(port[0][4:], np.arange(4) * 2.0)


# ----------------------------------------------------------------------
# loud degradation
# ----------------------------------------------------------------------

def test_eager_body_rejects_capture():
    """A carry made outside the recorded dispatch stream (a host round
    trip) rejects the capture: the plain loop runs."""
    def run(ctx, pkg):
        if pkg == "ref":
            return JIterate(ctx, lambda t: jnp.asarray(np.asarray(t) * 2.0),
                            jnp.arange(4, dtype=jnp.float64), 3,
                            name="eager")
        return tt.Iterate(ctx, lambda t: torch.as_tensor(t.numpy() * 2.0),
                          torch.arange(4, dtype=torch.float64), 3,
                          name="eager")

    ref, port = _both(1, run)
    _assert_same(ref, port)
    assert np.array_equal(port[0], np.arange(4) * 8.0)
    assert port[1]["loop_plan_builds"] == port[1]["loop_replays"] == 0


@pytest.mark.parametrize("W", [2, 4])
def test_data_dependent_exchange_rejects_capture(W):
    """k-means at W > 1: the exchange's send matrix follows the changing
    labels, so the capture is rejected (plain loop, exact centers)."""
    _, jkm = _ref_examples()
    pts = np.random.default_rng(0).normal(size=(512, 4))

    def run(ctx, pkg):
        mod = jkm if pkg == "ref" else tkm
        return mod.k_means(ctx, pts, 8, iterations=4, seed=0)

    ref, port = _both(W, run)
    _assert_same(ref, port)
    assert port[1]["loop_plan_builds"] == port[1]["loop_replays"] == 0
    c0 = pts[np.random.default_rng(0).choice(512, size=8, replace=False)]
    assert np.allclose(port[0], jkm.k_means_dense(pts, c0.copy(), 4),
                       rtol=1e-6, atol=1e-8)


@pytest.mark.chaos
@pytest.mark.parametrize("W", [1, 2])
def test_replay_fault_degrades_to_replanning(W, monkeypatch):
    """An injected failure at api.loop.replay falls back to a plain
    iteration that captures again; bit-equal ranks, one fallback."""
    want = _both(W, _pagerank())
    monkeypatch.setenv(faults.ENV_VAR, "api.loop.replay:p=1.0:n=1")
    faults.REGISTRY.reset()
    jfaults.REGISTRY.reset()
    ref, port = _both(W, _pagerank())
    _assert_same(ref, port, atol=PR_ATOL)
    assert port[1]["loop_replay_fallbacks"] == 1
    assert port[1]["loop_plan_builds"] == 2
    assert np.array_equal(port[0], want[1][0])


# ----------------------------------------------------------------------
# release (donation) analysis
# ----------------------------------------------------------------------

class _Fn:                                       # raw-less stand-in
    raw = None


def _positions(calls, carry_out, n_carry):
    """Release positions of the same wiring in both packages."""
    f = _Fn()
    got = []
    for Call, Plan, mex in ((JCall, JLoopPlan, JMeshExec(num_workers=1)),
                            (tloop._Call, tloop.LoopPlan,
                             tt.MeshExec(num_workers=1, device="cpu"))):
        plan = Plan(mex, [Call(f, list(refs), [object() for _ in range(no)])
                          for refs, no in calls], list(carry_out), n_carry)
        got.append(([c.donate_pos for c in plan.calls],
                    [r[0] for r in plan.carry_out]))
    assert got[0] == got[1]
    return got[1]


def test_donation_positions():
    """Only loop-owned buffers at their LAST use that do not survive
    into the next carry are released; one passed twice never is."""
    pos, _ = _positions([([("carry", 0), ("carry", 0)], 1),
                         ([("val", (0, 0)), ("carry", 1)], 1)],
                        [("val", (1, 0)), ("carry", 1)], 2)
    assert pos == [(), (0,)]


def test_eager_device_math_rejects_capture():
    """Eager math on the carry between recorded dispatches rejects the
    capture (its frozen value would be wrong on replay)."""
    def run(ctx, pkg):
        step = ctx.mesh_exec.jit_cached(("test_loop_eager_feed",),
                                        lambda y: y + 1.0)
        if pkg == "ref":
            x0, it = jnp.arange(4, dtype=jnp.float64), JIterate
        else:
            x0, it = torch.arange(4, dtype=torch.float64), tt.Iterate
        return it(ctx, lambda x: step(x * 2.0), x0, 4, name="eager_feed")

    ref, port = _both(1, run)
    _assert_same(ref, port)
    assert np.array_equal(port[0], [15.0, 31.0, 47.0, 63.0])
    assert port[1]["loop_plan_builds"] == port[1]["loop_replays"] == 0


@pytest.mark.parametrize("W", [1, 2])
def test_fori_with_checkpoint_every_but_no_manager(W):
    """checkpoint_every without a checkpoint directory seals nothing and
    does not cost the whole-loop program."""
    def run(ctx, pkg):
        d = ctx.Distribute(np.arange(32, dtype=np.float64))
        it = JIterate if pkg == "ref" else tt.Iterate
        out = it(ctx, lambda d: d.Map(_step_half), d, 5, name="nockpt",
                 checkpoint_every=2)
        return np.asarray([float(x) for x in out.AllGather()])

    ref, port = _both(W, run)
    _assert_same(ref, port)
    assert port[1]["loop_fori_iters"] == 4


def test_nested_iterate_rejects_outer_capture():
    """An inner Iterate inside a capturing body rejects the outer
    capture; the results are exact."""
    def run(ctx, pkg):
        step = ctx.mesh_exec.jit_cached(("test_loop_nested_step",),
                                        lambda x: x + 1.0)
        it = JIterate if pkg == "ref" else tt.Iterate
        x0 = jnp.zeros(4) if pkg == "ref" else torch.zeros(4)

        def outer(x):
            return it(ctx, lambda z: step(z), step(x), 2, name="inner")

        out = it(ctx, outer, x0, 3, name="outer")
        reports = {r["name"]: r for r in ctx.mesh_exec.loop_reports}
        return np.concatenate([_np(out), [reports["outer"]["captures"]]])

    ref, port = _both(1, run)
    _assert_same(ref, port)
    assert np.array_equal(port[0], [9.0] * 4 + [0])


def test_folded_const_carry_out_not_donated():
    """A carry slot whose producer is invariant folds to a constant and
    is never released."""
    pos, kinds = _positions([([("const", object())], 1),
                             ([("carry", 0), ("carry", 1)], 1)],
                            [("val", (1, 0)), ("val", (0, 0))], 2)
    assert kinds == ["val", "const"]
    assert pos == [(0,)]


def test_aliased_carry_out_not_donated():
    """Two carry slots handed back one buffer are both pinned."""
    pos, _ = _positions([([("carry", 0)], 1),
                         ([("carry", 1), ("val", (0, 0))], 1)],
                        [("val", (1, 0)), ("val", (1, 0))], 2)
    assert pos == [(), (1,)]


def test_aliased_carry_donation_end_to_end(monkeypatch):
    """{'a': v, 'b': v} with release forced on replays exactly."""
    monkeypatch.setenv("THRILL_TPU_LOOP_DONATE", "1")
    monkeypatch.setenv("THRILL_TPU_LOOP_FORI", "0")

    def run(ctx, pkg):
        mex = ctx.mesh_exec
        fa = mex.jit_cached(("test_loop_alias_f",), lambda x: x * 2.0)
        fb = mex.jit_cached(("test_loop_alias_g",), lambda x, s: x + s)

        def body(t):
            v = fb(t["b"], fa(t["a"]))
            return {"a": v, "b": v}

        if pkg == "ref":
            x0, it = {"a": jnp.arange(8, dtype=jnp.float64),
                      "b": jnp.ones(8, dtype=jnp.float64)}, JIterate
        else:
            x0, it = {"a": torch.arange(8, dtype=torch.float64),
                      "b": torch.ones(8, dtype=torch.float64)}, tt.Iterate
        out = it(ctx, body, x0, 5, name="alias")
        return np.concatenate([_np(out["a"]), _np(out["b"])])

    ref, port = _both(1, run)
    _assert_same(ref, port)
    assert port[1]["loop_replays"] == 4


def _count_drift_body(d):
    # 10 items in, 16 dense rows out: counts [10] -> [16], cap 16
    return d.ReduceToIndex(lambda x: x % 16, lambda a, b: a + b, 16,
                           neutral=0)


@pytest.mark.parametrize("replay", ["1", "0"])
def test_count_changing_body_rejects_capture(replay, monkeypatch):
    """A body that changes host-known carry counts with stable leaf
    shapes misses; results equal the un-replayed path's. The reference
    runs its jitted reduce engine (``THRILL_TPU_HOST_RADIX=0``), the
    device path the port's takes; its native CPU engine is no dispatch."""
    monkeypatch.setenv("THRILL_TPU_LOOP_REPLAY", replay)
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")

    def run(ctx, pkg):
        it = JIterate if pkg == "ref" else tt.Iterate
        out = it(ctx, _count_drift_body,
                 ctx.Distribute(np.arange(10, dtype=np.int64)), 4,
                 name="countdrift")
        return np.array([int(x) for x in out.AllGather()])

    ref, port = _both(1, run)
    _assert_same(ref, port)


def test_capture_miss_stops_reattempting():
    """Two deterministic misses, then the rest of the loop runs plain."""
    attempts = {"ref": 0, "port": 0}

    def run(ctx, pkg):
        def body(x):
            attempts[pkg] += 1
            if pkg == "ref":
                return jnp.asarray(np.asarray(x) * 0.5 + 1.0)
            return torch.as_tensor(x.numpy() * 0.5 + 1.0)

        if pkg == "ref":
            return JIterate(ctx, body, jnp.arange(8, dtype=jnp.float64), 6,
                            name="missy")
        return tt.Iterate(ctx, body, torch.arange(8, dtype=torch.float64),
                          6, name="missy")

    ref, port = _both(1, run)
    _assert_same(ref, port)
    assert attempts == {"ref": 6, "port": 6}
    assert port[1]["loop_plan_builds"] == 0


def test_donated_bytes_counted(monkeypatch):
    """With release forced on, replayed calls count the released bytes:
    the first replay pins the capture's carry, replays 2..3 release it."""
    monkeypatch.setenv("THRILL_TPU_LOOP_DONATE", "1")
    monkeypatch.setenv("THRILL_TPU_LOOP_FORI", "0")

    def run(ctx, pkg):
        step = ctx.mesh_exec.jit_cached(("test_loop_donate_step",),
                                        lambda x: x * 0.5 + 1.0)
        if pkg == "ref":
            x0, it = jnp.arange(64, dtype=jnp.float64), JIterate
        else:
            x0, it = torch.arange(64, dtype=torch.float64), tt.Iterate
        return it(ctx, lambda x: step(x), x0, 4, name="donate")

    ref, port = _both(1, run)
    _assert_same(ref, port)
    assert port[1]["loop_replays"] == 3
    assert port[1]["loop_donated_bytes"] == 2 * 64 * 8


# ----------------------------------------------------------------------
# checkpoint/resume composes with a loop carry
# ----------------------------------------------------------------------

_BODY_RUNS = []


def _ckpt_job(ctx):
    def body(d):
        _BODY_RUNS.append(1)
        return d.Map(_step_half)

    it = tt.Iterate if isinstance(ctx, tt.Context) else JIterate
    d = ctx.Distribute(np.arange(32, dtype=np.float64))
    out = it(ctx, body, d, 6, name="ckpt_loop", checkpoint_every=2)
    return [float(x) for x in out.AllGather()]


def test_checkpoint_every_rejects_pytree_carry():
    for ctx, it, x in ((JContext(JMeshExec(num_workers=1)), JIterate,
                        jnp.arange(4.0)),
                       (tt.Context(num_workers=1, device="cpu"), tt.Iterate,
                        torch.arange(4.0))):
        with pytest.raises(ValueError, match="checkpoint_every"):
            it(ctx, lambda v: v, x, 3, checkpoint_every=2)
        ctx.close()


def _ckpt_runs(tmp_path, resume_cfg):
    """(first run, its body runs, resumed run, its body runs) of each
    package under its own checkpoint directory."""
    out = {}
    for pkg in ("ref", "port"):
        d = tmp_path / pkg
        runs = []
        for resume in (False, True):
            _BODY_RUNS.clear()
            if pkg == "ref":
                got = JRun(_ckpt_job, JConfig(ckpt_dir=str(d)),
                           resume=resume)
            else:
                got = tt.Run(_ckpt_job, 1, device="cpu",
                             config=Config(ckpt_dir=str(d)), resume=resume)
            runs.append((got, len(_BODY_RUNS)))
        out[pkg] = (runs, len(list(d.iterdir())))
    return out


def test_loop_checkpoint_resume(tmp_path, monkeypatch):
    """Epochs after iterations 2 and 4; a resumed run restores the newest
    and re-runs only iterations 5 and 6 (replay off: body runs count
    iterations)."""
    monkeypatch.setenv("THRILL_TPU_LOOP_REPLAY", "0")
    got = _ckpt_runs(tmp_path, True)
    assert got["port"] == got["ref"]
    (first, n_first), (resumed, n_resumed) = got["port"][0]
    assert (n_first, n_resumed, got["port"][1]) == (6, 2, 2)
    assert resumed == first


def test_loop_checkpoint_resume_with_replay(tmp_path):
    """Replay on: the resumed run restores mid-loop, captures again, and
    gives the same values as the first run and as the reference."""
    got = _ckpt_runs(tmp_path, True)
    assert got["port"][0][0][0] == got["port"][0][1][0] \
        == got["ref"][0][0][0] == got["ref"][0][1][0]


# ----------------------------------------------------------------------
# per-output taint
# ----------------------------------------------------------------------

def _taint_run(dependent: bool):
    def run(ctx, pkg):
        mex = ctx.mesh_exec
        name = "leaf_taint_dep" if dependent else "leaf_taint"
        if dependent:
            step = mex.jit_cached((name + "_step",),
                                  lambda x: (x + 1.0, x * 3.0))
        else:
            step = mex.jit_cached((name + "_step",),
                                  lambda x, k: (x + 1.0, k * 2))
        scale = mex.jit_cached((name + "_scale",), lambda x, s: x * s)
        if pkg == "ref":
            keys = mex.put(np.arange(8, dtype=np.int64).reshape(1, 8) % 4)
            x0, it = jnp.zeros((1, 1), dtype=jnp.float64), JIterate
        else:
            keys = mex.put_small(np.arange(8, dtype=np.int64).reshape(1, 8)
                                 % 4)
            x0, it = torch.zeros((1, 1), dtype=torch.float64), tt.Iterate

        def body(x):
            y, z = step(x) if dependent else step(x, keys)
            v = mex.fetch(z)            # plan logic reads an output
            return scale(y, mex.put_small(np.asarray(v[:, :1] * 0 + 2.0)))

        return it(ctx, body, x0, 4, name=name)

    return run


def test_invariant_output_of_carry_dependent_call_captures():
    """A fetched output that depends on a constant input only, of a
    call that also makes a carry-dependent one, does not poison the
    tape."""
    ref, port = _both(1, _taint_run(False))
    _assert_same(ref, port)
    assert port[1]["loop_plan_builds"] == 1
    assert port[0].item() == 30.0


def test_carry_dependent_fetch_still_rejects():
    """Fetching an output that derives from the carry rejects."""
    ref, port = _both(1, _taint_run(True))
    _assert_same(ref, port)
    assert port[1]["loop_plan_builds"] == port[1]["loop_replays"] == 0
    assert port[0].item() == 30.0


@pytest.mark.parametrize("W", [1, 2, 4])
def test_pagerank_captures_at_w_gt_1(W):
    """The fixed-topology PageRank body (its exchange's send matrix rides
    the edges' fixed targets) captures and replays at every W,
    bit-equal to the reference."""
    ref, port = _both(W, _pagerank(pages=128, iters=4))
    _assert_same(ref, port, LOOP_KEYS + ("device_dispatches",), PR_ATOL)
    assert port[1]["loop_plan_builds"] == 1
    assert port[1]["loop_replays"] + port[1]["loop_fori_iters"] == 3


# ----------------------------------------------------------------------
# the port's own cases
# ----------------------------------------------------------------------

def test_inplace_update_rejects_capture():
    """A program that writes into its argument in place cannot be
    replayed against another value: the capture is rejected, the loop
    runs plain and exactly."""
    ctx = tt.Context(num_workers=1, device="cpu")
    mex = ctx.mesh_exec
    bump = mex.jit_cached(("inplace_bump",), lambda x, c: x.add_(c) * 1.0)
    const = torch.ones(4, dtype=torch.float64)
    out = tt.Iterate(ctx, lambda x: bump(x, const),
                     torch.zeros(4, dtype=torch.float64), 4)
    assert np.array_equal(out.numpy(), [4.0] * 4)
    assert _loop_stats(ctx)["loop_plan_builds"] == 0
    ctx.close()


def _hidden_kernel(x, k):
    """A stand-in for a hand-written kernel that counts its launch but
    does not report its edge: it writes ``k * 2`` into its output behind
    the dispatcher's back (through numpy), as a launch through a raw
    pointer does."""
    from thrill_tpu_torch.core import pallas_kernels as pk
    out = torch.empty_like(k)
    out.numpy()[...] = k.numpy() * 2
    pk.partition_histogram.launches += 1
    return x + 1.0, out


@pytest.mark.parametrize("report", [True, False])
def test_unreported_kernel_gives_conservative_verdict(report):
    """The taint follows a kernel's output only through its reported
    edge. A launch without a report makes the call opaque: the fetched
    output then counts as carry-dependent, and the capture is rejected
    (slow, never wrong). With the report it captures."""
    from thrill_tpu_torch.common import taint
    ctx = tt.Context(num_workers=1, device="cpu")
    mex = ctx.mesh_exec

    def step_fn(x, k):
        y, out = _hidden_kernel(x, k)
        if report:
            taint.kernel_edge((k,), (out,))
        return y, out

    step = mex.jit_cached(("hidden_step", report), step_fn)
    scale = mex.jit_cached(("hidden_scale",), lambda x, s: x * s)
    keys = mex.put_small(np.arange(8, dtype=np.int64).reshape(1, 8) % 4)

    def body(x):
        y, kk = step(x, keys)
        v = mex.fetch(kk)
        return scale(y, mex.put_small(np.asarray(v[:, :1] * 0 + 2.0)))

    out = tt.Iterate(ctx, body, torch.zeros((1, 1), dtype=torch.float64), 4)
    assert out.item() == 30.0
    assert _loop_stats(ctx)["loop_plan_builds"] == (1 if report else 0)
    ctx.close()


def test_jit_cached_counts_as_dispatch():
    """``MeshExec.jit_cached`` returns a program behind the dispatch choke
    point: its calls count in ``device_dispatches`` as the reference's
    ``_CountedJit`` calls do, and a capture records them."""
    for ctx in (JContext(JMeshExec(num_workers=1)),
                tt.Context(num_workers=1, device="cpu")):
        mex = ctx.mesh_exec
        f = mex.jit_cached(("counted_step",), lambda x: x + 1)
        assert mex.jit_cached(("counted_step",), lambda x: x) is f
        d0 = mex.stats_dispatches
        f(np.arange(3.0) if isinstance(ctx, JContext) else torch.arange(3.0))
        assert mex.stats_dispatches == d0 + 1
        ctx.close()


@pytest.mark.parametrize("W", [1, 2, 4])
def test_kmeans_dispatches_are_the_reference_s(W):
    """k-means' dispatches (the centre update a program now) equal the
    reference's at every W; its loop stats too; and its host fetches: at
    W > 1 both exchanges read the send matrix in the two capture attempts
    only and run the later iterations on the cached capacity plan
    (ROADMAP.md fault C14, closed)."""
    _, jkm = _ref_examples()
    pts = np.random.default_rng(1).normal(size=(512, 4))

    def run(ctx, pkg):
        mod = jkm if pkg == "ref" else tkm
        return mod.k_means(ctx, pts, 8, iterations=10, seed=0)

    ref, port = _both(W, run)
    _assert_same(ref, port, LOOP_KEYS + ("device_dispatches",))
    assert port[1]["device_fetches"] == ref[1]["device_fetches"] == (
        0 if W == 1 else 2)


def test_replayed_release_survives_rung2_retry(monkeypatch):
    """An OOM on a replayed call that releases its arguments: rung 2
    retries it on the same, still-held tensors (the port's counterpart
    of the reference's ``_donate_base``), exact results, bytes counted."""
    monkeypatch.setenv("THRILL_TPU_LOOP_DONATE", "1")
    monkeypatch.setenv("THRILL_TPU_LOOP_FORI", "0")
    ctx = tt.Context(num_workers=1, device="cpu")
    calls = []

    def half(x):
        # a real allocator OOM (an armed fault site would turn release
        # off) on the third call: the second replay, which releases
        calls.append(1)
        if len(calls) == 3:
            raise torch.OutOfMemoryError("CUDA out of memory (simulated)")
        return x * 0.5 + 1.0

    step = ctx.mesh_exec.jit_cached(("rung2_release",), half)
    want = np.arange(64, dtype=np.float64)
    for _ in range(5):
        want = want * 0.5 + 1.0
    out = tt.Iterate(ctx, step, torch.arange(64, dtype=torch.float64), 5,
                     name="rung2")
    s = ctx.overall_stats()
    assert np.array_equal(out.numpy(), want)
    assert s["oom_retries"] == 1 and s["loop_replay_fallbacks"] == 0
    assert s["loop_replays"] == 4 and s["loop_donated_bytes"] == 3 * 64 * 8
    ctx.close()


@pytest.mark.parametrize("W", [1, 4])
def test_a_capture_holds_nothing_for_the_collector(W):
    """k-means captures at W = 1 and misses twice at W = 4. Either way no
    recorded call outlives ``Iterate`` with the garbage collector off: a
    reference cycle through the analysis would hold every recorded call,
    and with it the capture iteration's outputs, until a collection ran
    (the plain iterations after a miss then peaked on top of them)."""
    import gc
    pts = np.random.default_rng(1).normal(size=(512, 4))
    gc.collect()
    gc.disable()
    try:
        ctx = tt.Context(num_workers=W, device="cpu")
        tkm.k_means(ctx, pts, 8, iterations=4, seed=0)
        builds = ctx.overall_stats()["loop_plan_builds"]
        alive = sum(isinstance(o, tloop._Call) for o in gc.get_objects())
    finally:
        gc.enable()
    assert builds == (1 if W == 1 else 0)
    assert alive == 0
    ctx.close()


# ----------------------------------------------------------------------
# padded capacities on a CPU mesh (ROADMAP.md fault C18)
# ----------------------------------------------------------------------

PLAN_COUNTS = ("cap_cache_misses", "plan_builds", "cap_cache_hits",
               "device_dispatches")


@pytest.mark.parametrize("data_seed", [1, 3])
def test_kmeans_plan_counters_at_size_are_the_reference_s(data_seed,
                                                          monkeypatch):
    """k-means cold at W = 4 (2^16 points of dimension 4, k = 5, 4
    iterations, the plain loop): the capacity-plan cache's misses, plan
    builds, hits and the dispatches equal the reference's (0, 1, 3): on
    a CPU mesh the padded capacities round to powers of two, as the
    reference's, so clusters drifting between iterations stay under the
    cached plan (with five-bit capacities the points of seed 3 missed
    twice: 2, 3 and 1)."""
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    monkeypatch.setenv("THRILL_TPU_LOOP_REPLAY", "0")
    _, jkm = _ref_examples()
    pts = np.random.default_rng(data_seed).normal(size=(1 << 16, 4))

    def run(ctx, pkg):
        mod = jkm if pkg == "ref" else tkm
        return mod.k_means(ctx, pts, 5, iterations=4, seed=0)[0]

    (rv, rs), (pv, ps) = _both(4, run)
    assert {k: ps[k] for k in PLAN_COUNTS} == {k: rs[k] for k in PLAN_COUNTS}
    assert ps["cap_cache_misses"] == 0
    assert np.abs(_np(pv) - _np(rv)).max() <= 1e-9


def test_pagerank_chunks_and_dispatches_at_size_are_the_reference_s(
        monkeypatch):
    """PageRank at W = 4 (2^14 pages, 2^16 edges, 4 iterations, the plain
    loop), a cold run then a warm one on one Context: every run's
    dispatches and plan counters equal the reference's. The contribution
    exchange's padded volume reaches the 1 MiB chunk threshold with
    power-of-two capacities, so it ships in 4 chunks as the reference's
    (38 dispatches a run, where five-bit capacities shipped one chunk
    and made 26)."""
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    monkeypatch.setenv("THRILL_TPU_LOOP_REPLAY", "0")
    jpr, _ = _ref_examples()
    edges = tpr.zipf_graph(1 << 14, 1 << 16)

    def run(ctx, pkg):
        mod = jpr if pkg == "ref" else tpr
        per_run = []
        for _ in range(2):
            s0 = ctx.overall_stats()
            ranks = mod.page_rank(ctx, edges, 1 << 14, iterations=4)
            s1 = ctx.overall_stats()
            per_run.append({k: s1[k] - s0[k] for k in PLAN_COUNTS})
        chunks = []
        if pkg == "port":
            chunks = [d["chosen"] for d in ctx.decisions.snapshot()
                      if d["kind"] == "xchg_chunks"]
        return _np(ranks), per_run, chunks

    (rv, _), (pv, _) = _both(4, run)
    assert pv[1] == rv[1]
    assert pv[1][1]["device_dispatches"] == 38
    assert "4" in pv[2]
    assert np.abs(pv[0] - rv[0]).max() <= PR_ATOL
