"""The port's Iterate against the reference package's on the CPU, with a
DIA carry and with a pytree-of-tensors carry, at W in {1, 2, 4}.

Both packages capture the first iteration and replay the rest, which is
bit-identical to their plain loops (``tests/test_torch_loop_replay.py``
holds the port's loop layer to the reference's). Rows,
per-worker counts and carried values must be equal: integers bit for
bit, floats within ``1e-12`` (f64 sums that may associate differently).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thrill_tpu.api import Context as JContext
from thrill_tpu.api import FieldReduce as JFieldReduce
from thrill_tpu.api import Iterate as JIterate
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.api.dia_base import DISPOSED, FUSED

WIDTHS = [1, 2, 4]
N = 29


def _jax_ctx(W):
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]))


def _step(d):
    return {"i": d["i"] * 3 + 1, "k": (d["i"] * 7) % N, "v": d["v"] * 0.5}


def _index(d):
    return d["k"]


def _halve(t):
    return {"i": t["i"] % 1000, "k": t["k"], "v": t["v"] + 0.25}


def _body(field_reduce):
    red = field_reduce({"i": "max", "k": "first", "v": "sum"})

    def body(d):
        return d.Map(_step).ReduceToIndex(
            _index, red, N, neutral={"i": 0, "k": 0, "v": 0.0}).Map(_halve)

    return body


def _dia_loop(ctx, iterate, field_reduce, iters):
    rng = np.random.default_rng(3)
    src = ctx.Distribute({"i": rng.integers(0, 50, N).astype(np.int64),
                          "k": np.zeros(N, np.int64),
                          "v": rng.random(N)}).Collapse()
    return iterate(ctx, _body(field_reduce), src, iters, name="t")


@pytest.mark.parametrize("W", WIDTHS)
def test_iterate_with_a_dia_carry(W):
    jctx = _jax_ctx(W)
    try:
        j = _dia_loop(jctx, JIterate, JFieldReduce, 4)._link().pull()
        ref_rows, ref_counts = j.to_global_numpy(), np.asarray(
            j.counts).reshape(-1).copy()
    finally:
        jctx.close()
    t = _dia_loop(tt.Context(num_workers=W, device="cpu"), tt.Iterate,
                  tt.FieldReduce, 4)._link().pull()
    assert np.array_equal(t.counts, ref_counts)
    rows = t.to_global_numpy()
    assert np.array_equal(rows["i"], ref_rows["i"])
    assert np.array_equal(rows["k"], ref_rows["k"])
    np.testing.assert_allclose(rows["v"], ref_rows["v"], rtol=1e-12,
                               atol=1e-12)


def _tree_body(c):
    return {"c": c["c"] * 0.5 + c["x"].sum(), "x": c["x"] + 1,
            "n": c["n"] * 3 % 1000003}


@pytest.mark.parametrize("W", WIDTHS)
def test_iterate_with_a_pytree_carry(W):
    init = {"c": np.linspace(0.0, 1.0, 6), "x": np.arange(4, dtype=np.int64),
            "n": np.array(7, dtype=np.int64)}
    jctx = _jax_ctx(W)
    try:
        ref = JIterate(jctx, _tree_body, jax.tree.map(jnp.asarray, init), 5)
        ref = jax.tree.map(np.asarray, ref)
    finally:
        jctx.close()
    got = tt.Iterate(tt.Context(num_workers=W, device="cpu"), _tree_body,
                     init, 5)
    assert isinstance(got["c"], torch.Tensor)
    np.testing.assert_allclose(got["c"].numpy(), ref["c"], rtol=1e-12,
                               atol=1e-12)
    assert np.array_equal(got["x"].numpy(), ref["x"])
    assert int(got["n"]) == int(ref["n"])


def test_iterate_zero_times_and_refusals():
    """No iteration returns the carry; ``checkpoint_every`` with a
    pytree carry is refused up front, as in the reference
    (``test_checkpoint_every_rejects_pytree_carry``)."""
    ctx = tt.Context(num_workers=2, device="cpu")
    d = ctx.Generate(5)
    assert tt.Iterate(ctx, lambda x: x.Map(lambda v: v + 1), d, 0) is d
    with pytest.raises(ValueError, match="checkpoint_every"):
        tt.Iterate(ctx, lambda x: x, torch.arange(4.0), 3,
                   checkpoint_every=2)
    jctx = _jax_ctx(1)
    try:
        with pytest.raises(ValueError, match="checkpoint_every"):
            JIterate(jctx, lambda x: x, jnp.arange(4.0), 3,
                     checkpoint_every=2)
    finally:
        jctx.close()


def _step_half(x):
    return x * 0.5 + 1.0


@pytest.mark.parametrize("W", WIDTHS)
def test_checkpoint_every_without_a_manager_seals_nothing(W, tmp_path,
                                                         monkeypatch):
    """The reference's ``test_fori_with_checkpoint_every_but_no_manager``:
    no checkpoint directory, so no epoch and the plain loop's values."""
    monkeypatch.delenv("THRILL_TPU_CKPT_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    vals = np.arange(32, dtype=np.float64)
    outs = []
    for ctx, iterate in ((_jax_ctx(W), JIterate),
                         (tt.Context(num_workers=W, device="cpu"),
                          tt.Iterate)):
        try:
            out = iterate(ctx, lambda d: d.Map(_step_half),
                          ctx.Distribute(vals), 5, name="nockpt",
                          checkpoint_every=2)
            outs.append([float(x) for x in out.AllGather()])
            assert getattr(ctx, "checkpoint", None) is None
        finally:
            ctx.close()
    want = vals.copy()
    for _ in range(5):
        want = want * 0.5 + 1.0
    assert outs[0] == outs[1] == want.tolist()
    assert os.listdir(tmp_path) == []


_BODY_RUNS = []


def _ckpt_job(ctx, iterate):
    def body(d):
        _BODY_RUNS.append(1)
        return d.Map(_step_half)

    d = ctx.Distribute(np.arange(32, dtype=np.float64))
    out = iterate(ctx, body, d, 6, name="ckpt_loop", checkpoint_every=2)
    return [float(x) for x in out.AllGather()]


@pytest.mark.parametrize("W", WIDTHS)
def test_loop_checkpoint_resume(W, tmp_path, monkeypatch):
    """The reference's ``test_loop_checkpoint_resume``: epochs sealed
    after iterations 2 and 4; the resumed run restores the newest and
    runs iterations 5 and 6 alone, bit-equal to the reference's resumed
    run, with the same epoch files."""
    from thrill_tpu.common.config import Config as JConfig
    from thrill_tpu_torch.common.config import Config as TConfig

    monkeypatch.setenv("THRILL_TPU_LOOP_REPLAY", "0")
    runs = {}
    for side in ("j", "t"):
        cfg = (JConfig if side == "j" else TConfig)(
            ckpt_dir=str(tmp_path / side))
        for resume in (False, True):
            _BODY_RUNS.clear()
            if side == "j":
                ctx = JContext(JMeshExec(num_workers=W), config=cfg,
                               resume=resume)
                try:
                    out = _ckpt_job(ctx, JIterate)
                finally:
                    ctx.close()
            else:
                out = tt.Run(lambda c: _ckpt_job(c, tt.Iterate), W,
                             device="cpu", config=cfg, resume=resume)
            runs[side, resume] = (out, len(_BODY_RUNS))
    assert runs["t", False] == runs["j", False]
    assert runs["t", True] == runs["j", True]
    assert runs["t", False][1] == 6 and runs["t", True][1] == 2
    assert runs["t", True][0] == runs["t", False][0]
    for side in ("j", "t"):
        assert sorted(os.listdir(tmp_path / side)) == [
            "epoch_000000", "epoch_000001"]
    for rel in ("epoch_000001/MANIFEST.json",
                "epoch_000001/n0.w0.bin"):
        a = (tmp_path / "j" / rel).read_bytes()
        b = (tmp_path / "t" / rel).read_bytes()
        if rel.endswith(".json"):
            a, b = json.loads(a), json.loads(b)
        assert a == b


def test_iterate_frees_each_iteration_and_keeps_kept_sources(monkeypatch):
    """Consume budgets across the plain loop (``THRILL_TPU_LOOP_REPLAY=0``:
    a replayed iteration pulls nothing, so it consumes no budget): a
    source kept for every iteration stays; each iteration's
    intermediates are disposed once the next iteration has read them."""
    monkeypatch.setenv("THRILL_TPU_LOOP_REPLAY", "0")
    ctx = tt.Context(num_workers=2, device="cpu")
    iters = 4
    table = ctx.Generate(8).Map(lambda g: g * 10).Cache().Keep(iters)
    nodes = []

    def body(x):
        z = tt.Zip(x, table, zip_fn=lambda a, b: a + b)
        nodes.append(z.node)
        return z.Map(lambda v: v + 1)

    out = tt.Iterate(ctx, body, ctx.Generate(8), iters)
    assert out.AllGather() == [iters * (g * 10 + 1) + g for g in range(8)]
    # stitched into the next op's program, a Zip ends FUSED: consumed
    # without ever holding a result
    assert all(n.state in (DISPOSED, FUSED) for n in nodes)
    assert table.node.state != DISPOSED and table.node._shards is not None
    table.Size()
    assert table.node.state == DISPOSED


def test_pytree_walks_hold_no_reference_cycle():
    """flatten/unflatten leave no cycle behind: with the collector off,
    a leaf dies with its last reference."""
    import gc
    import weakref
    from thrill_tpu_torch.common import tree as pt
    gc.disable()
    try:
        t = torch.zeros(3)
        ref = weakref.ref(t)
        leaves, td = pt.flatten({"a": t, "b": (t, [t])})
        out = pt.unflatten(td, leaves)
        assert out["b"][1][0] is t
        del t, leaves, out
        assert ref() is None
    finally:
        gc.enable()


def test_iterate_frees_intermediates_without_the_collector():
    """Each iteration's tensors are freed when the next iteration has
    read them, by reference counting alone (the collector is off): a
    reference cycle would keep them until it ran, and the peak device
    memory of a long loop would grow."""
    import gc
    import weakref
    refs = []

    def spy(x):
        refs.append(weakref.ref(x))
        return x * 2 + 1

    ctx = tt.Context(num_workers=2, device="cpu")
    gc.disable()
    try:
        out = tt.Iterate(ctx, lambda d: d.Map(spy).ReduceToIndex(
            lambda x: x % 8, tt.FieldReduce("sum"), 8), ctx.Generate(64), 5)
        assert len(out.AllGather()) == 8
        assert len(refs) == 5 and all(r() is None for r in refs)
    finally:
        gc.enable()
