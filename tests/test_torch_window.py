"""The port's Window, DisjointWindow, FlatWindow and ZipWindow against
the reference package on the CPU, device and host paths.

The same items, made from a numpy seed, go through ``thrill_tpu`` and
``thrill_tpu_torch`` at W in {1, 2, 3, 4}: device outputs row for row
with their per-worker counts, host outputs as per-worker lists.
Integers bit for bit; f32 window sums within ``rtol=1e-6, atol=1e-6``
(sums of k values below 1 in another order). Inputs that went through a
Filter or a Sort hold rows past the counts that the port's exchange
leaves as copies (ROADMAP.md fault C4): the halo reads below the counts
only, so the windows are the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thrill_tpu.api import Context as JContext
from thrill_tpu.api import ZipWindow as JZipWindow
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
from thrill_tpu_torch.common import tree as pt
from thrill_tpu_torch.data.shards import DeviceShards, HostShards

WIDTHS = [1, 2, 3, 4]
TOL = 1e-6


def _jax_ctx(W):
    return JContext(JMeshExec(devices=jax.devices("cpu")[:W]))


class _J:
    ZipWindow = staticmethod(JZipWindow)
    stack1 = staticmethod(lambda xs: jnp.stack(xs, axis=1))
    sum1 = staticmethod(lambda x: jnp.sum(x, axis=1))
    max1 = staticmethod(lambda x: jnp.max(x, axis=1))


class _T:
    ZipWindow = staticmethod(tt.ZipWindow)
    stack1 = staticmethod(lambda xs: torch.stack(xs, dim=1))
    sum1 = staticmethod(lambda x: x.sum(dim=1))
    max1 = staticmethod(lambda x: x.amax(dim=1))


def _out(shards):
    if isinstance(shards, HostShards) or hasattr(shards, "lists"):
        return ("host", shards.lists)
    return ("device", shards.to_global_numpy(),
            np.asarray(shards.counts).reshape(-1).copy())


def _both(W, job):
    jctx = _jax_ctx(W)
    try:
        ref = _out(job(jctx, _J).node.materialize())
    finally:
        jctx.close()
    t = job(tt.Context(num_workers=W, device="cpu"), _T).node.materialize()
    return ref, _out(t), t


def _assert_same(ref, port):
    assert ref[0] == port[0]
    if ref[0] == "host":
        assert len(ref[1]) == len(port[1])
        for a, b in zip(ref[1], port[1]):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                for u, v in zip(jax.tree.leaves(x), pt.leaves(y)):
                    np.testing.assert_allclose(np.asarray(v), np.asarray(u),
                                               rtol=TOL, atol=TOL)
        return
    assert np.array_equal(ref[2], port[2])
    jl, tl = jax.tree.leaves(ref[1]), pt.leaves(port[1])
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert b.dtype == a.dtype and b.shape == a.shape
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
        else:
            assert np.array_equal(b, a)


def _vals(n, seed):
    return np.random.default_rng(seed).random(n).astype(np.float32)


def _ran_on_device(t, label):
    """The op's one run on a fresh mesh took the device path."""
    return (isinstance(t, DeviceShards)
            and t.mesh_exec.device_runs == {label: 1})


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("k", [1, 3, 7])
def test_window_device_path_matches_reference(W, k):
    x = _vals(61, W)

    def job(ctx, L):
        return ctx.Distribute(x).Window(k, None, device_fn=L.sum1)

    ref, port, t = _both(W, job)
    _assert_same(ref, port)
    assert _ran_on_device(t, "Window")
    np.testing.assert_allclose(
        port[1], np.lib.stride_tricks.sliding_window_view(x, k).sum(1),
        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("W", WIDTHS)
def test_window_of_pytree_items_after_a_filter_matches_reference(W):
    """A dict item with a [2] column; the Filter leaves copies past the
    counts."""
    rng = np.random.default_rng(9 + W)
    items = {"a": rng.integers(0, 100, 90).astype(np.int64),
             "b": rng.integers(0, 9, (90, 2)).astype(np.int32)}

    def job(ctx, L):
        return ctx.Distribute(items).Filter(lambda r: r["a"] % 5 != 0) \
            .Window(4, None, device_fn=lambda w: {
                "a": L.max1(w["a"]), "b": L.sum1(w["b"])})

    ref, port, t = _both(W, job)
    _assert_same(ref, port)
    assert _ran_on_device(t, "Window")


@pytest.mark.parametrize("W", WIDTHS)
def test_window_after_a_sort_matches_reference(W):
    """The exchange leaves copies of shipped rows past the counts."""
    x = np.random.default_rng(3).integers(-50, 50, 70).astype(np.int64)

    def job(ctx, L):
        return ctx.Distribute(x).Sort().Window(5, None, device_fn=L.sum1)

    ref, port, _ = _both(W, job)
    _assert_same(ref, port)


@pytest.mark.parametrize("W", WIDTHS)
def test_window_host_path_matches_reference(W):
    def job(ctx, L):
        return ctx.Generate(20, storage="host").Window(
            3, lambda i, win: (i, sum(win)))

    ref, port, t = _both(W, job)
    _assert_same(ref, port)
    assert isinstance(t, HostShards)


@pytest.mark.parametrize("W", WIDTHS)
def test_window_falls_back_to_the_host_as_the_reference_does(W):
    """A worker before the last holding fewer than k-1 items takes the
    host path, which needs fn."""
    def job(ctx, L):
        return ctx.Generate(8).Filter(lambda x: x > 5).Window(
            3, lambda i, win: int(sum(win)), device_fn=L.sum1)

    ref, port, _ = _both(W, job)
    _assert_same(ref, port)
    if W > 2:
        ctx = tt.Context(num_workers=W, device="cpu")
        with pytest.raises(ValueError, match="no host fn"):
            ctx.Generate(8).Filter(lambda x: x > 5).Window(
                3, None, device_fn=_T.sum1).AllGather()


@pytest.mark.parametrize("W", WIDTHS)
def test_disjoint_window_device_path_matches_reference(W):
    def job(ctx, L):
        return ctx.Generate(23).DisjointWindow(
            5, lambda i, w: max(w), device_fn=L.max1)

    ref, port, t = _both(W, job)
    _assert_same(ref, port)
    assert port[1].tolist() == [4, 9, 14, 19]
    assert _ran_on_device(t, "DisjointWindow")


@pytest.mark.parametrize("W", WIDTHS)
def test_disjoint_window_partial_fn_matches_reference(W):
    """partial_fn takes the trailing block of fewer than k items and
    keeps the op on the host, device_fn or not."""
    def job(ctx, L):
        return ctx.Generate(23).DisjointWindow(
            5, lambda i, w: (i, int(max(w))), device_fn=L.max1,
            partial_fn=lambda i, w: (i, -len(w)))

    ref, port, t = _both(W, job)
    _assert_same(ref, port)
    assert [it for l in port[1] for it in l][-1] == (20, -3)
    assert isinstance(t, HostShards)


@pytest.mark.parametrize("W", WIDTHS)
def test_flat_window_device_and_host_paths_match_reference(W):
    x = np.random.default_rng(W).integers(-9, 9, 40).astype(np.int64)

    def device(ctx, L):
        # each pair emits its difference, and its sum when that is even
        return ctx.Distribute(x).FlatWindow(2, device_fn=lambda w: (
            L.stack1([w[:, 1] - w[:, 0], w[:, 1] + w[:, 0]]),
            L.stack1([w[:, 0] == w[:, 0], (w[:, 1] + w[:, 0]) % 2 == 0])),
            factor=2)

    def host(ctx, L):
        return ctx.Distribute(x.tolist(), storage="host").FlatWindow(
            2, lambda i, w: [w[1] - w[0]] + ([w[1] + w[0]]
                                              if (w[1] + w[0]) % 2 == 0
                                              else []))

    ref, port, t = _both(W, device)
    _assert_same(ref, port)
    assert _ran_on_device(t, "FlatWindow")
    href, hport, _ = _both(W, host)
    _assert_same(href, hport)
    assert port[1].tolist() == [v for l in hport[1] for v in l]


@pytest.mark.parametrize("W", WIDTHS)
def test_zip_window_device_fn_and_default_schema_match_reference(W):
    def fn(ctx, L):
        a = ctx.Generate(24)
        b = ctx.Generate(37, fn=lambda i: i * 10)
        return L.ZipWindow((2, 3), a, b,
                           device_fn=lambda ca, cb: L.sum1(ca) + L.sum1(cb))

    def default(ctx, L):
        a = ctx.Distribute(_vals(25, W))
        b = ctx.Generate(36, fn=lambda i: i * 10).Filter(lambda v: v % 4 > 0)
        return L.ZipWindow((2, 3), a, b)

    for job in (fn, default):
        ref, port, t = _both(W, job)
        _assert_same(ref, port)
        assert isinstance(t, DeviceShards)


@pytest.mark.parametrize("W", WIDTHS)
def test_zip_window_host_path_matches_reference(W):
    def job(ctx, L):
        a = ctx.Generate(24, storage="host")
        b = ctx.Generate(36, fn=lambda i: i * 10, storage="host")
        return L.ZipWindow((2, 3), a, b,
                           zip_fn=lambda ca, cb: sum(ca) + sum(cb))

    ref, port, _ = _both(W, job)
    _assert_same(ref, port)
    ctx = tt.Context(num_workers=W, device="cpu")
    with pytest.raises(ValueError, match="pass zip_fn"):
        tt.ZipWindow((1, 1), ctx.Generate(3, storage="host"),
                     ctx.Generate(3, storage="host"),
                     device_fn=lambda a, b: a).AllGather()
