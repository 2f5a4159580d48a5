"""The port's Gather, Print, action futures, Dispose, Sort with a
comparator and Sort of host storage against the reference package on
the CPU, at W in {1, 2, 3, 4}. Every result is compared exactly: items,
per-worker lists and what Print writes."""

import jax
import numpy as np
import pytest

from thrill_tpu.api import Context as JContext
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt

WIDTHS = [1, 2, 3, 4]


def _both(W, job):
    """(reference, port) of ``job(ctx)``, a plain value."""
    jctx = JContext(JMeshExec(devices=jax.devices("cpu")[:W]))
    try:
        ref = job(jctx)
    finally:
        jctx.close()
    return ref, job(tt.Context(num_workers=W, device="cpu"))


def _ints(xs):
    return [int(x) for x in xs]


@pytest.mark.parametrize("W", WIDTHS)
def test_gather_and_print_match_reference(W, capsys):
    def job(ctx):
        d = ctx.Generate(50, fn=lambda i: i * 3).Keep(2)
        got = _ints(d.Gather(root=W - 1))
        d.Print("xs", limit=7)
        d.Print()
        return got, capsys.readouterr().out

    ref, port = _both(W, job)
    assert port == ref
    assert port[0] == [i * 3 for i in range(50)]
    assert port[1].startswith("[xs] n=50: [0, 3, 6, 9, 12, 15, 18] ... (+43")


@pytest.mark.parametrize("W", WIDTHS)
def test_gather_and_print_of_host_items_match_reference(W, capsys):
    def job(ctx):
        d = ctx.Distribute(["a", (1, 2.5), 7], storage="host").Keep()
        got = d.Gather()
        d.Print("h")
        return got, capsys.readouterr().out

    ref, port = _both(W, job)
    assert port == ref


@pytest.mark.parametrize("W", WIDTHS)
def test_futures_survive_an_intervening_action(W):
    def job(ctx):
        d = ctx.Generate(100, fn=lambda i: i * 2).Cache()
        fs = d.SizeFuture()
        fg = d.AllGatherFuture()
        fsum = d.SumFuture()
        fcustom = d.SumFuture(lambda a, b: a + b, 1)
        done_before = fs.done
        size = d.Size()                  # spends the original budget
        out = (done_before, size, fs.get(), fs.done, fs(),
               _ints(fg.get()), int(fsum.get()), int(fcustom()))
        with pytest.raises(RuntimeError):
            d.Size()                     # every reserved use is spent
        return out

    ref, port = _both(W, job)
    assert port == ref
    assert port[:5] == (False, 100, 100, True, 100)


@pytest.mark.parametrize("W", WIDTHS)
def test_dispose_frees_and_a_later_use_raises(W):
    def job(ctx):
        d = ctx.Generate(10).Cache()
        d.Execute()
        held = d.node._shards is not None
        d.Dispose()
        with pytest.raises(RuntimeError):
            d.AllGather()
        return held, d.node._shards is None, d.node.state

    ref, port = _both(W, job)
    assert port == ref == (True, True, "DISPOSED")


@pytest.mark.parametrize("W", WIDTHS)
def test_sort_with_compare_fn_matches_reference(W):
    vals = np.random.default_rng(W).integers(-50, 50, 97).astype(np.int64)

    def job(ctx):
        s = ctx.Distribute(vals).Sort(compare_fn=lambda a, b: a > b)
        lists = s.node.materialize().lists
        return [_ints(l) for l in lists]

    ref, port = _both(W, job)
    assert port == ref
    assert [x for l in port for x in l] == sorted(vals.tolist(), reverse=True)


@pytest.mark.parametrize("W", WIDTHS)
def test_sort_of_host_storage_matches_reference(W):
    """key_fn per item and compare_fn on host items, Sort and SortStable:
    stable, evenly split."""
    rng = np.random.default_rng(30 + W)
    words = [f"w{int(i)}" for i in rng.integers(0, 40, 150)]
    pairs = [(int(a), int(b)) for a, b in rng.integers(0, 5, (120, 2))]

    def job(ctx):
        out = []
        for make in (
                lambda: ctx.Distribute(words, storage="host").Sort(),
                lambda: ctx.Distribute(pairs, storage="host").SortStable(
                    key_fn=lambda p: p[0]),
                lambda: ctx.Distribute(pairs, storage="host").Sort(
                    compare_fn=lambda a, b: a[1] < b[1])):
            out.append(make().node.materialize().lists)
        return out

    ref, port = _both(W, job)
    assert port == ref
    assert [x for l in port[1] for x in l] == sorted(pairs,
                                                     key=lambda p: p[0])


def test_sort_with_compare_fn_on_2_16_items_descending():
    """The smoke's size on the CPU: a comparator sort of 2^16 items."""
    vals = np.random.default_rng(4).integers(0, 1 << 40, 1 << 16)
    ctx = tt.Context(num_workers=4, device="cpu")
    got = ctx.Distribute(vals).Sort(compare_fn=lambda a, b: a > b).AllGather()
    assert got == sorted(vals.tolist(), reverse=True)
