"""The HBM ledger charges what a cached result holds (ROADMAP.md fault
C25): every device result's ``device_bytes`` (``thrill_tpu_torch/mem/
hbm.py``) equals the bytes of the distinct storages its leaves live in,
so spilling it frees what the ledger took off, and each op's
``tenant_hbm_peaks`` stays the reference package's.

The fault: a ReduceToIndex's integer sums (and the integer folds of
``core/segmented.py``) were views of a scatter buffer with one dump slot
an item past the output rows. PageRank's degree table, 16 bytes a page in
the ledger, pinned 48 bytes a page on the card. The op battery
(``thrill_tpu_torch/examples/op_battery.py``) at W = 4 is held result by
result; then each op's result is kept under a tenant of its own name in
both packages and the tenant peaks compared. Tolerance: exact.
"""

import tempfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from thrill_tpu import api as japi
from thrill_tpu.api import Context as JContext
from thrill_tpu.parallel.mesh import MeshExec as JMeshExec

import thrill_tpu_torch as tt
import torch
from thrill_tpu_torch.api import dia_base
from thrill_tpu_torch.common import tree as pt
from thrill_tpu_torch.core import segmented
from thrill_tpu_torch.data.shards import DeviceShards
from thrill_tpu_torch.examples.op_battery import Port, battery
from thrill_tpu_torch.mem import hbm

W = 4


def held_bytes(shards) -> int:
    """Bytes of the distinct storages a DeviceShards' leaves live in."""
    seen = {}
    for leaf in pt.leaves(shards.tree):
        s = leaf.untyped_storage()
        seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values())


def test_every_result_of_the_op_battery_is_charged_its_storages(
        monkeypatch):
    results, cached = [], []
    materialize = dia_base.DIABase.materialize
    on_cache = hbm.HbmGovernor.on_cache

    def spy_materialize(self, consume=False):
        out = materialize(self, consume=consume)
        if isinstance(out, DeviceShards):
            results.append((self.label, hbm.device_bytes(out),
                            held_bytes(out)))
        return out

    def spy_on_cache(self, node):
        on_cache(self, node)
        if isinstance(node._shards, DeviceShards):
            cached.append((node.label, node._hbm_bytes,
                           held_bytes(node._shards)))

    monkeypatch.setattr(dia_base.DIABase, "materialize", spy_materialize)
    monkeypatch.setattr(hbm.HbmGovernor, "on_cache", spy_on_cache)
    ctx = tt.Context(num_workers=W, device="cpu")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            battery(ctx, Port(), tmp)
    finally:
        ctx.close()
    assert len(results) > 50 and cached
    assert [r for r in results if r[1] != r[2]] == []
    assert [c for c in cached if c[1] != c[2]] == []


# -- each op's kept result under a tenant of its own, in both packages -----------

def _src_one(s):
    return (s, 1)


def _first(kv):
    return kv[0]


def _pid(t):
    return t["i"]


def _seg(pkg, how):
    if pkg == "j":
        return {"sum": jax.ops.segment_sum, "max": jax.ops.segment_max,
                "min": jax.ops.segment_min}[how]
    return {"sum": segmented.segment_sum, "max": segmented.segment_max,
            "min": segmented.segment_min}[how]


def _ones(pkg, x):
    return (jnp if pkg == "j" else torch).ones_like(x)


_RNG = np.random.default_rng(25)
_IDS = _RNG.integers(0, 300, 1500).astype(np.int64)
_VALS = _RNG.integers(-1000, 1000, 1500).astype(np.int64)
_F32 = _RNG.random(1500).astype(np.float32)
_KEYS = _RNG.integers(0, 256, (900, 10)).astype(np.uint8)


def _ops(pkg):
    api = japi if pkg == "j" else tt

    def rti(spec, neutral):
        return lambda c: c.Distribute({"i": _IDS, "v": _VALS}).ReduceToIndex(
            _pid, api.FieldReduce({"i": "first", "v": spec}), 320,
            neutral=neutral)

    def gbk(how):
        return lambda c: c.Distribute({"i": _IDS, "v": _VALS}).GroupByKey(
            _pid, device_fn=lambda tree, ids, n: {
                "n": _seg(pkg, "sum")(_ones(pkg, tree["i"]), ids,
                                      num_segments=n),
                "v": _seg(pkg, how)(tree["v"], ids, num_segments=n)})

    return {
        "degree_table": lambda c: c.Distribute(_IDS).Map(_src_one)
        .ReduceToIndex(_first, api.FieldReduce(("first", "sum")), 320,
                       neutral=(0, 0)),
        "rti_int_sum": rti("sum", {"i": 0, "v": 0}),
        "rti_int_sum_neutral": rti("sum", {"i": 0, "v": 5}),
        "rti_min": rti("min", {"i": 0, "v": 0}),
        "rti_max": rti("max", {"i": 0, "v": 0}),
        "rti_f32_sum": lambda c: c.Distribute(
            {"i": _IDS, "v": _F32}).ReduceToIndex(
            _pid, api.FieldReduce({"i": "first", "v": "sum"}), 320,
            neutral={"i": 0, "v": 0.0}),
        "gbk_sum_max": gbk("max"),
        "gbk_sum_min": gbk("min"),
        "sort": lambda c: c.Distribute({"k": _KEYS}).Sort(
            key_fn=lambda t: t["k"]),
        "reduce_by_key": lambda c: c.Distribute(
            {"i": _IDS, "v": _VALS}).ReduceByKey(
            _pid, api.FieldReduce({"i": "first", "v": "sum"})),
        "prefix_sum": lambda c: c.Distribute(_VALS).PrefixSum(),
        "zip": lambda c: api.Zip(c.Generate(700),
                                 c.Generate(700, fn=lambda i: i * 3),
                                 zip_fn=lambda x, y: x + y),
        "distribute": lambda c: c.Distribute(_VALS),
    }


OPS = sorted(_ops("t"))


def _peak(pkg, name):
    if pkg == "j":
        ctx = JContext(JMeshExec(devices=jax.devices("cpu")[:W]))
    else:
        ctx = tt.Context(num_workers=W, device="cpu")
    try:
        ctx.current_tenant = name
        d = _ops(pkg)[name](ctx)
        d.Keep()
        d.node.materialize(consume=False)
        ctx.current_tenant = None
        peaks = ctx.overall_stats()["tenant_hbm_peaks"]
        held = held_bytes(d.node._shards) if pkg == "t" else None
        return peaks, d.node._hbm_bytes, held
    finally:
        ctx.close()


@pytest.mark.parametrize("name", OPS)
def test_each_ops_tenant_peak_is_the_references(monkeypatch, name):
    monkeypatch.setenv("THRILL_TPU_HOST_RADIX", "0")
    jpeaks, jbytes, _ = _peak("j", name)
    tpeaks, tbytes, held = _peak("t", name)
    assert tpeaks == jpeaks == {name: jbytes}
    assert tbytes == jbytes == held
