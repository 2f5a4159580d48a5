"""The native CPU engine (``thrill_tpu_torch/core/host_radix.py`` over
``thrill_tpu_torch/native/hostsort.cpp``) against the reference's
(``thrill_tpu/core/host_radix.py`` over ``native/hostsort.cpp``).

The six entry points run through both packages on the same seeded
inputs and their outputs are equal, bit for bit: hash grouping on the
model cases of the reference's ``tests/core/test_hash_group.py`` and on
keys that differ only in their high bits, fold plans, scatter and gather
(native, and the numpy path for inputs the native one does not take),
the strided fold of a non-commutative function, every accumulate opcode,
and the radix argsort over 1-4 words with heavy ties. The port's wrappers
take its int64 key words (the reference's uint64 bits) and CPU tensors
without a copy.
"""

import numpy as np
import pytest
import torch

from thrill_tpu.api.ops.reduce import _strided_run_fold as j_fold
from thrill_tpu.core import host_radix as jhr

from thrill_tpu_torch.api.ops.reduce import _strided_run_fold
from thrill_tpu_torch.common import tree as pt
from thrill_tpu_torch.core import host_radix as hr


@pytest.fixture(autouse=True)
def _native(monkeypatch):
    monkeypatch.delenv("THRILL_TPU_HOST_RADIX", raising=False)
    assert hr.available() and jhr.available()


def _group_model(words):
    """First-appearance-ordered stable grouping, as lists of rows."""
    seen, order = {}, []
    for i in range(len(words[0])):
        k = tuple(int(w[i]) for w in words)
        if k not in seen:
            seen[k] = len(order)
            order.append([])
        order[seen[k]].append(i)
    return order


def _as_port_words(words):
    """uint64 words as the port carries them: int64 tensors, same bits."""
    return [torch.from_numpy(w.view(np.int64)) for w in words]


@pytest.mark.parametrize("n,nkeys,K", [
    (0, 1, 1), (1, 1, 1), (1000, 7, 1), (5000, 5000, 2),
    (4096, 3, 2), (10000, 100, 3)])
def test_hash_group_is_the_reference_s(n, nkeys, K):
    rng = np.random.default_rng(n + K)
    words = [rng.integers(0, nkeys, size=n).astype(np.uint64)
             for _ in range(K)]
    perm, lens = hr.hash_group(_as_port_words(words))
    jperm, jlens = jhr.hash_group(words)
    assert perm.dtype == jperm.dtype == np.uint32
    assert np.array_equal(perm, jperm) and np.array_equal(lens, jlens)
    groups = _group_model(words)
    assert perm.tolist() == [i for g in groups for i in g]
    assert lens.tolist() == [len(g) for g in groups]


def test_hash_group_keeps_keys_apart_by_their_high_bits():
    base = np.uint64(0x0123456789ABCDEF)
    w = np.array([base, base | np.uint64(1 << 63), base,
                  base | np.uint64(1 << 62)] * 100, dtype=np.uint64)
    perm, lens = hr.hash_group(_as_port_words([w]))
    jperm, jlens = jhr.hash_group([w])
    assert np.array_equal(perm, jperm) and np.array_equal(lens, jlens)
    assert lens.tolist() == [200, 100, 100]


@pytest.mark.parametrize("lens_l", [
    [1], [5, 1, 2], [1] * 10, [100], [3, 3, 3, 3], [262144]])
def test_fold_plan_is_the_reference_s(lens_l):
    lens = np.array(lens_l, np.uint32)
    ri, lc = hr.fold_plan(torch.from_numpy(lens.astype(np.int64)))
    jri, jlc = jhr.fold_plan(lens)
    assert np.array_equal(ri, jri) and np.array_equal(lc, jlc)
    exp = {lv: [] for lv in range(32)}
    start = 0
    for L in lens_l:
        for p in range(1, L):
            exp[(p & -p).bit_length() - 1].append(start + p)
        start += L
    assert ri.tolist() == [i for lv in range(32) for i in exp[lv]]


def test_scatter_rows_native_and_through_numpy():
    a = np.arange(40, dtype=np.int64).reshape(10, 4).copy()
    ja = a.copy()
    src = -np.arange(8, dtype=np.int64).reshape(2, 4)
    idx = np.array([3, 7], np.uint32)
    t = torch.from_numpy(a)
    hr.scatter_rows(t, idx, torch.from_numpy(src))      # in place, shared
    jhr.scatter_rows(ja, idx, src)
    assert np.array_equal(a, ja) and (a[3] == src[0]).all()
    # a source of another dtype goes through numpy's cast
    b, jb = np.zeros(5, dtype=np.int64), np.zeros(5, dtype=np.int64)
    hr.scatter_rows(b, np.array([1], np.uint32), np.array([2.0]))
    jhr.scatter_rows(jb, np.array([1], np.uint32), np.array([2.0]))
    assert np.array_equal(b, jb) and b[1] == 2
    # a non-contiguous destination goes through numpy's assignment
    c = np.zeros((6, 4), dtype=np.int64)[:, ::2]
    jc = np.zeros((6, 4), dtype=np.int64)[:, ::2]
    s2 = np.arange(4, dtype=np.int64).reshape(2, 2)
    hr.scatter_rows(c, np.array([0, 5], np.uint32), s2)
    jhr.scatter_rows(jc, np.array([0, 5], np.uint32), s2)
    assert np.array_equal(c, jc) and (c[5] == s2[1]).all()


@pytest.mark.parametrize("dtype,trail", [
    (np.uint8, ()), (np.int16, ()), (np.float32, ()), (np.int64, ()),
    (np.uint8, (10,)), (np.float64, (3,))])
def test_gather_rows_native_and_through_numpy(dtype, trail):
    rng = np.random.default_rng(7)
    arr = (rng.standard_normal((300,) + trail) * 100).astype(dtype)
    perm = rng.permutation(300)[:200].astype(np.uint32)
    got = hr.gather_rows(torch.from_numpy(arr), perm)
    assert np.array_equal(got, jhr.gather_rows(arr, perm))
    assert np.array_equal(got, arr[perm])
    # a non-contiguous input takes numpy's take
    nc = np.asfortranarray(np.stack([arr, arr], axis=1))
    assert not nc.flags.c_contiguous
    assert np.array_equal(hr.gather_rows(nc, perm),
                          jhr.gather_rows(nc, perm))


def test_strided_run_fold_of_a_non_commutative_function():
    """2x2 integer matrix products: associative, not commutative. The
    fold combines each run left to right, in both packages, with equal
    results; the port's function sees CPU tensors."""
    rng = np.random.default_rng(1)
    seen = set()

    def red(a, b):
        seen.add(type(a["m"]))
        return {"m": torch.einsum("nij,njk->nik", a["m"], b["m"])}

    def jred(a, b):
        return {"m": np.einsum("nij,njk->nik", a["m"], b["m"])}

    td = pt.flatten({"m": 0})[1]
    for trial in range(10):
        ngroups = int(rng.integers(1, 15))
        lens = rng.integers(1, 50, size=ngroups).astype(np.uint32)
        n = int(lens.sum())
        mats = rng.integers(0, 3, size=(n, 2, 2)).astype(np.int64)
        (got,) = _strided_run_fold([mats.copy()], td, lens, red)
        want = j_fold({"m": mats.copy()}, lens, jred)["m"]
        assert np.array_equal(got, want), trial
        start = 0
        for g, L in enumerate(lens):
            em = mats[start]
            for p in range(1, int(L)):
                em = em @ mats[start + p]
            assert (got[g] == em).all(), (trial, g)
            start += int(L)
    assert seen == {torch.Tensor}


def test_hash_group_acc_opcodes_are_the_reference_s():
    """Every accumulate opcode, NaN in float min/max and uint64 values
    above 2**63 included: equal heads and accumulations, bit for bit."""
    rng = np.random.default_rng(3)
    n = 4000
    keys = rng.integers(0, 57, size=n).astype(np.uint64)
    si = rng.integers(-1000, 1000, size=n).astype(np.int64)
    fv = rng.standard_normal(n)
    fv[rng.integers(0, n, size=20)] = np.nan
    uv = rng.integers(0, 1 << 63, size=n, dtype=np.uint64) * np.uint64(2)
    cols = [si, si, si, fv, fv, fv, uv, uv]
    ops = [0, 1, 2, 3, 4, 5, 6, 7]
    heads, accs = hr.hash_group_acc(
        _as_port_words([keys]), [torch.from_numpy(c) for c in cols], ops)
    jheads, jaccs = jhr.hash_group_acc([keys], cols, ops)
    assert np.array_equal(heads, jheads)
    for a, b in zip(accs, jaccs):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert len(heads) == len(set(keys.tolist()))
    # the first group's sum, by a plain fold from its first row
    k0 = keys[heads[0]]
    assert accs[0][0] == si[keys == k0].sum()


def test_hash_group_acc_refuses_a_narrow_column():
    with pytest.raises(ValueError, match="8-byte"):
        hr.hash_group_acc([np.zeros(4, np.uint64)],
                          [np.zeros(4, np.int32)], [0])


@pytest.mark.parametrize("nwords", [1, 2, 3, 4])
def test_radix_argsort_with_heavy_ties_is_the_reference_s(nwords):
    """A stable argsort by 1-4 words, few distinct values a word and
    the high bit set on some: equal to the reference's and to numpy's
    stable lexsort of the unsigned words."""
    rng = np.random.default_rng(40 + nwords)
    n = 20000
    words = []
    for i in range(nwords):
        w = rng.integers(0, 3, size=n).astype(np.uint64) << np.uint64(
            17 * i)
        w[rng.random(n) < 0.1] |= np.uint64(1 << 63)
        words.append(w)
    perm = hr.radix_argsort(_as_port_words(words))
    jperm = jhr.radix_argsort(words)
    assert perm.dtype == np.uint32 and np.array_equal(perm, jperm)
    assert np.array_equal(perm, np.lexsort(words[::-1]))
    sp, same = hr.sorted_runs(_as_port_words(words))
    jsp, jsame = jhr.sorted_runs(words)
    assert np.array_equal(sp, jsp) and np.array_equal(same, jsame)


def test_the_engine_never_runs_on_a_card_mesh():
    from thrill_tpu_torch.parallel.mesh import MeshExec

    class _Card:
        device = torch.device("cuda", 0)
        num_processes = 1

    assert not hr.eligible(_Card())
    assert hr.eligible(MeshExec(2, device="cpu"))
