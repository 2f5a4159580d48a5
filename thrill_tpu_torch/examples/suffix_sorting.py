"""Suffix sorting, the Sort-heaviest user (the port's copy of the
reference package's ``examples/suffix_sorting.py``).

    python -m thrill_tpu_torch.examples.suffix_sorting --size 10000 --device cpu

Prefix doubling keeps the ranks as device columns: each round is one
Sort of (rank[i], rank[i+h], i) and a neighbour compare that assigns the
new ranks. Quadrupling, DC3 and DC7 sort their tuples with the DIA Sort
and merge on the host; the wavelet matrix is one SortStable by the
current bit a level; the BWT and its run-length form read the suffix
array.
"""

from __future__ import annotations

import numpy as np
import torch

from thrill_tpu_torch.api import Context


def _sa_rank_key(t):
    return (t["r1"], t["r2"])


def _sorted_columns(ctx: Context, cols: dict, key_fn) -> dict:
    """``cols`` sorted by ``key_fn`` through the DIA Sort, as host
    arrays."""
    got = ctx.Distribute(cols).Sort(key_fn=key_fn).AllGatherArrays()
    return {k: v.cpu().numpy() for k, v in got.items()}


def suffix_array(ctx: Context, text: np.ndarray) -> np.ndarray:
    """text: [n] uint8. Returns the suffix array [n] int64.

    The doubling loop stays on the device: the sorted columns come back
    as device tensors (AllGatherArrays), the new ranks are torch math,
    and Distribute splits device tensors without a host copy. The one
    sync a round is the count of distinct ranks that ends the loop."""
    n = len(text)
    if n == 0:
        return np.array([], dtype=np.int64)
    dev = ctx.mesh_exec.device

    # initial ranks = byte values; sentinel handling via +1
    rank = torch.as_tensor(text.astype(np.int64) + 1, device=dev)
    idx = torch.arange(n, device=dev)
    h = 1
    while True:
        rank2 = torch.zeros(n, dtype=torch.int64, device=dev)
        if h < n:
            rank2[:n - h] = rank[h:]

        d = ctx.Distribute({"i": idx, "r1": rank, "r2": rank2})
        s = d.Sort(key_fn=_sa_rank_key)
        # columnar egress in worker-rank order = global sort order
        cols = s.AllGatherArrays()
        si, r1, r2 = cols["i"], cols["r1"], cols["r2"]

        # new ranks: 1 + prefix count of strict (r1, r2) boundaries
        boundary = torch.cat([
            torch.ones(1, dtype=torch.int64, device=dev),
            ((r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])).to(torch.int64)])
        new_rank_sorted = torch.cumsum(boundary, dim=0)
        # si is a permutation, so no two writes share an index and the
        # scatter is deterministic on CUDA too
        rank = torch.zeros(n, dtype=torch.int64, device=dev).index_put_(
            (si,), new_rank_sorted)
        if int(new_rank_sorted[-1]) == n:       # termination sync
            return si.cpu().numpy()
        h *= 2
        if h >= 2 * n:
            return si.cpu().numpy()


def _quad_key(t):
    return (t["a"], t["b"], t["c"], t["d"])


def suffix_array_quadrupling(ctx: Context, text: np.ndarray) -> np.ndarray:
    """Prefix quadrupling: rank refinement advancing h by 4x per round
    with (rank[i], rank[i+h], rank[i+2h], rank[i+3h]) quadruple keys —
    half the distributed sorts of doubling at wider keys (reference:
    examples/suffix_sorting/prefix_quadrupling.cpp)."""
    n = len(text)
    if n == 0:
        return np.array([], dtype=np.int64)

    rank = text.astype(np.int64) + 1
    idx = np.arange(n, dtype=np.int64)
    h = 1
    while True:
        def shifted(k):
            out = np.zeros(n, dtype=np.int64)
            if k < n:
                out[:n - k] = rank[k:]
            return out

        r2, r3, r4 = shifted(h), shifted(2 * h), shifted(3 * h)
        got = _sorted_columns(ctx, {"i": idx, "a": rank, "b": r2, "c": r3,
                                    "d": r4}, _quad_key)
        si = got["i"]
        boundary = np.ones(n, dtype=np.int64)
        neq = np.zeros(n - 1, dtype=bool)
        for k in ("a", "b", "c", "d"):
            neq |= got[k][1:] != got[k][:-1]
        boundary[1:] = neq.astype(np.int64)
        new_rank_sorted = np.cumsum(boundary)
        rank = np.zeros(n, dtype=np.int64)
        rank[si] = new_rank_sorted
        if new_rank_sorted[-1] == n:
            return si
        h *= 4
        if h >= 4 * n:
            return si


def dc3_suffix_array(ctx: Context, text: np.ndarray) -> np.ndarray:
    """DC3 (difference cover mod 3, a.k.a. skew) suffix array.

    Reference: examples/suffix_sorting/dc3.cpp. The (t_i, t_{i+1},
    t_{i+2}) triple sort of the mod-1/mod-2 sample and the (t_i,
    rank_{i+1}) sort of the mod-0 class are DIA Sorts at every recursion
    level; lexicographic naming and the class-aware 3-way merge are
    linear host passes.
    """
    T = np.asarray(text, dtype=np.int64) + 1     # 0 reserved as sentinel
    return _dc3(ctx, T)


def _triple_key(t):
    return (t["a"], t["b"], t["c"])


def _pair_key(t):
    return (t["a"], t["r"])


def _dc3(ctx: Context, T: np.ndarray) -> np.ndarray:
    n = len(T)
    if n <= 3:
        return np.array(sorted(range(n),
                               key=lambda i: tuple(T[i:]) + (0,)),
                        dtype=np.int64)

    # canonical Kärkkäinen–Sanders counts: when n % 3 == 1 the sample
    # gains the dummy position n (triple (0,0,0)), so the mod-1 section
    # of the recursion string ends with a unique smallest terminator
    n0 = (n + 2) // 3
    n1 = (n + 1) // 3
    ext = n0 - n1                    # 1 iff n % 3 == 1
    m = n + ext
    Tp = np.concatenate([T, np.zeros(3 + ext, dtype=np.int64)])
    s12 = np.array([i for i in range(m) if i % 3 != 0], dtype=np.int64)

    # device sort of the sample triples (the hot phase)
    got = _sorted_columns(ctx, {"i": s12, "a": Tp[s12], "b": Tp[s12 + 1],
                                "c": Tp[s12 + 2]}, _triple_key)
    order = got["i"]
    trip = np.stack([got["a"], got["b"], got["c"]], axis=1)

    # lexicographic names: 1 + count of strict triple boundaries
    boundary = np.ones(len(order), dtype=np.int64)
    if len(order) > 1:
        boundary[1:] = np.any(trip[1:] != trip[:-1], axis=1)
    names_sorted = np.cumsum(boundary)
    num_names = int(names_sorted[-1])
    name_of = np.zeros(m + 3, dtype=np.int64)
    name_of[order] = names_sorted

    if num_names < len(s12):
        # names collide: recurse on the sample string (mod-1 positions
        # then mod-2 positions, the canonical DC3 arrangement)
        ones = np.array([i for i in range(m) if i % 3 == 1])
        twos = np.array([i for i in range(m) if i % 3 == 2])
        R = np.concatenate([name_of[ones], name_of[twos]])
        SA_R = _dc3(ctx, R)
        k1 = len(ones)
        SA12 = np.where(SA_R < k1, 1 + 3 * SA_R, 2 + 3 * (SA_R - k1))
    else:
        SA12 = order

    # rank of each sample suffix in SA12 (1-based; 0 = beyond end)
    rank12 = np.zeros(m + 3, dtype=np.int64)
    rank12[SA12] = np.arange(1, len(SA12) + 1)
    # the dummy (position n, empty suffix) leaves the output
    SA12 = SA12[SA12 < n]

    # device sort of the mod-0 class by (t_i, rank_{i+1})
    s0 = np.array([i for i in range(n) if i % 3 == 0], dtype=np.int64)
    SA0 = _sorted_columns(ctx, {"i": s0, "a": Tp[s0],
                                "r": rank12[s0 + 1]}, _pair_key)["i"]

    # class-aware linear merge (reference: dc3.cpp merge comparators)
    def leq12(i, j):
        """suffix i (mod 1 or 2) <= suffix j (mod 0)?"""
        if i % 3 == 1:
            return (Tp[i], rank12[i + 1]) <= (Tp[j], rank12[j + 1])
        return (Tp[i], Tp[i + 1], rank12[i + 2]) <= \
            (Tp[j], Tp[j + 1], rank12[j + 2])

    out = np.empty(n, dtype=np.int64)
    a = b = k = 0
    while a < len(SA12) and b < len(SA0):
        if leq12(int(SA12[a]), int(SA0[b])):
            out[k] = SA12[a]
            a += 1
        else:
            out[k] = SA0[b]
            b += 1
        k += 1
    while a < len(SA12):
        out[k] = SA12[a]
        a += 1
        k += 1
    while b < len(SA0):
        out[k] = SA0[b]
        b += 1
        k += 1
    return out


def suffix_array_dense(text: np.ndarray) -> np.ndarray:
    s = bytes(text)
    return np.array(sorted(range(len(s)), key=lambda i: s[i:]),
                    dtype=np.int64)


# DC7 difference cover: {0, 1, 3} mod 7 (differences cover Z_7), so 3/7
# of positions are sampled and any two residues share an aligning shift
DC7_D = (0, 1, 3)
# SHIFT[a][b] = min t >= 0 with (a+t) % 7 in D and (b+t) % 7 in D
DC7_SHIFT = [[min(t for t in range(7)
                  if (a + t) % 7 in DC7_D and (b + t) % 7 in DC7_D)
              for b in range(7)] for a in range(7)]


def dc7_suffix_array(ctx: Context, text: np.ndarray) -> np.ndarray:
    """DC7 (difference cover mod 7) suffix array.

    Reference: examples/suffix_sorting/dc7.cpp. Like DC3 but samples 3/7
    of positions with the perfect difference cover {0,1,3} mod 7, so
    each recursion level shrinks by 3/7 and sorts wider (7-char)
    tuples. The sample 7-tuple sort and the batched non-sample class
    sort ride the DIA Sort; naming and the comparator merge are linear
    host passes.
    """
    return _dc7(ctx, np.asarray(text, dtype=np.int64))


def _seven_key(t):
    return tuple(t[f"c{k}"] for k in range(7))


def _dc7(ctx: Context, S: np.ndarray) -> np.ndarray:
    """Suffix array of an arbitrary non-negative int string S."""
    n = len(S)
    if n <= 16:
        return np.array(sorted(range(n),
                               key=lambda i: tuple(S[i:]) + (-1,)),
                        dtype=np.int64)

    # internal shift so 0 is reserved for padding/terminators: zeros
    # then appear only in the tail, making every zero-containing
    # 7-tuple position-unique (shorter-suffix-sorts-first semantics)
    T = S + 1
    Tp = np.concatenate([T, np.zeros(14, dtype=np.int64)])

    res = np.arange(n) % 7
    s_cls = [np.flatnonzero(res == c).astype(np.int64) for c in range(7)]
    s_all = np.concatenate([s_cls[c] for c in DC7_D])

    # ---- device sort of the sample 7-tuples (naming phase) ----------
    got = _sorted_columns(ctx, {"i": s_all, **{f"c{k}": Tp[s_all + k]
                                               for k in range(7)}},
                          _seven_key)
    order = got["i"]
    tup = np.stack([got[f"c{k}"] for k in range(7)], axis=1)

    boundary = np.ones(len(order), dtype=np.int64)
    if len(order) > 1:
        boundary[1:] = np.any(tup[1:] != tup[:-1], axis=1)
    names_sorted = np.cumsum(boundary)
    num_names = int(names_sorted[-1])
    name_of = np.zeros(n + 14, dtype=np.int64)
    name_of[order] = names_sorted

    if num_names < len(s_all):
        # recursion string: class sections joined by 0 terminators (a
        # unique-smallest section end keeps cross-section comparisons
        # from ever being decided by wrapped-around names; the
        # recursion re-shifts internally, so 0 stays reserved)
        sections = [name_of[s_cls[c]] for c in DC7_D]
        R = np.concatenate([sections[0], [0], sections[1], [0],
                            sections[2]])
        pos_map = np.concatenate([s_cls[DC7_D[0]], [-1],
                                  s_cls[DC7_D[1]], [-1],
                                  s_cls[DC7_D[2]]])
        SA_R = _dc7(ctx, R)
        SA12 = pos_map[SA_R]
        SA12 = SA12[SA12 >= 0]
    else:
        SA12 = order

    rank7 = np.zeros(n + 14, dtype=np.int64)
    rank7[SA12] = np.arange(1, len(SA12) + 1)

    # ---- one batched device sort of the non-sample classes ----------
    # class c orders by (T[i..i+tc-1], rank7[i+tc]); keys are laid out
    # (class, ch0.., rank, 0-pad) so one Sort covers all four classes
    ns_cls = [c for c in range(7) if c not in DC7_D]
    ns_pos = np.concatenate([s_cls[c] for c in ns_cls])
    if len(ns_pos):
        tcs = np.array([DC7_SHIFT[c][c] for c in range(7)], dtype=np.int64)
        tmax = int(tcs[ns_cls].max())              # = 3 for {0,1,3}
        keys = np.zeros((len(ns_pos), tmax + 2), dtype=np.int64)
        keys[:, 0] = ns_pos % 7
        for c in ns_cls:                           # 4 vectorized fills
            mask = ns_pos % 7 == c
            pos = ns_pos[mask]
            tc = int(tcs[c])
            keys[np.flatnonzero(mask)[:, None], 1 + np.arange(tc)] = \
                Tp[pos[:, None] + np.arange(tc)]
            keys[mask, 1 + tc] = rank7[pos + tc]
        gotn = _sorted_columns(
            ctx, {"i": ns_pos, **{f"k{j}": keys[:, j]
                                  for j in range(tmax + 2)}},
            lambda t: tuple(t[f"k{j}"] for j in range(tmax + 2)))
        seqs = [SA12.tolist()] + [gotn["i"][gotn["k0"] == c].tolist()
                                  for c in ns_cls]
    else:
        seqs = [SA12.tolist()]

    # ---- comparator merge of the 5 sorted sequences -----------------
    import heapq
    from functools import cmp_to_key

    def cmp(i: int, j: int) -> int:
        t = DC7_SHIFT[i % 7][j % 7]
        for k in range(t):
            if Tp[i + k] != Tp[j + k]:
                return -1 if Tp[i + k] < Tp[j + k] else 1
        ri, rj = rank7[i + t], rank7[j + t]
        return -1 if ri < rj else (1 if ri > rj else 0)

    out = np.fromiter(
        heapq.merge(*seqs, key=cmp_to_key(cmp)), dtype=np.int64, count=n)
    return out


def _bit_key(t):
    return t["b"]


def wavelet_tree(ctx: Context, text: np.ndarray, bits: int = 8):
    """Wavelet matrix (level-ordered wavelet tree) of a byte sequence.

    Construction is one stable bit-partition per level: one SortStable
    by the current bit. Returns one packed bitvector per level, MSB
    first, each in that level's element order.
    """
    levels = []
    cur = np.asarray(text, dtype=np.uint8)
    for b in reversed(range(bits)):
        bit = (cur >> b) & 1
        levels.append(np.packbits(bit))
        if b == 0:
            break
        # stable partition by the current bit = stable sort on it
        d = ctx.Distribute({"v": cur.astype(np.int64),
                            "b": bit.astype(np.int64)})
        got = d.SortStable(key_fn=_bit_key).AllGatherArrays()
        cur = got["v"].cpu().numpy().astype(np.uint8)
    return levels


def wavelet_access(levels, n: int, i: int, bits: int = 8) -> int:
    """Reconstruct the symbol at original position i from the matrix
    (rank-based descent; validates the construction)."""
    sym = 0
    pos = i
    for lvl in range(bits):
        bv = np.unpackbits(levels[lvl])[:n]
        b = int(bv[pos])
        sym = (sym << 1) | b
        if lvl == bits - 1:
            break
        if b == 0:
            pos = int(np.sum(bv[:pos] == 0))
        else:
            pos = int(np.sum(bv == 0)) + int(np.sum(bv[:pos] == 1))
    return sym


def bwt(ctx: Context, text: np.ndarray) -> np.ndarray:
    """Burrows-Wheeler transform via the suffix array."""
    sa = suffix_array(ctx, text)
    return text[(sa - 1) % len(text)]


def rl_bwt(ctx: Context, text: np.ndarray):
    """Run-length-compressed BWT: (run chars, run lengths) (reference:
    examples/suffix_sorting/rl_bwt.cpp; boundary flags and segment
    lengths on the host)."""
    b = bwt(ctx, text)
    if len(b) == 0:
        return np.array([], dtype=text.dtype), np.array([], np.int64)
    starts = np.concatenate([[0], np.flatnonzero(b[1:] != b[:-1]) + 1])
    lengths = np.diff(np.concatenate([starts, [len(b)]]))
    return b[starts], lengths.astype(np.int64)


def check_sa(text: np.ndarray, sa: np.ndarray) -> bool:
    """Linear-time suffix array verification.

    Reference: examples/suffix_sorting/check_sa.hpp — permutation check
    plus the rank trick: sa is correct iff for consecutive entries
    (text[sa[r-1]], rank[sa[r-1]+1]) <= (text[sa[r]], rank[sa[r]+1])
    with the empty suffix ranked smallest.
    """
    n = len(text)
    sa = np.asarray(sa)
    if len(sa) != n:
        return False
    if n == 0:
        return True
    if not np.array_equal(np.sort(sa), np.arange(n)):
        return False
    rank = np.zeros(n + 1, dtype=np.int64)
    rank[sa] = np.arange(1, n + 1)                 # rank[n] = 0 (empty)
    a, b = sa[:-1], sa[1:]
    ca, cb = text[a], text[b]
    ra, rb = rank[a + 1], rank[b + 1]
    return bool(np.all((ca < cb) | ((ca == cb) & (ra < rb))))


def lcp_from_sa(text: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """LCP array (lcp[r] = lcp(suffix sa[r-1], suffix sa[r]), lcp[0]=0)
    by Kasai's algorithm, in O(n) host time from any valid SA."""
    n = len(text)
    lcp = np.zeros(n, dtype=np.int64)
    if n == 0:
        return lcp
    rank = np.zeros(n, dtype=np.int64)
    rank[sa] = np.arange(n)
    h = 0
    for i in range(n):
        r = rank[i]
        if r > 0:
            j = int(sa[r - 1])
            while i + h < n and j + h < n and text[i + h] == text[j + h]:
                h += 1
            lcp[r] = h
            if h > 0:
                h -= 1
        else:
            h = 0
    return lcp


def main():
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", type=int, default=10000)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args()

    from thrill_tpu_torch.api import Run

    def job(ctx):
        rng = np.random.default_rng(0)
        text = rng.integers(97, 101, args.size).astype(np.uint8)
        sa = suffix_array(ctx, text)
        print("suffix array head:", sa[:10])

    Run(job, device=args.device)


if __name__ == "__main__":
    main()
