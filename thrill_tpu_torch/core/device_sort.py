"""The device sort engine (counterpart of the reference package's
``core/device_sort.py``): one entry point, ``argsort_words``, a stable
argsort by a list of int64 key words (``core/keys.py``).

Two engines: the radix engine (``core/pallas_sort.py``: the histogram
and stable-partition kernels, 8-bit digits) and the plain engine, a
stable ``torch.argsort`` per word from the last word to the first, a
sort outside any kernel of the port as the reference's ``lax.sort`` is.
On the CPU the plain engine runs. On the card every sort takes the
radix engine, so the port's kernels do the sorting of every path;
:func:`sort_engine_policy` still prices both engines with constants
measured on the H100 (``python3 kernel_times.py --sort-engines``) and
the choice is a ``sort_engine`` decision of the ledger, the plain
engine's modelled cost its rejected alternative. ``THRILL_TPU_SORT_IMPL``
(the reference's switch) forces ``radix`` or ``plain`` (the reference's
``xla``); ``auto``, the default, is the policy.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .keys import order_view
from .pallas_sort import radix_argsort_device

# The engines' costs on the card, in microseconds, fitted to the sweep
# of `python3 kernel_times.py --sort-engines` (n = 2^10 to 2^24 rows,
# 1 to 3 words; PERF.md: NVIDIA H100 80GB HBM3, 700.00 W):
#   radix  = launch * (words + passes) + rows * passes * per_row_pass
#   plain  = launch * words + rows * words * per_row_word
# (rows = every worker's rows, passes = 8-bit digits of the used bits).
# The fit puts the plain engine ahead below about 4M rows; the card
# takes the radix engine all the same (the port's sorting is its
# kernels'), and the record keeps both costs.
_CUDA_COSTS = {"radix_launch_us": 42.93, "radix_row_pass_us": 1.532e-5,
               "plain_launch_us": 121.47, "plain_row_word_us": 1.902e-4}
# rows per microsecond of a plain sort on the CPU (the reference's
# n log n model; only its record reads it)
_CPU_OPS_PER_US = 2e3


def sort_engine_policy(n: int, total_bits: int, radix_ok: bool,
                       platform: str = "cuda",
                       words: int = 1) -> Tuple[str, Dict[str, float], str]:
    """The one cost model of the engine choice, shared by the planner
    (``Planner.sort_engine``) and the planner-off path. Returns
    (engine, modelled microseconds per candidate, reason); the
    reference's ``xla`` engine is ``plain`` here. On the card the
    engine is radix whenever it is eligible, at every size."""
    if platform != "cuda":
        lg = max(1.0, math.log2(max(n, 2)))
        return ("plain", {"plain": n * lg / _CPU_OPS_PER_US},
                "plain engine on the CPU")
    c = _CUDA_COSTS
    passes = max(1, (total_bits + 7) // 8)
    costs = {"plain": c["plain_launch_us"] * words
             + n * words * c["plain_row_word_us"]}
    if not radix_ok:
        return "plain", costs, "radix ineligible"
    costs["radix"] = (c["radix_launch_us"] * (words + passes)
                      + n * passes * c["radix_row_pass_us"])
    return "radix", costs, ("radix cheaper at this size"
                            if costs["radix"] <= costs["plain"] else
                            "the port's kernels sort on the card")


def plain_argsort_words(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable LSD argsort by whole words: ``torch.argsort(stable=True)``
    of each word's order view, last word first."""
    shape = words[0].shape
    words = [w if w.dim() == 2 else w.unsqueeze(0) for w in words]
    R, n = words[0].shape
    perm = torch.arange(n, device=words[0].device).expand(R, n).contiguous()
    for w in reversed(words):
        key = order_view(torch.gather(w, 1, perm))
        perm = torch.gather(perm, 1, torch.argsort(key, dim=1, stable=True))
    return perm.reshape(shape)


def _choose(words: List[torch.Tensor],
            word_bits: Optional[Sequence[int]], record: bool = True) -> str:
    """The auto engine for ``words``, through the planner when one is
    attached, recorded in the decision ledger once per program (on its
    first call, as the reference records at trace time) or, outside a
    program, once per node and site."""
    from ..parallel import mesh as _mesh
    mex = _mesh.current_mex()
    dev = words[0].device
    n = words[0].shape[-1]                 # one worker's rows
    rows = words[0].numel()                # every worker's
    total_bits = sum(64 if word_bits is None else int(word_bits[k])
                     for k in range(len(words)))
    site = f"sort:n{n}:w{len(words)}"
    pl = getattr(mex, "planner", None) if mex is not None else None
    if pl is not None and pl.enabled:
        engine, costs, reason = pl.sort_engine(rows, total_bits, True,
                                               site=site,
                                               words=len(words))
    else:
        engine, costs, reason = sort_engine_policy(
            rows, total_bits, True, dev.type, len(words))
    led = getattr(mex, "decisions", None) if mex is not None else None
    if record and led is not None and led.enabled:
        prog = mex.current_program
        if prog is not None:
            fresh = prog.calls == 1
        else:
            # outside a program: once per node computing and site
            seen = getattr(mex, "_sort_sites", None)
            if seen is None:
                seen = mex._sort_sites = set()
            key = (led._current_node()[0], site)
            fresh = key not in seen
            seen.add(key)
        if fresh:
            rec = led.record("sort_engine", site=site, chosen=engine,
                             predicted=costs.get(engine),
                             rejected=[(e, c) for e, c
                                       in sorted(costs.items())
                                       if e != engine],
                             reason=reason, n=n, total_bits=total_bits)
            if prog is not None:
                # audited by the program's later host time (the
                # reference joins its dispatch latency alike)
                prog.engine_recs.append(rec)
    return engine


def argsort_words(words: List[torch.Tensor],
                  word_bits: Optional[Sequence[int]] = None,
                  passes: Optional[List[Tuple[int, int]]] = None,
                  sync_free: bool = False,
                  record: bool = True) -> torch.Tensor:
    """Stable argsort by key words (``[n]`` or per worker ``[W, n]``,
    lexicographic, unsigned order). ``word_bits`` bounds the used bits
    of each word for the radix engine; ``sync_free`` (with ``word_bits``)
    sorts by every digit of those bits without reading which are live,
    always on the radix engine. ``record=False`` keeps the engine choice
    out of the decision ledger (the Sort's merge of received runs, a
    merge tree in the reference, which records no engine choice)."""
    dev = words[0].device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"argsort_words: unsupported device {dev}")
    if dev.type == "cuda" and sync_free:
        return radix_argsort_device(words, word_bits=word_bits,
                                    passes=passes, sync_free=True)
    mode = os.environ.get("THRILL_TPU_SORT_IMPL", "auto")
    if mode in ("plain", "xla"):
        return plain_argsort_words(words)
    if mode == "radix" or _choose(words, word_bits, record) == "radix":
        return radix_argsort_device(words, word_bits=word_bits,
                                    passes=passes, sync_free=sync_free)
    return plain_argsort_words(words)
