"""The worker mesh: W virtual workers in one process on one device.

Counterpart of the reference package's ``parallel/mesh.py``. Every
worker's shard is one slice of the leading tensor dimension of a
``[W, cap, ...]`` leaf, so a per-worker program is one batched torch op
and an all-to-all between workers is a transpose of the worker
dimension. Multiple cards and ``torch.distributed`` come later.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another. Raises when CUDA is asked for and absent; there is no
    silent fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class CountedCall:
    """A plain callable plus the count of its calls."""

    __slots__ = ("fn", "calls")

    def __init__(self, fn: Callable) -> None:
        self.fn = fn
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


class MeshExec:
    """W workers on one device, plus the mesh's traffic counters."""

    def __init__(self, num_workers: int = 1,
                 device: DeviceLike = None) -> None:
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self.num_workers = int(num_workers)
        self.device = resolve_device(device)
        # exchange traffic (reference: net::Manager tx/rx counters)
        self.stats_exchanges = 0
        self.stats_items_moved = 0
        self.stats_bytes_moved = 0
        # (live passes, candidate passes) of every radix argsort run
        self.radix_passes: List[Tuple[int, int]] = []
        # sticky pre-shuffle verdicts by (kind, site) (core/preshuffle.py)
        self.prune_verdicts: Dict[Tuple, bool] = {}
        self._cache: Dict[Tuple, Any] = {}

    def cached(self, key: Tuple, builder: Callable[[], Any]) -> Any:
        """``builder()``'s result, built once per key on this mesh."""
        if key not in self._cache:
            self._cache[key] = builder()
        return self._cache[key]

    def jit_cached(self, key: Tuple, fn: Callable) -> "CountedCall":
        """``fn`` behind a call counter, one per key (reference: a cached
        ``jax.jit`` of an iterative program's small update step). Torch
        runs ``fn`` eagerly: there is no trace to cache, only the
        callable and the count of its calls."""
        return self.cached(key, lambda: CountedCall(fn))

    def put_small(self, arr) -> torch.Tensor:
        """A host array on the mesh's device."""
        return torch.as_tensor(np.asarray(arr), device=self.device)

    def fetch(self, t: torch.Tensor) -> np.ndarray:
        """A device tensor on the host (waits for the device)."""
        return t.detach().cpu().numpy()

    def __repr__(self) -> str:
        return f"MeshExec(num_workers={self.num_workers}, device={self.device})"
