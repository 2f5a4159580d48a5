"""The runtime handle passed to user jobs (counterpart of a minimal
reference package's ``api/context.py``: no service plane, checkpoints,
elasticity or host group)."""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch

from ..parallel.mesh import DeviceLike, MeshExec


class Context:
    """Owns the mesh of W virtual workers and the DIA graph's nodes."""

    def __init__(self, mesh_exec: Optional[MeshExec] = None,
                 num_workers: int = 1, device: DeviceLike = None) -> None:
        self.mesh_exec = mesh_exec or MeshExec(num_workers=num_workers,
                                               device=device)
        self._next_id = 0

    @property
    def num_workers(self) -> int:
        return self.mesh_exec.num_workers

    def _register_node(self, node) -> int:
        self._next_id += 1
        return self._next_id

    def Generate(self, size: int, fn: Optional[Callable] = None):
        from .ops.sources import Generate
        return Generate(self, size, fn)

    def Distribute(self, items, storage: Optional[str] = None):
        from .ops.sources import Distribute
        return Distribute(self, items, storage)

    def EqualToDIA(self, items, storage: Optional[str] = None):
        """Data every worker holds alike, as a DIA (reference:
        api/equal_to_dia.hpp:30); one process holds it for every worker,
        so this is Distribute."""
        from .ops.sources import Distribute
        return Distribute(self, items, storage)

    def ConcatToDIA(self, per_worker_items, storage: Optional[str] = None):
        from .ops.sources import ConcatToDIA
        return ConcatToDIA(self, per_worker_items, storage)

    def overall_stats(self) -> dict:
        """The counters the port keeps (reference: OverallStats): the
        mesh's exchange traffic, the nodes created and the peak device
        bytes (``torch.cuda.max_memory_allocated``; 0 on the CPU)."""
        mex = self.mesh_exec
        dev = mex.device
        return {
            "workers": self.num_workers,
            "nodes_created": self._next_id,
            "exchanges": mex.stats_exchanges,
            "items_moved": mex.stats_items_moved,
            "bytes_moved": mex.stats_bytes_moved,
            "hbm_peak": (int(torch.cuda.max_memory_allocated(dev))
                         if dev.type == "cuda" else 0),
        }


def Run(job: Callable[[Context], Any], num_workers: int = 1,
        device: DeviceLike = None) -> Any:
    """Run ``job`` on a fresh Context of ``num_workers`` workers."""
    return job(Context(num_workers=num_workers, device=device))


def RunLocalTests(job: Callable[[Context], Any],
                  worker_counts: Sequence[int] = (1, 2, 4),
                  device: DeviceLike = None) -> List[Any]:
    """Sweep ``job`` over several worker counts on one device
    (reference: api::RunLocalTests)."""
    return [Run(job, w, device) for w in worker_counts]
