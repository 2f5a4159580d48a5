"""The runtime handle passed to user jobs (counterpart of a minimal
reference package's ``api/context.py``: no service plane, checkpoints,
elasticity or host group)."""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

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

    def Distribute(self, items):
        from .ops.sources import Distribute
        return Distribute(self, items)


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
