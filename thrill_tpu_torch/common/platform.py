"""The collectives backend of a mesh of several processes (counterpart of
the reference package's ``common/platform.py``, which forces JAX's CPU
platform and picks gloo for a CPU mesh across processes).

The port's device data plane across processes is ``torch.distributed``.
Its backend is gloo in both cases this slice runs:

* a mesh on the CPU (the tests);
* a mesh on CUDA whose processes share one card. gloo takes CUDA tensors
  for ``all_to_all_single`` (even splits and the uneven ones of
  ``MeshExec.exchange_rows``), ``all_gather``, ``broadcast`` and
  ``all_reduce`` (every collective the mesh runs; checked on the H100)
  and stages them through host memory itself. It refuses bools,
  16-bit integers and uint32/uint64: the mesh's exchanges and gathers
  ship those as their bytes, and its sums, maxima and minima widen them
  to int64 (uint64 with its sign bit flipped for an order) and narrow
  the result back (parallel/mesh.py ``_reducible``). NCCL would be the backend
  for processes on distinct cards, but it refuses two ranks on one
  device, and it waits for a machine with two cards (ROADMAP.md queue A
  item 6).

:func:`init_process_group` sets up the process group of
``RunDistributed`` from an explicit address, world size and rank:
nothing on the machine tells a program of a cluster.
"""

from __future__ import annotations

import datetime

import torch


def backend_for(device: torch.device) -> str:
    """The ``torch.distributed`` backend of a mesh on ``device``: gloo
    (see the module)."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return "gloo"


def init_process_group(coordinator_address: str, num_processes: int,
                       process_id: int, device: torch.device) -> str:
    """Join the default process group at ``tcp://<coordinator_address>``
    as rank ``process_id`` of ``num_processes``; returns the backend.
    The coordinator handshake is a distress deadline like the host
    group's bootstrap (common/timeouts.py)."""
    import torch.distributed as dist

    from .timeouts import scaled
    backend = backend_for(device)
    addr = coordinator_address
    if "://" not in addr:
        addr = "tcp://" + addr
    dist.init_process_group(backend=backend, init_method=addr,
                            world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(
                                seconds=scaled(300.0)))
    return backend


def abandon_process_group() -> bool:
    """Tear this process's side of the device data plane down after an
    unrecoverable failure: a peer blocked in a gloo collective that this
    process will never enter sees its connections close and fails at
    once, instead of waiting out gloo's timeout. True when a group was
    torn down."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return False
    try:
        dist.destroy_process_group()
    except Exception:
        return False
    return True
