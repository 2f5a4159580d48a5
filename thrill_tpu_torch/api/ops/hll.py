"""HyperLogLog distinct counting (counterpart of the reference
package's ``api/ops/hll.py``; Thrill's ``api/hyperloglog.hpp``).

Device path: each item's key words hashed (``hash_key_words``), the
register index the hash's top ``p`` bits and ``rho`` one plus the
leading zeros of the rest, a per-worker ``scatter_reduce_(..., "amax")``
into ``2^p`` int32 registers, an amax over the worker dimension (and
over the processes: ``mesh.worker_max``, or the host path's
``net_fold`` of the registers), and the estimate on the host. Every
shift is logical on int64 bit patterns (ROADMAP.md fault C1), so the
registers equal the reference's bit for bit. The host path hashes
items with ``stable_host_hash``.
"""

from __future__ import annotations

import numpy as np
import torch

from ...common import hashing
from ...core import keys as keymod
from ...data import multiplexer
from ...data.shards import DeviceShards
from ...parallel.mesh import worker_max
from ..dia import DIA


def _alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1 + 1.079 / m)


def _estimate(registers: np.ndarray, p: int) -> float:
    """The classic estimate, with linear counting for small ranges and
    the 32-bit large-range correction."""
    m = 1 << p
    inv = np.sum(np.exp2(-registers.astype(np.float64)))
    raw = _alpha(m) * m * m / inv
    if raw <= 2.5 * m:
        zeros = int(np.sum(registers == 0))
        if zeros:
            return m * np.log(m / zeros)
    two32 = float(1 << 32)
    if raw > two32 / 30.0:
        return -two32 * np.log(1.0 - raw / two32)
    return raw


def _clz_device(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of nonzero 64-bit patterns held as int64
    (branch-free doubling, logical shifts)."""
    n = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for shift in (32, 16, 8, 4, 2, 1):
        move = hashing._shr(x, 64 - shift) == 0
        n = n + move.to(torch.int32) * shift
        x = torch.where(move, x << shift, x)
    return n


def _clz64(v: int) -> int:
    n = 0
    for shift in (32, 16, 8, 4, 2, 1):
        if (v >> (64 - shift)) == 0:
            n += shift
            v = (v << shift) & 0xFFFFFFFFFFFFFFFF
    return n


def _rho_max(p: int) -> int:
    # the register range is [1, 64 - p + 1]: an all-zero rest counts as
    # the largest
    return 64 - p + 1


def device_registers(shards: DeviceShards, p: int) -> torch.Tensor:
    """int32 ``[2^p]`` registers of the items of device shards (every
    process's, max-folded, across processes)."""
    W = shards.mesh_exec.num_local
    h = hashing.hash_key_words(keymod.worker_key_words(lambda t: t,
                                                       shards.tree))
    idx = hashing._shr(h, 64 - p)
    rest = h << p
    rho = torch.where(rest == 0, _rho_max(p), _clz_device(rest) + 1)
    rho = torch.where(shards.valid_mask(), rho.clamp(max=_rho_max(p)),
                      0).to(torch.int32)
    regs = torch.zeros((W, 1 << p), dtype=torch.int32, device=h.device)
    regs.scatter_reduce_(1, idx, rho, "amax")
    return worker_max(regs, shards.mesh_exec)


def host_registers(lists, p: int) -> np.ndarray:
    """int32 ``[2^p]`` registers of host items."""
    regs = np.zeros(1 << p, dtype=np.int32)
    for items in lists:
        for it in items:
            h = hashing.stable_host_hash(
                hashing.hashable(it, nested=False))
            idx = h >> (64 - p)
            rest = (h << p) & 0xFFFFFFFFFFFFFFFF
            rho = _rho_max(p) if rest == 0 else _clz64(rest) + 1
            regs[idx] = max(regs[idx], min(rho, _rho_max(p)))
    return regs


def HyperLogLog(dia: DIA, precision: int = 14) -> float:
    p = int(precision)
    shards = dia._link().pull(consume=True)
    if isinstance(shards, DeviceShards):
        regs = shards.mesh_exec.fetch(device_registers(shards, p))
    else:
        # the sketch merges by elementwise max: across processes the
        # registers travel, not the items
        regs = multiplexer.net_fold(dia.context.mesh_exec,
                                    host_registers(shards.lists, p),
                                    np.maximum)
    return _estimate(regs, p)
