"""Nodes for local ops that leave the device path (counterpart of the
reference package's ``api/ops/lop_nodes.py``): the host FlatMap and the
explicit ToHost/ToDevice moves between storages."""

from __future__ import annotations

from typing import Callable

from ...data.shards import DeviceShards, HostShards
from ..dia import DIA
from ..dia_base import DIABase, ParentLink


class HostFlatMapNode(DIABase):
    """The general FlatMap, ``fn(item) -> iterable`` of any length
    (reference: api/dia.hpp:458), over host item lists; device input is
    demoted first."""

    def __init__(self, ctx, link: ParentLink, fn: Callable) -> None:
        super().__init__(ctx, "FlatMapHost", [link])
        self.fn = fn

    def compute(self) -> HostShards:
        shards = self.parents[0].pull()
        if isinstance(shards, DeviceShards):
            shards = shards.to_host_shards("flatmap-host")
        return HostShards(shards.num_workers,
                          [[out for it in items for out in self.fn(it)]
                           for items in shards.lists])


class ToHostNode(DIABase):
    def __init__(self, ctx, link: ParentLink) -> None:
        super().__init__(ctx, "ToHost", [link])

    def compute(self) -> HostShards:
        shards = self.parents[0].pull()
        if isinstance(shards, DeviceShards):
            return shards.to_host_shards("explicit-tohost")
        return shards


class ToDeviceNode(DIABase):
    def __init__(self, ctx, link: ParentLink) -> None:
        super().__init__(ctx, "ToDevice", [link])

    def compute(self) -> DeviceShards:
        shards = self.parents[0].pull()
        if isinstance(shards, HostShards):
            return shards.to_device(self.context.mesh_exec)
        return shards


def flat_map_host(dia: DIA, fn: Callable) -> DIA:
    return DIA(HostFlatMapNode(dia.context, dia._link(), fn))


def to_host(dia: DIA) -> DIA:
    return DIA(ToHostNode(dia.context, dia._link()))


def to_device(dia: DIA) -> DIA:
    return DIA(ToDeviceNode(dia.context, dia._link()))
