"""Periodic runtime profiling into the JSON event log (counterpart of
the reference package's ``common/profile.py``; Thrill: ProfileThread
and LinuxProcStatsProfiler, common/profile_thread.hpp).

:class:`ProfileThread` samples the host's CPU use (``/proc/stat``) and
RAM (``/proc/meminfo``) and the card's allocator every ``interval``
seconds as ``event=profile`` lines. The device fields come from the
CUDA caching allocator's host-side counters under the reference's
names where it has one (``bytes_in_use``, ``bytes_limit``) and the
allocator's own beside them; reading them never waits for the device.
"""

from __future__ import annotations

import threading
from typing import Optional

from .logger import JsonLogger


def _read_proc_stat():
    try:
        with open("/proc/stat") as f:
            parts = f.readline().split()
        vals = [int(x) for x in parts[1:8]]
        idle = vals[3] + vals[4]
        total = sum(vals)
        return total, idle
    except (OSError, ValueError, IndexError):
        return None


def _read_meminfo():
    try:
        out = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, _, rest = line.partition(":")
                if k in ("MemTotal", "MemAvailable"):
                    out[k] = int(rest.split()[0]) * 1024
        return out
    except (OSError, ValueError):
        return {}


def _device_memory_stats(device=None) -> dict:
    """The card's allocator counters: ``bytes_in_use`` (allocated by
    tensors), ``bytes_limit`` (the card's memory), ``peak_bytes_in_use``,
    ``bytes_reserved`` (held by the caching allocator) and
    ``num_alloc_retries``. ``{}`` on a CPU mesh or without a card. Host
    counters only: no synchronisation."""
    import sys
    torch = sys.modules.get("torch")
    if torch is None:
        return {}
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return {}
    try:
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return {}
        idx = (device.index if device is not None
               and device.index is not None
               else torch.cuda.current_device())
        ms = torch.cuda.memory_stats(idx)
        return {
            "bytes_in_use": int(torch.cuda.memory_allocated(idx)),
            "bytes_limit": int(
                torch.cuda.get_device_properties(idx).total_memory),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(idx)),
            "bytes_reserved": int(ms.get("reserved_bytes.all.current", 0)),
            "num_alloc_retries": int(ms.get("num_alloc_retries", 0)),
        }
    except Exception:
        return {}


class ProfileThread:
    """Samples host CPU and RAM and the card's memory every
    ``interval`` seconds; ``device`` is the mesh's (a CPU mesh samples
    the host only)."""

    def __init__(self, logger: JsonLogger, interval: float = 0.5,
                 device=None) -> None:
        self.logger = logger
        self.interval = interval
        self.device = device
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_cpu = None

    def start(self) -> "ProfileThread":
        if self._thread is None and self.logger.enabled:
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name="thrill-tpu-torch-profile")
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self._sample()

    def _sample(self) -> None:
        fields = {"event": "profile"}
        cpu = _read_proc_stat()
        if cpu and self._last_cpu:
            dt = cpu[0] - self._last_cpu[0]
            didle = cpu[1] - self._last_cpu[1]
            if dt > 0:
                fields["cpu_util"] = round(1.0 - didle / dt, 4)
        self._last_cpu = cpu
        mem = _read_meminfo()
        if mem:
            fields["host_mem_total"] = mem.get("MemTotal")
            fields["host_mem_available"] = mem.get("MemAvailable")
        fields.update(_device_memory_stats(self.device))
        self.logger.line(**fields)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
