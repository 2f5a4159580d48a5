"""Hooks through which code outside torch's dispatcher tells a loop
capture (``api/loop.py``) what it read and wrote.

A capture follows, through every aten op, which loop value each tensor
was computed from. Two things escape it: a hand-written kernel, which
writes its output through a raw pointer, and a host read the capture
cannot see as an op (``.tolist()`` or ``.numpy()`` of a CPU tensor).
Each kernel wrapper calls :func:`kernel_edge` after it launches, and the
radix engine's live-digit read calls :func:`host_read`. Outside a
capture each call costs one global read.
"""

from __future__ import annotations

from typing import Sequence

#: the capture in progress (``api/loop.py`` ``_Recorder``), or None
TRACKER = None


def kernel_edge(inputs: Sequence, outputs: Sequence) -> None:
    """A kernel read the tensors ``inputs`` (None entries skipped) and
    wrote ``outputs``."""
    t = TRACKER
    if t is not None:
        t.kernel_edge(inputs, outputs)


def host_read(tensor) -> None:
    """The host read ``tensor``'s values."""
    t = TRACKER
    if t is not None:
        t.host_read(tensor)
