"""Deferred action results (counterpart of the reference package's
``api/future.py``; Thrill's ``ActionFuture``, ``api/action_node.hpp``).

A ``*Future`` action defers its evaluation until ``get()`` (or a call).
Issuing one reserves a unit of its DIA's consume budget
(``DIA._future``), so actions run between issue and ``get`` cannot
starve it: issue order governs consumption, as in Thrill, where the
action node is built when it is issued.
"""

from __future__ import annotations

from typing import Any, Callable, Generic, TypeVar

T = TypeVar("T")

_UNSET = object()


class ActionFuture(Generic[T]):
    def __init__(self, thunk: Callable[[], T]) -> None:
        self._thunk = thunk
        self._result: Any = _UNSET

    def get(self) -> T:
        if self._result is _UNSET:
            self._result = self._thunk()
            self._thunk = None  # drop the captured pipeline
        return self._result

    __call__ = get

    @property
    def done(self) -> bool:
        return self._result is not _UNSET
