"""Launch counts of the kernel wrappers.

Each CUDA wrapper is wrapped in ``counted``: the wrapper adds one with
``add_launch()`` where it launches its kernel, and ``.launches`` reads
or resets the count.  A lock guards the count, so replicas' driver
threads that launch at once lose no increment.
"""
from __future__ import annotations

import functools
import threading
from typing import Any, Callable


class counted:
    """A kernel wrapper with a lock-guarded launch count."""

    def __init__(self, fn: Callable[..., Any]) -> None:
        functools.update_wrapper(self, fn)
        self._fn = fn
        self._lock = threading.Lock()
        self._launches = 0

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self._fn(*args, **kwargs)

    def add_launch(self) -> None:
        with self._lock:
            self._launches += 1

    @property
    def launches(self) -> int:
        with self._lock:
            return self._launches

    @launches.setter
    def launches(self, n: int) -> None:
        with self._lock:
            self._launches = n
