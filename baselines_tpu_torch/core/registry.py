"""A tiny string -> object registry (counterpart of baselines_tpu/core/registry.py).

The port's network and env tables are ``Registry`` objects, as the JAX package's are:
registering a name twice raises ``ValueError``, and so does ``get`` of a name that was
never registered, listing the names that were.
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, Iterable, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, T] = {}

    def register(self, name: str) -> Callable[[T], T]:
        def deco(obj: T) -> T:
            if name in self._entries:
                raise ValueError(f"duplicate {self.kind} registration: {name!r}")
            self._entries[name] = obj
            return obj

        return deco

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def get(self, name: str) -> T:
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(sorted(self._entries))
            raise ValueError(
                f"unknown {self.kind} {name!r}; registered: {known}"
            ) from None

    def names(self) -> Iterable[str]:
        return sorted(self._entries)
