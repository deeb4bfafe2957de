"""Tiny name -> factory registry (the JAX package's ``utils/registry.py``,
copied: the port imports nothing of it). The server-aggregation
strategies register here."""
from __future__ import annotations

from typing import Callable, Dict, Generic, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Callable[[], T]] = {}

    def register(
            self, name: str) -> Callable[[Callable[[], T]], Callable[[], T]]:
        def deco(fn: Callable[[], T]) -> Callable[[], T]:
            if name in self._entries:
                raise ValueError(f"duplicate {self.kind} registration: {name}")
            self._entries[name] = fn
            return fn

        return deco

    def get(self, name: str) -> T:
        if name not in self._entries:
            raise KeyError(
                f"unknown {self.kind} '{name}'. known: {sorted(self._entries)}"
            )
        return self._entries[name]()

    def names(self) -> list[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries
