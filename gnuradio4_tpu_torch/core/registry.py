"""Block registry (≈ the reference's ``GeneralRegistry``, BlockRegistry.hpp:44).

Registration is a decorator at import time. The port keeps its own registry, so
a graph built by registry name in both packages gets the counterpart block type
in each.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

from .block import Block
from .errors import GrError


class BlockRegistry:
    def __init__(self):
        self._factories: dict[str, Callable[..., Block]] = {}

    def register(self, name: str | None = None, *, aliases: Iterable[str] = ()
                 ) -> Callable[[type], type]:
        def deco(cls: type) -> type:
            key = name or cls.__name__
            for k in (key, *aliases):
                if k in self._factories and self._factories[k] is not cls:
                    raise GrError(f"block type {k!r} already registered")
                self._factories[k] = cls
            cls.registry_name = key
            return cls
        return deco

    def known_blocks(self) -> list[str]:
        return sorted(self._factories)

    def create(self, name: str, /, **settings: Any) -> Block:
        try:
            factory = self._factories[name]
        except KeyError as e:
            raise GrError(f"unknown block type {name!r}; known: {self.known_blocks()}") from e
        return factory(**settings)


global_registry = BlockRegistry()
register_block = global_registry.register


class SchedulerRegistry:
    """Parallel registry for scheduler types (≈ BlockRegistry.hpp:152)."""

    def __init__(self):
        self._factories: dict[str, Callable[..., Any]] = {}

    def register(self, name: str | None = None):
        def deco(cls):
            self._factories[name or cls.__name__] = cls
            return cls
        return deco

    def known_schedulers(self) -> list[str]:
        return sorted(self._factories)

    def create(self, name: str, /, *args, **kw):
        try:
            factory = self._factories[name]
        except KeyError as e:
            raise GrError(f"unknown scheduler type {name!r}; known: "
                          f"{self.known_schedulers()}") from e
        return factory(*args, **kw)


global_scheduler_registry = SchedulerRegistry()
register_scheduler = global_scheduler_registry.register
