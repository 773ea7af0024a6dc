"""String-keyed plugin registry shared by the api and core layers.

A ``Registry`` is a thin, typed name → object mapping with a decorator
interface. The sampler/solver registries in ``repro_torch.api`` and the
kernel-ops backend registry in ``repro_torch.core.backends`` are all
instances; user code can register additional entries without touching the
library:

    from repro_torch.core.backends import BACKENDS

    @BACKENDS.register("my_backend")
    class MyOps(KernelOps): ...

Unknown names raise ``KeyError`` with the list of available entries, so a
typo in a ``SketchConfig`` fails loudly and early.
"""
from __future__ import annotations

from typing import Callable, Generic, Iterator, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    """Name → object mapping with ``register`` decorator and loud lookup."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict[str, T] = {}

    def register(self, name: str) -> Callable[[T], T]:
        """Decorator: ``@REG.register("name")``. Re-registration of an
        existing name raises (shadowing a builtin is almost always a bug —
        use a new name)."""
        def deco(obj: T) -> T:
            if name in self._entries:
                raise ValueError(
                    f"{self.kind} {name!r} is already registered")
            self._entries[name] = obj
            return obj
        return deco

    def get(self, name: str) -> T:
        """The entry registered under ``name``; unknown names raise
        ``KeyError`` listing every available entry."""
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(
                f"unknown {self.kind} {name!r}; available: "
                f"{sorted(self._entries)}") from None

    def available(self) -> tuple[str, ...]:
        """All registered names, sorted."""
        return tuple(sorted(self._entries))

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._entries))

    def __len__(self) -> int:
        return len(self._entries)
