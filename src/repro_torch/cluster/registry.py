"""String-keyed backend registries for the pluggable estimator (a copy
of ``repro/cluster/registry.py``).

Each pipeline phase (affinity, eigensolver, assigner) owns one
:class:`Registry`; backends self-register at import time with the
``@REGISTRY.register("name")`` decorator, and user code selects them by
string — no ``if/elif`` ladders in the pipeline, and downstream projects can
plug in their own backends without touching this package:

    from repro_torch.cluster import AFFINITIES

    @AFFINITIES.register("my-kernel")
    def my_affinity(est, x, sigma):
        ...
"""
from __future__ import annotations

from typing import Callable, Iterator


class Registry:
    """A named string -> callable map with self-describing error messages."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict[str, Callable] = {}

    def register(self, name: str) -> Callable[[Callable], Callable]:
        def deco(fn: Callable) -> Callable:
            if name in self._entries:
                raise ValueError(
                    f"{self.kind} backend {name!r} is already registered")
            self._entries[name] = fn
            return fn
        return deco

    def get(self, name: str) -> Callable:
        try:
            return self._entries[name]
        except KeyError:
            raise ValueError(
                f"unknown {self.kind} backend {name!r}; "
                f"registered backends: {sorted(self._entries)}") from None

    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self._entries))

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self.names())
