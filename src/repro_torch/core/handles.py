"""Handles: references to yet-to-be-constructed services (paper §2, §4).

A :class:`Handle` is returned by ``Program.add_node`` and acts as a client
to the service that the node will become. Passing a handle into another
node's constructor creates a directed edge in the program graph. During
execution each handle is *dereferenced* into a service-specific client.
"""

from __future__ import annotations

import abc
from typing import Any

from repro_torch.core.addressing import Address


class Handle(abc.ABC):
    """Reference to a node; dereferences to a client at execution time."""

    def __init__(self, address: Address):
        self._address = address

    @property
    def address(self) -> Address:
        return self._address

    @abc.abstractmethod
    def dereference(self) -> Any:
        """Create the client object for this service (execution phase)."""

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._address!r})"


def map_handles(obj: Any, fn) -> Any:
    """Recursively walk (args/kwargs-style) containers applying ``fn`` to Handles.

    Used both at setup (edge discovery) and at execution (dereferencing the
    handles embedded in a node's constructor arguments).
    """
    if isinstance(obj, Handle):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        mapped = [map_handles(v, fn) for v in obj]
        if isinstance(obj, tuple):
            # NamedTuple subclasses construct from positional fields; a
            # plain tuple() here would erase the concrete type.
            return type(obj)(*mapped) if hasattr(obj, "_fields") \
                else tuple(mapped)
        return type(obj)(mapped)
    if isinstance(obj, dict):
        return {k: map_handles(v, fn) for k, v in obj.items()}
    return obj


def collect_handles(obj: Any) -> list[Handle]:
    found: list[Handle] = []

    def _visit(h: Handle) -> Handle:
        found.append(h)
        return h

    map_handles(obj, _visit)
    return found
