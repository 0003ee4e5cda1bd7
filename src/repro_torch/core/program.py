"""The Launchpad Program: a directed graph of service nodes (paper §2, §3.1).

Setup-phase API::

    p = Program('producer-consumer')
    with p.group('producer'):
        h1 = p.add_node(CourierNode(Range, 0, 10))
        h2 = p.add_node(CourierNode(Range, 10, 20))
    with p.group('consumer'):
        p.add_node(CourierNode(Consumer, [h1, h2]))

Edges are created implicitly when one node's handle is passed to another
node's constructor; the edge originates at the *receiving* node (the one
initiating communication).
"""

from __future__ import annotations

import contextlib
from typing import Optional

from repro_torch.core.handles import Handle
from repro_torch.core.nodes.base import Node
from repro_torch.core.resources import DEFAULT_GROUP, ResourceGroup


class Program:
    def __init__(self, name: str):
        self.name = name
        self.groups: dict[str, ResourceGroup] = {}
        self._current_group: Optional[str] = None
        # Graph bookkeeping: node -> handle (or None), and handle -> owner node.
        self.nodes: list[Node] = []
        self._handle_owner: dict[int, Node] = {}  # id(handle) -> node

    # ---- resource groups ---------------------------------------------------
    @contextlib.contextmanager
    def group(self, name: str):
        """Context manager assigning added nodes to a resource group."""
        if name == DEFAULT_GROUP:
            raise ValueError(f"{DEFAULT_GROUP!r} is reserved")
        if self._current_group is not None:
            raise RuntimeError("Resource groups cannot be nested")
        self._current_group = name
        try:
            yield
        finally:
            self._current_group = None

    def _group_for(self, name: str) -> ResourceGroup:
        if name not in self.groups:
            self.groups[name] = ResourceGroup(name)
        return self.groups[name]

    # ---- graph construction --------------------------------------------------
    def add_node(self, node: Node, label: Optional[str] = None) -> Optional[Handle]:
        """Add a node to the graph; returns a handle referencing it (or None)."""
        if node in self.nodes:
            raise ValueError(f"Node {node.name!r} was already added")
        group_name = self._current_group or DEFAULT_GROUP
        group = self._group_for(group_name)
        group.add(node)
        if label:
            node.name = label
        # Disambiguate node names within the program (useful for addresses).
        node.name = f"{group_name}/{node.name}_{len(self.nodes)}"
        self.nodes.append(node)

        handle = node.create_handle()
        if handle is not None:
            self._handle_owner[id(handle)] = node
        # Adopt handles minted before add_node (e.g. handles of nodes
        # wrapped in a ColocationNode, created to wire them to each other).
        for h in getattr(node, "_created_handles", ()):
            self._handle_owner.setdefault(id(h), node)
        return handle

    # ---- introspection -------------------------------------------------------
    def edges(self) -> list[tuple[Node, Node]]:
        """(consumer, producer) pairs — the consumer initiates communication."""
        out = []
        for node in self.nodes:
            for h in node.input_handles:
                owner = self._handle_owner.get(id(h))
                if owner is not None:
                    out.append((node, owner))
        return out

    def owner_of(self, handle: Handle) -> Optional[Node]:
        return self._handle_owner.get(id(handle))

    def validate(self) -> None:
        """Structural checks run by launchers before anything starts."""
        names = [n.name for n in self.nodes]
        if len(set(names)) != len(names):
            raise ValueError(f"Duplicate node names in program: {names}")
        for node in self.nodes:
            for h in node.input_handles:
                if id(h) not in self._handle_owner:
                    raise ValueError(
                        f"Node {node.name!r} consumes a handle that does not "
                        "belong to any node in this program")

    def __repr__(self) -> str:
        lines = [f"Program({self.name!r})"]
        for gname, group in self.groups.items():
            lines.append(f"  group {gname}:")
            for node in group.nodes:
                deps = [self._handle_owner[id(h)].name
                        for h in node.input_handles
                        if id(h) in self._handle_owner]
                suffix = f" <- {deps}" if deps else ""
                lines.append(f"    {node.name} [{type(node).__name__}]{suffix}")
        return "\n".join(lines)
