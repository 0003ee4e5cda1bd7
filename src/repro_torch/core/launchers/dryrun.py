"""DryRunLauncher: full launch-phase processing without execution.

Validates the graph, assigns (fake but unique) addresses, materializes all
executables, and reports the topology. This is the control-plane analogue
of ``jit(...).lower().compile()`` for the data plane: it proves the program
datastructure is coherent (all handles owned, addresses resolvable, nodes
materializable) before any resources are spent.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.launchers.base import Launcher
from repro_torch.core.nodes.base import Executable, Node


@dataclasses.dataclass
class DryRunReport:
    nodes: list[str]
    groups: dict[str, list[str]]
    executables: dict[str, int]          # node name -> count
    edges: list[tuple[str, str]]         # (consumer, producer)
    addresses: dict[str, str]            # address name/uid -> endpoint

    def summary(self) -> str:
        lines = [f"dry-run: {len(self.nodes)} nodes, "
                 f"{sum(self.executables.values())} executables, "
                 f"{len(self.edges)} edges"]
        for g, members in self.groups.items():
            lines.append(f"  group {g}: {len(members)} node(s)")
        for consumer, producer in self.edges:
            lines.append(f"  {consumer} -> {producer}")
        return "\n".join(lines)


class DryRunLauncher(Launcher):
    launch_type = "dryrun"

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._executables: dict[str, list[Executable]] = {}
        self._groups: dict[str, list[str]] = {}

    def _assign_address(self, node: Node, index: int) -> str:
        # Unique, never-connected endpoints: dereference would fail loudly.
        return f"grpc://dryrun.invalid:{10000 + len(self.address_table)}"

    def _execute(self, node, group_name, executables) -> None:
        self._executables[node.name] = executables
        self._groups.setdefault(group_name, []).append(node.name)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return True

    def stop(self) -> None:
        pass

    def report(self) -> DryRunReport:
        program = self._program
        return DryRunReport(
            nodes=[n.name for n in program.nodes],
            groups=self._groups,
            executables={k: len(v) for k, v in self._executables.items()},
            edges=[(c.name, p.name) for c, p in program.edges()],
            addresses={f"{a}": e for a, e in self.address_table.items()},
        )
