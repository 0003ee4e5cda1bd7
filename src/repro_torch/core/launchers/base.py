"""Launcher ABC (paper §3.2): program -> resources -> addresses -> executables.

A launcher is handed a Program plus an optional mapping from resource-group
names to platform-specific requirements (Listing 1). It

  1. validates the graph,
  2. attaches requirements to groups,
  3. performs *resource discovery* and assigns every address placeholder a
     physical endpoint (building the address table),
  4. calls ``node.to_executables()`` for each node, and
  5. hands the executables to the platform for execution, optionally
     monitoring them (with restart policies — paper §6's "the underlying
     job scheduling system has the ability to restart failing jobs").
"""

from __future__ import annotations

import abc
import logging
import threading
from typing import Any, Optional

from repro_torch.core.addressing import AddressTable
from repro_torch.core.fault import NodeFailure, RestartPolicy
from repro_torch.core.nodes.base import Executable, Node
from repro_torch.core.program import Program

logger = logging.getLogger(__name__)


class Launcher(abc.ABC):
    launch_type: str = "abstract"

    def __init__(self,
                 restart_policy: Optional[RestartPolicy] = None,
                 per_group_restart: Optional[dict[str, RestartPolicy]] = None):
        self._restart_policy = restart_policy or RestartPolicy()
        self._per_group_restart = per_group_restart or {}
        self.address_table = AddressTable()
        self.failures: list[NodeFailure] = []
        self._failures_lock = threading.Lock()

    # -- overridable per platform -------------------------------------------
    @abc.abstractmethod
    def _assign_address(self, node: Node, index: int) -> str:
        """Return a concrete endpoint for the node's index-th address."""

    @abc.abstractmethod
    def _execute(self, node: Node, group_name: str,
                 executables: list[Executable]) -> None:
        """Begin running a node's executables on the platform."""

    # -- the launch phase -----------------------------------------------------
    def launch(self, program: Program,
               resources: Optional[dict[str, dict[str, Any]]] = None) -> "Launcher":
        program.validate()
        resources = resources or {}
        unknown = set(resources) - set(program.groups)
        if unknown:
            raise ValueError(
                f"resources given for unknown groups: {sorted(unknown)}; "
                f"program has {sorted(program.groups)}")
        for gname, reqs in resources.items():
            program.groups[gname].requirements = dict(reqs)

        # Resource discovery + address assignment (before to_executables so
        # nodes can serialize resolved handles into their executables).
        for node in program.nodes:
            for i, addr in enumerate(node.addresses()):
                if not addr.is_resolved:
                    self.address_table.assign(addr, self._assign_address(node, i))

        for gname, group in program.groups.items():
            for node in group.nodes:
                executables = node.to_executables(
                    requirements=group.requirements,
                    launch_type=self.launch_type)
                self._execute(node, gname, executables)
        self._program = program
        return self

    # -- monitoring (paper §3.2 "the launcher can wait for or monitor ...") ---
    def record_failure(self, failure: NodeFailure) -> None:
        with self._failures_lock:
            self.failures.append(failure)
        logger.warning("node %s failed (restarts=%d, fatal=%s): %r",
                       failure.node_name, failure.restarts, failure.fatal,
                       failure.error)

    def policy_for(self, group_name: str) -> RestartPolicy:
        return self._per_group_restart.get(group_name, self._restart_policy)

    @abc.abstractmethod
    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the program terminates. True if it did."""

    @abc.abstractmethod
    def stop(self) -> None:
        """Request cooperative shutdown of every service."""
