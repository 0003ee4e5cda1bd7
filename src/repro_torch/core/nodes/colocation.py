"""ColocationNode: force a set of nodes onto one machine (paper §4.2).

At execution time the wrapped nodes' executables run as threads of a single
executable, so their mutual communication resolves to the in-process
(shared-memory) channel. This gives the program designer node-by-node
control over locality and communication cost.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from repro_torch.core.nodes.base import Executable, Node, WorkerContext


class _ColocatedExecutable(Executable):
    def __init__(self, name: str, inner: list[Executable]):
        self.name = name
        self._inner = inner

    def run(self, context: WorkerContext) -> None:
        errors: list[BaseException] = []
        threads = []

        def _run_one(ex: Executable):
            try:
                ex.run(context)
            except BaseException as exc:  # noqa: BLE001
                errors.append(exc)
                context.stop_program()

        for ex in self._inner:
            t = threading.Thread(target=_run_one, args=(ex,),
                                 name=f"{self.name}/{ex.name}", daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
        if errors:
            raise errors[0]


class ColocationNode(Node):
    """Wraps nodes so their executables share one machine/process."""

    def __init__(self, *nodes: Node, name: str = "Colocation"):
        super().__init__(name=name)
        self._nodes = list(nodes)
        for n in self._nodes:
            # Handles consumed by the wrapped nodes from OUTSIDE this
            # colocation are our inputs; handles minted by wrapped nodes are
            # adopted so the program can resolve edges pointing at them.
            own = {id(h) for m in self._nodes
                   for h in getattr(m, "_created_handles", ())}
            self.input_handles.extend(
                h for h in n.input_handles if id(h) not in own)
            self._created_handles.extend(
                getattr(n, "_created_handles", ()))

    @property
    def wrapped(self) -> list[Node]:
        return self._nodes

    def addresses(self):
        out = []
        for n in self._nodes:
            out.extend(n.addresses())
        return tuple(out)

    def create_handle(self):
        return None  # use the wrapped nodes' own handles

    def to_executables(self, requirements=None, launch_type="thread"):
        inner: list[Executable] = []
        for n in self._nodes:
            inner.extend(n.to_executables(requirements, launch_type="thread"))
        return [_ColocatedExecutable(self.name, inner)]
