"""Node and Executable protocols (paper §2, §4).

A *node* is a datastructure describing computation that **will** run — a
factory for the service. A node may materialize into one or more
*executables* (a service can be several processes). Decoupling declaration
from implementation lets the same program run under different launchers.
"""

from __future__ import annotations

import abc
import threading
from typing import Any, Callable, Optional, Sequence

from repro_torch.core.addressing import Address
from repro_torch.core.handles import Handle


class WorkerContext:
    """Execution-phase context handed to every executable.

    Gives services cooperative shutdown (``should_stop`` /
    ``wait_for_stop``) and the ability to terminate the whole program
    (``stop_program`` — like ``lp.stop()``).
    """

    def __init__(self,
                 node_name: str = "worker",
                 stop_event: Optional[threading.Event] = None,
                 stop_program_fn: Optional[Callable[[], None]] = None):
        self.node_name = node_name
        self.stop_event = stop_event if stop_event is not None else threading.Event()
        self._stop_program_fn = stop_program_fn
        # The node's own resolved serving endpoint (set by courier-serving
        # executables before the service object is constructed). This is
        # how a service can *advertise itself* — e.g. register with a
        # discovery Registry — without the program author threading the
        # address through every constructor. None for non-courier nodes.
        self.endpoint: Optional[str] = None

    @property
    def should_stop(self) -> bool:
        return self.stop_event.is_set()

    def wait_for_stop(self, timeout: Optional[float] = None) -> bool:
        return self.stop_event.wait(timeout)

    def stop_program(self) -> None:
        """Request termination of the entire distributed program."""
        self.stop_event.set()
        if self._stop_program_fn is not None:
            self._stop_program_fn()


# Thread-local so library code (e.g. a service method) can reach its context
# without threading it through every call.
_context_local = threading.local()


def set_current_context(ctx: WorkerContext) -> None:
    _context_local.ctx = ctx


def get_current_context() -> WorkerContext:
    ctx = getattr(_context_local, "ctx", None)
    if ctx is None:
        # Outside any launcher (e.g. unit tests poking a service directly):
        # hand back a standalone context rather than failing.
        ctx = WorkerContext(node_name="standalone")
        _context_local.ctx = ctx
    return ctx


def stop_program() -> None:
    """Module-level convenience mirroring ``lp.stop()``."""
    get_current_context().stop_program()


class Executable(abc.ABC):
    """A materialized unit of computation produced by a node at launch."""

    name: str = "executable"

    @abc.abstractmethod
    def run(self, context: WorkerContext) -> None:
        """Execute the service. Returns when the service is done/stopped."""


class Node(abc.ABC):
    """User-facing description of a service (the factory, not the service)."""

    def __init__(self, name: str = ""):
        self.name = name or type(self).__name__
        self._created_handles: list[Handle] = []
        # Edges: handles (to *other* nodes) this node consumes. Populated by
        # Program.add_node via collect_handles over the constructor args.
        self.input_handles: list[Handle] = []

    # ---- setup phase ------------------------------------------------------
    def create_handle(self) -> Optional[Handle]:
        """Create a handle referencing this node. None => PyNode-style."""
        return None

    def addresses(self) -> Sequence[Address]:
        """Address placeholders this node's services bind to."""
        return ()

    # ---- launch phase -----------------------------------------------------
    @abc.abstractmethod
    def to_executables(self, requirements: Optional[dict[str, Any]] = None,
                       launch_type: str = "thread") -> list[Executable]:
        """Materialize the service. Addresses are resolved by this point."""
