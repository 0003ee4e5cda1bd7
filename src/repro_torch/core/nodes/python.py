"""PyNode and CourierNode (paper §4.1).

Both take a Python class plus constructor arguments and act as *deferred
constructors*: the class is not instantiated at setup (side effects must not
happen at graph-definition time); it is serialized with its args and
constructed at execution time, after any embedded handles are dereferenced.

``PyNode``     — no handle; cannot receive messages (pure execution /
                 communication-initiating services). Cost-saving variant.
``CourierNode`` — additionally starts a courier server exposing the public
                 methods of the constructed object; its handle dereferences
                 to an RPC client.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

from repro_torch.core import courier
from repro_torch.core.addressing import Address, parse_endpoint
from repro_torch.core.handles import Handle, collect_handles, map_handles
from repro_torch.core.nodes.base import Executable, Node, WorkerContext, set_current_context

logger = logging.getLogger(__name__)


class CourierHandle(Handle):
    """Dereferences to the unified CourierClient; the endpoint scheme picks
    the transport (inproc fast path vs. gRPC on a pooled channel)."""

    def dereference(self) -> Any:
        return courier.client_for(self.address.endpoint)


def _construct(cls, args, kwargs):
    """Dereference embedded handles, then build the service object."""
    args = map_handles(list(args), lambda h: h.dereference())
    kwargs = map_handles(dict(kwargs), lambda h: h.dereference())
    return cls(*args, **kwargs)


class _PyExecutable(Executable):
    """Runs construct() then the object's run() method (if any)."""

    def __init__(self, name: str, cls, args, kwargs):
        self.name = name
        self._cls, self._args, self._kwargs = cls, args, kwargs

    def run(self, context: WorkerContext) -> None:
        set_current_context(context)
        obj = _construct(self._cls, self._args, self._kwargs)
        run_fn = getattr(obj, "run", None)
        if callable(run_fn):
            run_fn()
        else:
            context.wait_for_stop()


class _CourierExecutable(Executable):
    """Start a courier server for the object, then run()/wait (paper §4.1)."""

    def __init__(self, name: str, cls, args, kwargs, address: Address):
        self.name = name
        self._cls, self._args, self._kwargs = cls, args, kwargs
        self._address = address

    def run(self, context: WorkerContext) -> None:
        # Endpoint goes into the context *before* construction so the
        # service's __init__ can advertise itself (discovery registration).
        context.endpoint = self._address.endpoint
        set_current_context(context)
        obj = _construct(self._cls, self._args, self._kwargs)
        endpoint = self._address.endpoint
        # A "+"-joined endpoint advertises several transports for the same
        # service (e.g. shm://name+grpc://host:port from ProcessLauncher):
        # serve all of them; clients pick the first viable scheme.
        parts = parse_endpoint(endpoint)
        server = None
        try:
            if parts.inproc is not None:
                courier.inprocess.register(parts.inproc, obj)
            if parts.grpc is not None:
                host, port = parts.grpc.rsplit(":", 1)
                # handler_init: RPC handler threads get this node's context,
                # so service methods can call lp.stop_program() remotely.
                server = courier.CourierServer(
                    obj, port=int(port), host=host, shm_name=parts.shm,
                    handler_init=lambda: set_current_context(context))
                server.start()
            elif parts.shm is not None:
                raise ValueError(
                    f"shm endpoint {endpoint!r} needs a grpc:// fallback "
                    "component (launchers always emit dual endpoints)")

            run_fn = getattr(obj, "run", None)
            if callable(run_fn):
                run_fn()
            else:
                context.wait_for_stop()
        finally:
            if parts.inproc is not None:
                courier.inprocess.unregister(parts.inproc)
            if server is not None:
                server.stop()


class PyNode(Node):
    def __init__(self, cls, *args, **kwargs):
        name = getattr(cls, "__name__", "PyNode")
        super().__init__(name=name)
        self._cls, self._args, self._kwargs = cls, args, kwargs
        self.input_handles = collect_handles((args, kwargs))

    def create_handle(self) -> Optional[Handle]:
        return None  # PyNodes cannot receive messages.

    def to_executables(self, requirements=None, launch_type="thread"):
        return [_PyExecutable(self.name, self._cls, self._args, self._kwargs)]


class CourierNode(Node):
    def __init__(self, cls, *args, **kwargs):
        name = getattr(cls, "__name__", "CourierNode")
        super().__init__(name=name)
        self._cls, self._args, self._kwargs = cls, args, kwargs
        self.input_handles = collect_handles((args, kwargs))
        self._address = Address(name)

    def addresses(self):
        return (self._address,)

    def create_handle(self) -> Handle:
        h = CourierHandle(self._address)
        self._created_handles.append(h)
        return h

    def to_executables(self, requirements=None, launch_type="thread"):
        return [_CourierExecutable(self.name, self._cls, self._args,
                                   self._kwargs, self._address)]
