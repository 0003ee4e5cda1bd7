"""MeshWorkerNode: a device worker as a Launchpad service.

The Launchpad graph is the *control plane*; inside a MeshWorkerNode the
*data plane* is PyTorch computation on one device. The node behaves like a
CourierNode (deferred constructor, courier handle), and the wrapped class
receives ``device=<torch.device>`` as a keyword argument, taken from the
resource group's requirements, else from the node's own ``device=``
argument, else ``"cuda"``::

    with p.group('learner'):
        learner = p.add_node(MeshWorkerNode(Learner, replay, ckpt_dir))
    launcher.launch(p, resources={'learner': {'device': 'cuda:1'}})

The name is kept from the JAX package, whose node builds a device mesh
here; a multi-device (sharded) worker is later work.
"""

from __future__ import annotations

from typing import Any, Optional

from repro_torch.core.addressing import Address, parse_endpoint
from repro_torch.core.handles import Handle, collect_handles
from repro_torch.core.nodes.base import Executable, Node, WorkerContext, set_current_context
from repro_torch.core.nodes.python import CourierHandle, _construct


class _MeshExecutable(Executable):
    def __init__(self, name: str, cls, args, kwargs, address: Address,
                 device: str):
        self.name = name
        self._cls, self._args, self._kwargs = cls, args, kwargs
        self._address = address
        self._device = device

    def run(self, context: WorkerContext) -> None:
        import torch

        from repro_torch.core import courier
        context.endpoint = self._address.endpoint
        set_current_context(context)
        obj = _construct(self._cls, self._args,
                         dict(self._kwargs, device=torch.device(self._device)))
        endpoint = self._address.endpoint
        # Dual endpoints (shm://name+grpc://host:port from ProcessLauncher)
        # serve every advertised scheme, same as _CourierExecutable.
        parts = parse_endpoint(endpoint)
        server = None
        try:
            if parts.inproc is not None:
                courier.inprocess.register(parts.inproc, obj)
            if parts.grpc is not None:
                host, port = parts.grpc.rsplit(":", 1)
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


class MeshWorkerNode(Node):
    """A CourierNode whose service runs on one torch device."""

    DEFAULT_DEVICE = "cuda"

    def __init__(self, cls, *args, **kwargs):
        name = getattr(cls, "__name__", "MeshWorker")
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

    def to_executables(self, requirements: Optional[dict[str, Any]] = None,
                       launch_type: str = "thread"):
        reqs = requirements or {}
        device = str(reqs.get("device",
                              self._kwargs.get("device", self.DEFAULT_DEVICE)))
        kwargs = {k: v for k, v in self._kwargs.items() if k != "device"}
        return [_MeshExecutable(self.name, self._cls, self._args, kwargs,
                                self._address, device)]
