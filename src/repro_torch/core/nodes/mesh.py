"""MeshWorkerNode: a device worker as a Launchpad service.

The Launchpad graph is the *control plane*; inside a MeshWorkerNode the
*data plane* is PyTorch computation on a device, or over a device mesh.
The node behaves like a CourierNode (deferred constructor, courier
handle). When the resource group's requirements carry a mesh geometry,
the wrapped class receives ``mesh=<DeviceMesh>`` as a keyword argument::

    with p.group('learner'):
        learner = p.add_node(MeshWorkerNode(Learner, replay, ckpt_dir))
    launcher.launch(p, resources={
        'learner': {'mesh': (1, 1), 'axes': ('data', 'model')}})

Otherwise it receives ``device=<torch.device>``, taken from the
requirements' ``device``, else from the node's own ``device=`` argument,
else ``"cuda"``::

    launcher.launch(p, resources={'learner': {'device': 'cuda:1'}})

The mesh's device type follows the same choice ("cuda": nccl, "cpu":
gloo). A torch mesh spans one process per device in one process group:
a mesh of one device starts its own group, a larger one needs its
processes' group first, and a mesh larger than the group raises.
"""

from __future__ import annotations

from typing import Any, Optional

from repro_torch.core.addressing import Address, parse_endpoint
from repro_torch.core.handles import Handle, collect_handles
from repro_torch.core.nodes.base import Executable, Node, WorkerContext, set_current_context
from repro_torch.core.nodes.python import CourierHandle, _construct


class _MeshExecutable(Executable):
    def __init__(self, name: str, cls, args, kwargs, address: Address,
                 device: str, mesh=None):
        self.name = name
        self._cls, self._args, self._kwargs = cls, args, kwargs
        self._address = address
        self._device = device
        self._mesh = mesh                # (shape, axes) or None

    def _placement(self) -> dict:
        import torch
        if self._mesh is None:
            return {"device": torch.device(self._device)}
        from repro_torch.sharding.compat import make_mesh
        shape, axes = self._mesh
        return {"mesh": make_mesh(shape, axes,
                                  torch.device(self._device).type)}

    def run(self, context: WorkerContext) -> None:
        from repro_torch.core import courier
        context.endpoint = self._address.endpoint
        set_current_context(context)
        obj = _construct(self._cls, self._args,
                         dict(self._kwargs, **self._placement()))
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
    """A CourierNode whose service runs on a torch device or mesh."""

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
        mesh = None
        if "mesh" in reqs:
            shape = tuple(reqs["mesh"])
            axes = tuple(reqs.get("axes", ("data", "model")[:len(shape)]))
            if len(shape) != len(axes):
                raise ValueError(f"mesh shape {shape} / axes {axes} mismatch")
            mesh = (shape, axes)
        return [_MeshExecutable(self.name, self._cls, self._args, kwargs,
                                self._address, device, mesh)]
