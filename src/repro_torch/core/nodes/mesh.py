"""MeshWorkerNode: a device worker as a Launchpad service.

The Launchpad graph is the *control plane*; inside a MeshWorkerNode the
*data plane* is PyTorch computation on a device, or over a device mesh.
The node behaves like a CourierNode (deferred constructor, courier
handle). When the resource group's requirements carry a mesh geometry,
the wrapped class receives ``mesh=<DeviceMesh>`` as a keyword argument::

    with p.group('learner'):
        learner = p.add_node(MeshWorkerNode(Learner, replay, ckpt_dir))
    launcher.launch(p, resources={
        'learner': {'mesh': (2, 2), 'axes': ('data', 'model')}})

Otherwise it receives ``device=<torch.device>``, taken from the
requirements' ``device``, else from the node's own ``device=`` argument,
else ``"cuda"``::

    launcher.launch(p, resources={'learner': {'device': 'cuda:1'}})

The mesh's device type follows the same choice ("cuda": nccl, a card a
rank; "cpu": gloo). A torch mesh spans one process per device. A mesh of
one device starts a group of one in the node's process. A larger mesh
keeps the JAX package's single controller: the node's process is rank 0
and starts D·M-1 follower processes (``sharding.group.MeshGroup``), and
every rank holds its own copy of the object, built from the same
arguments on its part of the mesh:

* handles among those arguments reach rank 0 only; a follower's copy
  gets a stub in their place that raises, naming the service, on use
  (a follower cannot reach an ``inproc://`` service, and under the
  thread launcher every service is one);
* every courier call to the object is first sent to every follower,
  under ``sharding.group.MESH_LOCK``, then run on rank 0, so every rank
  runs the same collectives in the same order. Concurrent calls from
  the courier handler pool therefore run one after another: the price
  of one controller over a runtime that wants many. Rank 0's result is
  the caller's; a failure on rank 0 fails the group, whose followers are
  then killed;
* the node serves from its start: a call that comes while the followers
  start and the object is built waits for it (starting interpreters can
  take longer than a client's wait for a service to come up);
* ``run()``, if the class has one, runs on rank 0 only; its work with
  collectives reaches the ranks through ``on_ranks`` (the same mechanism
  as a courier call);
* the class is sent to the followers by reference, so it must be
  defined at module level in a file (``sharding.group.reference``;
  under ``python -c`` or inside a function it is refused);
* a mesh needs as many devices as ranks, checked before any follower
  starts: cards on "cuda", cores on "cpu";
* when the node ends the group closes (the followers exit and are
  reaped), and a follower that dies ends the node with an error naming
  its rank.

Unlike the JAX package, where each node builds its mesh from the
process's devices, a torch process has one default process group: the
multi-rank nodes of one process share one group and its lock, so their
mesh shape, axes and device type must be equal (another raises before
any follower starts).
"""

from __future__ import annotations

import math
import os
import sys
import threading
from typing import Any, Optional

from repro_torch.core.addressing import Address, parse_endpoint
from repro_torch.core.handles import Handle, collect_handles, map_handles
from repro_torch.core.nodes.base import Executable, Node, WorkerContext, set_current_context
from repro_torch.core.nodes.python import CourierHandle, _construct

# How often a multi-rank node without ``run()`` looks at its followers.
CHECK_S = 0.1

# Rank 0's objects that a group replays: id -> (object, group, name,
# incarnation); ``release`` forgets one.
_served: dict[int, tuple] = {}
# The process's one multi-rank group: key (shape, axes, device type),
# the MeshGroup and the number of nodes on it.
_shared: dict[str, Any] = {}
_shared_lock = threading.Lock()


class _FollowerHandle:
    """A handle's place in a follower's copy of the arguments: only rank
    0 reaches the program's services."""

    def __init__(self, service: str):
        self._service = service

    def __getattr__(self, attr):
        if attr.startswith("_"):
            raise AttributeError(attr)
        raise RuntimeError(
            f"service {self._service!r} is reachable from rank 0 of a mesh "
            f"node only, not from a follower rank (used: .{attr})")

    def __repr__(self) -> str:
        return f"_FollowerHandle({self._service!r})"


class _Replayed:
    """What a multi-rank node serves: each public method of rank 0's
    object, run on every rank (``MeshGroup.on_ranks``). The node serves
    it from its start: a call that comes while the followers start and
    the object is built waits for it (or for the error that ended it)."""

    def __init__(self):
        self._ready = threading.Event()
        self._entry: Optional[tuple] = None   # (obj, group, name, inc.)
        self._error: Optional[BaseException] = None

    def _set(self, entry=None, error=None) -> None:
        self._entry, self._error = entry, error
        self._ready.set()

    def __getattr__(self, attr):
        if attr.startswith("_"):
            raise AttributeError(attr)
        self._ready.wait()
        if self._entry is None:
            raise RuntimeError("the mesh node's object was not built: "
                               f"{self._error!r}")
        obj, group, name, incarnation = self._entry
        value = getattr(obj, attr)
        if not callable(value):
            return value

        def replayed(*args, **kwargs):
            return group.on_ranks(name, incarnation, obj, attr, args, kwargs)
        return replayed


def control(group, name: str, cls, args=(), kwargs=None, served=None):
    """Build ``cls(*args, mesh=group.mesh, **kwargs)`` on every rank of
    ``group`` (a ``sharding.group.MeshGroup``) as object ``name``: first
    on the followers, with each handle among the arguments replaced by a
    stub, then here, with the handles dereferenced. Returns (rank 0's
    object, the proxy that runs each of its public methods on every
    rank: ``served`` if given); ``release`` ends it."""
    from repro_torch.sharding.group import MESH_LOCK
    kwargs = dict(kwargs or {})

    def stub(h: Handle):
        return _FollowerHandle(h.address.name)

    with MESH_LOCK:
        incarnation = group.construct(
            name, cls, map_handles(list(args), stub),
            map_handles(kwargs, stub))
        try:
            obj = _construct(cls, args, dict(kwargs, mesh=group.mesh))
        except BaseException as exc:
            group.fail(f"{name}: construction failed on rank 0: {exc!r}")
            raise
    _served[id(obj)] = entry = (obj, group, name, incarnation)
    served = served if served is not None else _Replayed()
    served._set(entry)
    return obj, served


def release(obj) -> None:
    """Drop ``obj``'s copies on the followers (after the call in flight)
    and forget it: ``on_ranks`` calls it here only from now on."""
    from repro_torch.sharding.group import MESH_LOCK
    entry = _served.pop(id(obj), None)
    if entry is not None:
        _, group, name, incarnation = entry
        with MESH_LOCK:
            group.drop(name, incarnation)


def on_ranks(obj, method: str, *args, **kwargs):
    """``obj.method(*args, **kwargs)`` on every rank of the multi-rank
    mesh node that serves ``obj``, as a courier call to it runs; rank 0's
    result. For work with collectives inside the wrapped class's
    ``run()``, which runs on rank 0 only. For any other object (a
    follower's copy, one a node of one rank serves) it calls the method
    here."""
    entry = _served.get(id(obj))
    if entry is None:
        return getattr(obj, method)(*args, **kwargs)
    _, group, name, incarnation = entry
    return group.on_ranks(name, incarnation, obj, method, args, kwargs)


def current_group():
    """The ``MeshGroup`` this process's multi-rank mesh nodes run on (its
    ``pids`` are the followers'), or ``None``."""
    with _shared_lock:
        return _shared.get("group")


def _check_devices(shape: tuple, device_type: str) -> None:
    """A rank a card on "cuda", a rank a core on "cpu"."""
    n_need = math.prod(shape)
    if device_type == "cuda":
        import torch
        n_have, what = torch.cuda.device_count(), "CUDA cards"
    else:
        n_have, what = os.cpu_count() or 1, "CPU cores"
    if n_have < n_need:
        raise RuntimeError(
            f"mesh {shape} needs {n_need} devices, the host has {n_have} "
            f"{what} (one rank each): shrink the mesh resource")


def _join_group(shape: tuple, axes: tuple, device: str):
    """The process's multi-rank group for this mesh, started by the
    first node that asks for it (``_check_devices`` first)."""
    import torch
    import torch.distributed as dist
    from repro_torch.sharding.group import MeshGroup
    key = (shape, axes, torch.device(device).type)
    with _shared_lock:
        if _shared:
            if _shared["key"] != key:
                raise RuntimeError(
                    f"mesh {key} differs from {_shared['key']}, which a "
                    "mesh node of this process already runs: a torch "
                    "process has one default process group, so its "
                    "multi-rank mesh nodes share one mesh")
            _shared["users"] += 1
            return _shared["group"]
        if dist.is_initialized():
            raise RuntimeError(
                "a process group is already running in this process: a "
                "multi-rank mesh node starts its own")
        group = MeshGroup(shape, axes, device)
        _shared.update(key=key, group=group, users=1)
        return group


def _leave_group(group) -> None:
    with _shared_lock:
        _shared["users"] -= 1
        if _shared["users"]:
            return
        _shared.clear()
    group.close()


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
        endpoint = self._address.endpoint
        group = None
        multi = self._mesh is not None and math.prod(self._mesh[0]) > 1
        if multi:
            import torch
            from repro_torch.sharding.group import reference
            # Refused before any follower starts.
            _check_devices(self._mesh[0], torch.device(self._device).type)
            reference(self._cls)
            obj, served = None, _Replayed()
        else:
            obj = served = _construct(self._cls, self._args,
                                      dict(self._kwargs, **self._placement()))
        # Dual endpoints (shm://name+grpc://host:port from ProcessLauncher)
        # serve every advertised scheme, same as _CourierExecutable.
        parts = parse_endpoint(endpoint)
        server = None
        try:
            if parts.inproc is not None:
                courier.inprocess.register(parts.inproc, served)
            if parts.grpc is not None:
                host, port = parts.grpc.rsplit(":", 1)
                server = courier.CourierServer(
                    served, port=int(port), host=host, shm_name=parts.shm,
                    handler_init=lambda: set_current_context(context))
                server.start()
            elif parts.shm is not None:
                raise ValueError(
                    f"shm endpoint {endpoint!r} needs a grpc:// fallback "
                    "component (launchers always emit dual endpoints)")
            if multi:
                group = _join_group(*self._mesh, self._device)
                obj, _ = control(group, f"{self.name}@{endpoint}",
                                 self._cls, self._args, self._kwargs, served)
            run_fn = getattr(obj, "run", None)
            if callable(run_fn):
                run_fn()
            elif group is None:
                context.wait_for_stop()
            else:
                while not context.wait_for_stop(CHECK_S):
                    group.check()
        finally:
            if multi and not served._ready.is_set():
                # Release the calls that wait for the object.
                served._set(error=sys.exc_info()[1]
                            or RuntimeError("the node stopped"))
            if parts.inproc is not None:
                courier.inprocess.unregister(parts.inproc)
            if server is not None:
                server.stop()
            if group is not None:
                if obj is not None:
                    release(obj)
                _leave_group(group)


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
