from repro_torch.core.nodes.base import (Executable, Node, WorkerContext,
                                   get_current_context, stop_program)
from repro_torch.core.nodes.cacher import Cacher, CacherNode
from repro_torch.core.nodes.colocation import ColocationNode
from repro_torch.core.nodes.mesh import MeshWorkerNode
from repro_torch.core.nodes.python import CourierHandle, CourierNode, PyNode
from repro_torch.core.nodes.reverb import ReverbNode

__all__ = [
    "Node", "Executable", "WorkerContext", "get_current_context",
    "stop_program", "PyNode", "CourierNode", "CourierHandle",
    "CacherNode", "Cacher", "ColocationNode", "MeshWorkerNode", "ReverbNode",
]
