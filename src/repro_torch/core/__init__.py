"""repro_torch.core — the Launchpad programming model (the paper's contribution).

Public API mirrors the paper:

    from repro_torch import core as lp

    p = lp.Program('ps')
    with p.group('server'):
        server = p.add_node(lp.CourierNode(ParamServer))
    with p.group('requester'):
        for _ in range(n):
            p.add_node(lp.CourierNode(Requester, server))
    lp.ThreadLauncher().launch(p, resources={...})
"""

from repro_torch.core import courier, telemetry
from repro_torch.core.addressing import Address, AddressTable
from repro_torch.core.discovery import Heartbeater, Registry, ReplicaInfo
from repro_torch.core.fault import (ALWAYS_RESTART, NO_RESTART, FaultEvent,
                              FaultInjector, NodeFailure, RestartPolicy,
                              hedged_map)
from repro_torch.core.handles import Handle, collect_handles, map_handles
from repro_torch.core.launchers import (DryRunLauncher, Launcher, ProcessLauncher,
                                  ProgramTestError, ThreadLauncher,
                                  launch_and_wait)
from repro_torch.core.nodes import (Cacher, CacherNode, ColocationNode, CourierHandle,
                              CourierNode, Executable, MeshWorkerNode, Node,
                              PyNode, ReverbNode, WorkerContext,
                              get_current_context, stop_program)
from repro_torch.core.program import Program
from repro_torch.core.resources import DEFAULT_GROUP, ResourceGroup
from repro_torch.core.telemetry import TelemetryHub, get_logger

__all__ = [
    "Program", "ResourceGroup", "DEFAULT_GROUP",
    "Node", "Executable", "Handle", "Address", "AddressTable",
    "PyNode", "CourierNode", "CourierHandle", "CacherNode", "Cacher",
    "ColocationNode", "MeshWorkerNode", "ReverbNode",
    "WorkerContext", "get_current_context", "stop_program",
    "collect_handles", "map_handles",
    "Launcher", "ThreadLauncher", "ProcessLauncher", "DryRunLauncher",
    "launch_and_wait", "ProgramTestError",
    "RestartPolicy", "NodeFailure", "NO_RESTART", "ALWAYS_RESTART", "hedged_map",
    "FaultEvent", "FaultInjector",
    "Registry", "Heartbeater", "ReplicaInfo",
    "TelemetryHub", "get_logger", "telemetry",
    "courier",
]
