"""The training program's mesh group, under its first name.

``launch.train --mesh D,M`` drives its follower processes through the
generic group in ``repro_torch.sharding.group``, the one command
protocol that ``MeshWorkerNode`` uses too; this module re-exports it.
"""

from repro_torch.sharding.group import (GROUP_TIMEOUT_S, MESH_LOCK,
                                        REAP_TIMEOUT_S, Command, MeshGroup)

__all__ = ["GROUP_TIMEOUT_S", "MESH_LOCK", "REAP_TIMEOUT_S", "Command",
           "MeshGroup"]
