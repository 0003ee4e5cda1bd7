"""ReverbNode: a replay/data service node (paper §4.2).

Wraps :class:`repro_torch.data.replay.ReplayServer` — our reverb-lite — behind a
courier endpoint. "Particularly useful in reinforcement learning settings
where the dataset can itself be filled in an online fashion by data
generating processes."
"""

from __future__ import annotations

from repro_torch.core.addressing import Address
from repro_torch.core.handles import Handle
from repro_torch.core.nodes.base import Node
from repro_torch.core.nodes.python import CourierHandle, _CourierExecutable
from repro_torch.data.replay import ReplayServer, TableConfig


class ReverbNode(Node):
    def __init__(self, tables: list[TableConfig]):
        super().__init__(name="Reverb")
        self._tables = tables
        self._address = Address("reverb")

    def addresses(self):
        return (self._address,)

    def create_handle(self) -> Handle:
        h = CourierHandle(self._address)
        self._created_handles.append(h)
        return h

    def to_executables(self, requirements=None, launch_type="thread"):
        return [_CourierExecutable(self.name, ReplayServer, (self._tables,),
                                   {}, self._address)]
