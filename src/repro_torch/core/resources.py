"""Resource groups (paper §2, §3.1, Listing 1).

Groups collect nodes with homogeneous requirements. Constraints are *not*
interpreted at setup — they're an opaque mapping handed to the launcher,
which applies platform-specific meaning at launch time. On our TPU-pod
adaptation the interesting resources are mesh shapes, e.g.::

    resources = {
        'learner':  {'mesh': (16, 16), 'axes': ('data', 'model')},
        'actors':   {'cpu': 2, 'ram_gb': 4},
    }
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class ResourceGroup:
    name: str
    # Nodes are appended by Program.add_node while the group context is open.
    nodes: list = dataclasses.field(default_factory=list)
    # Filled at launch from the user's resource mapping (Listing 1).
    requirements: Optional[dict[str, Any]] = None
    # Paper §3.1: nodes in one group must share a node type.
    node_type: Optional[type] = None

    def add(self, node) -> None:
        # Paper §3.1: "nodes added to the same resource group share a node
        # type" — this keeps the group's executables comparable. The default
        # group is exempt: it collects all *unassigned* nodes of any type.
        if self.name == DEFAULT_GROUP:
            self.nodes.append(node)
            return
        if self.node_type is None:
            self.node_type = type(node)
        elif type(node) is not self.node_type:
            raise TypeError(
                f"Resource group {self.name!r} holds nodes of type "
                f"{self.node_type.__name__}; cannot add {type(node).__name__}. "
                "Nodes in one group must share a node type (paper §3.1).")
        self.nodes.append(node)


DEFAULT_GROUP = "__default__"
