"""Address placeholders and the launch-phase address table.

Paper §3.1/§3.2: during *setup*, nodes create :class:`Address` placeholders
and attach them to their handles — physical endpoints are platform specific
and unknown until launch. During *launch*, the launcher walks the program,
assigns each placeholder a concrete endpoint, and records the mapping in an
:class:`AddressTable`. Handles are serialized *after* resolution, so a
deserialized handle on a remote worker carries its resolved endpoint.

Endpoint schemes (see ``courier/README.md`` for the full table):

    inproc://<name>          same-process registry (thread launcher /
                             colocation)
    shm://<name>             shared-memory ring pair, same-host processes
    grpc://host:port         courier-over-gRPC (works anywhere)

An endpoint string may join several candidate URIs with ``+``, preferred
first — ``ProcessLauncher`` emits ``shm://<name>+grpc://127.0.0.1:<port>``
so same-host clients take the ring and everything else (including clients
facing a stale rendezvous left by a crashed server) falls back to gRPC.
Ports in ``grpc://`` endpoints emitted by the built-in launchers are held
by a live ``PortReservation`` socket from assignment until the server
binds, so the table never advertises a port another process can steal.
"""

from __future__ import annotations

import itertools
import threading
from typing import NamedTuple, Optional


class EndpointParts(NamedTuple):
    """A resolved endpoint split into its per-scheme components.

    Any field is ``None`` when the endpoint does not carry that scheme;
    ``grpc`` is the bare ``host:port`` with the prefix stripped.
    """

    inproc: Optional[str]
    shm: Optional[str]
    grpc: Optional[str]


def parse_endpoint(endpoint: str) -> EndpointParts:
    """Split a (possibly ``+``-joined) endpoint into scheme components.

    Server-side executables use this to serve every advertised scheme;
    raises ``ValueError`` on an unknown scheme so typos fail at launch,
    not as a mysterious connect hang.
    """
    inproc = shm = grpc = None
    for part in endpoint.split("+"):
        if part.startswith("inproc://"):
            inproc = part[len("inproc://"):]
        elif part.startswith("shm://"):
            shm = part[len("shm://"):]
        elif part.startswith("grpc://"):
            grpc = part[len("grpc://"):]
        else:
            raise ValueError(f"unknown endpoint scheme {part!r}")
    return EndpointParts(inproc, shm, grpc)

_uid = itertools.count()
_uid_lock = threading.Lock()


def _next_uid() -> int:
    with _uid_lock:
        return next(_uid)


class Address:
    """A placeholder for a service endpoint, resolved at launch time.

    ``endpoint`` is a URI-style string once resolved, e.g.::

        inproc://<name>      same-process registry (thread launcher / colocation)
        grpc://host:port     courier-over-gRPC (process / cluster launchers)
    """

    __slots__ = ("uid", "name", "_endpoint")

    def __init__(self, name: str = ""):
        self.uid = _next_uid()
        self.name = name
        self._endpoint: Optional[str] = None

    # -- launch phase -------------------------------------------------------
    def resolve(self, endpoint: str) -> None:
        if self._endpoint is not None and self._endpoint != endpoint:
            raise RuntimeError(
                f"Address {self.name!r} already resolved to {self._endpoint!r}; "
                f"refusing to re-resolve to {endpoint!r}")
        self._endpoint = endpoint

    # -- execution phase ----------------------------------------------------
    @property
    def endpoint(self) -> str:
        if self._endpoint is None:
            raise RuntimeError(
                f"Address {self.name!r} (uid={self.uid}) was dereferenced before "
                "launch resolved it. Handles are only usable during execution.")
        return self._endpoint

    @property
    def is_resolved(self) -> bool:
        return self._endpoint is not None

    def __repr__(self) -> str:
        state = self._endpoint if self._endpoint else "<unresolved>"
        return f"Address({self.name!r}, uid={self.uid}, endpoint={state})"

    # Addresses are serialized inside handles; preserve resolution state.
    def __getstate__(self):
        return {"uid": self.uid, "name": self.name, "endpoint": self._endpoint}

    def __setstate__(self, state):
        self.uid = state["uid"]
        self.name = state["name"]
        self._endpoint = state["endpoint"]


class AddressTable:
    """Launch-phase mapping from address uid -> endpoint (paper §3.2)."""

    def __init__(self):
        self._table: dict[int, str] = {}

    def assign(self, address: Address, endpoint: str) -> None:
        self._table[address.uid] = endpoint
        address.resolve(endpoint)

    def lookup(self, address: Address) -> str:
        return self._table[address.uid]

    def __len__(self) -> int:
        return len(self._table)

    def items(self):
        return self._table.items()
