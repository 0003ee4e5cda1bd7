"""Courier: the RPC layer under Launchpad handles (paper §4, footnote 2).

Layered as: ``CourierClient`` (proxy sugar) over a pluggable
:class:`Transport` (``GrpcTransport`` / ``ShmTransport`` /
``InProcTransport``) over the framed zero-copy wire format
(``serialization``). See README.md here.
"""

from __future__ import annotations

from repro_torch.core.courier import inprocess, shm
from repro_torch.core.courier.client import CourierClient
from repro_torch.core.courier.serialization import RemoteError, materialize
from repro_torch.core.courier.server import CourierServer
from repro_torch.core.courier.transport import (GrpcTransport, InProcTransport,
                                          ShmTransport, Transport,
                                          channel_pool_stats, make_transport)


def client_for(endpoint: str) -> CourierClient:
    """Build the unified client over the most appropriate transport.

    ``inproc://name`` -> same-process direct transport (colocated services)
    ``shm://name`` -> shared-memory ring pair (same-host processes)
    ``grpc://host:port`` -> courier-over-gRPC on a pooled channel

    Endpoints may list several candidates joined by ``+`` (preferred
    first); the first viable one wins, e.g. ``shm://n+grpc://h:p`` uses
    the ring on the server's host and gRPC everywhere else.
    """
    return CourierClient(endpoint)


__all__ = [
    "CourierClient",
    "CourierServer",
    "GrpcTransport",
    "InProcTransport",
    "RemoteError",
    "ShmTransport",
    "Transport",
    "channel_pool_stats",
    "client_for",
    "inprocess",
    "make_transport",
    "materialize",
    "shm",
]
