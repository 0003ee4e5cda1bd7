"""Unified courier client: RPC proxy whose attributes are remote methods
(paper §4.1).

"from the perspective of any consuming class remote communication is
invisible and it appears as if it is just using the original Python
objects." One client class serves every transport — gRPC or in-process —
so the futures-proxy and method-proxy logic lives in exactly one place.

API surface::

    client = CourierClient("grpc://host:port")        # or "inproc://name"
    client.method(*args, **kwargs)                    # blocking call
    client.futures.method(*args, **kwargs)            # -> concurrent Future
    client.batch_call([(m, args, kwargs), ...])       # N calls, one frame
    client.futures.batch_call([...])                  # async batch
    with CourierClient(ep) as c: ...                  # scoped channel use

Results that contain arrays may be zero-copy: over the shm transport a
large reply's arrays are read-only views aliasing a shared-memory slot,
pinned by a lease that returns the slot to the sender's pool when the
result is garbage-collected. Drop results promptly, or detach them with
``courier.materialize(result)`` before retaining them long-term (a
handful of long-lived results otherwise starves the server's reply
pool). See courier/README.md, "The lease free protocol".
"""

from __future__ import annotations

from concurrent import futures as cf
from typing import Any, Optional, Sequence

from repro_torch.core import telemetry
from repro_torch.core.courier import serialization as ser
from repro_torch.core.courier.transport import Call, Transport, make_transport


def _inject_calls(calls: Sequence[Call]) -> Sequence[Call]:
    """Fold the current sampled trace context into each batched call's
    kwargs (copy-on-write: caller-owned tuples are never mutated)."""
    if telemetry.current_context() is None:
        return calls
    return [(m, a, telemetry.inject(kw)) for m, a, kw in calls]


def _statuses_to_results(statuses: Sequence[tuple]) -> list:
    """Unwrap batch statuses; error slots hold the exception instance."""
    return [status[1] if status[0] == "ok"
            else ser.status_to_exception(status)
            for status in statuses]


class _FuturesProxy:
    """``client.futures.method(...)`` -> concurrent.futures.Future."""

    def __init__(self, transport: Transport):
        self._transport = transport

    def batch_call(self, calls: Sequence[Call]) -> cf.Future:
        """Async batch; resolves to per-call results in request order, with
        exception instances occupying the slots of failed calls."""
        inner = self._transport.batch_call_future(_inject_calls(calls))
        out: cf.Future = cf.Future()
        out.set_running_or_notify_cancel()

        def _done(f):
            try:
                out.set_result(_statuses_to_results(f.result()))
            except BaseException as exc:  # noqa: BLE001
                out.set_exception(exc)

        inner.add_done_callback(_done)
        return out

    def __getattr__(self, method: str):
        if method.startswith("_"):
            raise AttributeError(method)
        transport = self._transport

        def call(*args, **kwargs) -> cf.Future:
            return transport.call_future(method, args,
                                         telemetry.inject(kwargs))

        return call


class CourierClient:
    """Client for a courier endpoint, over whichever transport fits it.

    ``grpc://host:port`` -> :class:`GrpcTransport` (pooled channel, framed
    zero-copy wire format); ``shm://name`` -> :class:`ShmTransport`
    (same-host shared-memory rings); ``inproc://name`` ->
    :class:`InProcTransport` (direct invocation). A ``+``-joined endpoint
    (e.g. ``shm://n+grpc://h:p`` from the process launcher) tries the
    candidates in order — shm when a healthy same-host listener exists,
    gRPC otherwise. Close (or use as a context manager) to release the
    pooled channel / rings; double-close is a no-op.
    """

    def __init__(self, endpoint: str, timeout: Optional[float] = None,
                 wire_format: str = "frames",
                 transport: Optional[Transport] = None):
        self._transport = transport if transport is not None else \
            make_transport(endpoint, timeout=timeout, wire_format=wire_format)

    @property
    def endpoint(self) -> str:
        return self._transport.endpoint

    @property
    def transport(self) -> Transport:
        return self._transport

    @property
    def futures(self) -> _FuturesProxy:
        return _FuturesProxy(self._transport)

    def __getattr__(self, method: str):
        if method.startswith("_"):
            raise AttributeError(method)
        transport = self._transport

        def call(*args, **kwargs):
            return transport.call(method, args, telemetry.inject(kwargs))

        return call

    # -- batched RPC ---------------------------------------------------------
    def batch_call(self, calls: Sequence[Call],
                   return_exceptions: bool = False) -> list[Any]:
        """Execute ``calls`` — ``(method, args, kwargs)`` tuples — in one
        round trip.

        Results come back in request order. A failing call never aborts its
        siblings server-side; client-side, the first error is raised unless
        ``return_exceptions`` is set, in which case error slots hold the
        exception instance instead.
        """
        statuses = self._transport.batch_call(_inject_calls(calls))
        if return_exceptions:
            return _statuses_to_results(statuses)
        return [ser.status_to_result(status) for status in statuses]

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        self._transport.close()

    def __enter__(self) -> "CourierClient":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    def __repr__(self) -> str:
        return f"CourierClient({self.endpoint})"
