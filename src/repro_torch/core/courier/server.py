"""Courier server: expose an arbitrary Python object over gRPC (paper §4.1).

We register *generic* unary-unary handlers at ``/courier/Call`` and
``/courier/BatchCall`` so no protoc-generated stubs are needed. Requests
are framed ``(method, args, kwargs)`` messages (serialization.py); replies
are ``("ok", value)`` or ``("err", exc, traceback)`` statuses — a batch
request carries N calls in one frame and gets N statuses back, in order.
The server mirrors the request's wire format (framed vs. legacy bare
pickle), so old-format clients keep working.

Paper semantics implemented here:
  * all *public* methods of the wrapped object are exposed, except ``run``;
  * if a ``run`` method exists the worker executes it, otherwise the worker
    waits for incoming RPCs.
"""

from __future__ import annotations

import threading
from concurrent import futures
from typing import Any, Callable, Optional

from repro_torch.core import telemetry
from repro_torch.core.courier import serialization as ser
from repro_torch.core.courier import shm as shm_mod
from repro_torch.core.courier.transport import (COURIER_BATCH_METHOD,
                                          COURIER_METHOD, _GRPC_OPTIONS)


def _generic_handler(handlers: dict[str, Callable]):
    """A generic gRPC handler routing raw-bytes unary calls by method name.
    gRPC is imported here, where a server is built: the in-process and
    shared-memory paths run without it."""
    import grpc

    class _GenericCourierHandler(grpc.GenericRpcHandler):
        def __init__(self):
            self._handlers = {
                method: grpc.unary_unary_rpc_method_handler(
                    fn,
                    request_deserializer=None,   # raw bytes in
                    response_serializer=None,    # raw bytes out
                )
                for method, fn in handlers.items()
            }

        def service(self, handler_call_details):
            return self._handlers.get(handler_call_details.method)

    return _GenericCourierHandler()


class CourierServer:
    """Serves the public methods of ``obj`` at a gRPC endpoint.

    ``handler_init`` (optional) runs at the top of every RPC on the
    handling thread — launchers use it to install the node's
    :class:`WorkerContext` so service code can call ``lp.stop_program()``
    from inside an RPC handler.

    ``shm_name`` (optional) additionally serves same-host clients over a
    shared-memory ring listener (``shm://<shm_name>``) alongside the gRPC
    port — same dispatch, same exposure rules, same per-call batch
    isolation; the process launcher emits dual endpoints so same-host
    peers take the ring and everyone else falls back to gRPC.

    Request dispatch is zero-copy on both transports: decoded argument
    arrays are read-only views aliasing the inbound message (gRPC request
    bytes, or a shared-memory pool slot pinned by a lease). The lease is
    released after the handler returns — via refcount, so a handler that
    *retains* an argument array keeps the slot pinned and must
    ``np.copy`` it instead (see courier/README.md).
    """

    def __init__(self, obj: Any, port: int = 0, host: str = "127.0.0.1",
                 max_workers: int = 16,
                 handler_init: Optional[Callable[[], None]] = None,
                 shm_name: Optional[str] = None):
        self._obj = obj
        self._handler_init = handler_init
        self._lock = threading.Lock()  # guards lifecycle transitions
        import grpc
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers,
                                       thread_name_prefix="courier-srv"),
            options=_GRPC_OPTIONS)
        self._server.add_generic_rpc_handlers(
            (_generic_handler({
                COURIER_METHOD: self._handle,
                COURIER_BATCH_METHOD: self._handle_batch,
            }),))
        self._port = self._server.add_insecure_port(f"{host}:{port}")
        if self._port == 0:
            raise RuntimeError(f"failed to bind courier server on {host}:{port}")
        self._host = host
        self._shm_name = shm_name
        self._shm_listener: Optional[shm_mod.ShmListener] = None
        self._max_workers = max_workers
        self._started = False
        self._stopped = False

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        with self._lock:
            if self._stopped:
                raise RuntimeError("CourierServer cannot restart after stop()")
            if self._started:
                return
            self._server.start()
            if self._shm_name is not None and shm_mod.supported():
                # Advertise the ring listener only once we actually serve.
                self._shm_listener = shm_mod.ShmListener(
                    self._shm_name, invoke=self._invoke,
                    handler_init=self._handler_init,
                    max_workers=self._max_workers)
                self._shm_listener.start()
            self._started = True

    def stop(self, grace: Optional[float] = 0.5) -> None:
        """Stop serving. Safe to call repeatedly or before start() (which
        releases the port bound in __init__ either way)."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            listener = self._shm_listener
            self._shm_listener = None
        if listener is not None:
            listener.stop()
        self._server.stop(grace)

    def wait(self) -> None:
        self._server.wait_for_termination()

    def __enter__(self) -> "CourierServer":
        self.start()
        return self

    def __exit__(self, *exc_info) -> None:
        self.stop()

    @property
    def endpoint(self) -> str:
        return f"grpc://{self._host}:{self._port}"

    @property
    def shm_endpoint(self) -> Optional[str]:
        return f"shm://{self._shm_name}" if self._shm_name else None

    @property
    def port(self) -> int:
        return self._port

    # -- request handling ----------------------------------------------------
    def _invoke(self, method: str, args: tuple, kwargs: dict) -> Any:
        if method.startswith("_") or method == "run":
            raise AttributeError(
                f"method {method!r} is not exposed over courier")
        # Trace envelope: the client-side proxy injected the sampled
        # context into kwargs; activate it on this handler thread so
        # spans recorded by the service nest under the caller's span.
        # This chokepoint covers gRPC unary, gRPC batch entries, and
        # the shm listener (which dispatches through invoke=).
        ctx = telemetry.extract(kwargs)
        if ctx is None:
            return getattr(self._obj, method)(*args, **kwargs)
        with telemetry.activate(ctx):
            return getattr(self._obj, method)(*args, **kwargs)

    def _handle(self, request: bytes, context) -> bytes:
        legacy = not ser.is_framed(request)
        if self._handler_init is not None:
            self._handler_init()
        try:
            method, args, kwargs = ser.decode_call(request)
            # Peek (don't pop — _invoke owns extraction) so the reply
            # serialization span lands in the same trace.
            wire = kwargs.get(telemetry.TRACE_KEY) \
                if isinstance(kwargs, dict) else None
            result = self._invoke(method, args, kwargs)
            ctx = telemetry.TraceContext.from_wire(wire) if wire else None
            if ctx is None:
                return ser.encode_reply_ok(result, legacy=legacy)
            with telemetry.activate(ctx):
                with telemetry.span("reply", method=method):
                    return ser.encode_reply_ok(result, legacy=legacy)
        except BaseException as exc:  # noqa: BLE001 - ship any failure back
            return ser.encode_reply_error(exc, legacy=legacy)

    def _handle_batch(self, request: bytes, context) -> bytes:
        legacy = not ser.is_framed(request)
        if self._handler_init is not None:
            self._handler_init()
        statuses = []
        try:
            calls = ser.decode_batch_call(request)
        except BaseException as exc:  # noqa: BLE001 - undecodable batch
            return ser.encode_reply_error(exc, legacy=legacy)
        for method, args, kwargs in calls:
            # Per-call isolation: one failing entry never aborts siblings,
            # and statuses come back in request order.
            try:
                statuses.append(
                    ser.make_ok_status(self._invoke(method, args, kwargs)))
            except BaseException as exc:  # noqa: BLE001
                statuses.append(ser.make_error_status(exc))
        return ser.encode_batch_reply(statuses, legacy=legacy)
