"""Pluggable courier transports (paper §4.1).

A :class:`Transport` moves one call — ``(method, args, kwargs)`` — or one
batch of calls to a service and returns the result(s). The unified
:class:`~repro_torch.core.courier.client.CourierClient` owns all proxy sugar
(attribute methods, ``.futures``, ``batch_call``) and delegates the actual
movement here, so the gRPC and in-process paths no longer duplicate it.

Implementations:

``GrpcTransport``    framed wire format (serialization.py) over pooled
                     gRPC channels. Channels are shared process-wide,
                     keyed by ``host:port`` and refcounted: N clients to
                     the same endpoint share one channel; the channel
                     closes when the last client is closed.
``ShmTransport``     same-host cross-process fast path: framed messages
                     over shared-memory rings (shm.py), with a reply-
                     correlation map so futures pipeline without waiting
                     on each other.
``InProcTransport``  direct method invocation against the in-process
                     registry (zero serialization); ``.futures`` runs on a
                     shared thread pool. Used when launch placed caller
                     and service in the same process.

An endpoint may carry several candidate schemes joined by ``+``
(preferred first), e.g. ``shm://name+grpc://127.0.0.1:9000``:
:func:`make_transport` picks the first viable one, so a same-host client
gets the shm ring and a remote (or shm-less) client transparently falls
back to gRPC.
"""

from __future__ import annotations

import abc
import contextlib
import re
import threading
import time
from concurrent import futures as cf
from typing import Any, Callable, Optional, Sequence

from repro_torch.core import telemetry
from repro_torch.core.courier import inprocess
from repro_torch.core.courier import serialization as ser
from repro_torch.core.courier import shm as shm_mod

# One call: (method, args, kwargs). One status: ("ok", value) | ("err", ...).
Call = tuple[str, tuple, dict]


class TransportStats:
    """Per-transport I/O counters. Plain attribute adds (GIL-atomic
    enough for telemetry) — the record path takes no locks. ``bytes_*``
    count serialized payloads where a wire exists (gRPC/shm); the inproc
    transport moves objects, so its byte counters stay zero."""

    __slots__ = ("calls", "batch_calls", "batched_calls_in_frames",
                 "errors", "bytes_out", "bytes_in", "serialize_us",
                 "pool_grows")

    def __init__(self):
        self.calls = 0
        self.batch_calls = 0
        self.batched_calls_in_frames = 0
        self.errors = 0
        self.bytes_out = 0
        self.bytes_in = 0
        self.serialize_us = 0.0
        self.pool_grows = 0

    def as_dict(self) -> dict:
        return {"calls": self.calls, "batch_calls": self.batch_calls,
                "batched_calls_in_frames": self.batched_calls_in_frames,
                "errors": self.errors, "bytes_out": self.bytes_out,
                "bytes_in": self.bytes_in,
                "serialize_us": self.serialize_us,
                "pool_grows": self.pool_grows}

_GRPC_OPTIONS = [
    ("grpc.max_send_message_length", -1),
    ("grpc.max_receive_message_length", -1),
    # Launchers reserve ports by holding a bound SO_REUSEPORT socket open
    # until the server binds (closes the pick-then-bind TOCTOU window), so
    # the server must bind with SO_REUSEPORT too. Default on Linux; pinned
    # here so the reservation scheme cannot silently break.
    ("grpc.so_reuseport", 1),
]

COURIER_METHOD = "/courier/Call"
COURIER_BATCH_METHOD = "/courier/BatchCall"

# First-contact deadline for gRPC transports. wait_for_ready=True exists so
# calls issued before the server node finished binding do not fail, but with
# timeout=None it blocks *forever* on an endpoint that never comes up; this
# bounds the wait with a clear error instead. Overridable per client via
# the existing timeout plumbing (CourierClient(endpoint, timeout=...)).
CONNECT_TIMEOUT_S = 20.0


class Transport(abc.ABC):
    """Moves calls to one service endpoint."""

    endpoint: str

    def __init__(self):
        self._io = TransportStats()

    def stats(self) -> dict:
        """Cumulative I/O counters (calls, batched calls, bytes in/out,
        errors, serialize time, slot-pool grow events) — the transport's
        contribution to a node's ``telemetry()`` report."""
        return self._io.as_dict()

    @abc.abstractmethod
    def call(self, method: str, args: tuple, kwargs: dict) -> Any:
        """Execute one call synchronously; return its result or raise."""

    @abc.abstractmethod
    def call_future(self, method: str, args: tuple, kwargs: dict) -> cf.Future:
        """Execute one call asynchronously."""

    @abc.abstractmethod
    def batch_call(self, calls: Sequence[Call]) -> list[tuple]:
        """Execute N calls in one round trip; return N statuses in order."""

    @abc.abstractmethod
    def batch_call_future(self, calls: Sequence[Call]) -> cf.Future:
        """Async :meth:`batch_call`; the future resolves to the status list."""

    def close(self) -> None:  # noqa: B027 - optional hook
        """Release transport resources. Idempotent."""


# ---- gRPC channel pool ------------------------------------------------------

class _ChannelPool:
    """Process-wide refcounted channel cache keyed by ``host:port``.

    gRPC channels are expensive (socket + HTTP/2 session + threads) and
    fully thread-safe, so every transport to the same endpoint shares one.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[str, tuple[grpc.Channel, int]] = {}

    def acquire(self, target: str) -> grpc.Channel:
        import grpc
        with self._lock:
            entry = self._entries.get(target)
            if entry is None:
                channel = grpc.insecure_channel(target, options=_GRPC_OPTIONS)
                self._entries[target] = (channel, 1)
                return channel
            channel, refs = entry
            self._entries[target] = (channel, refs + 1)
            return channel

    def release(self, target: str) -> None:
        with self._lock:
            entry = self._entries.get(target)
            if entry is None:
                return
            channel, refs = entry
            if refs <= 1:
                del self._entries[target]
            else:
                self._entries[target] = (channel, refs - 1)
                return
        channel.close()

    def stats(self) -> dict[str, int]:
        """target -> refcount (test/debug hook)."""
        with self._lock:
            return {t: refs for t, (_, refs) in self._entries.items()}


_channel_pool = _ChannelPool()


def channel_pool_stats() -> dict[str, int]:
    return _channel_pool.stats()


def _wrap_rpc_error(endpoint: str, exc: grpc.RpcError) -> ser.RemoteError:
    """Transport-level failures (channel broken, server gone, deadline)
    surface as RemoteError naming the endpoint, like remote exceptions."""
    code = exc.code() if hasattr(exc, "code") else None
    details = exc.details() if hasattr(exc, "details") else ""
    return ser.RemoteError(
        f"courier call to {endpoint} failed: {code} {details}".rstrip())


class _DecodingFuture(cf.Future):
    """Adapts a grpc future into a concurrent.futures.Future, decoding the
    raw reply bytes with ``decode`` on completion."""

    @classmethod
    def wrap(cls, grpc_future, decode: Callable[[bytes], Any],
             endpoint: str, io: Optional["TransportStats"] = None
             ) -> "cf.Future":
        import grpc
        out = cls()
        out.set_running_or_notify_cancel()

        def _done(gf):
            try:
                out.set_result(decode(gf.result()))
            except grpc.RpcError as exc:
                if io is not None:
                    io.errors += 1
                out.set_exception(_wrap_rpc_error(endpoint, exc))
            except BaseException as exc:  # noqa: BLE001
                out.set_exception(exc)

        grpc_future.add_done_callback(_done)
        return out


class GrpcTransport(Transport):
    """Courier-over-gRPC with pooled channels and framed serialization.

    ``wire_format="frames"`` (default) uses the protocol-5 out-of-band
    frame format; ``"legacy"`` emits the pre-frames bare-cloudpickle blobs
    (the server mirrors whichever format the request used — this is the
    benchmark baseline and the mixed-version compatibility path).
    """

    def __init__(self, endpoint: str, timeout: Optional[float] = None,
                 wire_format: str = "frames"):
        super().__init__()
        if endpoint.startswith("grpc://"):
            endpoint = endpoint[len("grpc://"):]
        if wire_format not in ("frames", "legacy"):
            raise ValueError(f"unknown wire_format {wire_format!r}")
        self.endpoint = f"grpc://{endpoint}"
        self._target = endpoint
        self._timeout = timeout
        self._legacy = wire_format == "legacy"
        self._lock = threading.Lock()
        self._channel: Optional[grpc.Channel] = None
        self._unary = None
        self._unary_batch = None
        self._closed = False
        self._ready = False

    # -- channel lifecycle ---------------------------------------------------
    def _callables(self, ensure_ready: bool = False):
        import grpc
        with self._lock:
            if self._closed:
                raise RuntimeError(f"transport to {self.endpoint} is closed")
            if self._channel is None:
                self._channel = _channel_pool.acquire(self._target)
                self._unary = self._channel.unary_unary(
                    COURIER_METHOD,
                    request_serializer=None, response_deserializer=None)
                self._unary_batch = self._channel.unary_unary(
                    COURIER_BATCH_METHOD,
                    request_serializer=None, response_deserializer=None)
            channel = self._channel
            unary, unary_batch = self._unary, self._unary_batch
        if ensure_ready and not self._ready:
            # First contact on the *synchronous* paths: bound wait for the
            # endpoint to exist at all, so a typo'd or never-started server
            # errors out instead of blocking forever under wait_for_ready.
            # Future-returning paths skip this (they must not block the
            # caller during asynchronous launch). Probed with an RPC to a
            # reserved method — UNIMPLEMENTED proves the server is up —
            # rather than channel_ready_future, whose connectivity
            # subscription leaks a polling thread that crashes when the
            # channel closes.
            deadline = self._timeout if self._timeout is not None \
                else CONNECT_TIMEOUT_S
            probe = channel.unary_unary("/courier/__ready__")
            try:
                probe(b"", timeout=deadline, wait_for_ready=True)
            except grpc.RpcError as exc:
                code = exc.code() if hasattr(exc, "code") else None
                if code == grpc.StatusCode.DEADLINE_EXCEEDED:
                    raise ser.RemoteError(
                        f"courier endpoint {self.endpoint} did not become "
                        f"reachable within {deadline:.1f}s (server down, "
                        "still starting, or wrong address)") from None
                if code != grpc.StatusCode.UNIMPLEMENTED:
                    raise _wrap_rpc_error(self.endpoint, exc) from exc
            self._ready = True
        return unary, unary_batch

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            had_channel = self._channel is not None
            self._channel = None
            self._unary = None
            self._unary_batch = None
        if had_channel:
            _channel_pool.release(self._target)

    # -- calls ---------------------------------------------------------------
    def _encode(self, calls_or_one, batch: bool) -> bytes:
        io = self._io
        t0 = time.perf_counter()
        if batch:
            payload = ser.encode_batch_call(calls_or_one, legacy=self._legacy)
            io.batch_calls += 1
            io.batched_calls_in_frames += len(calls_or_one)
        else:
            method, args, kwargs = calls_or_one
            payload = ser.encode_call(method, args, kwargs,
                                      legacy=self._legacy)
            io.calls += 1
        io.serialize_us += (time.perf_counter() - t0) * 1e6
        io.bytes_out += len(payload)
        return payload

    def _decode_reply(self, reply: bytes):
        self._io.bytes_in += len(reply)
        return ser.decode_reply(reply)

    def _decode_batch_reply(self, reply: bytes):
        self._io.bytes_in += len(reply)
        return ser.decode_batch_reply(reply)

    def call(self, method: str, args: tuple, kwargs: dict) -> Any:
        import grpc
        unary, _ = self._callables(ensure_ready=True)
        payload = self._encode((method, args, kwargs), batch=False)
        try:
            # wait_for_ready: don't fail calls issued before the server node
            # finished binding (launch is asynchronous).
            reply = unary(payload, timeout=self._timeout, wait_for_ready=True)
        except grpc.RpcError as exc:
            self._io.errors += 1
            raise _wrap_rpc_error(self.endpoint, exc) from exc
        return self._decode_reply(reply)

    def call_future(self, method: str, args: tuple, kwargs: dict) -> cf.Future:
        unary, _ = self._callables()
        payload = self._encode((method, args, kwargs), batch=False)
        gf = unary.future(payload, timeout=self._timeout, wait_for_ready=True)
        return _DecodingFuture.wrap(gf, self._decode_reply, self.endpoint,
                                    io=self._io)

    def batch_call(self, calls: Sequence[Call]) -> list[tuple]:
        import grpc
        _, batch = self._callables(ensure_ready=True)
        payload = self._encode(calls, batch=True)
        try:
            reply = batch(payload, timeout=self._timeout, wait_for_ready=True)
        except grpc.RpcError as exc:
            self._io.errors += 1
            raise _wrap_rpc_error(self.endpoint, exc) from exc
        return self._decode_batch_reply(reply)

    def batch_call_future(self, calls: Sequence[Call]) -> cf.Future:
        _, batch = self._callables()
        payload = self._encode(calls, batch=True)
        gf = batch.future(payload, timeout=self._timeout, wait_for_ready=True)
        return _DecodingFuture.wrap(gf, self._decode_batch_reply,
                                    self.endpoint, io=self._io)

    def __repr__(self) -> str:
        fmt = "legacy" if self._legacy else "frames"
        return f"GrpcTransport({self.endpoint}, wire_format={fmt!r})"


class ShmTransport(Transport):
    """Courier over a shared-memory ring pair (same-host processes only).

    One SPSC ring per direction (shm.py): requests are scatter-gathered
    straight into the ring (``serialization.encode_frames`` +
    ``framed_chunks`` — no intermediate ``bytes``), large messages go
    through the per-direction slot pool, and replies resolve through a
    req-id -> Future correlation map so ``call_future``/``batch_call``
    pipeline: N in-flight calls share the rings without blocking each
    other.

    Large replies are decoded **zero-copy**: result arrays are read-only
    views aliasing a pool slot, pinned by a lease that frees the slot
    when the decoded result is garbage-collected. Callers that retain a
    result long-term should ``np.copy`` it (or
    ``serialization.materialize`` the whole result) so the sender's pool
    is not starved. ``zero_copy=False`` restores the copy-out receive on
    both directions of the connection — the paired A/B baseline in
    benchmarks/rpc_overhead.py.

    Receiving is *caller-driven*: the thread blocked in a synchronous
    ``call`` takes the drive lock and drains the reply ring itself
    (fulfilling any other caller's futures it encounters on the way),
    which keeps the hot path free of reader-thread/condvar hand-offs; a
    fallback daemon thread drives only while futures are outstanding with
    no active driver. If the server process dies, pending futures fail
    with a RemoteError naming the endpoint (no deadlock).
    """

    def __init__(self, endpoint: str, timeout: Optional[float] = None,
                 connect_wait: Optional[float] = None,
                 zero_copy: bool = True):
        super().__init__()
        if endpoint.startswith("shm://"):
            endpoint = endpoint[len("shm://"):]
        self.endpoint = f"shm://{endpoint}"
        self._timeout = timeout
        # Raises ShmConnectError if no healthy listener; make_transport
        # catches it to fall back to gRPC.
        self._conn = shm_mod.ClientConnection.connect(
            endpoint, wait=connect_wait, zero_copy=zero_copy)
        self._pending: dict[int, cf.Future] = {}
        self._plock = threading.Lock()
        self._drive_lock = threading.Lock()
        self._work = threading.Event()
        self._next_id = 0
        self._closed = False
        self._broken: Optional[BaseException] = None
        self._fallback = threading.Thread(
            target=self._fallback_drive,
            name=f"courier-shm-client/{endpoint}", daemon=True)
        self._fallback.start()

    # -- reply correlation ----------------------------------------------------
    def _dispatch(self, rec) -> None:
        kind, req_id, obj = rec
        with self._plock:
            fut = self._pending.pop(req_id, None)
        if fut is None:
            return  # cancelled/unknown; drop
        if isinstance(obj, shm_mod.DecodeFailure):
            fut.set_exception(ser.RemoteError(
                f"reply from {self.endpoint} failed to decode: "
                f"{obj.exc!r}"))
        elif kind == shm_mod.KIND_REPLY:
            if obj[0] == "ok":
                fut.set_result(obj[1])
            else:
                fut.set_exception(ser.status_to_exception(obj))
        elif kind == shm_mod.KIND_BATCH_REPLY:
            fut.set_result(obj)

    def _drive_once(self, timeout: float) -> None:
        """Receive+dispatch at most one reply. Marks the transport broken
        (failing every pending future) on peer death or a dead ring."""
        try:
            rec = self._conn.recv(timeout=timeout)
        except shm_mod.RingClosed:
            self._fail_pending(ser.RemoteError(
                f"courier endpoint {self.endpoint} closed by peer"))
            return
        except Exception as exc:  # undecodable stream; KeyboardInterrupt
            # and friends must propagate to the driving caller instead.
            self._fail_pending(ser.RemoteError(
                f"courier endpoint {self.endpoint} sent an undecodable "
                f"reply: {exc!r}"))
            return
        if rec is None:
            if not self._conn.peer_alive() and not self._closed:
                self._fail_pending(ser.RemoteError(
                    f"courier endpoint {self.endpoint}: server process "
                    "died"))
            return
        self._dispatch(rec)

    def _fallback_drive(self) -> None:
        """Covers futures nobody is awaiting synchronously. Sleeps on an
        event while the transport is idle (no polling cost), woken by
        ``_submit``."""
        while not self._closed and self._broken is None:
            if not self._pending:
                self._work.wait(timeout=0.5)
                self._work.clear()
                continue
            if self._drive_lock.acquire(timeout=0.05):
                try:
                    while (not self._closed and self._broken is None
                           and self._pending):
                        self._drive_once(timeout=0.05)
                except BaseException:  # noqa: BLE001 - daemon must not die
                    if self._broken is None and not self._closed:
                        self._fail_pending(ser.RemoteError(
                            f"courier endpoint {self.endpoint}: reply "
                            "drain failed"))
                    return
                finally:
                    self._drive_lock.release()

    def _fail_pending(self, exc: BaseException) -> None:
        # _broken is published under _plock, in the same critical section
        # that empties the map: a _submit either sees _broken and raises,
        # or registers its future before the clear and gets it failed —
        # never an orphaned pending future nobody will resolve.
        with self._plock:
            self._broken = exc
            pending = list(self._pending.values())
            self._pending.clear()
        self._io.errors += len(pending)
        for fut in pending:
            if not fut.done():
                fut.set_exception(exc)

    def _submit(self, kind: int, payload) -> tuple[int, cf.Future]:
        if self._closed:
            raise RuntimeError(f"transport to {self.endpoint} is closed")
        fut: cf.Future = cf.Future()
        fut.set_running_or_notify_cancel()
        with self._plock:
            if self._broken is not None:
                raise ser.RemoteError(
                    f"courier endpoint {self.endpoint} is broken: "
                    f"{self._broken}")
            self._next_id += 1
            req_id = self._next_id
            self._pending[req_id] = fut
        self._work.set()  # wake the fallback driver for this request
        try:
            self._conn.send(kind, req_id, payload, timeout=self._timeout)
        except BaseException as exc:
            with self._plock:
                self._pending.pop(req_id, None)
            if isinstance(exc, shm_mod.RingClosed):
                raise ser.RemoteError(
                    f"courier endpoint {self.endpoint} is gone: {exc}"
                ) from exc
            raise
        return req_id, fut

    def _timed_out(self, req_id: int) -> ser.RemoteError:
        # Un-register the request so a reply that never comes cannot keep
        # the fallback driver awake (and the map from growing) forever; a
        # late reply for this id is simply dropped by _dispatch.
        with self._plock:
            self._pending.pop(req_id, None)
        return ser.RemoteError(
            f"courier call to {self.endpoint} timed out after "
            f"{self._timeout}s")

    def _await(self, req_id: int, fut: cf.Future) -> Any:
        deadline = None if self._timeout is None \
            else time.monotonic() + self._timeout
        while not fut.done():
            if self._closed:
                break
            if deadline is not None and time.monotonic() >= deadline:
                raise self._timed_out(req_id)
            if self._drive_lock.acquire(blocking=False):
                try:
                    while not fut.done() and not self._closed \
                            and self._broken is None:
                        self._drive_once(timeout=0.05)
                        if deadline is not None \
                                and time.monotonic() >= deadline \
                                and not fut.done():
                            raise self._timed_out(req_id)
                finally:
                    self._drive_lock.release()
            else:
                # Another thread is driving; it will fulfil our future.
                with contextlib.suppress(cf.TimeoutError):
                    fut.result(timeout=0.005)
                if deadline is not None and time.monotonic() >= deadline \
                        and not fut.done():
                    raise self._timed_out(req_id)
        if not fut.done():
            # Raced with close(): _closed was observed before close's
            # _fail_pending resolved our future.
            raise ser.RemoteError(
                f"transport to {self.endpoint} was closed")
        return fut.result(timeout=0)

    # -- calls ---------------------------------------------------------------
    def call(self, method: str, args: tuple, kwargs: dict) -> Any:
        self._io.calls += 1
        return self._await(*self._submit(shm_mod.KIND_CALL,
                                         (method, args, kwargs)))

    def call_future(self, method: str, args: tuple, kwargs: dict) -> cf.Future:
        self._io.calls += 1
        return self._submit(shm_mod.KIND_CALL, (method, args, kwargs))[1]

    def batch_call(self, calls: Sequence[Call]) -> list[tuple]:
        self._io.batch_calls += 1
        self._io.batched_calls_in_frames += len(calls)
        return self._await(*self._submit(shm_mod.KIND_BATCH, list(calls)))

    def batch_call_future(self, calls: Sequence[Call]) -> cf.Future:
        self._io.batch_calls += 1
        self._io.batched_calls_in_frames += len(calls)
        return self._submit(shm_mod.KIND_BATCH, list(calls))[1]

    def stats(self) -> dict:
        """Transport counters plus the connection's wire-level I/O —
        bytes actually carried by the rings (serialize time included)
        and slot-pool grow events on the send channel."""
        out = self._io.as_dict()
        io = getattr(self._conn, "io_stats", None)
        if callable(io):
            conn = io()
            out["bytes_out"] += conn["bytes_out"]
            out["bytes_in"] += conn["bytes_in"]
            out["serialize_us"] += conn["serialize_us"]
            out["pool_grows"] += conn["pool_grows"]
        return out

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._work.set()  # wake the fallback driver so it can exit
        self._fail_pending(ser.RemoteError(
            f"transport to {self.endpoint} was closed"))
        self._conn.close()
        self._fallback.join(timeout=2.0)
        self._conn.release()

    def __repr__(self) -> str:
        return f"ShmTransport({self.endpoint})"


class InProcTransport(Transport):
    """Same-process fast path: direct invocation, zero serialization.

    Mirrors the gRPC server's exposure rules (no ``run``, no ``_private``)
    so a program behaves the same whichever transport launch picked.
    Exceptions propagate as the *original* exception objects — there is no
    wire to strip tracebacks — except batch statuses, which carry them
    unmodified in the ``err`` slot.
    """

    def __init__(self, name: str):
        super().__init__()
        self.endpoint = f"inproc://{name}"
        self._name = name
        self._obj = None

    def _target_obj(self) -> Any:
        if self._obj is None:
            self._obj = inprocess.lookup(self._name)
        return self._obj

    def _resolve(self, method: str):
        if method.startswith("_") or method == "run":
            raise ser.RemoteError(
                f"method {method!r} is not exposed over courier")
        return getattr(self._target_obj(), method)

    def call(self, method: str, args: tuple, kwargs: dict) -> Any:
        # Mirror the server chokepoint: pop the trace envelope and run the
        # handler under it, so a sampled request traces identically
        # whichever transport launch picked. kwargs is copied first — the
        # caller may share the dict (e.g. a retried batch entry).
        self._io.calls += 1
        ctx = None
        if telemetry.TRACE_KEY in kwargs:
            kwargs = dict(kwargs)
            ctx = telemetry.extract(kwargs)
        try:
            if ctx is not None:
                with telemetry.activate(ctx):
                    return self._resolve(method)(*args, **kwargs)
            return self._resolve(method)(*args, **kwargs)
        except BaseException:
            self._io.errors += 1
            raise

    def call_future(self, method: str, args: tuple, kwargs: dict) -> cf.Future:
        return inprocess.shared_pool().submit(self.call, method, args, kwargs)

    def batch_call(self, calls: Sequence[Call]) -> list[tuple]:
        self._io.batch_calls += 1
        self._io.batched_calls_in_frames += len(calls)
        statuses = []
        for method, args, kwargs in calls:
            try:
                statuses.append(ser.make_ok_status(self.call(method, args,
                                                             kwargs)))
            except BaseException as exc:  # noqa: BLE001 - per-call isolation
                statuses.append(ser.make_error_status(exc))
        return statuses

    def batch_call_future(self, calls: Sequence[Call]) -> cf.Future:
        return inprocess.shared_pool().submit(self.batch_call, list(calls))

    def __repr__(self) -> str:
        return f"InProcTransport({self.endpoint})"


def _is_grpc_endpoint(ep: str) -> bool:
    # grpc://host:port, or a bare host:port (numeric port) for convenience.
    return ep.startswith("grpc://") or re.fullmatch(r"[^:/]+:\d+", ep) is not None


def _try_shm(name: str, timeout: Optional[float],
             has_fallback: bool) -> Optional[Transport]:
    """Connect over shm if a healthy same-host listener is (or comes) up.

    ``ClientConnection.connect`` owns the rendezvous policy: an absent
    listener gets a grace period (``shm.CONNECT_WAIT_S`` — launch is
    asynchronous, same idea as gRPC's wait_for_ready), while a *stale*
    one (rendezvous left by a crashed server, or a different host) fails
    immediately so the caller falls back instead of deadlocking on dead
    shared memory.
    """
    try:
        return ShmTransport(name, timeout=timeout)
    except shm_mod.ShmConnectError as exc:
        if has_fallback:
            return None
        raise ser.RemoteError(
            f"shm connect failed and the endpoint has no fallback: {exc}"
        ) from exc


def make_transport(endpoint: str, timeout: Optional[float] = None,
                   wire_format: str = "frames") -> Transport:
    """Build the most appropriate transport for a resolved endpoint.

    ``endpoint`` may be a single URI or a ``+``-joined candidate list
    (preferred first). Unknown schemes fail fast — with wait_for_ready a
    typo'd endpoint would otherwise block forever instead of erroring.
    """
    candidates = endpoint.split("+")
    grpc_ep = next((ep for ep in candidates if _is_grpc_endpoint(ep)), None)
    for ep in candidates:
        if ep.startswith("inproc://"):
            return InProcTransport(ep[len("inproc://"):])
        if ep.startswith("shm://"):
            # The shm transport only speaks the framed format; an explicit
            # legacy request (A/B tooling, mixed-version peers) must reach
            # a transport that honors it.
            if not shm_mod.supported() or wire_format != "frames":
                continue
            transport = _try_shm(ep[len("shm://"):], timeout,
                                 has_fallback=grpc_ep is not None)
            if transport is not None:
                return transport
            continue  # stale/unreachable listener: fall through to gRPC
        if _is_grpc_endpoint(ep):
            return GrpcTransport(ep, timeout=timeout, wire_format=wire_format)
        raise ValueError(f"unknown courier endpoint scheme: {ep!r}")
    raise ValueError(f"no viable transport for endpoint {endpoint!r}")
