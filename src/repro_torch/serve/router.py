"""Serve-fabric router: least-loaded dispatch across engine replicas.

The control plane over the PR 1-3 data plane: replicas register with a
:class:`repro_torch.core.discovery.Registry` and heartbeat a load report (free
KV slots, queue depth, EWMA us/token); a :class:`Router` admits requests
and forwards each one to the least-loaded healthy replica over the
existing courier ``futures`` pipeline. The program graph stays static —
``clients -> router -> registry`` handles — while the *membership* under
the router moves at runtime:

  * **Discovery**: a background thread polls ``registry.lookup()`` every
    ``refresh_s``; new replicas get a courier client, evicted ones are
    dropped (their in-flight requests fail over first). Every poll also
    refreshes the load reports — membership generation alone can't
    short-circuit it, because heartbeats update loads without bumping
    the generation.
  * **Routing**: per-request score = local in-flight count (this
    router's own dispatches, exact) + the replica's last-reported queue
    depth − its reported free slots; the freshest signal (our own
    in-flight deltas) dominates between heartbeats, ties break
    round-robin. Requests never pin to a replica: two requests from one
    client may land on two engines. A replica serving a *paged* engine
    reports free pages and expected pages-per-request alongside free
    slots, and the score caps admission headroom at
    ``free_pages / pages_per_request`` — a replica with idle rows but a
    drained page pool stops looking attractive.
  * **Coalesced dispatch** (``coalesce=True``, the default): ``submit``
    does not send its own RPC. It parks the call on a pending queue and
    a single dispatcher thread drains the queue, packing every call
    bound for the same replica into ONE courier ``batch_call`` frame
    and fanning the per-call results back out to the callers' futures.
    The flush policy is adaptive, not timed: an idle dispatcher flushes
    a lone arrival immediately (no added latency), and while it is busy
    sending one frame the next arrivals pile up behind it and leave as
    one frame — under load, frames form exactly as fast as the
    transport can carry them. Per-frame cost (serialize + send) is paid
    once per frame instead of once per call; failure semantics are
    unchanged because a frame-level transport error fans out to every
    caller and feeds the same failover classification as a per-call
    error.
  * **Failover**: a dispatch that dies with a *replica* error (transport
    failure, stopped engine) is retried on a sibling — bounded by
    ``max_retries`` — and the failed replica is evicted from the
    registry (``report_failure``) so other routers stop picking it too.
    A *request* error (bad prompt: ``ValueError``/``TypeError``) is
    returned to the caller unretried: resending a poisoned request N
    times is how fabrics melt down. When the failover leaves no healthy
    replica at all, the caller gets ``Overloaded`` (retry-later) rather
    than the dead replica's error — a stalled-but-live replica
    re-registers on its next heartbeat, so the condition is transient by
    construction.
  * **Backpressure**: when every healthy replica is at its admission
    budget (in-flight ≥ ``2 * num_slots``: a full pool plus an equally
    deep queue), ``submit`` fails fast with the typed
    :class:`Overloaded` instead of queueing unboundedly. Callers treat
    it as a retry-later signal (see :func:`is_overloaded`, which unwraps
    the courier ``RemoteError`` envelope).

  * **Rollout support**: a replica the registry marks *draining*
    (``Registry.set_draining`` — registered and heartbeating, but being
    taken out for a weight swap) stays in the table with its transport
    open while new dispatches go to siblings, and it does not count
    toward the Overloaded budget check. With ``set_canary(version,
    fraction)`` the router pins that fraction of requests to replicas
    reporting the canary model version (and steers the rest away from
    it), and keeps **per-version** latency/error rows in ``stats()`` so
    a RolloutController can compare old-vs-new percentiles before
    promoting fleet-wide. Version pinning is a preference, not a wall:
    if no replica of the wanted version is admissible, the request runs
    on whatever is — a canary must never fail requests.

The router is an ordinary ``CourierNode`` service: ``submit`` blocks its
RPC handler thread for one reply, so the courier server's handler pool is
the router's concurrency. Several routers can front the same registry;
each keeps its own in-flight counters (the heartbeat load reports carry
the cross-router signal).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent import futures as cf
from typing import Any, Callable, Optional

from repro_torch.core import courier, telemetry
from repro_torch.core.courier.serialization import RemoteError
from repro_torch.core.nodes.base import get_current_context


class Overloaded(RuntimeError):
    """Every healthy replica is at its admission budget. Typed so callers
    can tell "back off and retry" from a real failure."""


def unwrap_remote(exc: BaseException) -> BaseException:
    """Peel courier ``RemoteError`` envelopes down to the service's own
    exception (cross-transport: inproc raises originals, gRPC/shm wrap)."""
    seen: set[int] = set()
    while (isinstance(exc, RemoteError) and exc.__cause__ is not None
           and id(exc) not in seen):
        seen.add(id(exc))
        exc = exc.__cause__
    return exc


def is_overloaded(exc: BaseException) -> bool:
    return isinstance(unwrap_remote(exc), Overloaded)


def _is_request_error(exc: BaseException) -> bool:
    """Errors the *request* caused — retrying them on a sibling would just
    fail N times (and poison N engines' admission paths)."""
    return isinstance(unwrap_remote(exc), (ValueError, TypeError))


def _is_timeout(exc: BaseException) -> bool:
    """Timeouts — local or raised server-side and shipped back wrapped —
    mean slow, not dead: never grounds for evicting the replica."""
    return isinstance(unwrap_remote(exc), (TimeoutError, cf.TimeoutError))


def decorrelated_backoff(prev_s: float, rng, base_s: float = 0.005,
                         cap_s: float = 0.5) -> float:
    """Next sleep for an Overloaded retry: decorrelated jitter,
    ``min(cap, U(base, 3*prev))``. When a drain momentarily drops capacity
    by one replica, every client sees Overloaded at once; a fixed (or
    deterministic-exponential) schedule has them all resubmit on the same
    tick and re-stampede a fabric that just told them it is full. Jitter
    spreads the retry wave; the 3x term still grows the mean under
    sustained overload. ``rng`` is any object with ``uniform(a, b)``."""
    return min(cap_s, rng.uniform(base_s, max(prev_s, base_s) * 3.0))


@dataclasses.dataclass
class _Replica:
    name: str
    endpoint: str
    client: Any
    load: dict
    inflight: int = 0
    dispatched: int = 0
    # Removed from the routing table while requests are still in flight
    # (TTL eviction of a maybe-just-stalled replica): no new dispatches,
    # but the transport stays open until the last one resolves.
    draining: bool = False
    # Registry-directed drain (rollout taking the replica out for a weight
    # swap): still registered and heartbeating, transport open, but not a
    # dispatch candidate until the mark clears.
    undispatchable: bool = False

    @property
    def version(self) -> Optional[str]:
        v = self.load.get("version")
        return None if v is None else str(v)

    def budget(self, queue_slack: Optional[int]) -> int:
        slots = int(self.load.get("num_slots", 8)) or 8
        slack = slots if queue_slack is None else queue_slack
        return slots + slack

    def score(self) -> float:
        # Local in-flight is exact and fresh; the reported queue/free pair
        # is at most one heartbeat old and carries other routers' traffic.
        # A paged engine's row count overstates its headroom when the page
        # pool is the binding constraint: cap "free" at the number of
        # expected-size requests the remaining pages can hold.
        free = float(self.load.get("free_slots", 0))
        if "free_pages" in self.load:
            ppr = max(float(self.load.get("pages_per_request_ewma") or 0.0),
                      1.0)
            free = min(free, float(self.load.get("free_pages", 0)) / ppr)
        return (self.inflight
                + float(self.load.get("queue_depth", 0))
                - free)


class Router:
    """Admission front for a replicated serve fabric.

    ``registry`` is a handle/client for (or direct reference to) a
    :class:`~repro_torch.core.discovery.Registry`. ``client_factory`` builds a
    courier client from an endpoint (defaults to
    :func:`repro_torch.core.courier.client_for`; tests inject fakes).
    """

    def __init__(self, registry: Any, *, refresh_s: float = 0.25,
                 max_retries: int = 2, queue_slack: Optional[int] = None,
                 startup_wait_s: float = 15.0,
                 request_timeout_s: float = 120.0,
                 coalesce: bool = True,
                 client_factory: Optional[Callable[[str], Any]] = None):
        self._registry = registry
        self._refresh_s = refresh_s
        self._max_retries = max_retries
        self._queue_slack = queue_slack
        self._startup_wait = startup_wait_s
        self._timeout = request_timeout_s
        self._coalesce = coalesce
        self._client_factory = client_factory or courier.client_for

        self._lock = threading.Lock()
        self._node = telemetry.node_name()
        self._replicas: dict[str, _Replica] = {}
        self._draining: list[_Replica] = []
        self._generation = -1
        self._closed = threading.Event()
        self._ctx_stop = get_current_context().stop_event
        self._counters = dict(submitted=0, completed=0, retries=0,
                              failovers=0, overloaded=0, request_errors=0,
                              refreshes=0, dispatches=0, frames=0,
                              coalesced_calls=0, dispatch_us_sum=0.0)
        self._first_failover_done_s: Optional[float] = None
        # Canary routing: (version, fraction) plus a fractional
        # accumulator that meters out exactly `fraction` of requests to
        # the canary version, deterministically (no sampling noise in the
        # comparison rows). Per-version completion/latency/error rows use
        # the same namespacing idea as the Meter's per_source percentiles.
        self._canary: Optional[tuple[str, float]] = None
        self._canary_acc = 0.0
        self._per_version: dict[str, dict] = {}

        # Coalesced-dispatch state: (replica, call, caller future) triples
        # park here until the dispatcher thread drains them into
        # per-replica batch_call frames.
        self._pending_cv = threading.Condition(self._lock)
        self._pending_calls: collections.deque = collections.deque()
        self._dispatcher: Optional[threading.Thread] = None
        if coalesce:
            self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                                daemon=True,
                                                name="router-dispatch")
            self._dispatcher.start()

        self._refresh()                            # best-effort initial view
        self._thread = threading.Thread(target=self._refresh_loop,
                                        daemon=True, name="router-refresh")
        self._thread.start()

    # -- membership ----------------------------------------------------------
    def _refresh_loop(self) -> None:
        while not (self._closed.is_set() or self._ctx_stop.is_set()):
            self._closed.wait(self._refresh_s)
            if self._closed.is_set() or self._ctx_stop.is_set():
                return
            self._refresh()

    def _refresh(self) -> None:
        try:
            view = self._registry.lookup()
        except Exception:  # noqa: BLE001 - registry down: keep last view
            return
        live = {r["name"]: r for r in view["replicas"]}
        to_close, missing = [], []
        with self._lock:
            self._counters["refreshes"] += 1
            self._generation = view["generation"]
            for name in list(self._replicas):
                if name not in live:
                    rep = self._replicas.pop(name)
                    if rep.inflight > 0:
                        # TTL eviction may just mean stalled: closing the
                        # transport now would abort the in-flight requests
                        # of a replica that is still serving them. Stop
                        # dispatching; the last release closes it.
                        rep.draining = True
                        self._draining.append(rep)
                    else:
                        to_close.append(rep)
            for name, info in live.items():
                rep = self._replicas.get(name)
                if rep is None:
                    missing.append(info)
                else:
                    rep.load = dict(info["load"])
                    rep.undispatchable = bool(info.get("draining", False))
        # Client construction does connect I/O (shm rendezvous probe, gRPC
        # channel) — never under the dispatch lock.
        built = []
        for info in missing:
            try:
                built.append(_Replica(
                    name=info["name"], endpoint=info["endpoint"],
                    client=self._client_factory(info["endpoint"]),
                    load=dict(info["load"]),
                    undispatchable=bool(info.get("draining", False))))
            except Exception:  # noqa: BLE001 - endpoint unreachable
                continue
        with self._lock:
            for rep in built:
                if rep.name in self._replicas:   # lost a refresh race
                    to_close.append(rep)
                else:
                    self._replicas[rep.name] = rep
        for rep in to_close:
            self._close_client(rep)

    @staticmethod
    def _close_client(rep: _Replica) -> None:
        close = getattr(rep.client, "close", None)
        if callable(close):
            try:
                close()
            except Exception:  # noqa: BLE001 - already-dead transport
                pass

    def _drop_replica(self, rep: _Replica) -> None:
        """A dispatch observed ``rep`` failing: drop it locally and evict
        it registry-wide so siblings stop picking it too. A live replica
        re-registers on its next heartbeat.

        Dropped by *identity*, not name: if the failure came from an old
        (drained) incarnation while a recovered replica already
        re-registered under the same name, the fresh entry — and its
        in-flight requests — must survive the stale error."""
        superseded = False
        with self._lock:
            cur = self._replicas.get(rep.name)
            if cur is rep:
                self._replicas.pop(rep.name)
            else:
                superseded = cur is not None
            if rep.draining:
                if rep in self._draining:   # _release may have beaten us
                    self._draining.remove(rep)
                rep.draining = False        # this close is the final one
        self._close_client(rep)
        if superseded:
            return
        telemetry.record_event("replica_dropped",
                               cause="dispatch observed a replica error",
                               node=self._node, replica=rep.name)
        try:
            self._registry.report_failure(rep.name)
        except Exception:  # noqa: BLE001 - registry down: TTL will evict
            pass

    # -- canary routing ------------------------------------------------------
    def set_canary(self, version: Optional[Any],
                   fraction: float = 0.0) -> None:
        """Pin ``fraction`` of requests to replicas serving ``version``
        (and steer the remainder away from it, so the per-version rows
        compare clean populations). ``set_canary(None)`` clears."""
        with self._lock:
            if version is None or fraction <= 0:
                self._canary = None
            else:
                self._canary = (str(version), min(float(fraction), 1.0))
            self._canary_acc = 0.0

    def _want_version(self) -> tuple[Optional[str], Optional[str]]:
        """(want, avoid) version preference for one request under the
        current canary split. Caller holds the lock."""
        if self._canary is None:
            return None, None
        version, fraction = self._canary
        self._canary_acc += fraction
        if self._canary_acc >= 1.0:
            self._canary_acc -= 1.0
            return version, None
        return None, version

    def _version_row(self, version: Optional[str]) -> dict:
        """Per-version accounting row. Caller holds the lock."""
        key = version if version is not None else "unversioned"
        row = self._per_version.get(key)
        if row is None:
            row = {"completed": 0, "errors": 0, "lat_sum_s": 0.0,
                   "tokens": 0, "lats": collections.deque(maxlen=512)}
            self._per_version[key] = row
        return row

    # -- dispatch ------------------------------------------------------------
    def _pick(self, exclude: set[str]) -> Optional[_Replica]:
        """Least-loaded healthy replica under budget, or None. Raises
        Overloaded when replicas exist but every one is at budget.
        Registry-draining replicas are not candidates and do not count
        toward the budget check (a drain is planned capacity loss, not
        congestion)."""
        with self._lock:
            candidates = [r for name, r in self._replicas.items()
                          if name not in exclude and not r.undispatchable]
            if not candidates:
                return None
            admissible = [r for r in candidates
                          if r.inflight < r.budget(self._queue_slack)]
            if not admissible:
                self._counters["overloaded"] += 1
                telemetry.record_event(
                    "overloaded", cause="all replicas at admission budget",
                    node=self._node, replicas=len(candidates))
                raise Overloaded(
                    f"all {len(candidates)} replicas at admission budget "
                    f"(in-flight {[r.inflight for r in candidates]})")
            want, avoid = self._want_version()
            if want is not None:
                preferred = [r for r in admissible if r.version == want]
            elif avoid is not None:
                preferred = [r for r in admissible if r.version != avoid]
            else:
                preferred = admissible
            # Preference, not a wall: an empty preferred set (canary
            # draining, dead, or not up yet) falls back to anything
            # admissible rather than failing the request.
            if preferred:
                admissible = preferred
            # Ties go to the replica dispatched least: equal scores
            # round-robin instead of pinning to dict order.
            best = min(admissible, key=lambda r: (r.score(), r.dispatched))
            best.inflight += 1
            best.dispatched += 1
            return best

    def _release(self, rep: _Replica) -> None:
        with self._lock:
            rep.inflight -= 1
            drained = rep.draining and rep.inflight <= 0
            if drained:
                if rep in self._draining:   # close() may have beaten us
                    self._draining.remove(rep)
                rep.draining = False
        if drained:
            self._close_client(rep)

    # -- coalesced dispatch --------------------------------------------------
    def _enqueue(self, rep: _Replica, method: str, args: tuple,
                 kwargs: dict) -> cf.Future:
        """Park one call for the dispatcher; returns the caller's future.
        The dispatcher packs every call bound for the same replica that is
        pending at drain time into one ``batch_call`` frame.

        Trace propagation happens HERE, on the caller's handler thread —
        the dispatcher thread has no request context. The envelope's
        context is parented under a pre-minted ``dispatch`` span id, so
        engine-side spans nest under the dispatch that carried them; the
        span itself is recorded when the frame COMPLETES, covering
        send -> results-back (the replica-side spans nest inside it;
        the serialize+send share rides along as ``send_us``)."""
        fut: cf.Future = cf.Future()
        ctx = telemetry.current_context()
        sid = None
        if ctx is not None and ctx.sampled:
            sid = telemetry.new_span_id()
            kwargs = dict(kwargs)
            kwargs[telemetry.TRACE_KEY] = ctx.child(sid).to_wire()
        with self._pending_cv:
            self._pending_calls.append(
                (rep, (method, args, kwargs), fut, ctx, sid))
            self._pending_cv.notify()
        return fut

    def _dispatch_loop(self) -> None:
        while True:
            with self._pending_cv:
                while (not self._pending_calls
                       and not (self._closed.is_set()
                                or self._ctx_stop.is_set())):
                    self._pending_cv.wait(timeout=0.5)
                items = list(self._pending_calls)
                self._pending_calls.clear()
                stopping = self._closed.is_set() or self._ctx_stop.is_set()
            if stopping and not items:
                return
            # Group by replica identity: one frame per replica per drain.
            # Anything that arrived while the previous frames were being
            # serialized/sent leaves in the NEXT drain — that lag is the
            # whole coalescing window, so an idle router adds no latency.
            groups: dict[int, tuple[_Replica, list, list, list]] = {}
            for rep, call, fut, ctx, sid in items:
                key = id(rep)
                if key not in groups:
                    groups[key] = (rep, [], [], [])
                groups[key][1].append(call)
                groups[key][2].append(fut)
                groups[key][3].append((ctx, sid))
            for rep, calls, futs, traces in groups.values():
                self._send_frame(rep, calls, futs, traces)
            if stopping:
                return

    def _send_frame(self, rep: _Replica, calls: list, futs: list,
                    traces: Optional[list] = None) -> None:
        t0w = time.time()
        t0 = time.perf_counter()
        try:
            frame = rep.client.futures.batch_call(calls)
        except BaseException as exc:  # noqa: BLE001 - transport refused
            if traces:
                dur = time.perf_counter() - t0
                for ctx, sid in traces:
                    if sid is not None:
                        telemetry.record_span(
                            "dispatch", ctx, t0w, dur, span_id=sid,
                            node=self._node, replica=rep.name,
                            frame_calls=len(calls), error=repr(exc))
            for fut in futs:
                if not fut.set_running_or_notify_cancel():
                    continue
                fut.set_exception(exc)
            return
        # Counter accounting stays SEND cost (the router-added overhead
        # number the bench reports); the dispatch SPAN below covers the
        # full send -> results-back window so the trace timeline has no
        # hole while the frame is in flight on the replica.
        us = (time.perf_counter() - t0) * 1e6
        with self._lock:
            self._counters["frames"] += 1
            self._counters["dispatches"] += len(calls)
            self._counters["dispatch_us_sum"] += us
            if len(calls) > 1:
                self._counters["coalesced_calls"] += len(calls)

        def _fan(f: cf.Future) -> None:
            if traces:
                dur = time.perf_counter() - t0
                for ctx, sid in traces:
                    if sid is not None:
                        telemetry.record_span(
                            "dispatch", ctx, t0w, dur, span_id=sid,
                            node=self._node, replica=rep.name,
                            frame_calls=len(calls), send_us=us)
            try:
                results = f.result()
            except BaseException as exc:  # noqa: BLE001 - frame died whole
                results = [exc] * len(futs)
            for fut, res in zip(futs, results):
                if not fut.set_running_or_notify_cancel():
                    continue                    # caller already cancelled
                try:
                    if isinstance(res, BaseException):
                        fut.set_exception(res)
                    else:
                        fut.set_result(res)
                except cf.InvalidStateError:    # cancel raced the fan-out
                    pass

        frame.add_done_callback(_fan)

    def submit(self, prompt, max_new: Optional[int] = None):
        """Serve one request: returns the completed [S + n_generated]
        sequence, transparently failing over if the serving replica dies
        mid-decode. Raises :class:`Overloaded` when the fabric is full."""
        with self._lock:
            self._counters["submitted"] += 1
        t_req = time.monotonic()
        deadline = time.monotonic() + self._startup_wait
        tried: set[str] = set()
        attempts = 0
        failed_over = False
        last_exc: Optional[BaseException] = None
        # Trace context rides in on this RPC handler thread (activated by
        # the courier server); queue/dispatch spans are recorded per
        # attempt so a failover's extra hops stay visible in the timeline.
        tctx = telemetry.current_context()
        tracing = tctx is not None and tctx.sampled
        pick_t0w = pick_t0 = None
        while attempts <= self._max_retries:
            # Dispatch accounting starts per attempt: waits (startup
            # grace, a timed-out prior attempt) are not dispatch cost.
            if pick_t0 is None:
                pick_t0w, pick_t0 = time.time(), time.perf_counter()
            t0 = time.perf_counter()
            rep = self._pick(tried)
            if rep is None:
                if tried:
                    # Every replica left was tried and dropped: the fabric
                    # has no healthy replica *right now* — a retry-later
                    # condition (a stalled-but-live replica re-registers
                    # on its next beat), not this request's failure.
                    with self._lock:
                        self._counters["overloaded"] += 1
                    raise Overloaded(
                        f"no healthy replica left after {attempts} "
                        "attempts") from last_exc
                if time.monotonic() >= deadline:
                    with self._lock:
                        self._counters["overloaded"] += 1
                    raise Overloaded("no live replicas in the registry")
                # Launch is asynchronous: replicas may still be coming up.
                self._closed.wait(0.05)
                self._refresh()
                continue
            attempts += 1
            if tracing:
                # The queue/pick wait — including any waiting-for-replicas
                # iterations since the last dispatch attempt.
                telemetry.record_span(
                    "queue", tctx, pick_t0w,
                    time.perf_counter() - pick_t0, node=self._node,
                    replica=rep.name, attempt=attempts)
            pick_t0w = pick_t0 = None
            kwargs = {} if max_new is None else {"max_new": max_new}
            if self._coalesce:
                # Enqueue-only: the dispatcher thread owns the transport
                # send and the frame-level dispatch accounting. A dispatch
                # failure surfaces through the future and feeds the same
                # failover classification below.
                fut = self._enqueue(rep, "generate", (prompt,), kwargs)
            else:
                sid = None
                if tracing:
                    sid = telemetry.new_span_id()
                    kwargs = dict(kwargs)
                    kwargs[telemetry.TRACE_KEY] = \
                        tctx.child(sid).to_wire()
                d0w = time.time()
                try:
                    fut = rep.client.futures.generate(prompt, **kwargs)
                except BaseException as exc:  # noqa: BLE001 - dispatch failed
                    if sid is not None:
                        telemetry.record_span(
                            "dispatch", tctx, d0w,
                            time.perf_counter() - t0, span_id=sid,
                            node=self._node, replica=rep.name,
                            frame_calls=1, error=repr(exc))
                    self._release(rep)
                    last_exc = exc
                    tried.add(rep.name)
                    self._drop_replica(rep)
                    failed_over = True
                    with self._lock:
                        self._counters["retries"] += 1
                        self._counters["failovers"] += 1
                        self._version_row(rep.version)["errors"] += 1
                    continue
                if sid is not None:
                    # Span recorded at frame completion (send ->
                    # results-back), same window as the coalesced path;
                    # counters below keep the send-cost-only number.
                    send_us = (time.perf_counter() - t0) * 1e6

                    def _rec(f, _sid=sid, _d0w=d0w, _t0=t0, _rep=rep,
                             _send_us=send_us):
                        telemetry.record_span(
                            "dispatch", tctx, _d0w,
                            time.perf_counter() - _t0, span_id=_sid,
                            node=self._node, replica=_rep.name,
                            frame_calls=1, send_us=_send_us)
                    fut.add_done_callback(_rec)
                with self._lock:
                    self._counters["dispatches"] += 1
                    self._counters["frames"] += 1
                    self._counters["dispatch_us_sum"] += \
                        (time.perf_counter() - t0) * 1e6
            try:
                out = fut.result(timeout=self._timeout)
            except cf.TimeoutError as exc:
                # Slow is not dead: exclude the replica for this request
                # but let heartbeat TTL decide whether it leaves the set.
                fut.cancel()
                self._release(rep)
                last_exc = exc
                tried.add(rep.name)
                with self._lock:
                    self._counters["retries"] += 1
                continue
            except BaseException as exc:  # noqa: BLE001
                self._release(rep)
                if _is_request_error(exc):
                    with self._lock:
                        self._counters["request_errors"] += 1
                    # Deliver the service's own exception, not the batch
                    # envelope: per-call inproc dispatch raises originals,
                    # and coalesced frames must look the same to callers.
                    raise unwrap_remote(exc) from exc
                last_exc = exc
                tried.add(rep.name)
                if _is_timeout(exc):
                    # A *server-side* timeout arrives wrapped in the
                    # courier envelope: same policy as the local one
                    # above — exclude for this request, don't evict.
                    with self._lock:
                        self._counters["retries"] += 1
                    continue
                self._drop_replica(rep)
                failed_over = True
                with self._lock:
                    self._counters["retries"] += 1
                    self._counters["failovers"] += 1
                    self._version_row(rep.version)["errors"] += 1
                continue
            self._release(rep)
            r0w, r0 = time.time(), time.perf_counter()
            # Generated-token count, when the reply looks like a sequence
            # ([S + n_generated] vs the [S] prompt) — powers the
            # per-version us/token comparison the canary verdict reads.
            try:
                gen_tokens = max(len(out) - len(prompt), 1)
            except TypeError:
                gen_tokens = 1
            if tracing:
                # Router-side reply handling (fan-out + accounting); the
                # serialization half is recorded server-side on the
                # replica for non-inproc transports.
                telemetry.record_span("reply", tctx, r0w,
                                      time.perf_counter() - r0,
                                      node=self._node, replica=rep.name)
            with self._lock:
                self._counters["completed"] += 1
                row = self._version_row(rep.version)
                row["completed"] += 1
                lat = time.monotonic() - t_req
                row["lat_sum_s"] += lat
                row["tokens"] += gen_tokens
                row["lats"].append(lat)
                if failed_over and self._first_failover_done_s is None:
                    # When the first request that had to fail over lands:
                    # the fabric's observable recovery point after a kill.
                    self._first_failover_done_s = time.perf_counter()
            return out
        assert last_exc is not None
        raise last_exc

    # -- introspection -------------------------------------------------------
    def health(self) -> dict:
        with self._lock:
            return {"status": "ok", "replicas": len(self._replicas),
                    "dispatchable": sum(1 for r in self._replicas.values()
                                        if not r.undispatchable),
                    "generation": self._generation}

    def load(self) -> dict:
        with self._lock:
            return {"replicas": len(self._replicas),
                    "inflight": sum(r.inflight
                                    for r in self._replicas.values())}

    def stats(self) -> dict:
        with self._lock:
            s = dict(self._counters)
            s["generation"] = self._generation
            s["first_failover_done_s"] = self._first_failover_done_s
            s["replicas"] = {name: {"endpoint": r.endpoint,
                                    "inflight": r.inflight,
                                    "dispatched": r.dispatched,
                                    "version": r.version,
                                    "draining": r.undispatchable,
                                    "load": dict(r.load)}
                             for name, r in self._replicas.items()}
            s["per_version"] = {}
            for key, row in self._per_version.items():
                lats = sorted(row["lats"])
                n = len(lats)
                s["per_version"][key] = {
                    "completed": row["completed"],
                    "errors": row["errors"],
                    "mean_lat_us": 1e6 * row["lat_sum_s"]
                                   / (row["completed"] or 1),
                    "p50_lat_us": 1e6 * lats[n // 2] if n else 0.0,
                    "p95_lat_us": 1e6 * lats[min(n - 1, int(n * 0.95))]
                                  if n else 0.0,
                    "us_per_token": 1e6 * row["lat_sum_s"]
                                    / (row["tokens"] or 1),
                }
        # Per dispatch *attempt* — the sum accrues once per dispatch (one
        # frame may carry many dispatches, so coalescing shows up here as a
        # lower per-call mean), and a request that failed over contributes
        # each of its attempts.
        s["mean_dispatch_us"] = s.pop("dispatch_us_sum") / (s["dispatches"]
                                                            or 1)
        s["mean_calls_per_frame"] = s["dispatches"] / (s["frames"] or 1)
        return s

    def telemetry(self) -> dict:
        """Standard telemetry scrape: process metrics + drained spans and
        events, with the router's own ``stats()`` and each replica
        client's transport wire counters as the service payload."""
        transports: dict[str, dict] = {}
        with self._lock:
            reps = [(name, r.client) for name, r in self._replicas.items()]
        for name, client in reps:
            tr = getattr(client, "transport", None)
            stats = getattr(tr, "stats", None)
            if callable(stats):
                try:
                    transports[name] = stats()
                except Exception:  # noqa: BLE001 - closing transport
                    pass
        service = self.stats()
        service["transports"] = transports
        return telemetry.telemetry_snapshot(service=service)

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        self._closed.set()
        with self._pending_cv:
            self._pending_cv.notify()
        if self._dispatcher is not None and self._dispatcher.is_alive():
            # The dispatcher drains (and sends) whatever is pending on its
            # way out, so in-flight submits still get replies.
            self._dispatcher.join(timeout=5)
        if self._thread.is_alive():
            self._thread.join(timeout=5)
        with self._lock:
            reps = list(self._replicas.values()) + self._draining
            for rep in reps:
                rep.draining = False    # a late _release must not re-close
            self._replicas.clear()
            self._draining.clear()
        for rep in reps:
            self._close_client(rep)

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()
