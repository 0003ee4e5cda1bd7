"""Fabric-wide telemetry: metrics, cross-node request tracing, collection.

Launchpad's pitch is that a distributed program should be as easy to
*understand* as it is to define. This module is the understanding half:
one dependency-light layer that every node shares, with three pillars.

**Metrics** — a per-process :class:`MetricsRegistry` of counters, gauges
and mergeable log2-bucket histograms. The record path is lock-free:
counters/gauges are single attribute writes (GIL-atomic), histograms are
one ``math.frexp`` plus one preallocated-``int64``-array increment —
cheap enough to live inside the decode loop. Every node exposes the
registry through a ``telemetry()`` RPC alongside its existing ``load()``.

**Tracing** — a per-request :class:`TraceContext` (trace id + span
parent) carried in a ``contextvars`` var and injected into the courier
call envelope as a reserved ``__trace__`` kwarg. Injection happens at the
one client chokepoint (:class:`~repro_torch.core.courier.client.CourierClient`)
and extraction at the two invocation chokepoints (``CourierServer._invoke``
and ``InProcTransport``), so propagation is transport-agnostic by
construction: inproc, shm and gRPC all carry it because it rides the
serialized kwargs. A sampled request yields :func:`span` records for the
full critical path — router queue/dispatch, engine admission wait,
prefill, each fused decode window, reply — landing in a per-process ring
buffer (:class:`SpanBuffer`) that the collector drains.

**Collection** — a :class:`TelemetryHub` node discovers scrape targets
through the ``Registry`` (plus explicit handles for unregistered nodes
like routers), merges metric snapshots **per pid** (thread-launched
fabrics share one process registry — deduping by pid keeps a node's
counters from being summed N times), accumulates drained spans and fabric
events (evictions, drains, swaps, respawns, Overloaded rejections — each
with a cause), and writes a JSON snapshot plus a Chrome trace-event
timeline (:func:`chrome_trace`) loadable in Perfetto.

Timestamps: span ``ts`` is wall-clock ``time.time()`` so spans recorded
in different same-host processes align on one timeline; durations come
from ``perf_counter`` deltas. Cross-host alignment is out of scope (the
shm fabric is same-host anyway).

Overhead budget: an unsampled request pays one contextvar read per
courier hop (~100ns) and nothing else; a sampled request pays ~2us per
span (dict build + deque append). The serve benchmark gates the
telemetry-on arm at <= 1.03x the off arm at the mixed scenario.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import itertools
import json
import math
import os
import sys
import threading
import time
import traceback
from typing import Any, Callable, Iterable, Optional

import numpy as np

# ---- metrics -----------------------------------------------------------------

# Histogram geometry: log2 buckets with 8 sub-buckets per octave (relative
# error <= ~4.5% at the bucket midpoint). frexp exponents [EMIN, EMIN+NEXP)
# cover ~1e-8 .. ~5e10 — microseconds from 10ns to 14 hours.
_SUB = 8
_EMIN = -26
_NEXP = 64
_NBUCKETS = _NEXP * _SUB


class Counter:
    """Monotonic counter. ``inc`` is a single in-place add — no lock (the
    GIL serializes the read-modify-write at the bytecode level closely
    enough for telemetry; we trade perfect atomicity for zero hot-path
    cost)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Mergeable log2-bucket histogram with sub-bucket resolution.

    ``record`` appends to a preallocated int64 array — one ``frexp``, one
    element increment, no locks, no allocation. ``count``/``sum`` are
    exact (so ``mean`` is exact); percentiles are bucket-midpoint
    approximations clamped to the observed [min, max]. Two histograms
    merge by adding their bucket arrays — the collector's roll-up is
    exactly as accurate as any single node's histogram.
    """

    __slots__ = ("name", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, name: str):
        self.name = name
        self.counts = np.zeros(_NBUCKETS, np.int64)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def record(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if v <= 0.0:
            idx = 0
        else:
            m, e = math.frexp(v)            # v = m * 2**e, m in [0.5, 1)
            idx = ((e - _EMIN) << 3) + int((m - 0.5) * 16.0)
            if idx < 0:
                idx = 0
            elif idx >= _NBUCKETS:
                idx = _NBUCKETS - 1
        self.counts[idx] += 1

    @staticmethod
    def _bucket_mid(idx: int) -> float:
        e = (idx >> 3) + _EMIN
        sub = idx & 7
        lo = math.ldexp(1.0, e - 1) * (1.0 + sub / 8.0)
        return lo * (1.0 + 1.0 / 16.0)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100])."""
        if not self.count:
            return 0.0
        rank = max(1, math.ceil(self.count * q / 100.0))
        acc = 0
        for idx in np.nonzero(self.counts)[0]:
            acc += int(self.counts[idx])
            if acc >= rank:
                return min(max(self._bucket_mid(int(idx)), self.vmin),
                           self.vmax)
        return self.vmax

    def reset(self) -> None:
        """Zero in place (owners that scope a window — e.g. a Meter
        claiming a possibly-stale registry histogram — start fresh
        without replacing the object other readers already hold)."""
        self.counts[:] = 0
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def merge(self, other: "Histogram") -> "Histogram":
        self.counts += other.counts
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    def snapshot(self) -> dict:
        nz = np.nonzero(self.counts)[0]
        return {"count": self.count, "sum": self.total,
                "min": self.vmin if self.count else 0.0,
                "max": self.vmax if self.count else 0.0,
                "buckets": {int(i): int(self.counts[i]) for i in nz}}

    @classmethod
    def from_snapshot(cls, name: str, snap: dict) -> "Histogram":
        h = cls(name)
        h.count = int(snap["count"])
        h.total = float(snap["sum"])
        if h.count:
            h.vmin, h.vmax = float(snap["min"]), float(snap["max"])
        for idx, n in snap["buckets"].items():
            h.counts[int(idx)] = int(n)
        return h


def merge_histogram_snapshots(snaps: Iterable[dict],
                              name: str = "merged") -> Histogram:
    out = Histogram(name)
    for snap in snaps:
        out.merge(Histogram.from_snapshot(name, snap))
    return out


class MetricsRegistry:
    """Per-process get-or-create registry of named metrics.

    Creation takes a lock (cold path); recording against a held metric
    object is lock-free. ``snapshot()`` is the ``telemetry()`` RPC's
    metrics payload — JSON-friendly, mergeable downstream.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(name))
        return h

    def snapshot(self) -> dict:
        with self._lock:
            counters = {n: c.value for n, c in self._counters.items()}
            gauges = {n: g.value for n, g in self._gauges.items()}
            hists = {n: h.snapshot() for n, h in self._histograms.items()}
        return {"counters": counters, "gauges": gauges, "histograms": hists}

    def reset(self) -> None:
        """Zero everything (benchmarks: exclude warmup from the window)."""
        with self._lock:
            for c in self._counters.values():
                c.value = 0
            for g in self._gauges.values():
                g.value = 0.0
            for h in self._histograms.values():
                h.counts[:] = 0
                h.count, h.total = 0, 0.0
                h.vmin, h.vmax = math.inf, -math.inf


_metrics = MetricsRegistry()


def metrics() -> MetricsRegistry:
    """The process-wide metrics registry every node records into."""
    return _metrics


def merge_metric_snapshots(snaps: Iterable[dict]) -> dict:
    """Fabric roll-up: counters sum, gauges last-write-wins, histograms
    merge by bucket. Input dicts are ``MetricsRegistry.snapshot()``s."""
    counters: dict[str, int] = {}
    gauges: dict[str, float] = {}
    hists: dict[str, Histogram] = {}
    for snap in snaps:
        for n, v in snap.get("counters", {}).items():
            counters[n] = counters.get(n, 0) + v
        gauges.update(snap.get("gauges", {}))
        for n, h in snap.get("histograms", {}).items():
            if n in hists:
                hists[n].merge(Histogram.from_snapshot(n, h))
            else:
                hists[n] = Histogram.from_snapshot(n, h)
    out_h = {}
    for n, h in hists.items():
        out_h[n] = h.snapshot()
        out_h[n]["p50"] = h.percentile(50)
        out_h[n]["p95"] = h.percentile(95)
        out_h[n]["p99"] = h.percentile(99)
        out_h[n]["mean"] = h.mean
    return {"counters": counters, "gauges": gauges, "histograms": out_h}


# ---- tracing -----------------------------------------------------------------

TRACE_KEY = "__trace__"

_ids = itertools.count(1)
_id_lock = threading.Lock()


def _new_id() -> str:
    with _id_lock:
        n = next(_ids)
    return f"{os.getpid():x}.{n:x}"


@dataclasses.dataclass
class TraceContext:
    """One request's position in its trace: which trace, and which span
    is the parent of anything recorded under this context."""

    trace_id: str
    parent_id: Optional[str] = None
    sampled: bool = True

    def to_wire(self) -> tuple:
        return (self.trace_id, self.parent_id, self.sampled)

    @classmethod
    def from_wire(cls, wire: Any) -> Optional["TraceContext"]:
        try:
            trace_id, parent_id, sampled = wire
            return cls(str(trace_id),
                       None if parent_id is None else str(parent_id),
                       bool(sampled))
        except Exception:  # noqa: BLE001 - malformed envelope: drop trace
            return None

    def child(self, span_id: str) -> "TraceContext":
        return TraceContext(self.trace_id, span_id, self.sampled)


_ctx_var: contextvars.ContextVar[Optional[TraceContext]] = \
    contextvars.ContextVar("repro_trace_ctx", default=None)


def current_context() -> Optional[TraceContext]:
    return _ctx_var.get()


def new_span_id() -> str:
    """Mint a span id up front — for callers that must inject a child
    context into an envelope *before* the span itself is recorded (the
    router pre-parents engine-side spans under its dispatch span)."""
    return _new_id()


def start_trace(sampled: bool = True) -> TraceContext:
    """Mint a fresh trace root context (client submit side). Activate it
    with :func:`activate` (or pass it explicitly to :func:`span`)."""
    return TraceContext(trace_id=_new_id(), parent_id=None, sampled=sampled)


@contextlib.contextmanager
def activate(ctx: Optional[TraceContext]):
    """Install ``ctx`` as the current trace context for the block —
    the server-side half of envelope propagation."""
    token = _ctx_var.set(ctx)
    try:
        yield ctx
    finally:
        _ctx_var.reset(token)


def inject(kwargs: dict) -> dict:
    """Client chokepoint: fold the current sampled trace context into a
    call's kwargs under the reserved ``__trace__`` key. Returns the input
    dict unchanged when there is nothing to propagate."""
    ctx = _ctx_var.get()
    if ctx is None or not ctx.sampled or TRACE_KEY in kwargs:
        return kwargs
    out = dict(kwargs)
    out[TRACE_KEY] = ctx.to_wire()
    return out


def extract(kwargs: dict) -> Optional[TraceContext]:
    """Server chokepoint: pop and decode the trace envelope (mutates
    ``kwargs`` so the service method never sees the reserved key)."""
    wire = kwargs.pop(TRACE_KEY, None)
    if wire is None:
        return None
    return TraceContext.from_wire(wire)


class SpanBuffer:
    """Bounded per-process ring of finished spans. ``append`` rides
    deque's atomic append (no lock); ``drain`` empties via atomic
    poplefts, so a concurrent recorder never blocks on a scrape."""

    def __init__(self, maxlen: int = 8192):
        self._dq: collections.deque = collections.deque(maxlen=maxlen)

    def append(self, item: dict) -> None:
        self._dq.append(item)

    def drain(self) -> list[dict]:
        out = []
        while True:
            try:
                out.append(self._dq.popleft())
            except IndexError:
                return out

    def peek(self) -> list[dict]:
        return list(self._dq)

    def __len__(self) -> int:
        return len(self._dq)


_spans = SpanBuffer()
_events = SpanBuffer(maxlen=2048)

# Fallback node attribution for spans recorded on threads that never got a
# WorkerContext (engine decode loops, dispatcher threads). Services capture
# telemetry.node_name() at construction and pass it explicitly when they
# can; this keeps the default better than "standalone".
_default_node: Optional[str] = None


def set_default_node(name: str) -> None:
    global _default_node
    _default_node = name


def node_name() -> str:
    """Best-effort name of the node this thread serves."""
    from repro_torch.core.nodes.base import _context_local
    ctx = getattr(_context_local, "ctx", None)
    if ctx is not None and ctx.node_name != "standalone":
        return ctx.node_name
    return _default_node or f"pid-{os.getpid()}"


def record_span(name: str, ctx: TraceContext, start_wall: float,
                dur_s: float, node: Optional[str] = None,
                span_id: Optional[str] = None, **attrs) -> str:
    """Append one finished span (explicit-timestamps API, used by the
    engine thread which reconstructs spans after the fact). Returns the
    span id so callers can parent further spans under it."""
    sid = span_id or _new_id()
    _spans.append({"name": name, "trace": ctx.trace_id, "id": sid,
                   "parent": ctx.parent_id, "node": node or node_name(),
                   "ts": start_wall, "dur": dur_s, "attrs": attrs})
    return sid


@contextlib.contextmanager
def span(name: str, ctx: Optional[TraceContext] = None, **attrs):
    """Timed span context manager. No-op (one contextvar read) when the
    request is unsampled. Within the block the current context points at
    this span, so nested spans — including remote ones, via the envelope —
    parent correctly."""
    c = ctx if ctx is not None else _ctx_var.get()
    if c is None or not c.sampled:
        yield None
        return
    sid = _new_id()
    token = _ctx_var.set(c.child(sid))
    t0w = time.time()
    t0 = time.perf_counter()
    mutable_attrs = dict(attrs)
    try:
        yield mutable_attrs
    finally:
        _ctx_var.reset(token)
        record_span(name, c, t0w, time.perf_counter() - t0,
                    span_id=sid, **mutable_attrs)


def record_event(kind: str, cause: str = "", node: Optional[str] = None,
                 **attrs) -> None:
    """One fabric event — an eviction, drain, swap, respawn, Overloaded
    rejection — with its cause. Collected by the hub alongside spans."""
    _events.append({"kind": kind, "cause": cause,
                    "node": node or node_name(), "ts": time.time(),
                    "attrs": attrs})


def spans_buffer() -> SpanBuffer:
    return _spans


def events_buffer() -> SpanBuffer:
    return _events


def telemetry_snapshot(drain: bool = True, service: Optional[dict] = None,
                       **extra) -> dict:
    """The standard ``telemetry()`` RPC payload: process metrics plus the
    drained span/event rings, stamped with the pid so a collector scraping
    N thread-launched nodes in one process merges the shared registry
    once, not N times."""
    snap = {"node": node_name(), "pid": os.getpid(), "time": time.time(),
            "metrics": _metrics.snapshot(),
            "spans": _spans.drain() if drain else _spans.peek(),
            "events": _events.drain() if drain else _events.peek()}
    if service is not None:
        snap["service"] = service
    snap.update(extra)
    return snap


# ---- structured per-node logging --------------------------------------------

_log_lock = threading.Lock()


class NodeLogger:
    """Launchpad-style per-node logger: every line is prefixed with the
    node's name so interleaved output from N workers stays attributable.
    ``exception`` appends the current traceback and records a fabric
    event, so a supervisor respawn has a queryable cause, not just a
    scrolled-away stack."""

    __slots__ = ("node",)

    def __init__(self, node: str):
        self.node = node

    def _emit(self, level: str, msg: str, tb: Optional[str] = None) -> None:
        ts = time.strftime("%H:%M:%S", time.localtime())
        line = f"{ts} [{self.node}] {level}: {msg}"
        if tb:
            line = f"{line}\n{tb.rstrip()}"
        with _log_lock:
            print(line, file=sys.stderr, flush=True)

    def info(self, msg: str, **kv) -> None:
        self._emit("INFO", _fmt(msg, kv))

    def warning(self, msg: str, **kv) -> None:
        self._emit("WARN", _fmt(msg, kv))

    def error(self, msg: str, **kv) -> None:
        self._emit("ERROR", _fmt(msg, kv))
        record_event("error", cause=msg, node=self.node, **kv)

    def exception(self, msg: str, **kv) -> None:
        self._emit("ERROR", _fmt(msg, kv), tb=traceback.format_exc())
        record_event("error", cause=msg, node=self.node, **kv)


def _fmt(msg: str, kv: dict) -> str:
    if not kv:
        return msg
    tail = " ".join(f"{k}={v}" for k, v in kv.items())
    return f"{msg} ({tail})"


def get_logger(node: Optional[str] = None) -> NodeLogger:
    return NodeLogger(node or node_name())


# ---- Chrome trace-event (Perfetto) export ------------------------------------

def chrome_trace(spans: Iterable[dict],
                 events: Iterable[dict] = ()) -> dict:
    """Render spans as a Chrome trace-event JSON object (the ``{"traceEvents":
    [...]}`` form Perfetto and chrome://tracing load directly). Nodes map
    to pids (with ``process_name`` metadata), traces map to tids so one
    request's spans share a row; fabric events become instants."""
    pids: dict[str, int] = {}
    tids: dict[str, int] = {}

    def pid_of(node: str) -> int:
        if node not in pids:
            pids[node] = len(pids) + 1
        return pids[node]

    def tid_of(trace: str) -> int:
        if trace not in tids:
            tids[trace] = len(tids) + 1
        return tids[trace]

    out = []
    for s in spans:
        out.append({"ph": "X", "name": s["name"], "cat": "span",
                    "ts": s["ts"] * 1e6, "dur": max(s["dur"], 1e-7) * 1e6,
                    "pid": pid_of(s["node"]), "tid": tid_of(s["trace"]),
                    "args": {"trace": s["trace"], "id": s["id"],
                             "parent": s["parent"], **s.get("attrs", {})}})
    for e in events:
        out.append({"ph": "i", "name": f"{e['kind']}: {e['cause']}"
                    if e.get("cause") else e["kind"],
                    "cat": "event", "s": "g", "ts": e["ts"] * 1e6,
                    "pid": pid_of(e["node"]), "tid": 0,
                    "args": dict(e.get("attrs", {}))})
    meta = [{"ph": "M", "name": "process_name", "pid": pid,
             "args": {"name": node}} for node, pid in pids.items()]
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def trace_coverage(spans: Iterable[dict], trace_id: str,
                   start_wall: float, dur_s: float) -> float:
    """Fraction of the [start, start+dur] window covered by the union of
    the trace's span intervals — the "does the trace explain every
    microsecond" number the bench gates at >= 0.95. The root span itself
    (covering the whole window by definition) is excluded."""
    if dur_s <= 0:
        return 0.0
    end_wall = start_wall + dur_s
    ivals = []
    for s in spans:
        if s["trace"] != trace_id or s.get("attrs", {}).get("root"):
            continue
        a = max(s["ts"], start_wall)
        b = min(s["ts"] + s["dur"], end_wall)
        if b > a:
            ivals.append((a, b))
    ivals.sort()
    covered, cur_a, cur_b = 0.0, None, None
    for a, b in ivals:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                covered += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        covered += cur_b - cur_a
    return covered / dur_s


# ---- the collector -----------------------------------------------------------

class TelemetryHub:
    """Fabric telemetry collector, run as an ordinary program node.

    Scrape targets come from two places: the ``Registry`` (every replica
    that registers and heartbeats — engines, train workers) and explicit
    ``targets`` handles for nodes that serve couriers but do not register
    (routers, the registry itself). Each scrape calls the target's
    ``telemetry()`` RPC: metric snapshots replace the previous snapshot
    *per pid* (counters are cumulative, and thread-launched fabrics share
    one process registry — last-per-pid is the merge that never double
    counts), while spans and events accumulate.

    ``out_dir`` (optional): on every scrape — and on shutdown — the hub
    writes ``telemetry.json`` (merged snapshot) and ``trace.json``
    (Chrome trace-event timeline, Perfetto-loadable).
    """

    def __init__(self, registry: Any = None, targets: Iterable[Any] = (),
                 poll_s: float = 0.5, out_dir: Optional[str] = None,
                 client_factory: Optional[Callable[[str], Any]] = None):
        from repro_torch.core import courier
        self._registry = registry
        self._targets = list(targets)
        self._poll_s = poll_s
        self._out_dir = out_dir
        self._client_factory = client_factory or courier.client_for
        self._lock = threading.Lock()
        self._clients: dict[str, Any] = {}
        self._by_pid: dict[int, dict] = {}        # pid -> latest metrics
        self._service: dict[str, dict] = {}       # node -> service extras
        self._spans: list[dict] = []
        self._events: list[dict] = []
        self._scrapes = 0
        self._scrape_errors = 0

    # -- scraping ------------------------------------------------------------
    def _registry_clients(self) -> list[tuple[str, Any]]:
        if self._registry is None:
            return []
        try:
            view = self._registry.lookup()
        except Exception:  # noqa: BLE001 - registry down: scrape targets only
            return []
        out = []
        for rep in view["replicas"]:
            ep = rep["endpoint"]
            cli = self._clients.get(ep)
            if cli is None:
                try:
                    cli = self._client_factory(ep)
                except Exception:  # noqa: BLE001 - endpoint unreachable
                    continue
                self._clients[ep] = cli
            out.append((rep["name"], cli))
        return out

    def scrape_once(self) -> int:
        """One collection pass over every reachable target; returns how
        many targets answered."""
        ok = 0
        seen_pids: set[int] = set()
        # Service stats are keyed by a name the HUB derives (replica name
        # from the registry, endpoint for explicit targets): the reply's
        # self-reported node name is whatever thread served the RPC —
        # for in-process couriers that's the hub's own thread, and every
        # target would collapse onto one key.
        pairs = [(getattr(t, "endpoint", None), t) for t in self._targets]
        pairs += self._registry_clients()
        for i, (name, target) in enumerate(pairs):
            try:
                snap = target.telemetry()
            except Exception:  # noqa: BLE001 - dead target: next pass
                with self._lock:
                    self._scrape_errors += 1
                continue
            ok += 1
            pid = int(snap.get("pid", 0))
            with self._lock:
                self._scrapes += 1
                # Same-process targets share one registry snapshot; merge
                # it once per scrape pass. Spans/events were *drained* by
                # whichever sibling's RPC ran first, so accumulation is
                # already dedup'd by construction.
                if pid not in seen_pids:
                    self._by_pid[pid] = snap.get("metrics", {})
                    seen_pids.add(pid)
                self._spans.extend(snap.get("spans", []))
                self._events.extend(snap.get("events", []))
                if "service" in snap:
                    key = name or str(snap.get("node", f"target-{i}"))
                    self._service[key] = snap["service"]
        if self._out_dir:
            self.write(self._out_dir)
        return ok

    # -- views ---------------------------------------------------------------
    def merged_metrics(self) -> dict:
        with self._lock:
            return merge_metric_snapshots(list(self._by_pid.values()))

    def spans(self) -> list[dict]:
        with self._lock:
            return list(self._spans)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def snapshot(self) -> dict:
        """RPC-friendly merged view of everything collected so far."""
        with self._lock:
            spans = list(self._spans)
            events = list(self._events)
            service = {k: dict(v) for k, v in self._service.items()}
            per_pid = list(self._by_pid.values())
            stats = {"scrapes": self._scrapes,
                     "scrape_errors": self._scrape_errors,
                     "processes": len(self._by_pid)}
        return {"merged": merge_metric_snapshots(per_pid),
                "services": service, "spans": spans, "events": events,
                "hub": stats}

    def coverage(self, trace_id: str, start_wall: float,
                 dur_s: float) -> float:
        return trace_coverage(self.spans(), trace_id, start_wall, dur_s)

    # -- export --------------------------------------------------------------
    def write(self, out_dir: str) -> dict[str, str]:
        os.makedirs(out_dir, exist_ok=True)
        snap = self.snapshot()
        spans = snap.pop("spans")
        events = snap["events"]
        snap["span_count"] = len(spans)
        paths = {"snapshot": os.path.join(out_dir, "telemetry.json"),
                 "trace": os.path.join(out_dir, "trace.json")}
        with open(paths["snapshot"], "w") as f:
            json.dump(snap, f, indent=2, default=str)
            f.write("\n")
        with open(paths["trace"], "w") as f:
            json.dump(chrome_trace(spans, events), f)
            f.write("\n")
        return paths

    # -- node protocol -------------------------------------------------------
    def run(self) -> None:
        """Program-node loop: scrape every ``poll_s`` until the program
        stops, then one final scrape + export so shutdown never loses the
        tail of the story."""
        from repro_torch.core.nodes.base import get_current_context
        ctx = get_current_context()
        while not ctx.wait_for_stop(self._poll_s):
            self.scrape_once()
        self.scrape_once()
        self.close()

    def close(self) -> None:
        if self._out_dir:
            with contextlib.suppress(Exception):
                self.write(self._out_dir)
        for cli in self._clients.values():
            with contextlib.suppress(Exception):
                cli.close()
        self._clients.clear()
