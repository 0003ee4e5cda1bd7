"""Service discovery and liveness for replicated nodes (the serve fabric's
control plane, but generic to any replicated service).

Launchpad wires a *static* graph: handles are resolved to endpoints at
launch and never change. A replicated service wants the dual: membership
that moves at runtime — replicas come up, die, and come back — while the
program graph stays a plain node-and-handle picture. The pieces here keep
that shape:

``Registry``
    A passive membership table served as an ordinary ``CourierNode``.
    Replicas ``register(name, endpoint, load)`` and then ``heartbeat``
    periodically, refreshing a TTL and piggybacking a fresh load report
    (free slots, queue depth, EWMA us/token — whatever the service
    measures). Consumers ``lookup()`` the live set. An entry whose beats
    stop is evicted after ``ttl_s`` (checked lazily on every read — no
    background thread to leak). ``report_failure`` lets a *caller* that
    observed a replica failing evict it immediately instead of waiting
    out the TTL; a replica that was wrongly reported re-registers on its
    next beat (``heartbeat`` returns False to tell it to), so a false
    report costs one beat period, not an outage.

``Heartbeater``
    The replica-side loop: register once, then beat every ``period_s``
    with a fresh ``load_fn()`` report, re-registering whenever the
    registry stops recognizing the name (registry restart, TTL eviction
    during a stall, failure report). Runs as a daemon thread; registry
    hiccups are absorbed (the beat that failed is simply missed).

The membership table carries a monotonic ``generation`` that bumps on
every register/evict/deregister, so a polling consumer can skip rebuilding
clients when nothing changed.

Both classes speak duck-typed registries: a ``CourierClient`` for a remote
Registry node, or the ``Registry`` object itself in-process — same calls.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Optional

from repro_torch.core import telemetry


@dataclasses.dataclass
class ReplicaInfo:
    """One live replica, as reported by ``Registry.lookup``."""
    name: str
    endpoint: str
    load: dict
    age_s: float          # seconds since the last heartbeat


class Registry:
    """Membership + liveness table for replicated services.

    Thread-safe; all state is in-memory (the registry is itself a node —
    if it restarts, replicas re-register within one beat because their
    heartbeats come back unrecognized).
    """

    def __init__(self, ttl_s: float = 2.0):
        if ttl_s <= 0:
            raise ValueError("ttl_s must be positive")
        self._ttl = ttl_s
        self._lock = threading.Lock()
        self._entries: dict[str, dict] = {}   # name -> {endpoint, load, beat}
        self._generation = 0
        self._evictions = 0

    # -- replica side --------------------------------------------------------
    def register(self, name: str, endpoint: str,
                 load: Optional[dict] = None) -> int:
        """Add (or refresh) a replica; returns the new generation.

        Registration clears any drain mark: a replica that was evicted and
        came back is dispatchable again (the rollout controller re-derives
        and re-drains if it still wants it out of rotation)."""
        with self._lock:
            self._entries[name] = {"endpoint": endpoint,
                                   "load": dict(load or {}),
                                   "beat": time.monotonic(),
                                   "draining": False}
            self._generation += 1
            return self._generation

    def set_draining(self, name: str, draining: bool) -> bool:
        """Mark a replica undispatchable (or back in rotation) while it
        stays registered and heartbeating — the rollout controller's drain
        primitive. Routers stop picking a draining replica; its in-flight
        requests finish naturally. Returns whether the entry existed."""
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                return False
            if entry.get("draining", False) != bool(draining):
                entry["draining"] = bool(draining)
                self._generation += 1
            return True

    def heartbeat(self, name: str, load: Optional[dict] = None) -> bool:
        """Refresh a replica's TTL (and load report). Returns False when
        the name is unknown — evicted or registry restarted — telling the
        replica to re-register."""
        now = time.monotonic()
        with self._lock:
            self._evict_expired(now)
            entry = self._entries.get(name)
            if entry is None:
                return False
            entry["beat"] = now
            if load is not None:
                entry["load"] = dict(load)
            return True

    def deregister(self, name: str) -> None:
        """Graceful removal (planned shutdown — no TTL wait)."""
        with self._lock:
            if self._entries.pop(name, None) is not None:
                self._generation += 1

    # -- consumer side -------------------------------------------------------
    def lookup(self) -> dict:
        """The live membership: ``{"generation": g, "replicas": [...]}``
        with one ``ReplicaInfo``-shaped dict per live replica."""
        now = time.monotonic()
        with self._lock:
            self._evict_expired(now)
            replicas = [{"name": name, "endpoint": e["endpoint"],
                         "load": dict(e["load"]),
                         "draining": e.get("draining", False),
                         "age_s": now - e["beat"]}
                        for name, e in sorted(self._entries.items())]
            return {"generation": self._generation, "replicas": replicas}

    def version_table(self) -> dict:
        """``{name: {endpoint, version, draining}}`` for every live
        replica — the model version each one reports serving (piggybacked
        on its heartbeat load report). This table is the rollout's single
        source of truth: a controller that restarts mid-rollout re-derives
        exactly where it was from here."""
        now = time.monotonic()
        with self._lock:
            self._evict_expired(now)
            return {name: {"endpoint": e["endpoint"],
                           "version": e["load"].get("version"),
                           "draining": e.get("draining", False)}
                    for name, e in sorted(self._entries.items())}

    def report_failure(self, name: str) -> bool:
        """A caller observed ``name`` failing: evict it now. A live replica
        re-registers on its next beat; a dead one stays gone. Returns
        whether the entry existed."""
        with self._lock:
            if self._entries.pop(name, None) is None:
                return False
            self._generation += 1
            self._evictions += 1
        telemetry.record_event("eviction", cause="caller reported a failure",
                               replica=name)
        return True

    def stats(self) -> dict:
        with self._lock:
            return {"generation": self._generation,
                    "live": len(self._entries),
                    "evictions": self._evictions,
                    "ttl_s": self._ttl}

    def telemetry(self) -> dict:
        """Standard telemetry scrape (the hub collects eviction events —
        with their causes — from here)."""
        return telemetry.telemetry_snapshot(service=self.stats())

    # -- internal ------------------------------------------------------------
    def _evict_expired(self, now: float) -> None:
        # Caller holds the lock. Lazy missed-beat eviction: an entry whose
        # last beat is older than the TTL is dead to every reader, at the
        # same instant, without a sweeper thread.
        dead = [n for n, e in self._entries.items()
                if now - e["beat"] > self._ttl]
        for name in dead:
            del self._entries[name]
            self._generation += 1
            self._evictions += 1
            telemetry.record_event(
                "eviction", cause=f"missed heartbeats for > {self._ttl}s",
                replica=name)


class Heartbeater:
    """Replica-side registration + heartbeat loop (daemon thread).

    ``registry`` is duck-typed (CourierClient or Registry). ``load_fn``
    (optional) is called once per beat and piggybacked onto it, so the
    registry's view of this replica's load is at most one period old.
    ``stop_event`` (optional) lets the owner tie the loop to a node's
    ``WorkerContext.stop_event``; ``stop()`` works either way.
    """

    def __init__(self, registry: Any, name: str, endpoint: str,
                 load_fn: Optional[Callable[[], dict]] = None,
                 period_s: float = 0.5,
                 stop_event: Optional[threading.Event] = None):
        self._registry = registry
        self._name = name
        self._endpoint = endpoint
        self._load_fn = load_fn
        self._period = period_s
        self._stop = stop_event if stop_event is not None else threading.Event()
        self._own_stop = threading.Event()      # stop() without stopping the node
        self._thread: Optional[threading.Thread] = None
        self._beats = 0
        self._misses = 0
        self._pause_until = 0.0

    def pause(self, seconds: float) -> None:
        """Fault hook: skip beats for ``seconds``. To the registry the
        node looks dead (TTL eviction); when beats resume, the next one
        comes back False and the loop re-registers — the full stall →
        evict → revive cycle, injectable on demand."""
        self._pause_until = time.monotonic() + float(seconds)

    def beat_now(self) -> None:
        """One immediate out-of-band beat (fresh ``load_fn`` report) —
        e.g. right after a weight swap, so the registry's version table
        updates without waiting out a period."""
        try:
            if not self._registry.heartbeat(self._name, self._load()):
                self._registry.register(self._name, self._endpoint,
                                        self._load())
            self._beats += 1
        except Exception:  # noqa: BLE001 - registry down: miss this beat
            self._misses += 1

    def _load(self) -> Optional[dict]:
        if self._load_fn is None:
            return None
        try:
            return self._load_fn()
        except Exception:  # noqa: BLE001 - a broken probe must not kill beats
            return None

    def _loop(self) -> None:
        while not (self._stop.is_set() or self._own_stop.is_set()):
            if time.monotonic() < self._pause_until:
                self._own_stop.wait(self._period)
                continue
            try:
                if not self._registry.heartbeat(self._name, self._load()):
                    # Evicted (TTL miss during a stall, a failure report,
                    # or a registry restart): re-introduce ourselves.
                    self._registry.register(self._name, self._endpoint,
                                            self._load())
                self._beats += 1
            except Exception:  # noqa: BLE001 - registry down: miss this beat
                self._misses += 1
            self._own_stop.wait(self._period)

    def start(self) -> "Heartbeater":
        if self._thread is None:
            try:
                self._registry.register(self._name, self._endpoint,
                                        self._load())
            except Exception:  # noqa: BLE001 - loop will register when it's up
                self._misses += 1
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"heartbeat/{self._name}")
            self._thread.start()
        return self

    def stop(self, deregister: bool = True) -> None:
        self._own_stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if deregister:
            try:
                self._registry.deregister(self._name)
            except Exception:  # noqa: BLE001 - registry gone: TTL handles it
                pass

    def stats(self) -> dict:
        return {"beats": self._beats, "misses": self._misses,
                "period_s": self._period}
