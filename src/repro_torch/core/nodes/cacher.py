"""CacherNode: generic RPC-result caching layer (paper §4.2, §5.1, Fig. 2).

Wraps a handle to any CourierNode and caches RPC results for ``timeout``
seconds — the fan-in mitigation of the parameter-server example: requesters
hit the cacher; the cacher refreshes from the origin only when its copy is
stale, collapsing N requester QPS into ~1/timeout origin QPS.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

from repro_torch.core.addressing import Address
from repro_torch.core.handles import Handle
from repro_torch.core.nodes.base import Node
from repro_torch.core.nodes.python import CourierHandle, _CourierExecutable


class _CacheEntry:
    __slots__ = ("value", "expires_at", "lock")

    def __init__(self):
        self.value = None
        self.expires_at = 0.0
        self.lock = threading.Lock()


class Cacher:
    """The service object behind a CacherNode.

    Exposes ``call(method, *args, **kwargs)`` plus ``__getattr__`` style
    forwarding: any public method name is served from cache when fresh,
    refreshed from the origin otherwise. Per-key locking means a stampede of
    requesters triggers exactly one origin refresh (single-flight).
    """

    def __init__(self, origin, timeout_s: float = 0.1):
        self._origin = origin
        self._timeout_s = float(timeout_s)
        self._entries: dict[Any, _CacheEntry] = {}
        self._entries_lock = threading.Lock()
        self.stats = {"hits": 0, "misses": 0}
        self._stats_lock = threading.Lock()

    def _entry(self, key) -> _CacheEntry:
        with self._entries_lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = self._entries[key] = _CacheEntry()
            return entry

    def call(self, method: str, *args, **kwargs):
        key = (method, args, tuple(sorted(kwargs.items())))
        try:
            hash(key)
        except TypeError:  # unhashable args: pass straight through
            return getattr(self._origin, method)(*args, **kwargs)
        entry = self._entry(key)
        now = time.monotonic()
        if now < entry.expires_at:
            with self._stats_lock:
                self.stats["hits"] += 1
            return entry.value
        with entry.lock:  # single-flight refresh
            now = time.monotonic()
            if now < entry.expires_at:
                with self._stats_lock:
                    self.stats["hits"] += 1
                return entry.value
            value = getattr(self._origin, method)(*args, **kwargs)
            entry.value = value
            entry.expires_at = time.monotonic() + self._timeout_s
            with self._stats_lock:
                self.stats["misses"] += 1
            return value

    def cache_stats(self) -> dict:
        with self._stats_lock:
            return dict(self.stats)

    # Forward arbitrary public method names through the cache so that a
    # cacher handle is a drop-in replacement for the origin handle.
    def __getattr__(self, method: str):
        if method.startswith("_") or method == "run":
            # A cacher is a passive service: never forward the executable's
            # run() probe to the origin.
            raise AttributeError(method)

        def cached_call(*args, **kwargs):
            return self.call(method, *args, **kwargs)

        return cached_call


class CacherNode(Node):
    """Low-level caching node wrapping any CourierNode handle (paper §4.2)."""

    def __init__(self, origin: Handle, timeout_s: float = 0.1):
        super().__init__(name="Cacher")
        self._origin = origin
        self._timeout_s = timeout_s
        self.input_handles = [origin]
        self._address = Address("cacher")

    def addresses(self):
        return (self._address,)

    def create_handle(self) -> Handle:
        h = CourierHandle(self._address)
        self._created_handles.append(h)
        return h

    def to_executables(self, requirements=None, launch_type="thread"):
        return [_CourierExecutable(self.name, Cacher, (self._origin,),
                                   {"timeout_s": self._timeout_s},
                                   self._address)]
