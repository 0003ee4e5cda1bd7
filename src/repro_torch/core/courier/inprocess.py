"""In-process service registry (shared-memory fast path).

Paper §4: "the Handle abstraction ... allows us to flexibly choose the most
appropriate client type at launch phase (e.g., to use a shared-memory
channel if the service is allocated on the same physical machine)."

The thread launcher and ColocationNode resolve addresses to
``inproc://<name>`` endpoints backed by this registry. The client side
lives in :class:`repro_torch.core.courier.transport.InProcTransport` (behind the
unified ``CourierClient``); this module only owns the name -> object map
and the shared thread pool that serves ``.futures`` calls.
"""

from __future__ import annotations

import threading
import time
from concurrent import futures
from typing import Any, Optional

_registry: dict[str, Any] = {}
_registry_lock = threading.Lock()
_pool: Optional[futures.ThreadPoolExecutor] = None
_pool_lock = threading.Lock()


def shared_pool() -> futures.ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            # Sized for blocking-handler services (a serve fabric holds one
            # handler thread per in-flight request): a full pool makes a
            # dispatched call wait behind workers blocked on *other*
            # services, which starves an idle replica while its siblings
            # queue. Workers spawn lazily, so the ceiling is cheap.
            _pool = futures.ThreadPoolExecutor(
                max_workers=256, thread_name_prefix="courier-inproc")
        return _pool


def register(name: str, obj: Any) -> None:
    with _registry_lock:
        if name in _registry:
            raise RuntimeError(f"inproc service {name!r} already registered")
        _registry[name] = obj


def unregister(name: str) -> None:
    with _registry_lock:
        _registry.pop(name, None)


def lookup(name: str, timeout_s: float = 10.0) -> Any:
    """Resolve a service, waiting for it to come up (launch is async:
    a client node may start before its server node has registered)."""
    deadline = time.monotonic() + timeout_s
    while True:
        with _registry_lock:
            if name in _registry:
                return _registry[name]
            known = sorted(_registry)
        if time.monotonic() >= deadline:
            raise RuntimeError(
                f"inproc service {name!r} did not come up within "
                f"{timeout_s}s (registered: {known})")
        time.sleep(0.005)


def reset() -> None:
    """Test hook: clear all registered in-process services."""
    with _registry_lock:
        _registry.clear()


def InProcessClient(name: str):
    """Back-compat constructor: the unified client over InProcTransport."""
    from repro_torch.core.courier.client import CourierClient
    return CourierClient(f"inproc://{name}")
