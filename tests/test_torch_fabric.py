"""The port's serve-fabric control plane: registry membership and
liveness, least-loaded routing, mid-request failover, backpressure and
router re-discovery — ``tests/test_fabric.py``'s cases against
``repro_torch``'s Registry, Heartbeater and Router over the port's inproc
courier transport, with the same fake replicas (no model). The fabric
with real engines runs in ``tests/test_torch_serve_fabric.py``.
"""

import threading
import time
import uuid

import numpy as np
import pytest

from repro_torch.core import courier
from repro_torch.core.discovery import Heartbeater, Registry
from repro_torch.serve.router import Overloaded, Router, is_overloaded


@pytest.fixture(autouse=True)
def _reset_port_inproc_registry():
    """Each test gets a clean in-process courier registry (the port's)."""
    courier.inprocess.reset()
    yield
    courier.inprocess.reset()


class FakeReplica:
    """EngineServer-shaped service: generate/load/health, controllable."""

    def __init__(self, block: threading.Event = None,
                 fail_with: BaseException = None, num_slots: int = 8):
        self.block = block
        self.fail_with = fail_with
        self.num_slots = num_slots
        self.calls = 0

    def generate(self, prompt, max_new=None):
        self.calls += 1
        if self.fail_with is not None:
            raise self.fail_with
        if self.block is not None:
            assert self.block.wait(timeout=30)
        return np.concatenate([np.asarray(prompt, np.int32), [7]])

    def load(self):
        return {"num_slots": self.num_slots, "free_slots": self.num_slots,
                "queue_depth": 0, "ewma_us_per_token": 100.0}

    def health(self):
        return {"status": "ok"}


@pytest.fixture
def fabric():
    """A Registry plus a factory that registers fake replicas over the
    real inproc courier transport; everything unregisters on teardown."""
    registry = Registry(ttl_s=5.0)
    names = []

    def add(replica, load=None, name=None):
        name = name or f"rep-{uuid.uuid4().hex[:8]}"
        courier.inprocess.register(name, replica)
        names.append(name)
        registry.register(name, f"inproc://{name}",
                          load if load is not None else replica.load())
        return name

    yield registry, add
    for name in names:
        courier.inprocess.unregister(name)


def make_router(registry, **kw):
    kw.setdefault("refresh_s", 0.05)
    kw.setdefault("startup_wait_s", 2.0)
    return Router(registry, **kw)


# -- registry ----------------------------------------------------------------

def test_registry_missed_beats_evict():
    # Generous TTL-vs-sleep margins: a loaded host oversleeping must not
    # age 'a' past the TTL between its beats.
    reg = Registry(ttl_s=0.6)
    reg.register("a", "inproc://a")
    reg.register("b", "inproc://b")
    assert [r["name"] for r in reg.lookup()["replicas"]] == ["a", "b"]
    g0 = reg.lookup()["generation"]
    time.sleep(0.4)
    assert reg.heartbeat("a")                     # refresh a only
    time.sleep(0.4)                               # b's last beat is now stale
    view = reg.lookup()
    assert [r["name"] for r in view["replicas"]] == ["a"]
    assert view["generation"] > g0                # eviction bumped it
    assert not reg.heartbeat("b")                 # evicted: told to re-register
    reg.register("b", "inproc://b")
    assert len(reg.lookup()["replicas"]) == 2


def test_registry_report_failure_and_recover():
    reg = Registry(ttl_s=5.0)
    reg.register("a", "inproc://a")
    assert reg.report_failure("a")
    assert reg.lookup()["replicas"] == []
    assert not reg.report_failure("a")            # already gone
    assert not reg.heartbeat("a")                 # live replica re-registers:
    reg.register("a", "inproc://a")
    assert [r["name"] for r in reg.lookup()["replicas"]] == ["a"]


def test_registry_heartbeat_carries_load():
    reg = Registry(ttl_s=5.0)
    reg.register("a", "inproc://a", {"free_slots": 1})
    reg.heartbeat("a", {"free_slots": 7})
    (rep,) = reg.lookup()["replicas"]
    assert rep["load"]["free_slots"] == 7
    assert rep["age_s"] < 1.0


def test_heartbeater_keeps_alive_and_reregisters():
    reg = Registry(ttl_s=0.3)
    hb = Heartbeater(reg, "x", "inproc://x", period_s=0.05,
                     load_fn=lambda: {"free_slots": 3}).start()
    try:
        time.sleep(0.6)                           # several TTLs: still live
        (rep,) = reg.lookup()["replicas"]
        assert rep["load"]["free_slots"] == 3
        reg.report_failure("x")                   # wrongly reported...
        time.sleep(0.2)                           # ...re-registers in a beat
        assert [r["name"] for r in reg.lookup()["replicas"]] == ["x"]
    finally:
        hb.stop()
    assert reg.lookup()["replicas"] == []         # graceful deregistration


# -- routing -----------------------------------------------------------------

def test_router_routes_to_least_loaded(fabric):
    registry, add = fabric
    busy, idle = FakeReplica(), FakeReplica()
    add(busy, load={"num_slots": 8, "free_slots": 0, "queue_depth": 6})
    add(idle, load={"num_slots": 8, "free_slots": 8, "queue_depth": 0})
    with make_router(registry) as router:
        for _ in range(4):
            out = router.submit(np.arange(3, dtype=np.int32))
            assert out[-1] == 7
    assert idle.calls == 4 and busy.calls == 0


def test_router_spreads_ties_by_inflight(fabric):
    """Between heartbeats the router's own in-flight counts dominate:
    equal reported loads must not pin every request to one replica."""
    registry, add = fabric
    gate = threading.Event()
    a, b = FakeReplica(block=gate), FakeReplica(block=gate)
    add(a)
    add(b)
    with make_router(registry) as router:
        futs = [courier.inprocess.shared_pool().submit(
            router.submit, np.arange(2, dtype=np.int32)) for _ in range(6)]
        deadline = time.monotonic() + 5
        while a.calls + b.calls < 6 and time.monotonic() < deadline:
            time.sleep(0.01)
        gate.set()
        for f in futs:
            f.result(timeout=30)
    assert a.calls == 3 and b.calls == 3


def test_router_failover_onto_sibling_zero_lost(fabric):
    """A replica dying mid-request (RPC raises) is retried on a sibling
    and evicted registry-wide; the caller never sees the failure."""
    registry, add = fabric
    dead = FakeReplica(fail_with=RuntimeError("engine stopped"))
    live = FakeReplica()
    # The dead replica advertises the *better* load, so it is picked first.
    dead_name = add(dead, load={"num_slots": 8, "free_slots": 8,
                                "queue_depth": 0})
    add(live, load={"num_slots": 8, "free_slots": 2, "queue_depth": 3})
    with make_router(registry) as router:
        outs = [router.submit(np.arange(4, dtype=np.int32))
                for _ in range(5)]
        stats = router.stats()
    assert all(o[-1] == 7 for o in outs)          # zero lost
    assert dead.calls >= 1 and live.calls == 5
    assert stats["failovers"] >= 1
    assert stats["first_failover_done_s"] is not None   # recovery marker
    names = [r["name"] for r in registry.lookup()["replicas"]]
    assert dead_name not in names                 # evicted for everyone


def test_router_request_errors_are_not_retried(fabric):
    registry, add = fabric
    rep = FakeReplica(fail_with=ValueError("prompt too long"))
    name = add(rep)
    with make_router(registry) as router:
        with pytest.raises(ValueError, match="too long"):
            router.submit(np.arange(4, dtype=np.int32))
        assert router.stats()["request_errors"] == 1
    assert rep.calls == 1                         # exactly one attempt
    names = [r["name"] for r in registry.lookup()["replicas"]]
    assert name in names                          # the replica is healthy


def test_router_overloaded_when_all_queues_full(fabric):
    registry, add = fabric
    gate = threading.Event()
    rep = FakeReplica(block=gate, num_slots=1)
    add(rep, load={"num_slots": 1, "free_slots": 1, "queue_depth": 0})
    with make_router(registry) as router:
        # budget = num_slots + queue slack = 2: fill it with blocked calls.
        futs = [courier.inprocess.shared_pool().submit(
            router.submit, np.arange(2, dtype=np.int32)) for _ in range(2)]
        deadline = time.monotonic() + 5
        while router.load()["inflight"] < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(Overloaded):
            router.submit(np.arange(2, dtype=np.int32))
        try:
            raise Overloaded("x")
        except Overloaded as exc:
            assert is_overloaded(exc)
        gate.set()
        for f in futs:                            # the admitted ones finish
            assert f.result(timeout=30)[-1] == 7
        assert router.stats()["overloaded"] >= 1


def test_router_server_side_timeout_excludes_without_evicting(fabric):
    """A timeout shipped back wrapped in the courier envelope means slow,
    not dead: the request retries a sibling, but the slow replica stays
    registered (the module's 'slow is not dead' policy)."""
    from concurrent import futures as cf
    from repro_torch.core.courier.serialization import RemoteError
    registry, add = fabric
    wrapped = RemoteError("remote call failed:\n...")
    wrapped.__cause__ = cf.TimeoutError()
    slow = FakeReplica(fail_with=wrapped)
    fast = FakeReplica()
    slow_name = add(slow, load={"num_slots": 8, "free_slots": 8,
                                "queue_depth": 0})
    add(fast, load={"num_slots": 8, "free_slots": 2, "queue_depth": 3})
    with make_router(registry) as router:
        out = router.submit(np.arange(3, dtype=np.int32))
        stats = router.stats()
    assert out[-1] == 7
    assert stats["retries"] == 1 and stats["failovers"] == 0
    names = [r["name"] for r in registry.lookup()["replicas"]]
    assert slow_name in names                     # never evicted


def test_router_ttl_eviction_drains_inflight(fabric):
    """A replica that drops out of the registry mid-request (TTL
    eviction of a stalled-but-live node) must not have its transport
    closed under the in-flight request: the router drains it — no new
    dispatches, close deferred to the last release."""
    registry, add = fabric
    gate = threading.Event()
    rep = FakeReplica(block=gate)
    name = add(rep)
    closed = []

    def factory(endpoint):
        client = courier.client_for(endpoint)

        class Recorder:
            futures = client.futures

            def close(self):
                closed.append(endpoint)
                client.close()
        return Recorder()

    with make_router(registry, client_factory=factory,
                     refresh_s=0.05) as router:
        fut = courier.inprocess.shared_pool().submit(
            router.submit, np.arange(2, dtype=np.int32))
        deadline = time.monotonic() + 5
        while rep.calls < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        registry.report_failure(name)             # TTL-style eviction
        deadline = time.monotonic() + 5
        while router.health()["replicas"] > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert closed == []                       # in flight: not closed
        gate.set()
        assert fut.result(timeout=30)[-1] == 7    # request unharmed
        deadline = time.monotonic() + 5
        while not closed and time.monotonic() < deadline:
            time.sleep(0.01)
        assert closed                             # drained -> closed


def test_router_stale_incarnation_failure_spares_reregistered(fabric):
    """A failure surfacing from an old, drained incarnation must not
    evict (or close the client of) the healthy replica that re-registered
    under the same name in the meantime."""
    registry, add = fabric
    gate = threading.Event()

    class Flaky(FakeReplica):
        def generate(self, prompt, max_new=None):
            self.calls += 1
            if self.calls == 1:               # the in-flight "old" call
                assert gate.wait(timeout=30)
                raise RuntimeError("engine stopped")
            return super().generate(prompt, max_new)

    rep = Flaky()
    name = add(rep)
    with make_router(registry, refresh_s=0.05) as router:
        fut = courier.inprocess.shared_pool().submit(
            router.submit, np.arange(2, dtype=np.int32))
        deadline = time.monotonic() + 5
        while rep.calls < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        registry.report_failure(name)         # TTL-style eviction...
        deadline = time.monotonic() + 5
        while router.health()["replicas"] > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        registry.register(name, f"inproc://{name}", rep.load())  # ...recovery
        deadline = time.monotonic() + 5
        while router.health()["replicas"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        gate.set()                            # stale incarnation now fails
        with pytest.raises(Overloaded):       # same name was already tried
            fut.result(timeout=30)
        # The re-registered incarnation survived the stale failure:
        assert router.health()["replicas"] == 1
        assert [r["name"] for r in registry.lookup()["replicas"]] == [name]
        assert router.submit(np.arange(2, dtype=np.int32))[-1] == 7


def test_router_all_replicas_dead_is_overloaded(fabric):
    """When failover drops every replica, the caller gets the typed
    retry-later signal (a stalled replica re-registers next beat), not
    the dead replica's own error."""
    registry, add = fabric
    rep = FakeReplica(fail_with=RuntimeError("engine stopped"))
    add(rep)
    with make_router(registry) as router:
        with pytest.raises(Overloaded, match="no healthy replica"):
            router.submit(np.arange(2, dtype=np.int32))
    assert rep.calls == 1
    assert registry.lookup()["replicas"] == []    # evicted for everyone


def test_router_no_replicas_fails_fast(fabric):
    registry, _ = fabric
    with make_router(registry, startup_wait_s=0.2) as router:
        t0 = time.monotonic()
        with pytest.raises(Overloaded, match="no live replicas"):
            router.submit(np.arange(2, dtype=np.int32))
        assert time.monotonic() - t0 < 5.0


def test_router_restart_rediscovers_live_replicas(fabric):
    registry, add = fabric
    rep = FakeReplica()
    add(rep)
    router = make_router(registry)
    assert router.submit(np.arange(2, dtype=np.int32))[-1] == 7
    router.close()
    # A fresh router (restart) finds the live set from the registry alone.
    with make_router(registry) as reborn:
        assert reborn.submit(np.arange(2, dtype=np.int32))[-1] == 7
        assert reborn.health()["replicas"] == 1
    assert rep.calls == 2


def test_router_discovers_late_replicas(fabric):
    """Launch is asynchronous: a router that starts before any replica
    registered must pick them up within its startup grace."""
    registry, add = fabric
    rep = FakeReplica()

    def late_add():
        time.sleep(0.2)
        add(rep)

    t = threading.Thread(target=late_add)
    t.start()
    try:
        with make_router(registry, startup_wait_s=5.0) as router:
            assert router.submit(np.arange(2, dtype=np.int32))[-1] == 7
    finally:
        t.join()


# -- coalesced dispatch -------------------------------------------------------

def test_coalesced_dispatch_batches_frames(fabric):
    """While the dispatcher is busy sending one frame, concurrent submits
    pile up behind it and leave as ONE batch_call frame — every caller
    still gets its own correct reply."""
    registry, add = fabric
    rep = FakeReplica(num_slots=32)
    add(rep, load={"num_slots": 32, "free_slots": 32, "queue_depth": 0})
    frames = []

    class SlowClient:
        """Transport wrapper that makes each frame send take a while —
        the window in which arrivals coalesce."""

        def __init__(self, inner):
            self._inner = inner

        @property
        def futures(self):
            return self

        def batch_call(self, calls):
            frames.append(len(calls))
            time.sleep(0.08)
            return self._inner.futures.batch_call(calls)

        def close(self):
            self._inner.close()

    factory = lambda ep: SlowClient(courier.client_for(ep))  # noqa: E731
    with make_router(registry, client_factory=factory) as router:
        results = [None] * 8

        def call(i):
            results[i] = router.submit(np.arange(i + 1, dtype=np.int32))

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(8)]
        threads[0].start()
        time.sleep(0.03)                  # frame 1 is in flight
        for th in threads[1:]:
            th.start()
        for th in threads:
            th.join(timeout=30)
        s = router.stats()
    for i, out in enumerate(results):
        np.testing.assert_array_equal(
            out, np.concatenate([np.arange(i + 1, dtype=np.int32), [7]]))
    assert s["dispatches"] == 8
    assert s["frames"] < s["dispatches"]          # something coalesced
    assert max(frames) >= 2
    assert s["mean_calls_per_frame"] > 1.0
    assert s["coalesced_calls"] >= 2


def test_coalesced_frame_failure_fans_out_and_fails_over(fabric):
    """A frame-level transport death must fan the error out to every call
    in the frame and feed the normal failover path: the request completes
    on the sibling and the dead replica is evicted registry-wide."""
    registry, add = fabric
    good = FakeReplica()
    add(good)
    # More attractive load -> always picked first; its transport is dead.
    dead_name = add(FakeReplica(),
                    load={"num_slots": 8, "free_slots": 100,
                          "queue_depth": 0},
                    name=f"dead-{uuid.uuid4().hex[:8]}")

    class DeadClient:
        @property
        def futures(self):
            return self

        def batch_call(self, calls):
            raise ConnectionError("transport down")

        def close(self):
            pass

    factory = lambda ep: (DeadClient() if f"inproc://{dead_name}" == ep  # noqa: E731
                          else courier.client_for(ep))
    with make_router(registry, client_factory=factory) as router:
        out = router.submit(np.arange(3, dtype=np.int32))
        np.testing.assert_array_equal(out, [0, 1, 2, 7])
        assert router.stats()["failovers"] >= 1
    assert good.calls == 1
    names = [r["name"] for r in registry.lookup()["replicas"]]
    assert dead_name not in names                 # evicted registry-wide


def test_router_score_caps_admission_headroom_at_free_pages(fabric):
    """A paged replica advertising many free rows but a drained page pool
    must lose to a sibling with real page headroom: the score caps free
    slots at free_pages / pages_per_request."""
    registry, add = fabric
    roomy, starved = FakeReplica(), FakeReplica()
    add(roomy, load={"num_slots": 4, "free_slots": 2, "queue_depth": 0})
    add(starved, load={"num_slots": 4, "free_slots": 4, "queue_depth": 0,
                       "free_pages": 2, "pages_per_request_ewma": 4.0})
    with make_router(registry) as router:
        out = router.submit(np.arange(3, dtype=np.int32))
        np.testing.assert_array_equal(out, [0, 1, 2, 7])
    assert roomy.calls == 1 and starved.calls == 0
