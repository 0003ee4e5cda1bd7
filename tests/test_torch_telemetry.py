"""The port's telemetry through the serve fabric: one trace across the
router -> replica hop (coalesced or not) and across a failover, the
router's telemetry RPC, engine spans and TTFT on the port's
``ServeEngine``, and the TelemetryHub's scrapes (per-pid merge, registry
replicas, dead targets) — ``tests/test_telemetry.py``'s router, engine
and hub cases against ``repro_torch``. The rest of that file tests
``core/telemetry.py`` itself, which ``tests/test_torch_core_copy.py``
holds equal to the reference.
"""

import json
import time
import uuid

import numpy as np
import pytest

from repro_torch.core import courier, telemetry
from repro_torch.core.discovery import Registry
from repro_torch.core.telemetry import TelemetryHub, trace_coverage
from repro_torch.serve.router import Router


@pytest.fixture(autouse=True)
def _reset_port_inproc_registry():
    """Each test gets a clean in-process courier registry (the port's)."""
    courier.inprocess.reset()
    yield
    courier.inprocess.reset()


@pytest.fixture(autouse=True)
def clean_buffers():
    """Spans/events land in process-global rings; start every test from
    an empty one so assertions only see their own records."""
    telemetry.spans_buffer().drain()
    telemetry.events_buffer().drain()
    yield
    telemetry.spans_buffer().drain()
    telemetry.events_buffer().drain()


# ---- cross-node propagation through the fabric -------------------------------

class TracedReplica:
    """EngineServer-shaped fake that records engine-style spans under
    whatever trace context the transport delivered."""

    def __init__(self, fail=False):
        self.fail = fail
        self.calls = 0

    def generate(self, prompt, max_new=None):
        self.calls += 1
        if self.fail:
            raise RuntimeError("engine stopped")
        with telemetry.span("admission"):
            pass
        with telemetry.span("prefill", tokens=len(prompt)):
            time.sleep(0.001)
        with telemetry.span("decode"):
            time.sleep(0.001)
        return np.concatenate([np.asarray(prompt, np.int32), [7]])

    def load(self):
        return {"num_slots": 8, "free_slots": 8, "queue_depth": 0,
                "ewma_us_per_token": 100.0}

    def health(self):
        return {"status": "ok"}

    def telemetry(self):
        return telemetry.telemetry_snapshot(service=self.load())


@pytest.fixture
def fabric():
    registry = Registry(ttl_s=5.0)
    names = []

    def add(replica, load=None, name=None):
        name = name or f"tel-{uuid.uuid4().hex[:8]}"
        courier.inprocess.register(name, replica)
        names.append(name)
        registry.register(name, f"inproc://{name}",
                          load if load is not None else replica.load())
        return name

    yield registry, add
    for name in names:
        courier.inprocess.unregister(name)


def _traced_submit(router, prompt):
    """Client-side half of a sampled request: mint the trace, run submit
    under a context parented on a pre-minted root span id, then record
    the root 'request' span over the measured e2e window."""
    ctx = telemetry.start_trace()
    root_sid = telemetry.new_span_id()
    t0w, t0 = time.time(), time.perf_counter()
    with telemetry.activate(ctx.child(root_sid)):
        out = router.submit(prompt)
    dur = time.perf_counter() - t0
    telemetry.record_span("request", ctx, t0w, dur, span_id=root_sid,
                          root=True)
    return out, ctx, root_sid, t0w, dur


@pytest.mark.parametrize("coalesce", [True, False])
def test_sampled_request_yields_single_nested_trace(fabric, coalesce):
    """One sampled request through a 2-replica fabric produces ONE trace
    whose spans nest correctly across the router -> replica hop."""
    registry, add = fabric
    add(TracedReplica())
    add(TracedReplica())
    with Router(registry, refresh_s=0.05, startup_wait_s=2.0,
                coalesce=coalesce) as router:
        out, ctx, root_sid, _, _ = _traced_submit(
            router, np.arange(4, dtype=np.int32))
    assert out[-1] == 7
    spans = telemetry.spans_buffer().drain()
    assert spans and {s["trace"] for s in spans} == {ctx.trace_id}
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)
    # Router-side spans hang off the client's root span.
    (queue,) = by_name["queue"]
    (dispatch,) = by_name["dispatch"]
    (reply,) = by_name["reply"]
    assert queue["parent"] == root_sid
    assert dispatch["parent"] == root_sid
    assert reply["parent"] == root_sid
    # Replica-side spans nest under the dispatch that carried them.
    for name in ("admission", "prefill", "decode"):
        (s,) = by_name[name]
        assert s["parent"] == dispatch["id"], name
    (root,) = by_name["request"]
    assert root["id"] == root_sid and root["attrs"]["root"] is True


def test_failover_hops_stay_in_one_trace(fabric):
    """A replica dying mid-request adds a second queue/dispatch hop to
    the SAME trace; replica-side spans only hang off the surviving
    dispatch."""
    registry, add = fabric
    # The failing replica advertises the better load -> picked first.
    add(TracedReplica(fail=True),
        load={"num_slots": 8, "free_slots": 8, "queue_depth": 0})
    live = TracedReplica()
    add(live, load={"num_slots": 8, "free_slots": 2, "queue_depth": 3})
    with Router(registry, refresh_s=0.05, startup_wait_s=2.0) as router:
        out, ctx, root_sid, t0w, dur = _traced_submit(
            router, np.arange(4, dtype=np.int32))
    assert out[-1] == 7 and live.calls == 1
    spans = telemetry.spans_buffer().drain()
    assert {s["trace"] for s in spans} == {ctx.trace_id}      # single trace
    queues = [s for s in spans if s["name"] == "queue"]
    dispatches = [s for s in spans if s["name"] == "dispatch"]
    assert len(queues) == 2 and len(dispatches) == 2          # failover hop
    assert {q["attrs"]["attempt"] for q in queues} == {1, 2}
    live_dispatch = [d for d in dispatches
                    if any(s["parent"] == d["id"] for s in spans
                           if s["name"] == "decode")]
    assert len(live_dispatch) == 1
    # The trace explains (almost) every microsecond of the e2e window:
    # fake replicas do ~no work outside their spans, so the union of
    # non-root spans must cover most of it.
    cov = trace_coverage(spans, ctx.trace_id, t0w, dur)
    assert cov > 0.5
    # The drop left a queryable fabric event with a cause.
    events = telemetry.events_buffer().drain()
    kinds = {e["kind"] for e in events}
    assert "replica_dropped" in kinds and "eviction" in kinds
    assert all(e["cause"] for e in events if e["kind"] == "eviction")


def test_router_telemetry_rpc_surfaces_transport_stats(fabric):
    registry, add = fabric
    add(TracedReplica())
    with Router(registry, refresh_s=0.05, startup_wait_s=2.0) as router:
        assert router.submit(np.arange(3, dtype=np.int32))[-1] == 7
        snap = router.telemetry()
    assert "metrics" in snap and "pid" in snap
    transports = snap["service"]["transports"]
    assert transports, "replica transport counters missing"
    (io,) = transports.values()
    assert io["calls"] + io["batched_calls_in_frames"] >= 1


# ---- real engine spans -------------------------------------------------------

def test_engine_spans_and_ttft():
    """A sampled request through the port's ServeEngine yields admission /
    prefill / decode spans and a TTFT histogram sample."""
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine

    cfg = configs.get_reduced("qwen2-1.5b")
    params = transformer.init_params(cfg, seed=0, device="cpu")
    engine = ServeEngine(cfg, params, num_slots=2, context_len=24,
                         max_new=4, device="cpu")
    ctx = telemetry.start_trace()
    with telemetry.activate(ctx):
        fut = engine.submit(np.arange(5, dtype=np.int32) % cfg.vocab_size)
    steps = 0
    while not fut.done():
        engine.step()
        steps += 1
        assert steps < 500
    assert fut.result().shape == (9,)
    engine.stop()
    spans = [s for s in telemetry.spans_buffer().drain()
             if s["trace"] == ctx.trace_id]
    names = {s["name"] for s in spans}
    assert {"admission", "prefill", "decode"} <= names
    hists = telemetry.metrics().snapshot()["histograms"]
    ttft = [k for k in hists if k.startswith("engine.ttft_us.")]
    assert ttft and any(hists[k]["count"] >= 1 for k in ttft)


# ---- collector ---------------------------------------------------------------

class FakeNode:
    """telemetry()-shaped scrape target with a controllable pid."""

    def __init__(self, node, pid, counters=None, spans=(), events=()):
        self._snap = {"node": node, "pid": pid, "time": time.time(),
                      "metrics": {"counters": dict(counters or {}),
                                  "gauges": {}, "histograms": {}},
                      "spans": list(spans), "events": list(events)}
        self.scrapes = 0

    def telemetry(self):
        self.scrapes += 1
        snap = dict(self._snap)
        # Spans drain: only the first scrape carries them.
        if self.scrapes > 1:
            snap["spans"], snap["events"] = [], []
        return snap


def _span(trace, sid, parent, name, ts, dur, node="n"):
    return {"name": name, "trace": trace, "id": sid, "parent": parent,
            "node": node, "ts": ts, "dur": dur, "attrs": {}}


def test_hub_merges_per_pid_and_accumulates_spans(tmp_path):
    sp = _span("t1", "s1", None, "request", 100.0, 1.0)
    a = FakeNode("a", pid=1, counters={"reqs": 5}, spans=[sp],
                 events=[{"kind": "swap", "cause": "v2", "node": "a",
                          "ts": 100.5, "attrs": {}}])
    # Same pid as a (thread-launched sibling sharing the registry): its
    # counters must NOT double the merge.
    b = FakeNode("b", pid=1, counters={"reqs": 5})
    c = FakeNode("c", pid=2, counters={"reqs": 2})
    hub = TelemetryHub(targets=[a, b, c], out_dir=str(tmp_path))
    assert hub.scrape_once() == 3
    assert hub.scrape_once() == 3                  # spans don't duplicate
    merged = hub.merged_metrics()
    assert merged["counters"]["reqs"] == 7         # 5 (pid 1, once) + 2
    assert len(hub.spans()) == 1
    assert hub.events()[0]["kind"] == "swap"
    # Export: merged snapshot + Perfetto-loadable trace.
    snap = json.loads((tmp_path / "telemetry.json").read_text())
    assert snap["merged"]["counters"]["reqs"] == 7
    assert snap["hub"]["scrapes"] >= 3
    trace = json.loads((tmp_path / "trace.json").read_text())
    evs = trace["traceEvents"]
    assert any(e["ph"] == "X" and e["name"] == "request" for e in evs)
    assert any(e["ph"] == "M" and e["name"] == "process_name" for e in evs)
    assert any(e["ph"] == "i" and "swap" in e["name"] for e in evs)


def test_hub_scrapes_registry_replicas(fabric):
    registry, add = fabric
    rep = TracedReplica()
    add(rep)
    hub = TelemetryHub(registry=registry)
    assert hub.scrape_once() >= 1
    # The replica's process registry reached the hub (pid-keyed).
    assert hub.snapshot()["hub"]["scrapes"] >= 1
    hub.close()


def test_hub_survives_dead_targets():
    class Dead:
        def telemetry(self):
            raise ConnectionError("gone")

    hub = TelemetryHub(targets=[Dead(), FakeNode("ok", pid=9)])
    assert hub.scrape_once() == 1
    assert hub.snapshot()["hub"]["scrape_errors"] == 1
