"""The port's replicated serve fabric end to end on the CPU: Registry ->
Router -> EngineServers through ``build_program(device="cpu")`` —
``tests/test_examples.py``'s fabric, failover, rollout and meter-hold
cases — plus the telemetry hub, the CLI's fabric flags and the fabric's
argument checks.
"""

import json
import threading

import pytest

from repro_torch import configs
from repro_torch import core as lp
from repro_torch.launch import serve

CFG = configs.get_reduced("qwen2-1.5b")


@pytest.fixture(autouse=True)
def _reset_port_inproc_registry():
    """Each test gets a clean in-process courier registry (the port's)."""
    from repro_torch.core.courier import inprocess
    inprocess.reset()
    yield
    inprocess.reset()


def test_serve_fabric_end_to_end(tmp_path):
    """Replicated fabric: Registry -> Router -> 2 EngineServers serves
    every request, and the meter summary is namespaced by router."""
    meter_json = str(tmp_path / "fabric_meter.json")
    program = serve.build_program(CFG, num_clients=2, requests_per_client=2,
                                  prompt_len=8, max_new=4, replicas=2,
                                  routers=1, meter_json=meter_json,
                                  device="cpu")
    lp.launch_and_wait(program, timeout_s=120)
    summary = json.load(open(meter_json))
    assert summary["count"] == 4
    assert summary["out_lens"] == [12] * 4
    assert summary["p95_ms"] >= summary["p50_ms"] > 0
    (source,) = summary["per_source"]
    assert "Router" in source
    assert summary["per_source"][source]["count"] == 4


def test_serve_failover_demo(tmp_path, capsys):
    """``kill_after``: one replica dies mid-run; every request is still
    served (failover onto the sibling, zero lost)."""
    meter_json = str(tmp_path / "failover_meter.json")
    program = serve.build_program(CFG, num_clients=2, requests_per_client=3,
                                  prompt_len=8, max_new=4, replicas=2,
                                  routers=1, meter_json=meter_json,
                                  kill_after=1, registry_ttl_s=1.0,
                                  heartbeat_s=0.2, device="cpu")
    lp.launch_and_wait(program, timeout_s=120)
    summary = json.load(open(meter_json))
    assert summary["count"] == 6          # zero lost
    assert summary["out_lens"] == [12] * 6
    assert "fault: kill -> target 0 fired" in capsys.readouterr().out


def test_serve_rollout_demo(tmp_path, capsys):
    """``rollout``: mid-run the fleet rolls v0 -> v1 one replica at a
    time from a store in the JAX layout; every request is served and the
    rollout promotes, both replicas ending on v1."""
    store_dir = str(tmp_path / "store")
    serve.publish_demo_versions(CFG, store_dir, device="cpu")
    meter_json = str(tmp_path / "rollout_meter.json")
    program = serve.build_program(CFG, num_clients=2, requests_per_client=3,
                                  prompt_len=8, max_new=4, replicas=2,
                                  routers=1, meter_json=meter_json,
                                  registry_ttl_s=2.0, heartbeat_s=0.1,
                                  store_dir=store_dir, model_version=0,
                                  rollout=1, rollout_after=1, device="cpu")
    lp.launch_and_wait(program, timeout_s=120)
    summary = json.load(open(meter_json))
    assert summary["count"] == 6          # zero lost across the roll
    out = capsys.readouterr().out
    assert "rollout: promoted -> v1" in out
    # print() writes a line's newline on its own, so another thread's
    # output can follow the JSON directly: decode just the object.
    start = out.index("rollout: result ") + len("rollout: result ")
    result, _ = json.JSONDecoder().raw_decode(out, start)
    assert result["status"] == "promoted"
    assert sorted(result["replica_versions"].values()) == [1, 1]


def test_meter_hold_gates_stop():
    """A Meter stop-hold delays program stop past the last served
    request until released."""
    from repro_torch.core.nodes.base import WorkerContext, set_current_context

    stops = []
    set_current_context(WorkerContext(
        node_name="meter", stop_event=threading.Event(),
        stop_program_fn=lambda: stops.append(True)))
    try:
        m = serve.Meter(2, holds=1)
        m.record(0.01, 4)
        m.record(0.01, 4)
        assert not stops              # count reached, hold still pending
        m.release("rollout")
        assert len(stops) == 1        # hold dropped -> stop fires

        m2 = serve.Meter(1, holds=1)  # release-before-done: record stops
        m2.release("rollout")
        assert len(stops) == 1
        m2.record(0.01, 4)
        assert len(stops) == 2
    finally:
        set_current_context(None)


def test_meter_per_source_rows_are_exact(tmp_path):
    """Two sources get their own rows; every percentile is the exact
    one of the raw samples (not a histogram bucket), and the merged row
    covers both."""
    from repro_torch.core.nodes.base import WorkerContext, set_current_context
    set_current_context(WorkerContext(
        node_name="meter", stop_event=threading.Event(),
        stop_program_fn=lambda: None))
    path = tmp_path / "m.json"
    try:
        m = serve.Meter(4, summary_path=str(path))
        for lat, src in ((0.010, "a"), (0.030, "a"), (0.020, "b"),
                         (0.050, "b")):
            m.record(lat, 7, source=src)
    finally:
        set_current_context(None)
    got = json.loads(path.read_text())
    assert got["count"] == 4 and got["out_lens"] == [7] * 4
    assert got["p50_ms"] == pytest.approx(25.0)
    assert got["per_source"]["a"]["p50_ms"] == pytest.approx(20.0)
    assert got["per_source"]["b"]["p95_ms"] == pytest.approx(48.5)


def test_serve_fabric_telemetry_hub_writes_traces(tmp_path):
    """``telemetry_dir`` + ``trace_every``: the hub files each registry
    replica's engine counters under its name and writes a Perfetto trace
    with the sampled requests' root spans."""
    tel = tmp_path / "tel"
    # Long enough for the hub (polling every 0.1 s) to scrape mid-run: a
    # hub whose first scrape comes after the stop finds every service
    # gone and waits out each lookup.
    program = serve.build_program(CFG, num_clients=2, requests_per_client=6,
                                  prompt_len=8, max_new=24, replicas=2,
                                  routers=1, telemetry_dir=str(tel),
                                  heartbeat_s=0.05, trace_every=2,
                                  device="cpu")
    lp.launch_and_wait(program, timeout_s=120)
    snap = json.loads((tel / "telemetry.json").read_text())
    engines = {k: v for k, v in snap["services"].items()
               if "EngineServer" in k}
    assert len(engines) == 2
    assert sum(v["admitted"] for v in engines.values()) >= 1
    trace = json.loads((tel / "trace.json").read_text())
    assert any(e.get("name") == "request" for e in trace["traceEvents"])


def test_fabric_engine_batches_concurrent_requests(tmp_path):
    """Requests behind the router reach the engine together: 3 clients
    x 4 in flight against 8 slots fill every slot at once. The router
    sends one RPC per request (ROADMAP.md C15): a coalesced frame would
    run its blocking ``generate`` calls one after another."""
    tel = tmp_path / "tel"
    program = serve.build_program(CFG, num_clients=3, requests_per_client=4,
                                  prompt_len=8, max_new=24, replicas=1,
                                  routers=1, num_slots=8,
                                  telemetry_dir=str(tel), heartbeat_s=0.05,
                                  device="cpu")
    lp.launch_and_wait(program, timeout_s=120)
    services = json.loads((tel / "telemetry.json").read_text())["services"]
    (router,) = [v for k, v in services.items() if "Router" in k]
    (engine,) = [v for k, v in services.items() if "EngineServer" in k]
    assert router["dispatches"] == router["frames"] == 12
    assert engine["retired"] == 12
    assert engine["peak_occupancy"] == 8


@pytest.mark.parametrize("flags, line", [
    (["--kill-after", "2"], "fault: kill -> target 0 fired"),
    (["--rollout-after", "2"], "rollout: promoted -> v1"),
])
def test_cli_fabric_flags(tmp_path, capsys, flags, line):
    meter_json = tmp_path / "m.json"
    args = ["--device", "cpu", "--replicas", "2", "--routers", "1",
            "--clients", "2", "--requests", "3",
            "--meter-json", str(meter_json)] + flags
    if "--rollout-after" in flags:
        args += ["--store", str(tmp_path / "store")]
    serve.main(args)
    assert line in capsys.readouterr().out
    assert json.loads(meter_json.read_text())["count"] == 6


@pytest.mark.parametrize("kw, match", [
    (dict(replicas=2), "needs at least one router"),
    (dict(kill_after=1), "needs the fabric"),
    (dict(routers=1, mode="lockstep"), "continuous-batching"),
    (dict(routers=1, kill_after=1), "no sibling"),
    (dict(routers=1, replicas=2, kill_after=99), "never fires"),
    (dict(routers=1, rollout=1), "needs store_dir"),
    (dict(routers=1, rollout=1, store_dir="x", rollout_after=99),
     "rollout_after < total"),
])
def test_build_program_argument_checks(kw, match):
    with pytest.raises(ValueError, match=match):
        serve.build_program(CFG, device="cpu", **kw)
