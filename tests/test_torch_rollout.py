"""The port's zero-downtime rollout: registry drain marks, canary
routing, the RolloutController state machine (happy path, bad canary,
mid-drain kill, controller restart) — ``tests/test_rollout.py``'s cases
against ``repro_torch`` — then the real hot-swap on the port's
``ServeEngine``/``EngineServer`` (``device="cpu"``), and a store the JAX
package publishes served by both packages' engine servers with the same
greedy tokens.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

from repro_torch import configs as tconfigs
from repro_torch import core as lp
from repro_torch.core.discovery import Heartbeater, Registry
from repro_torch.serve.rollout import RolloutController
from repro_torch.serve.router import Router, decorrelated_backoff


@pytest.fixture(autouse=True)
def _reset_port_inproc_registry():
    """Each test gets a clean in-process courier registry (the port's)."""
    from repro_torch.core.courier import inprocess
    inprocess.reset()
    yield
    inprocess.reset()


# -- fakes --------------------------------------------------------------------

class FakeReplica:
    """Version-aware engine replica: generate/load/health/load_version,
    with knobs for the failure paths (slow canary, failing swap, death)."""

    def __init__(self, name, version=0, num_slots=8, vocab=64):
        self.name = name
        self.version = version
        self.num_slots = num_slots
        self.calls = 0
        self.inflight = 0
        self.latency_s = 0.0
        self.fail_swap_to = None       # version id whose swap raises
        self.dead = False
        self.swaps = []
        self._lock = threading.Lock()

    def generate(self, prompt, max_new=4):
        if self.dead:
            raise ConnectionError(f"{self.name} is dead")
        with self._lock:
            self.calls += 1
            self.inflight += 1
        if self.latency_s:
            time.sleep(self.latency_s)
        with self._lock:
            self.inflight -= 1
        prompt = np.asarray(prompt)
        return np.concatenate([prompt, np.zeros(max_new, prompt.dtype)])

    def load(self):
        if self.dead:
            raise ConnectionError(f"{self.name} is dead")
        with self._lock:
            return {"num_slots": self.num_slots,
                    "free_slots": self.num_slots - self.inflight,
                    "queue_depth": 0, "version": self.version}

    def health(self):
        if self.dead:
            raise ConnectionError(f"{self.name} is dead")
        return {"status": "ok", "version": self.version}

    def load_version(self, version):
        if self.dead:
            raise ConnectionError(f"{self.name} is dead")
        if self.fail_swap_to is not None and int(version) == self.fail_swap_to:
            raise ValueError("shape mismatch: bad published version")
        self.version = int(version)
        self.swaps.append(int(version))
        return {"version": self.version}

    def kill(self):
        self.dead = True


class _Fleet:
    """Registry + heartbeating fake replicas + a router over them."""

    def __init__(self, n=2, ttl_s=5.0, heartbeat_s=0.02, **rep_kw):
        self.registry = Registry(ttl_s=ttl_s)
        self.replicas = [FakeReplica(f"rep-{i}", **rep_kw) for i in range(n)]
        self.by_endpoint = {}
        self.beaters = []
        for rep in self.replicas:
            ep = f"fake://{rep.name}"
            self.by_endpoint[ep] = rep
            self.beaters.append(Heartbeater(
                self.registry, rep.name, ep, load_fn=rep.load,
                period_s=heartbeat_s).start())
        self.router = Router(self.registry, refresh_s=0.01,
                             startup_wait_s=2.0, coalesce=False,
                             client_factory=self.client_for)

    def client_for(self, endpoint):
        rep = self.by_endpoint[endpoint]

        class _Client:
            class futures:
                @staticmethod
                def generate(prompt, **kw):
                    from concurrent import futures as cf
                    fut = cf.Future()
                    try:
                        fut.set_result(rep.generate(prompt, **kw))
                    except BaseException as exc:  # noqa: BLE001
                        fut.set_exception(exc)
                    return fut

            generate = staticmethod(rep.generate)
            load = staticmethod(rep.load)
            health = staticmethod(rep.health)
            load_version = staticmethod(rep.load_version)

        return _Client()

    def controller(self, **kw):
        kw.setdefault("client_factory", self.client_for)
        kw.setdefault("drain_timeout_s", 5.0)
        kw.setdefault("poll_s", 0.005)
        kw.setdefault("canary_timeout_s", 2.0)
        return RolloutController(self.registry, [self.router], **kw)

    def wait_routable(self, n):
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            if self.router.health()["replicas"] >= n:
                return
            time.sleep(0.01)
        raise AssertionError("router never saw the fleet")

    def close(self):
        self.router.close()
        for b in self.beaters:
            b.stop()


@pytest.fixture
def fleet():
    f = _Fleet()
    f.wait_routable(2)
    yield f
    f.close()


# -- registry drain marks -----------------------------------------------------

def test_set_draining_marks_and_generation():
    reg = Registry(ttl_s=5.0)
    reg.register("a", "fake://a", {"version": 0})
    g0 = reg.lookup()["generation"]
    assert reg.set_draining("a", True)
    view = reg.lookup()
    assert view["replicas"][0]["draining"] is True
    assert view["generation"] > g0
    assert reg.version_table()["a"]["draining"] is True
    # idempotent set does not churn the generation
    g1 = reg.lookup()["generation"]
    reg.set_draining("a", True)
    assert reg.lookup()["generation"] == g1
    assert not reg.set_draining("ghost", True)
    # re-registration clears the mark (recovered replica is dispatchable)
    reg.register("a", "fake://a", {"version": 0})
    assert reg.lookup()["replicas"][0]["draining"] is False


def test_router_skips_draining_replica(fleet):
    fleet.registry.set_draining("rep-0", True)
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline:
        if fleet.router.health()["dispatchable"] == 1:
            break
        time.sleep(0.01)
    assert fleet.router.health()["dispatchable"] == 1
    for _ in range(6):
        fleet.router.submit(np.arange(4, dtype=np.int32), max_new=2)
    assert fleet.replicas[0].calls == 0
    assert fleet.replicas[1].calls == 6


def test_version_table_tracks_heartbeat_versions(fleet):
    fleet.replicas[1].version = 7
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline:
        table = fleet.registry.version_table()
        if table.get("rep-1", {}).get("version") == 7:
            break
        time.sleep(0.01)
    table = fleet.registry.version_table()
    assert table["rep-0"]["version"] == 0
    assert table["rep-1"]["version"] == 7


# -- canary routing -----------------------------------------------------------

def test_canary_fraction_is_metered(fleet):
    fleet.replicas[1].version = 1
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline:
        stats = fleet.router.stats()["replicas"]
        if stats.get("rep-1", {}).get("version") == "1":
            break
        time.sleep(0.01)
    fleet.router.set_canary(1, 0.25)
    for _ in range(16):
        fleet.router.submit(np.arange(4, dtype=np.int32), max_new=2)
    # Deterministic accumulator: exactly 1/4 of requests hit the canary,
    # and baseline traffic is steered *away* from it.
    assert fleet.replicas[1].calls == 4
    assert fleet.replicas[0].calls == 12
    per_version = fleet.router.stats()["per_version"]
    assert per_version["1"]["completed"] == 4
    assert per_version["0"]["completed"] == 12
    assert per_version["1"]["us_per_token"] > 0
    fleet.router.set_canary(None)
    fleet.router.submit(np.arange(4, dtype=np.int32), max_new=2)
    assert fleet.replicas[0].calls + fleet.replicas[1].calls == 17


def test_decorrelated_backoff_spreads_and_caps():
    rng = np.random.default_rng(0)
    sleeps = set()
    prev = 0.0
    for _ in range(32):
        prev = decorrelated_backoff(prev, rng, base_s=0.005, cap_s=0.1)
        assert 0.005 <= prev <= 0.1
        sleeps.add(round(prev, 6))
    assert len(sleeps) > 16          # jittered, not a fixed schedule


# -- the controller -----------------------------------------------------------

def _traffic(fleet, stop, counts):
    """Background closed-loop client; Overloaded retried with jitter."""
    rng = np.random.default_rng(1)
    backoff = 0.0
    while not stop.is_set():
        try:
            out = fleet.router.submit(np.arange(4, dtype=np.int32),
                                      max_new=2)
            assert len(out) == 6
            counts["ok"] += 1
            backoff = 0.0
        except Exception as exc:  # noqa: BLE001
            from repro_torch.serve.router import is_overloaded
            if is_overloaded(exc):
                backoff = decorrelated_backoff(backoff, rng)
                time.sleep(backoff)
            else:
                counts["lost"] += 1


def test_rollout_happy_path_zero_lost(fleet):
    # Both versions serve at the same 2 ms: with the fakes' default of no
    # work at all, the canary compares two p50s of scheduling noise, and
    # one twice the other rolls the happy path back (about one run in
    # seven of tests/test_rollout.py's copy, alone on a CPU host).
    for rep in fleet.replicas:
        rep.latency_s = 0.002
    stop, counts = threading.Event(), {"ok": 0, "lost": 0}
    dips = []
    sampler_stop = threading.Event()

    def sample():
        while not sampler_stop.is_set():
            dips.append(fleet.router.health()["dispatchable"])
            time.sleep(0.002)

    threads = [threading.Thread(target=_traffic,
                                args=(fleet, stop, counts), daemon=True)
               for _ in range(3)]
    threads.append(threading.Thread(target=sample, daemon=True))
    for t in threads:
        t.start()
    try:
        result = fleet.controller(canary_fraction=0.5,
                                  canary_requests=4).rollout(1)
    finally:
        sampler_stop.set()
        stop.set()
        for t in threads:
            t.join(timeout=5)
    assert result["status"] == "promoted"
    assert result["canary"] is not None and result["canary"]["ok"]
    assert all(r.version == 1 for r in fleet.replicas)
    table = fleet.registry.version_table()
    assert all(not info["draining"] for info in table.values())
    assert counts["lost"] == 0
    assert counts["ok"] > 0
    # One replica drains at a time: the fleet never dropped below N-1.
    assert min(dips) >= 1


def test_rollout_bad_swap_rolls_back_fleet_wide(fleet):
    # First replica (the canary) swaps fine; the second one's swap blows
    # up (e.g. a version published for another architecture). The
    # controller must re-pin the already-updated canary back to v0.
    fleet.replicas[1].fail_swap_to = 1
    result = fleet.controller(canary_requests=0).rollout(1)
    assert result["status"] == "rolled_back"
    assert "rep-1" in result["reason"]
    assert all(r.version == 0 for r in fleet.replicas)
    assert all(not info["draining"]
               for info in fleet.registry.version_table().values())


def test_rollout_canary_regression_rolls_back(fleet):
    # The new version is healthy but slow: the canary comparison, not the
    # health probe, must catch it and restore v0 everywhere.
    stop, counts = threading.Event(), {"ok": 0, "lost": 0}
    orig = fleet.replicas[0].load_version

    def slow_swap(version):
        out = orig(version)
        fleet.replicas[0].latency_s = 0.03 if int(version) == 1 else 0.0
        return out

    fleet.replicas[0].load_version = slow_swap
    threads = [threading.Thread(target=_traffic,
                                args=(fleet, stop, counts), daemon=True)
               for _ in range(3)]
    for t in threads:
        t.start()
    try:
        result = fleet.controller(canary_fraction=0.5, canary_requests=6,
                                  canary_timeout_s=10.0,
                                  regression_ratio=2.0).rollout(1)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
    assert result["status"] == "rolled_back"
    assert result["reason"].startswith("canary")
    assert not result["canary"]["ok"]
    assert all(r.version == 0 for r in fleet.replicas)
    assert counts["lost"] == 0


def test_rollout_survives_mid_drain_kill(fleet):
    # Chaos: the first replica dies while draining. The controller must
    # detect it, skip it, and finish rolling the survivor — zero lost.
    fleet.replicas[0].inflight = 1       # pins the drain wait open
    injector = lp.FaultInjector(
        [lp.FaultEvent(kind="kill", target=0,
                       when=lambda: fleet.registry.version_table()
                       .get("rep-0", {}).get("draining", False))],
        [fleet.replicas[0]])
    done = threading.Event()

    def chaos():
        while not done.is_set() and injector.poll():
            time.sleep(0.002)

    t = threading.Thread(target=chaos, daemon=True)
    t.start()
    try:
        result = fleet.controller(canary_requests=0).rollout(1)
    finally:
        done.set()
        t.join(timeout=5)
    assert injector.fired and injector.fired[0]["kind"] == "kill"
    assert result["status"] == "promoted"
    assert result["replicas"]["rep-0"] == "dead"
    assert result["replicas"]["rep-1"] == "swapped"
    assert fleet.replicas[1].version == 1


def test_rollout_resumes_from_registry_state(fleet):
    # Controller "dies" after rolling the first replica; a fresh
    # controller re-derives progress from the registry's version table
    # and only touches the remaining replica.
    fleet.replicas[0].load_version(1)
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline:
        if fleet.registry.version_table()["rep-0"]["version"] == 1:
            break
        time.sleep(0.01)
    result = fleet.controller(canary_requests=0).rollout(1)
    assert result["status"] == "promoted"
    assert list(result["replicas"]) == ["rep-1"]     # rep-0 untouched
    assert fleet.replicas[0].swaps == [1]            # exactly once, by us
    assert fleet.replicas[1].swaps == [1]


# -- the real engine ----------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_cfg():
    from repro_torch import configs
    return configs.get_reduced("qwen2-1.5b")


def _run_to_done(engine, fut, limit=500):
    steps = 0
    while not fut.done():
        engine.step()
        steps += 1
        assert steps < limit, "engine made no progress"
    return np.asarray(fut.result())


def test_engine_swap_params_applies_between_windows(tiny_cfg):
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    p0 = transformer.init_params(tiny_cfg, seed=0, device="cpu")
    p1 = transformer.init_params(tiny_cfg, seed=1, device="cpu")
    prompt = np.arange(1, 7, dtype=np.int32)

    eng = ServeEngine(tiny_cfg, p0, num_slots=2, context_len=32, max_new=4,
                      device="cpu")
    out_v0 = _run_to_done(eng, eng.submit(prompt))
    # Externally-stepped engine: the swap lands on the next step() call.
    eng.swap_params(p1, block=False)
    out_v1 = _run_to_done(eng, eng.submit(prompt))
    assert eng.stats()["param_swaps"] == 1
    eng.stop()

    solo = ServeEngine(tiny_cfg, p1, num_slots=2, context_len=32, max_new=4,
                       device="cpu")
    expected = _run_to_done(solo, solo.submit(prompt))
    solo.stop()
    np.testing.assert_array_equal(out_v1, expected)
    assert not np.array_equal(out_v0, out_v1)   # the weights really moved


def _publish_port_versions(cfg, store_dir, versions=(0, 1)):
    from repro_torch.launch.serve import publish_demo_versions
    publish_demo_versions(cfg, store_dir, versions, device="cpu")


def test_engine_server_load_version_roundtrip(tiny_cfg, tmp_path):
    from repro_torch.launch.serve import EngineServer

    _publish_port_versions(tiny_cfg, str(tmp_path / "store"))
    registry = Registry(ttl_s=5.0)
    server = EngineServer(tiny_cfg, max_new=4, num_slots=2, context_len=32,
                          registry=registry, heartbeat_s=0.05,
                          name="rep-0", endpoint="fake://rep-0",
                          store_dir=str(tmp_path / "store"), version=0,
                          device="cpu")
    try:
        assert server.load()["version"] == 0
        out0 = np.asarray(server.generate(np.arange(1, 7, dtype=np.int32)))
        server.load_version(1)
        assert server.health()["version"] == 1
        # beat_now() pushed the new version without waiting a period
        assert registry.version_table()["rep-0"]["version"] == 1
        out1 = np.asarray(server.generate(np.arange(1, 7, dtype=np.int32)))
        assert not np.array_equal(out0, out1)
        # a version that was never published fails before any swap
        with pytest.raises(FileNotFoundError):
            server.load_version(9)
        assert server.load()["version"] == 1
    finally:
        server.kill()


def test_load_version_of_another_architecture_fails_before_install(
        tiny_cfg, tmp_path):
    """The shape check against the current tree is the rollout's health
    gate: a version published for another width is refused and the
    replica keeps serving what it had."""
    from repro_torch.launch.serve import EngineServer
    store = str(tmp_path / "store")
    _publish_port_versions(tiny_cfg, store, versions=(0,))
    wide = dataclasses.replace(tiny_cfg, d_model=tiny_cfg.d_model * 2)
    _publish_port_versions(wide, store, versions=(1,))
    server = EngineServer(tiny_cfg, max_new=4, num_slots=2, context_len=32,
                          store_dir=store, version=0, device="cpu")
    try:
        before = np.asarray(server.generate(np.arange(1, 7, dtype=np.int32)))
        with pytest.raises(ValueError, match="shape"):
            server.load_version(1)
        assert server.load()["version"] == 0
        assert server.stats()["param_swaps"] == 0
        np.testing.assert_array_equal(
            server.generate(np.arange(1, 7, dtype=np.int32)), before)
    finally:
        server.kill()


def test_jax_published_store_serves_same_greedy_tokens_in_both(tmp_path):
    """A store the JAX package publishes (fp32, stacked blocks) serves in
    the port: the port's EngineServer at fp32 compute gives the JAX
    EngineServer's greedy tokens for v0, and again after both swap to
    v1."""
    import jax

    from repro import configs as jconfigs
    from repro.ckpt.checkpoint import ModelStore as JaxModelStore
    from repro.ckpt.checkpoint import config_hash
    from repro.launch.serve import EngineServer as JaxEngineServer
    from repro.models import transformer as jt
    from repro_torch.launch.serve import EngineServer

    jcfg = dataclasses.replace(jconfigs.get_reduced("qwen2-1.5b"),
                               compute_dtype="float32")
    cfg = dataclasses.replace(tconfigs.get_reduced("qwen2-1.5b"),
                              compute_dtype="float32")
    store_dir = str(tmp_path / "store")
    store = JaxModelStore(store_dir)
    for v in (0, 1):
        store.publish_version(
            v, jt.init_params(jcfg, jax.random.key(v)),
            metadata={"step": v, "config_hash": config_hash(jcfg)})
    prompts = [np.random.default_rng(s).integers(
        0, cfg.vocab_size, n).astype(np.int32) for s, n in ((0, 6), (1, 11))]
    kw = dict(max_new=5, num_slots=2, context_len=32, store_dir=store_dir,
              version=0)
    outs = {}
    for pkg, server in (("jax", JaxEngineServer(jcfg, **kw)),
                        ("port", EngineServer(cfg, device="cpu", **kw))):
        try:
            outs[pkg] = [np.asarray(server.generate(p)) for p in prompts]
            server.load_version(1)
            assert server.load()["version"] == 1
            outs[pkg] += [np.asarray(server.generate(p)) for p in prompts]
        finally:
            server.kill()
    assert len(outs["port"]) == 4
    for a, b in zip(outs["jax"], outs["port"]):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(outs["port"][0], outs["port"][2])
