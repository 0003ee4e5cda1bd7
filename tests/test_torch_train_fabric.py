"""The port's training fabric: ``tests/test_train_fabric.py``'s cases
(typed replay stalls, gradient wire compression, quorum aggregation, the
supervisor's survival story) on a torch ``ToyTask`` over the port's
Registry, replay and inproc courier; then what the two packages share:
int8 error-feedback compression bit-equal to the JAX package's, the
elastic restore, training versions published by either package's learner
restoring in the other's, the data pipeline, and ``launch.train`` end to
end on the CPU.
"""

import dataclasses
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.ckpt import elastic as jelastic
from repro.core.courier import inprocess as jinprocess
from repro.core.discovery import Registry as JRegistry
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_source as jmake_source
from repro.launch.train import LMTask as JLMTask
from repro.models import transformer as jt
from repro.train import fabric as jfabric
from repro.train import grad_compression as jgc
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import configs
from repro_torch.ckpt import checkpoint
from repro_torch.ckpt.checkpoint import ModelStore
from repro_torch.ckpt.elastic import restore_elastic
from repro_torch.core import courier
from repro_torch.core.discovery import Registry
from repro_torch.core.fault import RestartPolicy, hedged_map
from repro_torch.data.pipeline import DataConfig, Prefetcher, make_source
from repro_torch.data.replay import (ReplayServer, TableConfig,
                                     WriterStalled, is_writer_stalled)
from repro_torch.launch import train as launch_train
from repro_torch.models import convert
from repro_torch.models import transformer as tt
from repro_torch.train import fabric, grad_compression, tree
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.train_step import TrainConfig

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset_port_inproc_registry():
    """Each test gets a clean in-process courier registry (the port's)."""
    courier.inprocess.reset()
    yield
    courier.inprocess.reset()


# -- typed replay stalls ------------------------------------------------------

def _stall_table():
    # SPI budget of ~1 sample per insert with tiny tolerance: with no
    # sampler draining, inserts run ahead fast and hit the limiter.
    return TableConfig(name="t", max_size=100, min_size_to_sample=1,
                       samples_per_insert=1.0, spi_tolerance=1.0)


def test_insert_raises_writer_stalled_past_deadline():
    server = ReplayServer([_stall_table()])
    while server.insert("t", {"x": 1}, 1.0, 0.05, False):
        pass                                   # exhaust the SPI budget
    with pytest.raises(WriterStalled) as ei:
        server.insert("t", {"x": 1}, 1.0, 0.05, True)
    assert ei.value.table == "t"
    assert is_writer_stalled(ei.value)
    assert server.insert("t", {"x": 1}, 1.0, 0.05) is False


def test_writer_stalled_unwraps_across_inproc_courier():
    server = ReplayServer([_stall_table()])
    courier.inprocess.register("replay-x", server)
    client = courier.client_for("inproc://replay-x")
    while client.insert("t", {"x": 1}, 1.0, 0.05, False):
        pass
    with pytest.raises(Exception) as ei:
        client.insert("t", {"x": 1}, 1.0, 0.05, True)
    assert is_writer_stalled(ei.value)         # typed through the transport
    assert not is_writer_stalled(ValueError("nope"))


# -- gradient wire compression ------------------------------------------------

def _tree(key=0):
    rng = np.random.default_rng(key)
    return {"w": rng.normal(size=(8, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32)}


def _torch_tree(t):
    return {k: torch.from_numpy(v.copy()) for k, v in t.items()}


def test_dense_payload_roundtrips_exactly():
    g = _tree()
    payload, err = grad_compression.compress_tree(_torch_tree(g), None,
                                                  method="dense")
    out = grad_compression.decompress_tree(payload)
    assert err is None
    for k in g:
        np.testing.assert_array_equal(out[k], g[k])


def test_int8_roundtrip_error_is_bounded_by_scale():
    g = _tree()
    payload, err = grad_compression.compress_tree(_torch_tree(g), None,
                                                  method="int8_ef")
    out = grad_compression.decompress_tree(payload)
    for k in g:
        scale = float(np.max(np.abs(g[k]))) / 127.0
        assert np.max(np.abs(out[k] - g[k])) <= scale * 0.5 + 1e-7
        # The residual is exactly what the wire dropped.
        np.testing.assert_allclose(err[k].numpy(), g[k] - out[k], atol=1e-6)


def test_error_feedback_cancels_quantization_bias():
    """Feeding the residual back makes the *running sum* of dequantized
    gradients track the true sum — the bias does not accumulate."""
    g = _tree()
    err = None
    sent = {k: np.zeros_like(v) for k, v in g.items()}
    n = 50
    for _ in range(n):
        payload, err = grad_compression.compress_tree(_torch_tree(g), err,
                                                      method="int8_ef")
        out = grad_compression.decompress_tree(payload)
        sent = {k: sent[k] + out[k] for k in g}
    for k in g:
        scale = float(np.max(np.abs(g[k]))) / 127.0
        assert np.max(np.abs(sent[k] - n * g[k])) <= 2 * scale


def test_select_strategy_by_gradient_size():
    small = {"w": torch.zeros((4, 4))}
    assert grad_compression.select_strategy(small, threshold_bytes=1024) \
        == "dense"
    assert grad_compression.select_strategy(small, threshold_bytes=64) \
        == "int8_ef"
    assert grad_compression.grad_bytes(small) == 64
    assert grad_compression.wire_bytes_saved(small) == \
        jgc.wire_bytes_saved({"w": np.zeros((4, 4), np.float32)})


def test_compress_rejects_unknown_method():
    with pytest.raises(ValueError, match="unknown"):
        grad_compression.compress_tree(_torch_tree(_tree()), None,
                                       method="fp4")


def test_int8_ef_is_bit_equal_to_jax_over_error_feedback_steps():
    """Payload (q, scale), residual and dequantized gradient equal the
    JAX package's numpy version bit for bit over several steps, from
    tensors and from numpy, with values that land on .5 ties."""
    rng = np.random.default_rng(7)
    grads = [{"w": rng.normal(size=(33, 17)).astype(np.float32),
              "b": (np.arange(-6, 6) / 4).astype(np.float32),
              "z": np.zeros((5,), np.float32)} for _ in range(6)]
    j_err, t_err, n_err = None, None, None
    for g in grads:
        jp, j_err = jgc.compress_tree(g, j_err, method="int8_ef")
        tp, t_err = grad_compression.compress_tree(_torch_tree(g), t_err,
                                                   method="int8_ef")
        npay, n_err = grad_compression.compress_tree(g, n_err,
                                                     method="int8_ef")
        for pay, err in ((tp, t_err), (npay, n_err)):
            for k in g:
                np.testing.assert_array_equal(pay["q"][k], jp["q"][k])
                assert pay["q"][k].dtype == np.int8
                assert pay["scale"][k] == jp["scale"][k]
                assert type(pay["scale"][k]) is np.float32
                np.testing.assert_array_equal(err[k].numpy(), j_err[k])
            deq = grad_compression.decompress_tree(pay)
            jdeq = jgc.decompress_tree(jp)
            dev = grad_compression.decompress_tree(pay, torch.device("cpu"))
            for k in g:
                np.testing.assert_array_equal(deq[k], jdeq[k])
                np.testing.assert_array_equal(dev[k].numpy(), jdeq[k])


# -- quorum aggregation over survivors ----------------------------------------

def test_hedged_map_return_exceptions_degrades_not_fails():
    import concurrent.futures as cf

    def ok():
        return 1

    def boom():
        raise RuntimeError("peer died")

    with cf.ThreadPoolExecutor(3) as pool:
        results = hedged_map(
            [lambda: pool.submit(ok), lambda: pool.submit(boom),
             lambda: pool.submit(ok)],
            timeout_s=5.0, quorum=3, return_exceptions=True)
    assert results[0] == 1 and results[2] == 1
    assert isinstance(results[1], RuntimeError)


# -- end-to-end fleet ---------------------------------------------------------

def _target(x):
    return np.sin(x[:, 0]) + 0.5 * x[:, 1]


def _rollout(params, rng):
    x = rng.normal(size=(8, 4)).astype(np.float32)
    return {"x": x, "y": _target(x).astype(np.float32)}


class ToyTask:
    optimizer = OptimizerConfig(lr=0.03, warmup_steps=0,
                                total_steps=1_000_000, weight_decay=0.0,
                                clip_norm=None)

    def init_params(self, seed):
        g = torch.Generator().manual_seed(seed)
        return {"w1": torch.randn((4, 16), generator=g) * 0.5,
                "b1": torch.zeros((16,)),
                "w2": torch.randn((16, 1), generator=g) * 0.5,
                "b2": torch.zeros((1,))}

    def grad_fn(self, params, batch):
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            h = torch.tanh(batch["x"] @ live["w1"] + live["b1"])
            pred = (h @ live["w2"] + live["b2"])[:, 0]
            loss = torch.mean((pred - batch["y"]) ** 2)
        grads = torch.autograd.grad(loss, list(live.values()))
        return loss.detach(), dict(zip(live, grads))

    def collate(self, items):
        return {"x": np.concatenate([it["x"] for it in items]),
                "y": np.concatenate([it["y"] for it in items])}


class _Fleet:
    def __init__(self, store_dir, *, learners=1, actors=1, total_steps=12,
                 publish_every=4):
        self.store_dir = str(store_dir)
        self.registry = Registry(ttl_s=1.0)
        self.spawner = fabric.ThreadWorkerSpawner()
        self.cfg = fabric.FabricConfig(
            total_steps=total_steps, batch_size=4,
            publish_every=publish_every, peer_timeout_s=5.0,
            heartbeat_s=0.05, insert_timeout_s=0.5, sample_timeout_s=0.5)
        task = ToyTask()
        table = TableConfig(name="batches", max_size=500,
                            min_size_to_sample=8)
        resolver = fabric.registry_resolver(self.registry, "replay")
        cfg, registry, spawner = self.cfg, self.registry, self.spawner
        store = self.store_dir

        def spawn_fn(name):
            role, idx = name.rsplit("-", 1)
            if role == "replay":
                spawner.spawn(name, lambda n, ep: fabric.ReplayService(
                    [table], registry, name=n, endpoint=ep,
                    heartbeat_s=cfg.heartbeat_s))
            elif role == "learner":
                batch_fn = fabric.replay_batch_fn(
                    resolver, "batches", task.collate, cfg.batch_size,
                    cfg.sample_timeout_s)
                spawner.spawn(name, lambda n, ep, i=int(idx):
                              fabric.LearnerWorker(
                                  task, batch_fn, store, registry, cfg,
                                  name=n, chief=(i == 0), device="cpu",
                                  endpoint=ep))
            elif role == "actor":
                spawner.spawn(name, lambda n, ep, i=int(idx):
                              fabric.ActorWorker(
                                  task, _rollout, resolver, "batches",
                                  store, registry, cfg, name=n,
                                  endpoint=ep, seed=100 + i))
            else:
                raise ValueError(name)

        self.sup = fabric.TrainSupervisor(
            self.registry, spawn_fn,
            expected={"replay": 1, "actor": actors, "learner": learners},
            policy=RestartPolicy(max_restarts=8, backoff_s=0.02),
            spawn_grace_s=10.0, total_steps=total_steps)

    def lookup(self, name):
        for r in self.registry.lookup()["replicas"]:
            if r["name"] == name:
                return r["load"]
        return None

    def chief(self):
        for r in self.registry.lookup()["replicas"]:
            load = r["load"]
            if load.get("role") == "learner" and load.get("chief"):
                return load
        return None

    def drive(self, events=(), timeout_s=90.0):
        """Poll to completion, firing (trigger_step, fn) events once when
        the chief first reports that step. Returns the final chief load."""
        t0 = time.monotonic()
        fired = [False] * len(events)
        last = None
        while time.monotonic() - t0 < timeout_s:
            self.sup.poll()
            load = self.chief()
            if load is not None:
                last = load
                for i, (trig, fn) in enumerate(events):
                    if not fired[i] and load["step"] >= trig:
                        fired[i] = True
                        fn()
            if self.sup.done:
                deadline = time.monotonic() + 5.0
                while time.monotonic() < deadline:
                    load = self.chief()
                    if load is not None and load.get("done"):
                        return load
                    time.sleep(0.02)
                return last
            time.sleep(0.02)
        raise AssertionError(
            f"fleet did not finish in {timeout_s}s: chief={last}, "
            f"stats={self.sup.stats()}")

    def versions(self):
        return ModelStore(self.store_dir).versions()

    def close(self):
        self.spawner.stop_all()


@pytest.fixture
def fleet_factory(tmp_path):
    fleets = []

    def make(**kw):
        f = _Fleet(tmp_path / f"store{len(fleets)}", **kw)
        fleets.append(f)
        return f

    yield make
    for f in fleets:
        f.close()


def test_fleet_trains_to_done_and_publishes(fleet_factory):
    fleet = fleet_factory(total_steps=8, publish_every=4)
    load = fleet.drive()
    assert load["step"] >= 8 and load["done"]
    assert load["start_step"] == 0              # never restored
    assert fleet.versions() == [4, 8]           # every publish boundary
    assert fleet.sup.stats()["restarts"] == {}  # no faults, no respawns


def test_kill_chief_restores_with_bounded_step_loss(fleet_factory):
    fleet = fleet_factory(learners=2, total_steps=12, publish_every=4)
    kill_at = {}

    def kill_chief():
        kill_at["step"] = fleet.chief()["step"]
        fabric.RegistryTarget(fleet.registry, "learner-0").kill()

    # Fire between publish boundaries so the regression is visible.
    load = fleet.drive([(6, kill_chief)])
    assert load["step"] >= 12 and load["done"]
    assert fleet.sup.stats()["restarts"].get("learner-0", 0) >= 1
    # The respawned chief resumed from the last *published* version:
    assert load["start_step"] > 0
    assert kill_at["step"] - load["start_step"] <= 4   # <= publish_every


def test_kill_actor_costs_zero_steps(fleet_factory):
    fleet = fleet_factory(actors=2, total_steps=10, publish_every=5)
    load = fleet.drive(
        [(3, lambda: fabric.RegistryTarget(fleet.registry,
                                           "actor-0").kill())])
    assert load["step"] >= 10 and load["done"]
    assert load["start_step"] == 0
    restarts = fleet.sup.stats()["restarts"]
    assert not any(k.startswith("learner") for k in restarts)
    deadline = time.monotonic() + 10.0
    while (not fleet.sup.stats()["restarts"].get("actor-0")
           and time.monotonic() < deadline):
        fleet.sup.poll()
        time.sleep(0.02)
    assert fleet.sup.stats()["restarts"].get("actor-0", 0) >= 1


def test_elastic_grow_joins_from_published_version(fleet_factory):
    fleet = fleet_factory(learners=1, total_steps=14, publish_every=4)
    fleet.drive([(5, lambda: fleet.sup.scale("learner", 2))])
    grown = fleet.lookup("learner-1")
    assert grown is not None and not grown["chief"]
    assert grown["start_step"] > 0
    assert grown["start_step"] % 4 == 0


def test_elastic_shrink_retires_gracefully(fleet_factory):
    fleet = fleet_factory(learners=2, total_steps=12, publish_every=4)
    load = fleet.drive([(4, lambda: fleet.sup.scale("learner", 1))])
    assert load["step"] >= 12 and load["done"]
    assert fleet.lookup("learner-1") is None    # deregistered, not dead
    stats = fleet.sup.stats()
    assert stats["expected"]["learner"] == 1
    assert not stats["restarts"]                # retire is not a fault


def test_learner_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fabric.LearnerWorker(ToyTask(), lambda: None, str(tmp_path),
                             Registry(), fabric.FabricConfig())


# -- the elastic restore ------------------------------------------------------

def _lm_state(cfg, seed=0):
    params = tt.init_params(cfg, seed, device="cpu", dtype=torch.float32)
    return {"params": params, "opt": init_opt_state(params),
            "ef": tree.tree_map(torch.zeros_like, params)}


_MESH_RESTORE = """
import sys
import torch
from torch.distributed.tensor import DTensor
from repro_torch import configs
from repro_torch.ckpt.elastic import reshard, restore_elastic
from repro_torch.models import transformer as tt
from repro_torch.sharding.compat import make_mesh
from repro_torch.sharding.rules import path_str, placements, spec_for_path
from repro_torch.train import tree
from repro_torch.train.optimizer import init_opt_state
d, seed = sys.argv[1], int(sys.argv[2])
cfg = configs.get_reduced("qwen2-1.5b")
params = tt.init_params(cfg, seed, device="cpu", dtype=torch.float32)
like = {"params": params, "opt": init_opt_state(params),
        "ef": tree.tree_map(torch.zeros_like, params)}
mesh = make_mesh((1, 1), ("data", "model"), "cpu")


def full(t):
    return {"/".join(map(str, p)): x.full_tensor()
            for p, x in tree.leaves_with_path(t)}


def placed(t):
    return all(isinstance(x, DTensor) and tuple(x.placements) == placements(
        mesh, spec_for_path(path_str(p), tuple(x.shape), mesh))
        for p, x in tree.leaves_with_path(t))


got = restore_elastic(d, like, new_mesh=mesh, fill_missing=True)
moved = reshard(like, mesh)
for name, x in full(got).items():
    if name.startswith("ef/"):
        assert float(x.abs().max()) == 0.0, name
want = {"/".join(map(str, p)): x for p, x in tree.leaves_with_path(like)}
for name, x in full(moved).items():
    assert torch.equal(x, want[name]), name
assert placed(got) and placed(moved)
torch.save(full(got), d + ".pt")
print("MESH_OK", len(tree.leaves(got)))
"""


def test_fill_missing_supplies_ef_residual_on_old_checkpoints(tmp_path):
    """A version published before the error-feedback residual existed
    restores: the missing ``ef`` comes from ``like`` (the caller's zero
    residual), everything present stays bit-exact — also onto a 1x1 gloo
    mesh (``new_mesh``, in a process of its own: it starts a process
    group), where every leaf is a DTensor on the rules' placements, and
    ``reshard`` places a tree there."""
    cfg = configs.get_reduced("qwen2-1.5b")
    state = _lm_state(cfg, seed=3)
    d = str(tmp_path / "old")
    checkpoint.save({"params": state["params"], "opt": state["opt"]}, d)
    like = _lm_state(cfg, seed=4)
    with pytest.raises(KeyError, match="ef"):
        restore_elastic(d, like)
    got = restore_elastic(d, like, fill_missing=True)
    for a, b in zip(tree.leaves({"params": got["params"], "opt": got["opt"]}),
                    tree.leaves({"params": state["params"],
                                 "opt": state["opt"]})):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert all(float(leaf.abs().max()) == 0.0
               for leaf in tree.leaves(got["ef"]))
    proc = subprocess.run(
        [sys.executable, "-c", _MESH_RESTORE, d, "4"], capture_output=True,
        text=True, timeout=240, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "MESH_OK" in proc.stdout
    on_mesh = torch.load(d + ".pt")
    for path, leaf in tree.leaves_with_path({"params": state["params"],
                                             "opt": state["opt"]}):
        got_leaf = on_mesh["/".join(map(str, path))]
        assert got_leaf.dtype == leaf.dtype and torch.equal(got_leaf, leaf)


# -- versions published by either package's learner ---------------------------

def _qwen2():
    return (dataclasses.replace(configs.get_reduced("qwen2-1.5b"),
                                compute_dtype="float32"),
            dataclasses.replace(configs.get_reduced("qwen2-1.5b"),
                                compute_dtype="float32"))


def _wait_for_version(store_dir, version, timeout_s=120.0):
    store = ModelStore(store_dir)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if (store.latest_version() or 0) >= version:
            return
        time.sleep(0.05)
    raise AssertionError(f"version {version} was not published")


def _fab_cfg(total_steps):
    return dict(total_steps=total_steps, batch_size=4, publish_every=1,
                heartbeat_s=0.05)


def _port_learner(cfg, store_dir, registry, total_steps, spawner):
    task = launch_train.LMTask(cfg, TrainConfig(), device="cpu")
    src = iter(make_source(DataConfig(seq_len=16, batch_size=4,
                                      vocab_size=cfg.vocab_size)))
    spawner.spawn("learner-0", lambda n, ep: fabric.LearnerWorker(
        task, lambda: next(src), store_dir, registry,
        fabric.FabricConfig(**_fab_cfg(total_steps)), name=n, device="cpu",
        endpoint=ep))
    return task


def test_port_published_version_restores_in_jax(tmp_path):
    cfg, jcfg = _qwen2()
    store_dir = str(tmp_path / "store")
    spawner = fabric.ThreadWorkerSpawner()
    try:
        _port_learner(cfg, store_dir, Registry(ttl_s=5.0), 2, spawner)
        _wait_for_version(store_dir, 2)
    finally:
        spawner.stop_all()
    d = ModelStore(store_dir).version_dir(2)
    jp = jax.jit(lambda k: jt.init_params(jcfg, k))(jax.random.key(0))
    like = {"params": jp, "opt": jopt.init_opt_state(jp),
            "ef": jax.tree.map(lambda x: np.zeros(x.shape, np.float32), jp)}
    got = jelastic.restore_elastic(d, like)
    flat = checkpoint.restore(d)
    leaves = jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(leaves) == len(flat)
    for path, leaf in leaves:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        assert leaf.dtype == flat[name].dtype
        np.testing.assert_array_equal(np.asarray(leaf), flat[name])
    assert int(got["opt"]["step"]) == 2
    # JAX trains on from it.
    step = jax.jit(jts.make_train_step(jcfg, jts.TrainConfig()))
    batch = next(iter(jmake_source(JDataConfig(
        seq_len=16, batch_size=4, vocab_size=jcfg.vocab_size))))
    _, opt2, m = step(got["params"], got["opt"],
                      jax.tree.map(jnp.asarray, batch))
    assert int(opt2["step"]) == 3 and bool(jnp.isfinite(m["loss"]))


def test_jax_published_version_restores_in_port(tmp_path):
    cfg, jcfg = _qwen2()
    store_dir = str(tmp_path / "store")
    jspawner = jfabric.ThreadWorkerSpawner()
    jtask = JLMTask(jcfg, jts.TrainConfig())
    jsrc = iter(jmake_source(JDataConfig(seq_len=16, batch_size=4,
                                         vocab_size=jcfg.vocab_size)))
    try:
        jspawner.spawn("learner-0", lambda n, ep: jfabric.LearnerWorker(
            jtask, lambda: next(jsrc), store_dir, JRegistry(ttl_s=5.0),
            jfabric.FabricConfig(**_fab_cfg(2)), name=n, endpoint=ep))
        _wait_for_version(store_dir, 2)
    finally:
        jspawner.stop_all()
        jinprocess.reset()
    published = checkpoint.restore(ModelStore(store_dir).version_dir(2))

    # What a port learner restores (the fabric's own path), bit for bit.
    task = launch_train.LMTask(cfg, TrainConfig(), device="cpu")
    like = _lm_state(cfg)
    state = fabric.from_store(task, restore_elastic(
        ModelStore(store_dir).version_dir(2), fabric.to_store(task, like),
        fill_missing=True), "cpu")
    assert int(state["opt"]["step"]) == 2
    for name, arr in checkpoint._flatten(fabric.to_store(task, state)):
        np.testing.assert_array_equal(arr, published[name], err_msg=name)

    # A port learner on that store resumes from it and publishes the next.
    registry = Registry(ttl_s=5.0)
    spawner = fabric.ThreadWorkerSpawner()
    try:
        _port_learner(cfg, store_dir, registry, 3, spawner)
        _wait_for_version(store_dir, 3)
        load = registry.lookup()["replicas"][0]["load"]
        assert load["start_step"] == 2
    finally:
        spawner.stop_all()


# -- data pipeline ------------------------------------------------------------

def test_data_pipeline_deterministic_and_sharded():
    cfg = DataConfig(seq_len=16, batch_size=4, vocab_size=97, seed=3)
    a = next(iter(make_source(cfg, host_id=0, num_hosts=2)))
    b = next(iter(make_source(cfg, host_id=0, num_hosts=2)))
    c = next(iter(make_source(cfg, host_id=1, num_hosts=2)))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    j = next(iter(jmake_source(JDataConfig(seq_len=16, batch_size=4,
                                           vocab_size=97, seed=3),
                               host_id=0, num_hosts=2)))
    np.testing.assert_array_equal(a["tokens"], j["tokens"])


def test_prefetcher_yields_batches():
    cfg = DataConfig(seq_len=8, batch_size=2, vocab_size=50)
    pf = Prefetcher(make_source(cfg), depth=2)
    batches = [next(pf) for _ in range(3)]
    assert all(b["tokens"].shape == (2, 8) for b in batches)
    pf.close()


def test_byte_corpus(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_bytes(b"the quick brown fox jumps over the lazy dog " * 50)
    cfg = DataConfig(seq_len=16, batch_size=2, vocab_size=256, kind="bytes",
                     path=str(path))
    batch = next(iter(make_source(cfg)))
    assert batch["tokens"].shape == (2, 16)
    assert batch["tokens"].max() < 256


# -- launch.train -------------------------------------------------------------

def test_train_lm_end_to_end(tmp_path):
    from repro_torch import core as lp
    from repro_torch.ckpt.checkpoint import CheckpointManager
    cfg = dataclasses.replace(launch_train.LM_TINY, num_layers=2, d_model=64,
                              d_ff=128)
    program = launch_train.build_program(
        cfg, steps=12, ckpt_dir=str(tmp_path), batch_size=8, seq_len=32,
        with_eval=False, device="cpu")
    lp.launch_and_wait(program, timeout_s=600)
    assert CheckpointManager(str(tmp_path)).latest_step() == 12


class _PromptEvaluator(launch_train.Evaluator):
    """The program's evaluator scraping the store every 0.2 s, not every
    5 s: a 12-step run on a quiet host can end before a 5 s scrape."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **dict(kwargs, every_s=0.2))


def test_train_cli_survives_the_chief_kill(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(launch_train, "Evaluator", _PromptEvaluator)
    launch_train.main([
        "--device", "cpu", "--preset", "tiny", "--learners", "2",
        "--kill-after", "0.5", "--steps", "12", "--publish-every", "2",
        "--batch-size", "8", "--seq-len", "32",
        "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr()
    assert ModelStore(str(tmp_path)).latest_version() == 12
    assert "respawn learner-0" in out.out + out.err
    assert "eval v" in out.out


@pytest.fixture
def no_group_left():
    """A test whose program starts a process group (a learner mesh) ends
    it: a later planning mesh in the same worker needs the fake
    backend."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_mesh_training_equals_plain_training(tmp_path, no_group_left):
    """``mesh_shape=(1, 1)``: the learner's state lives on a 1x1 gloo
    mesh as DTensors and its steps run under the mesh's sharding
    context; the loss of every step (published with each version) and
    the last version's bytes equal those of ``mesh_shape=None``."""
    cfg = dataclasses.replace(launch_train.LM_TINY, num_layers=2, d_model=64,
                              d_ff=128)
    runs = {}
    for mesh in (None, (1, 1)):
        d = str(tmp_path / f"mesh-{mesh}")
        program = launch_train.build_program(
            cfg, steps=6, ckpt_dir=d, batch_size=8, seq_len=32,
            with_eval=False, publish_every=1, mesh_shape=mesh, device="cpu")
        from repro_torch import core as lp
        lp.launch_and_wait(program, timeout_s=300)
        store = ModelStore(d)
        assert store.versions() == [1, 2, 3, 4, 5, 6]
        runs[mesh] = ([store.metadata(v)["loss"] for v in store.versions()],
                      checkpoint.restore(store.version_dir(6)))
    assert dist.is_initialized() and dist.get_world_size() == 1
    (loss_a, last_a), (loss_b, last_b) = runs[None], runs[(1, 1)]
    assert loss_a == loss_b and all(np.isfinite(loss_a))
    assert sorted(last_a) == sorted(last_b)
    for name, arr in last_a.items():
        np.testing.assert_array_equal(last_b[name], arr, err_msg=name)


def test_build_program_refuses_a_mesh_and_a_missing_card(tmp_path):
    """A cuda mesh of more ranks than visible cards (one rank a card)
    raises, naming both counts, when the program is built; so does a
    missing card. A CPU mesh of any size runs as gloo processes
    (``test_torch_mesh_program.py``)."""
    from repro_torch.sharding.compat import rank_devices
    n = torch.cuda.device_count()
    shape = (n + 1, 1)
    fewer = rf"mesh \({n + 1}, 1\) needs {n + 1} cuda devices, {n} visible"
    with pytest.raises(RuntimeError, match=fewer):
        rank_devices(shape, "cuda")
    if torch.cuda.is_available():
        with pytest.raises(RuntimeError, match=fewer):
            launch_train.build_program(launch_train.LM_TINY, steps=2,
                                       ckpt_dir=str(tmp_path),
                                       mesh_shape=shape)
        return
    for mesh_shape in (None, shape):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_train.build_program(launch_train.LM_TINY, steps=2,
                                       ckpt_dir=str(tmp_path),
                                       mesh_shape=mesh_shape)
