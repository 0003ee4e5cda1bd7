"""The port's mesh building blocks against the JAX package's
(``tests/test_distributed.py``, ``tests/test_nodes.py`` and
``tests/test_shm.py`` cases): the cross-pod compressed reduction and the
collective matmul on real gloo meshes of 4 processes, and
``MeshWorkerNode`` handing its class a ``DeviceMesh``.

A torch mesh is one process per device, so each mesh here is a group of
gloo processes, each with its own timeout, meeting at a ``file://``
rendezvous under the test's ``tmp_path`` (no port is picked). The JAX
side runs as its own tests run it: in a subprocess with 8 placeholder
host devices. Arrays pass between the two as ``.npy`` files.
"""

import json
import os
import subprocess
import sys
import textwrap
import uuid

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import core as lp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 240


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def run_gloo(body: str, world: int, tmp_path, *args) -> list[dict]:
    """Run ``body`` in ``world`` gloo processes (rank r of a group of
    ``world``, the default group started from a fresh ``file://`` store
    under ``tmp_path``; ``ARGS`` holds ``args``); each rank's last
    stdout line is JSON. Returns those, by rank."""
    rdv = tmp_path / f"rdv-{uuid.uuid4().hex}"
    code = textwrap.dedent("""
        import json, sys
        import numpy as np
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        RANK, WORLD = int(sys.argv[2]), int(sys.argv[3])
        ARGS = sys.argv[4:]
        dist.init_process_group("gloo", init_method=f"file://{sys.argv[1]}",
                                world_size=WORLD, rank=RANK)
    """) + textwrap.dedent(body) + "\ndist.destroy_process_group()\n"
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(rdv), str(r), str(world),
         *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=ROOT) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S))
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-4000:]}"
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


def run_jax(body: str, devices: int = 8) -> str:
    """``body`` with the JAX package on ``devices`` placeholder host
    devices."""
    code = ("import os\n"
            "os.environ['XLA_FLAGS'] = "
            f"'--xla_force_host_platform_device_count={devices}'\n"
            "import jax, jax.numpy as jnp, numpy as np\n"
            "from jax.sharding import NamedSharding, PartitionSpec as P\n"
            "from repro.sharding.compat import make_mesh\n"
            + textwrap.dedent(body))
    env = _env()
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=RANK_TIMEOUT_S, env=env,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


@pytest.fixture
def no_group_left():
    """A test that starts a process group in this process ends it: a
    later planning mesh in the same worker needs the fake backend."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# compress_reduce_pod on a ("pod", "data", "model") mesh
# ---------------------------------------------------------------------------

def _grads(tmp_path):
    """Seeded gradient and residual: identical pods (g, e) and one
    gradient per pod (g0, g1)."""
    rng = np.random.default_rng(20)
    arrs = {"g": rng.standard_normal((8, 8)).astype(np.float32),
            "e": (rng.standard_normal((8, 8)) * 1e-3).astype(np.float32),
            "g0": rng.standard_normal((8, 8)).astype(np.float32),
            "g1": (3 * rng.standard_normal((8, 8))).astype(np.float32)}
    for k, v in arrs.items():
        np.save(tmp_path / f"{k}.npy", v)
    return arrs


_POD_RANK = """
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.sharding.compat import make_mesh
from repro_torch.train.grad_compression import compress_reduce_pod
d = ARGS[0]
load = lambda k: torch.from_numpy(np.load(f"{d}/{k}.npy"))
mesh = make_mesh((2, 1, 2), ("pod", "data", "model"), "cpu")
pl = [Replicate(), Replicate(), Shard(1)]      # P() over pod, TP-sharded
out = {}
for method in ("int8_ef", "bf16"):
    for with_e in (False, True):
        g = {"w": distribute_tensor(load("g"), mesh, pl)}
        e = {"w": distribute_tensor(load("e"), mesh, pl)} if with_e else None
        red, err = compress_reduce_pod(g, e, mesh, method=method)
        assert tuple(red["w"].placements) == tuple(pl)
        tag = f"{method}_{int(with_e)}"
        np.save(f"{d}/port_red_{tag}_{RANK}.npy",
                red["w"].full_tensor().numpy())
        np.save(f"{d}/port_err_{tag}_{RANK}.npy",
                err["w"].full_tensor().numpy())
pod = mesh.get_local_rank("pod")
red, err = compress_reduce_pod({"w": load(f"g{pod}")}, None, mesh)
np.save(f"{d}/port_red_distinct_{RANK}.npy", red["w"].numpy())
np.save(f"{d}/port_err_distinct_{RANK}.npy", err["w"].numpy())
g = {"w": load("g")}
same = [compress_reduce_pod(g, None, m)[0] is g for m in (
    mesh["data", "model"], make_mesh((1, 2, 2), ("pod", "data", "model"),
                                     "cpu"))]
print(json.dumps({"identity_without_pods": same}))
"""


def test_compress_reduce_pod_matches_jax(tmp_path):
    """Identical per-pod gradients: the reduced gradient and the new
    residual are bit-equal to the JAX function's on its (2,2,2) host
    mesh, for int8_ef and bf16, with and without a residual. Distinct
    per-pod gradients: the reduction is the numpy mean of each pod's
    dequantized values, each pod's residual the numpy formula's."""
    arrs = _grads(tmp_path)
    run_jax(f"""
    from repro.train.grad_compression import compress_reduce_pod
    d = "{tmp_path}"
    mesh3 = make_mesh((2, 2, 2), ("pod", "data", "model"))
    rep = NamedSharding(mesh3, P())
    for method in ("int8_ef", "bf16"):
        for with_e in (False, True):
            g = {{"w": jax.device_put(np.load(f"{{d}}/g.npy"), rep)}}
            e = ({{"w": jax.device_put(np.load(f"{{d}}/e.npy"), rep)}}
                 if with_e else None)
            red, err = compress_reduce_pod(g, e, mesh3, method=method)
            tag = f"{{method}}_{{int(with_e)}}"
            np.save(f"{{d}}/jax_red_{{tag}}.npy", np.asarray(red["w"]))
            np.save(f"{{d}}/jax_err_{{tag}}.npy", np.asarray(err["w"]))
    """)
    res = run_gloo(_POD_RANK, 4, tmp_path, tmp_path)
    assert all(r["identity_without_pods"] == [True, True] for r in res)
    for method in ("int8_ef", "bf16"):
        for with_e in (0, 1):
            tag = f"{method}_{with_e}"
            for kind in ("red", "err"):
                want = np.load(tmp_path / f"jax_{kind}_{tag}.npy")
                for r in range(4):
                    got = np.load(tmp_path / f"port_{kind}_{tag}_{r}.npy")
                    assert got.dtype == want.dtype == np.float32
                    np.testing.assert_array_equal(got, want,
                                                  err_msg=f"{kind} {tag}")
    # distinct pods: the numpy formula (fp32, true divisions, half-even)
    deq, res_np = [], []
    for p in (0, 1):
        x = arrs[f"g{p}"]
        scale = np.float32(max(np.max(np.abs(x)), np.float32(1e-12))) \
            / np.float32(127.0)
        q = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
        deq.append(q.astype(np.float32) * scale)
        res_np.append(x - deq[-1])
    mean = (deq[0] + deq[1]) / np.float32(2)
    for r in range(4):                   # ranks 0, 1: pod 0; 2, 3: pod 1
        got = np.load(tmp_path / f"port_red_distinct_{r}.npy")
        np.testing.assert_allclose(got, mean, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(
            np.load(tmp_path / f"port_err_distinct_{r}.npy"),
            res_np[r // 2])


# ---------------------------------------------------------------------------
# collective matmul
# ---------------------------------------------------------------------------

_CM_RANK = """
from torch.distributed.tensor import distribute_tensor
from repro_torch.sharding.collective_matmul import collective_matmul
from repro_torch.sharding.compat import make_mesh
from repro_torch.sharding.rules import Spec, placements
d, shape = ARGS[0], tuple(int(s) for s in ARGS[1].split(","))
x = torch.from_numpy(np.load(f"{d}/x.npy"))
w = torch.from_numpy(np.load(f"{d}/w.npy"))
mesh = make_mesh(shape, ("data", "model"), "cpu")
xs = distribute_tensor(x, mesh, placements(mesh, Spec("data", None, "model")))
ws = distribute_tensor(w, mesh, placements(mesh, Spec(None, "model")))
y = collective_matmul(xs, ws, mesh)
plain = collective_matmul(x, w, mesh)          # full tensors on each rank
ok = tuple(y.placements) == placements(mesh, Spec("data", None, "model"))
np.save(f"{d}/y_{ARGS[1].replace(',', 'x')}_{RANK}.npy",
        y.full_tensor().numpy())
print(json.dumps({"placed": ok, "same_from_full_inputs":
                  bool(torch.equal(plain.full_tensor(), y.full_tensor()))}))
"""

CM_TOL = 1e-5      # fp32: |y - x @ w| / max|x @ w|, summation order only


@pytest.mark.parametrize("shape", ["2,2", "1,4"])
def test_collective_matmul_matches_einsum_and_jax(shape, tmp_path):
    """Y = X @ W with X sharded on D over ``model`` and W column-sharded,
    as a ring of TP steps: equal to the full einsum and to the JAX
    package's ``collective_matmul`` on its (2,4) host mesh (fp32)."""
    rng = np.random.default_rng(5)
    B, S, D, F = 2, 8, 32, 64
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    w = rng.standard_normal((D, F)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "w.npy", w)
    run_jax(f"""
    from repro.sharding.collective_matmul import collective_matmul
    mesh = make_mesh((2, 4), ("data", "model"))
    x = np.load("{tmp_path}/x.npy"); w = np.load("{tmp_path}/w.npy")
    xs = jax.device_put(x, NamedSharding(mesh, P("data", None, "model")))
    ws = jax.device_put(w, NamedSharding(mesh, P(None, "model")))
    np.save("{tmp_path}/y_jax.npy", np.asarray(collective_matmul(xs, ws,
                                                                 mesh)))
    """)
    res = run_gloo(_CM_RANK, 4, tmp_path, tmp_path, shape)
    assert all(r["placed"] and r["same_from_full_inputs"] for r in res)
    expect = np.einsum("bsd,df->bsf", x.astype(np.float64),
                       w.astype(np.float64))
    y_jax = np.load(tmp_path / "y_jax.npy")
    scale = np.abs(expect).max()
    for r in range(4):
        y = np.load(tmp_path / f"y_{shape.replace(',', 'x')}_{r}.npy")
        assert y.shape == (B, S, F) and y.dtype == np.float32
        assert np.abs(y - expect).max() / scale <= CM_TOL
        assert np.abs(y - y_jax).max() / scale <= CM_TOL


# ---------------------------------------------------------------------------
# MeshWorkerNode
# ---------------------------------------------------------------------------

def test_mesh_worker_node_gets_mesh(no_group_left):
    got = {}

    class Learner:
        def __init__(self, mesh=None):
            got["mesh"] = mesh

        def run(self):
            lp.stop_program()

    p = lp.Program("mesh")
    with p.group("learner"):
        p.add_node(lp.MeshWorkerNode(Learner))
    lp.launch_and_wait(
        p, resources={"learner": {"mesh": (1, 1), "axes": ("data", "model"),
                                  "device": "cpu"}},
        timeout_s=30)
    mesh = got["mesh"]
    assert mesh is not None and mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cpu"
    assert dist.get_backend() == "gloo"


def test_mesh_worker_rejects_oversized_mesh():
    class Learner:
        def __init__(self, mesh=None):
            pass

    p = lp.Program("mesh2")
    with p.group("learner"):
        p.add_node(lp.MeshWorkerNode(Learner))
    with pytest.raises(lp.ProgramTestError) as ei:
        lp.launch_and_wait(
            p, resources={"learner": {"mesh": (4096,), "axes": ("data",),
                                      "device": "cpu"}},
            timeout_s=30)
    cause = ei.value.__cause__
    assert isinstance(cause, RuntimeError)
    # A rank a core on the CPU: the host's count, before any follower.
    assert "needs 4096 devices" in str(cause)
    assert f"has {os.cpu_count()}" in str(cause)
    assert not dist.is_initialized()


def test_mesh_worker_device_path_unchanged():
    """Without a mesh resource the class gets ``device=`` as before."""
    got = {}

    class Worker:
        def __init__(self, device=None):
            got["device"] = device

        def run(self):
            lp.stop_program()

    p = lp.Program("dev")
    with p.group("w"):
        p.add_node(lp.MeshWorkerNode(Worker, device="cpu"))
    lp.launch_and_wait(p, timeout_s=30)
    assert got["device"] == torch.device("cpu")
    assert not dist.is_initialized()


_PROCESS_LAUNCHER = """
import sys
from repro_torch import core as lp


class Learner:
    def __init__(self, mesh=None):
        self._mesh = mesh

    def axes(self):
        return [list(self._mesh.mesh_dim_names), self._mesh.device_type]


class Driver:
    def __init__(self, learner, out_path):
        self._learner = learner
        self._out = out_path

    def run(self):
        axes, device_type = self._learner.axes()
        kind = type(self._learner.transport).__name__
        with open(self._out, "w") as f:
            f.write(f"{','.join(axes)} {device_type} {kind}")
        lp.stop_program()


p = lp.Program("meshshm")
with p.group("learner"):
    h = p.add_node(lp.MeshWorkerNode(Learner))
with p.group("driver"):
    p.add_node(lp.CourierNode(Driver, h, sys.argv[1]))
launcher = lp.ProcessLauncher()
launcher.launch(p, resources={
    "learner": {"mesh": (1,), "axes": ("data",), "device": "cpu"}})
try:
    assert launcher.wait(timeout=120)
finally:
    launcher.stop()
"""


def test_mesh_worker_serves_dual_endpoint_under_process_launcher(tmp_path):
    """The node's mesh (1,) on gloo in a child process of the process
    launcher, served over its shm+grpc endpoint. The launcher runs in a
    fresh interpreter: it forks its children, and a pytest worker that
    has run gloo groups in other tests is no safe parent for a child
    that starts one."""
    out = tmp_path / "out"
    proc = subprocess.run([sys.executable, "-c", _PROCESS_LAUNCHER,
                           str(out)], capture_output=True, text=True,
                          timeout=RANK_TIMEOUT_S, env=_env(), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    axes, device_type, kind = out.read_text().split()
    assert (axes, device_type, kind) == ("data", "cpu", "ShmTransport")


# ---------------------------------------------------------------------------
# LearnerWorker on a mesh of two processes
# ---------------------------------------------------------------------------

_LEARNER_RANK = """
import dataclasses, threading, time
from repro_torch.core.discovery import Registry
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.launch import train as launch_train
from repro_torch.sharding.compat import make_mesh
from repro_torch.train import fabric
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import TrainConfig
store, shape, batches = ARGS[0], ARGS[1], ARGS[2]
# fp32 compute: a bf16 product's rounding would hide the comparison.
cfg = dataclasses.replace(launch_train.LM_TINY, num_layers=2, d_model=64,
                          d_ff=128, compute_dtype="float32")
task = launch_train.LMTask(cfg, TrainConfig(optimizer=OptimizerConfig(
    lr=1e-3, warmup_steps=2, total_steps=4)), device="cpu")
# "same": the same batches on every rank; "own": each rank draws its own,
# and rank 0's must win.
seed = 7 + (RANK if batches == "own" else 0)
src = iter(make_source(DataConfig(seq_len=32, batch_size=8,
                                  vocab_size=cfg.vocab_size, seed=seed)))
mesh = (None if shape == "none" else make_mesh(
    tuple(int(s) for s in shape.split(",")), ("data", "model"), "cpu"))
fcfg = fabric.FabricConfig(total_steps=4, batch_size=8, publish_every=2,
                           grad_strategy="dense")
learner = fabric.LearnerWorker(task, lambda: next(src), store, Registry(),
                               fcfg, device="cpu", mesh=mesh)
t = threading.Thread(target=learner.run)
t.start()
deadline = time.monotonic() + 180
while not learner.load()["done"] and time.monotonic() < deadline:
    time.sleep(0.05)
load = learner.load()
learner.retire()
t.join(timeout=30)
print(json.dumps({"history": learner.history, "load": load}))
"""

# fp32, where only the summation order differs: the loss, and each
# published leaf's |got - want|_2 / |want|_2 (per leaf, not per element:
# AdamW turns a gradient that rounds to either sign into updates of
# either sign).
LEARNER_LOSS_RTOL = 1e-5
LEARNER_STATE_RTOL = 1e-5


@pytest.mark.parametrize("shape", ["1,2", "2,1"])
def test_mesh_learner_on_two_ranks_equals_plain_learner(shape, tmp_path):
    """``LearnerWorker(mesh=)`` built on each rank of a 2-process gloo
    mesh, fed the same batches: its params and optimizer state are
    DTensors placed by the rules (the batch sharded over ``data``, the
    weights over ``model``), every rank publishes into one store, and
    the loss history and published versions equal the plain learner's
    (which ``test_torch_train_fabric.py`` holds to the JAX package) up
    to the summation order of a sharded product or a split batch."""
    _two_ranks_equal_plain(shape, "same", tmp_path)


@pytest.mark.parametrize("shape", ["1,2", "2,1"])
def test_mesh_learner_takes_rank_zero_batch(shape, tmp_path):
    """C18: each rank's ``batch_fn`` draws a different batch, and the
    mesh learner still equals the plain learner fed rank 0's batches:
    the batch is scattered from rank 0, so no global batch is stitched
    from the ranks' own."""
    _two_ranks_equal_plain(shape, "own", tmp_path)


def _two_ranks_equal_plain(shape, batches, tmp_path):
    plain, mesh = str(tmp_path / "plain"), str(tmp_path / "mesh")
    (ref,) = run_gloo(_LEARNER_RANK, 1, tmp_path, plain, "none", "same")
    ranks = run_gloo(_LEARNER_RANK, 2, tmp_path, mesh, shape, batches)
    want_mesh = dict(zip(("data", "model"), map(int, shape.split(","))))
    assert ref["load"]["done"] and ref["load"]["mesh"] is None
    for r in ranks:
        assert r["load"]["done"] and r["load"]["mesh"] == want_mesh
        assert r["history"] == ranks[0]["history"]
    steps = [s for s, _ in ranks[0]["history"]]
    assert steps == [s for s, _ in ref["history"]] == [1, 2, 3, 4]
    np.testing.assert_allclose([l for _, l in ranks[0]["history"]],
                               [l for _, l in ref["history"]],
                               rtol=LEARNER_LOSS_RTOL)
    from repro_torch.ckpt.checkpoint import ModelStore, restore
    a, b = ModelStore(plain), ModelStore(mesh)
    assert a.versions() == b.versions() == [2, 4]
    for v in (2, 4):
        got, want = restore(b.version_dir(v)), restore(a.version_dir(v))
        assert sorted(got) == sorted(want)
        for name, arr in want.items():
            assert got[name].dtype == arr.dtype, name
            diff = np.linalg.norm(got[name].astype(np.float64) - arr)
            assert diff <= LEARNER_STATE_RTOL * np.linalg.norm(arr), name


# ---------------------------------------------------------------------------
# C17: a sharded product's rounding at bf16, the port against JAX
# ---------------------------------------------------------------------------

_TINY = ("dataclasses.replace(launch_train.LM_TINY, num_layers=2, "
         "d_model=64, d_ff=128)")

_GRADS_RANK = """
import dataclasses
from repro_torch.core.discovery import Registry
from repro_torch.launch import train as launch_train
from repro_torch.sharding.compat import make_mesh
from repro_torch.train import fabric, tree
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import TrainConfig
d, shape = ARGS[0], ARGS[1]
cfg = """ + _TINY + """      # bf16 compute
task = launch_train.LMTask(cfg, TrainConfig(optimizer=OptimizerConfig(
    lr=1e-3, warmup_steps=2, total_steps=4)), device="cpu")
batch = dict(np.load(f"{d}/batch.npz"))
mesh = (None if shape == "none" else make_mesh(
    tuple(int(s) for s in shape.split(",")), ("data", "model"), "cpu"))
fcfg = fabric.FabricConfig(total_steps=4, batch_size=8,
                           grad_strategy="dense")
learner = fabric.LearnerWorker(task, lambda: batch, f"{d}/store",
                               Registry(), fcfg, device="cpu", mesh=mesh)
loss, grads = learner.on_ranks("_grads", batch=batch)
if RANK == 0:
    np.savez(f"{d}/port_{shape}.npz", *[x.numpy() for x in tree.leaves(grads)])
learner.retire()
print(json.dumps({"loss": loss}))
"""


def _max_leaf_rel(got, want) -> float:
    """The largest |got - want|_2 / |want|_2 over the leaves."""
    return max(float(np.linalg.norm(g.astype(np.float64) - w)
                     / np.linalg.norm(w)) for g, w in zip(got, want))


# The port's sharded bf16 gradients may move from its plain ones by at
# most this many times what the JAX package's move from its own.
C17_DRIFT_RATIO = 2.0


def test_sharded_bf16_gradients_move_as_jax(tmp_path):
    """C17: at bf16 compute, the first gradients of a learner on a (1,2)
    mesh move from the plain learner's in both packages, from the same
    weights (a version the JAX package published, which each learner
    restores) and the same batch: the JAX package's on its (1,2) host
    mesh by ~1.6% of a leaf, the port's on 2 gloo ranks by ~2.0%. A
    sharded product rounds its partial sums to bf16 in both, so the
    port is held to ``C17_DRIFT_RATIO`` times JAX's measured drift."""
    out = run_jax(f"""
    import dataclasses, json
    from repro.core.discovery import Registry
    from repro.ckpt.checkpoint import ModelStore
    from repro.data.pipeline import DataConfig, make_source
    from repro.launch import train as launch_train
    from repro.train import fabric, optimizer as opt_lib
    from repro.train.optimizer import OptimizerConfig
    from repro.train.train_step import TrainConfig
    d = "{tmp_path}"
    cfg = {_TINY}      # bf16 compute
    task = launch_train.LMTask(cfg, TrainConfig(optimizer=OptimizerConfig(
        lr=1e-3, warmup_steps=2, total_steps=4)))
    params = task.init_params(jax.random.key(0))
    ModelStore(f"{{d}}/store").publish_version(0, fabric.host_tree({{
        "params": params, "opt": opt_lib.init_opt_state(params),
        "ef": jax.tree.map(lambda x: np.zeros(x.shape, np.float32),
                           params)}}), metadata={{"step": 0}})
    batch = next(iter(make_source(DataConfig(
        seq_len=32, batch_size=8, vocab_size=cfg.vocab_size, seed=7))))
    np.savez(f"{{d}}/batch.npz", **batch)
    fcfg = fabric.FabricConfig(total_steps=4, batch_size=8,
                               grad_strategy="dense")
    grads = []
    for mesh in (None, make_mesh((1, 2), ("data", "model"))):
        learner = fabric.LearnerWorker(task, lambda: batch, f"{{d}}/store",
                                       Registry(), fcfg, mesh=mesh)
        _, g = learner._grad_jit(learner._params, batch)
        grads.append(jax.tree.leaves(fabric.host_tree(g)))
        learner.retire()
    np.savez(f"{{d}}/jax_plain.npz", *grads[0])
    np.savez(f"{{d}}/jax_mesh.npz", *grads[1])
    """, devices=2)
    run_gloo(_GRADS_RANK, 1, tmp_path, tmp_path, "none")
    run_gloo(_GRADS_RANK, 2, tmp_path, tmp_path, "1,2")

    def leaves(name):
        with np.load(tmp_path / f"{name}.npz") as z:
            return [z[k] for k in z.files]

    jax_drift = _max_leaf_rel(leaves("jax_mesh"), leaves("jax_plain"))
    port_drift = _max_leaf_rel(leaves("port_1,2"), leaves("port_none"))
    print(f"C17 bf16 (1,2) max leaf drift: jax {jax_drift:.4g}, "
          f"port {port_drift:.4g}")
    assert 0 < port_drift <= C17_DRIFT_RATIO * jax_drift, (port_drift,
                                                           jax_drift)
