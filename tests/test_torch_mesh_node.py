"""``MeshWorkerNode`` on a mesh of D·M ranks: the node's process is rank
0 and drives D·M-1 follower processes (``sharding.group``), against the
JAX package's ``MeshWorkerNode`` on placeholder host devices.

The service has two methods: ``matmul`` (``sharding.collective_matmul``
with its weight sharded over ``model``) and ``score`` (the LM loss of a
2-layer model whose params the sharding rules place on the mesh). Its
weights and the requests are made with numpy from a seed; both packages
read them from files.

Each program is written to a file under ``tmp_path`` (so that its
``__main__`` has a path the followers re-run) and runs as rank 0 in a
fresh process of its own session under ``RANK_TIMEOUT_S``; every test
fails if any process of that session outlives rank 0.
"""

import json
import os
import pickle
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 240
CM_TOL = 1e-5         # fp32: |y - want| / max|want|, summation order only
LOSS_RTOL = 1e-5
N_REQUESTS = 8        # alternately matmul and score
B, S, D, F = 4, 16, 128, 256

_SERVICE = '''
import dataclasses, json, os, pickle, signal, sys, threading, time
from concurrent import futures
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch import core as lp
from repro_torch.core.nodes import mesh as mesh_node
from repro_torch.launch import cells, train as launch_train
from repro_torch.models import convert, transformer
from repro_torch.sharding import group as group_lib, use_sharding
from repro_torch.sharding.collective_matmul import collective_matmul
from repro_torch.sharding.rules import (Spec, distribute, param_sharding,
                                        placements)

CFG = dataclasses.replace(launch_train.LM_TINY, num_layers=2,
                          compute_dtype="float32")
STARTED = []                      # MeshGroups this process started
_init = group_lib.MeshGroup.__init__


def _counted(self, *a, **kw):
    STARTED.append(a[0])
    _init(self, *a, **kw)


group_lib.MeshGroup.__init__ = _counted


class Service:
    """matmul: collective_matmul, W sharded over "model"; score: the LM
    loss, params placed by the rules. Plain tensors without a mesh."""

    def __init__(self, data_dir, peer=None, mesh=None):
        self._mesh, self._peer = mesh, peer
        w = torch.from_numpy(np.load(os.path.join(data_dir, "w.npy")))
        with open(os.path.join(data_dir, "params.pkl"), "rb") as f:
            params = convert.params_from_numpy(CFG, pickle.load(f), "cpu")
        if mesh is None:
            self._w, self._params = w, params
        else:
            self._w = distribute(
                {"w": w}, {"w": (mesh, placements(mesh, Spec(None,
                                                            "model")))})["w"]
            self._params = distribute(params, param_sharding(params, mesh))

    def matmul(self, x):
        x = torch.from_numpy(np.asarray(x))
        if self._mesh is None:
            return torch.matmul(x, self._w).numpy()
        return collective_matmul(x, self._w, self._mesh).full_tensor().numpy()

    def score(self, batch):
        b = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        with torch.no_grad():
            if self._mesh is None:
                return float(transformer.loss_fn(CFG, self._params, b)[0])
            with use_sharding(cells.sharding_ctx(self._mesh)):
                loss, _ = transformer.loss_fn(
                    CFG, self._params,
                    distribute(b, cells.batch_shardings(self._mesh, b)))
                return float(loss.full_tensor())

    def ping(self):
        return self._peer.value()


class Counter:
    def __init__(self):
        self._n = 0

    def value(self):
        self._n += 1
        return self._n


def requests(data_dir):
    """Each input twice: matmul and score alternately, then the other
    way round."""
    with open(os.path.join(data_dir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    pairs = list(zip(inputs["x"], inputs["batch"]))
    return ([("matmul", x) if i % 2 == 0 else ("score", b)
             for i, (x, b) in enumerate(pairs)]
            + [("score", b) if i % 2 == 0 else ("matmul", x)
               for i, (x, b) in enumerate(pairs)])


class Client:
    """Sends the requests ``repeat`` times, ``workers`` at a time, keeps
    the replies in ``REPLIES``, then runs ``then(svc)`` or stops the
    program."""
    REPLIES = []

    def __init__(self, svc, data_dir, workers=1, then=None, repeat=1):
        self._svc, self._dir = svc, data_dir
        self._workers, self._then, self._repeat = workers, then, repeat

    def run(self):
        reqs = requests(self._dir) * self._repeat
        with futures.ThreadPoolExecutor(self._workers) as pool:
            Client.REPLIES[:] = list(pool.map(
                lambda r: getattr(self._svc, r[0])(r[1]), reqs))
        if self._then is not None:
            self._then(self._svc)
        else:
            lp.stop_program()


def program(data_dir, shape, workers=1, then=None, peer=False,
            cls=None, repeat=1):
    p = lp.Program("mesh-node")
    if peer:
        with p.group("peer"):
            peer = p.add_node(lp.CourierNode(Counter))
    with p.group("svc"):
        svc = p.add_node(lp.MeshWorkerNode(cls or Service, data_dir,
                                           peer=peer or None))
    with p.group("client"):
        p.add_node(lp.PyNode(Client, svc, data_dir, workers, then, repeat))
    return p, {"svc": {"mesh": shape, "axes": ("data", "model"),
                       "device": "cpu"}}


def plain_replies(data_dir):
    ref = Service(data_dir)
    return [getattr(ref, m)(a) for m, a in requests(data_dir)]
'''


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
    env.pop("XLA_FLAGS", None)
    return env


def _session_alive(sid: int) -> bool:
    """Whether a process of session ``sid`` still runs. An exited one
    that its dead parent left unreaped (the process launcher's children
    leave multiprocessing's resource tracker so) does not."""
    states = subprocess.run(["ps", "-o", "stat=", "-s", str(sid)],
                            capture_output=True, text=True).stdout.split()
    return any(not st.startswith("Z") for st in states)


def run_rank0(argv: list) -> tuple[str, str]:
    """Run ``python <argv>`` in a session of its own under
    ``RANK_TIMEOUT_S``; assert that it exits 0 and leaves no process of
    its session behind. Returns (stdout, stderr)."""
    proc = subprocess.Popen([sys.executable, *argv], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_env(),
                            cwd=ROOT, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=RANK_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"rank 0 outlived {RANK_TIMEOUT_S} s: "
                             f"{err[-4000:]}")
    left = _session_alive(proc.pid)
    if left:
        os.killpg(proc.pid, signal.SIGKILL)
    assert proc.returncode == 0, err[-4000:]
    assert not left, "a process of the program outlived rank 0"
    return out, err


def run_program(tmp_path, body: str, *args) -> dict:
    """``_SERVICE`` + ``body`` (its entry point under ``__main__``) as the
    file ``prog.py``, run as rank 0; its last stdout line is JSON."""
    path = tmp_path / "prog.py"
    path.write_text(_SERVICE + textwrap.dedent(body))
    out, _ = run_rank0([str(path), *map(str, args)])
    return json.loads(out.strip().splitlines()[-1])


def make_data(d, seed: int = 11) -> None:
    """The weight, the model's params (the JAX layout) and the requests'
    inputs, made with numpy from ``seed``."""
    import dataclasses

    import torch
    from repro_torch.launch import train as launch_train
    from repro_torch.models import convert, transformer
    cfg = dataclasses.replace(launch_train.LM_TINY, num_layers=2,
                              compute_dtype="float32")
    rng = np.random.default_rng(seed)
    like = convert.params_to_numpy(cfg, transformer.init_params(
        cfg, 0, device="cpu", dtype=torch.float32))

    def draw(leaf):
        std = float(np.std(leaf))
        if std == 0.0:                               # norm scales
            return (leaf + 0.05 * rng.standard_normal(leaf.shape)
                    ).astype(np.float32)
        return (std * rng.standard_normal(leaf.shape)).astype(np.float32)

    def walk(tree):
        return ({k: walk(v) for k, v in tree.items()}
                if isinstance(tree, dict) else draw(np.asarray(tree)))

    d.mkdir(parents=True, exist_ok=True)
    with open(d / "params.pkl", "wb") as f:
        pickle.dump(walk(like), f)
    np.save(d / "w.npy", rng.standard_normal((D, F)).astype(np.float32))
    toks = [rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            for _ in range(N_REQUESTS // 2)]
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump({"x": [rng.standard_normal((B, S, D)).astype(np.float32)
                           for _ in range(N_REQUESTS // 2)],
                     "batch": [{"tokens": t, "labels": t} for t in toks]}, f)


def assert_replies_close(got, want, what):
    assert len(got) == len(want) == N_REQUESTS, what
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, float):
            assert np.isfinite(w)
            assert abs(g - w) <= LOSS_RTOL * abs(w), (what, i, g, w)
        else:
            g, w = np.asarray(g), np.asarray(w)
            assert g.shape == w.shape == (B, S, F), (what, i)
            assert np.abs(g - w).max() / np.abs(w).max() <= CM_TOL, (what,
                                                                      i)


# ---------------------------------------------------------------------------
# 1. parity with the JAX package's node
# ---------------------------------------------------------------------------

SHAPES = ["2,2", "2,1", "1,2"]

_JAX_NODES = '''
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import core as lp
from repro.ckpt.elastic import reshard
from repro.launch import cells, train as launch_train
from repro.models import transformer
from repro.sharding import ShardingCtx, use_sharding
from repro.sharding.collective_matmul import collective_matmul

CFG = dataclasses.replace(launch_train.LM_TINY, num_layers=2,
                          compute_dtype="float32")
d, shapes = sys.argv[1], sys.argv[2:]
with open(os.path.join(d, "inputs.pkl"), "rb") as f:
    inputs = pickle.load(f)
REQS = [("matmul", x) if i % 2 == 0 else ("score", b)
        for i, (x, b) in enumerate(zip(inputs["x"], inputs["batch"]))] + [
    ("score", b) if i % 2 == 0 else ("matmul", x)
    for i, (x, b) in enumerate(zip(inputs["x"], inputs["batch"]))]
REPLIES = {}


class Service:
    def __init__(self, mesh=None):
        self._mesh = mesh
        self._w = jax.device_put(np.load(os.path.join(d, "w.npy")),
                                 NamedSharding(mesh, P(None, "model")))
        with open(os.path.join(d, "params.pkl"), "rb") as f:
            self._params = reshard(pickle.load(f), mesh)
        self._loss = jax.jit(
            lambda p, b: transformer.loss_fn(CFG, p, b)[0])

    def matmul(self, x):
        xs = jax.device_put(x, NamedSharding(self._mesh,
                                             P("data", None, "model")))
        return np.asarray(collective_matmul(xs, self._w, self._mesh))

    def score(self, batch):
        b = jax.device_put(batch, cells.batch_shardings(self._mesh, batch))
        with use_sharding(ShardingCtx(self._mesh, dp=("data",))):
            return float(self._loss(self._params, b))


class Client:
    def __init__(self, svc, key):
        self._svc, self._key = svc, key

    def run(self):
        REPLIES[self._key] = [getattr(self._svc, m)(a) for m, a in REQS]
        lp.stop_program()


for shape in shapes:
    p = lp.Program("mesh-node")
    with p.group("svc"):
        svc = p.add_node(lp.MeshWorkerNode(Service))
    with p.group("client"):
        p.add_node(lp.PyNode(Client, svc, shape))
    lp.launch_and_wait(p, resources={"svc": {
        "mesh": tuple(int(s) for s in shape.split(",")),
        "axes": ("data", "model")}}, timeout_s=180)
with open(os.path.join(d, "jax.pkl"), "wb") as f:
    pickle.dump(REPLIES, f)
'''

_PARITY = '''
if __name__ == "__main__":
    d, shape = sys.argv[1], tuple(int(s) for s in sys.argv[2].split(","))
    p, res = program(d, shape)
    lp.launch_and_wait(p, resources=res, timeout_s=180)
    with open(os.path.join(d, f"port_{sys.argv[2]}.pkl"), "wb") as f:
        pickle.dump({"replies": Client.REPLIES,
                     "plain": plain_replies(d)}, f)
    print(json.dumps({"started": STARTED}))
'''


@pytest.fixture(scope="module")
def jax_replies(tmp_path_factory):
    """The JAX package's node on 4 host devices, every shape, one
    process."""
    d = tmp_path_factory.mktemp("mesh_node_data")
    make_data(d)
    env = _env()
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_NODES, str(d),
                           *SHAPES], capture_output=True, text=True,
                          timeout=RANK_TIMEOUT_S, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(d / "jax.pkl", "rb") as f:
        return d, pickle.load(f)


@pytest.mark.parametrize("shape", SHAPES)
def test_node_replies_equal_jax_node(shape, jax_replies, tmp_path):
    """The port's node on D·M gloo ranks (one MeshGroup, started by the
    node) answers as the JAX package's node on D·M host devices, and as
    the unsharded single-process service."""
    d, jax_out = jax_replies
    res = run_program(tmp_path, _PARITY, d, shape)
    assert res["started"] == [[int(s) for s in shape.split(",")]]
    with open(d / f"port_{shape}.pkl", "rb") as f:
        port = pickle.load(f)
    assert_replies_close(port["replies"], jax_out[shape], "port vs jax")
    assert_replies_close(port["replies"], port["plain"], "port vs plain")


# ---------------------------------------------------------------------------
# 2. concurrent calls run one after another
# ---------------------------------------------------------------------------

_CONCURRENT = '''
if __name__ == "__main__":
    d = sys.argv[1]
    p, res = program(d, (2, 1), workers=16, repeat=2)
    t0 = time.monotonic()
    lp.launch_and_wait(p, resources=res, timeout_s=180)
    with open(os.path.join(d, "concurrent.pkl"), "wb") as f:
        pickle.dump({"replies": Client.REPLIES,
                     "plain": plain_replies(d) * 2}, f)
    print(json.dumps({"s": time.monotonic() - t0}))
'''


def test_concurrent_calls_equal_single_process(tmp_path):
    """16 courier calls at once to a 2-rank node (the requests twice):
    the node runs them one after another on both ranks, so each reply
    equals the single-process service's, with no hang."""
    d = tmp_path / "data"
    make_data(d, seed=12)
    run_program(tmp_path, _CONCURRENT, d)
    with open(d / "concurrent.pkl", "rb") as f:
        res = pickle.load(f)
    got, want = res["replies"], res["plain"]
    assert len(got) == len(want) == 2 * N_REQUESTS
    for half in range(0, len(got), N_REQUESTS):
        assert_replies_close(got[half:half + N_REQUESTS],
                             want[half:half + N_REQUESTS], "concurrent")


# ---------------------------------------------------------------------------
# 3-5. what a follower cannot do, and how the node fails
# ---------------------------------------------------------------------------

_FAILS = '''
def fail_run(p, res, timeout_s=120):
    """The program's error and how long after ``MARK`` it came."""
    try:
        lp.launch_and_wait(p, resources=res, timeout_s=timeout_s)
    except lp.ProgramTestError as exc:
        return {"error": repr(exc.__cause__),
                "after_s": time.monotonic() - MARK[0],
                "started": STARTED}
    return {"error": None, "started": STARTED}


MARK = [0.0]


def kill_follower(svc):
    MARK[0] = time.monotonic()
    os.kill(mesh_node.current_group().pids[0], signal.SIGKILL)
    lp.get_current_context().wait_for_stop()


def use_peer(svc):
    MARK[0] = time.monotonic()
    svc.ping()
    lp.get_current_context().wait_for_stop()


def linger(svc):
    lp.get_current_context().wait_for_stop(2.0)
    lp.stop_program()


def make_local():
    class Local(Service):
        pass
    return Local


if __name__ == "__main__":
    d, case = sys.argv[1], sys.argv[2]
    if case == "kill":
        out = fail_run(*program(d, (2, 1), then=kill_follower))
    elif case == "handle":
        out = fail_run(*program(d, (2, 1), then=use_peer, peer=True))
    elif case == "local":
        out = fail_run(*program(d, (2, 1), cls=make_local()))
    else:                                   # two nodes, same or not
        p = lp.Program("two-nodes")
        for g in ("a", "b"):
            with p.group(g):
                svc = p.add_node(lp.MeshWorkerNode(Service, d))
            if case == "same":
                with p.group(f"client-{g}"):
                    p.add_node(lp.PyNode(Client, svc, d, 1, linger))
        other = (2, 1) if case == "same" else (1, 2)
        out = fail_run(p, {"a": {"mesh": (2, 1), "device": "cpu"},
                           "b": {"mesh": other, "device": "cpu"}})
    print(json.dumps(out))
'''


def _fails(tmp_path, case):
    d = tmp_path / "data"
    make_data(d, seed=13)
    return run_program(tmp_path, _FAILS, d, case)


def test_killed_follower_ends_the_program(tmp_path):
    """A follower killed while the node serves: the program ends with the
    group's error naming the rank, within seconds, and reaps every
    process it started."""
    res = _fails(tmp_path, "kill")
    assert res["error"] is not None and "RuntimeError" in res["error"]
    assert "mesh rank 1" in res["error"], res
    assert res["after_s"] < 60, res


def test_follower_handle_raises_naming_the_service(tmp_path):
    """A handle among the node's arguments reaches rank 0 only: rank 0's
    ``ping`` calls the Counter service, the follower's copy raises on its
    stub, naming the service, and the program ends with that error."""
    res = _fails(tmp_path, "handle")
    assert res["error"] is not None, res
    assert "mesh rank 1" in res["error"], res
    assert "Counter" in res["error"], res
    assert "reachable from rank 0" in res["error"], res


_MINUS_C = '''
import sys
from repro_torch import core as lp
from repro_torch.sharding import group as group_lib
STARTED = []
group_lib.MeshGroup.__init__ = lambda self, *a, **kw: STARTED.append(a)


class Service:
    def __init__(self, mesh=None):
        pass


p = lp.Program("minus-c")
with p.group("svc"):
    p.add_node(lp.MeshWorkerNode(Service))
try:
    lp.launch_and_wait(p, resources={"svc": {"mesh": (2, 1),
                                             "device": "cpu"}},
                       timeout_s=60)
except lp.ProgramTestError as exc:
    print(repr(exc.__cause__), STARTED)
'''


def test_class_without_a_file_is_refused(tmp_path):
    """A ``__main__`` class works (every program here defines its service
    in its file); a class local to a function, and one defined under
    ``python -c``, are refused before any follower starts."""
    res = _fails(tmp_path, "local")
    assert "ValueError" in res["error"] and "local to a function" in \
        res["error"], res
    assert res["started"] == []
    out, _ = run_rank0(["-c", _MINUS_C])
    assert "ValueError" in out and "without a file" in out, out
    assert out.strip().endswith("[]"), out


@pytest.mark.parametrize("case", ["same", "differ"])
def test_two_nodes_in_one_process(case, tmp_path):
    """Two multi-rank nodes of one process: with equal meshes they share
    one group (one set of followers) and both serve; with another shape
    the second is refused before it starts any follower."""
    res = _fails(tmp_path, case)
    assert res["started"] == [[2, 1]], res
    if case == "same":
        assert res["error"] is None, res
    else:
        assert "RuntimeError" in res["error"] and "differs" in \
            res["error"], res


# ---------------------------------------------------------------------------
# 6. under the process launcher
# ---------------------------------------------------------------------------

_PROCESS = '''
class Driver:
    def __init__(self, svc, data_dir):
        self._svc, self._dir = svc, data_dir

    def run(self):
        got = [getattr(self._svc, m)(a) for m, a in requests(self._dir)]
        kind = type(self._svc.transport).__name__
        with open(os.path.join(self._dir, "process.pkl"), "wb") as f:
            pickle.dump({"replies": got, "transport": kind}, f)
        lp.stop_program()


if __name__ == "__main__":
    d = sys.argv[1]
    p = lp.Program("mesh-node-process")
    with p.group("svc"):
        h = p.add_node(lp.MeshWorkerNode(Service, d))
    with p.group("driver"):
        p.add_node(lp.CourierNode(Driver, h, d))
    launcher = lp.ProcessLauncher()
    launcher.launch(p, resources={"svc": {"mesh": (2, 1),
                                          "axes": ("data", "model"),
                                          "device": "cpu"}})
    try:
        assert launcher.wait(timeout=180)
    finally:
        launcher.stop()
    with open(os.path.join(d, "process.pkl"), "rb") as f:
        res = pickle.load(f)
    with open(os.path.join(d, "process.pkl"), "wb") as f:
        pickle.dump(dict(res, plain=plain_replies(d)), f)
    print(json.dumps({}))
'''


def test_two_rank_node_under_process_launcher(tmp_path):
    """A (2, 1) node in a child process of the process launcher (the
    followers its children), served over its shm+grpc endpoint: its
    replies equal the single-process service's."""
    d = tmp_path / "data"
    make_data(d, seed=14)
    run_program(tmp_path, _PROCESS, d)
    with open(d / "process.pkl", "rb") as f:
        res = pickle.load(f)
    assert res["transport"] == "ShmTransport"
    assert_replies_close(res["replies"], res["plain"], "process launcher")
