"""``launch.train --mesh D,M`` across processes: the port's training
program on a ``("data", "model")`` mesh of D·M gloo ranks, rank 0 the
program's own process and ranks 1..D·M-1 the followers it starts
(``sharding.group``), against the plain program and against the JAX
package's ``build_program(mesh_shape=(2, 1))`` on 2 host devices.

Each program runs as rank 0 in a fresh process of its own session under
``RANK_TIMEOUT_S`` (its followers under it, its children), and every
test fails if any process of that session outlives rank 0. A follower
shares rank 0's stdout, where it prints its exit line (its rank, device
and mirrors' state).
"""

import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 240
# fp32 compute, where only the summation order of a split batch or a
# sharded product differs: each version's loss, and each leaf's
# |got - want|_2 / |want|_2 of the last version.
LOSS_RTOL = 1e-5
STATE_RTOL = 1e-5
STEPS = 4
# Longer than the spawner's 5 s stop grace: the step is still in flight
# when the program's group closes.
STOP_SLEEP_S = 6.0

_HEAD = """
import dataclasses, json, os, signal, sys, threading, time
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch import core as lp
from repro_torch.ckpt.checkpoint import ModelStore
from repro_torch.launch import train as launch_train
ARGS = sys.argv[1:]
CFG = dataclasses.replace(launch_train.LM_TINY, num_layers=2,
                          compute_dtype="float32")


def program(ckpt, mesh, **kw):
    kw = dict(dict(steps=%d, batch_size=8, seq_len=32, with_eval=False,
                   publish_every=1, device="cpu"), **kw)
    return launch_train.build_program(CFG, ckpt_dir=ckpt, mesh_shape=mesh,
                                      **kw)


class Recorded(launch_train.MeshGroup):
    \"\"\"The program's group, kept for the test to read.\"\"\"
    last = None

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        Recorded.last = self


launch_train.MeshGroup = Recorded
""" % STEPS


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
    env.pop("XLA_FLAGS", None)
    return env


def _session_alive(pgid: int) -> bool:
    try:
        os.killpg(pgid, 0)
    except ProcessLookupError:
        return False
    return True


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


def run_body(body: str, *args) -> dict:
    """``_HEAD`` + ``body`` as rank 0 (``run_rank0``); its last stdout
    line is JSON, and ``followers`` holds the followers' exit lines."""
    out, _ = run_rank0(["-c", _HEAD + textwrap.dedent(body),
                        *map(str, args)])
    lines = out.strip().splitlines()
    return dict(json.loads(lines[-1]), followers=[
        json.loads(line) for line in lines[:-1]
        if line.startswith('{"mesh_rank"')])


def _store(d):
    from repro_torch.ckpt.checkpoint import ModelStore
    return ModelStore(str(d))


def _losses(d, versions) -> list:
    s = _store(d)
    return [s.metadata(v)["loss"] for v in versions]


def _assert_state_close(got_dir, want_dir, version):
    from repro_torch.ckpt.checkpoint import restore
    got = restore(_store(got_dir).version_dir(version))
    want = restore(_store(want_dir).version_dir(version))
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype, name
        diff = np.linalg.norm(got[name].astype(np.float64) - arr)
        assert diff <= STATE_RTOL * np.linalg.norm(arr), name


_PLAIN_AND_MESH = """
d, shape = ARGS[0], tuple(int(s) for s in ARGS[1].split(","))
for label, mesh in (("plain", None), ("mesh", shape)):
    lp.launch_and_wait(program(f"{d}/{label}", mesh), timeout_s=180)
print(json.dumps({"world": Recorded.last.world}))
"""


@pytest.mark.parametrize("shape", ["2,1", "1,2"])
def test_mesh_program_equals_plain_program(shape, tmp_path):
    """a) ``build_program(mesh_shape=)`` on 2 gloo ranks, one learner at
    fp32 compute publishing every step: each version's loss equals the
    plain program's (``mesh_shape=None``), and so does each leaf of the
    last version; the follower held the learner's mirror to the end."""
    res = run_body(_PLAIN_AND_MESH, tmp_path, shape)
    assert res["world"] == 2
    [follower] = res["followers"]
    assert follower["mesh_rank"] == 1 and follower["device"] == "cpu"
    assert follower["learners"]["learner-0"]["step"] == STEPS
    versions = list(range(1, STEPS + 1))
    plain, mesh = tmp_path / "plain", tmp_path / "mesh"
    assert _store(plain).versions() == _store(mesh).versions() == versions
    want = _losses(plain, versions)
    assert all(np.isfinite(want))
    np.testing.assert_allclose(_losses(mesh, versions), want,
                               rtol=LOSS_RTOL)
    _assert_state_close(mesh, plain, STEPS)


_JAX_PROGRAM = """
import dataclasses, os, shutil
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
import numpy as np
from repro import core as lp
from repro.ckpt.checkpoint import ModelStore
from repro.launch import train as launch_train
from repro.train import fabric, optimizer as opt_lib
from repro.train.optimizer import OptimizerConfig
from repro.train.train_step import TrainConfig
d = sys.argv[1]
cfg = dataclasses.replace(launch_train.LM_TINY, num_layers=2,
                          compute_dtype="float32")
params = launch_train.LMTask(cfg, TrainConfig(
    optimizer=OptimizerConfig())).init_params(jax.random.key(3))
ModelStore(f"{d}/seed").publish_version(0, fabric.host_tree({
    "params": params, "opt": opt_lib.init_opt_state(params),
    "ef": jax.tree.map(lambda x: np.zeros(x.shape, np.float32), params)}),
    metadata={"step": 0})
for to in ("jax", "port"):
    shutil.copytree(f"{d}/seed", f"{d}/{to}")
lp.launch_and_wait(launch_train.build_program(
    cfg, steps=%d, ckpt_dir=f"{d}/jax", batch_size=8, seq_len=32,
    with_eval=False, publish_every=1, mesh_shape=(2, 1)), timeout_s=180)
""" % STEPS

_PORT_FROM_SEED = """
d = ARGS[0]
lp.launch_and_wait(program(f"{d}/port", (2, 1)), timeout_s=180)
print(json.dumps({}))
"""


def test_mesh_program_equals_jax_mesh_program(tmp_path):
    """b) Both stores seeded with one version the JAX package published
    (its seeded init at step 0), which each program's learner restores
    when it is built: the port's program on 2 gloo ranks and the JAX
    package's ``build_program(mesh_shape=(2, 1))`` on 2 placeholder host
    devices take the same fp32 steps on the same batches, version by
    version, within ``LOSS_RTOL``."""
    env = _env()
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run(
        [sys.executable, "-c", "import sys\n" + _JAX_PROGRAM,
         str(tmp_path)], capture_output=True, text=True,
        timeout=RANK_TIMEOUT_S, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    run_body(_PORT_FROM_SEED, tmp_path)
    versions = list(range(STEPS + 1))
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    assert _store(jax_dir).versions() == _store(port_dir).versions() \
        == versions
    want = _losses(jax_dir, versions[1:])
    assert all(np.isfinite(want))
    np.testing.assert_allclose(_losses(port_dir, versions[1:]), want,
                               rtol=LOSS_RTOL)


PUBLISH_EVERY = 2
KILL_STEPS = 10

_CHIEF_KILLED = """
d = ARGS[0]
seen = {}


class ChaosAfterPublish(launch_train.ChaosNode):
    \"\"\"Kills learner-0 once it has published a version, then records
    the step its next incarnation starts from.\"\"\"

    def __init__(self, registry, schedule):
        super().__init__(registry, schedule)
        self._registry = registry

    @staticmethod
    def _after_live(registry, name, delay_s):
        def pred():
            try:
                live = registry.lookup()["replicas"]
            except Exception:  # noqa: BLE001 - registry not up yet
                return False
            for r in live:
                if r["name"] == name and r["load"].get("version"):
                    seen["kill_step"] = r["load"]["step"]
                    return True
            return False
        return pred

    def run(self):
        super().run()
        ctx = lp.get_current_context()
        while not ctx.should_stop:
            try:
                for r in self._registry.lookup()["replicas"]:
                    if r["name"] == "learner-0" and r["load"]["start_step"]:
                        seen["restored"] = r["load"]["start_step"]
            except Exception:  # noqa: BLE001 - registry stopping
                pass
            ctx.wait_for_stop(0.02)


launch_train.ChaosNode = ChaosAfterPublish
lp.launch_and_wait(program(
    d, (2, 1), steps=%d, learners=2, publish_every=%d, kill_after=0.0,
    registry_ttl_s=1.0, heartbeat_s=0.1), timeout_s=180)
print(json.dumps({"seen": seen, "last": ModelStore(d).latest_version()}))
""" % (KILL_STEPS, PUBLISH_EVERY)


def test_mesh_program_survives_the_chief_kill(tmp_path):
    """c) Two learners on the 2-rank mesh, the chief killed after its
    first publish: the supervisor respawns it from the last published
    version (no step lost beyond ``publish_every``), its construction
    is sent to the follower, which drops the dead incarnation's shards
    and holds a later incarnation's, restored from that version, to the
    last step (a call for any other incarnation fails the follower)."""
    res = run_body(_CHIEF_KILLED, tmp_path)
    seen = res["seen"]
    assert res["last"] == KILL_STEPS
    assert "kill_step" in seen and seen.get("restored"), seen
    assert 0 <= seen["kill_step"] - seen["restored"] <= PUBLISH_EVERY
    [follower] = res["followers"]
    mirrors = follower["learners"]
    assert sorted(mirrors) == ["learner-0", "learner-1"]
    chief = mirrors["learner-0"]
    assert chief["step"] == KILL_STEPS
    assert chief["restored_from"] == seen["restored"]
    assert chief["incarnation"] > mirrors["learner-1"]["incarnation"]


_FOLLOWER_KILLED = """
d = ARGS[0]
out = {}


def kill_follower():
    while Recorded.last is None or ModelStore(d).latest_version() is None:
        time.sleep(0.02)
    os.kill(Recorded.last.pids[0], signal.SIGKILL)
    out["killed_at"] = time.monotonic()


threading.Thread(target=kill_follower, daemon=True).start()
try:
    lp.launch_and_wait(program(d, (2, 1), steps=100000), timeout_s=180)
except lp.ProgramTestError as exc:
    out["error"] = repr(exc.__cause__)
    out["raised_after_s"] = time.monotonic() - out["killed_at"]
print(json.dumps(out))
"""


def test_mesh_program_ends_when_a_follower_dies(tmp_path):
    """d) The follower killed mid-run: the program raises (the group's
    error, naming the lost rank) within seconds, not a hang, and reaps
    every process it started."""
    res = run_body(_FOLLOWER_KILLED, tmp_path)
    assert "error" in res, res
    assert "rank" in res["error"] and "RuntimeError" in res["error"]
    assert res["raised_after_s"] < 60


_STOPPED_MID_STEP = """
from repro_torch.train import fabric
d, sleep_s = ARGS[0], float(ARGS[1])
grads, in_flight = fabric.LearnerWorker._grads, threading.Event()


def slow_grads(self, **kw):
    # Rank 0 only: the follower has the command and waits in the step's
    # collectives meanwhile.
    if self._step == 1 and not in_flight.is_set():
        in_flight.set()
        time.sleep(sleep_s)
    return grads(self, **kw)


fabric.LearnerWorker._grads = slow_grads
launcher = lp.ThreadLauncher(restart_policy=lp.RestartPolicy(max_restarts=0))
launcher.launch(program(d, (2, 1), steps=100000))
assert in_flight.wait(120)
t0 = time.monotonic()
launcher.stop()
done = launcher.wait(timeout=120)
print(json.dumps({"done": done, "stop_s": time.monotonic() - t0,
                  "failures": [repr(f.error) for f in launcher.failures]}))
"""


def test_mesh_program_stops_while_a_step_is_in_flight(tmp_path):
    """f) The program stopped while a mesh step is in flight on rank 0
    and outlasts the spawner's stop grace: closing the group waits for
    the step's collectives before it sends the exit command, so the
    follower exits 0 with its exit line, nothing fails, and no reap
    timeout is waited out."""
    from repro_torch.sharding.group import REAP_TIMEOUT_S
    res = run_body(_STOPPED_MID_STEP, tmp_path, STOP_SLEEP_S)
    assert res["done"] and res["failures"] == [], res
    assert res["stop_s"] < REAP_TIMEOUT_S
    [follower] = res["followers"]
    assert follower["mesh_rank"] == 1
    assert follower["learners"]["learner-0"]["step"] >= 1


def test_train_cli_runs_a_two_rank_mesh(tmp_path):
    """e) ``python -m repro_torch.launch.train --device cpu --mesh 2,1``
    runs to done as 2 processes and leaves none behind."""
    run_rank0(["-m", "repro_torch.launch.train", "--device", "cpu",
               "--mesh", "2,1", "--steps", "6", "--publish-every", "2",
               "--batch-size", "8", "--seq-len", "32",
               "--ckpt-dir", str(tmp_path)])
    assert _store(tmp_path).latest_version() == 6
