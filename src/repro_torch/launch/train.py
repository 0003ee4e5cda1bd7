"""End-to-end LM training as a Launchpad program — on the elastic fabric.

Topology (the paper's patterns composed, surviving worker churn):

    registry (CourierNode: membership + heartbeats, the control plane)
    data (CourierNode × N, prefetching pipeline shards)
      -> learners (fabric workers: chief aggregates peer gradients via
         hedged_map quorum, publishes {params, opt, ef} to the versioned
         ModelStore in ckpt_dir every --publish-every steps)
      <- supervisor (PyNode: spawns the learner fleet, respawns dead
         workers under RestartPolicy backoff; a respawned chief restores
         the last *published* version — step loss <= publish interval)
    evaluator (PyNode: pulls published versions from the store, reports
         eval loss — never an ad-hoc RPC params snapshot)

The port of ``repro.launch.train``: every node runs on ``device`` (the
CUDA card unless ``--device cpu``). The learners train through the flash
kernel and its backward on a card (``impl="train"``; dense on the CPU
or on a mesh); the evaluator scores
published versions under ``torch.no_grad()`` with ``impl="auto"``,
which on the card is the prefill flash-attention kernel (K3). Versions
are published in the JAX package's layout, so either package's learners
and evaluators read the other's. ``--mesh D,M`` places every learner's
state on a ``("data", "model")`` DeviceMesh of D·M ranks: one mesh,
built once by the supervisor and shared by its learner threads, as the
JAX program's mesh of D·M local devices is. A torch mesh spans one
process per device: this process is rank 0, and the supervisor starts
ranks 1..D·M-1 as follower processes (``sharding.group``) that replay
each learner's collective work on the batches rank 0 draws. With
``--device cpu`` the ranks are gloo processes; on "cuda" rank r takes
card r over nccl, and a mesh of more ranks than visible cards raises.
``--mesh 1,1`` needs no follower: its group of one starts in-process.
A follower that dies ends the program with an error.

``--trace-every N`` makes the chief learner trace every Nth step (its
``train.*`` spans, ``train/fabric.py``); ``--telemetry-dir DIR`` adds a
``TelemetryHub`` that scrapes the registry and every registered learner
and writes ``telemetry.json`` and a Perfetto ``trace.json`` there.

The learner is a *stateful node in the paper-§6 sense*: on restart it
restores from the latest published version and continues; data nodes and
the evaluator are stateless and just restart.

    PYTHONPATH=src python -m repro_torch.launch.train --steps 200
    PYTHONPATH=src python -m repro_torch.launch.train --learners 2
    PYTHONPATH=src python -m repro_torch.launch.train --kill-after 3 \
        --learners 2
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --arch qwen2-1.5b
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --mesh 1,1
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --mesh 2,1 --steps 6
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --steps 6 --trace-every 2 --telemetry-dir /tmp/train-tel
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch import configs, core as lp
from repro_torch.ckpt.checkpoint import ModelStore
from repro_torch.data.pipeline import DataConfig, Prefetcher, make_source
from repro_torch.models import convert, transformer
from repro_torch.models.config import ATTN, ModelConfig
from repro_torch.serve.engine import resolve_device
from repro_torch.sharding.compat import make_mesh, rank_devices
from repro_torch.sharding.group import MeshGroup
from repro_torch.train.fabric import (ChaosNode, FabricConfig, LearnerWorker,
                                      ThreadWorkerSpawner, TrainSupervisor)
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import (Replayed, TrainConfig, make_grad_fn,
                                          to_device)

# A self-contained ~100M-param preset (brief: "train ~100M model").
LM100M = ModelConfig(
    name="lm100m", family="dense", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=4, d_ff=3072, vocab_size=32768,
    pattern=(ATTN,), tie_embeddings=True)

LM_TINY = ModelConfig(
    name="lm-tiny", family="dense", num_layers=4, d_model=128,
    num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=512,
    pattern=(ATTN,), tie_embeddings=True)

PRESETS = {"lm100m": LM100M, "tiny": LM_TINY}


class DataNode:
    """Serves host-sharded batches from the pipeline (prefetched)."""

    def __init__(self, data_cfg: DataConfig, host_id: int, num_hosts: int):
        self._pf = Prefetcher(make_source(data_cfg, host_id, num_hosts),
                              depth=4)

    def next_batch(self):
        return next(self._pf)


class LMTask:
    """The fabric task for LM pretraining: transformer loss + AdamW, with
    master weights in ``cfg.param_dtype`` drawn on ``device``. Its state
    goes to the store in the JAX package's layout.

    The gradient function is ``train_step.Replayed``: the learner updates
    its parameters in place on a card (``optimizer.apply_updates_``), so
    from its second step on the pass replays as one CUDA graph. What
    ``grad_fn`` returns then lives in the graph's memory until the next
    call; the learner consumes it before then.

    For a stack of dropless expert layers the pass also leaves, on the
    device, the rows each held expert computed, summed over the
    microbatches; ``read_step`` reads their sum and their largest entry
    back with the loss, in one copy, beside the pairs the step routed
    (layers x tokens x top-k, counted on the host)."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 device="cuda"):
        self._model_cfg = model_cfg
        self._train_cfg = train_cfg
        self._device = resolve_device(device)
        self.optimizer = train_cfg.optimizer
        self._compute = Replayed(make_grad_fn(model_cfg, train_cfg),
                                 train_cfg.num_microbatches)
        # The rows of the last pass, per calling thread: the learners of
        # one process share the task.
        self._last = threading.local()

    def __reduce__(self):
        # A mesh follower rebuilds the task on its own card of this type.
        return LMTask, (self._model_cfg, self._train_cfg, self._device.type)

    def init_params(self, seed: int):
        return transformer.init_params(self._model_cfg, seed,
                                       device=self._device,
                                       dtype=self._model_cfg.param_dtype)

    def grad_fn(self, params, batch):
        loss, aux, grads = self._compute(params, batch)
        self._last.rows = aux.get("moe_rows")
        if self._last.rows is not None:
            self._last.pairs = (self._last.rows.shape[0]
                                * batch["tokens"].numel()
                                * self._model_cfg.experts_per_token)
        return loss, grads

    def read_step(self, loss) -> tuple[float, dict]:
        """(the loss as a float, the step's readings): with held experts,
        ``moe.rows_held``, the rows all of them computed in every layer,
        and ``moe.rows_max``, the busiest one's, read back with the loss
        in one copy, and ``moe.pairs``, the (token, choice) pairs routed
        in every layer: rows_held / pairs is the share of the pairs the
        pair kernels touch."""
        rows = getattr(self._last, "rows", None)
        self._last.rows = None
        if rows is None:
            return float(loss), {}
        host = torch.stack([loss.float(), rows.sum(), rows.max()]).tolist()
        return host[0], {"moe.rows_held": host[1], "moe.rows_max": host[2],
                         "moe.pairs": self._last.pairs}

    def state_to_numpy(self, state: dict) -> dict:
        return convert.train_state_to_numpy(self._model_cfg, state)

    def state_from_numpy(self, tree: dict, device) -> dict:
        return convert.train_state_from_numpy(self._model_cfg, tree, device)


def _data_batch_fn(data_nodes):
    """Learner batch source over its assigned data-node shard(s); errors
    return None so the learner retries while a data node restarts."""
    def fn():
        try:
            shards = [d.next_batch() for d in data_nodes]
            return {k: np.concatenate([s[k] for s in shards])
                    for k in shards[0]}
        except Exception:  # noqa: BLE001
            return None
    return fn


# How long a stopping fleet waits for its learners' threads: a learner
# stops between steps, and a step of a model at 8k tokens takes seconds
# (about 5.5 s for Mellum2's share on an H100), so the wait covers one. A
# learner left running past it would hold its state and its graph's pool
# on the card while whatever comes after the program allocates there.
LEARNER_STOP_S = 120.0


class FleetSupervisor:
    """PyNode wrapper: hosts the learner fleet on a ThreadWorkerSpawner
    and runs the TrainSupervisor loop until the chief reports done."""

    def __init__(self, registry, data_nodes, model_cfg: ModelConfig,
                 train_cfg: TrainConfig, fab_cfg: FabricConfig,
                 store_dir: str, learners: int = 1, mesh_shape=None,
                 device="cuda", spawn_grace_s: float = 30.0):
        self._registry = registry
        self._data = list(data_nodes)
        self._task = LMTask(model_cfg, train_cfg, device)
        self._device = device
        self._fab_cfg = fab_cfg
        self._store_dir = store_dir
        self._learners = learners
        self._mesh_shape = mesh_shape
        self._spawn_grace_s = spawn_grace_s

    def _make_mesh(self):
        """(mesh, group): the learners' mesh, on the supervisor's device,
        built once, before any learner starts, and shared by them all;
        for more than one rank, with the group of follower processes that
        spans it (``MeshGroup``, this process rank 0)."""
        if self._mesh_shape is None:
            return None, None
        shape = tuple(self._mesh_shape)
        names = ("data", "model")[: len(shape)]
        if math.prod(shape) == 1:
            return make_mesh(shape, names,
                             resolve_device(self._device).type), None
        group = MeshGroup(shape, names, self._device)
        return group.mesh, group

    def run(self):
        spawner = ThreadWorkerSpawner()
        n_learners = self._learners
        mesh, group = self._make_mesh()

        def spawn_fn(name: str):
            idx = int(name.rsplit("-", 1)[1])
            shard = self._data[idx::n_learners] or [
                self._data[idx % len(self._data)]]
            batch_fn = _data_batch_fn(shard)
            spawner.spawn(name, lambda n, ep: LearnerWorker(
                self._task, batch_fn, self._store_dir, self._registry,
                self._fab_cfg, name=n, chief=(idx == 0),
                device=self._device, mesh=mesh, group=group, endpoint=ep))

        sup = TrainSupervisor(
            self._registry, spawn_fn, expected={"learner": n_learners},
            policy=lp.RestartPolicy(max_restarts=5, backoff_s=0.05),
            spawn_grace_s=self._spawn_grace_s,
            total_steps=self._fab_cfg.total_steps,
            check=None if group is None else group.check)
        try:
            sup.run()
        finally:
            spawner.stop_all(timeout_s=LEARNER_STOP_S)
            if group is not None:
                group.close()


class Evaluator:
    """Scores published versions from the ModelStore on a held-out
    stream — always a consistent, durable snapshot — on ``device``,
    through the kernels there (``impl="auto"``)."""

    def __init__(self, store_dir: str, model_cfg: ModelConfig,
                 data_cfg: DataConfig, every_s: float = 5.0, device="cuda"):
        self._store_dir = store_dir
        self._cfg = model_cfg
        self._src = iter(make_source(dataclasses.replace(data_cfg, seed=999)))
        self._every = every_s
        self._device = resolve_device(device)

    def score(self, params: dict, batch: dict, impl: str = "auto") -> float:
        """The loss of ``params`` (the port's tree, in the compute dtype,
        on the device) on a numpy ``batch``."""
        with torch.no_grad():
            loss, _ = transformer.loss_fn(
                self._cfg, params, to_device(batch, self._device), impl=impl)
        return float(loss)

    def run(self):
        ctx = lp.get_current_context()
        store = ModelStore(self._store_dir)
        like = convert.params_to_numpy(self._cfg, transformer.init_params(
            self._cfg, 0, device="cpu", dtype=self._cfg.param_dtype))
        seen: Optional[int] = None
        while not ctx.should_stop:
            ctx.wait_for_stop(self._every)
            if ctx.should_stop:
                return
            try:
                v = store.latest_version()
                if v is None or v == seen:
                    continue
                params = store.load_version(v, like={"params": like})["params"]
                seen = v
            except Exception:  # noqa: BLE001 - version GC'd mid-read
                continue
            batch = next(self._src)
            loss = self.score(convert.params_from_numpy(
                self._cfg, params, self._device), batch)
            print(f"  eval v{v} loss: {loss:.4f}", flush=True)


def build_program(model_cfg: ModelConfig, *, steps: int, ckpt_dir: str,
                  batch_size: int = 16, seq_len: int = 64,
                  num_data_nodes: int = 2, num_micro: int = 1,
                  mesh_shape=None, with_eval: bool = True,
                  learners: int = 1, publish_every: int = 50,
                  kill_after: Optional[float] = None,
                  # Generous TTL: a first-step jit trace can starve the
                  # heartbeat thread for seconds; that is a stall, not a
                  # death, and should not trigger a respawn.
                  registry_ttl_s: float = 10.0,
                  heartbeat_s: float = 0.2,
                  telemetry_dir: Optional[str] = None, trace_every: int = 0,
                  grad_strategy: str = "auto",
                  device="cuda") -> lp.Program:
    """The training topology on ``device`` (a CUDA card must exist unless
    ``device="cpu"``), its learners on a ``mesh_shape`` mesh when one is
    given (a mesh of more ranks than cards raises here).

    ``trace_every=N`` makes the chief trace every Nth step;
    ``telemetry_dir`` adds a TelemetryHub node that scrapes the registry
    and the learners registered there and writes ``telemetry.json`` and
    ``trace.json`` into it."""
    resolve_device(device)
    if mesh_shape is not None:
        rank_devices(mesh_shape, device)
    data_cfg = DataConfig(seq_len=seq_len,
                          batch_size=batch_size // num_data_nodes,
                          vocab_size=model_cfg.vocab_size)
    train_cfg = TrainConfig(
        optimizer=OptimizerConfig(lr=1e-3, warmup_steps=20, total_steps=steps),
        num_microbatches=num_micro)
    fab_cfg = FabricConfig(total_steps=steps, batch_size=batch_size,
                           publish_every=publish_every,
                           heartbeat_s=heartbeat_s, trace_every=trace_every,
                           grad_strategy=grad_strategy)

    p = lp.Program(f"train-{model_cfg.name}")
    with p.group("registry"):
        registry = p.add_node(lp.CourierNode(lp.Registry,
                                             ttl_s=registry_ttl_s))
    with p.group("data"):
        data = [p.add_node(lp.CourierNode(DataNode, data_cfg, i,
                                          num_data_nodes))
                for i in range(num_data_nodes)]
    with p.group("supervisor"):
        p.add_node(lp.PyNode(FleetSupervisor, registry, data, model_cfg,
                             train_cfg, fab_cfg, ckpt_dir,
                             learners=learners, mesh_shape=mesh_shape,
                             device=device))
    if kill_after is not None:
        with p.group("chaos"):
            p.add_node(lp.PyNode(
                ChaosNode, registry,
                [("kill", "learner-0", kill_after, 0.0)]))
    if telemetry_dir is not None:
        with p.group("telemetry"):
            p.add_node(lp.PyNode(
                lp.TelemetryHub, registry, targets=[registry],
                poll_s=max(heartbeat_s, 0.1), out_dir=telemetry_dir))
    if with_eval:
        with p.group("eval"):
            p.add_node(lp.PyNode(Evaluator, ckpt_dir, model_cfg, data_cfg,
                                 device=device))
    return p


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="assigned arch id")
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant of --arch")
    ap.add_argument("--experts-held", default=None, metavar="A,B",
                    help="hold experts A..B-1 of --arch's dropless expert "
                         "layers: one chip's share of expert parallelism")
    ap.add_argument("--vocab-size", type=int, default=None,
                    help="keep the first N rows of --arch's vocabulary")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-strategy", default="auto",
                    choices=("auto", "dense", "int8_ef"),
                    help="the gradient's form on the wire and in the "
                         "update; auto: int8_ef for a gradient of 4 MiB "
                         "or more, whose error-feedback residual is a "
                         "second copy of it")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train_ckpt")
    ap.add_argument("--learners", type=int, default=1,
                    help="data-parallel learner count (chief = learner-0)")
    ap.add_argument("--publish-every", type=int, default=50,
                    help="ModelStore publish interval = max step loss on "
                         "a learner death")
    ap.add_argument("--kill-after", type=float, default=None,
                    help="chaos demo: kill the chief learner this many "
                         "seconds in; the supervisor restores it from the "
                         "last published version")
    ap.add_argument("--mesh", default=None,
                    help="e.g. 2,1 -> data=2,model=1: the learners' "
                         "DeviceMesh, one process a rank (needs a card a "
                         "rank on cuda)")
    ap.add_argument("--telemetry-dir", default=None, metavar="DIR",
                    help="run a TelemetryHub and write telemetry.json + "
                         "trace.json (Perfetto) here")
    ap.add_argument("--trace-every", type=int, default=0, metavar="N",
                    help="the chief traces every Nth step (0 = off)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    args = ap.parse_args(argv)

    if args.arch:
        model_cfg = (configs.get_reduced(args.arch) if args.reduced
                     else configs.get(args.arch))
    else:
        model_cfg = PRESETS[args.preset]
    if args.experts_held:
        lo, hi = (int(x) for x in args.experts_held.split(","))
        model_cfg = dataclasses.replace(model_cfg, experts_held=(lo, hi))
    if args.vocab_size:
        model_cfg = dataclasses.replace(model_cfg,
                                        vocab_size=args.vocab_size)

    mesh_shape = (tuple(int(x) for x in args.mesh.split(","))
                  if args.mesh else None)
    program = build_program(model_cfg, steps=args.steps,
                            ckpt_dir=args.ckpt_dir,
                            batch_size=args.batch_size,
                            seq_len=args.seq_len,
                            num_micro=args.microbatches,
                            learners=args.learners,
                            publish_every=args.publish_every,
                            kill_after=args.kill_after,
                            mesh_shape=mesh_shape,
                            telemetry_dir=args.telemetry_dir,
                            trace_every=args.trace_every,
                            grad_strategy=args.grad_strategy,
                            device=args.device)
    print(program)
    # The mesh's followers are not restarted: their loss ends the program.
    launcher = lp.ThreadLauncher(
        restart_policy=lp.RestartPolicy(max_restarts=2),
        per_group_restart=({"supervisor": lp.NO_RESTART}
                           if mesh_shape and math.prod(mesh_shape) > 1
                           else None))
    launcher.launch(program)
    launcher.wait()
    if launcher.fatal_failures:
        raise SystemExit(f"fatal failure: {launcher.fatal_failures[0]}")


if __name__ == "__main__":
    # From the module's own name, so that the task a mesh's followers
    # unpickle is repro_torch.launch.train.LMTask, not __main__'s.
    from repro_torch.launch.train import main as _main
    _main()
