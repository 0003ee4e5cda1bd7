"""Elastic actor–learner training fabric (paper §5.4 on the serve stack)
— the port of ``repro.train.fabric``.

The Launchpad paper's training topologies — actor–learner and parameter
server — predate the discovery/rollout fabric PRs 5–8 built for serving.
This module ports them onto it, with the serve fleet's survival story:

``LearnerWorker``
    One data-parallel learner. Registers and heartbeats through the
    ``Registry`` like an engine replica (load reports carry the step and
    the published model version). The *chief* learner (index 0 — chiefship
    is assigned at spawn, never self-elected, matching the paper's
    scheduler-restarts model) drives synchronous steps: it resolves the
    live peer set from the registry, fans ``compute_grads`` out to every
    peer via ``hedged_map`` (quorum over survivors, per-peer failures
    degrade the quorum instead of failing the step), averages the
    contributions, applies the update, and publishes ``{params, opt, ef}``
    to the versioned ``ModelStore`` every ``publish_every`` steps — actors
    always pull a consistent version, never an ad-hoc RPC snapshot.
    Gradients cross the wire dense or int8+error-feedback
    (``grad_compression``), selected by gradient size.

``ActorWorker``
    Generates experience with the latest published params and writes it
    into replay. A rate-limited insert that stalls past its deadline
    raises the typed ``WriterStalled`` (instead of blocking forever on a
    dead sampler); the actor fails over by re-resolving the replay
    service from the registry and keeps going.

``TrainSupervisor``
    Sibling of ``serve.rollout.RolloutController``: stateless over the
    registry's membership table. Detects dead workers (missed heartbeats
    → TTL eviction), respawns them under ``RestartPolicy`` backoff, and
    applies elastic resizes (``scale``): grown learners restore the
    latest published version onto their device via
    ``ckpt.elastic.restore_elastic``; shrunk learners are retired
    gracefully. A respawned chief restores from the last published
    version, so a learner death costs at most ``publish_every`` steps.
    A ``check`` given to it (a mesh group's) ends the run by raising.

``ThreadWorkerSpawner``
    The in-process stand-in for "the scheduler restarts the executable":
    hosts workers on daemon threads behind inproc couriers, giving each
    respawn a fresh endpoint while the registry keeps the logical name.

In the port, a learner's params, optimizer state and error-feedback
residual live on its device (``device=``, a CUDA card unless ``"cpu"``
is asked for); the wire and the store see numpy. On a card the optimizer
updates params and state in place (``optimizer.apply_updates_``): what
reads them (publishing, the wire, ``_gathered``'s callers) copies them
before the next step. The task's duck type
takes a seed (``init_params(seed)``) where the JAX package takes a
``jax.random`` key. A task may convert its state to and from the store's
layout (``state_to_numpy(state)``, ``state_from_numpy(tree, device)``:
the LM task publishes the JAX package's tree, so either package restores
the other's versions); without them the state is stored as it is.

The chief traces every ``FabricConfig.trace_every``-th step (numbered
from 1, as ``history`` and the published versions are): a fresh trace
whose root ``train.step`` holds ``train.data`` (the wait for a batch),
``train.grads`` (with ``train.forward``, ``train.backward`` and
``train.accumulate`` per microbatch from ``train_step.make_grad_fn``,
or ``train.replay`` where the pass is replayed from a CUDA graph
(``train_step.Replayed``, as ``launch.train.LMTask`` wraps it), after
``train.capture`` on the step that captures it; then ``train.sync``,
the loss read back to the host) and ``train.update`` (with
``train.optimizer``). On a CUDA device the root carries
``alloc_retries``, the caching allocator's retries during the step. A
task with ``read_step`` reads the step's other readings back in the
same copy as the loss (the LM task of a dropless expert stack: its held
experts' rows); each reading ``r`` adds to the counter ``train.r`` and
is an attribute of that name on the root. The
spans land in the process's ring (``core.telemetry``), on the wall clock;
an untraced step pays one context-variable read a span. A peer's
``compute_grads`` carries the trace in its courier envelope, so the
peer's forward, backward and sync spans join the step's trace; the
followers of a mesh group record nothing.

A learner given ``mesh=`` (a ``DeviceMesh``) holds its params and
optimizer state as DTensors placed by the sharding rules
(``ckpt.elastic.reshard``) and runs its grad function under the mesh's
sharding context; the error-feedback residual, which only the wire
reads, stays a local tensor. A recovered learner restores in the store's
layout, converts (``from_store``) and then reshards. Publishing and the
gradient wire gather to numpy, as without a mesh. The work with
collectives runs through ``on_ranks`` on every rank of the mesh, in
lockstep. Either every rank builds the learner itself and steps it (rank
0's batch wins: each rank keeps its shard of it), or, as ``launch.train``
does on a mesh of more than one process, rank 0 alone runs the learner
with ``group=`` (a ``sharding.group.MeshGroup``) and sends each such
call to a ``mirror`` of it on every other rank, with the batch and
arguments rank 0 drew. The sharding context is the process's: the
learners of one process take turns on it (``sharding.group.MESH_LOCK``),
each holding it across a call and its collectives.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import ModelStore
from repro_torch.ckpt.elastic import reshard, restore_elastic
from repro_torch.core import courier, telemetry
from repro_torch.core.discovery import Heartbeater
from repro_torch.core.fault import (FaultEvent, FaultInjector, RestartPolicy,
                              hedged_map)
from repro_torch.core.nodes.base import (WorkerContext, get_current_context,
                                   set_current_context)
from repro_torch.data.replay import (ReplayServer, TableConfig,
                                     is_writer_stalled)
from repro_torch.serve.engine import resolve_device
from repro_torch.sharding import ShardingCtx, use_sharding
from repro_torch.sharding.group import MESH_LOCK
from repro_torch.sharding.rules import batch_shardings, distribute, full
from repro_torch.train import grad_compression, tree
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.train_step import to_device


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """Knobs shared by every worker in one training fabric."""
    total_steps: int = 100
    batch_size: int = 32
    publish_every: int = 25            # bounded step loss on learner death
    grad_strategy: str = "auto"        # auto | dense | int8_ef
    compress_threshold_bytes: int = 1 << 22
    peer_timeout_s: float = 10.0       # chief's per-step fan-out deadline
    hedge_after_s: Optional[float] = None
    heartbeat_s: float = 0.2
    params_refresh_s: float = 0.1      # actor store-poll cadence
    insert_timeout_s: float = 1.0      # actor replay stall deadline
    sample_timeout_s: float = 1.0
    keep_versions: int = 10
    seed: int = 0
    trace_every: int = 0               # chief traces every Nth step; 0 off


def gathered(t):
    """A tree with each DTensor gathered to its full value on its device
    (a collective over its mesh)."""
    return tree.tree_map(full, t)


def host_tree(t):
    """Device tree -> picklable numpy tree (the wire/ckpt form)."""
    return tree.tree_map(
        lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
        else np.asarray(x), gathered(t))


def to_store(task, state) -> Any:
    """``state`` in the store's layout: the task's own export, or numpy."""
    export = getattr(task, "state_to_numpy", None)
    return export(gathered(state)) if export is not None else host_tree(state)


def from_store(task, t, device) -> Any:
    """Inverse of ``to_store``, onto ``device``."""
    load = getattr(task, "state_from_numpy", None)
    return load(t, device) if load is not None else to_device(t, device)



def registry_resolver(registry: Any, role: str) -> Callable[[], Any]:
    """Resolve a live replica of ``role`` from the registry into a courier
    client — actors use this to *re*-resolve replay after a stall."""
    def resolve():
        for r in registry.lookup()["replicas"]:
            if r["load"].get("role") == role and not r.get("draining"):
                return courier.client_for(r["endpoint"])
        raise RuntimeError(f"no live {role!r} replica in registry")
    return resolve


class RegistryTarget:
    """A ``FaultInjector`` target addressed by *logical* name: the fault
    resolves the worker's current endpoint from the registry at fire time,
    so chaos schedules survive respawns (the respawned incarnation has a
    fresh endpoint but the same name)."""

    def __init__(self, registry: Any, name: str):
        self._registry = registry
        self._name = name

    def _client(self) -> Any:
        for r in self._registry.lookup()["replicas"]:
            if r["name"] == self._name:
                return courier.client_for(r["endpoint"])
        raise RuntimeError(f"{self._name!r} not live in registry")

    def kill(self) -> None:
        self._client().kill()

    def stall(self, seconds: float) -> None:
        self._client().stall(seconds)


class ChaosNode:
    """A PyNode-able fault injector addressed by logical worker names.

    ``schedule`` rows are ``(kind, name, after_s, duration_s)``; targets
    resolve through the registry at fire time (``RegistryTarget``), and
    ``after_s`` counts from when the target *first appears live* in the
    registry — worker startup (jit warmup, checkpoint restore) varies, so
    wall-clock-from-launch kills race it. The registry must be a
    *top-level* constructor arg so the launcher dereferences its handle —
    which is why this wrapper exists instead of handing
    ``RegistryTarget`` objects to ``FaultInjector`` directly.
    """

    def __init__(self, registry: Any, schedule):
        events, targets = [], []
        for i, (kind, name, after_s, duration_s) in enumerate(schedule):
            targets.append(RegistryTarget(registry, name))
            events.append(FaultEvent(
                kind, target=i, duration_s=duration_s,
                when=self._after_live(registry, name, after_s)))
        self.injector = FaultInjector(events, targets)

    @staticmethod
    def _after_live(registry: Any, name: str, delay_s: float):
        seen_at: dict[str, float] = {}

        def pred() -> bool:
            try:
                live = {r["name"] for r in registry.lookup()["replicas"]}
            except Exception:  # noqa: BLE001 - registry not up yet
                return False
            if name in live and "t0" not in seen_at:
                seen_at["t0"] = time.monotonic()
            return ("t0" in seen_at
                    and time.monotonic() - seen_at["t0"] >= delay_s)
        return pred

    def run(self) -> None:
        self.injector.run()


def replay_batch_fn(resolver: Callable[[], Any], table: str,
                    collate: Callable[[list], Any], batch_size: int,
                    timeout_s: float = 1.0) -> Callable[[], Any]:
    """A learner batch source over a replay service: sample, collate,
    ``None`` on timeout/error (caller retries; the client is re-resolved
    after an error so a replay restart heals)."""
    state: dict[str, Any] = {"client": None}

    def fn():
        if state["client"] is None:
            try:
                state["client"] = resolver()
            except Exception:  # noqa: BLE001 - replay not up yet
                return None
        try:
            items = state["client"].sample(table, batch_size, timeout_s)
        except Exception:  # noqa: BLE001 - replay died: re-resolve next call
            state["client"] = None
            return None
        if not items:
            return None
        return collate(items)
    return fn


class LearnerWorker:
    """One data-parallel learner; chief drives, peers serve gradients.

    ``task`` is duck-typed: ``init_params(seed)``, ``optimizer``
    (an ``OptimizerConfig``), and ``grad_fn(params, batch) -> (loss,
    grads)`` over tensors on the learner's device. ``batch_fn()`` returns
    the next batch (numpy) or ``None`` (retry). State is ``{"params",
    "opt", "ef"}`` — the int8 error-feedback residual is real training
    state and rides in every published version (see ckpt/elastic.py).
    ``device`` defaults to the CUDA card and raises without one; with
    ``mesh`` the state lives on the mesh (its device type) as DTensors.
    """

    def __init__(self, task, batch_fn: Callable[[], Any], store_dir: str,
                 registry: Any, cfg: FabricConfig, *, name: str = "learner-0",
                 chief: Optional[bool] = None, device="cuda", mesh=None,
                 group=None, endpoint: Optional[str] = None):
        self._batch_fn = batch_fn
        self._registry = registry
        self._group = group
        self._peer_clients: dict[str, tuple[str, Any]] = {}
        store = ModelStore(store_dir, keep=cfg.keep_versions)
        self._init_state(task, store, cfg, name, chief,
                         mesh.device_type if mesh is not None else device,
                         mesh, store.latest_version())
        self.incarnation = 0
        if group is not None:   # the mirrors restore the same version
            with MESH_LOCK:
                self.incarnation = group.construct(
                    name, LearnerWorker.mirror, kwargs=dict(
                        task=task, store_dir=store_dir, cfg=cfg, name=name,
                        chief=self._chief, version=self._restored_from))

        ctx = get_current_context()
        ep = endpoint or ctx.endpoint or f"inproc://{name}"
        self._heartbeater = Heartbeater(
            registry, name, ep, load_fn=self.load,
            period_s=cfg.heartbeat_s, stop_event=ctx.stop_event).start()

    @classmethod
    def mirror(cls, task, store_dir: str, cfg: FabricConfig, *, name: str,
               chief: bool, mesh, version: Optional[int]) -> "LearnerWorker":
        """A follower rank's copy of rank 0's learner ``name``: the same
        state, restored from the same ``version``, on this rank's part of
        ``mesh``, for ``on_ranks`` calls only (no batch source, registry,
        heartbeat or store writes)."""
        self = cls.__new__(cls)
        self._group = None
        self._init_state(task, ModelStore(store_dir, keep=cfg.keep_versions),
                         cfg, name, chief, mesh.device_type, mesh, version)
        return self

    def _init_state(self, task, store: ModelStore, cfg: FabricConfig,
                    name: str, chief: Optional[bool], device, mesh,
                    version: Optional[int]) -> None:
        """The learner's state: ``version`` of ``store`` if one is
        given, else the task's seeded init, on ``device`` and then
        resharded onto ``mesh``."""
        self._task = task
        self._cfg = cfg
        self._name = name
        self._chief = name.endswith("-0") if chief is None else bool(chief)
        self._mesh = mesh
        self._device = resolve_device(device)
        self._store = store
        self._grad_fn = task.grad_fn
        self._lock = threading.Lock()
        self._dead = False
        self._retired = False
        self._done = False
        self._loss: Optional[float] = None
        self._published: Optional[int] = None
        self._restored_from: Optional[int] = None
        self._held = None
        self._readings: dict = {}

        params = to_device(task.init_params(cfg.seed), self._device)
        like = {"params": params, "opt": opt_lib.init_opt_state(params),
                "ef": tree.tree_map(
                    lambda x: torch.zeros_like(x, dtype=torch.float32),
                    params)}
        if version is not None:
            # Recovery/grow path: resume from the last *published* version
            # on this incarnation's device, then reshard onto whatever
            # mesh it runs on. The step loss of a learner death is
            # therefore bounded by publish_every. fill_missing tolerates
            # versions published before the EF residual existed.
            state = from_store(task, restore_elastic(
                self._store.version_dir(version), to_store(task, like),
                fill_missing=True), self._device)
            self._step = int(version)
            self._restored_from = int(version)
            self._published = int(version)
        else:
            state = like
            self._step = 0
        if mesh is not None:   # the wire's residual ef stays local
            state = dict(state, **reshard(
                {"params": state["params"], "opt": state["opt"]}, mesh))
        self._params = state["params"]
        self._opt = state["opt"]
        self._ef = state["ef"]
        self._start_step = self._step
        self.history: list[tuple[int, float]] = []

    def mirror_state(self) -> dict:
        """What a follower reports of its mirror."""
        return {"step": self._step, "restored_from": self._restored_from}

    # -- registry-facing -----------------------------------------------------
    def load(self) -> dict:
        mesh = self._mesh
        return {"role": "learner", "chief": self._chief,
                "step": self._step, "start_step": self._start_step,
                "version": self._published, "loss": self._loss,
                "done": self._done,
                "mesh": None if mesh is None else dict(
                    zip(mesh.mesh_dim_names, mesh.shape))}

    def telemetry(self) -> dict:
        """Standard hub scrape: process metrics/spans + this worker's load."""
        return telemetry.telemetry_snapshot(service=self.load())

    def get_status(self) -> dict:
        if self._dead:
            raise ConnectionError(f"{self._name} is dead")
        return self.load()

    # -- fault hooks (FaultInjector duck-type) -------------------------------
    def kill(self) -> None:
        """Die unannounced: heartbeats stop (no deregister — the registry
        finds out via TTL), RPCs fail, the run loop exits."""
        self._dead = True
        self._heartbeater.stop(deregister=False)
        self._drop_mirrors()

    def stall(self, seconds: float) -> None:
        self._heartbeater.pause(seconds)

    def retire(self) -> None:
        """Graceful scale-down: finish the in-flight call, deregister."""
        self._retired = True
        self._heartbeater.stop(deregister=True)
        self._drop_mirrors()

    def _drop_mirrors(self) -> None:
        """After the call in flight, the followers free this
        incarnation's shards; ``on_ranks`` sends no more calls."""
        if self._group is not None:
            with MESH_LOCK:
                self._group.drop(self._name, self.incarnation)

    # -- the step's computation: on every rank of the mesh ------------------
    @contextlib.contextmanager
    def _on_mesh(self):
        """The mesh's sharding context (nothing without a mesh)."""
        if self._mesh is None:
            yield
            return
        names = self._mesh.mesh_dim_names
        ctx = ShardingCtx(self._mesh,
                          dp=tuple(a for a in ("pod", "data") if a in names))
        with MESH_LOCK, use_sharding(ctx):
            yield

    def _in_mesh(self, method: str, **kwargs):
        """``method(**kwargs)`` under the mesh's context: what each rank
        runs for ``on_ranks``."""
        with self._on_mesh():
            return getattr(self, method)(**kwargs)

    def on_ranks(self, method: str, **kwargs):
        """``method(**kwargs)`` under the mesh's context, first sent to
        this learner's mirror on every follower when rank 0 drives them
        (``group``, ``MeshGroup.on_ranks``), so that each rank runs the
        same collectives. A failure on rank 0 leaves the followers out of
        step: the group takes no more calls."""
        if self._group is None:
            return self._in_mesh(method, **kwargs)
        with MESH_LOCK:
            if self._dead or self._retired:
                raise ConnectionError(f"{self._name} is dead")
            return self._group.on_ranks(self._name, self.incarnation, self,
                                        "_in_mesh", (method,), kwargs)

    def _place_params(self, host_params) -> Any:
        params = to_device(host_params, self._device)
        return reshard(params, self._mesh) if self._mesh is not None \
            else params

    def _grads(self, batch, params=None, hold: bool = False) -> tuple:
        """(loss, gradient tree) on a numpy batch at ``params`` (a peer's
        copy of the chief's, placed first) or the current ones; on a mesh
        the batch is scattered from rank 0 and the gradients gathered to
        full tensors. ``hold`` keeps them for ``_update``."""
        if params is not None:
            self._params = self._place_params(params)
        batch = to_device(batch, self._device)
        if self._mesh is None:
            loss, grads = self._grad_fn(self._params, batch)
        else:
            batch = distribute(batch, batch_shardings(self._mesh, batch),
                               src_data_rank=0)
            loss, grads = self._grad_fn(self._params, batch)
            loss, grads = full(loss), gathered(grads)
        self._held = grads if hold else None
        with telemetry.span("train.sync"):
            read = getattr(self._task, "read_step", None)
            loss, readings = read(loss) if read else (float(loss), {})
        reg = telemetry.metrics()
        self._readings = {f"train.{k}": v for k, v in readings.items()}
        for k, v in self._readings.items():
            reg.counter(k).inc(int(v))
        return loss, grads

    def _update(self, strategy: str, payloads: list) -> None:
        """One optimizer step on the average of the held gradients and
        the peers' wire ``payloads``. Under int8_ef the held gradients
        round-trip through this learner's residual, so the aggregate is
        uniformly quantized and the published EF state is the chief's
        real residual."""
        grads, self._held = self._held, None
        if strategy == "int8_ef":
            payload, self._ef = grad_compression.compress_tree(
                grads, self._ef, method="int8_ef")
            contribs = [grad_compression.decompress_tree(payload,
                                                         self._device)]
        else:
            contribs = [grads]
        contribs += [grad_compression.decompress_tree(p, self._device)
                     for p in payloads]
        n = len(contribs)
        avg = tree.tree_map(lambda *xs: sum(xs) / n, *contribs)
        if self._mesh is not None:
            avg = reshard(avg, self._mesh)
        with telemetry.span("train.optimizer"):
            if self._device.type == "cuda":
                # In place: the card holds one copy of p, m and v, and the
                # parameters stay where a replayed gradient pass reads
                # them (train_step.Replayed). Off a card no graph reads
                # them, and the functional update stays.
                opt_lib.apply_updates_(self._task.optimizer, self._params,
                                       avg, self._opt)
            else:
                self._params, self._opt, _ = opt_lib.apply_updates(
                    self._task.optimizer, self._params, avg, self._opt)
        self._step += 1

    def _gathered(self, keys: tuple) -> dict:
        """``{key: full tree}`` of params, opt and/or ef."""
        state = {"params": self._params, "opt": self._opt, "ef": self._ef}
        return gathered({k: state[k] for k in keys})

    # -- peer RPC surface ----------------------------------------------------
    def compute_grads(self, step: int, params_payload, strategy: str) -> dict:
        """Chief -> peer: gradient contribution at the chief's params.

        The peer compresses with its *own* error-feedback residual, so the
        chief sees uniformly quantized contributions and each worker's
        residual cancels its own bias over time.
        """
        if self._dead:
            raise ConnectionError(f"{self._name} is dead")
        with self._lock:
            self._step = int(step)
            batch = self._batch_fn()
            if batch is None:
                raise RuntimeError(f"{self._name}: no batch available")
            loss, grads = self.on_ranks("_grads", batch=batch,
                                        params=params_payload)
            if strategy == "int8_ef":
                payload, self._ef = grad_compression.compress_tree(
                    grads, self._ef, method="int8_ef")
            else:
                payload, _ = grad_compression.compress_tree(
                    grads, None, method="dense")
            self._loss = loss
            return {"loss": loss, "payload": payload}

    # -- chief internals -----------------------------------------------------
    def _resolve_strategy(self) -> str:
        if self._cfg.grad_strategy != "auto":
            return self._cfg.grad_strategy
        total = grad_compression.grad_bytes(self._params)
        return ("int8_ef"
                if total >= self._cfg.compress_threshold_bytes else "dense")

    def _live_peers(self) -> list[tuple[str, Any]]:
        peers = []
        try:
            replicas = self._registry.lookup()["replicas"]
        except Exception:  # noqa: BLE001 - registry hiccup: step solo
            return []
        for r in replicas:
            if (r["load"].get("role") != "learner" or r["name"] == self._name
                    or r.get("draining")):
                continue
            cached = self._peer_clients.get(r["name"])
            if cached is None or cached[0] != r["endpoint"]:
                cached = (r["endpoint"], courier.client_for(r["endpoint"]))
                self._peer_clients[r["name"]] = cached
            peers.append((r["name"], cached[1]))
        return peers

    def _next_batch(self, ctx) -> Any:
        while not (ctx.should_stop or self._dead or self._retired):
            batch = self._batch_fn()
            if batch is not None:
                return batch
            ctx.wait_for_stop(0.02)
        return None

    def _publish(self) -> None:
        state = to_store(self._task, self.on_ranks(
            "_gathered", keys=("params", "opt", "ef")))
        self._store.publish_version(
            self._step, state,
            metadata={"step": self._step, "loss": self._loss})
        self._published = self._step
        self._heartbeater.beat_now()   # version table updates immediately

    def _chief_step(self, ctx) -> bool:
        cfg = self._cfg
        strategy = self._resolve_strategy()
        peers = self._live_peers()
        fns = []
        if peers:   # the host copy of the weights is only for the wire
            payload_params = host_tree(self.on_ranks(
                "_gathered", keys=("params",))["params"])
            fns = [lambda c=client: c.futures.compute_grads(
                       self._step, payload_params, strategy)
                   for _, client in peers]
        with telemetry.span("train.data"):
            batch = self._next_batch(ctx)
        if batch is None:
            return False
        with telemetry.span("train.grads"):
            loss, _ = self.on_ranks("_grads", batch=batch, hold=True)
        losses = [loss]

        results = hedged_map(fns, hedge_after_s=cfg.hedge_after_s,
                             quorum=len(fns) or None,
                             timeout_s=cfg.peer_timeout_s,
                             return_exceptions=True) if fns else []
        payloads = []
        for (name, _), res in zip(peers, results):
            if res is None or isinstance(res, BaseException):
                # Peer failed or timed out: evict it so the next step's
                # quorum is over survivors only (it re-registers on its
                # next beat if it was a false alarm).
                try:
                    self._registry.report_failure(name)
                except Exception:  # noqa: BLE001
                    pass
                self._peer_clients.pop(name, None)
                continue
            payloads.append(res["payload"])
            losses.append(float(res["loss"]))

        with telemetry.span("train.update", strategy=strategy):
            self.on_ranks("_update", strategy=strategy, payloads=payloads)
        self._loss = float(np.mean(losses))
        self.history.append((self._step, self._loss))
        if (self._step % cfg.publish_every == 0
                or self._step >= cfg.total_steps):
            self._publish()
        return True

    def _alloc_retries(self) -> Optional[int]:
        """The caching allocator's retries so far (None off CUDA)."""
        if self._device.type != "cuda":
            return None
        return torch.cuda.memory_stats(self._device).get(
            "num_alloc_retries", 0)

    def _traced_step(self, ctx) -> bool:
        """``_chief_step``, inside a fresh trace's ``train.step`` span
        when its number is a multiple of ``trace_every``."""
        every, k = self._cfg.trace_every, self._step + 1
        if not every or k % every:
            return self._chief_step(ctx)
        with telemetry.activate(telemetry.start_trace()), \
                telemetry.span("train.step", step=k) as attrs:
            retries = self._alloc_retries()
            self._readings = {}
            try:
                return self._chief_step(ctx)
            finally:
                if retries is not None:
                    attrs["alloc_retries"] = self._alloc_retries() - retries
                attrs.update(self._readings)

    # -- main loop -----------------------------------------------------------
    def run(self) -> None:
        ctx = get_current_context()
        if not self._chief:
            while not (ctx.should_stop or self._dead or self._retired):
                ctx.wait_for_stop(0.1)
            return
        while (self._step < self._cfg.total_steps
               and not (ctx.should_stop or self._dead or self._retired)):
            self._traced_step(ctx)
        if self._step >= self._cfg.total_steps and not self._dead:
            self._done = True
            self._heartbeater.beat_now()
            # Keep heartbeating so the supervisor reads the done flag, but
            # our work is finished — wait for the program to wind down.
            while not (ctx.should_stop or self._dead or self._retired):
                ctx.wait_for_stop(0.05)


class ActorWorker:
    """Experience generator: pulls *published* params, writes replay.

    ``rollout_fn(params, rng) -> item`` produces one replay item.
    ``replay_resolver()`` returns a fresh replay client — called again
    after any insert failure, so a replay restart (or a stall caused by a
    dead learner) never wedges the actor: the typed ``WriterStalled``
    surfaces, the actor re-resolves and retries.
    """

    def __init__(self, task, rollout_fn: Callable[[Any, Any], Any],
                 replay_resolver: Callable[[], Any], table: str,
                 store_dir: str, registry: Any, cfg: FabricConfig, *,
                 name: str = "actor-0", endpoint: Optional[str] = None,
                 seed: int = 0):
        self._rollout_fn = rollout_fn
        self._resolver = replay_resolver
        self._table = table
        self._store = ModelStore(store_dir)
        self._cfg = cfg
        self._name = name
        self._task = task
        self._params = task.init_params(cfg.seed)
        self._like = to_store(task, {"params": self._params})
        self._version: Optional[int] = None
        self._last_refresh = 0.0
        self._replay_client: Optional[Any] = None
        self._rng = np.random.default_rng(seed)
        self._dead = False
        self._inserts = 0
        self._stalls = 0
        self._errors = 0
        self._inserts_per_s = 0.0

        ctx = get_current_context()
        ep = endpoint or ctx.endpoint or f"inproc://{name}"
        self._heartbeater = Heartbeater(
            registry, name, ep, load_fn=self.load,
            period_s=cfg.heartbeat_s, stop_event=ctx.stop_event).start()

    def load(self) -> dict:
        return {"role": "actor", "version": self._version,
                "inserts": self._inserts, "stalls": self._stalls,
                "inserts_per_s": round(self._inserts_per_s, 3)}

    def telemetry(self) -> dict:
        return telemetry.telemetry_snapshot(service=self.load())

    def get_status(self) -> dict:
        if self._dead:
            raise ConnectionError(f"{self._name} is dead")
        return self.load()

    def kill(self) -> None:
        self._dead = True
        self._heartbeater.stop(deregister=False)

    def stall(self, seconds: float) -> None:
        self._heartbeater.pause(seconds)

    def _maybe_refresh(self) -> None:
        now = time.monotonic()
        if now - self._last_refresh < self._cfg.params_refresh_s:
            return
        self._last_refresh = now
        try:
            v = self._store.latest_version()
            if v is None or v == self._version:
                return
            state = self._store.load_version(v, like=self._like)
            self._params = from_store(self._task, state, "cpu")["params"]
            self._version = v
        except Exception:  # noqa: BLE001 - version GC'd mid-read: next poll
            pass

    def _replay(self) -> Any:
        if self._replay_client is None:
            self._replay_client = self._resolver()
        return self._replay_client

    def run(self) -> None:
        ctx = get_current_context()
        t_last = time.monotonic()
        while not (ctx.should_stop or self._dead):
            self._maybe_refresh()
            item = self._rollout_fn(self._params, self._rng)
            try:
                ok = self._replay().insert(
                    self._table, item, 1.0, self._cfg.insert_timeout_s, True)
            except Exception as exc:  # noqa: BLE001
                if is_writer_stalled(exc):
                    # The sampler isn't draining (learner dead or lagging):
                    # fail over to a fresh handle instead of deadlocking.
                    self._stalls += 1
                else:
                    self._errors += 1
                self._replay_client = None
                ctx.wait_for_stop(0.05)
                continue
            if ok:
                self._inserts += 1
                now = time.monotonic()
                inst = 1.0 / max(now - t_last, 1e-9)
                self._inserts_per_s = (inst if self._inserts_per_s == 0.0
                                       else 0.9 * self._inserts_per_s
                                       + 0.1 * inst)
                t_last = now


class ReplayService(ReplayServer):
    """A ReplayServer that advertises itself in the registry (role=replay)
    so actors and learners can (re-)resolve it by role, and exposes the
    fault hooks chaos schedules expect."""

    def __init__(self, tables: list[TableConfig], registry: Any = None, *,
                 name: str = "replay", endpoint: Optional[str] = None,
                 heartbeat_s: float = 0.2):
        super().__init__(tables)
        self._name = name
        self._table_names = [t.name for t in tables]
        self._heartbeater = None
        if registry is not None:
            ctx = get_current_context()
            ep = endpoint or ctx.endpoint or f"inproc://{name}"
            self._heartbeater = Heartbeater(
                registry, name, ep, load_fn=self.load,
                period_s=heartbeat_s, stop_event=ctx.stop_event).start()

    def load(self) -> dict:
        totals = {"inserts": 0, "samples": 0, "size": 0}
        for t in self._table_names:
            s = self.stats(t)
            for k in totals:
                totals[k] += s[k]
        return {"role": "replay", **totals}

    def telemetry(self) -> dict:
        return telemetry.telemetry_snapshot(service=self.load())


class TrainSupervisor:
    """Membership-level resurrection for the training fleet.

    Stateless over the registry (like ``RolloutController``): every poll
    re-derives the live set and compares it against the expected roster
    ``{role: count}`` (worker ``i`` of a role is named ``{role}-{i}``). A
    missing worker is respawned through ``spawn_fn(name)`` under
    ``RestartPolicy`` backoff; ``scale(role, n)`` grows (spawn + elastic
    restore happens inside the worker ctor) or shrinks (graceful
    ``retire`` RPC + deregister) the set. With ``total_steps`` set, the
    supervisor stops the program once the chief reports done.
    """

    def __init__(self, registry: Any, spawn_fn: Callable[[str], Any],
                 expected: Optional[dict[str, int]] = None,
                 policy: RestartPolicy = RestartPolicy(max_restarts=5),
                 poll_s: float = 0.05, spawn_grace_s: float = 5.0,
                 total_steps: Optional[int] = None,
                 check: Optional[Callable[[], None]] = None):
        self._registry = registry
        self._check = check
        self._spawn_fn = spawn_fn
        self._expected = dict(expected or {})
        self._policy = policy
        self._poll_s = poll_s
        self._grace = spawn_grace_s
        self._total = total_steps
        self._restarts: dict[str, int] = {}
        self._spawned: set[str] = set()
        self._seen: set[str] = set()
        self._fatal: set[str] = set()
        self._hold_until: dict[str, float] = {}   # spawn in flight: wait
        self._pending: dict[str, float] = {}      # backoff: respawn at t
        self._logger = telemetry.get_logger()
        self.events: list[dict] = []
        self.done = False

    def _log(self, kind: str, name: str, **extra) -> None:
        self.events.append({"kind": kind, "name": name, **extra})
        self._logger.info(f"{kind} {name}", **extra)
        if kind in ("respawn", "fatal", "backoff", "spawn-failed",
                    "retire", "scale"):
            # Fabric events with causes: the hub collects these, so a
            # respawn storm is queryable after the fact, not just
            # scrolled-away stdout.
            telemetry.record_event(kind, cause=name,
                                   node=self._logger.node, **extra)

    def expected_names(self) -> list[str]:
        return [f"{role}-{i}" for role, n in sorted(self._expected.items())
                for i in range(n)]

    def scale(self, role: str, n: int) -> None:
        """Elastic resize; takes effect on the next poll."""
        old = self._expected.get(role, 0)
        self._expected[role] = int(n)
        self._log("scale", role, old=old, new=n)

    def stats(self) -> dict:
        return {"restarts": dict(self._restarts),
                "fatal": sorted(self._fatal),
                "expected": dict(self._expected), "done": self.done}

    def _retire_extras(self, live: dict) -> None:
        expected = set(self.expected_names())
        for name, rep in live.items():
            role = name.rsplit("-", 1)[0]
            if role not in self._expected or name in expected:
                continue
            try:
                courier.client_for(rep["endpoint"]).retire()
            except Exception:  # noqa: BLE001 - already gone is fine
                pass
            try:
                self._registry.deregister(name)
            except Exception:  # noqa: BLE001
                pass
            self._spawned.discard(name)
            self._seen.discard(name)
            self._restarts.pop(name, None)
            self._log("retire", name)

    def _spawn(self, name: str, restart: bool) -> None:
        try:
            self._spawn_fn(name)
        except Exception as exc:  # noqa: BLE001 - spawn failed: retry later
            self._log("spawn-failed", name, error=repr(exc))
            self._hold_until[name] = (time.monotonic()
                                      + self._policy.backoff_for(
                                          self._restarts.get(name, 0)))
            return
        self._spawned.add(name)
        self._hold_until[name] = time.monotonic() + self._grace
        self._log("respawn" if restart else "spawn", name,
                  restarts=self._restarts.get(name, 0))

    def _chief_done(self, live: dict) -> bool:
        for rep in live.values():
            load = rep.get("load", {})
            if load.get("role") == "learner" and load.get("chief"):
                if load.get("done"):
                    return True
                if (self._total is not None
                        and load.get("step", 0) >= self._total):
                    return True
        return False

    def poll(self) -> dict:
        now = time.monotonic()
        try:
            live = {r["name"]: r
                    for r in self._registry.lookup()["replicas"]}
        except Exception:  # noqa: BLE001 - registry down: nothing to decide
            return self.stats()
        self._seen |= set(live)
        for name in list(live):
            self._hold_until.pop(name, None)
            self._pending.pop(name, None)
        self._retire_extras(live)
        for name in self.expected_names():
            if name in live or name in self._fatal:
                continue
            if name in self._pending:                  # backoff running
                if now >= self._pending[name]:
                    del self._pending[name]
                    self._spawn(name, restart=True)
                continue
            if now < self._hold_until.get(name, 0.0):  # spawn coming up
                continue
            died = name in self._seen or name in self._spawned
            if not died:
                self._spawn(name, restart=False)       # initial roster fill
                continue
            r = self._restarts.get(name, 0)
            if not self._policy.allows(r):
                self._fatal.add(name)
                self._log("fatal", name, restarts=r)
                continue
            self._restarts[name] = r + 1
            wait = self._policy.backoff_for(r)
            if wait > 0:                               # crash-loop damping
                self._pending[name] = now + wait
                self._log("backoff", name, wait_s=round(wait, 3),
                          restarts=r + 1)
            else:
                self._spawn(name, restart=True)
        self.done = self._chief_done(live)
        return self.stats()

    def run(self) -> None:
        """Poll until the chief is done; ``check`` raising (a lost mesh
        rank) ends the run with its error."""
        ctx = get_current_context()
        while not ctx.should_stop:
            self.poll()
            if self._check is not None:
                self._check()
            if self.done:
                ctx.stop_program()
                return
            ctx.wait_for_stop(self._poll_s)


class ThreadWorkerSpawner:
    """Hosts fabric workers on daemon threads behind inproc couriers.

    Each spawn gets a fresh inproc endpoint (incarnation-suffixed — inproc
    names are single-owner), its own ``WorkerContext``, and runs the
    worker's ``run()`` until it returns or ``stop_all`` fires. This is the
    thread launcher's analogue of the scheduler restarting an executable.
    """

    def __init__(self):
        self._incarnation = itertools.count()
        self._lock = threading.Lock()
        self._live: list[tuple[str, WorkerContext, threading.Thread]] = []

    def spawn(self, name: str,
              factory: Callable[[str, str], Any]) -> str:
        """Start ``factory(name, endpoint)`` on its own thread; returns the
        endpoint the worker serves on.

        Any still-running older incarnation of ``name`` is stopped first:
        a worker that merely *stalled* past its TTL (e.g. heartbeats
        starved during a long jit compile) must not keep training beside
        its replacement — the scheduler's restart semantics are that the
        old executable is gone.
        """
        with self._lock:
            for n, ctx_old, _ in self._live:
                if n == name:
                    ctx_old.stop_event.set()
        inproc = f"{name}.{next(self._incarnation)}"
        endpoint = f"inproc://{inproc}"
        ctx = WorkerContext(node_name=name)
        ctx.endpoint = endpoint

        def _main():
            set_current_context(ctx)
            log = telemetry.get_logger(name)
            try:
                worker = factory(name, endpoint)
            except Exception:  # noqa: BLE001 - supervisor retries the spawn
                log.exception("worker factory failed")
                return
            courier.inprocess.register(inproc, worker)
            try:
                run = getattr(worker, "run", None)
                if callable(run):
                    run()
                else:
                    # Passive services (e.g. replay) serve until stopped.
                    ctx.stop_event.wait()
            except Exception:  # noqa: BLE001 - a worker crash is a *fault*:
                # the supervisor resurrects it; the node-prefixed log (and
                # the recorded fabric event) make the respawn attributable
                # in interleaved fleet output.
                log.exception("worker crashed")
            finally:
                courier.inprocess.unregister(inproc)

        thread = threading.Thread(target=_main, daemon=True,
                                  name=f"fabric/{inproc}")
        with self._lock:
            self._live.append((name, ctx, thread))
        thread.start()
        return endpoint

    def stop_all(self, timeout_s: float = 5.0) -> None:
        with self._lock:
            live = list(self._live)
        for _, ctx, _ in live:
            ctx.stop_event.set()
        deadline = time.monotonic() + timeout_s
        for _, _, thread in live:
            thread.join(timeout=max(0.0, deadline - time.monotonic()))
