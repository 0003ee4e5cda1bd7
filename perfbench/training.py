"""The training cell: the port's training program as ``launch.train``
builds it with one learner, a ``Registry``, the ``DataNode``s of seeded
SyntheticLM batches, and a ``FleetSupervisor`` whose learner runs the
train step (microbatches, remat, AdamW).

The learner's task is the port's ``LMTask`` over the benchmark's
weights (``BenchTask``); its ``grad_fn`` is where each step starts, so
the probe there marks step boundaries on the host clock, keeps the first
three batches and losses for the reference, reads the optimizer's state
after step 1 through the learner's own ``on_ranks`` call, copies the
parameters after step 3 to the host, and opens and closes the device
trace. The window runs from the start of step ``window_from_step`` to
the first step start ``--seconds`` after it; set-up is everything before
it, the checked steps included."""

from __future__ import annotations

import shutil
import tempfile
import threading
import time

import numpy as np
import torch

from perfbench import weights as wts
from perfbench.bundle import Bundle
from perfbench.profiling import profile_in
from repro_torch import core as lp
from repro_torch.core import courier
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.train import DataNode, FleetSupervisor, LMTask
from repro_torch.models import transformer
from repro_torch.train.fabric import FabricConfig
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import TrainConfig

CHECKED_STEPS = 3


class Probe:
    """Step boundaries and the checked steps' readings (see the module)."""

    def __init__(self, plan: dict, b1: float):
        self.plan, self.b1 = plan, b1
        self.starts: list[float] = []       # perf time of each step start
        self.host_spans: list[tuple] = []
        self.batches: list[np.ndarray] = []
        self.losses: list[float] = []
        self.first_grad_norms: list[float] = []
        self.params_after: list = []
        self.inits = 0
        self.t0 = self.t1 = None
        self.perf_to_wall = time.time() - time.perf_counter()
        self.profiler, self.prof_box = None, {}
        self.done = threading.Event()
        self.release = threading.Event()
        self.registry = None
        self.error = None

    def _learner_state(self, keys: tuple) -> dict:
        view = self.registry.lookup()
        eps = [r["endpoint"] for r in view["replicas"]
               if r["load"].get("role") == "learner"]
        client = courier.client_for(eps[0])
        try:
            return client.on_ranks("_gathered", keys=keys)
        finally:
            client.close()

    def before(self, params, batch) -> None:
        k = len(self.starts) + 1                    # the step starting now
        now = time.perf_counter()
        if self.starts:
            self.host_spans.append(("between steps (update, data)",
                                    self._last_exit, now))
        self.starts.append(now)
        plan = self.plan
        if k == 2:
            m = self._learner_state(("opt",))["opt"]["m"]
            self.first_grad_norms = [float(x.float().norm()) / (1 - self.b1)
                                     for _, x in wts.leaves(m)]
        if k == CHECKED_STEPS + 1:
            self.params_after = [x.detach().to("cpu")
                                 for _, x in wts.leaves(params)]
        if k <= CHECKED_STEPS:
            self.batches.append(np.asarray(batch["tokens"].cpu()))
        if k == plan["window_from_step"]:
            _sync(params)
            self.t0 = time.perf_counter()
            self.starts[-1] = self.t0
            if plan["trace"]:
                self.profiler = profile_in(plan, self.t0, self.prof_box)
        if (self.t0 is not None and self.t1 is None and k > plan[
                "window_from_step"] and now - self.t0 >= plan["seconds"]):
            _sync(params)
            self.t1 = time.perf_counter()
            self.starts[-1] = self.t1
            self.done.set()
            self.release.wait()
        self._enter = time.perf_counter()

    def after(self, loss) -> None:
        if len(self.losses) < CHECKED_STEPS:
            self.losses.append(float(loss))
        self._last_exit = time.perf_counter()
        self.host_spans.append(("grad_fn (forward, backward)", self._enter,
                                self._last_exit))


def _sync(params) -> None:
    dev = wts.leaves(params)[0][1].device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class BenchTask(LMTask):
    """The port's ``LMTask`` over the benchmark's weights, its
    ``grad_fn`` seen by the probe."""

    def __init__(self, model_cfg, train_cfg, device, weights, probe):
        super().__init__(model_cfg, train_cfg, device)
        self._weights, self._probe = weights, probe

    def init_params(self, seed: int):
        self._probe.inits += 1
        if self._probe.inits > 1:
            # A respawned learner would start over from the seed.
            self._probe.error = RuntimeError("the learner was respawned")
            self._probe.done.set()
        return self._weights

    def grad_fn(self, params, batch):
        self._probe.before(params, batch)
        loss, grads = super().grad_fn(params, batch)
        self._probe.after(loss)
        return loss, grads


class BenchFleet(FleetSupervisor):
    """``FleetSupervisor`` whose learners run ``BenchTask``."""

    def __init__(self, registry, data_nodes, model_cfg, train_cfg, fab_cfg,
                 store_dir, weights, probe, device):
        super().__init__(registry, data_nodes, model_cfg, train_cfg,
                         fab_cfg, store_dir, learners=1, device=device)
        probe.registry = registry
        self._task = BenchTask(model_cfg, train_cfg, device, weights, probe)


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> tuple[Bundle, dict]:
    conf, mix = cell.config, cell.traffic
    tcfg = conf["train"]
    arch = cell.arch
    s = arch.sizes(conf)
    model_cfg = arch.program_config(conf)
    weights = wts.draw(arch.layout(s), seed, device,
                       getattr(torch, s["param_dtype"]))
    wts.check_layout(weights, transformer.param_shapes(model_cfg))
    B, S, nm = (int(mix["batch_size"]), int(mix["seq_len"]),
                int(mix["num_microbatches"]))
    opt = OptimizerConfig(**tcfg["optimizer"])
    train_cfg = TrainConfig(optimizer=opt, num_microbatches=nm,
                            remat=tcfg["remat"])
    fab = FabricConfig(total_steps=10 ** 9, batch_size=B,
                       publish_every=10 ** 9,
                       grad_strategy=tcfg["grad_strategy"],
                       heartbeat_s=float(tcfg["heartbeat_s"]))
    n_data = int(mix["data_nodes"])
    data_cfg = DataConfig(seq_len=S, batch_size=B // n_data,
                          vocab_size=s["vocab"], seed=int(seed) % (1 << 31))
    plan = {"seconds": float(seconds), "trace": bool(trace),
            "window_from_step": int(mix["window_from_step"]),
            "profile_s": float(mix["profile_s"])}
    probe = Probe(plan, opt.b1)
    store = tempfile.mkdtemp(prefix="perfbench-store-")
    p = lp.Program(f"perfbench-{cell.name}")
    with p.group("registry"):
        registry = p.add_node(lp.CourierNode(
            lp.Registry, ttl_s=float(tcfg["registry_ttl_s"])))
    with p.group("data"):
        data = [p.add_node(lp.CourierNode(DataNode, data_cfg, i, n_data))
                for i in range(n_data)]
    with p.group("supervisor"):
        p.add_node(lp.PyNode(BenchFleet, registry, data, model_cfg,
                             train_cfg, fab, store, weights, probe,
                             str(device)))
    del weights
    launcher = lp.ThreadLauncher(restart_policy=lp.RestartPolicy(
        max_restarts=0))
    try:
        launcher.launch(p)
        deadline = time.monotonic() + float(mix["run_limit_s"])
        while not probe.done.wait(0.5):
            if launcher.fatal_failures or time.monotonic() > deadline:
                break
        launcher.stop()
        probe.release.set()
        launcher.wait(timeout=120.0)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    if probe.error is not None:
        raise probe.error
    if probe.t1 is None:
        failure = launcher.fatal_failures
        raise RuntimeError("the training program ended before the window: "
                           f"{failure[0] if failure else 'time limit'}")
    trace_obj = None
    if probe.profiler is not None:
        probe.profiler.join()
        trace_obj = probe.prof_box.get("trace")
        trace_obj.read()
    steps = [t for t in probe.starts if probe.t0 <= t <= probe.t1]
    b = Bundle(cell=cell.name, sizes=s, config=conf, traffic=mix,
               seconds=float(seconds), setup_s=probe.t0 - t_start,
               t0=probe.t0, t1=probe.t1, perf_to_wall=probe.perf_to_wall,
               steps=steps, trace=trace_obj, arch=arch)
    b.host_spans = [(n, b.wall(a), b.wall(e)) for n, a, e in
                    probe.host_spans]
    b.extra = {"tokens_per_step": B * S, "batch": B, "seq": S}
    return b, {"probe": probe, "sizes": s, "optimizer": tcfg["optimizer"],
               "num_micro": nm, "seed": seed}
