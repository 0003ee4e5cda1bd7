"""Serving cells: the port's serve fabric, ``Registry -> Router -> one
EngineServer`` (a ``MeshWorkerNode``), launched as a Launchpad program on
the thread launcher, under the benchmark's load node, which calls
``Router.submit(prompt, max_new)`` over the courier.

The load is a backlog (the mix's ``mode``): ``outstanding`` requests
kept in flight from the start (each reply replaced at once), a
``ramp_s`` before the window, and requests still open at its end
dropped.

``Overloaded`` replies are retried with the port's decorrelated backoff
and counted. The engine draws no weights of its own here: it serves the
tree that the benchmark drew from the seed (``BenchEngineServer``)."""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import random
import threading
import time

import numpy as np
import torch

from perfbench import profiling
from perfbench import traffic as tr
from perfbench import weights as wts
from perfbench.bundle import Bundle
from repro_torch import core as lp
from repro_torch.core import telemetry
from repro_torch.launch.serve import EngineServer
from repro_torch.models import transformer
from repro_torch.serve.router import (Router, decorrelated_backoff,
                                      is_overloaded)

_INIT_LOCK = threading.Lock()


@contextlib.contextmanager
def _drawn(weights: dict):
    """For the block, ``transformer.init_params`` hands back ``weights``:
    ``EngineServer`` draws its weights with that call and takes no tree
    (a ``params=`` argument would make this unnecessary)."""
    orig = transformer.init_params

    def init_params(cfg, seed=0, device="cuda", dtype=None):
        return weights

    with _INIT_LOCK:
        transformer.init_params = init_params
        try:
            yield
        finally:
            transformer.init_params = orig


class BenchEngineServer(EngineServer):
    """The port's ``EngineServer``, serving the benchmark's weights."""

    def __init__(self, model_cfg, weights, **kwargs):
        with _drawn(weights):
            super().__init__(model_cfg, **kwargs)


class _Box:
    def __init__(self):
        self.done = threading.Event()
        self.result = None
        self.error = None


class LoadNode:
    """The benchmark's load, a node of the program: warm-up, then the
    window, against the router's handle; the engine's handle serves its
    counters."""

    def __init__(self, router, engine, plan: dict, box: _Box):
        self._router, self._engine = router, engine
        self._plan, self._box = plan, box

    def run(self):
        try:
            self._box.result = _drive(self._router, self._engine, self._plan)
        except BaseException as exc:  # noqa: BLE001 - handed to the harness
            self._box.error = exc
        finally:
            self._box.done.set()


class _Spans:
    """Drains the process's span ring while the window runs (it holds
    8192 spans), keeping every span in order."""

    def __init__(self, on: bool):
        self.on, self.spans = on, []
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        telemetry.spans_buffer().drain()
        if self.on:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="perfbench-spans")
            self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(0.2):
            self.spans += telemetry.spans_buffer().drain()

    def stop(self) -> list:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        self.spans += telemetry.spans_buffer().drain()
        return self.spans


def _send(router, r: dict, trace: bool, stop: threading.Event) -> None:
    """One request through ``Router.submit``, retried on Overloaded."""
    r["sent"] = time.perf_counter()
    rng, backoff = random.Random(r["i"]), 0.0
    ctx = telemetry.start_trace() if trace else None
    if ctx is not None:
        r["trace_id"] = ctx.trace_id
    while True:
        try:
            with telemetry.activate(ctx):
                out = router.submit(r["prompt"], r["max_new"])
            break
        except Exception as exc:  # noqa: BLE001 - recorded per request
            if is_overloaded(exc) and not stop.is_set():
                r["retries"] += 1
                backoff = decorrelated_backoff(backoff, rng, base_s=0.005,
                                               cap_s=0.2)
                time.sleep(backoff)
                continue
            r.update(done=time.perf_counter(), ok=False, err=repr(exc))
            return
    out = np.asarray(out)
    r.update(done=time.perf_counter(), ok=True, reply=out,
             out_len=int(out.size) - int(r["prompt"].size))


def _request(i: int, prompt, max_new: int) -> dict:
    return {"i": i, "prompt": prompt, "prompt_len": int(prompt.size),
            "max_new": int(max_new), "due": None, "sent": None,
            "done": None, "ok": False, "retries": 0, "out_len": 0,
            "reply": None, "trace_id": None, "err": None}


def _wait_ready(router, timeout_s: float = 300.0) -> None:
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            if router.health()["dispatchable"] >= 1:
                return
        except Exception:  # noqa: BLE001 - the router may not be up yet
            pass
        if time.monotonic() > deadline:
            raise TimeoutError("no engine replica reached the router")
        time.sleep(0.05)


def _warm(router, plan: dict) -> None:
    """The warm-up requests, all at once: the engine's decode widths and
    prefill paths run once before the window."""
    stop = threading.Event()
    reqs = [_request(-1 - i, p, m) for i, (p, m) in
            enumerate(plan["warmup"])]
    with cf.ThreadPoolExecutor(max_workers=max(1, len(reqs))) as pool:
        list(pool.map(lambda r: _send(router, r, False, stop), reqs))
    bad = [r["err"] for r in reqs if not r["ok"]]
    if bad:
        raise RuntimeError(f"warm-up request failed: {bad[0]}")


def _drive(router, engine, plan: dict) -> dict:
    _wait_ready(router)
    _warm(router, plan)
    out = {"t_setup": time.perf_counter()}
    spans = _Spans(plan["trace"]).start()
    _backlog(router, engine, plan, out)
    out["spans"] = spans.stop()
    return out


def _window(engine, plan, out, t0):
    """Counters at both ends, the device trace in the middle."""
    prof_box: dict = {}
    prof = profiling.profile_in(plan, t0, prof_box) if plan["trace"] else None
    out["stats0"] = engine.stats()
    out["t0"], out["perf_to_wall"] = t0, time.time() - time.perf_counter()
    return prof, prof_box


def _backlog(router, engine, plan, out) -> None:
    stop = threading.Event()
    reqs, lock = [], threading.Lock()
    counter = iter(range(10 ** 9))

    def worker():
        while not stop.is_set():
            with lock:
                i = next(counter)
                r = _request(i, plan["prompt"](i), plan["out_lens"][i])
                reqs.append(r)
            r["due"] = time.perf_counter()
            _send(router, r, plan["trace"], stop)

    threads = [threading.Thread(target=worker, daemon=True,
                                name=f"perfbench-load-{k}")
               for k in range(plan["outstanding"])]
    for th in threads:
        th.start()
    time.sleep(plan["ramp_s"])
    t0 = time.perf_counter()
    prof, prof_box = _window(engine, plan, out, t0)
    t1 = t0 + plan["seconds"]
    time.sleep(max(0.0, t1 - time.perf_counter()))
    out["t1"] = t1
    out["stats1"] = engine.stats()
    stop.set()
    if prof is not None:
        prof.join()
    with lock:
        out["requests"] = [dict(r) for r in reqs]
    out["trace"] = prof_box.get("trace")
    out["threads"] = threads


def plan_for(cell, s: dict, seed: int, seconds: float, trace: bool) -> dict:
    """Everything the load does, drawn from the seed and the mix."""
    mix, serve = cell.traffic, cell.config["serve"]
    if mix["mode"] != "backlog":
        raise ValueError(f"unknown serving mode {mix['mode']!r}")
    plan = {"seconds": float(seconds), "trace": bool(trace),
            "profile_s": float(mix["profile_s"]),
            "ramp_s": float(mix["ramp_s"])}
    plan["outstanding"] = min(int(mix["outstanding_per_slot"]
                                  * serve["num_slots"]),
                              int(mix["max_outstanding"]))
    n = int(mix["max_requests"])
    p_len, o_len = tr.lengths(mix, seed, n, block=int(mix["block"]))
    plan["out_lens"] = [int(x) for x in o_len]
    vocab = s["vocab"]
    plan["prompt"] = lambda i: tr.prompt(vocab, p_len[i], seed, i)
    wrng = np.random.default_rng([int(seed) % (1 << 63), 4])
    warm = mix["warmup"]
    plan["warmup"] = [
        (wrng.integers(0, vocab, int(warm["prompt_lens"][k % len(
            warm["prompt_lens"])]), dtype=np.int32),
         int(warm["max_new"][k % len(warm["max_new"])]))
        for k in range(int(warm["requests"]))]
    return plan


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> tuple[Bundle, dict]:
    """Launch the program, drive the window, stop the program. Returns the
    bundle and what the correctness check needs (``weights`` is the tree
    both sides read; the program's state is gone by then)."""
    conf, serve = cell.config, cell.config["serve"]
    arch = cell.arch
    s = arch.sizes(conf)
    model_cfg = arch.program_config(conf)
    dtype = getattr(torch, s["compute_dtype"])
    weights = wts.draw(arch.layout(s), seed, device, dtype)
    wts.check_layout(weights, transformer.param_shapes(model_cfg))
    plan = plan_for(cell, s, seed, seconds, trace)
    box = _Box()
    p = lp.Program(f"perfbench-{cell.name}")
    with p.group("registry"):
        registry = p.add_node(lp.CourierNode(
            lp.Registry, ttl_s=float(serve["registry_ttl_s"])))
    with p.group("server"):
        engine = p.add_node(lp.MeshWorkerNode(
            BenchEngineServer, model_cfg, weights,
            max_new=int(serve["default_max_new"]),
            num_slots=int(serve["num_slots"]),
            context_len=int(serve["context_len"]),
            page_size=serve.get("page_size"),
            prefill_chunk=serve.get("prefill_chunk"),
            prefix_cache=bool(serve.get("prefix_cache", True)),
            sync_every=int(serve["sync_every"]), eos_id=serve.get("eos_id"),
            request_timeout_s=float(serve["request_timeout_s"]),
            registry=registry, heartbeat_s=float(serve["heartbeat_s"]),
            device=str(device)))
    with p.group("router"):
        router = p.add_node(lp.CourierNode(
            Router, registry, refresh_s=float(serve["heartbeat_s"]),
            coalesce=False,
            request_timeout_s=float(serve["request_timeout_s"])))
    with p.group("load"):
        p.add_node(lp.PyNode(LoadNode, router, engine, plan, box))
    launcher = lp.ThreadLauncher(restart_policy=lp.RestartPolicy(
        max_restarts=0))
    launcher.launch(p)
    deadline = time.monotonic() + float(cell.traffic["run_limit_s"])
    while not box.done.wait(0.5):
        if launcher.fatal_failures or time.monotonic() > deadline:
            break
    launcher.stop()
    launcher.wait(timeout=60.0)
    if box.error is not None:
        raise box.error
    if box.result is None:
        failure = launcher.fatal_failures
        raise RuntimeError(f"the program failed before the window ended: "
                           f"{failure[0] if failure else 'time limit'}")
    res = box.result
    for th in res.get("threads", []):
        th.join(timeout=30.0)
    trace_obj = res.get("trace")
    if trace_obj is not None:
        trace_obj.read()
    b = Bundle(cell=cell.name, sizes=s, config=conf, traffic=cell.traffic,
               seconds=float(seconds), setup_s=res["t_setup"] - t_start,
               t0=res["t0"], t1=res["t1"], perf_to_wall=res["perf_to_wall"],
               requests=res["requests"], spans=res["spans"],
               stats0=res["stats0"], stats1=res["stats1"], trace=trace_obj,
               arch=arch)
    b.host_spans = [(sp["name"], sp["ts"], sp["ts"] + sp["dur"])
                    for sp in res["spans"]]
    return b, {"weights": weights, "sizes": s}
