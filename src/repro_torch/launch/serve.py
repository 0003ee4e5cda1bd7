"""LM serving as a Launchpad program — the port of ``repro.launch.serve``.

Single-engine topology (``--replicas 1 --routers 0``):

    frontend clients (CourierNode × N)
      -> batcher (CourierNode: thin admission queue, per-request replies)
      -> model server (MeshWorkerNode: ServeEngine on one torch device)

Replicated serve fabric (``--replicas N --routers M``, M >= 1):

    frontend clients (CourierNode × N)
      -> routers (CourierNode × M: least-loaded dispatch, failover)
      -> engine servers (MeshWorkerNode × N: one ServeEngine each)
           ⇅ heartbeats (endpoint + load report)
    registry (CourierNode: membership, TTL eviction)

Every engine replica registers its endpoint with the ``Registry`` and
heartbeats a load report; each ``Router`` dispatches to the least-loaded
replica, fails over onto a sibling when one dies mid-decode, and fails
fast with the typed ``Overloaded`` when every replica is at its
admission budget (``repro_torch/serve/router.py``). ``--kill-after N``
kills replica 0 after N served requests (the failover demo);
``--rollout-after N`` publishes v0/v1 into a ``ModelStore`` in the JAX
package's layout and rolls the fleet v0 -> v1 under load (drain,
hot-swap, canary, promote or roll back: ``repro_torch/serve/rollout.py``);
``--telemetry-dir`` runs a ``TelemetryHub`` that writes
``telemetry.json`` and a Perfetto ``trace.json``.

``--mode continuous`` (default) runs a :class:`ServeEngine` in the model
server; ``--mode lockstep`` keeps the batch-at-a-time baseline (single
engine only). Weights are seeded random tensors drawn on the device, or
restored from ``--store``.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 4
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --replicas 2 --routers 1 --kill-after 2
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --replicas 2 --routers 1 --rollout-after 2
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch mixtral-8x7b --device cpu

Attention-only (qwen2, qwen3, starcoder2, command-r-plus), MoE (mixtral-8x7b
and mixtral-8x22b: sliding-window attention with top-2 experts), RG-LRU +
LOCAL (recurrentgemma) and Mamba-1 (falcon-mamba) stacks serve here; the
recurrent ones keep per-row state in the engine. Llama-3.2-Vision needs
image memory, which no engine request carries: it is served by
``serve.decode.generate(memory=...)``, and the engine refuses it. HuBERT
is an encoder with no decode step (``transformer.forward(embeddings=...)``).
"""

from __future__ import annotations

import argparse
import collections
import json
import queue
import threading
import time

import numpy as np
import torch

from repro_torch import configs, core as lp
from repro_torch.core import telemetry
from repro_torch.models import convert, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serve import decode as serve_lib
from repro_torch.serve.engine import ServeEngine, resolve_device
from repro_torch.serve.router import (Router, decorrelated_backoff,
                                      is_overloaded)

# Bounded, thread-safe history for Batcher.stats().
STATS_WINDOW = 256


class ModelServer:
    """Lockstep baseline: holds params; serves batched generate() on its
    device. Replies are numpy."""

    def __init__(self, model_cfg: ModelConfig, max_new: int = 8,
                 device="cuda"):
        self._dev = resolve_device(device)
        self._cfg = model_cfg
        self._max_new = max_new
        self._params = transformer.init_params(model_cfg, seed=0,
                                               device=self._dev)

    def generate(self, prompts, lengths=None):
        toks = torch.as_tensor(np.asarray(prompts, np.int32),
                               device=self._dev)
        out = serve_lib.generate(self._cfg, self._params, toks,
                                 max_new=self._max_new,
                                 context_len=toks.shape[1] + self._max_new,
                                 lengths=None if lengths is None
                                 else np.asarray(lengths, np.int32))
        return out.cpu().numpy()


class EngineServer:
    """Continuous-batching model server: a ServeEngine on this worker's
    device. ``generate`` blocks its RPC handler thread until that one
    sequence retires and returns it as ``np.ndarray``.

    With ``registry`` set (the serve fabric), the server registers its own
    endpoint — taken from the worker context — and heartbeats its load
    report (``load()``: free slots, queue depth, EWMA us/token, loaded
    model version), the routers' routing signal and the rollout's version
    table. ``kill()`` crashes the replica in place (engine and heartbeats
    stop, no deregistration); ``stall``/``drop`` are the FaultInjector's
    softer faults (missed beats / transport blackhole for a window).

    With ``store_dir`` set, weights are restored from a versioned
    :class:`~repro_torch.ckpt.checkpoint.ModelStore` (``version=None``
    means latest) in the JAX package's layout — fp32, ``blocks`` stacked
    — checked leaf by leaf against this architecture's shapes, then cast
    to the compute dtype on the device. ``load_version()`` hot-swaps to
    another published version between decode windows; a version published
    for another architecture fails the shape check before anything is
    installed (the rollout's health gate).
    """

    def __init__(self, model_cfg: ModelConfig, max_new: int = 8,
                 num_slots: int = 8, context_len: int | None = None,
                 eos_id: int | None = None, request_timeout_s: float = 120.0,
                 registry=None, heartbeat_s: float = 0.5,
                 name: str | None = None, endpoint: str | None = None,
                 sync_every: int = 8, decode_impl: str = "auto",
                 top_k: int | None = None,
                 prefill_chunk: int | None = None,
                 page_size: int | None = None,
                 num_pages: int | None = None,
                 prefix_cache: bool = True,
                 store_dir: str | None = None,
                 version: int | None = None, device="cuda"):
        dev = resolve_device(device)
        self._cfg = model_cfg
        self._dev = dev
        self._timeout = request_timeout_s
        self._store = None
        self._version: int | None = None
        self._drop_until = 0.0
        ctx = lp.get_current_context() if registry is not None else None
        self._name = name = name or (ctx.node_name if ctx else None)
        params = transformer.init_params(model_cfg, seed=0, device=dev)
        if store_dir is not None:
            from repro_torch.ckpt.checkpoint import ModelStore
            self._store = ModelStore(store_dir)
            v = self._store.latest_version() if version is None else version
            if v is None:
                raise ValueError(f"model store {store_dir!r} has no "
                                 "published versions")
            params = self._restore(int(v), params)
            self._version = int(v)
        self._engine = ServeEngine(
            model_cfg, params, num_slots=num_slots,
            context_len=context_len or 128,
            max_new=max_new, eos_id=eos_id, sync_every=sync_every,
            decode_impl=decode_impl, top_k=top_k,
            prefill_chunk=prefill_chunk, page_size=page_size,
            num_pages=num_pages, prefix_cache=prefix_cache, device=dev)
        self._engine.start()
        self._heartbeater = None
        if registry is not None:
            endpoint = endpoint or ctx.endpoint
            if endpoint is None:
                raise ValueError(
                    "EngineServer(registry=...) needs a serving endpoint: "
                    "run it as a courier-serving node or pass endpoint=")
            self._heartbeater = lp.Heartbeater(
                registry, name, endpoint, load_fn=self.load,
                period_s=heartbeat_s, stop_event=ctx.stop_event).start()

    def _restore(self, version: int, params) -> dict:
        """Version ``version`` from the store, shape-checked against
        ``params`` (the current tree) and placed on this device."""
        t0 = time.perf_counter()
        like = convert.params_to_numpy(self._cfg, params)
        t1 = time.perf_counter()
        tree = self._store.load_version(version, like=like)
        del like
        t2 = time.perf_counter()
        out = convert.params_from_numpy(self._cfg, tree, device=self._dev)
        t3 = time.perf_counter()
        print(f"store: {self._name or 'engine'} restored v{version} in "
              f"{t3 - t0:.3f}s (like {t1 - t0:.3f}s, read {t2 - t1:.3f}s, "
              f"install {t3 - t2:.3f}s)", flush=True)
        return out

    def generate(self, prompt, max_new=None):
        if time.monotonic() < self._drop_until:
            raise ConnectionError("transport drop (fault injection)")
        fut = self._engine.submit(np.asarray(prompt, np.int32).reshape(-1),
                                  max_new=max_new)
        from concurrent import futures as cf
        try:
            return fut.result(timeout=self._timeout)
        except cf.TimeoutError:
            # A queued (not yet admitted) request is cancellable: don't
            # let an abandoned reply go on to occupy a slot.
            fut.cancel()
            raise

    def load(self):
        """Free slots, queued requests, EWMA us/token (and pages), plus
        the loaded model version, which the heartbeat carries into the
        Registry's version table."""
        report = self._engine.load()
        if self._version is not None:
            report["version"] = self._version
        return report

    def health(self):
        status = "ok" if self._engine.alive else "stopped"
        return {"status": status, **self.load()}

    def load_version(self, version):
        """Hot-swap to a published model version (the rollout's swap
        step): restore against the current tree, then install between
        decode windows."""
        if self._store is None:
            raise RuntimeError("EngineServer has no model store attached "
                               "(pass store_dir=)")
        self._engine.swap_params(self._restore(int(version),
                                               self._engine._params))
        self._version = int(version)
        if self._heartbeater is not None:
            # Don't wait a beat period to advertise the new version.
            self._heartbeater.beat_now()
        return {"version": self._version}

    def stall(self, seconds: float):
        """Fault hook: miss heartbeats for ``seconds`` — the registry
        TTL-evicts this replica, then its resumed beats re-register it.
        The engine keeps serving whatever is already in flight."""
        telemetry.record_event("stall", cause=f"heartbeats paused "
                               f"{seconds}s (fault injection)")
        if self._heartbeater is not None:
            self._heartbeater.pause(seconds)
        return "stalled"

    def drop(self, seconds: float):
        """Fault hook: blackhole the request transport for ``seconds`` —
        ``generate`` raises ``ConnectionError`` and routers fail over;
        heartbeats continue, so the replica recovers after the window."""
        telemetry.record_event("drop", cause=f"transport blackholed "
                               f"{seconds}s (fault injection)")
        self._drop_until = time.monotonic() + float(seconds)
        return "dropped"

    def kill(self):
        """Simulate a replica crash: stop heartbeats (no deregistration)
        and the engine, failing everything in flight."""
        telemetry.record_event("kill", cause="replica killed "
                               "(fault injection)")
        if self._heartbeater is not None:
            self._heartbeater.stop(deregister=False)
        self._engine.stop()
        return "killed"

    def stats(self):
        return self._engine.stats()

    def telemetry(self):
        """Process metrics + drained span/event rings, with the engine's
        counters as the service payload."""
        return telemetry.telemetry_snapshot(service=self._engine.stats())

    def run(self):
        """Worker body: serve RPCs until the program stops, then stop the
        engine thread (no decode left running past the program)."""
        lp.get_current_context().wait_for_stop()
        self._engine.stop()


class Batcher:
    """Admission front for the model server.

    ``mode="continuous"``: thin pass-through — each ``submit`` forwards
    the prompt as its own ``futures.generate`` RPC and blocks its handler
    thread for that one reply; batching happens inside the engine.

    ``mode="lockstep"``: the coalescing worker (the A/B baseline): up to
    ``max_batch`` queued prompts are right-padded into one batch and sent
    with their true lengths, with at most ``max_inflight`` batches out.
    """

    def __init__(self, server, max_batch: int = 8, max_wait_s: float = 0.02,
                 max_inflight: int = 2, mode: str = "continuous",
                 request_timeout_s: float = 150.0):
        if mode not in ("continuous", "lockstep"):
            raise ValueError(f"unknown serve mode {mode!r}")
        self._server = server
        self._mode = mode
        # Above the engine server's own per-request timeout, so a server-
        # side timeout surfaces as the reply instead of racing this one.
        self._timeout = request_timeout_s
        self._q: queue.Queue = queue.Queue()
        self._max_batch = max_batch
        self._max_wait = max_wait_s
        self._inflight = threading.Semaphore(max_inflight)
        self._stats_lock = threading.Lock()
        self._batches = collections.deque(maxlen=STATS_WINDOW)
        self._submitted = 0
        if mode == "lockstep":
            self._worker = threading.Thread(target=self._loop, daemon=True)
            self._worker.start()

    def submit(self, prompt):
        """Blocking request: returns the completed sequence."""
        with self._stats_lock:
            self._submitted += 1
        if self._mode == "continuous":
            fut = self._server.futures.generate(
                np.asarray(prompt, np.int32))
            return fut.result(timeout=self._timeout)
        done = queue.Queue(maxsize=1)
        self._q.put((np.asarray(prompt, np.int32), done))
        out = done.get(timeout=self._timeout)
        if isinstance(out, BaseException):
            raise out
        return out

    def _loop(self):
        while True:
            first = self._q.get()
            group = [first]
            deadline = time.monotonic() + self._max_wait
            while len(group) < self._max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    group.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            lengths = np.array([len(g[0]) for g in group], np.int32)
            prompts = np.zeros((len(group), int(lengths.max())), np.int32)
            for row, (p, _) in zip(prompts, group):
                row[:len(p)] = p
            group = [done for _, done in group]
            self._inflight.acquire()
            fut = self._server.futures.generate(prompts, lengths)
            with self._stats_lock:
                self._batches.append(len(group))
            fut.add_done_callback(
                lambda f, group=group: self._deliver(group, f))

    def _deliver(self, group, fut):
        self._inflight.release()
        try:
            outs = fut.result()
        except BaseException as exc:  # noqa: BLE001 - fail the waiters
            for done in group:
                done.put(exc)
            return
        for done, row in zip(group, outs):
            done.put(row)

    def stats(self):
        with self._stats_lock:
            return {"mode": self._mode,
                    "submitted": self._submitted,
                    "batches": list(self._batches)}


class Client:
    """Closed-loop client with a bounded pipeline window: up to
    ``window`` requests in flight as ``futures.submit``; latency samples
    go to the meter in one ``batch_call``. ``Overloaded`` (the fabric's
    retry-later signal) is retried with decorrelated jitter, latency
    accruing from the first attempt."""

    def __init__(self, batcher, meter, num_requests: int, prompt_len: int,
                 vocab: int, seed: int, window: int = 4, source: str = "",
                 trace_every: int = 0, gate=None):
        self._batcher = batcher
        self._meter = meter
        # A node whose ``armed()`` must be true before the first request
        # (the failover demo's fault injector).
        self._gate = gate
        self._n = num_requests
        self._rng = np.random.default_rng(seed)
        self._plen = prompt_len
        self._vocab = vocab
        self._window = max(1, window)
        # Which admission front this client talks to (router/batcher node
        # label) — the meter namespaces its percentiles by it.
        self._source = source
        # Trace sampling: every Nth request carries a trace envelope.
        self._trace_every = max(0, int(trace_every))

    def _submit(self, prompt, trace):
        if trace is None:
            return self._batcher.futures.submit(prompt)
        with telemetry.activate(trace[0].child(trace[1])):
            return self._batcher.futures.submit(prompt)

    def run(self):
        pending: list[tuple] = []
        records: list[tuple[float, int]] = []
        while self._gate is not None and not self._gate.armed():
            time.sleep(0.002)

        def drain_one():
            t0, prompt, fut, trace = pending.pop(0)
            backoff = 0.0
            while True:
                try:
                    out = fut.result(timeout=120)
                    break
                except BaseException as exc:  # noqa: BLE001
                    # Every client sees Overloaded at the same moment when
                    # capacity dips (a drain, a kill): jitter the resubmit
                    # so they do not stampede back on the same tick.
                    if not is_overloaded(exc):
                        raise
                    backoff = decorrelated_backoff(backoff, self._rng,
                                                   base_s=0.005, cap_s=0.2)
                    time.sleep(backoff)
                    fut = self._submit(prompt, trace)
            if trace is not None:
                ctx, root_sid, t0w, t0p = trace
                telemetry.record_span("request", ctx, t0w,
                                      time.perf_counter() - t0p,
                                      span_id=root_sid, root=True,
                                      out_len=len(out))
            records.append((time.monotonic() - t0, len(out)))

        for k in range(self._n):
            while len(pending) >= self._window:
                drain_one()
            prompt = self._rng.integers(0, self._vocab, self._plen,
                                        dtype=np.int32)
            trace = None
            if self._trace_every and k % self._trace_every == 0:
                trace = (telemetry.start_trace(), telemetry.new_span_id(),
                         time.time(), time.perf_counter())
            pending.append((time.monotonic(), prompt,
                            self._submit(prompt, trace), trace))
        while pending:
            drain_one()
        self._meter.batch_call(
            [("record", (lat, out_len), {"source": self._source})
             for lat, out_len in records])


class ArmedFaultInjector(lp.FaultInjector):
    """The failover demo's ``FaultInjector``, served as a courier node so
    that clients can wait for it: ``armed()`` is true once its poll loop
    runs. Without the wait, clients started before the injector could
    serve every request first, and a count-triggered kill would never
    fire (or fire after the run)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._armed = threading.Event()

    def armed(self) -> bool:
        return self._armed.is_set()

    def run(self) -> None:
        self._armed.set()
        super().run()
        # Serve ``armed()`` to late clients until the program stops.
        lp.get_current_context().wait_for_stop()


def _summary(lat_ms: list[float]) -> dict:
    lat = np.asarray(lat_ms)
    return {"count": int(lat.size),
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "mean_ms": float(lat.mean())}


class Meter:
    """Collects request latencies; prints percentiles and (optionally)
    writes the summary — count, p50/p95/mean ms (exact, from the raw
    samples), and the output lengths seen — to a JSON file, then stops
    the program once ``expected`` requests are recorded. Clients with a
    named source (a router) get their own rows under ``per_source``.
    Every sample also lands in the ``meter.latency_ms.<source>``
    telemetry histogram, so a ``telemetry()`` scrape sees the same
    distribution. (The JAX package's meter reports the histogram's
    log2-bucket percentiles instead; ROADMAP.md C13.)

    ``holds`` delays the program stop past the last served request: each
    hold is dropped by a ``release()`` RPC, and the stop fires only once
    the count is reached AND every hold is released (the rollout driver
    holds one until its roll is done)."""

    def __init__(self, expected: int, summary_path: str | None = None,
                 holds: int = 0):
        self._expected = expected
        self._summary_path = summary_path
        self._hists: dict[str, telemetry.Histogram] = {}
        self._lat_ms: dict[str, list[float]] = {}
        self._out_lens: list[int] = []
        self._count = 0
        self._holds = holds
        self._summary_done = False
        self._lock = threading.Lock()

    def record(self, latency_s: float, out_len: int, source: str = ""):
        with self._lock:
            src = source or "default"
            h = self._hists.get(src)
            if h is None:
                h = telemetry.metrics().histogram(f"meter.latency_ms.{src}")
                # This meter's lifetime scopes the window: the registry
                # entry may survive from a previous program in-process.
                h.reset()
                self._hists[src] = h
                self._lat_ms[src] = []
            h.record(latency_s * 1e3)
            self._lat_ms[src].append(latency_s * 1e3)
            self._out_lens.append(int(out_len))
            self._count += 1
            summary = None
            if self._count >= self._expected and not self._summary_done:
                self._summary_done = True
                summary = _summary([x for v in self._lat_ms.values()
                                    for x in v])
                summary["out_lens"] = sorted(self._out_lens)
                if len(self._lat_ms) > 1 or "default" not in self._lat_ms:
                    summary["per_source"] = {
                        src: _summary(lat)
                        for src, lat in sorted(self._lat_ms.items())}
            stop = self._count >= self._expected and self._holds == 0
        if summary is not None:
            print(f"served {summary['count']} requests: "
                  f"p50={summary['p50_ms']:.1f}ms "
                  f"p95={summary['p95_ms']:.1f}ms", flush=True)
            if self._summary_path:
                with open(self._summary_path, "w") as f:
                    json.dump(summary, f, indent=2)
                    f.write("\n")
        if stop:
            lp.stop_program()

    def telemetry(self):
        return telemetry.telemetry_snapshot()

    def release(self, tag: str = "") -> None:
        """Drop one stop-hold (e.g. the RolloutDriver finished its roll)."""
        with self._lock:
            self._holds = max(0, self._holds - 1)
            stop = self._count >= self._expected and self._holds == 0
        if stop:
            lp.stop_program()


def build_program(model_cfg: ModelConfig, *, num_clients=3,
                  requests_per_client=4, prompt_len=8, max_new=8,
                  mode: str = "continuous", num_slots: int = 8,
                  meter_json: str | None = None, replicas: int = 1,
                  routers: int = 0, registry_ttl_s: float = 2.0,
                  heartbeat_s: float = 0.25,
                  kill_after: int | None = None,
                  page_size: int | None = None,
                  num_pages: int | None = None,
                  store_dir: str | None = None,
                  model_version: int | None = None,
                  rollout: int | None = None,
                  rollout_after: int | None = None,
                  canary_fraction: float = 0.25,
                  telemetry_dir: str | None = None,
                  trace_every: int = 0, device="cuda") -> lp.Program:
    """Wire the serving topology as a Launchpad program on ``device``.

    ``routers == 0`` (default) is the direct path — one engine (or the
    lockstep baseline) behind a Batcher; ``replicas`` must be 1.
    ``routers >= 1`` builds the replicated serve fabric:
    Registry -> Routers -> EngineServers, clients partitioned across
    routers round-robin. ``kill_after`` adds a FaultInjector node that
    kills replica 0 once that many requests have been served.

    ``store_dir`` points the engines at a versioned ModelStore
    (``model_version`` picks the starting version; None = latest), and
    ``rollout=V`` adds a RolloutDriver that rolls the fleet to version
    ``V`` once ``rollout_after`` requests have been served.

    ``telemetry_dir`` adds a TelemetryHub node (fabric only) that scrapes
    every replica through the registry — plus the routers and meter by
    handle — and writes ``telemetry.json`` + ``trace.json`` there.
    ``trace_every=N`` makes every client trace its every Nth request.
    """
    resolve_device(device)
    p = lp.Program(f"serve-{model_cfg.name}")
    total = num_clients * requests_per_client

    if routers < 1:
        if replicas != 1:
            raise ValueError("replicas > 1 needs at least one router "
                             "(--routers 1)")
        if kill_after is not None:
            raise ValueError("the failover demo needs the fabric "
                             "(--routers >= 1 and --replicas >= 2)")
        with p.group("server"):
            if mode == "continuous":
                server = p.add_node(lp.MeshWorkerNode(
                    EngineServer, model_cfg, max_new=max_new,
                    num_slots=num_slots, context_len=prompt_len + max_new,
                    page_size=page_size, num_pages=num_pages, device=device))
            else:
                server = p.add_node(lp.MeshWorkerNode(
                    ModelServer, model_cfg, max_new=max_new, device=device))
        with p.group("batcher"):
            batcher = p.add_node(lp.CourierNode(Batcher, server, mode=mode))
        meter = p.add_node(lp.CourierNode(Meter, total,
                                          summary_path=meter_json))
        with p.group("client"):
            for i in range(num_clients):
                p.add_node(lp.CourierNode(
                    Client, batcher, meter, requests_per_client, prompt_len,
                    model_cfg.vocab_size, seed=i, trace_every=trace_every))
        return p

    if mode != "continuous":
        raise ValueError("the serve fabric routes to continuous-batching "
                         "engines only (drop --mode lockstep)")
    if kill_after is not None and replicas < 2:
        raise ValueError("killing a replica with no sibling loses requests "
                         "by construction; use --replicas >= 2")
    if kill_after is not None and kill_after >= total:
        raise ValueError(f"--kill-after {kill_after} never fires: only "
                         f"{total} requests will be served")
    if rollout is not None:
        if store_dir is None:
            raise ValueError("rollout= needs store_dir= (a ModelStore with "
                             "the target version published)")
        if rollout_after is None or rollout_after >= total:
            raise ValueError("rollout= needs rollout_after < total requests "
                             "so the roll happens under load")

    with p.group("registry"):
        registry = p.add_node(lp.CourierNode(lp.Registry,
                                             ttl_s=registry_ttl_s))
    replica_handles = []
    with p.group("server"):
        for _ in range(replicas):
            replica_handles.append(p.add_node(lp.MeshWorkerNode(
                EngineServer, model_cfg, max_new=max_new,
                num_slots=num_slots, context_len=prompt_len + max_new,
                page_size=page_size, num_pages=num_pages,
                registry=registry, heartbeat_s=heartbeat_s,
                store_dir=store_dir, version=model_version, device=device)))
    router_nodes, router_handles = [], []
    with p.group("router"):
        for _ in range(routers):
            # One RPC per request: a coalesced frame runs its calls one
            # after another on the replica (courier's batch_call), and a
            # generate call blocks until its sequence retires, so frames
            # would serialize requests the engine should batch
            # (ROADMAP.md C15).
            node = lp.CourierNode(Router, registry, refresh_s=heartbeat_s,
                                  coalesce=False)
            router_handles.append(p.add_node(node))
            router_nodes.append(node)
    meter = p.add_node(lp.CourierNode(Meter, total, summary_path=meter_json,
                                      holds=1 if rollout is not None else 0))
    chaos = None
    if kill_after is not None:
        with p.group("chaos"):
            chaos = p.add_node(lp.CourierNode(
                ArmedFaultInjector,
                [lp.FaultEvent(kind="kill", target=0,
                               after_served=kill_after)],
                [replica_handles[0]], progress=list(router_handles)))
    with p.group("client"):
        for i in range(num_clients):
            m = i % routers
            p.add_node(lp.CourierNode(
                Client, router_handles[m], meter, requests_per_client,
                prompt_len, model_cfg.vocab_size, seed=i,
                source=router_nodes[m].name, trace_every=trace_every,
                gate=chaos))
    if telemetry_dir is not None:
        with p.group("telemetry"):
            p.add_node(lp.PyNode(
                lp.TelemetryHub, registry,
                targets=list(router_handles) + [meter, registry],
                poll_s=max(heartbeat_s, 0.1), out_dir=telemetry_dir))
    if rollout is not None:
        with p.group("rollout"):
            p.add_node(lp.PyNode(RolloutDriver, registry,
                                 list(router_handles), rollout,
                                 rollout_after,
                                 canary_fraction=canary_fraction,
                                 meter=meter))
    return p


class RolloutDriver:
    """Program node that triggers a fleet rollout mid-run: once the
    routers have completed ``after_served`` requests it runs a
    :class:`~repro_torch.serve.rollout.RolloutController` against the
    registry (all rollout state lives in the registry's version table, so
    a restarted driver resumes). It holds one Meter stop-hold until its
    roll completes, so the fleet is still serving when it runs.

    Besides the ``rollout: <status> -> v<V>`` line it prints one
    ``rollout: result {json}`` line: the controller's result (with the
    canary verdict's rows) and each live replica's ``load()["version"]``
    read after the roll."""

    def __init__(self, registry, routers, version: int, after_served: int,
                 canary_fraction: float = 0.25, canary_requests: int = 4,
                 canary_timeout_s: float = 5.0, meter=None):
        self._registry = registry
        self._routers = routers
        self._version = version
        self._after = after_served
        self._canary_fraction = canary_fraction
        self._canary_requests = canary_requests
        self._canary_timeout = canary_timeout_s
        self._meter = meter

    def _replica_versions(self) -> dict:
        out = {}
        for name, info in sorted(self._registry.version_table().items()):
            client = lp.courier.client_for(info["endpoint"])
            try:
                out[name] = client.load().get("version")
            except Exception as exc:  # noqa: BLE001 - report, don't hide
                out[name] = f"unreachable ({exc!r})"
            finally:
                client.close()
        return out

    def run(self):
        from repro_torch.serve.rollout import RolloutController
        ctx = lp.get_current_context()
        try:
            while not ctx.wait_for_stop(0.002):
                try:
                    done = sum(r.stats()["completed"]
                               for r in self._routers)
                except Exception:
                    # Routers register their courier services
                    # asynchronously: keep polling through bring-up.
                    continue
                if done < self._after:
                    continue
                result = RolloutController(
                    self._registry, self._routers,
                    canary_fraction=self._canary_fraction,
                    canary_requests=self._canary_requests,
                    canary_timeout_s=self._canary_timeout,
                ).rollout(self._version)
                print(f"rollout: {result['status']} -> v{self._version} "
                      f"in {result.get('duration_s', 0.0):.2f}s", flush=True)
                result["replica_versions"] = self._replica_versions()
                print("rollout: result " + json.dumps(result, default=str),
                      flush=True)
                return
        finally:
            if self._meter is not None:
                try:
                    self._meter.release("rollout")
                except Exception:
                    pass


def publish_demo_versions(cfg: ModelConfig, store_dir: str,
                          versions=(0, 1), device="cuda") -> None:
    """Publish seeded weights ``init_params(cfg, seed=v)`` as version
    ``v`` of the ModelStore at ``store_dir``, in the JAX layout (fp32,
    ``blocks`` stacked), unless that version is already there."""
    from repro_torch.ckpt.checkpoint import ModelStore, config_hash
    store = ModelStore(store_dir)
    for v in versions:
        if v not in store.versions():
            params = transformer.init_params(cfg, seed=v, device=device)
            store.publish_version(
                v, convert.params_to_numpy(cfg, params),
                metadata={"step": v, "config_hash": config_hash(cfg)})
            del params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b",
                    help="architecture; its reduced config is served")
    ap.add_argument("--full", action="store_true",
                    help="serve the architecture's full config instead")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu on request)")
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--requests", type=int, default=4,
                    help="requests per client")
    ap.add_argument("--mode", choices=("continuous", "lockstep"),
                    default="continuous")
    ap.add_argument("--slots", type=int, default=8,
                    help="KV-cache slots (continuous mode)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="paged KV mode: tokens per page (None = flat)")
    ap.add_argument("--pages", type=int, default=None,
                    help="paged KV mode: pool size in pages")
    ap.add_argument("--meter-json", default=None,
                    help="write the latency percentile summary here")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas (>1 needs --routers >= 1)")
    ap.add_argument("--routers", type=int, default=0,
                    help="fabric routers; 0 = direct single-engine path")
    ap.add_argument("--kill-after", type=int, default=None, metavar="N",
                    help="failover demo: kill replica 0 after N requests "
                         "have been served (deterministically mid-run)")
    ap.add_argument("--store", default=None,
                    help="ModelStore directory (created and seeded with "
                         "v0/v1 for the rollout demo when absent)")
    ap.add_argument("--rollout-after", type=int, default=None, metavar="N",
                    help="rollout demo: roll the fleet v0 -> v1 after N "
                         "requests (needs the fabric; publishes both "
                         "versions into --store first)")
    ap.add_argument("--telemetry-dir", default=None, metavar="DIR",
                    help="fabric only: run a TelemetryHub and write "
                         "telemetry.json + trace.json (Perfetto) here")
    ap.add_argument("--trace-every", type=int, default=0, metavar="N",
                    help="trace every Nth request per client (0 = off)")
    args = ap.parse_args(argv)
    cfg = (configs.get(args.arch) if args.full
           else configs.get_reduced(args.arch))
    store_dir, model_version, rollout = args.store, None, None
    if args.rollout_after is not None:
        import tempfile
        store_dir = store_dir or tempfile.mkdtemp(prefix="modelstore-")
        publish_demo_versions(cfg, store_dir, device=args.device)
        model_version, rollout = 0, 1
    program = build_program(cfg, num_clients=args.clients,
                            requests_per_client=args.requests,
                            mode=args.mode, num_slots=args.slots,
                            meter_json=args.meter_json,
                            replicas=args.replicas, routers=args.routers,
                            kill_after=args.kill_after,
                            page_size=args.page_size, num_pages=args.pages,
                            store_dir=store_dir, model_version=model_version,
                            rollout=rollout,
                            rollout_after=args.rollout_after,
                            telemetry_dir=args.telemetry_dir,
                            trace_every=args.trace_every, device=args.device)
    print(program)
    lp.launch_and_wait(program, timeout_s=600)


if __name__ == "__main__":
    main()
