"""LM serving as a Launchpad program — the port of ``repro.launch.serve``
for the single-engine topology:

    frontend clients (CourierNode × N)
      -> batcher (CourierNode: thin admission queue, per-request replies)
      -> model server (MeshWorkerNode: ServeEngine on one torch device)

``--mode continuous`` (default) runs a :class:`ServeEngine` in the model
server; ``--mode lockstep`` keeps the batch-at-a-time baseline. Weights
are seeded random tensors drawn on the device (no checkpoint is loaded).
The serve fabric (routers, registry, rollout, telemetry hub, fault
injection) and checkpoint loading are later slices of the port and raise
``NotImplementedError`` here.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 4
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch falcon-mamba-7b --device cpu

Attention-only (qwen2), RG-LRU + LOCAL (recurrentgemma) and Mamba-1
(falcon-mamba) stacks serve here; the recurrent ones keep per-row state
in the engine. MoE, vision and audio stacks are ROADMAP.md queue item Q5.
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
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serve import decode as serve_lib
from repro_torch.serve.engine import ServeEngine, resolve_device

# Bounded, thread-safe history for Batcher.stats().
STATS_WINDOW = 256

_FABRIC = ("the serve fabric (routers, registry, rollout, telemetry hub, "
           "fault injection) is not ported yet — ROADMAP.md queue item Q3")
_CKPT = ("checkpoint loading is not ported yet — ROADMAP.md queue item Q4 "
         "(checkpoint I/O)")


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
    sequence retires and returns it as ``np.ndarray``."""

    def __init__(self, model_cfg: ModelConfig, max_new: int = 8,
                 num_slots: int = 8, context_len: int | None = None,
                 eos_id: int | None = None, request_timeout_s: float = 120.0,
                 sync_every: int = 8, decode_impl: str = "auto",
                 top_k: int | None = None,
                 prefill_chunk: int | None = None,
                 page_size: int | None = None,
                 num_pages: int | None = None,
                 prefix_cache: bool = True,
                 device="cuda", registry=None,
                 store_dir: str | None = None):
        if registry is not None:
            raise NotImplementedError(_FABRIC)
        if store_dir is not None:
            raise NotImplementedError(_CKPT)
        dev = resolve_device(device)
        self._cfg = model_cfg
        self._timeout = request_timeout_s
        params = transformer.init_params(model_cfg, seed=0, device=dev)
        self._engine = ServeEngine(
            model_cfg, params, num_slots=num_slots,
            context_len=context_len or 128,
            max_new=max_new, eos_id=eos_id, sync_every=sync_every,
            decode_impl=decode_impl, top_k=top_k,
            prefill_chunk=prefill_chunk, page_size=page_size,
            num_pages=num_pages, prefix_cache=prefix_cache, device=dev)
        self._engine.start()

    def generate(self, prompt, max_new=None):
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
        """Free slots, queued requests, EWMA us/token (and pages)."""
        return self._engine.load()

    def health(self):
        status = "ok" if self._engine.alive else "stopped"
        return {"status": status, **self.load()}

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
    go to the meter in one ``batch_call``. (The fabric's Overloaded
    retry comes with the router, queue item Q3.)"""

    def __init__(self, batcher, meter, num_requests: int, prompt_len: int,
                 vocab: int, seed: int, window: int = 4, source: str = "",
                 trace_every: int = 0):
        self._batcher = batcher
        self._meter = meter
        self._n = num_requests
        self._rng = np.random.default_rng(seed)
        self._plen = prompt_len
        self._vocab = vocab
        self._window = max(1, window)
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

        def drain_one():
            t0, fut, trace = pending.pop(0)
            out = fut.result(timeout=120)
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
            pending.append((time.monotonic(), self._submit(prompt, trace),
                            trace))
        while pending:
            drain_one()
        self._meter.batch_call(
            [("record", (lat, out_len), {"source": self._source})
             for lat, out_len in records])


class Meter:
    """Collects request latencies; prints percentiles and (optionally)
    writes the summary — count, p50/p95/mean ms (exact, from the raw
    samples), and the output lengths seen — to a JSON file, then stops
    the program once ``expected`` requests are recorded. Every sample
    also lands in the ``meter.latency_ms.<source>`` telemetry histogram,
    so a ``telemetry()`` scrape sees the same distribution."""

    def __init__(self, expected: int, summary_path: str | None = None):
        self._expected = expected
        self._summary_path = summary_path
        self._hists: dict[str, telemetry.Histogram] = {}
        self._lat_ms: list[float] = []
        self._out_lens: list[int] = []
        self._count = 0
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
            h.record(latency_s * 1e3)
            self._lat_ms.append(latency_s * 1e3)
            self._out_lens.append(int(out_len))
            self._count += 1
            done = self._count == self._expected
        if not done:
            return
        lat = np.asarray(self._lat_ms)
        summary = {"count": int(lat.size),
                   "p50_ms": float(np.percentile(lat, 50)),
                   "p95_ms": float(np.percentile(lat, 95)),
                   "mean_ms": float(lat.mean()),
                   "out_lens": sorted(self._out_lens)}
        print(f"served {summary['count']} requests: "
              f"p50={summary['p50_ms']:.1f}ms "
              f"p95={summary['p95_ms']:.1f}ms", flush=True)
        if self._summary_path:
            with open(self._summary_path, "w") as f:
                json.dump(summary, f, indent=2)
                f.write("\n")
        lp.stop_program()

    def telemetry(self):
        return telemetry.telemetry_snapshot()


def build_program(model_cfg: ModelConfig, *, num_clients=3,
                  requests_per_client=4, prompt_len=8, max_new=8,
                  mode: str = "continuous", num_slots: int = 8,
                  meter_json: str | None = None, replicas: int = 1,
                  routers: int = 0, kill_after: int | None = None,
                  page_size: int | None = None,
                  num_pages: int | None = None,
                  store_dir: str | None = None,
                  rollout: int | None = None,
                  telemetry_dir: str | None = None,
                  trace_every: int = 0, device="cuda") -> lp.Program:
    """Wire the single-engine serving topology as a Launchpad program:
    one engine server (or the lockstep baseline) on ``device`` behind a
    Batcher, ``num_clients`` clients and a Meter that stops the program
    after the last request."""
    if routers or replicas != 1 or kill_after is not None \
            or rollout is not None or telemetry_dir is not None:
        raise NotImplementedError(_FABRIC)
    if store_dir is not None:
        raise NotImplementedError(_CKPT)
    resolve_device(device)
    p = lp.Program(f"serve-{model_cfg.name}")
    total = num_clients * requests_per_client
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
    meter = p.add_node(lp.CourierNode(Meter, total, summary_path=meter_json))
    with p.group("client"):
        for i in range(num_clients):
            p.add_node(lp.CourierNode(
                Client, batcher, meter, requests_per_client, prompt_len,
                model_cfg.vocab_size, seed=i, trace_every=trace_every))
    return p


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b",
                    help="architecture; its reduced config is served")
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
    ap.add_argument("--trace-every", type=int, default=0, metavar="N",
                    help="trace every Nth request per client (0 = off)")
    args = ap.parse_args(argv)
    cfg = configs.get_reduced(args.arch)
    program = build_program(cfg, num_clients=args.clients,
                            requests_per_client=args.requests,
                            mode=args.mode, num_slots=args.slots,
                            meter_json=args.meter_json,
                            page_size=args.page_size, num_pages=args.pages,
                            trace_every=args.trace_every, device=args.device)
    print(program)
    lp.launch_and_wait(program, timeout_s=600)


if __name__ == "__main__":
    main()
