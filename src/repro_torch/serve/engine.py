"""Continuous-batching decode engine over a slotted KV cache — the port of
``repro.serve.engine``.

  * the KV cache is a fixed pool of ``num_slots`` rows
    (``transformer.init_decode_state`` with batch = num_slots) on the
    engine's device;
  * a persistent decode loop steps ALL occupied slots together, each at
    its own absolute position (``decode_step`` with a per-row ``t``);
  * decode runs in *fused windows* of K steps
    (``serve.decode.make_fused_serve_step``): feed tokens and positions
    stay device tensors and the host syncs one ``[num_slots, K]`` token
    block per window. ``sync_every`` caps K; each window's K is picked
    from the power-of-two ladder by useful-tokens-per-cost (see
    ``step``). EOS / ``max_new`` retirement slices each row's block to
    its own stop point;
  * ``decode_impl`` picks the attention leaf ("auto" | "dense" |
    "flash"): flash runs the flash-decode CUDA kernels (their plain
    version for a CPU engine); auto means flash on a CUDA device;
  * arrivals are admitted into free slots *between* windows: the request
    is prefilled alone at its exact prompt length and its state written
    into the free row (``write_decode_slot``);
  * with ``prefill_chunk``, a long prompt prefills in chunks interleaved
    between decode windows (``prefill_extend``), strict FCFS;
  * a sequence retires the moment it finishes and its slot is reusable;
  * replies stream back per request through ``concurrent.futures``.

Paged KV mode (``page_size`` set): full-context ATTN layers swap their
flat ``[num_slots, L]`` rings for a shared pool of ``num_pages`` pages
plus a host-resident ``[num_slots, n_log]`` page table. Admission
reserves a row's whole page budget up front, retirement refcount-releases
the pages and re-points the row at the trash page (physical page 0), and
a refcounted prefix cache (``serve.paging.PrefixCache``) lets a prompt
sharing a cached page-aligned prefix skip that prefix's prefill. With an
attention-only stack, windows run *compact*: at the active row count
padded up to a power of two, pad rows carrying an all-trash page table
and t=0.

The engine runs on the card unless the caller asks for the CPU
(``device="cpu"``); without a CUDA device the default raises.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from concurrent import futures as cf
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import telemetry
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serve import decode as serve_lib

_CHUNKABLE_KINDS = {"attn", "swa", "local"}


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: a CUDA device must exist when
    one is asked for (the default); there is no silent CPU fallback."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: the port runs on the GPU by "
                "default; pass device='cpu' to run on the CPU")
        if device.index is None:      # pin it: worker threads set_device
            device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass
class _Request:
    prompt: np.ndarray            # [S] int32, detached copy
    max_new: int
    future: cf.Future
    submitted: float
    # Trace attribution, captured on the submitting thread.
    ctx: Optional[telemetry.TraceContext] = None
    wall: float = 0.0             # submit wall-clock (TTFT / span anchors)


@dataclasses.dataclass
class _Slot:
    request: _Request
    t: int                        # absolute position of the next token fed
    generated: list


@dataclasses.dataclass
class _PendingPrefill:
    """A chunked prefill in flight: the request holds its reserved slot
    while its prompt streams through ``prefill_extend`` one chunk per
    engine step, against its own B=1 state."""
    request: _Request
    slot: int
    state: Any                    # B=1 decode state (chunk-extended)
    consumed: int                 # prompt tokens already prefilled
    start_page: int = 0           # leading shared prefix pages (paged mode)


class ServeEngine:
    """Continuous-batching serve engine.

    ``submit()`` is thread-safe and returns a ``concurrent.futures.Future``
    resolving to the full sequence (prompt + generated tokens, int32).
    Drive it with ``start()`` (daemon decode loop) or by calling
    ``step()`` from one thread (deterministic; tests and benchmarks).
    ``params`` must already live on ``device``.
    """

    def __init__(self, cfg: ModelConfig, params, *, num_slots: int = 8,
                 context_len: int = 64, max_new: int = 16,
                 eos_id: Optional[int] = None, temperature: float = 0.0,
                 seed: int = 0, sync_every: int = 8,
                 top_k: Optional[int] = None, decode_impl: str = "auto",
                 prefill_chunk: Optional[int] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prefix_cache: bool = True, device="cuda"):
        self._dev = resolve_device(device)
        transformer.check_supported(cfg)
        if not cfg.decode_supported:
            raise ValueError(f"{cfg.name} has no autoregressive decode step")
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        if decode_impl not in ("auto", "dense", "flash"):
            raise ValueError(f"decode_impl must be auto|dense|flash, "
                             f"got {decode_impl!r}")
        if page_size is not None and page_size < 1:
            raise ValueError("page_size must be >= 1")
        pdev = transformer.params_device(params)
        if pdev.type != self._dev.type:
            raise ValueError(f"params live on {pdev}, the engine runs on "
                             f"{self._dev}")
        self._cfg = cfg
        self._params = params
        self._ns = num_slots
        self._L = context_len
        self._max_new = max_new
        self._eos = eos_id
        self._impl = decode_impl
        self._sync = sync_every
        self._gen = (torch.Generator(device=self._dev).manual_seed(seed)
                     if temperature else None)

        kinds = set(cfg.pattern) | set(cfg.remainder)
        # Paged pool geometry: the ring modulus is context_len rounded UP
        # to whole pages (L_pad); submit() still rejects prompt+max_new >
        # context_len, so positions never wrap.
        self._paged = page_size is not None
        if self._paged:
            self._ps = int(page_size)
            self._n_log = -(-context_len // self._ps)
            self._Lp = self._n_log * self._ps
            self._has_paged = "attn" in kinds
            self._P = (int(num_pages) if num_pages is not None
                       else num_slots * self._n_log)
        else:
            self._ps = 0
            self._Lp = context_len
            self._has_paged = False
        # Compact windows: with every cache leaf behind the page table the
        # window's batch width is a free choice, so windows run at the
        # active row count (padded up to a power of two).
        self._compact = self._has_paged and kinds == {"attn"}
        self._chunk = prefill_chunk
        self._can_chunk = (prefill_chunk is not None
                           and kinds <= _CHUNKABLE_KINDS
                           and not cfg.conv_pos)
        if prefill_chunk is not None:
            ring = min((min(self._Lp, cfg.window or self._Lp)
                        if k in ("swa", "local") else self._Lp)
                       for k in kinds)
            if not 1 <= prefill_chunk <= ring:
                raise ValueError(
                    f"prefill_chunk ({prefill_chunk}) must be in [1, "
                    f"{ring}] (the smallest cache ring) — a larger chunk "
                    "would overwrite slots its own queries still attend to")

        if self._has_paged:
            # Physical pool is P usable pages + the trash page (id 0).
            self._state = self._init_state(num_slots)
            # Host-resident page table: mutated on every admission and
            # retirement, uploaded once per window.
            self._pages_tab = np.zeros((num_slots, self._n_log), np.int32)
            self._free_pages: list[int] = list(range(self._P, 0, -1))
            self._page_rc: list[int] = [0] * (self._P + 1)
            self._row_pages: list[Optional[list[int]]] = [None] * num_slots
            self._ppr_ewma = 0.0            # pages per admitted request
            prefix_ok = (prefix_cache and cfg.causal and not cfg.conv_pos
                         and kinds <= {"attn"})
            if prefix_ok:
                from repro_torch.serve.paging import PrefixCache
                self._prefix: Optional[PrefixCache] = PrefixCache(self._ps)
            else:
                self._prefix = None
        else:
            self._state = self._init_state(num_slots)
            self._pages_tab = None
            self._prefix = None
        self._slots: list[Optional[_Slot]] = [None] * num_slots
        self._free: list[int] = list(range(num_slots - 1, -1, -1))
        # Device-resident feed tokens and per-row positions.
        self._tokens_dev = torch.zeros((num_slots, 1), dtype=torch.int32,
                                       device=self._dev)
        self._t_dev = torch.zeros((num_slots,), dtype=torch.int32,
                                  device=self._dev)

        self._fused_steps: dict[int, Any] = {}
        self._temp, self._top_k = temperature, top_k
        self._sampler = serve_lib.make_sampler(temperature, top_k)

        self._queue: queue.Queue[_Request] = queue.Queue()
        self._ready: collections.deque[_Request] = collections.deque()
        self._pending: Optional[_PendingPrefill] = None
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._lock = threading.Lock()                       # stats + lifecycle
        self._counters = dict(submitted=0, admitted=0, retired=0, failed=0,
                              steps=0, decode_tokens=0, generated_tokens=0,
                              occupancy_sum=0, peak_occupancy=0,
                              host_syncs=0, prefix_tokens_reused=0,
                              param_swaps=0)
        self._pending_swap: Optional[tuple[Any, threading.Event]] = None
        self._node = telemetry.node_name()
        # EWMA decode-step microseconds per token (the load report).
        self._ewma_us_tok = 0.0

    # -- device helpers --------------------------------------------------------
    def _init_state(self, batch: int) -> dict:
        if self._has_paged:
            return transformer.init_decode_state(
                self._cfg, batch, self._Lp, page_size=self._ps,
                num_pages=self._P + 1, device=self._dev)
        return transformer.init_decode_state(self._cfg, batch, self._Lp,
                                             device=self._dev)

    def _fused(self, k: int):
        fn = self._fused_steps.get(k)
        if fn is None:
            fn = serve_lib.make_fused_serve_step(
                self._cfg, k, self._temp, self._top_k, self._impl)
            self._fused_steps[k] = fn
        return fn

    def _tensor(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), device=self._dev)

    def _prefill(self, prompt: np.ndarray):
        logits, state = transformer.prefill(
            self._cfg, self._params, tokens=self._tensor(prompt[None]),
            context_len=self._Lp)
        return self._sampler(logits[:, -1:], self._gen), state

    def _extend(self, state, tokens: np.ndarray, t0: int):
        return transformer.prefill_extend(self._cfg, self._params, state,
                                          self._tensor(tokens), t0)

    def _write_paged(self, slot_state, i: int, arr: np.ndarray,
                     start_page: int) -> None:
        transformer.write_paged_slot(self._cfg, self._state, slot_state, i,
                                     self._tensor(arr), start_page, self._ps)

    def _gather(self, i: int, arr: np.ndarray):
        return transformer.gather_paged_slot(self._cfg, self._state, i,
                                             self._tensor(arr), self._ps)

    # -- client side ---------------------------------------------------------
    def submit(self, prompt, max_new: Optional[int] = None) -> cf.Future:
        """Enqueue one request; resolves to [S + n_generated] int32.

        The prompt is copied. A request that cannot fit the slot ring
        fails its own future here, with no effect on its neighbours.
        """
        fut: cf.Future = cf.Future()
        prompt = np.asarray(prompt, np.int32).reshape(-1).copy()
        mn = self._max_new if max_new is None else int(max_new)
        if prompt.size == 0:
            fut.set_exception(ValueError("empty prompt"))
            return fut
        if prompt.size + mn > self._L:
            fut.set_exception(ValueError(
                f"prompt ({prompt.size}) + max_new ({mn}) exceeds the "
                f"engine's context_len ({self._L})"))
            return fut
        if self._has_paged and self._page_need(prompt.size, mn) > self._P:
            fut.set_exception(ValueError(
                f"request needs {self._page_need(prompt.size, mn)} KV "
                f"pages; the pool only has {self._P}"))
            return fut
        with self._lock:
            if self._closed:
                fut.set_exception(RuntimeError("engine stopped"))
                return fut
            self._counters["submitted"] += 1
            ctx = telemetry.current_context()
            self._queue.put(_Request(
                prompt, mn, fut, time.monotonic(),
                ctx=ctx if ctx is not None and ctx.sampled else None,
                wall=time.time()))
        self._wake.set()
        return fut

    def swap_params(self, params, block: bool = True,
                    timeout_s: float = 60.0) -> None:
        """Hot-swap the model weights between decode windows. With
        ``block=True`` (and a running engine thread) waits until applied."""
        done = threading.Event()
        with self._lock:
            if self._closed:
                raise RuntimeError("engine stopped")
            prev = self._pending_swap
            self._pending_swap = (params, done)
        if prev is not None:
            prev[1].set()       # superseded before it was applied
        self._wake.set()
        if block and self._thread is not None:
            if not done.wait(timeout_s):
                raise TimeoutError("param swap not applied within "
                                   f"{timeout_s}s")

    def _apply_pending_swap(self) -> None:
        with self._lock:
            swap, self._pending_swap = self._pending_swap, None
        if swap is None:
            return
        params, done = swap
        self._params = params
        with self._lock:
            self._counters["param_swaps"] += 1
        done.set()

    # -- page accounting (paged mode, engine thread only) --------------------
    def _page_need(self, prompt_len: int, max_new: int) -> int:
        total = min(prompt_len + max_new, self._Lp)
        return -(-total // self._ps)

    def _incref(self, pid: int) -> None:
        self._page_rc[pid] += 1

    def _decref(self, pid: int) -> None:
        self._page_rc[pid] -= 1
        if self._page_rc[pid] == 0:
            self._free_pages.append(pid)

    def _alloc_pages(self, n: int) -> Optional[list[int]]:
        """Take ``n`` pages off the free list (refcount 1 each), evicting
        prefix-cache entries LRU-first under pressure. None = the pool
        cannot satisfy ``n`` right now (admission blocks FCFS)."""
        while len(self._free_pages) < n:
            if self._prefix is None or not self._prefix.evict_one(self._decref):
                return None
        out = [self._free_pages.pop() for _ in range(n)]
        for pid in out:
            self._page_rc[pid] = 1
        return out

    def _release_pages(self, pages: Optional[list[int]]) -> None:
        if pages:
            for pid in pages:
                self._decref(pid)

    def _pages_arr(self, row_pages: list[int]) -> np.ndarray:
        """Row page list padded to the full logical length with trash-page
        entries (speculative writes past the reservation land there)."""
        pad = [0] * (self._n_log - len(row_pages))
        return np.asarray(row_pages + pad, np.int32)

    def _register_prefix(self, prompt: np.ndarray,
                         row_pages: list[int]) -> None:
        if self._prefix is not None:
            self._prefix.insert(prompt, row_pages, self._incref,
                                self._decref)

    def _window_width(self, n: int) -> int:
        """Compact-window batch width for ``n`` active rows: the smallest
        power of two >= n, capped at ``num_slots``."""
        w = 1
        while w < n and w < self._ns:
            w *= 2
        return min(w, self._ns)

    # -- engine side ---------------------------------------------------------
    def _activate(self, req: _Request, i: int, first: int,
                  path: str = "direct") -> None:
        """Mark slot ``i`` live: host bookkeeping plus the device-resident
        feed-token/position rows (compact engines rebuild those per window
        from host state instead). Records time-to-first-token by prefill
        path."""
        self._slots[i] = _Slot(request=req, t=len(req.prompt),
                               generated=[first])
        if req.wall:
            telemetry.metrics().histogram(
                f"engine.ttft_us.{path}").record(
                    (time.time() - req.wall) * 1e6)
        if not self._compact:
            self._tokens_dev[i, 0] = first
            self._t_dev[i] = len(req.prompt)
        with self._lock:
            self._counters["admitted"] += 1
            self._counters["host_syncs"] += 1   # the first-token pull
        if (self._eos is not None and first == self._eos) \
                or req.max_new <= 1:
            self._retire(i)

    def _admit(self) -> None:
        """Move queued requests into free slots: exact-length prefill (or
        a prefix-cache hit's suffix extend), then write the fresh state
        into the slot's row. Long prompts with ``prefill_chunk`` park as a
        _PendingPrefill; admission order stays strict FCFS. Paged mode
        reserves the row's whole page budget here."""
        while True:
            try:
                self._ready.append(self._queue.get_nowait())
            except queue.Empty:
                break
        while self._free and self._ready:
            req = self._ready[0]
            chunked = self._can_chunk and len(req.prompt) > self._chunk
            if chunked and self._pending is not None:
                return                          # FCFS: wait for the pending
            shared: list[int] = []
            row_pages: Optional[list[int]] = None
            if self._has_paged:
                n_need = self._page_need(len(req.prompt), req.max_new)
                if self._prefix is not None:
                    shared = self._prefix.lookup(req.prompt)
                owned = self._alloc_pages(n_need - len(shared))
                if owned is None:
                    return      # pool exhausted: FCFS-block at the head
                for pid in shared:
                    self._incref(pid)
                row_pages = shared + owned
            self._ready.popleft()
            if not req.future.set_running_or_notify_cancel():
                self._release_pages(row_pages)
                continue                                    # cancelled
            i = self._free.pop()
            if req.ctx is not None:
                telemetry.record_span("admission", req.ctx, req.wall,
                                      time.time() - req.wall,
                                      node=self._node, slot=i)
            c = len(shared)
            if self._has_paged:
                self._row_pages[i] = row_pages
                self._ppr_ewma = (float(len(row_pages))
                                  if self._ppr_ewma == 0.0 else
                                  0.2 * len(row_pages) + 0.8 * self._ppr_ewma)
                if c:
                    with self._lock:
                        self._counters["prefix_tokens_reused"] += c * self._ps
            if chunked:
                if c:
                    state = self._gather(i, self._pages_arr(row_pages))
                else:
                    state = transformer.init_decode_state(
                        self._cfg, 1, self._Lp, device=self._dev)
                self._pending = _PendingPrefill(
                    request=req, slot=i, state=state,
                    consumed=c * self._ps, start_page=c)
                continue
            try:
                t0w, t0 = time.time(), time.perf_counter()
                if c:
                    flat = self._gather(i, self._pages_arr(row_pages))
                    logits, slot_state = self._extend(
                        flat, req.prompt[None, c * self._ps:], c * self._ps)
                    nxt = self._sampler(logits, self._gen)
                else:
                    nxt, slot_state = self._prefill(req.prompt)
                if self._has_paged:
                    arr = self._pages_arr(row_pages)
                    self._write_paged(slot_state, i, arr, c)
                    self._pages_tab[i] = arr
                    self._register_prefix(req.prompt, row_pages)
                else:
                    transformer.write_decode_slot(self._cfg, self._state,
                                                  slot_state, i)
                first = int(nxt[0, 0])
                if req.ctx is not None:
                    telemetry.record_span(
                        "prefill", req.ctx, t0w,
                        time.perf_counter() - t0, node=self._node,
                        path="direct",
                        tokens=len(req.prompt) - c * self._ps)
            except Exception as exc:                        # noqa: BLE001
                # Per-request failure delivery: the slot goes straight back
                # and the step proceeds for everyone else.
                self._free.append(i)
                if self._has_paged:
                    self._release_pages(self._row_pages[i])
                    self._row_pages[i] = None
                    self._pages_tab[i] = 0
                with self._lock:
                    self._counters["failed"] += 1
                req.future.set_exception(exc)
                continue
            self._activate(req, i, first, path="direct")

    def _advance_chunk(self) -> bool:
        """Run ONE prefill chunk of the pending request (if any). The final
        chunk's logits seed the first generated token, and only then does
        the B=1 state land in the reserved row. Returns True if a chunk
        ran."""
        p = self._pending
        if p is None:
            return False
        prompt = p.request.prompt
        c0 = p.consumed
        c1 = min(c0 + self._chunk, len(prompt))
        t0w, t0 = time.time(), time.perf_counter()
        try:
            logits, p.state = self._extend(p.state, prompt[None, c0:c1], c0)
            p.consumed = c1
            if p.request.ctx is not None:
                telemetry.record_span("prefill", p.request.ctx, t0w,
                                      time.perf_counter() - t0,
                                      node=self._node, path="chunked",
                                      tokens=c1 - c0)
            if c1 < len(prompt):
                return True
            nxt = self._sampler(logits, self._gen)
            first = int(nxt[0, 0])
            if self._has_paged:
                rp = self._row_pages[p.slot]
                arr = self._pages_arr(rp)
                self._write_paged(p.state, p.slot, arr, p.start_page)
                self._pages_tab[p.slot] = arr
                self._register_prefix(p.request.prompt, rp)
            else:
                transformer.write_decode_slot(self._cfg, self._state,
                                              p.state, p.slot)
        except Exception as exc:                            # noqa: BLE001
            self._free.append(p.slot)
            if self._has_paged:
                self._release_pages(self._row_pages[p.slot])
                self._row_pages[p.slot] = None
                self._pages_tab[p.slot] = 0
            self._pending = None
            with self._lock:
                self._counters["failed"] += 1
            p.request.future.set_exception(exc)
            return True
        self._pending = None
        self._activate(p.request, p.slot, first, path="chunked")
        return True

    def _pick_k(self) -> int:
        """Window length from the power-of-two ladder up to sync_every,
        maximizing useful tokens per unit cost: a window costs ~K steps
        plus ~one step of sync overhead, and a row only uses min(K, its
        remaining budget) of it."""
        rems = [s.request.max_new - len(s.generated)
                for s in self._slots if s is not None]
        k_eff, best, k = 1, -1.0, 1
        while k <= self._sync:
            score = sum(min(k, r) for r in rems) / (k + 1)
            if score > best:
                best, k_eff = score, k
            k = min(k * 2, self._sync) if k < self._sync else k * 2
        return k_eff

    def step(self) -> int:
        """One engine iteration: advance a pending chunked prefill (up to
        one chunk per decode step of the window), admit arrivals, then
        decode every occupied slot one fused window. Returns the number
        of slots that decoded (0 = idle). Single driver thread only."""
        self._apply_pending_swap()      # between windows, before admission
        progressed = False
        for _ in range(self._sync):
            progressed |= self._advance_chunk()
            self._admit()
            if self._pending is None:
                break
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not active:
            return 1 if progressed else 0
        k_eff = self._pick_k()
        t0w = time.time()
        t0 = time.perf_counter()
        row_of = None
        if self._compact:
            # Pad rows carry an all-trash page table and t=0 (all-invalid
            # attention -> zeros); their writes land in the trash page.
            W = self._window_width(len(active))
            toks_w = np.zeros((W, 1), np.int32)
            t_w = np.zeros((W,), np.int32)
            pages_w = np.zeros((W, self._n_log), np.int32)
            for w, i in enumerate(active):
                s = self._slots[i]
                toks_w[w, 0] = s.generated[-1]
                t_w[w] = s.t
                pages_w[w] = self._pages_tab[i]
            toks, self._state, _, _, _ = self._fused(k_eff)(
                self._params, self._state, self._tensor(toks_w),
                self._tensor(t_w), self._gen, self._tensor(pages_w))
            row_of = {i: w for w, i in enumerate(active)}
        elif self._has_paged:
            toks, self._state, self._tokens_dev, self._t_dev, _ = \
                self._fused(k_eff)(self._params, self._state,
                                   self._tokens_dev, self._t_dev, self._gen,
                                   self._tensor(self._pages_tab))
        else:
            toks, self._state, self._tokens_dev, self._t_dev, _ = \
                self._fused(k_eff)(self._params, self._state,
                                   self._tokens_dev, self._t_dev, self._gen)
        toks = toks.cpu().numpy()          # ONE host sync per K-token window
        win_dur = time.perf_counter() - t0
        us_tok = win_dur * 1e6 / (len(active) * k_eff)
        for i in active:
            rq = self._slots[i].request
            if rq.ctx is not None:
                telemetry.record_span("decode", rq.ctx, t0w, win_dur,
                                      node=self._node, k=k_eff,
                                      active=len(active))
        with self._lock:
            c = self._counters
            c["steps"] += k_eff
            c["decode_tokens"] += len(active) * k_eff
            c["occupancy_sum"] += len(active) * k_eff
            c["peak_occupancy"] = max(c["peak_occupancy"], len(active))
            c["host_syncs"] += 1
            self._ewma_us_tok = us_tok if self._ewma_us_tok == 0.0 \
                else 0.2 * us_tok + 0.8 * self._ewma_us_tok
        for i in active:
            slot = self._slots[i]
            # Slice this row's block to its own stop point: tokens past EOS
            # or the max_new budget were speculative and are dropped.
            for j in range(k_eff):
                tok = int(toks[row_of[i] if row_of is not None else i, j])
                slot.generated.append(tok)
                slot.t += 1
                if (self._eos is not None and tok == self._eos) \
                        or len(slot.generated) >= slot.request.max_new:
                    self._retire(i)
                    break
        return len(active)

    def _retire(self, i: int) -> None:
        slot = self._slots[i]
        self._slots[i] = None
        self._free.append(i)
        if self._has_paged and self._row_pages[i] is not None:
            # Release the refs and re-point the row at the trash page: the
            # freed row keeps riding the window until reused, and its
            # speculative writes must not corrupt reallocated pages.
            self._release_pages(self._row_pages[i])
            self._row_pages[i] = None
            self._pages_tab[i] = 0
        out = np.concatenate([slot.request.prompt,
                              np.asarray(slot.generated, np.int32)])
        with self._lock:
            self._counters["retired"] += 1
            self._counters["generated_tokens"] += len(slot.generated)
        slot.request.future.set_result(out)

    # -- lifecycle -----------------------------------------------------------
    def warmup(self) -> "ServeEngine":
        """Run every window this engine can select (the K ladder, and in
        compact mode every width) once against throwaway state, plus a
        chunk-shaped ``prefill_extend``: the kernels build and the
        device's libraries initialise before serving, not mid-request."""
        state = self._init_state(self._ns)
        widths = [self._ns]
        if self._compact:
            widths = []
            w = 1
            while w < self._ns:
                widths.append(w)
                w *= 2
            widths.append(self._ns)
        gen = None
        if self._gen is not None:
            gen = torch.Generator(device=self._dev).manual_seed(0)
        for width in widths:
            pages = (torch.zeros((width, self._n_log), dtype=torch.int32,
                                 device=self._dev)
                     if self._has_paged else None)
            k = 1
            while k <= self._sync:
                toks = torch.zeros((width, 1), dtype=torch.int32,
                                   device=self._dev)
                t = torch.zeros((width,), dtype=torch.int32, device=self._dev)
                self._fused(k)(self._params, state, toks, t, gen, pages)
                k = min(k * 2, self._sync) if k < self._sync else k * 2
        if self._can_chunk:
            st1 = transformer.init_decode_state(self._cfg, 1, self._Lp,
                                                device=self._dev)
            self._extend(st1, np.zeros((1, self._chunk), np.int32), 0)
        if self._dev.type == "cuda":
            torch.cuda.synchronize(self._dev)
        return self

    def start(self) -> "ServeEngine":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="serve-engine")
            self._thread.start()
        return self

    def _loop(self) -> None:
        try:
            if self._dev.type == "cuda":
                torch.cuda.set_device(self._dev)
            while not self._stop.is_set():
                if self.step() == 0:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
        except BaseException as exc:
            # A dead decode loop must not leave callers waiting out their
            # timeouts: close the engine and fail everything it holds.
            with self._lock:
                self._closed = True
            self._fail_outstanding(
                RuntimeError(f"engine loop died: {exc!r}"))
            raise

    def stop(self) -> None:
        """Stop the loop and fail anything still queued or in flight."""
        with self._lock:
            self._closed = True
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        with self._lock:
            swap, self._pending_swap = self._pending_swap, None
        if swap is not None:
            swap[1].set()       # unblock a swap_params caller mid-stop
        self._fail_outstanding(RuntimeError("engine stopped"))

    def _fail_outstanding(self, err: Exception) -> None:
        """Fail every queued, pending and in-flight request with ``err``
        and release their slots and pages."""
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(err)
        while self._ready:
            req = self._ready.popleft()
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(err)
        if self._pending is not None:
            p, self._pending = self._pending, None
            self._free.append(p.slot)
            if self._has_paged:
                self._release_pages(self._row_pages[p.slot])
                self._row_pages[p.slot] = None
            p.request.future.set_exception(err)
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._slots[i] = None
                self._free.append(i)
                if self._has_paged:
                    self._release_pages(self._row_pages[i])
                    self._row_pages[i] = None
                slot.request.future.set_exception(err)
        if self._prefix is not None:
            self._prefix.clear(self._decref)

    def __enter__(self) -> "ServeEngine":
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.stop()

    # -- introspection -------------------------------------------------------
    @property
    def alive(self) -> bool:
        """False once the engine has been stopped."""
        with self._lock:
            return not self._closed

    @property
    def device(self) -> torch.device:
        return self._dev

    @property
    def num_slots(self) -> int:
        return self._ns

    @property
    def context_len(self) -> int:
        return self._L

    def reset_stats(self) -> None:
        with self._lock:
            for k in self._counters:
                self._counters[k] = 0

    def stats(self) -> dict:
        """Counters + derived occupancy; safe from any thread."""
        with self._lock:
            s = dict(self._counters)
            s["ewma_us_per_token"] = self._ewma_us_tok
        s["num_slots"] = self._ns
        s["free_slots"] = len(self._free)
        s["queue_depth"] = self._queue.qsize() + len(self._ready)
        s["mean_occupancy"] = (s["occupancy_sum"] / s["steps"]
                               if s["steps"] else 0.0)
        s["syncs_per_token"] = (s["host_syncs"] / s["generated_tokens"]
                                if s["generated_tokens"] else 0.0)
        if self._has_paged:
            s["pages_total"] = self._P
            s["pages_free"] = len(self._free_pages)
            s["pages_in_use"] = self._P - len(self._free_pages)
            s["pages_per_request_ewma"] = self._ppr_ewma
            if self._prefix is not None:
                s["prefix_cache"] = self._prefix.stats()
        return s

    def load(self) -> dict:
        """Cheap load report: free KV slots, queued requests, EWMA decode
        us/token and, in paged mode, free pages. Safe from any thread."""
        with self._lock:
            ewma = self._ewma_us_tok
            free = len(self._free)
        out = {"num_slots": self._ns, "free_slots": free,
               "queue_depth": self._queue.qsize() + len(self._ready),
               "ewma_us_per_token": ewma}
        if self._has_paged:
            out["pages_total"] = self._P
            out["free_pages"] = len(self._free_pages)
            out["pages_per_request_ewma"] = self._ppr_ewma
            out["prefix_hit_rate"] = (self._prefix.stats()["hit_rate"]
                                      if self._prefix is not None else 0.0)
        return out
