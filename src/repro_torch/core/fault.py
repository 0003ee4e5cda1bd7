"""Fault-tolerance primitives (paper §6 made concrete).

The paper's position: no exact (lineage) recovery — the scheduler restarts
failed jobs; stateful nodes restore themselves from checkpoints; stateless
nodes restart bare. We implement the scheduler half here (restart policies
used by launchers) plus straggler mitigation for fan-out call patterns
(hedged requests), which matters at 1000-node scale where the slowest
evaluator/actor dictates step time.

``FaultInjector`` is the adversary: a node (or plain object) that fires a
schedule of kill / stall / transport-drop faults against named targets, so
chaos scenarios — replica dies mid-drain, node stalls past its TTL, a
transport blackholes — are written as data, reused identically by tests,
benchmarks, and example programs instead of each growing a bespoke
kill-after loop.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent import futures as cf
from typing import Any, Callable, Iterable, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    """How a launcher reacts to a node's executable failing.

    max_restarts < 0 means restart forever (production default for stateless
    workers); 0 means fail fast. Exponential backoff avoids crash-looping a
    node whose dependency is still coming back.
    """
    max_restarts: int = 3
    backoff_s: float = 0.05
    backoff_multiplier: float = 2.0
    max_backoff_s: float = 5.0

    def backoff_for(self, restart_index: int) -> float:
        return min(self.backoff_s * (self.backoff_multiplier ** restart_index),
                   self.max_backoff_s)

    def allows(self, restarts_so_far: int) -> bool:
        return self.max_restarts < 0 or restarts_so_far < self.max_restarts


NO_RESTART = RestartPolicy(max_restarts=0)
ALWAYS_RESTART = RestartPolicy(max_restarts=-1)


@dataclasses.dataclass
class NodeFailure:
    node_name: str
    error: BaseException
    restarts: int
    fatal: bool


def hedged_map(fns: Sequence[Callable[[], cf.Future]],
               hedge_after_s: Optional[float] = None,
               quorum: Optional[int] = None,
               timeout_s: Optional[float] = None,
               return_exceptions: bool = False) -> list[Any]:
    """Fan out async calls with straggler mitigation.

    Each entry of ``fns`` is a zero-arg callable launching one future (e.g.
    ``lambda: client.futures.evaluate(params)``). Semantics:

      * ``hedge_after_s``: if a future hasn't resolved after this delay, the
        call is *re-issued* and the first result wins (classic hedged
        request / backup request).
      * ``quorum``: return once this many results are in, cancelling the
        rest (partial fan-in — e.g. an ES evolver that only needs the
        fastest 80% of evaluators per generation).
      * ``return_exceptions``: per-call failures become entries in the
        result list instead of raising — graceful degradation for quorum
        aggregation over a fleet where some members may be mid-restart
        (the caller inspects ``isinstance(r, BaseException)``).

    Returns a list aligned with ``fns``; entries that were cancelled by the
    quorum are ``None``.
    """
    n = len(fns)
    results: list[Any] = [None] * n
    done_flags = [False] * n
    done_count = 0
    target = n if quorum is None else min(quorum, n)
    lock = threading.Lock()
    all_done = threading.Event()
    primary = [fn() for fn in fns]
    hedges: list[Optional[cf.Future]] = [None] * n
    first_error: list[Optional[BaseException]] = [None]

    def _record(i: int, fut: cf.Future) -> None:
        nonlocal done_count
        with lock:
            if done_flags[i]:
                return
            try:
                results[i] = fut.result()
            except cf.CancelledError:
                return
            except BaseException as exc:  # noqa: BLE001
                if return_exceptions:
                    results[i] = exc
                elif first_error[0] is None:
                    first_error[0] = exc
            done_flags[i] = True
            done_count += 1
            if done_count >= target:
                all_done.set()

    for i, fut in enumerate(primary):
        fut.add_done_callback(lambda f, i=i: _record(i, f))

    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    if hedge_after_s is not None:
        # Wait for the hedge window, then re-issue whatever is unfinished.
        if not all_done.wait(hedge_after_s):
            for i in range(n):
                with lock:
                    if done_flags[i]:
                        continue
                try:
                    hedge = fns[i]()
                except BaseException as exc:  # noqa: BLE001
                    with lock:
                        if not return_exceptions and first_error[0] is None:
                            first_error[0] = exc
                    continue  # primary is still pending; let it decide
                hedges[i] = hedge
                hedge.add_done_callback(lambda f, i=i: _record(i, f))

    remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
    finished = all_done.wait(remaining)
    if not finished and quorum is None and timeout_s is not None:
        raise TimeoutError(
            f"hedged_map: only {done_count}/{target} calls finished "
            f"within {timeout_s}s")

    for fut_list in (primary, hedges):
        for fut in fut_list:
            if fut is not None and not fut.done():
                fut.cancel()

    if first_error[0] is not None:
        raise first_error[0]
    return results


@dataclasses.dataclass
class FaultEvent:
    """One scheduled fault.

    ``kind`` is duck-typed: it names a method on the target (``kill``,
    ``stall``, ``drop``, ...); stall/drop take ``duration_s``. ``target``
    indexes into the injector's targets list (events stay handle-free so
    they serialize cleanly into a program graph). Exactly one trigger
    should be set:

      * ``after_served`` — fires once the progress sources report this
        many completed requests (count-based, schedule-independent);
      * ``after_s``      — fires this many seconds after the injector
        starts (time-based);
      * ``when``         — fires when this zero-arg predicate first
        returns True (e.g. "a replica is draining in the registry").
        In-process use only — predicates don't serialize.
    """
    kind: str
    target: int = 0
    after_served: Optional[int] = None
    after_s: Optional[float] = None
    when: Optional[Callable[[], bool]] = None
    duration_s: float = 0.0


class FaultInjector:
    """Fires a schedule of faults against named targets.

    Runs as a ``PyNode`` (``run()`` polls until every event has fired or
    the program stops) or driven manually via ``poll()`` from a test.
    ``targets`` are handles/clients/objects exposing the fault methods;
    ``progress`` sources expose ``stats()`` with a ``completed`` counter
    (routers do) and power the ``after_served`` trigger.

    A fault firing is best-effort by design: the target may already be
    dead (that is the point of chaos testing), so per-event errors are
    recorded on the event outcome, never raised.
    """

    def __init__(self, events: Sequence[FaultEvent], targets: Sequence[Any],
                 progress: Sequence[Any] = (), poll_s: float = 0.002):
        self._events = list(events)
        self._targets = list(targets)
        self._progress = list(progress)
        self._poll_s = poll_s
        self._t0: Optional[float] = None
        self.fired: list[dict] = []     # {kind, target, t_s, error}
        self._pending = list(range(len(self._events)))

    def _served(self) -> int:
        total = 0
        for src in self._progress:
            try:
                total += int(src.stats().get("completed", 0))
            except Exception:  # noqa: BLE001 - progress source mid-restart
                pass
        return total

    def _due(self, e: FaultEvent, now: float, served: Optional[int]) -> bool:
        if e.after_served is not None:
            return served is not None and served >= e.after_served
        if e.after_s is not None:
            return now - self._t0 >= e.after_s
        if e.when is not None:
            try:
                return bool(e.when())
            except Exception:  # noqa: BLE001
                return False
        return True  # no trigger: fire on first poll

    def _fire(self, e: FaultEvent) -> None:
        err = None
        try:
            target = self._targets[e.target]
            method = getattr(target, e.kind)
            if e.kind in ("stall", "drop"):
                method(e.duration_s)
            else:
                method()
        except Exception as exc:  # noqa: BLE001 - target may already be dead
            err = repr(exc)
        self.fired.append({"kind": e.kind, "target": e.target,
                           "t_s": time.monotonic() - self._t0, "error": err})
        state = f"failed ({err})" if err else "fired"
        print(f"fault: {e.kind} -> target {e.target} {state}; "
              "traffic continues", flush=True)

    def poll(self) -> int:
        """Fire every due pending event; returns how many remain."""
        if self._t0 is None:
            self._t0 = time.monotonic()
        now = time.monotonic()
        needs_count = any(self._events[i].after_served is not None
                          for i in self._pending)
        served = self._served() if needs_count else None
        still = []
        for i in self._pending:
            if self._due(self._events[i], now, served):
                self._fire(self._events[i])
            else:
                still.append(i)
        self._pending = still
        return len(self._pending)

    def run(self) -> None:
        from repro_torch.core.nodes.base import get_current_context
        ctx = get_current_context()
        self._t0 = time.monotonic()
        while self._pending and not ctx.should_stop:
            if self.poll() == 0:
                return
            ctx.wait_for_stop(self._poll_s)
