"""Reverb-lite: the replay/data service behind ReverbNode (paper §4.2).

The paper's ReverbNode exposes a Reverb (Cassirer et al., 2021) dataset —
"particularly useful in reinforcement learning settings where the dataset
can itself be filled in an online fashion". We build the substrate
ourselves: tables with bounded size, FIFO/uniform/priority sampling, and a
rate limiter enforcing a samples-per-insert ratio so learners and actors
stay in lockstep (the SPI contract is Reverb's core flow-control idea).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional

import numpy as np


class WriterStalled(RuntimeError):
    """An insert blocked past its deadline because no sampler is draining
    the table (SPI budget exhausted — typically the learner died).

    Typed so actors can tell "my writer is stalled, re-resolve the replay
    service and fail over" from a real error. Raised by ``insert(...,
    raise_on_stall=True)``; the plain bool-returning path is unchanged.
    """

    def __init__(self, table: str, waited_s: float, stats: dict):
        super().__init__(
            f"insert into {table!r} stalled for {waited_s:.2f}s "
            f"(no sampler draining; table stats: {stats})")
        self.table = table
        self.waited_s = waited_s
        self.stats = stats


def is_writer_stalled(exc: BaseException) -> bool:
    """True if ``exc`` is (or wraps) a ``WriterStalled`` — cross-transport:
    inproc couriers chain the original via ``__cause__``, gRPC/shm wrap it
    in a RemoteError whose message carries the remote traceback text."""
    seen: set[int] = set()
    cur: Optional[BaseException] = exc
    while cur is not None and id(cur) not in seen:
        if isinstance(cur, WriterStalled):
            return True
        if type(cur).__name__ == "RemoteError" and "WriterStalled" in str(cur):
            return True
        seen.add(id(cur))
        cur = cur.__cause__
    return False


@dataclasses.dataclass(frozen=True)
class TableConfig:
    name: str
    max_size: int = 10_000
    sampler: str = "uniform"             # uniform | fifo | prioritized
    # Rate limiting (samples-per-insert): learner may not sample more than
    # spi * inserts, nor lag more than min_size_to_sample behind.
    min_size_to_sample: int = 1
    samples_per_insert: Optional[float] = None
    spi_tolerance: float = 2.0


class _Table:
    def __init__(self, cfg: TableConfig):
        self.cfg = cfg
        self._items: list[Any] = []
        self._priorities: list[float] = []
        self._inserts = 0
        self._samples = 0
        self._lock = threading.Lock()
        self._can_sample = threading.Condition(self._lock)
        self._can_insert = threading.Condition(self._lock)
        self._rng = np.random.default_rng(0)
        self._closed = False

    # -- rate limiter --------------------------------------------------------
    def _sample_allowed(self, n: int) -> bool:
        if len(self._items) < self.cfg.min_size_to_sample:
            return False
        spi = self.cfg.samples_per_insert
        if spi is None:
            return True
        budget = spi * self._inserts + self.cfg.spi_tolerance * spi
        return (self._samples + n) <= budget

    def _insert_allowed(self) -> bool:
        spi = self.cfg.samples_per_insert
        if spi is None:
            return True
        # Don't run unboundedly ahead of the learner.
        max_ahead = (self._samples / spi) + self.cfg.spi_tolerance
        return self._inserts <= max_ahead + self.cfg.min_size_to_sample

    # -- ops -------------------------------------------------------------------
    def insert(self, item: Any, priority: float = 1.0,
               timeout: Optional[float] = None,
               raise_on_stall: bool = False) -> bool:
        with self._lock:
            if not self._can_insert.wait_for(
                    lambda: self._insert_allowed() or self._closed, timeout):
                if raise_on_stall:
                    raise WriterStalled(
                        self.cfg.name, float(timeout or 0.0),
                        {"size": len(self._items), "inserts": self._inserts,
                         "samples": self._samples})
                return False
            if self._closed:
                return False
            self._items.append(item)
            self._priorities.append(float(priority))
            if len(self._items) > self.cfg.max_size:
                self._items.pop(0)
                self._priorities.pop(0)
            self._inserts += 1
            self._can_sample.notify_all()
            return True

    def sample(self, n: int, timeout: Optional[float] = None) -> Optional[list]:
        with self._lock:
            if not self._can_sample.wait_for(
                    lambda: self._sample_allowed(n) or self._closed, timeout):
                return None
            if self._closed and not self._items:
                return None
            size = len(self._items)
            if self.cfg.sampler == "fifo":
                take = min(n, size)
                out = self._items[:take]
                del self._items[:take], self._priorities[:take]
            elif self.cfg.sampler == "prioritized":
                pr = np.asarray(self._priorities)
                pr = pr / pr.sum()
                idx = self._rng.choice(size, size=n, p=pr)
                out = [self._items[i] for i in idx]
            else:  # uniform with replacement
                idx = self._rng.integers(0, size, size=n)
                out = [self._items[i] for i in idx]
            self._samples += n
            self._can_insert.notify_all()
            return out

    def size(self) -> int:
        with self._lock:
            return len(self._items)

    def stats(self) -> dict:
        with self._lock:
            return {"size": len(self._items), "inserts": self._inserts,
                    "samples": self._samples}

    def close(self):
        with self._lock:
            self._closed = True
            self._can_sample.notify_all()
            self._can_insert.notify_all()


class ReplayServer:
    """Multi-table replay service; the object a ReverbNode serves."""

    def __init__(self, tables: list[TableConfig]):
        self._tables = {t.name: _Table(t) for t in tables}

    def _t(self, table: str) -> _Table:
        return self._tables[table]

    def insert(self, table: str, item, priority: float = 1.0,
               timeout: Optional[float] = 10.0,
               raise_on_stall: bool = False) -> bool:
        return self._t(table).insert(item, priority, timeout,
                                     raise_on_stall=raise_on_stall)

    def sample(self, table: str, n: int,
               timeout: Optional[float] = 10.0):
        return self._t(table).sample(n, timeout)

    def size(self, table: str) -> int:
        return self._t(table).size()

    def stats(self, table: str) -> dict:
        return self._t(table).stats()

    def close(self):
        for t in self._tables.values():
            t.close()
