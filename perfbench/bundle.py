"""What one run saw, handed to every metric's reader: the window, each
request or step as the load saw it, the program's spans and counters,
and the device trace of a traced run. Times of requests and steps are
``time.perf_counter``; spans and the device trace are on the wall clock
(``time.time``), and ``wall(t)`` moves a perf time there."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class Bundle:
    cell: str
    sizes: dict                  # the architecture's sizes(config)
    config: dict
    traffic: dict
    seconds: float
    setup_s: float
    t0: float                    # the window, perf_counter
    t1: float
    perf_to_wall: float          # wall = perf + perf_to_wall
    requests: list = dataclasses.field(default_factory=list)
    steps: list = dataclasses.field(default_factory=list)
    spans: list = dataclasses.field(default_factory=list)
    stats0: dict = dataclasses.field(default_factory=dict)
    stats1: dict = dataclasses.field(default_factory=dict)
    trace: Optional[Any] = None  # profiling.DeviceTrace, read
    host_spans: list = dataclasses.field(default_factory=list)
    extra: dict = dataclasses.field(default_factory=dict)
    arch: Optional[Any] = None   # the module archs/<name>.py: the counts

    def wall(self, t: float) -> float:
        return t + self.perf_to_wall

    # -- requests ----------------------------------------------------------
    def ended_in_window(self) -> list:
        """Requests whose reply, or failure, came inside the window."""
        return [r for r in self.requests if r["done"] is not None
                and self.t0 <= r["done"] <= self.t1]

    def done_in_window(self) -> list:
        return [r for r in self.requests
                if r["ok"] and self.t0 <= r["done"] <= self.t1]

    # -- spans ---------------------------------------------------------------
    def spans_named(self, name: str) -> list:
        return [s for s in self.spans if s["name"] == name]

    def by_trace(self) -> dict:
        out: dict[str, list] = {}
        for s in self.spans:
            out.setdefault(s["trace"], []).append(s)
        return out

    def decode_windows(self) -> list:
        """The engine's decode windows (one span per active request each),
        once each: dicts with ``ts``, ``dur``, ``k``, ``active``."""
        seen = {}
        for s in self.spans_named("decode"):
            key = (s["node"], s["ts"])
            if key not in seen:
                seen[key] = {"ts": s["ts"], "dur": s["dur"],
                             "k": s["attrs"].get("k", 1),
                             "active": s["attrs"].get("active", 1)}
        return sorted(seen.values(), key=lambda w: w["ts"])

    def window_wall(self) -> tuple[float, float]:
        return self.wall(self.t0), self.wall(self.t1)
