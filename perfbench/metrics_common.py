"""Readings that several metrics share, each metric under its own name."""

from __future__ import annotations

from perfbench import profiling


def decode_step_ms(b):
    """Wall time inside the engine's decode windows that start in the
    window, over their decode steps."""
    w0, w1 = b.window_wall()
    ws = [w for w in b.decode_windows() if w0 <= w["ts"] <= w1]
    steps = sum(w["k"] for w in ws)
    return 1e3 * sum(w["dur"] for w in ws) / steps if steps else None


def device_idle_pct(b):
    """Share of the traced span with nothing running on the card."""
    tr = b.trace
    if tr is None or tr.t1 <= tr.t0:
        return None
    busy = profiling.busy_seconds(tr.kernels, tr.t0, tr.t1)
    return 100.0 * (1.0 - busy / (tr.t1 - tr.t0))
