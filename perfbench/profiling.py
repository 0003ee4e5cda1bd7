"""The device trace of a traced run: ``torch.profiler`` over a span of
the window, read back from its Chrome trace. Everything is put on the
host's wall clock (``time.time``) through one annotation whose host
start is known, so device kernels line up with the program's spans."""

from __future__ import annotations

import json
import os
import threading
import time

MARK = "perfbench.traced_span"

# Kernel names, by family. The port's own kernels are named in
# kernels/csrc/*.cu; cuBLAS and CUTLASS products by their libraries.
DECODE_ATTN = ("decode_kernel",)
PREFILL_ATTN = ("flash_kernel", "flash_tc_kernel")
MATMUL = ("gemm", "nvjet", "xmma", "cutlass", "cublas", "splitkreduce",
          "wgmma")


def family(name: str) -> str:
    low = name.lower()
    if any(k in name for k in DECODE_ATTN):
        return "decode_attn"
    if any(k in name for k in PREFILL_ATTN):
        return "prefill_attn"
    if any(k in low for k in MATMUL):
        return "matmul"
    return "other"


class DeviceTrace:
    """Start, stop, then read: ``kernels`` [(name, t0, t1)] on the wall
    clock, and the traced span [``t0``, ``t1``]."""

    def __init__(self):
        import torch
        self._torch = torch
        self._prof = None
        self._mark = None
        self.t0 = self.t1 = None
        self.kernels: list[tuple[str, float, float]] = []

    def start(self) -> None:
        torch = self._torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._mark = torch.profiler.record_function(MARK)
        self.t0 = time.time()
        self._mark.__enter__()

    def stop(self) -> None:
        torch = self._torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self.t1 = time.time()
        self._prof.__exit__(None, None, None)

    def read(self) -> None:
        """Parse the trace (a temporary file under ``TMPDIR``)."""
        import tempfile
        fd, path = tempfile.mkstemp(prefix="perfbench-trace-",
                                    suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self._prof = None
        mark = [e for e in events if e.get("name") == MARK
                and e.get("cat") in ("user_annotation", "cpu_op")]
        if not mark:
            raise RuntimeError("the device trace lost its annotation")
        base = self.t0 - mark[0]["ts"] * 1e-6
        ks = []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in (
                    "kernel", "gpu_memcpy", "gpu_memset"):
                continue
            a = base + e["ts"] * 1e-6
            ks.append((e.get("name", "?"), a, a + e.get("dur", 0) * 1e-6))
        ks.sort(key=lambda k: k[1])
        self.kernels = ks


def profile_in(plan: dict, t0: float, box: dict) -> threading.Thread:
    """Trace the card for ``plan["profile_s"]`` in the middle of the
    window that starts at ``t0`` (perf time), from a thread of its own;
    the trace lands in ``box["trace"]``."""
    def body():
        time.sleep(max(0.0, t0 + (plan["seconds"] - plan["profile_s"]) / 2
                       - time.perf_counter()))
        trace = DeviceTrace()
        trace.start()
        time.sleep(plan["profile_s"])
        trace.stop()
        box["trace"] = trace
    th = threading.Thread(target=body, daemon=True, name="perfbench-prof")
    th.start()
    return th


def clip(kernels, t0: float, t1: float):
    """Kernels cut to [t0, t1]."""
    return [(n, max(a, t0), min(b, t1)) for n, a, b in kernels
            if b > t0 and a < t1]


def busy_intervals(kernels, t0: float, t1: float) -> list[tuple]:
    """The union of the kernels' intervals inside [t0, t1]."""
    out: list[list[float]] = []
    for _, a, b in clip(kernels, t0, t1):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def busy_seconds(kernels, t0: float, t1: float) -> float:
    return sum(b - a for a, b in busy_intervals(kernels, t0, t1))


def seconds_by(kernels, t0: float, t1: float, pick) -> float:
    """Kernel seconds inside [t0, t1] of the kernels ``pick(name)``
    accepts (overlapping kernels each count)."""
    return sum(b - a for n, a, b in clip(kernels, t0, t1) if pick(n))


def top_ops(kernels, t0: float, t1: float, n: int = 10) -> list:
    tot: dict[str, float] = {}
    for name, a, b in clip(kernels, t0, t1):
        key = name[:120]
        tot[key] = tot.get(key, 0.0) + (b - a)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            ][:n]


def idle_gaps(kernels, t0: float, t1: float, host_spans,
              n: int = 10) -> list:
    """The ``n`` longest stretches with no kernel running, each named by
    the innermost host span open at its middle (``host_spans``:
    [(name, start, end)] on the wall clock)."""
    busy = busy_intervals(kernels, t0, t1)
    gaps, last = [], t0
    for a, b in busy:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if t1 > last:
        gaps.append((last, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:n]:
        mid = 0.5 * (a + b)
        open_ = [(e - s, name) for name, s, e in host_spans if s <= mid <= e]
        out.append([min(open_)[1] if open_ else "no host span", b - a])
    return out


def summary(trace: DeviceTrace, host_spans) -> tuple:
    """(busy_s, window_s, breakdown) of a read trace."""
    t0, t1 = trace.t0, trace.t1
    return (busy_seconds(trace.kernels, t0, t1), t1 - t0,
            {"device_ops": top_ops(trace.kernels, t0, t1),
             "idle_gaps": idle_gaps(trace.kernels, t0, t1, host_spans)})
