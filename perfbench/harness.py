"""The run of one cell: check for the card, run the cell's program, read
its metrics, judge what it produced, print the result.

``run_cell`` is the run without the look for a card, so that the tests
can drive a whole run on the CPU at a tiny size."""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

from perfbench import judge, spec

JAX_NAMES = ("jax", "jaxlib", "flax", "repro")


def jax_modules(modules) -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``repro_torch`` is none of them)."""
    return sorted(m for m in modules if m.split(".", 1)[0] in JAX_NAMES)


def _runner(cell):
    kind = cell.traffic["kind"]
    if kind == "serve":
        from perfbench import serving
        return serving, judge.serve_numbers
    if kind == "train":
        from perfbench import training
        return training, judge.train_numbers
    raise ValueError(f"unknown kind of cell {kind!r}")


def _metrics(bundle, entries: list) -> dict:
    out = {}
    for m in entries:
        value = spec.reader(m["name"])(bundle)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _counts(bundle) -> tuple[int, int]:
    if bundle.steps:
        return len(bundle.steps) - 1, 0
    judged = bundle.ended_in_window()
    return len(judged), sum(1 for r in judged if not r["ok"])


def _load_readings(bundle) -> dict:
    """What the window did, beside its metrics: the engine's decode steps
    a second and rows a step (counter deltas), and the load's retries of
    Overloaded replies; for training, the steps in the window."""
    if bundle.steps:
        return {"_window_steps": len(bundle.steps) - 1}
    s0, s1 = bundle.stats0, bundle.stats1
    steps = s1["steps"] - s0["steps"]
    return {"_steps_per_s": steps / (bundle.t1 - bundle.t0),
            "_rows_per_step": ((s1["occupancy_sum"] - s0["occupancy_sum"])
                               / steps if steps else 0.0),
            "_admitted": s1["admitted"] - s0["admitted"],
            "_retries": sum(r["retries"] for r in bundle.requests)}


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=None, control: bool = False) -> dict:
    """One run: the result line's object, with ``check`` last."""
    import torch

    from perfbench import profiling

    log = log or (lambda msg: None)
    runner, numbers_fn = _runner(cell)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    bundle, aux = runner.run(cell, seed, seconds, trace, device, t_start)
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    metrics = _metrics(bundle, cell.per_layer if trace else cell.end_to_end)
    log(f"window: {bundle.t1 - bundle.t0:.3f}s, setup {bundle.setup_s:.3f}s")
    t_check = time.perf_counter()
    numbers = numbers_fn(bundle, aux, cell, seed, device, control=control)
    del aux
    log(f"check took {time.perf_counter() - t_check:.1f}s; readings "
        + ", ".join(f"{k}={v:.6g}" for k, v in numbers.items()
                    if k not in cell.limits))
    correct, check = judge.verdict(cell, numbers)
    attempted, failed = _counts(bundle)
    dev = {"platform": "gpu" if cuda else torch.device(device).type,
           "kind": (torch.cuda.get_device_name(device) if cuda
                    else torch.device(device).type),
           "count": int(cell.chips), "memory_peak_bytes": peak}
    out = {"correct": bool(correct and failed == 0),
           "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        if bundle.trace is None:
            raise RuntimeError("the traced run recorded no device trace")
        busy, window, breakdown = profiling.summary(bundle.trace,
                                                    bundle.host_spans)
        dev["busy_s"], dev["window_s"] = busy, window
        out["breakdown"] = breakdown
    out["readings"] = {**_load_readings(bundle),
                       **{k: v for k, v in numbers.items()
                          if k not in check}}
    out["check"] = check
    return out


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unread ({exc!r})"


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def log(msg: str) -> None:
        print(f"perfbench: {msg}", file=sys.stderr, flush=True)

    import torch
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} cards; "
            f"{torch.cuda.device_count()} are visible")
        return 2
    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    log(f"card: {_power_limit()}; shares are of the published peaks "
        "(989 TFLOP/s bf16, 3.35 TB/s) at 700 W")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, t_start, log)
    found = jax_modules(sys.modules)
    if found:
        log(f"JAX is loaded in the benchmark's process: {found}")
        return 3
    for name, c in result["check"].items():
        print(f"check: {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
