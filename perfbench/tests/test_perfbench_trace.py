"""The program's spans on the device trace's clock: the learner's
``train.*`` spans (``repro_torch.train.fabric``) and the profiler's
events both sit on ``time.time()``, joined through the annotation that
``profiling.DeviceTrace`` opens; and ``profiling.idle_gaps`` names a gap
by the innermost span open at its middle, so a program span wins over
the training probe's outer ``grad_fn`` span."""

import dataclasses
import json
import os
import tempfile
import threading
import time

import torch

from perfbench import profiling
from repro_torch.core import telemetry
from repro_torch.core.discovery import Registry
from repro_torch.core.nodes.base import WorkerContext, set_current_context
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.launch.train import LM_TINY, LMTask
from repro_torch.train.fabric import FabricConfig, LearnerWorker
from repro_torch.train.train_step import TrainConfig


def _events(trace: profiling.DeviceTrace) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        trace._prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def test_a_region_inside_a_span_maps_into_its_interval():
    """A ``record_function`` region entered inside a ``telemetry.span``
    lands, through the annotation's base, inside the span's wall-clock
    interval, within a millisecond of when it was entered."""
    trace = profiling.DeviceTrace()
    trace.start()
    time.sleep(0.01)
    with telemetry.activate(telemetry.start_trace()):
        with telemetry.span("train.optimizer"):
            time.sleep(0.005)
            entered = time.time()
            with torch.profiler.record_function("probe.region"):
                torch.ones(64).sum()
                time.sleep(0.005)
            time.sleep(0.005)
    time.sleep(0.01)
    trace.stop()
    spans = telemetry.spans_buffer().drain()
    events = _events(trace)
    (span,) = [s for s in spans if s["name"] == "train.optimizer"]
    mark = [e for e in events if e.get("name") == profiling.MARK
            and e.get("cat") in ("user_annotation", "cpu_op")]
    (region,) = [e for e in events if e.get("name") == "probe.region"]
    base = trace.t0 - mark[0]["ts"] * 1e-6
    a = base + region["ts"] * 1e-6
    e = a + region["dur"] * 1e-6
    assert span["ts"] - 1e-3 <= a < e <= span["ts"] + span["dur"] + 1e-3
    assert abs(a - entered) < 1e-3


def _traced_step_spans(tmp_path) -> list:
    """One traced step of a CPU learner, two microbatches."""
    cfg = dataclasses.replace(LM_TINY, num_layers=1, d_model=32, d_ff=64,
                              vocab_size=128)
    task = LMTask(cfg, TrainConfig(num_microbatches=2), device="cpu")
    batch = next(iter(make_source(DataConfig(seq_len=8, batch_size=2,
                                             vocab_size=128))))
    ctx = WorkerContext(node_name="learner-0")
    box = {}

    def body():
        set_current_context(ctx)
        box["learner"] = learner = LearnerWorker(
            task, lambda: batch, str(tmp_path), Registry(),
            FabricConfig(total_steps=1, trace_every=1, heartbeat_s=0.05),
            device="cpu")
        learner.run()

    telemetry.spans_buffer().drain()
    thread = threading.Thread(target=body, daemon=True)
    thread.start()
    try:
        while not (box.get("learner") and box["learner"].load()["done"]):
            assert thread.is_alive()
            thread.join(0.02)
    finally:
        ctx.stop_event.set()
        thread.join(30)
    return telemetry.spans_buffer().drain()


def test_an_idle_gap_is_named_by_the_innermost_program_span(tmp_path):
    """Kernels everywhere but in the middle third of the first
    ``train.backward`` and of ``train.optimizer``: each gap takes that
    span's name, not the probe's ``grad_fn`` or ``between steps`` span
    around it."""
    spans = _traced_step_spans(tmp_path)
    named = {s["name"]: s for s in reversed(spans)}   # the first of each
    bwd, opt = named["train.backward"], named["train.optimizer"]
    fwd, root = named["train.forward"], named["train.step"]
    host = [("grad_fn (forward, backward)", fwd["ts"],
             bwd["ts"] + bwd["dur"]),
            ("between steps (update, data)", bwd["ts"] + bwd["dur"],
             root["ts"] + root["dur"])]
    host += [(s["name"], s["ts"], s["ts"] + s["dur"]) for s in spans]
    t0, t1 = root["ts"], root["ts"] + root["dur"]

    def middle_third(s):
        return s["ts"] + s["dur"] / 3, s["ts"] + 2 * s["dur"] / 3

    holes = sorted([middle_third(bwd), middle_third(opt)])
    kernels, last = [], t0
    for a, e in holes:
        kernels.append(("k", last, a))
        last = e
    kernels.append(("k", last, t1))
    gaps = profiling.idle_gaps(kernels, t0, t1, host)
    assert sorted(name for name, _ in gaps) == ["train.backward",
                                                "train.optimizer"]
    for name, dur in gaps:
        assert abs(dur - named[name]["dur"] / 3) < 1e-6   # wall-clock ulps
