"""The learner's step spans (``train/fabric.py``, ``train/train_step.py``):
one learner on the CPU, two microbatches. A traced step is one trace
whose root ``train.step`` holds the data wait, the gradients (forward,
backward and accumulation per microbatch, then the loss readback) and
the update (the optimizer); ``trace_every`` picks the steps; tracing
changes no number. Then ``launch.train --trace-every --telemetry-dir``
end to end, and (``gpu``, skipped without a card) the allocator counter.
"""

import dataclasses
import json
import threading

import pytest
import torch

from repro_torch.core import courier, telemetry
from repro_torch.core.discovery import Registry
from repro_torch.core.nodes.base import WorkerContext, set_current_context
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.launch import train as launch_train
from repro_torch.train import fabric, tree
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import TrainConfig

torch.set_num_threads(1)
CFG = dataclasses.replace(launch_train.LM_TINY, num_layers=2, d_model=64,
                          d_ff=128, vocab_size=256)
STEPS = 3


@pytest.fixture(autouse=True)
def _reset_port_inproc_registry():
    courier.inprocess.reset()
    yield
    courier.inprocess.reset()


def _train(store_dir, trace_every: int, device="cpu"):
    """Three steps of one learner on fixed batches: (the spans it
    recorded, its parameters)."""
    task = launch_train.LMTask(CFG, TrainConfig(
        optimizer=OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10),
        num_microbatches=2), device=device)
    batch = next(iter(make_source(DataConfig(
        seq_len=16, batch_size=4, vocab_size=CFG.vocab_size))))
    cfg = fabric.FabricConfig(total_steps=STEPS, batch_size=4,
                              trace_every=trace_every, heartbeat_s=0.05)
    ctx = WorkerContext(node_name="learner-0")
    box = {}

    def body():
        set_current_context(ctx)
        box["learner"] = learner = fabric.LearnerWorker(
            task, lambda: {k: v.copy() for k, v in batch.items()},
            str(store_dir), Registry(), cfg, device=device)
        learner.run()

    telemetry.spans_buffer().drain()
    thread = threading.Thread(target=body, daemon=True)
    thread.start()
    try:
        while not (box.get("learner") and box["learner"].load()["done"]):
            assert thread.is_alive(), "the learner ended before its steps"
            thread.join(0.02)
    finally:
        ctx.stop_event.set()
        thread.join(30)
    spans = telemetry.spans_buffer().drain()
    return spans, box["learner"]._params


def _inside(child, parent, slack=1e-6):
    return (parent["ts"] - slack <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"]
            + slack)


def test_traced_step_is_one_tree_of_spans(tmp_path):
    spans, _ = _train(tmp_path, trace_every=1)
    by_trace = {}
    for s in spans:
        by_trace.setdefault(s["trace"], []).append(s)
    assert len(by_trace) == STEPS
    for trace in by_trace.values():
        roots = [s for s in trace if s["parent"] is None]
        assert [r["name"] for r in roots] == ["train.step"]
        root = roots[0]
        assert "alloc_retries" not in root["attrs"]     # the CPU: no reading
        by_id = {s["id"]: s for s in trace}
        kids = lambda s: sorted(  # noqa: E731
            (c["name"], c["attrs"].get("mb", -1)) for c in trace
            if c["parent"] == s["id"])
        assert kids(root) == [("train.data", -1), ("train.grads", -1),
                              ("train.update", -1)]
        grads = next(s for s in trace if s["name"] == "train.grads")
        assert kids(grads) == [
            ("train.accumulate", 0), ("train.accumulate", 1),
            ("train.backward", 0), ("train.backward", 1),
            ("train.forward", 0), ("train.forward", 1), ("train.sync", -1)]
        update = next(s for s in trace if s["name"] == "train.update")
        assert update["attrs"]["strategy"] in ("dense", "int8_ef")
        assert kids(update) == [("train.optimizer", -1)]
        for s in trace:
            if s["parent"] is not None:
                assert _inside(s, by_id[s["parent"]]), s["name"]
        # The microbatches run in order: forward, backward, accumulate.
        order = sorted((s for s in trace if "mb" in s["attrs"]),
                       key=lambda s: s["ts"])
        assert [(s["name"], s["attrs"]["mb"]) for s in order] == [
            ("train.forward", 0), ("train.backward", 0),
            ("train.accumulate", 0), ("train.forward", 1),
            ("train.backward", 1), ("train.accumulate", 1)]
    assert sorted(r["attrs"]["step"] for r in spans
                  if r["name"] == "train.step") == [1, 2, 3]


@pytest.mark.parametrize("every,steps", [(0, []), (1, [1, 2, 3]), (2, [2])])
def test_trace_every_picks_the_steps(tmp_path, every, steps):
    spans, _ = _train(tmp_path, trace_every=every)
    assert sorted(s["attrs"]["step"] for s in spans
                  if s["name"] == "train.step") == steps
    assert len(spans) == 12 * len(steps)    # 0: nothing recorded at all


def test_tracing_leaves_the_parameters_bit_equal(tmp_path):
    _, plain = _train(tmp_path / "off", trace_every=0)
    _, traced = _train(tmp_path / "on", trace_every=1)
    for (path, a), (_, b) in zip(tree.leaves_with_path(plain),
                                 tree.leaves_with_path(traced)):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("learners", [1, 2])
def test_program_steps_are_traced_and_peers_join(tmp_path, learners):
    """``launch.train``'s program with ``trace_every=1``: every step is a
    trace (read from the process's ring, which nothing else drains
    here); with a peer, its forward, backward and sync join the chief's
    trace under ``train.step`` (the courier envelope carries it) on the
    steps it takes part in."""
    from repro_torch import core as lp
    program = launch_train.build_program(
        CFG, steps=6, ckpt_dir=str(tmp_path), batch_size=8, seq_len=16,
        learners=learners, with_eval=False, trace_every=1, device="cpu")
    telemetry.spans_buffer().drain()
    lp.launch_and_wait(program, timeout_s=300)
    spans = telemetry.spans_buffer().drain()
    roots = [s for s in spans if s["name"] == "train.step"]
    # The program stops once the chief reports its last step, which may
    # come before that step's root span closes.
    assert {r["attrs"]["step"] for r in roots} >= {1, 2, 3, 4, 5}
    peer = {"train.forward", "train.backward", "train.sync"}
    joined = set()
    for root in roots:
        kids = {s["name"] for s in spans if s["parent"] == root["id"]}
        assert kids - peer == {"train.data", "train.grads", "train.update"}
        joined |= kids & peer
    assert joined == (peer if learners == 2 else set())
    # One trace a step (the last step's root may be missing), the peer's
    # spans inside them.
    assert len({s["trace"] for s in spans}) <= len(roots) + 1


def test_train_cli_writes_the_step_spans(tmp_path):
    """``--trace-every 1 --telemetry-dir``: the hub's ``trace.json`` holds
    the steps' spans. (A scrape whose reply is lost drops what it
    drained, so this reads what arrived, not every span.)"""
    out = tmp_path / "tel"
    launch_train.main([
        "--device", "cpu", "--preset", "tiny", "--steps", "4",
        "--batch-size", "8", "--seq-len", "32", "--trace-every", "1",
        "--telemetry-dir", str(out), "--ckpt-dir", str(tmp_path / "ck")])
    events = json.load(open(out / "trace.json"))["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    assert {e["name"] for e in spans} == {
        "train.step", "train.data", "train.grads", "train.forward",
        "train.backward", "train.sync", "train.update", "train.optimizer"}
    assert any({e["name"] for e in spans
                if e["args"]["parent"] == root["args"]["id"]}
               == {"train.data", "train.grads", "train.update"}
               for root in spans if root["name"] == "train.step")
    snap = json.load(open(out / "telemetry.json"))
    assert snap["span_count"] == len(spans)


@pytest.mark.gpu
@pytest.mark.parametrize("every,reads", [(0, 0), (1, 2 * STEPS)])
def test_cuda_step_reads_the_allocator_only_when_traced(tmp_path, monkeypatch,
                                                        every, reads):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    calls = []
    real = torch.cuda.memory_stats

    def counted(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "memory_stats", counted)
    spans, _ = _train(tmp_path, trace_every=every, device="cuda")
    assert len(calls) == reads
    roots = [s for s in spans if s["name"] == "train.step"]
    assert len(roots) == (STEPS if every else 0)
    for root in roots:
        retries = root["attrs"]["alloc_retries"]
        assert isinstance(retries, int) and retries >= 0
