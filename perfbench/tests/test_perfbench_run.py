"""Whole runs of tiny cells on the CPU: the harness without its look for
a card, the program, the load, the metrics and the comparison that
decides ``correct``; then the same runs with the timed path broken
underneath, each fault a cell can have, and ``correct`` false."""

import dataclasses
import math
import os
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness, spec
from perfbench.tests.tiny import tiny_cell

SERVE = ["qwen2-1.5b.chat-backlog"]
TRAIN = "qwen2-1.5b.train-b8s1024"
SEED = 2 ** 31 + 12345


def _run(workload, trace=False, seconds=1.2):
    return harness.run_cell(tiny_cell(workload), SEED, seconds, trace,
                            torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("workload", SERVE + [TRAIN])
def test_a_sound_run_is_correct_and_reports_its_metrics(workload):
    out = _run(workload)
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    cell = tiny_cell(workload)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(math.isfinite(m["value"]) and m["value"] > 0
               for m in out["metrics"].values())
    assert list(out)[-1] == "check"


@pytest.mark.parametrize("workload", SERVE + [TRAIN])
def test_a_traced_run_reads_the_per_layer_metrics(workload):
    out = _run(workload, trace=True)
    assert out["correct"], out["check"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # No device on the CPU: the spans' and counters' metrics read, the
    # device trace's stay out of the line.
    names = set(out["metrics"])
    assert names and all(not n.startswith("device_idle") or
                         out["metrics"][n]["value"] == 100.0 for n in names)


def _altered_sampler(orig):
    def make_sampler(temperature=0.0, top_k=None):
        inner = orig(temperature, top_k)

        def sample(logits, gen=None):
            tok = inner(logits, gen)
            return (tok + 1) % logits.shape[-1]
        return sample
    return make_sampler


@pytest.mark.parametrize("workload", SERVE)
def test_an_altered_token_is_not_correct(workload, monkeypatch):
    from repro_torch.serve import decode
    monkeypatch.setattr(decode, "make_sampler",
                        _altered_sampler(decode.make_sampler))
    out = _run(workload)
    assert not out["correct"]
    gaps = [c for name, c in out["check"].items() if "gap" in name]
    assert gaps and all(c["value"] > c["limit"] for c in gaps)


@pytest.mark.parametrize("workload", SERVE)
def test_a_slot_state_left_unwritten_is_not_correct(workload, monkeypatch):
    from repro_torch.models import transformer
    monkeypatch.setattr(transformer, "write_decode_slot",
                        lambda *a, **k: None)
    monkeypatch.setattr(transformer, "write_paged_slot",
                        lambda *a, **k: None)
    out = _run(workload)
    assert not out["correct"]


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from repro_torch.train import optimizer
    monkeypatch.setattr(optimizer, "apply_updates",
                        lambda cfg, params, grads, state:
                        (params, state, {}))
    out = _run(TRAIN)
    assert not out["correct"]
    assert out["check"]["update_norm_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    from repro_torch.launch import train
    orig = train.make_grad_fn

    def half(model_cfg, train_cfg):
        fn = orig(model_cfg, dataclasses.replace(train_cfg,
                                                 num_microbatches=1))

        def compute(params, batch):
            n = batch["tokens"].shape[0] // 2
            return fn(params, {k: v[:n] for k, v in batch.items()})
        return compute

    monkeypatch.setattr(train, "make_grad_fn", half)
    out = _run(TRAIN)
    assert not out["correct"], out["check"]


def test_no_jax_module_in_a_run():
    assert harness.jax_modules(["jax", "jax.numpy", "jaxlib.xla", "flax",
                                "repro", "repro.core", "repro_torch",
                                "repro_torch.core", "jaxtyping",
                                "numpy"]) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla", "repro", "repro.core"]
    root = os.path.dirname(spec.HERE)
    code = ("import sys, time, torch\n"
            "from perfbench import harness\n"
            "from perfbench.tests.tiny import tiny_cell\n"
            "out = harness.run_cell(tiny_cell('qwen2-1.5b.chat-backlog'), "
            "7, 0.5, False, torch.device('cpu'), time.perf_counter())\n"
            "assert out['correct'], out\n"
            "found = harness.jax_modules(sys.modules)\n"
            "assert not found, found\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, os.path.join(root, "src")]))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]


def test_the_command_refuses_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root = os.path.dirname(spec.HERE)
    res = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         TRAIN, "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=root, capture_output=True, text=True,
        timeout=120)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
