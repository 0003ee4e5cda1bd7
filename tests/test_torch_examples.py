"""The port's examples (``repro_torch.examples``) run to completion: the
cases of ``tests/test_examples.py``, one for one, with ``device="cpu"``
(paper §3.2 — the test launcher waits for the system to perform its task
and terminate). Each example is also held to the port's default: without
``--device cpu`` it needs a card.
"""

import importlib
import json
import re

import pytest
import torch
import torch.distributed as dist

from repro_torch import core as lp
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.core.courier import inprocess

torch.set_num_threads(1)

NAMES = ("quickstart", "mapreduce", "parameter_server",
         "evolution_strategies", "actor_learner", "train_lm", "serve_lm")


def _load(name):
    return importlib.import_module(f"repro_torch.examples.{name}")


@pytest.fixture(autouse=True)
def _reset_port_inproc_registry():
    inprocess.reset()
    yield
    inprocess.reset()


@pytest.fixture
def no_group_left():
    """A learner mesh starts a process group in this process; end it (a
    later planning mesh in the same worker needs the fake backend)."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_quickstart_runs(capsys):
    mod = _load("quickstart")
    lp.launch_and_wait(mod.make_program(), timeout_s=30)
    mod.main(["--device", "cpu"])
    assert "total 190" in capsys.readouterr().out


def test_parameter_server_topologies():
    mod = _load("parameter_server")
    for mode in ("single", "replicated", "cached"):
        lp.launch_and_wait(mod.build(mode, num_requesters=2, seconds=0.2),
                           timeout_s=30)


def test_mapreduce_counts_words(tmp_path):
    mod = _load("mapreduce")
    text = "a b c a b a\n"
    paths = []
    for i in range(2):
        p = tmp_path / f"in{i}.txt"
        p.write_text(text * 5)
        paths.append(str(p))
    out = str(tmp_path / "out.txt")
    expected = 2 * 5 * 6
    lp.launch_and_wait(mod.build(paths, out, expected), timeout_s=60)
    counts = {}
    with open(out) as f:
        for line in f:
            w, c = line.split()
            counts[w] = counts.get(w, 0) + int(c)
    assert counts == {"a": 30, "b": 20, "c": 10}


def test_evolution_strategies_improves(capsys):
    """The fitness (a torch computation on the evaluators' device) at the
    search distribution's mean beats the first generation's."""
    mod = _load("evolution_strategies")
    lp.launch_and_wait(mod.build(num_evaluators=3, generations=8,
                                 device="cpu"), timeout_s=300)
    out = capsys.readouterr().out
    first = float(re.search(r"gen +0: mean fitness +(-?[0-9.]+)",
                            out).group(1))
    final = float(re.search(r"final fitness at mean: (-?[0-9.]+)",
                            out).group(1))
    assert final > first


def test_actor_learner_runs(capsys):
    mod = _load("actor_learner")
    lp.launch_and_wait(mod.build(num_actors=2, steps=20, device="cpu"),
                       timeout_s=300)
    assert "chief done: step=20" in capsys.readouterr().out


@pytest.mark.parametrize("mesh", [None, "1,1"])
def test_train_lm_end_to_end(mesh, tmp_path, no_group_left):
    """``train_lm`` as a user runs it: 12 steps of the tiny preset, the
    learner's final state checkpointed; with ``--mesh 1,1`` on a 1x1
    gloo mesh."""
    argv = ["--device", "cpu", "--steps", "12", "--batch-size", "8",
            "--seq-len", "32", "--publish-every", "4",
            "--ckpt-dir", str(tmp_path)]
    _load("train_lm").main(argv + (["--mesh", mesh] if mesh else []))
    assert CheckpointManager(str(tmp_path)).latest_step() == 12


def _serve(tmp_path, *flags):
    meter_json = str(tmp_path / "meter.json")
    _load("serve_lm").main(["--device", "cpu", "--clients", "2",
                            "--requests", "2", "--meter-json", meter_json,
                            *flags])
    with open(meter_json) as f:
        return json.load(f)


@pytest.mark.parametrize("mode", ["continuous", "lockstep"])
def test_serve_lm_end_to_end(mode, tmp_path):
    summary = _serve(tmp_path, "--mode", mode)
    assert summary["count"] == 4
    assert summary["p95_ms"] >= summary["p50_ms"] > 0


def test_serve_lm_fabric_end_to_end(tmp_path):
    """Replicated fabric: Registry -> Router -> 2 EngineServers serves
    every request, and the meter summary is namespaced by router."""
    summary = _serve(tmp_path, "--replicas", "2", "--routers", "1")
    assert summary["count"] == 4
    assert summary["p95_ms"] >= summary["p50_ms"] > 0
    (source,) = summary["per_source"]
    assert "Router" in source
    assert summary["per_source"][source]["count"] == 4


def test_serve_lm_failover_demo(tmp_path, capsys):
    """The --kill-after demo: one replica dies mid-run; every request is
    still served (failover onto the sibling, zero lost)."""
    summary = _serve(tmp_path, "--requests", "3", "--replicas", "2",
                     "--routers", "1", "--kill-after", "1")
    assert summary["count"] == 6          # zero lost
    assert "fault: kill -> target 0 fired" in capsys.readouterr().out


def test_serve_lm_rollout_demo(tmp_path, capsys):
    """The --rollout-after demo: mid-run the fleet rolls v0 -> v1 one
    replica at a time; every request is served and the rollout
    promotes."""
    summary = _serve(tmp_path, "--requests", "3", "--replicas", "2",
                     "--routers", "1", "--rollout-after", "1",
                     "--store", str(tmp_path / "store"))
    assert summary["count"] == 6          # zero lost across the roll
    assert "rollout: promoted -> v1" in capsys.readouterr().out


def test_serve_lm_paged(tmp_path):
    """The paged KV cache through the example's ``--page-size``: every
    request served at its length."""
    summary = _serve(tmp_path, "--page-size", "8")
    assert summary["count"] == 4
    assert len(set(summary["out_lens"])) == 1


@pytest.mark.parametrize("name", NAMES)
def test_examples_need_a_card_unless_asked_for_the_cpu(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = {"train_lm": ["--ckpt-dir", str(tmp_path)],
            "mapreduce": ["--files", str(tmp_path / "none.txt")]}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main(argv.get(name, []))
