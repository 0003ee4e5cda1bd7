"""Tiny cells for the CPU tests: the configurations' and mixes' own
shapes of file, at sizes a test run holds. The architecture that a
configuration names shrinks it (its ``tiny(conf)``)."""

from __future__ import annotations

import copy

from perfbench import spec


def tiny_config(conf: dict, base: str = spec.HERE) -> dict:
    conf = spec.arch_of(conf, base).tiny(conf)
    if "serve" in conf:
        conf["serve"].update(num_slots=8, context_len=256, prefill_chunk=32)
    return conf


def tiny_traffic(mix: dict) -> dict:
    mix = copy.deepcopy(mix)
    if mix["kind"] == "serve":
        mix["prompt"].update(median=24, min=4, max=96)
        mix["output"].update(median=6, min=2, max=24)
        mix["warmup"] = {"requests": 4, "prompt_lens": [8, 40],
                         "max_new": [2, 5]}
        mix["profile_s"] = 0.2
        mix["ramp_s"] = 0.2
        mix["max_outstanding"] = 16
    else:
        mix.update(batch_size=4, seq_len=16, window_from_step=5,
                   profile_s=0.2)
    mix["run_limit_s"] = 120
    return mix


def tiny_cell(workload: str, **where) -> spec.Cell:
    """The cell of BENCHMARK.json (or of ``where``'s ``root``, ``bench``
    and ``base``, as ``spec.cell`` takes them) at a tiny size, its limits
    as committed."""
    cell = spec.cell(workload, **where)
    cell.config = tiny_config(cell.config, cell.base)
    cell.traffic = tiny_traffic(cell.traffic)
    return cell
