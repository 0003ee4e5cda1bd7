"""Tiny cells for the CPU tests: the configurations' and mixes' own
shapes of file, at sizes a test run holds."""

from __future__ import annotations

import copy

from perfbench import spec

TINY_SIZES = {"hidden_size": 64, "intermediate_size": 128,
              "num_attention_heads": 4, "num_key_value_heads": 2,
              "num_hidden_layers": 2, "vocab_size": 256}


def tiny_config(name: str) -> dict:
    conf = copy.deepcopy(spec.load_json(
        f"{spec.HERE}/configs/{name}.json"))
    conf.update(TINY_SIZES, tiny=True)
    # float32 compute: the port then agrees with the reference to
    # rounding, and a fault stands out against any committed limit.
    conf["port"]["compute_dtype"] = "float32"
    if "serve" in conf:
        conf["serve"].update(num_slots=8, context_len=256, prefill_chunk=32)
    return conf


def tiny_traffic(name: str) -> dict:
    mix = copy.deepcopy(spec.load_json(f"{spec.HERE}/traffic/{name}.json"))
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


def tiny_cell(workload: str) -> spec.Cell:
    """The cell of BENCHMARK.json at a tiny size, its limits as
    committed."""
    cell = spec.cell(workload)
    cell.config = tiny_config(cell.config_name)
    cell.traffic = tiny_traffic(cell.traffic_name)
    return cell
