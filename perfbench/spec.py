"""Finds what a cell is made of, by the names in ``BENCHMARK.json``:
its configuration file, the architecture that file names under
``archs/``, its traffic mix under ``traffic/``, its limits under
``limits/`` and the reader of each of its metrics under ``metrics/``.
Nothing here names a cell, a configuration, an architecture or a
metric."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file, parsed
    config_name: str
    traffic: dict         # the traffic file, parsed
    traffic_name: str
    limits: dict          # limits/<cell>.json, parsed
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list
    base: str = HERE      # the folder its files were found in

    @property
    def arch(self):
        """The module of the architecture that the configuration names."""
        return arch_of(self.config, self.base)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _reported(metric: dict, cell: str, reports: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reports if "moves" in metric else True


def with_pending(bench: dict, name: str, base: str = HERE) -> dict:
    """``bench`` with the entries of ``pending/<name>.json`` added, if
    there is such a file: a cell built and checked but not yet in
    BENCHMARK.json (PERF.md says why), which runs and is tested as it
    will run once its entries move there."""
    path = os.path.join(base, "pending", f"{name}.json")
    if not os.path.exists(path):
        return bench
    extra = load_json(path)
    return {**bench, **{k: bench[k] + extra.get(k, []) for k in
                        ("workloads", "end_to_end", "per_layer")}}


def cell(name: str, root: str = ROOT, bench: Optional[dict] = None,
         base: str = HERE) -> Cell:
    """The cell ``name`` of ``bench`` (default: ``root``'s BENCHMARK.json),
    its files found under ``base`` (the benchmark's folder)."""
    bench = bench or benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        bench = with_pending(bench, name, base)
        work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _reported(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reported(m, name, names)]
    lim_path = os.path.join(base, "limits", f"{name}.json")
    if not os.path.exists(lim_path):
        raise ValueError(f"{name} has no limits ({lim_path}): a cell "
                         "compares its output with the reference")
    limits = load_json(lim_path)
    if not any(isinstance(v, dict) and "limit" in v
               for k, v in limits.items() if k != "sample"):
        raise ValueError(f"{lim_path} names no number with a limit")
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(os.path.join(root, conf["file"])),
        config_name=w["config"],
        traffic=load_json(os.path.join(base, "traffic",
                                       f"{w['traffic']}.json")),
        traffic_name=w["traffic"],
        limits=limits,
        end_to_end=e2e, per_layer=per_layer, base=base)


_modules: dict = {}


def _load(path: str, prefix: str, name: str):
    """The module in the file ``path``, executed once a process."""
    if path not in _modules:
        mod_name = prefix + name.replace(".", "_").replace("-", "_")
        sp = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(sp)
        sp.loader.exec_module(mod)
        _modules[path] = mod
    return _modules[path]


def reader(metric: str, base: str = HERE):
    """The ``read(bundle)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(base, "metrics", f"{metric}.py")
    if not os.path.exists(path):
        raise KeyError(f"no reader for metric {metric!r} ({path})")
    return _load(path, "perfbench_metric_", metric).read


def arch(name: str, base: str = HERE):
    """The module ``archs/<name>.py``: an architecture as the benchmark
    knows it (README.md, "Adding to it"): ``sizes(conf)``,
    ``program_config(conf)``, ``layout(sizes)``, ``reference``,
    ``tiny(conf)`` and the counts that the metrics' readers use."""
    folder = os.path.join(base, "archs")
    path = os.path.join(folder, f"{name}.py")
    if not os.path.exists(path):
        known = sorted(f[:-3] for f in os.listdir(folder)
                       if f.endswith(".py")) if os.path.isdir(folder) else []
        raise KeyError(f"no architecture {name!r} in {folder}; known: "
                       f"{known}")
    return _load(path, "perfbench_arch_", name)


def arch_of(conf: dict, base: str = HERE):
    """The architecture that a configuration file names under
    ``"bench_arch"``; a file that names none is refused."""
    if "bench_arch" not in conf:
        folder = os.path.join(base, "archs")
        raise ValueError(f"configuration {conf.get('name', '?')!r} names "
                         "no architecture: give it \"bench_arch\", the "
                         f"name of a module under {folder}")
    return arch(conf["bench_arch"], base)
