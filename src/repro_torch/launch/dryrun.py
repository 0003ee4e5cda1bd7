"""Multi-pod dry run: the port of ``repro.launch.dryrun``.

For every (architecture x input shape) cell, on the JAX package's
production meshes as planning meshes of H100s (``launch.mesh``):

  * single (16x16): the full configuration's step traced once under
    ``FakeTensorMode`` on DTensors (``launch.cells.trace_cell``): per
    device, its peak memory against the card's, its FLOPs, bytes and
    collectives, and the roofline terms and MFU they give. The trace
    unrolls every layer, so it counts the full depth directly. With
    probes (the default) the JAX package's method runs too: 1- and
    2-superblock traces extrapolated to the full depth, recorded as
    ``probe_vs_full`` (extrapolated / full, per term) to check it.
  * multi (2x16x16): the same trace, which proves the 'pod' axis shards.

Records go to ``artifacts/dryrun_torch/<mesh>/<arch>__<shape>.json``; a
cell the JAX package skips records its reason, and a cell that fails
records ``status: "error"`` with its message.

No card is needed: the planning mesh's process group is a fake one and
nothing is allocated.

Usage:
    python -m repro_torch.launch.dryrun                      # everything
    python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
    python -m repro_torch.launch.dryrun --mesh single --no-probes
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from repro_torch import configs
from repro_torch.launch import cells as cells_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import ALL_SHAPES, shape_applicability
from repro_torch.roofline import analysis, hw

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")


def probe_cfg(cfg, n_superblocks: int):
    """``cfg`` cut to ``n_superblocks`` repeats of its layer pattern."""
    return dataclasses.replace(cfg,
                               num_layers=n_superblocks * len(cfg.pattern))


def trace(cfg, shape, mesh, plan=None):
    """(cell, trace record, seconds) of one cell on ``mesh``."""
    cell = cells_lib.build_cell(cfg, shape, mesh, plan=plan)
    t0 = time.perf_counter()
    rec = cells_lib.trace_cell(cell, mesh)
    return cell, rec, time.perf_counter() - t0


def probe_cost(cfg, shape, mesh, plan) -> analysis.CellCost:
    """The JAX package's depth probe: 1- and 2-superblock traces
    extrapolated to the full depth."""
    costs = [trace(probe_cfg(cfg, n), shape, mesh, plan)[1].cost
             for n in (1, 2)]
    return analysis.extrapolate(costs[0], costs[1],
                                cfg.num_layers / len(cfg.pattern))


def _ratio(a: float, b: float) -> float:
    return a / b if b else (1.0 if a == b else float("inf"))


def cost_record(cost: analysis.CellCost) -> dict:
    return {"flops_per_device": cost.flops,
            "bytes_per_device": cost.bytes_accessed,
            "wire_bytes_per_device": cost.wire_bytes,
            "collective_counts": cost.collective_counts}


def roofline_record(roof: analysis.Roofline) -> dict:
    return {"compute_s": roof.compute_s, "memory_s": roof.memory_s,
            "collective_s": roof.collective_s, "bound": roof.bound,
            "step_s": roof.step_s,
            "model_flops_per_device": roof.model_flops,
            "useful_flops_ratio": roof.useful_flops_ratio,
            "mfu": roof.mfu}


def memory_record(rec: analysis.TraceRecord) -> dict:
    return {"argument_gb": rec.argument_bytes / 1e9,
            "output_gb": rec.output_bytes / 1e9,
            "temp_gb": rec.temp_bytes / 1e9,
            "peak_estimate_gb": rec.peak_bytes / 1e9,
            "hbm_gb": hw.HBM_BYTES / 1e9}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             with_probes: bool = True, budget: float = None) -> dict:
    cfg = configs.get(arch)
    shape = cells_lib.SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                    "mesh_shape": list(mesh.shape),
                    "devices": mesh.size(),
                    "device_type": mesh.device_type}
    skip = shape_applicability(cfg, shape)
    if skip:
        record.update(status="skipped", reason=skip)
        return record
    try:
        plan = cells_lib.plan_cell(
            cfg, shape, mesh,
            cells_lib.DEFAULT_BUDGET if budget is None else budget)
        cell, rec, trace_s = trace(cfg, shape, mesh, plan)
        roof = analysis.roofline_from_cost(rec.cost,
                                           cell.model_flops_per_device)
        record.update(
            status="ok", plan=dataclasses.asdict(plan),
            trace_s=trace_s, ops=rec.ops,
            memory=memory_record(rec),
            fits=rec.peak_bytes <= hw.HBM_BYTES,
            cost=cost_record(rec.cost),
            collective_result_bytes=rec.collective_result_bytes,
            roofline=roofline_record(roof))
        if with_probes:
            est = probe_cost(cfg, shape, mesh, plan)
            record["probe_cost"] = cost_record(est)
            record["probe_vs_full"] = {
                "flops": _ratio(est.flops, rec.cost.flops),
                "bytes": _ratio(est.bytes_accessed,
                                rec.cost.bytes_accessed),
                "wire_bytes": _ratio(est.wire_bytes, rec.cost.wire_bytes)}
    except Exception as exc:  # noqa: BLE001 -- a cell's failure is its record
        record.update(status="error", error=repr(exc),
                      traceback=traceback.format_exc())
    return record


def cell_list():
    return [(arch, shape.name) for arch in configs.ARCH_NAMES
            for shape in ALL_SHAPES]


def artifact_path(arch, shape, mesh_kind):
    d = os.path.abspath(os.path.join(ARTIFACT_DIR, mesh_kind))
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{arch}__{shape}.json")


def summary_line(mesh_kind: str, rec: dict) -> str:
    st = rec["status"]
    extra = ""
    if st == "ok":
        r, m = rec["roofline"], rec["memory"]
        extra = (f" nm={rec['plan']['num_microbatches']}"
                 f" resid_tp={rec['plan']['resid_tp']}"
                 f" peak={m['peak_estimate_gb']:.2f}/{m['hbm_gb']:.2f}GB"
                 f" ct={r['compute_s'] * 1e3:.2f}ms"
                 f" mt={r['memory_s'] * 1e3:.2f}ms"
                 f" colt={r['collective_s'] * 1e3:.2f}ms"
                 f" bound={r['bound']} mfu={r['mfu']:.3f}")
        if "probe_vs_full" in rec:
            extra += f" probe/full flops={rec['probe_vs_full']['flops']:.4f}"
    elif st == "error":
        extra = " " + rec["error"][:160]
    else:
        extra = " " + rec["reason"][:60]
    wall = f" wall={rec['wall_s']:.1f}s" if "wall_s" in rec else ""
    return (f"[{mesh_kind:6s}] {rec['arch']:22s} {rec['shape']:12s} "
            f"{st:7s}{extra}{wall}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    todo = [(a, s) for a, s in cell_list()
            if (args.arch is None or a == args.arch)
            and (args.shape is None or s == args.shape)]

    n_ok = n_skip = n_err = 0
    for mesh_kind in meshes:
        for arch, shape in todo:
            path = artifact_path(arch, shape, mesh_kind)
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    rec = json.load(f)
            else:
                t0 = time.perf_counter()
                rec = run_cell(arch, shape, mesh_kind,
                               with_probes=not args.no_probes)
                rec["wall_s"] = time.perf_counter() - t0
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
            st = rec["status"]
            n_ok += st == "ok"
            n_skip += st == "skipped"
            n_err += st == "error"
            print(summary_line(mesh_kind, rec), flush=True)
    print(f"done: ok={n_ok} skipped={n_skip} error={n_err}")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
