"""Perf hill climb: the port of ``repro.launch.hillclimb``. Re-traces one
cell under variant settings and reports the roofline terms.

A variant is (plan overrides + model-module flags). Each run traces the
cell as the dry run does (``launch.dryrun.trace``, the full depth on the
16x16 planning mesh of H100s), so before/after comparisons are
apples-to-apples.

    python -m repro_torch.launch.hillclimb --arch qwen3-8b \\
        --shape train_4k --variant attn_bf16
    python -m repro_torch.launch.hillclimb --list
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import time

from repro_torch import configs
from repro_torch.launch import cells as cells_lib

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                   "artifacts", "hillclimb_torch")

# variant name -> dict(plan={...}, flags={...}); the JAX package's list.
VARIANTS = {
    "baseline": {},
    # --- memory-term levers ------------------------------------------------
    "attn_bf16": {"flags": {"attention.LOGITS_DTYPE": "bfloat16"}},
    "ssm_bf16": {"flags": {"ssm.SCAN_DTYPE": "bfloat16"}},
    "remat_none": {"plan": {"remat": "none"}},
    # --- collective-term levers ---------------------------------------------
    "micro1": {"plan": {"num_microbatches": 1}},
    "micro2": {"plan": {"num_microbatches": 2}},
    "micro4": {"plan": {"num_microbatches": 4}},
    "micro8": {"plan": {"num_microbatches": 8}},
    "no_resid_tp": {"plan": {"resid_tp": False}},
    "resid_tp": {"plan": {"resid_tp": True}},
    "norm_bf16": {"flags": {"layers.NORM_RESIDENT_DTYPE": "compute"}},
    # --- combinations --------------------------------------------------------
    "attn_bf16+micro4": {"plan": {"num_microbatches": 4},
                         "flags": {"attention.LOGITS_DTYPE": "bfloat16"}},
    "ssm_bf16+micro2": {"plan": {"num_microbatches": 2},
                        "flags": {"ssm.SCAN_DTYPE": "bfloat16"}},
    "attn_bf16+ssm_bf16": {"flags": {"attention.LOGITS_DTYPE": "bfloat16",
                                     "ssm.SCAN_DTYPE": "bfloat16"}},
    "norm_bf16+attn_bf16": {"flags": {
        "layers.NORM_RESIDENT_DTYPE": "compute",
        "attention.LOGITS_DTYPE": "bfloat16"}},
    "norm_bf16+micro8": {"plan": {"num_microbatches": 8},
                         "flags": {"layers.NORM_RESIDENT_DTYPE": "compute"}},
    "all_bf16": {"flags": {
        "layers.NORM_RESIDENT_DTYPE": "compute",
        "attention.LOGITS_DTYPE": "bfloat16",
        "ssm.SCAN_DTYPE": "bfloat16"}},
    "all_bf16+micro8": {"plan": {"num_microbatches": 8}, "flags": {
        "layers.NORM_RESIDENT_DTYPE": "compute",
        "attention.LOGITS_DTYPE": "bfloat16",
        "ssm.SCAN_DTYPE": "bfloat16"}},
}


def _set_flag(dotted: str, value):
    mod_name, attr = dotted.rsplit(".", 1)
    mod = importlib.import_module(f"repro_torch.models.{mod_name}")
    old = getattr(mod, attr)
    setattr(mod, attr, value)
    return mod, attr, old


def run_variant(arch: str, shape_name: str, variant: str) -> dict:
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.roofline import analysis

    spec = VARIANTS[variant]
    cfg = configs.get(arch)
    shape = cells_lib.SHAPES[shape_name]
    mesh = make_production_mesh()
    plan = cells_lib.plan_cell(cfg, shape, mesh)
    if spec.get("plan"):
        plan = dataclasses.replace(plan, **spec["plan"])

    restore = []
    try:
        for dotted, value in (spec.get("flags") or {}).items():
            restore.append(_set_flag(dotted, value))
        t0 = time.perf_counter()
        cell, rec, _ = dryrun.trace(cfg, shape, mesh, plan)
        roof = analysis.roofline_from_cost(rec.cost,
                                           cell.model_flops_per_device)
        out = {
            "arch": arch, "shape": shape_name, "variant": variant,
            "status": "ok", "plan": dataclasses.asdict(plan),
            "flags": spec.get("flags", {}),
            "wall_s": time.perf_counter() - t0,
            "peak_gb": rec.peak_bytes / 1e9,
            "cost": {"flops": rec.cost.flops,
                     "bytes": rec.cost.bytes_accessed,
                     "wire": rec.cost.wire_bytes,
                     "collectives": rec.cost.collective_counts},
            "roofline": {"compute_s": roof.compute_s,
                         "memory_s": roof.memory_s,
                         "collective_s": roof.collective_s,
                         "bound": roof.bound, "step_s": roof.step_s,
                         "mfu": roof.mfu,
                         "useful": roof.useful_flops_ratio},
        }
    except Exception as exc:  # noqa: BLE001 -- a variant's failure is its record
        out = {"arch": arch, "shape": shape_name, "variant": variant,
               "status": "error", "error": repr(exc)}
    finally:
        for mod, attr, old in reversed(restore):
            setattr(mod, attr, old)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=False)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)
    if args.list:
        for k in VARIANTS:
            print(k)
        return 0
    if args.arch is None:
        ap.error("--arch is required unless --list")
    os.makedirs(ART, exist_ok=True)
    rec = run_variant(args.arch, args.shape, args.variant)
    path = os.path.join(
        ART, f"{args.arch}__{args.shape}__{args.variant}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    r = rec.get("roofline")
    if r:
        print(f"{args.arch} {args.shape} {args.variant}: "
              f"bound={r['bound']} ct={r['compute_s']:.3f} "
              f"mt={r['memory_s']:.3f} colt={r['collective_s']:.3f} "
              f"step={r['step_s']:.3f}s mfu={r['mfu']:.4f} "
              f"peak={rec['peak_gb']:.1f}GB")
    else:
        print(rec)
    return 0 if rec["status"] == "ok" else 1


if __name__ == "__main__":
    raise SystemExit(main())
