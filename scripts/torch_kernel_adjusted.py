"""Kernel-adjusted roofline: the port's ``kernel_adjusted.py``.

The dry run's memory term counts every eager op's operands and results,
among them the tensors that the kernels keep on chip: attention's
[B, H, Sq, Sk] logits and probabilities (K3 streams them through
registers and shared memory), and the selective scan's [.., Di, N]
elements (K5 discretises and carries h in registers). This script takes
their traffic out. It classifies each (op, result shapes) bucket of the
1- and 2-superblock traces (``roofline.analysis``, on the 16x16
planning mesh of H100s, fake tensors) with the JAX script's strict
classifier (``kernelizable``, kept as it is: it does not catch
RecurrentGemma's [B, S, W] RG-LRU elements), takes the kernelizable
share of a superblock's bytes from the difference of the two traces, and
scales the memory term by what is left. The kernels' own streaming pass
over their inputs and outputs stays in the other buckets, as in the JAX
script.

The memory term it scales is the dry run's record,
``artifacts/dryrun_torch/single/<arch>__<shape>.json``, when there is
one; otherwise the two traces extrapolated to the full depth (the dry
run's probe, ``analysis.extrapolate``). It prints the adjusted memory
term, step and MFU at the H100's peak (``roofline.hw``). The two traces
run in two processes at once.

The port's trace runs every layer, microbatch and scan step as it comes,
so the JAX script's ``SCAN_UNROLL_THRESHOLD``, ``FORCE_SINGLE_CHUNK`` and
``CHUNK_MODE`` settings have no counterpart here.

    PYTHONPATH=src python scripts/torch_kernel_adjusted.py \
        falcon-mamba-7b train_4k

``--reduced`` takes the arch's smoke-scale config; ``--json PATH`` also
writes the result.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
from concurrent import futures

from repro_torch import configs
from repro_torch.launch import cells, dryrun
from repro_torch.roofline import analysis, hw


def kernelizable(dims_list, ssm_state: int) -> bool:
    """Tensor shapes the kernels keep on chip. Deliberately strict: 4-D
    [B, H, Sq, Sk] attention logits/probs only (3-D [B, S, F] MLP
    activations are NOT eliminated by flash), and [.., Di, N] scan
    elements with the exact SSM state size. ``dims_list``: (dtype,
    shape) pairs, an op's results."""
    for _dtype, d in dims_list:
        if ssm_state and len(d) >= 3 and d[-1] == ssm_state:
            return True                      # [.., Di_shard, N] scan elems
        if len(d) == 4 and d[-2] >= 1024 and d[-1] >= 1024:
            return True                      # [B, H, Sq, Sk] logits/probs
    return False


def probe(arch: str, shape_name: str, n_superblocks: int,
          reduced: bool) -> dict:
    """One probe trace: its cost, its total and kernelizable bytes, and
    the full configuration's model FLOPs per device."""
    from repro_torch.launch.mesh import make_production_mesh
    cfg = (configs.get_reduced if reduced else configs.get)(arch)
    shape = cells.SHAPES[shape_name]
    mesh = make_production_mesh()
    plan = cells.plan_cell(cfg, shape, mesh)
    _, rec, trace_s = dryrun.trace(dryrun.probe_cfg(cfg, n_superblocks),
                                   shape, mesh, plan)
    kern = sum(b for (_op, shapes), b in rec.bytes_by_op.items()
               if kernelizable(shapes, cfg.ssm_state))
    return {"total": sum(rec.bytes_by_op.values()), "kern": kern,
            "cost": dryrun.cost_record(rec.cost), "trace_s": trace_s,
            "model_flops": cells._model_flops(cfg, shape, mesh.size())}


def _cost(rec: dict) -> analysis.CellCost:
    return analysis.CellCost(rec["flops_per_device"], rec["bytes_per_device"],
                             rec["wire_bytes_per_device"],
                             rec["collective_counts"])


def adjust(arch: str, shape_name: str, reduced: bool = False,
           base_path: str | None = None) -> dict:
    """The kernelizable byte fraction of a superblock and the roofline
    with the memory term scaled by what is left."""
    ctx = multiprocessing.get_context("spawn")   # one planning group each
    with futures.ProcessPoolExecutor(2, mp_context=ctx) as pool:
        p1, p2 = pool.map(probe, [arch] * 2, [shape_name] * 2, [1, 2],
                          [reduced] * 2)
    d_total, d_kern = p2["total"] - p1["total"], p2["kern"] - p1["kern"]
    frac = d_kern / d_total if d_total else 0.0
    cfg = (configs.get_reduced if reduced else configs.get)(arch)
    base_path = base_path or os.path.join(
        os.path.abspath(dryrun.ARTIFACT_DIR), "single",
        f"{arch}__{shape_name}.json")
    if os.path.exists(base_path):
        with open(base_path) as f:
            terms, base = json.load(f)["roofline"], base_path
    else:
        roof = analysis.roofline_from_cost(
            analysis.extrapolate(_cost(p1["cost"]), _cost(p2["cost"]),
                                 cfg.num_layers / len(cfg.pattern)),
            p1["model_flops"])
        terms = dryrun.roofline_record(roof)
        base = "1- and 2-superblock traces extrapolated to the full depth"
    mt = terms["memory_s"]
    adj_mt = mt * (1 - frac)
    step = max(terms["compute_s"], adj_mt, terms["collective_s"])
    return {"arch": arch, "shape": shape_name, "reduced": reduced,
            "base": base, "fraction": frac,
            "superblock_bytes": d_total, "superblock_kernelizable": d_kern,
            "memory_s": mt, "memory_s_adjusted": adj_mt,
            "step_s": terms["step_s"], "step_s_adjusted": step,
            "mfu": terms["mfu"],
            "mfu_adjusted": (terms["model_flops_per_device"]
                             / hw.PEAK_FLOPS_BF16 / step),
            "trace_s": [p1["trace_s"], p2["trace_s"]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--base", default=None,
                    help="a dry-run record (default: the single mesh's)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    r = adjust(args.arch, args.shape, args.reduced, args.base)
    print(f"{r['arch']} {r['shape']}: kernelizable byte fraction per "
          f"superblock = {r['fraction']:.2f} (base: {r['base']})")
    print(f"memory term {r['memory_s']:.4g}s -> kernel-adjusted "
          f"{r['memory_s_adjusted']:.4g}s; step {r['step_s']:.4g}s -> "
          f"{r['step_s_adjusted']:.4g}s; mfu {r['mfu']:.4g} -> "
          f"{r['mfu_adjusted']:.4g}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(r, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
