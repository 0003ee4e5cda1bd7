"""Where a cell's bytes go, per device: the port's ``profile_bytes.py``.

Traces one superblock of ``arch`` at ``shape`` (the cell's own plan) on
the 16x16 planning mesh of H100s (``launch.mesh.make_production_mesh``,
fake tensors: no card is needed), then prints the total bytes and FLOPs
and the 12 largest (op, result shapes) buckets by bytes, each bucket an
op's operand and result bytes (``roofline.analysis``'s count). ``bf16``
sets ``models.ssm.SCAN_DTYPE``, the plain selective scan's element type.

The port's trace runs every layer, microbatch and scan step as it comes,
so the JAX script's ``SCAN_UNROLL_THRESHOLD``, ``FORCE_SINGLE_CHUNK`` and
``CHUNK_MODE`` settings have no counterpart here.

    PYTHONPATH=src python scripts/torch_profile_bytes.py qwen2-1.5b train_4k
    PYTHONPATH=src python scripts/torch_profile_bytes.py falcon-mamba-7b \
        train_4k bf16

``--reduced`` takes the arch's smoke-scale config; ``--json PATH`` also
writes the totals and every bucket.
"""

from __future__ import annotations

import argparse
import json

from repro_torch import configs
from repro_torch.launch import cells, dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import ssm


def profile(arch: str, shape_name: str, reduced: bool = False):
    """The trace record of one superblock of the cell."""
    cfg = (configs.get_reduced if reduced else configs.get)(arch)
    shape = cells.SHAPES[shape_name]
    mesh = make_production_mesh()
    plan = cells.plan_cell(cfg, shape, mesh)
    return dryrun.trace(dryrun.probe_cfg(cfg, 1), shape, mesh, plan)[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("scan_dtype", nargs="?", choices=["bf16"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if args.scan_dtype == "bf16":
        ssm.SCAN_DTYPE = "bfloat16"
    rec = profile(args.arch, args.shape, args.reduced)
    buckets = sorted(rec.bytes_by_op.items(), key=lambda kv: -kv[1])
    print("total bytes accessed:", f"{rec.cost.bytes_accessed:.3e}",
          "flops:", f"{rec.cost.flops:.3e}")
    for (op, shapes), b in buckets[:12]:
        print(f"{b:.3e} {op:28s} {str(list(shapes))[:60]}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"total_bytes": rec.cost.bytes_accessed,
                       "flops": rec.cost.flops,
                       "buckets": [[op, shapes, b]
                                   for (op, shapes), b in buckets]}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
