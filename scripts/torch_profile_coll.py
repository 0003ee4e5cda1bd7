"""Where a cell's wire bytes go, per device: the port's
``profile_coll.py``.

Traces two superblocks of ``arch`` at ``shape`` with ``nm``
microbatches on the 16x16 planning mesh of H100s (fake tensors: no card
is needed) and ranks its collectives by ring wire bytes
(``roofline.analysis.wire_bytes``), keyed by (kind, result shape, group
size): the total, then the 12 largest with their share.

The port's trace runs every layer and microbatch as it comes, so the
JAX script's ``SCAN_UNROLL_THRESHOLD``, ``FORCE_SINGLE_CHUNK`` and
``CHUNK_MODE`` settings have no counterpart here.

    PYTHONPATH=src python scripts/torch_profile_coll.py qwen2-1.5b train_4k 4

``--reduced`` takes the arch's smoke-scale config; ``--json PATH`` also
writes the total and every bucket.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch import configs
from repro_torch.launch import cells, dryrun
from repro_torch.launch.mesh import make_production_mesh


def profile(arch: str, shape_name: str, nm: int, reduced: bool = False):
    """The trace record of two superblocks of the cell in ``nm``
    microbatches."""
    cfg = (configs.get_reduced if reduced else configs.get)(arch)
    shape = cells.SHAPES[shape_name]
    mesh = make_production_mesh()
    plan = dataclasses.replace(cells.plan_cell(cfg, shape, mesh),
                               num_microbatches=nm)
    return dryrun.trace(dryrun.probe_cfg(cfg, 2), shape, mesh, plan)[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("nm", type=int)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    rec = profile(args.arch, args.shape, args.nm, args.reduced)
    buckets = sorted(rec.wire_by_collective.items(), key=lambda kv: -kv[1])
    total = rec.cost.wire_bytes
    print(f"total wire bytes (2-superblock probe, nm={args.nm}): "
          f"{total:.3e}")
    for (kind, shapes, g), w in buckets[:12]:
        print(f"{w:.3e} ({100 * w / total:4.1f}%) {kind:18s} g={g:4d} "
              f"{str(list(shapes))[:60]}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"total_wire_bytes": total,
                       "buckets": [[kind, shapes, g, w]
                                   for (kind, shapes, g), w in buckets]}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
