"""Where a Mamba block's tensors shard in the dry run's trace.

Traces a cell of ``arch`` (default: the reduced falcon-mamba-7b at
prefill_32k, a few seconds) on the 16x16 planning mesh of H100s with fake
tensors, and prints, for the first Mamba block, the placements and local
shapes of ``in_proj``'s output before and after its ``shard`` constraint,
of the conv's input and output, and of the selective scan's input ``u``.
The counts of the CPU-only and the CUDA builds of PyTorch differ for the
scan cells; run this on both hosts and compare the lines.

    PYTHONPATH=src python scripts/torch_probe_scan_shards.py
    PYTHONPATH=src python scripts/torch_probe_scan_shards.py \
        falcon-mamba-7b train_4k --full
"""

from __future__ import annotations

import argparse

import torch
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch.launch import cells, dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import ssm

SEEN: list[str] = []


def _describe(label: str, t) -> None:
    if len(SEEN) >= 12 or not isinstance(t, torch.Tensor):
        return
    if isinstance(t, DTensor):
        SEEN.append(f"{label}: {tuple(t.shape)} {t.placements} local "
                    f"{tuple(t.to_local().shape)} {t.device.type}")
    else:
        SEEN.append(f"{label}: plain {tuple(t.shape)} {t.device.type}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch", nargs="?", default="falcon-mamba-7b")
    ap.add_argument("shape", nargs="?", default="prefill_32k")
    ap.add_argument("--full", action="store_true",
                    help="the full config, not the reduced one")
    args = ap.parse_args(argv)
    shard, conv, scan = ssm.shard, ssm._conv1d, ssm.selective_scan

    def shard_probe(x, *logical):
        _describe("in_proj out", x)
        y = shard(x, *logical)
        _describe(f"after shard{logical}", y)
        return y

    def conv_probe(p, u, state=None):
        _describe("conv in", u)
        out = conv(p, u, state)
        _describe("conv out", out[0])
        return out

    def scan_probe(cfg, p, u, h0, impl="auto"):
        _describe("scan u", u)
        return scan(cfg, p, u, h0, impl)

    ssm.shard, ssm._conv1d, ssm.selective_scan = (shard_probe, conv_probe,
                                                  scan_probe)
    cfg = (configs.get if args.full else configs.get_reduced)(args.arch)
    shape = cells.SHAPES[args.shape]
    mesh = make_production_mesh()
    plan = cells.plan_cell(cfg, shape, mesh)
    dryrun.trace(dryrun.probe_cfg(cfg, 1), shape, mesh, plan)
    print(f"torch {torch.__version__}, cuda built: "
          f"{torch.backends.cuda.is_built()}")
    print("\n".join(SEEN))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
