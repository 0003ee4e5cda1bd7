"""Readings that limits are set from, on the card, in one process:

    python3 perfbench/tools/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--out <file.jsonl>]

For each seed, one run of the cell (its program against the reference,
as the benchmark runs it) and, on the same sample, the control: the
reference computed in fp8 in the program's place; for the training
cell also the reference with half of each batch left out. One JSON line
a seed goes to standard output (and to ``--out``). A finished program
does not hand back all its device memory before the next seed starts:
run a model of tens of GB a few seeds to a process."""

import argparse
import json
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from perfbench import harness, spec  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="read the control on the first N seeds only")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA device")
    cell = spec.cell(args.workload)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    for k, seed in enumerate(args.seeds):
        t = time.perf_counter()
        control = args.control_seeds is None or k < args.control_seeds
        out = harness.run_cell(cell, seed, args.seconds, False, dev, t,
                               control=control)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "correct": out["correct"],
                           "metrics": out["metrics"],
                           "check": out["check"],
                           "readings": out["readings"],
                           "wall_s": time.perf_counter() - t})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
