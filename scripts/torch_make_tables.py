"""The dry run's tables, from its records: the port's ``make_tables.py``.

Reads ``artifacts/dryrun_torch/{single,multi}/*.json`` (what
``python -m repro_torch.launch.dryrun`` writes; ``--dir`` for another
place) and prints the same three tables as the JAX script: the status
and per-GPU peak of every cell on both planning meshes, the single
mesh's roofline terms, and the skipped cells.

    PYTHONPATH=src python scripts/torch_make_tables.py
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch import dryrun

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(root: str, mesh: str) -> dict:
    rows = {}
    for path in glob.glob(os.path.join(root, mesh, "*.json")):
        with open(path) as f:
            d = json.load(f)
        rows[(d["arch"], d["shape"])] = d
    return rows


def _matrix_cell(d1, d2) -> str:
    if d1 is None:
        return "—"
    if d1["status"] == "skipped":
        return "skip"
    p1 = d1["memory"]["peak_estimate_gb"]
    p2 = (d2["memory"]["peak_estimate_gb"]
          if d2 and d2["status"] == "ok" else None)
    return f"ok {p1:.1f}G / " + (f"ok {p2:.1f}G" if p2 is not None
                                 else d2["status"] if d2 else "—")


def tables(root: str) -> list[str]:
    single, multi = load(root, "single"), load(root, "multi")
    archs = sorted({a for a, _ in single})
    out = ["### Dry-run matrix (status single 16x16 / multi 2x16x16 "
           "planning meshes of H100s, per-GPU peak GB)\n",
           "| arch | " + " | ".join(SHAPES) + " |",
           "|---|" + "---|" * len(SHAPES)]
    for a in archs:
        out.append(f"| {a} | " + " | ".join(
            _matrix_cell(single.get((a, s)), multi.get((a, s)))
            for s in SHAPES) + " |")
    out += ["\n### Roofline (single 16x16, per GPU; seconds per step)\n",
            "| arch | shape | bound | compute_s | memory_s | collective_s "
            "| MFU | useful | collectives (AG/AR/RS/A2A/CP) |",
            "|---|---|---|---|---|---|---|---|---|"]
    for a in archs:
        for s in SHAPES:
            d = single.get((a, s))
            if not d or d["status"] != "ok" or "roofline" not in d:
                continue
            r, c = d["roofline"], d["cost"]["collective_counts"]
            cc = "/".join(str(int(c.get(k, 0))) for k in
                          ("all-gather", "all-reduce", "reduce-scatter",
                           "all-to-all", "collective-permute"))
            out.append(f"| {a} | {s} | {r['bound']} | {r['compute_s']:.3f} "
                       f"| {r['memory_s']:.3f} | {r['collective_s']:.3f} | "
                       f"{r['mfu']:.3f} | {r['useful_flops_ratio']:.2f} | "
                       f"{cc} |")
    out.append("\n### Skipped cells\n")
    out += [f"* `{a} × {s}` — {single[(a, s)]['reason']}"
            for a in archs for s in SHAPES
            if (a, s) in single and single[(a, s)]["status"] == "skipped"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=os.path.abspath(dryrun.ARTIFACT_DIR))
    args = ap.parse_args(argv)
    print("\n".join(tables(args.dir)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
