"""One bf16 decode step of full-width Mixtral-8x7B cut to 16 layers (B 3
rows over a 160-slot ring, where ``scripts/torch_time_kernels.py``
times K1 as Mixtral's) on the card, timed on the host clock to a
synchronize: the median of 10 steps after 3 warm-up steps.

It uses only entry points that earlier trees of the port have too, so
two trees can be compared in one call on one card, in the order parent,
change, change, parent:

    PYTHONPATH=<tree>/src python3 scripts/ab_decode_step.py --label change
"""

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import transformer
from repro_torch.serve import decode as serve_lib

B, L, LAYERS, STEPS, WARM = 3, 160, 16, 10, 3


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    cfg = dataclasses.replace(configs.get("mixtral-8x7b"), num_layers=LAYERS)
    params = transformer.init_params(cfg, 0, device="cuda",
                                     dtype=torch.bfloat16)
    state = transformer.init_decode_state(cfg, B, L, device="cuda")
    step = serve_lib.make_serve_step(cfg)
    tok = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
    t = torch.full((B,), 128, dtype=torch.int32, device="cuda")
    times = []
    with torch.no_grad():
        for i in range(WARM + STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, state = step(params, state, tok, t + i)
            torch.cuda.synchronize()
            if i >= WARM:
                times.append((time.perf_counter() - t0) * 1e3)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"label": args.label, "step_ms_median":
                      float(np.median(times)), "step_ms_runs": times,
                      "device": smi}), flush=True)


if __name__ == "__main__":
    main()
