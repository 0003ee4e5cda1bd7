"""The kernel wrappers' custom-op dispatch on the card, in one call: one
bf16 decode step of full-width Qwen2-1.5B (B 8, a 2048-slot cache, K1 in
every layer) with the kernels reached through ``torch.ops.repro_torch``
(``op``, what the wrappers do) against the same Python functions called
directly (``direct``), in the order op, direct, direct, op. Same kernels
and arguments, so the tokens must be equal; the step time is compared
(median of 50 after 5 warm-up steps, host clock to a synchronize).

    PYTHONPATH=src python3 scripts/ab_custom_op.py
"""

import json
import subprocess
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels import decode_attention as k12
from repro_torch.kernels import flash_attention as k3
from repro_torch.models import transformer
from repro_torch.serve import decode as serve_lib

B, L, STEPS, WARM = 8, 2048, 50, 5
OPS = {k12: ("_decode_attention", "_paged_decode_attention"),
       k3: ("_flash_attention",)}


def set_route(direct: bool) -> None:
    """Point each wrapper at its custom op or at the op's function."""
    for mod, names in OPS.items():
        for name in names:
            op = getattr(mod, name)
            op = getattr(op, "_op_def", op)
            if direct:
                fn = op._init_fn
                fn._op_def = op
                setattr(mod, name, fn)
            else:
                setattr(mod, name, op)


def run(cfg, params, state, direct: bool) -> dict:
    set_route(direct)
    step = serve_lib.make_serve_step(cfg)
    tok = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
    t = torch.full((B,), L // 2, dtype=torch.int32, device="cuda")
    times, toks = [], []
    k12.reset_launches()
    with torch.no_grad():
        for i in range(WARM + STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, state = step(params, state, tok, t + i)
            torch.cuda.synchronize()
            if i >= WARM:
                times.append(time.perf_counter() - t0)
            toks.append(tok[:, 0].tolist())
    return {"route": "direct" if direct else "op",
            "step_ms_median": float(np.median(times)) * 1e3,
            "step_ms_min": float(np.min(times)) * 1e3,
            "k1_launches": k12.launches["decode_attention"],
            "tokens": toks}


def main() -> None:
    cfg = configs.get("qwen2-1.5b")
    params = transformer.init_params(cfg, 0, device="cuda",
                                     dtype=torch.bfloat16)
    runs = []
    for direct in (False, True, True, False):
        state = transformer.init_decode_state(cfg, B, L, device="cuda")
        runs.append(run(cfg, params, state, direct))
    set_route(False)
    same = all(r["tokens"] == runs[0]["tokens"] for r in runs)
    for r in runs:
        r.pop("tokens")
        print(json.dumps(r), flush=True)
    print(json.dumps({"tokens_equal": same}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if not same:
        raise SystemExit("the two routes gave different tokens")


if __name__ == "__main__":
    main()
