"""Gradient clipping in the port's AdamW, two ways, on the card in one
call: as a clipped copy of the whole gradient tree, then the update
(``copy``), against the clip applied leaf by leaf inside the update
(``leaf``, what ``repro_torch.train.optimizer.apply_updates`` does).
Same arithmetic, so the losses must be equal; the step time and the CUDA
memory peak are compared, in the order copy, leaf, leaf, copy.

Full-width Qwen2-1.5B, fp32 master weights, bf16 compute, remat, B 8 x
S 1024 in 2 microbatches, six steps a run (``chip_smoke.py`` phase 8's
setup):

    PYTHONPATH=src python3 scripts/ab_train_clip.py
"""

import gc
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts
from repro_torch.train import tree


@torch.no_grad()
def copy_apply(cfg, params, grads, state):
    """``apply_updates`` with the clip made as a copy of the tree."""
    f32 = opt_lib._f32
    device = tree.leaves(params)[0].device
    step = torch.as_tensor(state["step"]).to("cpu", torch.int32) + 1
    lr = opt_lib.schedule(cfg, step)
    gnorm = opt_lib.global_norm(grads)
    scale = torch.minimum(f32(1.0, device), torch.div(
        f32(cfg.clip_norm, device), gnorm + f32(1e-9, device)))
    grads = tree.tree_map(lambda g: g * scale.to(g.dtype), grads)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = (f32(1.0) - torch.pow(f32(b1), stepf)).to(device)
    bc2 = (f32(1.0) - torch.pow(f32(b2), stepf)).to(device)
    lr_dev = lr.to(device)
    out = {}

    def upd(path, p, g, m, v):
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay and opt_lib._decay_mask(path):
            u = u + cfg.weight_decay * p.float()
        out[path] = ((p - lr_dev * u).to(p.dtype), m, v)

    tree.map_with_path(upd, params, grads, state["m"], state["v"])
    pick = lambda i: tree.map_with_path(  # noqa: E731
        lambda path, _: out[path][i], params)
    return (pick(0), {"m": pick(1), "v": pick(2), "step": step},
            {"grad_norm": gnorm, "lr": lr})


def main() -> None:
    variants = {"copy": copy_apply, "leaf": opt_lib.apply_updates}
    cfg = configs.get("qwen2-1.5b")
    tc = ts.TrainConfig(optimizer=opt_lib.OptimizerConfig(
        lr=1e-3, warmup_steps=20, total_steps=6), num_microbatches=2,
        remat="full")
    src = iter(make_source(DataConfig(seq_len=1024, batch_size=8,
                                      vocab_size=cfg.vocab_size)))
    batches = [ts.to_device(next(src), "cuda") for _ in range(6)]
    for name in ("copy", "leaf", "leaf", "copy"):
        opt_lib.apply_updates = variants[name]
        params, opt = ts.make_train_state(cfg, 0, device="cuda")
        step = ts.make_train_step(cfg, tc)
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        print(json.dumps({"variant": name, "step_s": times,
                          "median_steps_2_to_6": float(np.median(times[1:])),
                          "cuda_peak_gb": torch.cuda.max_memory_allocated()
                          / 1e9, "losses": losses}), flush=True)
        del params, opt, m, step
        gc.collect()
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
