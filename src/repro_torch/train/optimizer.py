"""AdamW + global-norm clipping + warmup-cosine schedule — the port of
``repro.train.optimizer``, over the port's parameter trees.

The arithmetic is the JAX package's, in fp32 throughout. Every Python
constant is rounded to fp32 before it meets a tensor, as JAX rounds a
weakly typed constant, and each division is a true division by an fp32
tensor: PyTorch divides a CUDA tensor by a Python scalar as a multiply
by its reciprocal, which can change the last bit. The schedule and the
bias corrections are computed from the step on the host; the step is a
CPU int32 scalar, so reading it never waits for the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.sharding.rules import full
from repro_torch.train import tree


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


def _f32(x, device=None) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step``: an fp32 scalar on the CPU."""
    step = torch.as_tensor(step).to(device="cpu", dtype=torch.float32)
    warm = step / _f32(max(cfg.warmup_steps, 1))
    t = (step - _f32(cfg.warmup_steps)) / _f32(
        max(cfg.total_steps - cfg.warmup_steps, 1))
    t = torch.clamp(t, 0.0, 1.0)
    cos = _f32(cfg.min_lr_ratio) + _f32((1 - cfg.min_lr_ratio) * 0.5) * (
        _f32(1.0) + torch.cos(_f32(math.pi) * t))
    return _f32(cfg.lr) * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> dict:
    zeros = lambda t: tree.tree_map(torch.zeros_like, t)  # noqa: E731
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(t) -> torch.Tensor:
    """sqrt of the sum of the per-leaf sums of squares, stacked first."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree.leaves(t)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _decay_mask(path) -> bool:
    """Weight decay on matrices only (no norms/biases/scalars)."""
    return str(path[-1]) not in ("bias", "scale", "lam", "A_log", "D",
                                 "bias_a", "bias_x")


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params, grads, state):
    """One AdamW step. Returns (new_params, new_state, metrics) and leaves
    the arguments as they are; the new moments are fp32."""
    out = {}

    def fresh(path, p, m, v):
        out[path] = (torch.empty_like(p),
                     torch.empty_like(m, dtype=torch.float32),
                     torch.empty_like(v, dtype=torch.float32))
        return out[path]

    step, metrics = _adamw(cfg, params, grads, state, fresh)
    pick = lambda i: tree.map_with_path(  # noqa: E731
        lambda path, _: out[path][i], params)
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}, metrics


@torch.no_grad()
def apply_updates_(cfg: OptimizerConfig, params, grads, state) -> dict:
    """``apply_updates`` in place: each leaf's new p, m and v is written
    into its own storage, so no second copy of the state is made and
    every leaf keeps its tensor and address (a replayed gradient pass
    reads the parameters where they live). The moments must be fp32, as
    they are beside fp32 master weights. ``state["step"]`` becomes the
    new step. Returns the metrics."""
    def own(path, p, m, v):
        if m.dtype != torch.float32 or v.dtype != torch.float32:
            raise ValueError(f"in-place AdamW needs fp32 moments, {path} "
                             f"has {m.dtype} and {v.dtype}")
        return p, m, v

    state["step"], metrics = _adamw(cfg, params, grads, state, own)
    return metrics


def _adamw(cfg: OptimizerConfig, params, grads, state, into) -> tuple:
    """The AdamW arithmetic of both entry points, leaf after leaf: each
    leaf's new p, m and v go into the tensors ``into(path, p, m, v)``
    names (fresh ones, or the leaf's own). Each first op reads the old
    value and writes the destination, so either way the same fp32
    operations run in the same order. Returns (new step, metrics)."""
    device = tree.leaves(params)[0].device
    step = torch.as_tensor(full(state["step"])).to("cpu", torch.int32) + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        # Applied leaf by leaf in ``upd``: a clipped copy of the whole
        # gradient tree would cost its size in memory (6.2 GB at Qwen2).
        scale = torch.minimum(_f32(1.0, device), torch.div(
            _f32(cfg.clip_norm, device), gnorm + _f32(1e-9, device)))

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = (_f32(1.0) - torch.pow(_f32(b1), stepf)).to(device)
    bc2 = (_f32(1.0) - torch.pow(_f32(b2), stepf)).to(device)
    lr_dev = lr.to(device)

    def upd(path, p, g, m, v):
        p_new, m_new, v_new = into(path, p, m, v)
        if scale is not None:
            g = g * scale.to(g.dtype)
        g = g.float()
        torch.mul(m, b1, out=m_new).add_((1 - b1) * g)
        torch.mul(v, b2, out=v_new).add_((1 - b2) * g * g)
        u = (m_new / bc1).div_((v_new / bc2).sqrt_().add_(cfg.eps))
        if cfg.weight_decay and _decay_mask(path):
            u.add_(cfg.weight_decay * p.float())
        torch.sub(p, u.mul_(lr_dev), out=p_new)

    tree.map_with_path(upd, params, grads, state["m"], state["v"])
    return step, {"grad_norm": gnorm, "lr": lr}
