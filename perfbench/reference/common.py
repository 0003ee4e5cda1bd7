"""What every architecture's plain reference shares: float32 products
with TF32 off, the fp8 rounding of the control, RMSNorm, RoPE, causal
GQA attention, and the AdamW steps that a training cell's numbers are
compared with, and the projections that a block is built of (``linear``,
``dense_mlp``). It imports neither ``repro_torch`` nor JAX."""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """float32 products in float32: TF32 off for the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one absmax scale along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Prec:
    """Where operands are rounded: nowhere (float32) or to fp8."""

    def __init__(self, quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown quantization {quant!r}")
        self.q = quant

    def w(self, w: torch.Tensor) -> torch.Tensor:
        """A weight [.., in, out] in float32 (rounded per output)."""
        w = w.float()
        return fp8(w, -2) if self.q else w

    def a(self, x: torch.Tensor) -> torch.Tensor:
        """An activation [.., features], rounded per row."""
        return fp8(x, -1) if self.q else x


def linear(x, p: dict, prec: Prec, name: str):
    """x @ the leaf ``name``'s kernel, plus its bias where it has one."""
    y = prec.a(x) @ prec.w(p[name]["kernel"])
    if "bias" in p[name]:
        y = y + p[name]["bias"].float()
    return y


def dense_mlp(p: dict, x: torch.Tensor, prec: Prec):
    """The gated SiLU MLP: w_down(silu(w_gate x) * w_up x)."""
    h = F.silu(linear(x, p, prec, "w_gate")) * linear(x, p, prec, "w_up")
    return linear(h, p, prec, "w_down")


def rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * \
        scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, heads, dh], positions 0..S-1; rotate-half, angles computed
    in float64."""
    S, dh = x.shape[0], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float64,
                                        device=x.device) / dh))
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] \
        * inv
    sin, cos = torch.sin(ang).float()[:, None], torch.cos(ang).float()[
        :, None]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window, prec: Prec, q_chunk: int = 1024):
    """Causal GQA over one sequence: q [S,H,dh], k/v [S,KV,dh]; query
    head i reads KV head i // (H/KV)."""
    S, H, dh = q.shape
    group = H // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    q, k, v = prec.a(q), prec.a(k), prec.a(v)
    kt = k.permute(1, 2, 0)                                  # [H,dh,S]
    vh = v.permute(1, 0, 2)                                  # [H,S,dh]
    out = torch.empty_like(q)
    kpos = torch.arange(S, device=q.device)
    for a in range(0, S, q_chunk):
        b = min(S, a + q_chunk)
        s = torch.matmul(q[a:b].permute(1, 0, 2), kt) / math.sqrt(dh)
        diff = torch.arange(a, b, device=q.device)[:, None] - kpos[None]
        ok = diff >= 0
        if window:
            ok &= diff < window
        s = s.masked_fill(~ok, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[a:b] = torch.matmul(p, vh).permute(1, 0, 2)
    return out


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _decays(path: tuple) -> bool:
    return str(path[-1]) not in ("bias", "scale")


def lr_at(opt: dict, step: int) -> float:
    """The warmup-cosine learning rate at ``step`` (1-based)."""
    w, total = opt["warmup_steps"], opt["total_steps"]
    if step < w:
        return opt["lr"] * step / max(w, 1)
    t = min(max((step - w) / max(total - w, 1), 0.0), 1.0)
    r = opt["min_lr_ratio"]
    return opt["lr"] * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * t)))


def adamw_steps(loss_fn: Callable, params: dict, batches: list, opt: dict,
                num_micro: int, leaves_fn, quant: Optional[str] = None
                ) -> dict:
    """Run len(batches) AdamW steps from ``params`` (float32, updated in
    place), ``loss_fn(params, tokens, prec)`` the mean loss of one
    microbatch: the mean gradient over the microbatches, global-norm
    clipping, the warmup-cosine schedule, weight decay on every leaf but
    biases and scales. Returns each step's loss, the first step's clipped
    gradient per leaf (its norm) and the leaves' paths, in ``leaves_fn``
    order."""
    prec = Prec(quant)
    paths, leaves = zip(*leaves_fn(params))
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    losses, first_grad_norms = [], None
    b1, b2 = opt["b1"], opt["b2"]
    with exact_fp32():
        for step, tokens in enumerate(batches, start=1):
            grads = [torch.zeros_like(p) for p in leaves]
            loss_sum = 0.0
            for mb in tokens.chunk(num_micro):
                live = [p.detach().requires_grad_() for p in leaves]
                tree = _rebuild(params, paths, live)
                with torch.enable_grad():
                    loss = loss_fn(tree, mb, prec)
                gs = torch.autograd.grad(loss, live, allow_unused=True)
                for acc, g in zip(grads, gs):
                    if g is not None:
                        acc.add_(g)
                loss_sum += float(loss.detach())
                del live, tree, loss, gs
            for g in grads:
                g.div_(num_micro)
            losses.append(loss_sum / num_micro)
            gnorm = math.sqrt(sum(float((g * g).sum()) for g in grads))
            clip = opt.get("clip_norm")
            scale = min(1.0, clip / (gnorm + 1e-9)) if clip else 1.0
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            lr = lr_at(opt, step)
            if step == 1:
                first_grad_norms = [float((g * scale).norm()) for g in grads]
            with torch.no_grad():
                for path, p, g, mi, vi in zip(paths, leaves, grads, m, v):
                    g = g * scale
                    mi.mul_(b1).add_(g, alpha=1 - b1)
                    vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                    u = (mi / bc1) / (torch.sqrt(vi / bc2) + opt["eps"])
                    if opt["weight_decay"] and _decays(path):
                        u = u + opt["weight_decay"] * p
                    p.sub_(lr * u)
            del grads
    return {"losses": losses, "first_grad_norms": first_grad_norms,
            "paths": list(paths)}


def _rebuild(params, paths, live):
    """A tree like ``params`` with ``live`` at ``paths``."""
    tree = _shallow_copy(params)
    for path, leaf in zip(paths, live):
        node = tree
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = leaf
    return tree


def _shallow_copy(node):
    if isinstance(node, dict):
        return {k: _shallow_copy(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_shallow_copy(v) for v in node]
    return node
