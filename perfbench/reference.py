"""The plain reference: the configuration's mathematics in float32
PyTorch, with TF32 off, and nothing of the program (it imports neither
``repro_torch`` nor JAX). It reads weights that the benchmark drew
(``weights.py``) by the port's leaf names, and tokens that the benchmark
made or that the program served.

Serving: one forward over prompt and served tokens, layer by layer over
every sampled sequence, so that a layer's weights are cast to float32
once and the model need not fit in float32. The MoE routes as the
configuration states: softmax over the router's logits, the top-k with
ties to the lower expert, gates renormalised over the top-k, then each
expert's capacity C = max(int(factor * k * S / E), 1) over the S tokens
that one engine call routes together (a prefill or one chunk of it; a
decode step routes each row's one token alone), tokens past C in
sequence order losing that expert. ``quant="fp8"`` is the control: every
matrix product's operands rounded to float8 e4m3 (per output channel for
weights, per token for activations, per position and head for q, k, v).

Training: the next-token loss over each microbatch, its gradient by
autograd, global-norm clipping, and AdamW with the warmup-cosine
schedule, as the configuration's optimizer states."""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

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


def _linear(x, p: dict, prec: Prec, name: str):
    y = prec.a(x) @ prec.w(p[name]["kernel"])
    if "bias" in p[name]:
        y = y + p[name]["bias"].float()
    return y


def attn_block(s: dict, p: dict, x: torch.Tensor, prec: Prec):
    S = x.shape[0]
    q = _linear(x, p, prec, "wq").view(S, s["h"], s["dh"])
    k = _linear(x, p, prec, "wk").view(S, s["kv"], s["dh"])
    v = _linear(x, p, prec, "wv").view(S, s["kv"], s["dh"])
    q, k = rope(q, s["theta"]), rope(k, s["theta"])
    o = attention(q, k, v, s.get("window"), prec).reshape(S, -1)
    return _linear(o, p, prec, "wo")


def dense_mlp(p: dict, x: torch.Tensor, prec: Prec):
    h = F.silu(_linear(x, p, prec, "w_gate")) * _linear(x, p, prec, "w_up")
    return _linear(h, p, prec, "w_down")


def route(s: dict, logits: torch.Tensor, segments) -> torch.Tensor:
    """Gates [S, E] from router logits [S, E]: top-k, renormalised, zero
    where the expert's capacity in the token's segment is spent."""
    E, K = s["experts"], s["top_k"]
    probs = torch.softmax(logits, dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    mask = torch.zeros_like(probs).scatter_(-1, idx[:, :K], 1.0)
    gates = probs * mask
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    if s["capacity_factor"]:
        keep = torch.zeros_like(mask, dtype=torch.bool)
        for a, b in segments:
            cap = max(int(s["capacity_factor"] * K * (b - a) / E), 1)
            pos = torch.cumsum(mask[a:b], dim=0) * mask[a:b] - 1.0
            keep[a:b] = (pos >= 0) & (pos < cap)
        gates = torch.where(keep, gates, torch.zeros_like(gates))
    return gates


def moe_mlp(s: dict, p: dict, x: torch.Tensor, segments, prec: Prec):
    gates = route(s, prec.a(x) @ prec.w(p["router"]["kernel"]), segments)
    out = torch.zeros_like(x)
    for e in range(s["experts"]):
        rows = torch.nonzero(gates[:, e] > 0).flatten()
        if rows.numel() == 0:
            continue
        xe = prec.a(x[rows])
        h = F.silu(xe @ prec.w(p["w_gate"][e])) * (xe @ prec.w(p["w_up"][e]))
        out[rows] += gates[rows, e:e + 1] * (prec.a(h) @ prec.w(
            p["w_down"][e]))
    return out


def serve_segments(prompt_len: int, total: int, chunk: Optional[int]):
    """The engine's calls over one request's positions: the prompt whole,
    or in ``chunk``-long pieces when it is longer than ``chunk``; then
    every later position alone (a decode step)."""
    if chunk and prompt_len > chunk:
        segs = [(a, min(a + chunk, prompt_len))
                for a in range(0, prompt_len, chunk)]
    else:
        segs = [(0, prompt_len)]
    return segs + [(t, t + 1) for t in range(prompt_len, total)]


@torch.no_grad()
def serve_logits(s: dict, params: dict, seqs: list, chunk: Optional[int],
                 device, quant: Optional[str] = None) -> list:
    """For each (tokens, prompt_len) in ``seqs``: float32 logits
    [n_served, V] at the positions that predicted each served token
    (prompt_len - 1 .. len - 2)."""
    prec = Prec(quant)
    with exact_fp32():
        emb = params["embed"]["tokens"]
        xs = [emb[torch.as_tensor(np.asarray(t[:-1], np.int64),
                                  device=device)].float()
              for t, _ in seqs]
        segs = [serve_segments(n, len(t) - 1, chunk) for t, n in seqs]
        for lp in params["blocks"]:
            p = lp["0"]
            for i, x in enumerate(xs):
                h = x + attn_block(s, p["attn"], rms_norm(
                    x, p["norm"]["scale"], s["eps"]), prec)
                g = rms_norm(h, p["mlp_norm"]["scale"], s["eps"])
                m = (moe_mlp(s, p["mlp"], g, segs[i], prec) if s["experts"]
                     else dense_mlp(p["mlp"], g, prec))
                xs[i] = h + m
        head = (emb.float().T if s["tie"] else
                params["embed"]["head"]["kernel"].float())
        head = prec.w(head)
        out = []
        for x, (t, n) in zip(xs, seqs):
            hid = rms_norm(x[n - 1:], params["final_norm"]["scale"],
                           s["eps"])
            out.append(prec.a(hid) @ head)
        return out


def served_gaps(s: dict, params: dict, seqs: list, chunk, device) -> list:
    """Per sequence, the gap by which each served token's reference logit
    lies below the reference's best at that position."""
    out = []
    for (t, n), lg in zip(seqs, serve_logits(s, params, seqs, chunk, device)):
        tok = torch.as_tensor(np.asarray(t[n:], np.int64), device=lg.device)
        out.append((lg.max(-1).values - lg.gather(-1, tok[:, None])[:, 0])
                   .cpu().numpy())
    return out


def control_gaps(s: dict, params: dict, seqs: list, chunk, device) -> list:
    """The control: at each position of the same sequences, the reference's
    gap for the token that the fp8 forward puts first."""
    ref = serve_logits(s, params, seqs, chunk, device)
    low = serve_logits(s, params, seqs, chunk, device, quant="fp8")
    out = []
    for r, q in zip(ref, low):
        pick = q.argmax(-1, keepdim=True)
        out.append((r.max(-1).values - r.gather(-1, pick)[:, 0]).cpu()
                   .numpy())
    return out


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def lm_loss(s: dict, params: dict, tokens: torch.Tensor,
            prec: Prec) -> torch.Tensor:
    """Mean next-token cross entropy of ``tokens`` [B, S] (dense models)."""
    if s["experts"]:
        raise NotImplementedError("the training reference is dense only")
    B, S = tokens.shape
    x = params["embed"]["tokens"][tokens.long()].float()
    outs = []
    for b in range(B):
        xb = x[b]
        for lp in params["blocks"]:
            # Recomputed in the backward pass: the same float32 numbers,
            # at a layer's activations instead of the stack's.
            xb = torch.utils.checkpoint.checkpoint(
                _dense_layer, s, lp["0"], xb, prec, use_reentrant=False)
        outs.append(xb)
    hid = rms_norm(torch.stack(outs), params["final_norm"]["scale"],
                   s["eps"])
    head = (params["embed"]["tokens"].T if s["tie"] else
            params["embed"]["head"]["kernel"])
    logits = prec.a(hid[:, :-1]) @ prec.w(head)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1).long())


def _dense_layer(s: dict, p: dict, x: torch.Tensor, prec: Prec):
    h = x + attn_block(s, p["attn"], rms_norm(x, p["norm"]["scale"],
                                              s["eps"]), prec)
    return h + dense_mlp(p["mlp"], rms_norm(h, p["mlp_norm"]["scale"],
                                            s["eps"]), prec)


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


def train_steps(s: dict, params: dict, batches: list, opt: dict,
                num_micro: int, leaves_fn, quant: Optional[str] = None
                ) -> dict:
    """Run len(batches) AdamW steps from ``params`` (float32, updated in
    place). Returns each step's loss, the first step's clipped gradient
    per leaf (its norm) and the leaves' paths, in ``leaves_fn`` order."""
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
                    loss = lm_loss(s, tree, mb, prec)
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
