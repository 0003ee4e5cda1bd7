"""The plain reference of Mellum2's decoder (``archs/mellum2.py``): its
mathematics in float32 PyTorch with TF32 off, and nothing of the
program (it imports neither ``repro_torch`` nor JAX). It reads weights
that the benchmark drew (``weights.py``) by the port's leaf names, and
the tokens that the training program was given.

A layer: x + attention(RMSNorm(x)), then + the sparse MLP of
RMSNorm(that). Attention is GQA over the layer's own RoPE: a sliding
layer rotates by theta and sees the last ``window`` positions; a full
layer rotates by YaRN's frequencies (Hugging Face's
``_compute_yarn_parameters``: theta's frequencies, the same divided by
``factor``, blended along a linear ramp between the pairs that turn
``beta_fast`` and ``beta_slow`` times over ``original_max_positions``,
the ramp's ends rounded outward), with cos and sin times
``attention_factor``, and sees every earlier position. The MLP's router
takes a softmax over all the experts, its top-k with ties to the lower
expert, and renormalises the k gates to sum to 1; each held expert is a
SwiGLU, w_down(silu(w_gate x) * w_up x), computed for every token that
chose it, with no capacity; experts not held are left out, so the MLP
gives this device's share of the layer.

Departures from the published model, which the program shares:
- only the held experts' share of each MLP (one chip of an 8-way expert
  parallel deployment, without the exchange) and the first rows of the
  vocabulary (``vocab_size``), as the configuration states;
- the training loss adds the Switch load-balance term of every layer,
  coefficient x E x sum_e f_e P_e over that layer's tokens (f_e the share
  of tokens that chose e, P_e its mean probability), where Hugging
  Face's sums f and P over the layers first; the coefficient, 0.001, is
  assumed (the config names none);
- no q/k norm (the config names none), no MTP head (it declares none).

``quant="fp8"`` is the control: every matrix product's operands rounded
to float8 e4m3 (per output channel for weights, per token for
activations, per position and head for q, k, v). Training: the
next-token loss over each microbatch, its gradient by autograd, global
norm clipping and AdamW (``common.py``), each layer recomputed in the
backward pass (``torch.utils.checkpoint``: the same float32 numbers, at
a layer's activations instead of the stack's)."""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from perfbench.reference.common import (Prec, adamw_steps, attention,
                                        linear, rms_norm, rope)


def yarn_inv_freq(dh: int, y: dict) -> torch.Tensor:
    """YaRN's inverse frequencies [dh/2] in float64."""
    theta = y["theta"]
    pair = torch.arange(0, dh, 2, dtype=torch.float64) / dh
    extrapolated = 1.0 / theta ** pair
    interpolated = extrapolated / y["factor"]

    def at(rotations):
        return (dh * math.log(y["original_max_positions"]
                              / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    low = max(math.floor(at(y["beta_fast"])), 0)
    high = min(math.ceil(at(y["beta_slow"])), dh - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dh // 2, dtype=torch.float64) - low)
            / (high - low)).clamp(0, 1)
    return interpolated * ramp + extrapolated * (1 - ramp)


def rope_yarn(x: torch.Tensor, y: dict) -> torch.Tensor:
    """x [S, heads, dh] at positions 0..S-1, rotate-half, by YaRN's
    frequencies, cos and sin times the attention factor; angles in
    float64."""
    S, dh = x.shape[0], x.shape[-1]
    inv = yarn_inv_freq(dh, y).to(x.device)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] \
        * inv
    a = y["attention_factor"]
    sin = (torch.sin(ang) * a).float()[:, None]
    cos = (torch.cos(ang) * a).float()[:, None]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attn_block(s: dict, kind: str, p: dict, x: torch.Tensor, prec: Prec):
    """One sequence x [S, d] through a layer's attention."""
    S = x.shape[0]
    q = linear(x, p, prec, "wq").view(S, s["h"], s["dh"])
    k = linear(x, p, prec, "wk").view(S, s["kv"], s["dh"])
    v = linear(x, p, prec, "wv").view(S, s["kv"], s["dh"])
    if kind == "swa":
        q, k = rope(q, s["theta"]), rope(k, s["theta"])
        window = s["window"]
    else:
        q, k = rope_yarn(q, s["yarn"]), rope_yarn(k, s["yarn"])
        window = None
    o = attention(q, k, v, window, prec).reshape(S, -1)
    return linear(o, p, prec, "wo")


def route(s: dict, p: dict, x: torch.Tensor, prec: Prec):
    """(probs [T, E], the top-k experts [T, k], their gates [T, k])."""
    probs = torch.softmax(prec.a(x) @ prec.w(p["router"]["kernel"]), -1)
    top = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :s["top_k"]]
    gates = torch.gather(probs, -1, top)
    if s["norm_topk"]:
        gates = gates / gates.sum(-1, keepdim=True)
    return probs, top, gates


def held_mlp(s: dict, p: dict, x: torch.Tensor, prec: Prec):
    """x [T, d] -> (the held experts' share of the MLP [T, d], the
    layer's load-balance term)."""
    probs, top, gates = route(s, p, x, prec)
    lo, hi = s["held"]
    out = torch.zeros_like(x)
    for e in range(lo, hi):
        tok, k = torch.nonzero(top == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = prec.a(x[tok])
        h = (F.silu(xe @ prec.w(p["w_gate"][e - lo]))
             * (xe @ prec.w(p["w_up"][e - lo])))
        y = prec.a(h) @ prec.w(p["w_down"][e - lo])
        out = out.index_add(0, tok, gates[tok, k, None] * y)
    chose = torch.zeros_like(probs).scatter_(-1, top, 1.0)
    aux = (s["router_aux_loss"] * s["experts"]
           * torch.sum(chose.mean(0) * probs.mean(0)))
    return out, aux


def layer(s: dict, kind: str, p: dict, x: torch.Tensor, prec: Prec):
    """x [B, S, d] -> (x after the layer, its load-balance term over the
    B x S tokens)."""
    h = torch.stack([xb + attn_block(s, kind, p["attn"], rms_norm(
        xb, p["norm"]["scale"], s["eps"]), prec) for xb in x])
    g = rms_norm(h, p["mlp_norm"]["scale"], s["eps"])
    m, aux = held_mlp(s, p["mlp"], g.reshape(-1, s["d"]), prec)
    return h + m.view_as(h), aux


def lm_loss(s: dict, params: dict, tokens: torch.Tensor,
            prec: Prec) -> torch.Tensor:
    """Mean next-token cross entropy of ``tokens`` [B, S] plus every
    layer's load-balance term."""
    x = params["embed"]["tokens"][tokens.long()].float()
    aux = torch.zeros((), device=x.device)
    for i, kind in enumerate(s["kinds"]):
        p = params["blocks"][i // 4][str(i % 4)]
        x, a = torch.utils.checkpoint.checkpoint(
            layer, s, kind, p, x, prec, use_reentrant=False)
        aux = aux + a
    hid = rms_norm(x, params["final_norm"]["scale"], s["eps"])
    head = (params["embed"]["tokens"].T if s["tie"] else
            params["embed"]["head"]["kernel"])
    logits = prec.a(hid[:, :-1]) @ prec.w(head)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         tokens[:, 1:].reshape(-1).long())
    return ce + aux


def train_steps(s: dict, params: dict, batches: list, opt: dict,
                num_micro: int, leaves_fn, quant: Optional[str] = None
                ) -> dict:
    """Run len(batches) AdamW steps of the loss from ``params``
    (``common.adamw_steps``)."""
    return adamw_steps(functools.partial(lm_loss, s), params, batches, opt,
                       num_micro, leaves_fn, quant)
