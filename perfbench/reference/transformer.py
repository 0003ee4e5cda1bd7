"""The plain reference of the GQA transformer (``archs/transformer.py``):
its mathematics in float32 PyTorch, with TF32 off, and nothing of the
program (it imports neither ``repro_torch`` nor JAX). It reads weights
that the benchmark drew (``weights.py``) by the port's leaf names, and
tokens that the benchmark made or that the program served.

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
schedule, as the configuration's optimizer states (``common.py``)."""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from perfbench.reference.common import (Prec, adamw_steps, attention,
                                        dense_mlp, exact_fp32, linear,
                                        rms_norm, rope)


def attn_block(s: dict, p: dict, x: torch.Tensor, prec: Prec):
    S = x.shape[0]
    q = linear(x, p, prec, "wq").view(S, s["h"], s["dh"])
    k = linear(x, p, prec, "wk").view(S, s["kv"], s["dh"])
    v = linear(x, p, prec, "wv").view(S, s["kv"], s["dh"])
    q, k = rope(q, s["theta"]), rope(k, s["theta"])
    o = attention(q, k, v, s.get("window"), prec).reshape(S, -1)
    return linear(o, p, prec, "wo")


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


def train_steps(s: dict, params: dict, batches: list, opt: dict,
                num_micro: int, leaves_fn, quant: Optional[str] = None
                ) -> dict:
    """Run len(batches) AdamW steps of the next-token loss from
    ``params`` (``common.adamw_steps``)."""
    return adamw_steps(functools.partial(lm_loss, s), params, batches, opt,
                       num_micro, leaves_fn, quant)
