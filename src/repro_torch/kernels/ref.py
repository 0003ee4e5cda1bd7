"""Plain PyTorch versions of the port's kernels (the contract).

Each function mirrors its kernel's exact semantics (masking, all-invalid
rows, accumulation dtypes) with straightforward tensor code, as
``repro.kernels.ref`` does for the Pallas kernels. The CPU tests hold the
port to the JAX package through these, ``tests/test_torch_gpu.py`` holds
the CUDA kernels to them on the card, and a kernel wrapper runs them for
a tensor that lies on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# Finite, as in the JAX package: a masked logit plus a real one never
# overflows, and exp(NEG_INF - m) is exactly 0 in fp32.
NEG_INF = -2.0 ** 30


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """One-token attention against a cache.

    q [B,H,dh]; k/v [B,L,KV,dh]; valid [B,L] bool -> [B,H,dh] in q's dtype.

    A row with no valid slot outputs zeros — the kernel's convention (its
    online-softmax accumulator never runs, so l=0 finalizes to 0), not the
    uniform-softmax mean a plain softmax over all-NEG_INF would give.
    """
    B, H, dh = q.shape
    KV = k.shape[2]
    sm_scale = sm_scale if sm_scale is not None else dh ** -0.5
    qg = q.float().reshape(B, KV, H // KV, dh)          # head h -> (h//G, h%G)
    logits = torch.einsum("bkgd,blkd->bkgl", qg, k.float()) * sm_scale
    mask = valid.bool()[:, None, None, :]
    logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    w = w * valid.bool().any(dim=-1)[:, None, None, None]
    out = torch.einsum("bkgl,blkd->bkgd", w, v.float())
    return out.reshape(B, H, dh).to(q.dtype)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, pages: torch.Tensor,
                           valid: torch.Tensor,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """One-token attention against a *paged* cache.

    q [B,H,dh]; k/v pages [P,ps,KV,dh]; pages [B,n] int32 (per-row page
    list); valid [B,n*ps] bool over *logical* slots -> [B,H,dh].

    Semantically: gather each row's pages into its logical [n*ps] cache
    view, then exactly ``decode_attention`` — including the all-invalid ->
    zeros contract.
    """
    B = q.shape[0]
    ps, KV, dh = k_pages.shape[1:]
    n = pages.shape[1]
    idx = pages.long()
    k = k_pages[idx].reshape(B, n * ps, KV, dh)
    v = v_pages[idx].reshape(B, n * ps, KV, dh)
    return decode_attention(q, k, v, valid, sm_scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Full-sequence GQA attention, the prefill kernel's contract.

    q [B,Sq,H,dh], k/v [B,Sk,KV,dh] (H % KV == 0) -> [B,Sq,H,dh] in q's
    dtype. Queries are right-aligned when Sq < Sk (query i sits at
    position i + Sk - Sq); logits are fp32 and masked with the finite
    NEG_INF; ``window`` keeps keys with 0 <= q_pos - k_pos < window.
    """
    ok = visible(q.shape[1], k.shape[1], causal, window, q.device)
    return masked_attention(q, k, v, ok, sm_scale)


def visible(Sq: int, Sk: int, causal: bool, window: Optional[int],
            device=None) -> torch.Tensor:
    """[Sq, Sk] bool: the keys each right-aligned query of
    ``flash_attention`` sees."""
    q_pos = torch.arange(Sq, device=device) + (Sk - Sq)
    k_pos = torch.arange(Sk, device=device)
    diff = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        ok &= diff >= 0
    if window is not None:
        ok &= diff < window
    return ok


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     ok: torch.Tensor,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """``flash_attention`` over an explicit [Sq, Sk] bool mask ``ok``."""
    return _masked_attention(q, k, v, ok, sm_scale)[0]


def _masked_attention(q, k, v, ok, sm_scale):
    """(``masked_attention``'s output, its fp32 masked logits)."""
    H, dh = q.shape[2], q.shape[3]
    KV = k.shape[2]
    sm_scale = sm_scale if sm_scale is not None else dh ** -0.5
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    logits = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * sm_scale
    logits = logits.masked_fill(~ok, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", w, v.float())
    return out.to(q.dtype), logits


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        sm_scale: Optional[float] = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward's contract: ``flash_attention``'s output and
    each row's log-sum-exp of its scaled visible logits, lse [B,H,Sq]
    fp32, which the backward pass reads."""
    ok = visible(q.shape[1], k.shape[1], causal, window, q.device)
    out, logits = _masked_attention(q, k, v, ok, sm_scale)
    return out, torch.logsumexp(logits, dim=-1)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, causal: bool = True,
                        window: Optional[int] = None,
                        sm_scale: Optional[float] = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' contract: (dq, dk, dv) of ``flash_attention``
    in the inputs' dtypes, from the forward's ``out`` and ``lse``:

        P = exp(scale q.k - lse), 0 where a key is not visible
        delta = rowsum(dout * out)
        dv = P^T dout,  dS = P (dout.v - delta)
        dq = scale dS k,  dk = scale dS^T q

    dk and dv summed over each KV head's query heads. Everything is fp32;
    P and dS are rounded to q's dtype where they enter a product, as the
    kernels round them (no rounding for float32 inputs)."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    sm_scale = sm_scale if sm_scale is not None else dh ** -0.5
    ok = visible(Sq, Sk, causal, window, q.device)
    qf, kf, vf = q.float(), k.float(), v.float()
    if G > 1:
        kf, vf = kf.repeat_interleave(G, dim=2), vf.repeat_interleave(G, dim=2)
    gf = dout.float()
    s = torch.einsum("bqhd,bshd->bhqs", qf, kf) * sm_scale
    p = torch.exp(s - lse[..., None]).masked_fill(~ok, 0.0)
    delta = (gf * out.float()).sum(-1).transpose(1, 2)          # [B,H,Sq]
    dp = torch.einsum("bqhd,bshd->bhqs", gf, vf)
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dv = torch.einsum("bhqs,bqhd->bshd", p.to(q.dtype).float(), gf)
    dq = torch.einsum("bhqs,bshd->bqhd", ds, kf) * sm_scale
    dk = torch.einsum("bhqs,bqhd->bshd", ds, qf) * sm_scale
    dk = dk.reshape(B, Sk, KV, G, dh).sum(3)
    dv = dv.reshape(B, Sk, KV, G, dh).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rglru_scan(a: torch.Tensor, x: torch.Tensor,
               h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential linear recurrence h_t = a_t h_{t-1} + x_t, in fp32.

    a/x [B,S,W], h0 [B,W] -> (y [B,S,W] in x's dtype, h_last [B,W] fp32).
    """
    af, xf = a.float(), x.float()
    h = h0.float()
    ys = torch.empty(af.shape, dtype=torch.float32, device=x.device)
    for t in range(x.shape[1]):
        h = af[:, t] * h + xf[:, t]
        ys[:, t] = h
    return ys.to(x.dtype), h


# Time steps whose discretised operands the plain selective scan forms at
# once: bounds its [B, chunk, Di, N] temporaries (at Falcon-Mamba-7B's
# Di 8192 and N 16, 128 MB each in fp32 per batch row).
SSM_CHUNK = 256


def ssm_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
             h0: torch.Tensor, elem_dtype: Optional[torch.dtype] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 selective scan, sequential over S, in fp32:

        h_t = exp(Δ_t ⊗ A) * h_{t-1} + (Δ_t u_t) ⊗ B_t
        y_t = Σ_n h_t C_t + D u_t

    u/delta [B,S,Di], A [Di,N], B/C [B,S,N], D [Di], h0 [B,Di,N] ->
    (y [B,S,Di] in u's dtype, h_last [B,Di,N] fp32).

    Each step multiplies and then adds, each rounded, and the sum over N
    folds halves pairwise (``_halving_sum``), as the kernel does, so the
    two can agree bit for bit. exp(Δ⊗A) and Δu⊗B are formed a chunk of
    steps at a time (the same elementwise products as one step at a
    time), so the loop itself is two launches per step. When a gradient
    is asked for, each step's state is a new tensor instead (autograd
    cannot differentiate ``out=`` and in-place steps): the same products
    and sums, so the same numbers. ``elem_dtype`` rounds exp(Δ⊗A) and
    Δu⊗B to that dtype first (``models.ssm.SCAN_DTYPE``; the kernel has
    no such rounding).
    """
    uf, df = u.float(), delta.float()
    Af, Bf, Cf, Df = A.float(), B.float(), C.float(), D.float()
    Bb, S, Di = u.shape
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (u, delta, A, B, C, D, h0))
    h = h0.float()
    y = torch.empty((Bb, S, Di), dtype=torch.float32, device=u.device)
    for s0 in range(0, S, SSM_CHUNK):
        s1 = min(S, s0 + SSM_CHUNK)
        dA = torch.exp(df[:, s0:s1, :, None] * Af)               # [B,c,Di,N]
        dBu = (df[:, s0:s1] * uf[:, s0:s1])[..., None] \
            * Bf[:, s0:s1, None, :]
        if elem_dtype is not None:
            dA, dBu = dA.to(elem_dtype).float(), dBu.to(elem_dtype).float()
        if grad:
            steps = []
            for t in range(s1 - s0):
                h = dA[:, t] * h + dBu[:, t]
                steps.append(h)
            hs = torch.stack(steps, dim=1)
        else:
            hs = torch.empty_like(dA)
            for t in range(s1 - s0):
                h = torch.mul(dA[:, t], h, out=hs[:, t])
                h.add_(dBu[:, t])
        y[:, s0:s1] = (_halving_sum(hs * Cf[:, s0:s1, None, :])
                       + Df * uf[:, s0:s1])
    return y.to(u.dtype), h.clone(memory_format=torch.contiguous_format)


def _halving_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim by adding its second half to its first until
    one entry is left: for N = 16, ((t0+t8)+(t4+t12)) + ... . This is the
    order of the kernel's reduce-scatter over a channel's N lanes (partner
    lanes n ^ N/2, then n ^ N/4, ...); an odd length carries its last
    entry to the next round."""
    while t.shape[-1] > 1:
        n = t.shape[-1]
        half = n // 2
        folded = t[..., :half] + t[..., half:2 * half]
        t = folded if n % 2 == 0 else torch.cat([folded, t[..., -1:]], -1)
    return t[..., 0]


# The dropless expert layer's pair-wise passes (``moe_pairs.cu``): the
# (token, choice) pairs sorted by held expert, the held ones first, and
# ends[-1] of them held. What these compute for the rows past ends[-1]
# the kernels leave unspecified.

def moe_held(pos: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """[N, K] bool: the choices held, those whose row ``pos`` [N, K] in
    the sorted order lies before ends[-1]."""
    return pos < ends[-1]


def moe_gather(x: torch.Tensor, tok: torch.Tensor,
               ends: torch.Tensor) -> torch.Tensor:
    """x [N, D], tok [M] -> x[tok] [M, D]: each pair's input row."""
    return x[tok]


def moe_swiglu(ab: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """ab = [a | b] [M, 2F] -> silu(a) * b [M, F], in fp32 and rounded
    once to ab's dtype."""
    a, b = ab.float().chunk(2, dim=-1)
    return (F.silu(a) * b).to(ab.dtype)


def moe_swiglu_bwd(dh: torch.Tensor, ab: torch.Tensor,
                   ends: torch.Tensor) -> torch.Tensor:
    """``moe_swiglu``'s gradient d[a | b] [M, 2F] from dh [M, F]: with
    s = sigmoid(a), da = dh b s (1 + a (1 - s)) and db = dh a s, in fp32
    and rounded once."""
    a, b = ab.float().chunk(2, dim=-1)
    g = dh.float()
    s = torch.sigmoid(a)
    da = (g * b) * (s * (1 + a * (1 - s)))
    return torch.cat([da, g * (a * s)], dim=-1).to(ab.dtype)


def moe_combine(ye: torch.Tensor, gate: Optional[torch.Tensor],
                pos: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """ye [M, D], gate [N, K] (None: every gate 1), pos [N, K] -> [N, D]:
    each token's held rows, selected (0 x NaN is NaN, and the rows past
    ends[-1] are unspecified), gated and summed over the choices in fp32,
    rounded once to ye's dtype. With unit gates, the gradient of
    ``moe_gather`` (each token's held pairs' rows, summed)."""
    zero = torch.zeros((), dtype=ye.dtype, device=ye.device)
    got = torch.where(moe_held(pos, ends)[..., None], ye[pos], zero)
    if gate is None:
        return got.float().sum(dim=1).to(ye.dtype)
    return (gate.float()[..., None] * got.float()).sum(dim=1).to(ye.dtype)


def moe_combine_bwd(dy: torch.Tensor, ye: torch.Tensor,
                    gate: Optional[torch.Tensor], pos: torch.Tensor,
                    ends: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``moe_combine``'s gradients from dy [N, D]: (dye [M, D], each held
    row gate x dy of its token and the rest 0; dgate [N, K], dy . ye of
    the choice's row, 0 where it is not held), in fp32 and rounded once to
    ye's and the gate's dtype."""
    held = moe_held(pos, ends)[..., None]
    zero = torch.zeros((), dtype=ye.dtype, device=ye.device)
    g = dy.float()[:, None, :]
    scaled = g if gate is None else gate.float()[..., None] * g
    dgot = torch.where(held, scaled.to(ye.dtype), zero)
    dye = torch.zeros_like(ye).index_put_((pos,), dgot, accumulate=True)
    got = torch.where(held, ye[pos], zero)
    dgate = (g * got.float()).sum(dim=-1)
    return dye, dgate.to(ye.dtype if gate is None else gate.dtype)
