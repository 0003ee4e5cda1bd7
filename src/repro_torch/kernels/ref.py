"""Plain PyTorch versions of the decode-attention kernels (the contract).

Each function mirrors its kernel's exact semantics (masking, all-invalid
rows, accumulation dtypes) with straightforward tensor code, as
``repro.kernels.ref`` does for the Pallas kernels. The CPU tests hold the
port to the JAX package through these, ``chip_smoke.py`` holds the CUDA
kernels to them on the card, and a kernel wrapper runs them for a tensor
that lies on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

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
