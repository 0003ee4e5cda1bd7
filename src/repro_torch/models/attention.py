"""GQA self-attention (global / sliding-window / local), the single-token
decode path against a KV cache (flat ring or paged pool), and chunked
prefill — the port of ``repro.models.attention`` for attention-only
stacks.

The plain attention matrix products stay ``torch.einsum`` (the JAX
package leaves them to XLA). Decode attention's leaf is switchable:
``"flash"`` hands q and the ring ``valid`` mask to the flash-decode CUDA
kernels' wrappers in ``kernels.decode_attention`` (which run the plain
version only for a CPU tensor);
``"dense"`` is the grouped einsum ``_sdpa_grouped``; ``"auto"`` means
flash on a CUDA device — the counterpart of "flash on TPU" in the JAX
package.

Cache updates are written in place (one slot per row with an indexed
store) where the JAX package returns a new array; the numbers are
identical, and the functions still return the cache for symmetry.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as flash_decode
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

NEG_INF = -2.0 ** 30

# Query-chunk size of the full-sequence path: bounds the materialized
# [B, H, Qc, S] logits once S > 2 * Q_CHUNK.
Q_CHUNK = 2048


def init_attention(cfg: ModelConfig, gen, device, dtype) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": layers.init_linear(gen, d, h * dh, device, dtype,
                                 bias=cfg.qkv_bias),
        "wk": layers.init_linear(gen, d, kv * dh, device, dtype,
                                 bias=cfg.qkv_bias),
        "wv": layers.init_linear(gen, d, kv * dh, device, dtype,
                                 bias=cfg.qkv_bias),
        "wo": layers.init_linear(gen, h * dh, d, device, dtype,
                                 scale=(h * dh) ** -0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.ones((dh,), device=device)}
        p["k_norm"] = {"scale": torch.ones((dh,), device=device)}
    return p


def _headwise_rms(x: torch.Tensor, scale: torch.Tensor,
                  eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * scale).to(dt)


def _project_qkv(cfg: ModelConfig, p: dict, xq: torch.Tensor,
                 xkv: torch.Tensor):
    B, Sq = xq.shape[:2]
    Skv = xkv.shape[1]
    q = layers.apply_linear(p["wq"], xq).reshape(B, Sq, cfg.num_heads,
                                                 cfg.head_dim)
    k = layers.apply_linear(p["wk"], xkv).reshape(B, Skv, cfg.num_kv_heads,
                                                  cfg.head_dim)
    v = layers.apply_linear(p["wv"], xkv).reshape(B, Skv, cfg.num_kv_heads,
                                                  cfg.head_dim)
    if cfg.qk_norm:
        q = _headwise_rms(q, p["q_norm"]["scale"], cfg.norm_eps)
        k = _headwise_rms(k, p["k_norm"]["scale"], cfg.norm_eps)
    return q, k, v


def _rope(cfg: ModelConfig, pos: torch.Tensor, *xs):
    if not cfg.rope:
        return xs
    sin, cos = layers.rope_freqs(cfg, pos)
    return tuple(layers.apply_rope(x, sin, cos) for x in xs)


def _window(cfg: ModelConfig, kind: str) -> Optional[int]:
    return cfg.window if kind in ("swa", "local") else None


def _mask_bias(cfg: ModelConfig, q_pos: torch.Tensor, k_pos: torch.Tensor,
               causal: bool, window: Optional[int]) -> torch.Tensor:
    """[.., Sq, Sk] additive fp32 mask from absolute positions."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok &= diff >= 0
    if window is not None:
        ok &= diff < window
    return _bias(ok)


def _bias(ok: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _sdpa(cfg: ModelConfig, q, k, v, bias) -> torch.Tensor:
    """q [B,Sq,H,dh], k/v [B,Sk,KV,dh], bias [B,1,Sq,Sk] fp32.

    KV heads are expanded to the query-head count. Logits are accumulated
    and kept in fp32 (the JAX einsum's ``preferred_element_type``);
    softmax weights go back to q's dtype for the value product.
    """
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    logits = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float())
    logits = logits * (dh ** -0.5)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    logits = logits + bias
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", w, v)


def self_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                   positions: torch.Tensor, kind: str,
                   return_kv: bool = False):
    """Full-sequence self-attention (prefill). Dense up to 2*Q_CHUNK
    tokens; above that, query chunks run one after another so only one
    chunk's logits exist at a time (windowed attention slices K/V to the
    reachable band, causal full attention keeps full-length K)."""
    causal = cfg.causal
    window = _window(cfg, kind)
    q, k, v = _project_qkv(cfg, p, x, x)
    q, k = _rope(cfg, positions, q, k)
    B, S = x.shape[:2]
    if S <= 2 * Q_CHUNK:
        bias = _mask_bias(cfg, positions, positions, causal, window)[:, None]
        out = _sdpa(cfg, q, k, v, bias)
    else:
        if S % Q_CHUNK:
            raise ValueError(f"sequence {S} is not a multiple of the query "
                             f"chunk {Q_CHUNK}")
        klen = min(S, window + Q_CHUNK) if window is not None else S
        ar = torch.arange(Q_CHUNK, dtype=torch.int32, device=x.device)
        chunks = []
        for q0 in range(0, S, Q_CHUNK):
            k0 = 0 if klen == S else max(q0 + Q_CHUNK - klen, 0)
            q_pos = (q0 + ar)[None]
            k_pos = (k0 + torch.arange(klen, dtype=torch.int32,
                                       device=x.device))[None]
            bias = _mask_bias(cfg, q_pos, k_pos, causal, window)[:, None]
            chunks.append(_sdpa(cfg, q[:, q0:q0 + Q_CHUNK],
                                k[:, k0:k0 + klen], v[:, k0:k0 + klen],
                                bias))
        out = torch.cat(chunks, dim=1)
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    out = layers.apply_linear(p["wo"], out)
    if return_kv:
        return out, (k, v)
    return out


def _ring_len(cfg: ModelConfig, context_len: int, kind: str) -> int:
    window = _window(cfg, kind)
    return min(context_len, window) if window else context_len


def build_cache_from_full(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
                          context_len: int, kind: str, dtype) -> dict:
    """Scatter full-sequence K/V (prefill) into the ring-cache layout."""
    B, S = k.shape[:2]
    L = _ring_len(cfg, context_len, kind)
    keep = min(S, L)
    slots = torch.remainder(torch.arange(S - keep, S, device=k.device), L)
    shape = (B, L, cfg.num_kv_heads, cfg.head_dim)
    ck = torch.zeros(shape, dtype=dtype, device=k.device)
    cv = torch.zeros(shape, dtype=dtype, device=k.device)
    ck[:, slots] = k[:, S - keep:].to(dtype)
    cv[:, slots] = v[:, S - keep:].to(dtype)
    return {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# Decode path: one new token against a (possibly windowed) KV cache
# ---------------------------------------------------------------------------

def kv_cache_shape(cfg: ModelConfig, batch: int, context_len: int,
                   kind: str) -> tuple:
    return (batch, _ring_len(cfg, context_len, kind), cfg.num_kv_heads,
            cfg.head_dim)


def init_kv_cache(cfg: ModelConfig, batch: int, context_len: int,
                  kind: str, dtype, device) -> dict:
    """Cache for one attention layer. SWA/local keep only a window ring."""
    shape = kv_cache_shape(cfg, batch, context_len, kind)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_kv_cache_shape(cfg: ModelConfig, num_pages: int,
                         page_size: int) -> tuple:
    """Pooled cache for one full-context attention layer; physical page 0
    is the trash page by convention."""
    return (num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)


def _positions(t, B: int, device) -> torch.Tensor:
    """Per-row absolute positions [B] int32 from a scalar or [B] ``t``."""
    tb = torch.as_tensor(t, device=device).to(torch.int32)
    return tb.expand(B) if tb.dim() == 0 else tb


def _resolve_impl(impl: str, x: torch.Tensor) -> str:
    if impl not in ("auto", "dense", "flash"):
        raise ValueError(f"impl must be auto|dense|flash, got {impl!r}")
    if impl == "auto":
        return "flash" if x.device.type == "cuda" else "dense"
    return impl


def _kernel_kv(k: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """K/V as the kernel should read them. The JAX package casts them to
    q's dtype first; a bf16 cache under fp32 compute widens exactly, and
    the kernel reads mixed dtypes, so only a narrowing cast is made."""
    if k.dtype == q.dtype or k.dtype == torch.bfloat16:
        return k
    return k.to(q.dtype)


def _flash_decode_eligible(cfg: ModelConfig) -> bool:
    """The flash-decode kernel has no softcap."""
    return not cfg.logit_softcap


def paged_decode_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                           cache: dict, t, pages: torch.Tensor,
                           impl: str = "auto"):
    """Single-token decode against a *paged* KV pool (full-context ATTN
    layers only).

    x [B,1,D]; cache {"k"/"v": [P, ps, KV, dh]} shared pool; ``pages``
    [B, n] int32 maps each row's logical page j to a physical page. The
    ring modulus is L = n*ps >= context_len, so positions never wrap.
    The new token's K/V land in physical page ``pages[b, t//ps]`` at
    offset ``t%ps`` (written in place; rows pointing at the trash page
    write garbage only garbage reads see). Returns (attn out [B,1,D],
    cache).
    """
    B = x.shape[0]
    ps = cache["k"].shape[1]
    n = pages.shape[1]
    L = n * ps
    tb = _positions(t, B, x.device)

    q, k_new, v_new = _project_qkv(cfg, p, x, x)
    q, k_new = _rope(cfg, tb[:, None], q, k_new)

    slot = torch.remainder(tb, L)                              # [B] logical
    rows = torch.arange(B, device=x.device)
    pid = pages[rows, (slot // ps).long()].long()              # [B] physical
    off = (slot % ps).long()
    k, v = cache["k"], cache["v"]
    k[pid, off] = k_new[:, 0].to(k.dtype)
    v[pid, off] = v_new[:, 0].to(v.dtype)

    # Same ring-position validity as the flat path, over logical slots.
    idx = torch.arange(L, dtype=torch.int32, device=x.device)[None, :]
    k_pos = tb[:, None] - torch.remainder(tb[:, None] - idx, L)
    valid = k_pos >= 0

    impl = _resolve_impl(impl, x)
    if impl == "flash" and _flash_decode_eligible(cfg):
        out = flash_decode.paged_decode_attention(
            q[:, 0], _kernel_kv(k, q), _kernel_kv(v, q),
            pages.to(torch.int32).contiguous(), valid)
        out = out[:, None]                                     # [B,1,H,dh]
    else:
        idxp = pages.long()
        kg = k[idxp].reshape(B, L, *k.shape[2:]).to(q.dtype)
        vg = v[idxp].reshape(B, L, *v.shape[2:]).to(q.dtype)
        bias = _bias(valid)[:, None, None, :]                  # [B,1,1,L]
        out = _sdpa_grouped(cfg, q, kg, vg, bias)
    out = out.reshape(B, 1, cfg.num_heads * cfg.head_dim)
    return layers.apply_linear(p["wo"], out), cache


def _sdpa_grouped(cfg: ModelConfig, q, k, v, bias) -> torch.Tensor:
    """GQA attention without KV expansion — the decode path's dense leaf.
    Logits are formed in q's dtype and then widened to fp32, as in the
    JAX package."""
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    q = q.reshape(B, Sq, KV, G, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q, k).float()
    logits = logits * (dh ** -0.5)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    logits = logits + bias[:, :, None, :, :]
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(B, Sq, H, dh)


def decode_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     cache: dict, t, kind: str, impl: str = "auto"):
    """x [B,1,D]; ``t`` is the absolute position of the new token — a
    scalar (all rows in lockstep) or a ``[B]`` vector (continuous
    batching). The cache ring-buffers the last L tokens (L = full context
    or the SWA window); slots past a row's own ``t`` are masked invalid by
    the ring-position arithmetic. Returns (attn output [B,1,D], cache).
    """
    B = x.shape[0]
    L = cache["k"].shape[1]
    window = _window(cfg, kind)
    tb = _positions(t, B, x.device)

    q, k_new, v_new = _project_qkv(cfg, p, x, x)
    q, k_new = _rope(cfg, tb[:, None], q, k_new)

    # One slot per row, written in place. (The JAX package rewrites the
    # whole ring with a mask-select to keep a TP-sharded cache local; the
    # numbers are identical.)
    slot = torch.remainder(tb, L).long()
    rows = torch.arange(B, device=x.device)
    k, v = cache["k"], cache["v"]
    k[rows, slot] = k_new[:, 0].to(k.dtype)
    v[rows, slot] = v_new[:, 0].to(v.dtype)

    # Absolute position of every cache slot given the ring layout: slot i
    # holds the most recent token congruent to i mod L that is <= t.
    idx = torch.arange(L, dtype=torch.int32, device=x.device)[None, :]
    k_pos = tb[:, None] - torch.remainder(tb[:, None] - idx, L)
    valid = k_pos >= 0
    if window is not None:
        valid &= (tb[:, None] - k_pos) < window

    impl = _resolve_impl(impl, x)
    if impl == "flash" and _flash_decode_eligible(cfg):
        out = flash_decode.decode_attention(q[:, 0], _kernel_kv(k, q),
                                            _kernel_kv(v, q), valid)
        out = out[:, None]                                     # [B,1,H,dh]
    else:
        bias = _bias(valid)[:, None, None, :]                  # [B,1,1,L]
        out = _sdpa_grouped(cfg, q, k.to(q.dtype), v.to(q.dtype), bias)
    out = out.reshape(B, 1, cfg.num_heads * cfg.head_dim)
    return layers.apply_linear(p["wo"], out), cache


def extend_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     cache: dict, t0, kind: str):
    """Chunked-prefill attention: extend a ring cache by ``C`` prompt
    tokens at positions ``t0 .. t0+C-1`` in one pass.

    Queries attend over the concatenation of the existing cache slots and
    the chunk's own keys, with per-query position masks; the chunk is
    scattered into the ring only afterwards (writing first would attend
    fresh keys where history should be once the ring is full). Requires
    C <= L. Returns (attn output [B,C,D], cache).
    """
    B, C = x.shape[:2]
    L = cache["k"].shape[1]
    window = _window(cfg, kind)
    if C > L:
        raise ValueError(f"prefill chunk ({C}) exceeds the cache ring ({L})")

    tb = _positions(t0, B, x.device)
    q, k_new, v_new = _project_qkv(cfg, p, x, x)
    pos = tb[:, None] + torch.arange(C, dtype=torch.int32,
                                     device=x.device)[None, :]    # [B,C]
    q, k_new = _rope(cfg, pos, q, k_new)

    # Absolute position of each existing slot before this chunk lands; at
    # t0=0 every one is negative -> fully masked.
    last = tb[:, None] - 1                                        # [B,1]
    idx = torch.arange(L, dtype=torch.int32, device=x.device)[None, :]
    k_pos_old = last - torch.remainder(last - idx, L)             # [B,L]
    diff_old = pos[:, :, None] - k_pos_old[:, None, :]            # [B,C,L]
    ok_old = (k_pos_old[:, None, :] >= 0).expand(diff_old.shape)
    if window is not None:
        ok_old = ok_old & (diff_old < window)
    diff_new = pos[:, :, None] - pos[:, None, :]                  # [B,C,C]
    ok_new = diff_new >= 0
    if window is not None:
        ok_new = ok_new & (diff_new < window)
    ok = torch.cat([ok_old, ok_new], dim=-1)                      # [B,C,L+C]
    bias = _bias(ok)[:, None]

    ck, cv = cache["k"], cache["v"]
    k_all = torch.cat([ck.to(q.dtype), k_new], dim=1)
    v_all = torch.cat([cv.to(q.dtype), v_new], dim=1)
    out = _sdpa(cfg, q, k_all, v_all, bias)
    out = out.reshape(B, C, cfg.num_heads * cfg.head_dim)

    slots = torch.remainder(pos, L).long()                        # [B,C]
    bidx = torch.arange(B, device=x.device)[:, None]
    ck[bidx, slots] = k_new.to(ck.dtype)
    cv[bidx, slots] = v_new.to(cv.dtype)
    return layers.apply_linear(p["wo"], out), cache
