"""GQA self-attention (global / sliding-window / local / bidirectional),
cross-attention to frontend memory, the single-token decode path against
a KV cache (flat ring or paged pool) or the stored cross memory, and
chunked prefill — the port of ``repro.models.attention``.

The plain attention matrix products stay ``torch.einsum`` (the JAX
package leaves them to XLA). Prefill and decode attention take an
``impl`` leaf switch: ``"flash"`` hands q, K/V and the mask to the CUDA
kernels' wrappers — ``kernels.flash_attention`` for a whole sequence,
``kernels.decode_attention`` for one token against the ring's ``valid``
mask (an all-true one over the cross memory) — which run their plain
version only for a CPU tensor; ``"dense"`` is the einsum path
(``_sdpa`` / ``_sdpa_grouped``), the parity reference; ``"auto"`` means
flash on a CUDA device — the counterpart of
"flash on TPU" in the JAX package. Softcapped configs always take the
dense path (the kernels have no softcap).

``"train"`` is the gradient pass's route (``train_step.make_loss_fn``):
full-sequence self- and cross-attention take the differentiable flash
entry (``flash_attention.flash_attention_train``) where the input allows
it (``_flash_grad_eligible``: a plain CUDA tensor, not a DTensor, in
bf16, no softcap, a head dim the backward kernels take), else the dense
path; the scans take their plain route. Each such call bumps the
process counter ``train.attn.flash`` or ``train.attn.dense``.

Cache updates are written in place (one slot per row with an indexed
store) where the JAX package returns a new array; the numbers are
identical, and the functions still return the cache for symmetry.

Under a sharding context (``sharding.use_sharding``) the tensors are
DTensors and the JAX package's ``shard`` constraints place them: q/k/v
over the batch and the (padded) heads, the cache over the batch and its
KV heads or its length. A projection's output is gathered over TP before
it is split into heads when the heads do not divide the TP width
(``_split_heads``: DTensor cannot unflatten a dim sharded across head
boundaries). Without a context each of these is a no-op.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core import telemetry
from repro_torch.kernels import _shards
from repro_torch.kernels import decode_attention as flash_decode
from repro_torch.kernels import flash_attention as flash_prefill
from repro_torch.models import layers
from repro_torch.models.config import ATTN, ModelConfig
from repro_torch.sharding import current_ctx, shard

NEG_INF = -2.0 ** 30


def _tp_size() -> int:
    ctx = current_ctx()
    return ctx.size("tp") if ctx is not None else 1


def _pad_heads(x: torch.Tensor, hp: int) -> torch.Tensor:
    """Zero-pad the head dim (axis 2) to ``hp`` heads."""
    pad = hp - x.shape[2]
    if pad == 0:
        return x
    return _shards.pad(x, (0, 0, 0, pad))


def _repeat_heads(k: torch.Tensor, group: int) -> torch.Tensor:
    """[B,S,KV,dh] -> [B,S,KV*group,dh], each KV head ``group`` times in
    a row (``repeat_interleave``, written as expand + reshape)."""
    B, S, KV, dh = k.shape
    return k[:, :, :, None, :].expand(B, S, KV, group, dh).reshape(
        B, S, KV * group, dh)


def _heads_over_tp(q, k, v, keep_groups: bool):
    """q/k/v laid out over the TP axis as the JAX package's ``_sdpa``
    lays them out: KV heads repeated to the query heads, heads
    zero-padded to a multiple of TP, then sharded (batch over DP, heads
    over TP). ``keep_groups`` keeps the KV heads grouped when they split
    evenly over TP (the kernels take GQA); the dense path always repeats
    them. Returns (q, k, v, H)."""
    H, KV = q.shape[2], k.shape[2]
    tp = _tp_size()
    if KV != H and not (keep_groups and KV % tp == 0):
        k, v = _repeat_heads(k, H // KV), _repeat_heads(v, H // KV)
    hp = H + ((-H) % tp)
    if hp != H:
        q, k, v = _pad_heads(q, hp), _pad_heads(k, hp), _pad_heads(v, hp)
    q = shard(q, "dp", None, "tp", None)
    k = shard(k, "dp", None, "tp", None)
    v = shard(v, "dp", None, "tp", None)
    return q, k, v, H


def _split_heads(y: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    """[B,S,n*dh] -> [B,S,n,dh]; under TP, gathered first unless the TP
    width divides the heads."""
    y = shard(y, "dp", None, "tp" if n % _tp_size() == 0 else None)
    return y.reshape(y.shape[0], y.shape[1], n, dh)

# Query-chunk size of the full-sequence path: bounds the materialized
# [B, H, Qc, S] logits once S > 2 * Q_CHUNK.
Q_CHUNK = 2048


def init_attention(cfg: ModelConfig, gen, device, dtype) -> dict:
    """The same leaves for self- and cross-attention: the two differ only
    in what K/V are projected from."""
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
    q = _split_heads(layers.apply_linear(p["wq"], xq), cfg.num_heads,
                     cfg.head_dim)
    k = _split_heads(layers.apply_linear(p["wk"], xkv), cfg.num_kv_heads,
                     cfg.head_dim)
    v = _split_heads(layers.apply_linear(p["wv"], xkv), cfg.num_kv_heads,
                     cfg.head_dim)
    if cfg.qk_norm:
        q = _headwise_rms(q, p["q_norm"]["scale"], cfg.norm_eps)
        k = _headwise_rms(k, p["k_norm"]["scale"], cfg.norm_eps)
    return q, k, v


def _rope(cfg: ModelConfig, kind: str, pos: torch.Tensor, *xs):
    """xs rotated for a block of ``kind`` (``layers.rope_freqs``)."""
    if not cfg.rope:
        return xs
    sin, cos = layers.rope_freqs(cfg, pos, kind)
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


# Attention-logits dtype (hillclimb lever): fp32 is the default; bf16
# halves the dense path's dominant HBM term at a bounded accuracy cost.
# The flash kernels keep fp32 logits on chip whatever it says.
LOGITS_DTYPE = "float32"


def _sdpa(cfg: ModelConfig, q, k, v, bias) -> torch.Tensor:
    """q [B,Sq,H,dh], k/v [B,Sk,KV,dh], bias [B,1,Sq,Sk] fp32.

    KV heads are expanded to the query-head count and the heads padded to
    a multiple of TP (``_heads_over_tp``). Logits are formed and kept in
    ``LOGITS_DTYPE`` (the JAX einsum's ``preferred_element_type``; fp32
    operands for fp32 logits); softmax weights go back to q's dtype for
    the value product. On DTensors each device computes its own rows and
    heads (``local_map``): DTensor cannot run the batched products on a
    batch dim merged from two sharded dims.
    """
    q, k, v, H = _heads_over_tp(q, k, v, keep_groups=False)
    if isinstance(q, DTensor):
        pl = _shards.moved(q.placements, {0: 0, 2: 2})
        pb = pl if bias.dim() and bias.shape[0] == q.shape[0] > 1 else \
            _shards.moved(q.placements, {})
        out = _shards.on_shards(
            lambda *a: _sdpa_local(cfg, *a), (q, k, v, bias),
            (pl, pl, pl, pb), pl)
    else:
        out = _sdpa_local(cfg, q, k, v, bias)
    return out[:, :, :H]


def _sdpa_local(cfg: ModelConfig, q, k, v, bias) -> torch.Tensor:
    """``_sdpa``'s products over heads already laid out one-to-one."""
    dh = q.shape[3]
    ldt = layers.to_dtype(LOGITS_DTYPE)
    logits = torch.einsum("bqhd,bshd->bhqs", q.to(ldt), k.to(ldt))
    logits = logits * (dh ** -0.5)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    logits = logits + bias.to(ldt)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", w, v)


def _flash_prefill(kernel, q, k, v, causal: bool,
                   window: Optional[int] = None) -> torch.Tensor:
    """The prefill kernel's entry ``kernel`` (``_prefill_kernel``'s) over
    the heads as ``_heads_over_tp`` lays them out (KV heads kept grouped
    where they split over TP)."""
    q, k, v, H = _heads_over_tp(q, k, v, keep_groups=True)
    out = kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                 causal=causal, window=window)
    return out[:, :, :H]


def _on_card(q: torch.Tensor) -> bool:
    return q.device.type == "cuda"


def _flash_grad_eligible(cfg: ModelConfig, q: torch.Tensor) -> bool:
    """Whether the gradient pass's attention over ``q`` can take the
    differentiable flash entry: a plain tensor on a card (a DTensor keeps
    the dense path), bf16, no softcap, a head dim the backward takes."""
    return (type(q) is torch.Tensor and _on_card(q)
            and q.dtype == torch.bfloat16 and _flash_eligible(cfg)
            and q.shape[3] in flash_prefill.BWD_HEAD_DIMS)


def _prefill_kernel(impl: str, cfg: ModelConfig, x: torch.Tensor,
                    q: torch.Tensor):
    """The flash entry a full-sequence attention call takes: the
    inference ``flash_attention``, the differentiable
    ``flash_attention_train`` (``impl="train"``, where the input allows
    it), or None for the dense path. A "train" call bumps the counter of
    the route it takes (``train.attn.flash`` / ``train.attn.dense``)."""
    impl = _resolve_impl(impl, x)
    if impl == "train":
        flash = _flash_grad_eligible(cfg, q)
        telemetry.metrics().counter(
            "train.attn.flash" if flash else "train.attn.dense").inc()
        return flash_prefill.flash_attention_train if flash else None
    if impl == "flash" and _flash_eligible(cfg):
        return flash_prefill.flash_attention
    return None


def self_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                   positions: torch.Tensor, kind: str,
                   return_kv: bool = False, impl: str = "auto"):
    """Full-sequence self-attention (prefill) over positions 0..S-1.

    ``"flash"`` runs the prefill flash-attention kernel over the whole
    sequence at any S. ``"dense"`` materializes the logits up to
    2*Q_CHUNK tokens; above that, query chunks run one after another so
    only one chunk's logits exist at a time (windowed attention slices
    K/V to the reachable band, causal full attention keeps full-length
    K)."""
    causal = cfg.causal
    window = _window(cfg, kind)
    q, k, v = _project_qkv(cfg, p, x, x)
    q, k = _rope(cfg, kind, positions, q, k)
    B, S = x.shape[:2]
    kernel = _prefill_kernel(impl, cfg, x, q)
    if kernel is not None:
        out = _flash_prefill(kernel, q, k, v, causal=causal, window=window)
    elif S <= 2 * Q_CHUNK:
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


def cross_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    memory: torch.Tensor, impl: str = "auto",
                    return_kv: bool = False):
    """Cross-attention of x [B,Sq,D] to frontend memory [B,Sk,D] (VLM):
    no RoPE, no mask (qk-norm if the config sets it). ``"flash"`` runs the
    prefill kernel non-causal over Sk = the memory's length; ``"dense"``
    the einsum path. With ``return_kv`` also returns the memory's (k, v),
    which the decode state keeps."""
    q, k, v = _project_qkv(cfg, p, x, memory)
    B, Sq = x.shape[:2]
    kernel = _prefill_kernel(impl, cfg, x, q)
    if kernel is not None:
        out = _flash_prefill(kernel, q, k, v, causal=False)
    else:
        out = _sdpa(cfg, q, k, v, torch.zeros((), dtype=torch.float32,
                                              device=x.device))
    out = out.reshape(B, Sq, cfg.num_heads * cfg.head_dim)
    out = layers.apply_linear(p["wo"], out)
    if return_kv:
        return out, (k, v)
    return out


def cross_decode_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                           cache: dict, impl: str = "auto") -> torch.Tensor:
    """One token x [B,1,D] against the cross memory the prefill stored
    (``cache`` {"k_mem"/"v_mem": [B,T,KV,dh]}): q is projected from x
    alone, and every one of the T slots is valid. ``"flash"`` runs the
    flash-decode kernel with an all-true ``valid``; ``"dense"`` the
    grouped einsum. Returns the attention output [B,1,D]."""
    B = x.shape[0]
    q = layers.apply_linear(p["wq"], x).reshape(B, 1, cfg.num_heads,
                                                cfg.head_dim)
    if cfg.qk_norm:
        q = _headwise_rms(q, p["q_norm"]["scale"], cfg.norm_eps)
    k, v = cache["k_mem"], cache["v_mem"]
    T = k.shape[1]
    if _resolve_impl(impl, x) == "flash" and _flash_decode_eligible(cfg):
        valid = torch.ones((B, T), dtype=torch.bool, device=x.device)
        out = flash_decode.decode_attention(q[:, 0], _kernel_kv(k, q),
                                            _kernel_kv(v, q), valid)
        out = out[:, None]                                     # [B,1,H,dh]
    else:
        bias = torch.zeros((B, 1, 1, T), dtype=torch.float32,
                           device=x.device)
        out = _sdpa_grouped(cfg, q, k.to(q.dtype), v.to(q.dtype), bias)
    out = out.reshape(B, 1, cfg.num_heads * cfg.head_dim)
    return layers.apply_linear(p["wo"], out)


def _ring_len(cfg: ModelConfig, context_len: int, kind: str) -> int:
    window = _window(cfg, kind)
    return min(context_len, window) if window else context_len


def build_cache_from_full(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
                          context_len: int, kind: str, dtype) -> dict:
    """Scatter full-sequence K/V (prefill) into the ring-cache layout."""
    L = _ring_len(cfg, context_len, kind)
    if isinstance(k, DTensor):          # rows and heads on their shards
        pl = _shards.moved(k.placements, {0: 0, 2: 2})
        ck, cv = _shards.on_shards(
            lambda k, v: _ring_from_full(k, v, L, dtype), (k, v), (pl, pl),
            (pl, pl))
    else:
        ck, cv = _ring_from_full(k, v, L, dtype)
    return {"k": _shard_cache(ck), "v": _shard_cache(cv)}


def _ring_from_full(k, v, L: int, dtype):
    """The last min(S, L) positions of k/v [B,S,KV,dh] at their ring
    slots of fresh zeroed [B,L,KV,dh] caches."""
    B, S = k.shape[:2]
    keep = min(S, L)
    slots = torch.remainder(torch.arange(S - keep, S, device=k.device), L)
    shape = (B, L) + tuple(k.shape[2:])
    ck = torch.zeros(shape, dtype=dtype, device=k.device)
    cv = torch.zeros(shape, dtype=dtype, device=k.device)
    ck[:, slots] = k[:, S - keep:].to(dtype)
    cv[:, slots] = v[:, S - keep:].to(dtype)
    return ck, cv


def _shard_cache(x: torch.Tensor) -> torch.Tensor:
    """KV-cache sharding: batch over DP; KV heads over TP when divisible,
    else the cache length."""
    tp = _tp_size()
    if tp > 1 and x.shape[2] % tp == 0:
        return shard(x, "dp", None, "tp", None)
    return shard(x, "dp", "tp", None, None)


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
    if impl not in ("auto", "dense", "flash", "train"):
        raise ValueError(f"impl must be auto|dense|flash|train, got "
                         f"{impl!r}")
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


def _flash_eligible(cfg: ModelConfig) -> bool:
    """The flash kernels have no softcap."""
    return not cfg.logit_softcap


def _flash_decode_eligible(cfg: ModelConfig) -> bool:
    """The flash-decode kernel also reduces over the whole cache length
    of a row, so it needs an unsharded (TP 1) cache, as in the JAX
    package."""
    return _flash_eligible(cfg) and _tp_size() == 1


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
    q, k_new = _rope(cfg, ATTN, tb[:, None], q, k_new)

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
    # Under TP the cache is sharded over its KV heads or its length, not
    # q's groups: q's heads are gathered before they are grouped.
    q = shard(q, "dp", None, None, None)
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
    q, k_new = _rope(cfg, kind, tb[:, None], q, k_new)

    # One slot per row, written in place. A sharded cache (a DTensor) is
    # rewritten whole with the JAX package's mask-select, which stays
    # local where an indexed store would gather the cache; the numbers
    # are identical.
    slot = torch.remainder(tb, L).long()
    k, v = cache["k"], cache["v"]
    if isinstance(k, DTensor):
        lane = (torch.arange(L, device=x.device)[None, :, None, None]
                == slot[:, None, None, None])
        k.copy_(torch.where(lane, k_new.to(k.dtype), k))
        v.copy_(torch.where(lane, v_new.to(v.dtype), v))
    else:
        rows = torch.arange(B, device=x.device)
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
    q, k_new = _rope(cfg, kind, pos, q, k_new)

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
