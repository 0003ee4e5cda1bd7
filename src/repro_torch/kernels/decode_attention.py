"""Wrappers for the flash-decode CUDA kernels (``csrc/decode_attention.cu``).

Each wrapper checks device, dtype, shape and contiguity, allocates the
output and the split scratch with ``torch.empty``, launches on the
current stream and counts the launch. A tensor on the CPU goes to the
plain version in ``ref.py``; a CUDA tensor launches the kernel or raises
— there is no fallback.

The kernels replace the Pallas ``_decode_kernel`` / ``_paged_kernel`` of
``repro/kernels/decode_attention.py``; unlike the Pallas flat kernel they
take any cache length (the ragged last tile is masked), and the paged one
strides the ``[P, ps, KV, dh]`` pool directly, with no transpose copy.

One launch per call: the last block of each (row, KV head) combines the
splits, counted in a per-device int32 workspace that every launch leaves
at zero. Calls on one device therefore must not overlap on different
streams (the serving engine issues them on one stream).

Each kernel is a custom op (``repro_torch::decode_attention``,
``repro_torch::paged_decode_attention``) with a fake and a FLOP formula,
so a trace under ``FakeTensorMode`` or a FLOP counter sees one op. A
DTensor runs on its local shards (rows or query/KV heads sharded).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, _shards, ref

# Launches of each kernel since the last reset: plain integers, bumped
# where the kernel launches and nowhere else.
launches = {"decode_attention": 0, "paged_decode_attention": 0}

TILE = 32                      # cache slots per tile (TILE in the .cu)
HEAD_DIMS = (16, 32, 64, 128, 256)
# The split plan's constants, picked from timings at the four decode
# shapes of PERF.md (``scripts/torch_tune_decode.py``):
_WARPS_PER_SM = 16     # resident warps the splits aim for on each SM
_MIN_TILES = 2         # tiles a split holds at least
_PARTIAL_SHARE = 4     # a split's K/V bytes >= this x its partials' bytes

# Per device: the kernels' split counters (zero between calls).
_COUNTERS: dict = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_plan(L: int, rows: int, group: int, kv_bytes: int,
               num_sms: int) -> tuple[int, int]:
    """(split_len, n_splits) for ``rows`` (row, KV head) pairs, each a
    block of ``group`` warps, over ``L`` cache slots of ``kv_bytes``-byte
    elements: whole tiles, at least ``_MIN_TILES`` of them (or the whole
    cache) and enough that the split's K/V bytes are ``_PARTIAL_SHARE``
    times its fp32 partials (``group`` x dh), and no more splits than
    fill ``_WARPS_PER_SM`` warps on every SM."""
    tiles = math.ceil(L / TILE)
    blocks_per_sm = max(1, _WARPS_PER_SM // group)
    want = max(1, math.ceil(blocks_per_sm * num_sms / rows))
    # partials group * dh * 4 bytes against split_tiles * TILE * dh * 2 *
    # kv_bytes of K and V
    min_tiles = max(_MIN_TILES, math.ceil(
        _PARTIAL_SHARE * group * 4 / (TILE * 2 * kv_bytes)))
    split_tiles = min(tiles, max(min_tiles, math.ceil(tiles / want)))
    split_len = split_tiles * TILE
    return split_len, math.ceil(L / split_len)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           valid: torch.Tensor, pages: Optional[torch.Tensor]) -> None:
    tensors = [q, k, v, valid] + ([pages] if pages is not None else [])
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"all operands must be on {q.device}, "
                             f"got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("decode-attention operands must be contiguous")
    if q.dtype not in _build.DTYPE_CODE or k.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"q/k/v must be float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}")
    if v.dtype != k.dtype or v.shape != k.shape:
        raise ValueError("k and v must share dtype and shape")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be torch.bool, got {valid.dtype}")
    if pages is not None and pages.dtype != torch.int32:
        raise TypeError(f"pages must be int32, got {pages.dtype}")
    B, H, dh = q.shape
    KV = k.shape[2]
    if dh not in HEAD_DIMS or k.shape[3] != dh:
        raise ValueError(f"head dim {dh} (k: {k.shape[3]}) not in "
                         f"{HEAD_DIMS}")
    if H % KV or H // KV > 32:
        raise ValueError(f"{H} query heads over {KV} KV heads: the group "
                         "must divide evenly and be at most 32")
    for t in (k, v):
        if t.data_ptr() % 16:
            raise ValueError("k/v must be 16-byte aligned")


def _scratch(q: torch.Tensor, KV: int, n_splits: int) -> tuple:
    """out, and the split partials m, l, acc and the counters (none for
    one split, where the kernel finalizes in place)."""
    B, H, dh = q.shape
    out = torch.empty((B, H, dh), dtype=q.dtype, device=q.device)
    if n_splits == 1:
        return out, []
    f32 = dict(dtype=torch.float32, device=q.device)
    counters = _COUNTERS.get(q.device)
    if counters is None or counters.numel() < B * KV:
        counters = torch.zeros(B * KV, dtype=torch.int32, device=q.device)
        _COUNTERS[q.device] = counters
    return out, [torch.empty((B, H, n_splits), **f32),
                 torch.empty((B, H, n_splits), **f32),
                 torch.empty((B, H, n_splits, dh), **f32), counters]


def _ptrs(ws: list) -> list:
    """The scratch's pointers, null pointers without a split."""
    return [t.data_ptr() for t in ws] or [None] * 4


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """q [B,H,dh]; k/v [B,L,KV,dh]; valid [B,L] bool -> [B,H,dh] (q's
    dtype). q and k/v may differ in dtype (float32 / bfloat16)."""
    args = (q, k, v, valid, sm_scale)
    if _shards.is_dtensor(q, k, v, valid):
        pq = _shards.moved(q.placements, {0: 0, 1: 1})
        pkv = _shards.moved(q.placements, {0: 0, 1: 2})
        prow = _shards.moved(q.placements, {0: 0})
        return _shards.on_shards(_decode_attention, args,
                                 (pq, pkv, pkv, prow, None), pq)
    _build.require_device("decode-attention", q)
    return _decode_attention(*args)


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def _decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid: torch.Tensor,
                      sm_scale: Optional[float]) -> torch.Tensor:
    """The kernel (the plain version for a CPU tensor) as a custom op."""
    if q.device.type == "cpu":
        return ref.decode_attention(q, k, v, valid, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no decode-attention kernel for {q.device}")
    _check(q, k, v, valid, None)
    B, H, dh = q.shape
    L, KV = k.shape[1], k.shape[2]
    if valid.shape != (B, L):
        raise ValueError(f"valid {tuple(valid.shape)} != {(B, L)}")
    sm_scale = sm_scale if sm_scale is not None else dh ** -0.5
    split_len, n_splits = split_plan(L, B * KV, H // KV, k.element_size(),
                                     _num_sms(q.device))
    out, ws = _scratch(q, KV, n_splits)
    lib = _build.load()
    rc = lib.repro_decode_attention(
        _build.DTYPE_CODE[q.dtype], _build.DTYPE_CODE[k.dtype], dh,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        out.data_ptr(), *_ptrs(ws),
        B, H, KV, L, split_len, n_splits, float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_rc(rc, "decode_attention")
    launches["decode_attention"] += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, pages: torch.Tensor,
                           valid: torch.Tensor,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """q [B,H,dh]; k/v pages [P,ps,KV,dh]; pages [B,n] int32; valid
    [B,n*ps] bool over logical slots -> [B,H,dh] (q's dtype). Page ids
    must lie in [0, P); repeats and the trash page 0 are legal. On
    DTensors the rows may be sharded; the pool is read whole."""
    args = (q, k_pages, v_pages, pages, valid, sm_scale)
    if _shards.is_dtensor(*args[:5]):
        prow = _shards.moved(q.placements, {0: 0})
        pool = _shards.moved(q.placements, {})
        return _shards.on_shards(_paged_decode_attention, args,
                                 (prow, pool, pool, prow, prow, None), prow)
    _build.require_device("decode-attention", q)
    return _paged_decode_attention(*args)


@torch.library.custom_op("repro_torch::paged_decode_attention",
                         mutates_args=())
def _paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, pages: torch.Tensor,
                            valid: torch.Tensor,
                            sm_scale: Optional[float]) -> torch.Tensor:
    """The kernel (the plain version for a CPU tensor) as a custom op."""
    if q.device.type == "cpu":
        return ref.paged_decode_attention(q, k_pages, v_pages, pages, valid,
                                          sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no decode-attention kernel for {q.device}")
    _check(q, k_pages, v_pages, valid, pages)
    B, H, dh = q.shape
    ps, KV = k_pages.shape[1], k_pages.shape[2]
    n = pages.shape[1]
    if pages.shape[0] != B or valid.shape != (B, n * ps):
        raise ValueError(f"pages {tuple(pages.shape)} / valid "
                         f"{tuple(valid.shape)} do not match B={B}, "
                         f"n*ps={n * ps}")
    sm_scale = sm_scale if sm_scale is not None else dh ** -0.5
    split_len, n_splits = split_plan(n * ps, B * KV, H // KV,
                                     k_pages.element_size(),
                                     _num_sms(q.device))
    out, ws = _scratch(q, KV, n_splits)
    lib = _build.load()
    rc = lib.repro_paged_decode_attention(
        _build.DTYPE_CODE[q.dtype], _build.DTYPE_CODE[k_pages.dtype], dh,
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        pages.data_ptr(), valid.data_ptr(),
        out.data_ptr(), *_ptrs(ws),
        B, H, KV, ps, n, split_len, n_splits, float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_rc(rc, "paged_decode_attention")
    launches["paged_decode_attention"] += 1
    return out


@_decode_attention.register_fake
def _(q, k, v, valid, sm_scale):
    return torch.empty_like(q)


@_paged_decode_attention.register_fake
def _(q, k_pages, v_pages, pages, valid, sm_scale):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _flops(q_shape, k_shape, v_shape, valid_shape, sm_scale,
           out_shape=None, **kwargs) -> int:
    """q.k and p.v over every slot of the ring (which are valid is data
    the formula does not see): 4 dh a slot and query head."""
    B, H, dh = q_shape
    return 4 * B * H * dh * k_shape[1]


@register_flop_formula(torch.ops.repro_torch.paged_decode_attention)
def _paged_flops(q_shape, k_shape, v_shape, pages_shape, valid_shape,
                 sm_scale, out_shape=None, **kwargs) -> int:
    """As ``decode_attention``, over each row's n * ps logical slots."""
    B, H, dh = q_shape
    return 4 * B * H * dh * valid_shape[1]
