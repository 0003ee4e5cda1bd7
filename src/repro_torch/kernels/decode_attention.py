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
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

# Launches of each kernel since the last reset: plain integers, bumped
# where the kernel launches and nowhere else.
launches = {"decode_attention": 0, "paged_decode_attention": 0}

TILE = 32                      # cache slots per tile (TILE in the .cu)
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Blocks per SM the split aims for: enough resident warps to keep loads
# in flight on every SM.
_BLOCKS_PER_SM = 4


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_plan(L: int, rows: int, num_sms: int) -> tuple[int, int]:
    """(split_len, n_splits): split the cache length so that
    ``rows * n_splits`` blocks fill the card, in whole tiles."""
    want = max(1, math.ceil(_BLOCKS_PER_SM * num_sms / rows))
    tiles = math.ceil(L / TILE)
    split_tiles = max(1, math.ceil(tiles / min(want, tiles)))
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
    if q.dtype not in _DTYPE_CODE or k.dtype not in _DTYPE_CODE:
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


def _scratch(q: torch.Tensor, n_splits: int):
    B, H, dh = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.empty((B, H, dh), dtype=q.dtype, device=q.device),
            torch.empty((B, H, n_splits), **f32),
            torch.empty((B, H, n_splits), **f32),
            torch.empty((B, H, n_splits, dh), **f32))


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """q [B,H,dh]; k/v [B,L,KV,dh]; valid [B,L] bool -> [B,H,dh] (q's
    dtype). q and k/v may differ in dtype (float32 / bfloat16)."""
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
    split_len, n_splits = split_plan(L, B * KV, _num_sms(q.device))
    out, m, l, acc = _scratch(q, n_splits)
    lib = _build.load()
    rc = lib.repro_decode_attention(
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype], dh,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        out.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
        B, H, KV, L, split_len, n_splits, float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "decode_attention")
    launches["decode_attention"] += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, pages: torch.Tensor,
                           valid: torch.Tensor,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """q [B,H,dh]; k/v pages [P,ps,KV,dh]; pages [B,n] int32; valid
    [B,n*ps] bool over logical slots -> [B,H,dh] (q's dtype). Page ids
    must lie in [0, P); repeats and the trash page 0 are legal."""
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
    split_len, n_splits = split_plan(n * ps, B * KV, _num_sms(q.device))
    out, m, l, acc = _scratch(q, n_splits)
    lib = _build.load()
    rc = lib.repro_paged_decode_attention(
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype], dh,
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        pages.data_ptr(), valid.data_ptr(),
        out.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
        B, H, KV, ps, n, split_len, n_splits, float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "paged_decode_attention")
    launches["paged_decode_attention"] += 1
    return out
