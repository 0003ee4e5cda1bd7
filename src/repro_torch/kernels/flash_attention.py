"""Wrappers for the prefill flash-attention CUDA kernels
(``csrc/flash_attention.cu``, and its backward pass in
``csrc/flash_attention_bwd.cu``).

The wrappers check device, dtype, shape, contiguity and alignment,
allocate outputs and scratch with ``torch.empty``, launch on the current
stream and count the launches. A tensor on the CPU goes to the plain
versions in ``ref.py``; a CUDA tensor launches the kernels or raises —
there is no fallback.

Two entries. ``flash_attention``, for inference, has no backward pass:
a call that needs a gradient raises on every device. ``flash_attention_
train`` is differentiable: its forward is the bf16 kernel's instance
that also keeps each row's log-sum-exp, its backward the kernels of
``flash_attention_bwd.cu`` (bf16 on a card, head dims ``BWD_HEAD_DIMS``;
the Pallas kernel has no backward to port). Autograd saves q, k, v, the
output and the log-sum-exp, nothing of size Sq x Sk. The learner's
gradient pass reaches it through ``models.attention`` (``impl="train"``).

The kernels replace the Pallas ``_flash_kernel`` of
``repro/kernels/flash_attention.py``; unlike it, any Sq and Sk are taken
(ragged tiles are masked). The dtype picks the kernel (``ENTRY``): bf16
runs on the tensor cores (wgmma, P rounded to bf16 before the value
product, as the dense path and SDPA round it), float32 on fp32 FMAs,
since float32 is the parity dtype and TF32 would keep three digits.

The kernel is the custom op ``repro_torch::flash_attention``, with a
fake (its output's shape) and a FLOP formula (the visible pairs, not the
dense square), so a trace under ``FakeTensorMode`` or a FLOP counter
sees it as one op; so are the training forward and backward,
``repro_torch::flash_attention_fwd`` and ``::flash_attention_bwd``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, _shards, ref

# Launches since the last reset: a plain integer, bumped where the kernel
# launches and nowhere else.
launches = {"flash_attention": 0, "flash_attention_bwd": 0}

HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # 80: HuBERT-XLarge
# The backward kernels' head dims: dh 256 would need 256 fp32 registers
# a thread for a key tile's dK and dV.
BWD_HEAD_DIMS = (16, 32, 64, 80, 128)
# The backward's tiles (64 queries or keys), and its dK/dV blocks an SM
# holds at once (~100 KB of shared memory each).
BWD_TILE = 64
BWD_BLOCKS_PER_SM = 2
# The C entry point for each dtype: the tensor-core kernel for bf16, the
# FMA kernel for float32.
ENTRY = {torch.bfloat16: "repro_flash_attention_bf16",
         torch.float32: "repro_flash_attention_f32"}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: Optional[int]) -> None:
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"all operands must be on {q.device}, "
                             f"got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("flash-attention operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("flash-attention operands must be 16-byte "
                             "aligned")
    if q.dtype not in ENTRY or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one dtype, float32 or bfloat16; "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q [B,Sq,H,dh], k/v [B,Sk,KV,dh] expected; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads over {KV} KV heads: the group "
                         "must divide evenly")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if causal and Sq > Sk:
        raise ValueError(f"causal attention with more queries ({Sq}) than "
                         f"keys ({Sk}) leaves rows with nothing to attend")


def visible_pairs(Sq: int, Sk: int, causal: bool,
                  window: Optional[int]) -> int:
    """(query, key) pairs ``ref.visible`` keeps: the work the kernel
    does, in place of the [Sq, Sk] square the dense path computes."""
    p = np.arange(Sq, dtype=np.int64) + (Sk - Sq)
    hi = np.minimum(p + 1, Sk) if causal else np.full(Sq, Sk, np.int64)
    lo = np.maximum(p - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q [B,Sq,H,dh], k/v [B,Sk,KV,dh] -> [B,Sq,H,dh] in q's dtype;
    queries right-aligned when Sq < Sk (see ``ref.flash_attention``).
    DTensors run on their local shards: batch and heads may be sharded
    (k/v over the same axes as q, so each shard keeps whole groups)."""
    _build.refuse_grad("flash_attention", q, k, v)
    args = (q, k, v, causal, window, sm_scale)
    if _shards.is_dtensor(q, k, v):
        pl = _shards.moved(q.placements, {0: 0, 2: 2})
        return _shards.on_shards(_flash_attention, args,
                                 (pl, pl, pl, None, None, None), pl)
    _build.require_device("flash-attention", q)
    return _flash_attention(*args)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool, window: Optional[int],
                     sm_scale: Optional[float]) -> torch.Tensor:
    """The kernel (the plain version for a CPU tensor), as a custom op:
    tracers see one op with the shape of its output and its FLOPs."""
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal, window, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {q.device}")
    _check(q, k, v, causal, window)
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    sm_scale = sm_scale if sm_scale is not None else dh ** -0.5
    out = torch.empty_like(q)
    if Sq == 0 or Sk == 0 or B == 0:
        return out.zero_()
    rc = getattr(_build.load(), ENTRY[q.dtype])(
        dh, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), B, Sq, Sk, H, KV, int(causal),
        int(window or 0), float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_rc(rc, "flash_attention")
    launches["flash_attention"] += 1
    return out


@_flash_attention.register_fake
def _(q, k, v, causal, window, sm_scale):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, v_shape, causal, window, sm_scale,
           out_shape=None, **kwargs) -> int:
    """q.k and p.v over the visible pairs: 4 dh a pair and query head."""
    B, Sq, H, dh = q_shape
    return 4 * B * H * dh * visible_pairs(Sq, k_shape[1], causal, window)


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: Optional[int] = None,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """``flash_attention``'s output, differentiable in q, k and v: the
    backward kernels give the gradient (the plain versions for a CPU
    tensor). Plain tensors only, not DTensors; on a card bf16 q/k/v and
    a head dim in ``BWD_HEAD_DIMS``."""
    _build.require_device("flash-attention", q)
    return _flash_attention_fwd(q, k, v, causal, window, sm_scale)[0]


def _check_train(q, k, v, causal, window) -> None:
    _check(q, k, v, causal, window)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the flash-attention backward takes bfloat16, got "
                        f"{q.dtype}")
    if q.shape[3] not in BWD_HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[3]} not in {BWD_HEAD_DIMS} "
                         "(the backward kernels')")


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: Optional[int],
                         sm_scale: Optional[float]
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse [B,H,Sq] fp32): the bf16 kernel's instance that keeps
    the log-sum-exp (the plain version for a CPU tensor)."""
    if q.device.type == "cpu":
        return ref.flash_attention_lse(q, k, v, causal, window, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {q.device}")
    _check_train(q, k, v, causal, window)
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    sm_scale = sm_scale if sm_scale is not None else dh ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if Sq == 0 or Sk == 0 or B == 0:
        return out.zero_(), lse.fill_(float("inf"))
    rc = _build.load().repro_flash_attention_bf16_lse(
        dh, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, Sq, Sk, H, KV, int(causal), int(window or 0),
        float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_rc(rc, "flash_attention")
    launches["flash_attention"] += 1
    return out, lse


@_flash_attention_fwd.register_fake
def _(q, k, v, causal, window, sm_scale):
    B, Sq, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, Sq), dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _flash_attention_bwd(dout: torch.Tensor, q: torch.Tensor,
                         k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                         lse: torch.Tensor, causal: bool,
                         window: Optional[int], sm_scale: Optional[float]
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the backward kernels (the plain version for a
    CPU tensor). Where a group's query heads are spread over blocks
    (``bwd_splits``), their fp32 shares of dK and dV go to scratch and
    are added in a fixed order."""
    if q.device.type == "cpu":
        return ref.flash_attention_bwd(q, k, v, out, lse, dout, causal,
                                       window, sm_scale)
    _check_train(q, k, v, causal, window)
    for t in (dout, out):
        if t.shape != q.shape or t.dtype != q.dtype or \
                not t.is_contiguous():
            raise ValueError("out and dout must be contiguous, of q's shape "
                             "and dtype")
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    sm_scale = sm_scale if sm_scale is not None else dh ** -0.5
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if Sq == 0 or Sk == 0 or B == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    splits = bwd_splits(B, Sq, Sk, H, KV, causal, window,
                        _sm_count(q.device))
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    part = (torch.empty((splits, 2, B, Sk, KV, dh), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    rc = _build.load().repro_flash_attention_bwd_bf16(
        dh, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        part.data_ptr() if part is not None else None, B, Sq, Sk, H, KV,
        int(causal), int(window or 0), float(sm_scale), splits,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_rc(rc, "flash_attention_bwd")
    launches["flash_attention_bwd"] += 1
    return dq, dk, dv


@_flash_attention_bwd.register_fake
def _(dout, q, k, v, out, lse, causal, window, sm_scale):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup_context(ctx, inputs, output) -> None:
    q, k, v, causal, window, sm_scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.mark_non_differentiable(lse)
    ctx.args = (causal, window, sm_scale)


def _backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = _flash_attention_bwd(dout.contiguous(), q, k, v, out, lse,
                                      *ctx.args)
    return dq, dk, dv, None, None, None


_flash_attention_fwd.register_autograd(_backward,
                                       setup_context=_setup_context)


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _fwd_flops(q_shape, k_shape, v_shape, causal, window, sm_scale,
               out_shape=None, **kwargs) -> int:
    return _flops(q_shape, k_shape, v_shape, causal, window, sm_scale)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_flops(dout_shape, q_shape, k_shape, v_shape, o_shape, lse_shape,
               causal, window, sm_scale, out_shape=None, **kwargs) -> int:
    """Five products over the visible pairs (S recomputed, dP, dV, dK,
    dQ): 10 dh a pair and query head, 2.5 times the forward. The kernels
    run seven, the dQ kernel recomputing S and dP."""
    B, Sq, H, dh = q_shape
    return 10 * B * H * dh * visible_pairs(Sq, k_shape[1], causal, window)


def bwd_query_tiles(Sq: int, Sk: int, causal: bool,
                    window: Optional[int]) -> np.ndarray:
    """For each 64-key tile, the 64-query tiles the dK/dV kernel visits
    for one query head (those that see a key of the tile)."""
    T = BWD_TILE
    nq, nk, off = -(-Sq // T), -(-Sk // T), Sk - Sq
    k0 = np.arange(nk, dtype=np.int64) * T
    lo = np.maximum(k0 - off, 0) // T if causal else np.zeros(nk, np.int64)
    hi = (np.minimum(nq - 1, (k0 + T + window - 2 - off) // T) if window
          else np.full(nk, nq - 1, np.int64))
    return np.maximum(hi - lo + 1, 0)


@functools.lru_cache(maxsize=None)
def bwd_splits(B: int, Sq: int, Sk: int, H: int, KV: int, causal: bool,
               window: Optional[int], sms: int) -> int:
    """Over how many dK/dV blocks a KV head's query heads are spread: the
    fewest (a divisor of the group) that bring the heaviest block's tiles
    down to the mean a block slot of the card gets (``sms`` SMs of
    ``BWD_BLOCKS_PER_SM``), else one a head. Few key tiles (Qwen2's
    4 x 2 x 16 blocks fill under half the card) or a causal pass whose
    first key tiles see every query tile call for more; a long windowed
    pass for none."""
    G = H // KV
    tiles = bwd_query_tiles(Sq, Sk, causal, window)
    total = B * KV * G * int(tiles.sum())
    heaviest = G * int(tiles.max(initial=0))
    slots = BWD_BLOCKS_PER_SM * sms
    return next((d for d in range(1, G)
                 if G % d == 0 and heaviest * slots <= total * d), G)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
