"""Wrapper for the prefill flash-attention CUDA kernel
(``csrc/flash_attention.cu``).

The wrapper checks device, dtype, shape, contiguity and alignment,
allocates the output with ``torch.empty``, launches on the current stream
and counts the launch. A tensor on the CPU goes to the plain version in
``ref.py``; a CUDA tensor launches the kernel or raises — there is no
fallback. The kernel has no backward pass, so a call that needs a
gradient raises on every device.

The kernels replace the Pallas ``_flash_kernel`` of
``repro/kernels/flash_attention.py``; unlike it, any Sq and Sk are taken
(ragged tiles are masked). The dtype picks the kernel (``ENTRY``): bf16
runs on the tensor cores (wgmma, P rounded to bf16 before the value
product, as the dense path and SDPA round it), float32 on fp32 FMAs,
since float32 is the parity dtype and TF32 would keep three digits.

The kernel is the custom op ``repro_torch::flash_attention``, with a
fake (its output's shape) and a FLOP formula (the visible pairs, not the
dense square), so a trace under ``FakeTensorMode`` or a FLOP counter
sees it as one op.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, _shards, ref

# Launches since the last reset: a plain integer, bumped where the kernel
# launches and nowhere else.
launches = {"flash_attention": 0}

HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # 80: HuBERT-XLarge
# The C entry point for each dtype: the tensor-core kernel for bf16, the
# FMA kernel for float32.
ENTRY = {torch.bfloat16: "repro_flash_attention_bf16",
         torch.float32: "repro_flash_attention_f32"}


def reset_launches() -> None:
    launches["flash_attention"] = 0


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
