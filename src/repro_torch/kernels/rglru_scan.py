"""Wrapper for the RG-LRU linear-scan CUDA kernel (``csrc/rglru_scan.cu``).

The wrapper checks device, dtype, shape and contiguity, allocates y and
h_last with ``torch.empty``, launches on the current stream and counts
the launch. A tensor on the CPU goes to the plain version in ``ref.py``;
a CUDA tensor launches the kernel or raises — there is no fallback. The
kernel has no backward pass, so a call that needs a gradient raises.

The kernel replaces the Pallas ``_rglru_kernel`` of
``repro/kernels/rglru_scan.py``; unlike it, any S and W are taken.
``launch_config`` reports the launch a call makes (grid, threads, shared
memory, ring depth).

The kernel is the custom op ``repro_torch::rglru_scan``, with a fake and
a FLOP formula; a DTensor runs on its local shards (rows or channels).
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, _shards, ref

# What ``repro_rglru_scan_config`` reports, in its order.
LAUNCH_KEYS = ("grid_x", "grid_y", "threads", "smem_bytes", "stages",
               "steps_per_stage")

# Launches since the last reset: a plain integer, bumped where the kernel
# launches and nowhere else.
launches = {"rglru_scan": 0}


def reset_launches() -> None:
    launches["rglru_scan"] = 0


def _check(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor) -> None:
    for t in (a, x, h0):
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, "
                             f"got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("rglru-scan operands must be contiguous")
    if x.dtype not in _build.DTYPE_CODE or a.dtype != x.dtype:
        raise TypeError(f"a and x must share one dtype, float32 or "
                        f"bfloat16; got {a.dtype}/{x.dtype}")
    if h0.dtype != torch.float32:
        raise TypeError(f"h0 must be float32, got {h0.dtype}")
    if x.dim() != 3 or a.shape != x.shape \
            or h0.shape != (x.shape[0], x.shape[2]):
        raise ValueError(f"a/x [B,S,W] and h0 [B,W] expected; got "
                         f"{tuple(a.shape)}, {tuple(x.shape)}, "
                         f"{tuple(h0.shape)}")


def rglru_scan(a: torch.Tensor, x: torch.Tensor,
               h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a/x [B,S,W], h0 [B,W] fp32 -> (y [B,S,W] in x's dtype, h_last
    [B,W] fp32), h_t = a_t * h_{t-1} + x_t."""
    _build.refuse_grad("rglru_scan", a, x, h0)
    if _shards.is_dtensor(a, x, h0):
        return _shards.on_shards(_rglru_scan, (a, x, h0),
                                 *shard_placements(x))
    _build.require_device("rglru-scan", x)
    return _rglru_scan(a, x, h0)


def shard_placements(x) -> tuple:
    """(input, output) placements of an RG-LRU scan over DTensor x: rows
    and channels keep x's sharding, the sequence is whole."""
    pl = _shards.moved(x.placements, {0: 0, 2: 2})
    ph = _shards.moved(x.placements, {0: 0, 2: 1})
    return (pl, pl, ph), (pl, ph)


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=())
def _rglru_scan(a: torch.Tensor, x: torch.Tensor,
                h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel (the plain version for a CPU tensor) as a custom op."""
    if x.device.type == "cpu":
        return ref.rglru_scan(a, x, h0)
    if x.device.type != "cuda":
        raise ValueError(f"no rglru-scan kernel for {x.device}")
    _check(a, x, h0)
    B, S, W = x.shape
    y = torch.empty_like(x)
    h_last = torch.empty((B, W), dtype=torch.float32, device=x.device)
    if B == 0 or W == 0:
        return y, h_last
    lib = _build.load()
    rc = lib.repro_rglru_scan(
        _build.DTYPE_CODE[x.dtype], a.data_ptr(), x.data_ptr(),
        h0.data_ptr(), y.data_ptr(), h_last.data_ptr(), B, S, W,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_rc(rc, "rglru_scan")
    launches["rglru_scan"] += 1
    return y, h_last


@_rglru_scan.register_fake
def _(a, x, h0):
    return (torch.empty_like(x),
            x.new_empty((x.shape[0], x.shape[2]), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.rglru_scan)
def _flops(a_shape, x_shape, h0_shape, out_shape=None, **kwargs) -> int:
    """One multiply and one add per element."""
    B, S, W = x_shape
    return 2 * B * S * W


def launch_config(dtype: torch.dtype, B: int, W: int) -> dict:
    """The launch ``rglru_scan`` makes for a/x of ``dtype`` and shape
    [B, S, W], as the kernel library reports it (``LAUNCH_KEYS``)."""
    lib = _build.load()
    return _build.launch_config(lib.repro_rglru_scan_config, LAUNCH_KEYS,
                                _build.DTYPE_CODE[dtype], B, W)
