"""Wrapper for the Mamba-1 selective-scan CUDA kernel (``csrc/ssm_scan.cu``).

The wrapper checks device, dtype, shape and contiguity, allocates y and
h_last with ``torch.empty``, launches on the current stream and counts
the launch. A tensor on the CPU goes to the plain version in ``ref.py``;
a CUDA tensor launches the kernel or raises — there is no fallback. The
kernel has no backward pass, so a call that needs a gradient raises.

The kernel replaces the Pallas ``_ssm_kernel`` of
``repro/kernels/ssm_scan.py``; unlike it, any S and Di are taken. The
state size N must be one the kernel is built for (``STATE_SIZES``).
B and C split from one projection are strided views: the caller makes
them contiguous.

``launch_config`` reports the launch a call makes (grid, threads,
shared memory, staged chunks, lanes a channel).

The kernel is the custom op ``repro_torch::ssm_scan``, with a fake and a
FLOP formula; a DTensor runs on its local shards (rows or channels).
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, _shards, ref

STATE_SIZES = (4, 8, 16)
# What ``repro_ssm_scan_config`` reports, in its order.
LAUNCH_KEYS = ("grid_x", "grid_y", "threads", "smem_bytes", "buffers",
               "steps_per_chunk", "lanes", "group_steps")

# Launches since the last reset: a plain integer, bumped where the kernel
# launches and nowhere else.
launches = {"ssm_scan": 0}


def reset_launches() -> None:
    launches["ssm_scan"] = 0


def _check(u, delta, A, B, C, D, h0) -> None:
    named = {"u": u, "delta": delta, "A": A, "B": B, "C": C, "D": D,
             "h0": h0}
    for name, t in named.items():
        if t.device != u.device:
            raise ValueError(f"all operands must be on {u.device}, "
                             f"got {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssm-scan operand {name} must be contiguous")
        if name != "u" and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if u.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"u must be float32 or bfloat16, got {u.dtype}")
    if u.dim() != 3 or A.dim() != 2:
        raise ValueError(f"u [B,S,Di] and A [Di,N] expected; got "
                         f"{tuple(u.shape)}, {tuple(A.shape)}")
    Bb, S, Di = u.shape
    N = A.shape[1]
    want = {"delta": (Bb, S, Di), "A": (Di, N), "B": (Bb, S, N),
            "C": (Bb, S, N), "D": (Di,), "h0": (Bb, Di, N)}
    for name, shape in want.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{name} must be {list(shape)} for u "
                             f"{list(u.shape)} and N={N}; got "
                             f"{list(named[name].shape)}")
    if N not in STATE_SIZES:
        raise ValueError(f"state size N={N}: the kernel is built for N in "
                         f"{STATE_SIZES}")


def ssm_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
             h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """u/delta [B,S,Di], A [Di,N], B/C [B,S,N], D [Di], h0 [B,Di,N] ->
    (y [B,S,Di] in u's dtype, h_last [B,Di,N] fp32); see
    ``ref.ssm_scan``."""
    _build.refuse_grad("ssm_scan", u, delta, A, B, C, D, h0)
    args = (u, delta, A, B, C, D, h0)
    if _shards.is_dtensor(*args):
        return _shards.on_shards(_ssm_scan, args, *shard_placements(u))
    _build.require_device("ssm-scan", u)
    return _ssm_scan(*args)


def shard_placements(u) -> tuple:
    """(input, output) placements of a selective scan over DTensor u:
    rows and channels keep u's sharding, the sequence and the state are
    whole."""
    pu = _shards.moved(u.placements, {0: 0, 2: 2})
    pa = _shards.moved(u.placements, {2: 0})
    pbc = _shards.moved(u.placements, {0: 0})
    ph = _shards.moved(u.placements, {0: 0, 2: 1})
    return (pu, pu, pa, pbc, pbc, pa, ph), (pu, ph)


@torch.library.custom_op("repro_torch::ssm_scan", mutates_args=())
def _ssm_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
              h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel (the plain version for a CPU tensor) as a custom op."""
    if u.device.type == "cpu":
        return ref.ssm_scan(u, delta, A, B, C, D, h0)
    if u.device.type != "cuda":
        raise ValueError(f"no ssm-scan kernel for {u.device}")
    _check(u, delta, A, B, C, D, h0)
    Bb, S, Di = u.shape
    N = A.shape[1]
    y = torch.empty_like(u)
    h_last = torch.empty((Bb, Di, N), dtype=torch.float32, device=u.device)
    if Bb == 0 or Di == 0:
        return y, h_last
    lib = _build.load()
    rc = lib.repro_ssm_scan(
        _build.DTYPE_CODE[u.dtype], N, u.data_ptr(), delta.data_ptr(),
        A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
        h0.data_ptr(), y.data_ptr(), h_last.data_ptr(), Bb, S, Di,
        torch.cuda.current_stream(u.device).cuda_stream)
    _build.check_rc(rc, "ssm_scan")
    launches["ssm_scan"] += 1
    return y, h_last


@_ssm_scan.register_fake
def _(u, delta, A, B, C, D, h0):
    return (torch.empty_like(u),
            u.new_empty((u.shape[0], u.shape[2], A.shape[1]),
                        dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.ssm_scan)
def _flops(u_shape, delta_shape, A_shape, B_shape, C_shape, D_shape,
           h0_shape, out_shape=None, **kwargs) -> int:
    """Per (row, step, channel, state): Δ·A and its exponential, Δu·B,
    the state's multiply-add and C·h's multiply-add (8); per channel D·u
    and its add (2)."""
    Bb, S, Di = u_shape
    return 8 * Bb * S * Di * A_shape[1] + 2 * Bb * S * Di


def launch_config(dtype: torch.dtype, N: int, B: int, Di: int) -> dict:
    """The launch ``ssm_scan`` makes for u of ``dtype`` and shape
    [B, S, Di] at state size N, as the kernel library reports it
    (``LAUNCH_KEYS``)."""
    lib = _build.load()
    return _build.launch_config(lib.repro_ssm_scan_config, LAUNCH_KEYS,
                                _build.DTYPE_CODE[dtype], N, B, Di)
