"""Wrappers for the dropless expert layer's pair-wise CUDA kernels
(``csrc/moe_pairs.cu``), which ``models.moe.apply_dropless`` runs.

The layer sorts its (token, choice) pairs by held expert, the held ones
first; ``ends`` [H] int32 are the grouped products' offsets, and
ends[-1] of the N*K pairs are held. Three differentiable entries work on
those alone, each kernel reading ends[-1] on the device:

- ``gather``: x[tok] for the held rows; its backward sums each token's
  held rows in choice order (``combine`` with unit gates).
- ``swiglu``: silu(a) * b over the held rows of the gate | up product.
- ``combine``: each token's held outputs, gated and summed in choice
  order; its backward writes each held row's gradient and each choice's
  gate gradient.

Rows of the [N*K, ..] buffers past ends[-1] are left unspecified and
never read, and no count goes to the host, so a CUDA graph holds them.

The wrappers check device, dtype, shape, contiguity and alignment on
every device (what the kernels do not take is refused on the CPU too),
allocate outputs with ``torch.empty``, launch on the current stream and
count the launches. A tensor on the CPU goes to the plain versions in
``ref.py``; a CUDA tensor launches the kernels or raises — there is no
fallback. Each kernel is a custom op (``repro_torch::moe_gather`` and so
on) with a fake; the forward ones carry their backward through
``register_autograd``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref

# The most choices a token may have: the per-token kernels keep each
# choice's row, gate and gradient sum in registers.
MAX_K = 8

# Launches since the last reset: plain integers, bumped where a kernel
# launches and nowhere else.
launches = {"moe_gather": 0, "moe_swiglu": 0, "moe_swiglu_bwd": 0,
            "moe_combine": 0, "moe_combine_bwd": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def gather(x: torch.Tensor, tok: torch.Tensor, pos: torch.Tensor,
           ends: torch.Tensor) -> torch.Tensor:
    """x [N, D], tok [M] int64 (each sorted pair's token), pos [N, K]
    int64 (each pair's sorted row), ends [H] int32 -> [M, D]: x[tok] in
    the held rows, differentiable in x."""
    _build.require_device("moe-pairs", x)
    return _gather(x, tok, pos, ends)


def swiglu(ab: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """ab = [a | b] [M, 2F] -> silu(a) * b [M, F] in the held rows,
    differentiable in ab."""
    _build.require_device("moe-pairs", ab)
    return _swiglu(ab, ends)


def combine(ye: torch.Tensor, gate: torch.Tensor, pos: torch.Tensor,
            ends: torch.Tensor) -> torch.Tensor:
    """ye [M, D], gate [N, K] in ye's dtype, pos [N, K] int64 -> [N, D]:
    each token's held rows times their gates, summed in choice order in
    fp32 and rounded once; differentiable in ye and gate."""
    _build.require_device("moe-pairs", ye)
    return _combine(ye, gate, pos, ends)


def _check(rows: dict, index: dict, ends: torch.Tensor,
           gate: Optional[torch.Tensor] = None) -> None:
    """``rows``: name -> a 2-D float operand of one dtype, contiguous,
    16-byte aligned, its rows whole 16-byte vectors; ``index``: name ->
    an int64 operand; ``ends`` 1-D int32; ``gate``, read an element at a
    time, of the rows' dtype."""
    device = ends.device
    dtype = next(iter(rows.values())).dtype
    if dtype not in _build.DTYPE_CODE:
        raise TypeError(f"the pair kernels take float32 or bfloat16, got "
                        f"{dtype}")
    named = {**rows, **index, "ends": ends}
    if gate is not None:
        named["gate"] = gate
        if gate.dtype != dtype:
            raise TypeError(f"gate must be {dtype}, got {gate.dtype}")
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"all operands must be on {device}, got {name} "
                             f"on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"pair-kernel operand {name} must be "
                             "contiguous")
    for name, t in rows.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != 2 or t.shape[1] * t.element_size() % 16:
            raise ValueError(f"{name} must be [rows, width] with rows of "
                             f"whole 16 bytes; got {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, t in index.items():
        if t.dtype != torch.int64:
            raise TypeError(f"{name} must be int64, got {t.dtype}")
    if ends.dtype != torch.int32 or ends.dim() != 1 or ends.numel() < 1:
        raise ValueError(f"ends must be [H >= 1] int32, got "
                         f"{tuple(ends.shape)} {ends.dtype}")


def _check_pairs(pos: torch.Tensor, n_tokens: int, n_pairs: int) -> None:
    N, K = (pos.shape if pos.dim() == 2 else (-1, -1))
    if N != n_tokens or N * K != n_pairs or not 1 <= K <= MAX_K:
        raise ValueError(f"pos must be [N={n_tokens}, K] with N*K = "
                         f"{n_pairs} pairs and K <= {MAX_K}; got "
                         f"{tuple(pos.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _count(rc: int, name: str) -> None:
    _build.check_rc(rc, name)
    launches[name] += 1


@torch.library.custom_op("repro_torch::moe_gather", mutates_args=())
def _gather(x: torch.Tensor, tok: torch.Tensor, pos: torch.Tensor,
            ends: torch.Tensor) -> torch.Tensor:
    """The gather kernel (the plain version for a CPU tensor); ``pos``
    is kept for the backward pass."""
    _check({"x": x}, {"tok": tok, "pos": pos}, ends)
    if tok.dim() != 1:
        raise ValueError(f"tok must be [M], got {tuple(tok.shape)}")
    _check_pairs(pos, x.shape[0], tok.shape[0])
    if x.device.type == "cpu":
        return ref.moe_gather(x, tok, ends)
    M, D = tok.shape[0], x.shape[1]
    out = x.new_empty((M, D))
    if M:
        _count(_build.load().repro_moe_gather(
            _build.DTYPE_CODE[x.dtype], x.data_ptr(), tok.data_ptr(),
            ends.data_ptr(), ends.numel(), out.data_ptr(), M, D, _stream(x)),
            "moe_gather")
    return out


@_gather.register_fake
def _(x, tok, pos, ends):
    return x.new_empty((tok.shape[0], x.shape[1]))


def _gather_setup(ctx, inputs, output) -> None:
    ctx.save_for_backward(inputs[2], inputs[3])


def _gather_backward(ctx, g):
    pos, ends = ctx.saved_tensors
    return _combine(g.contiguous(), None, pos, ends), None, None, None


_gather.register_autograd(_gather_backward, setup_context=_gather_setup)


def _check_swiglu(ab: torch.Tensor, ends: torch.Tensor, **rows) -> None:
    _check({"ab": ab, **rows}, {}, ends)
    if ab.shape[1] % 2:
        raise ValueError(f"ab must be [M, 2F], got {tuple(ab.shape)}")
    F = ab.shape[1] // 2
    if F * ab.element_size() % 16:
        raise ValueError(f"F = {F}: each half of ab's rows must be whole "
                         "16 bytes")
    for name, t in rows.items():
        if tuple(t.shape) != (ab.shape[0], F):
            raise ValueError(f"{name} must be [{ab.shape[0]}, {F}], got "
                             f"{tuple(t.shape)}")


@torch.library.custom_op("repro_torch::moe_swiglu", mutates_args=())
def _swiglu(ab: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """The SwiGLU kernel (the plain version for a CPU tensor)."""
    _check_swiglu(ab, ends)
    if ab.device.type == "cpu":
        return ref.moe_swiglu(ab, ends)
    M, F = ab.shape[0], ab.shape[1] // 2
    h = ab.new_empty((M, F))
    if M:
        _count(_build.load().repro_moe_swiglu(
            _build.DTYPE_CODE[ab.dtype], ab.data_ptr(), ends.data_ptr(),
            ends.numel(), h.data_ptr(), M, F, _stream(ab)), "moe_swiglu")
    return h


@_swiglu.register_fake
def _(ab, ends):
    return ab.new_empty((ab.shape[0], ab.shape[1] // 2))


@torch.library.custom_op("repro_torch::moe_swiglu_bwd", mutates_args=())
def _swiglu_bwd(dh: torch.Tensor, ab: torch.Tensor,
                ends: torch.Tensor) -> torch.Tensor:
    """d[a | b] from dh (the plain version for a CPU tensor)."""
    _check_swiglu(ab, ends, dh=dh)
    if ab.device.type == "cpu":
        return ref.moe_swiglu_bwd(dh, ab, ends)
    M, F = ab.shape[0], ab.shape[1] // 2
    dab = torch.empty_like(ab)
    if M:
        _count(_build.load().repro_moe_swiglu_bwd(
            _build.DTYPE_CODE[ab.dtype], dh.data_ptr(), ab.data_ptr(),
            ends.data_ptr(), ends.numel(), dab.data_ptr(), M, F,
            _stream(ab)), "moe_swiglu_bwd")
    return dab


@_swiglu_bwd.register_fake
def _(dh, ab, ends):
    return torch.empty_like(ab)


def _swiglu_setup(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs)


def _swiglu_backward(ctx, dh):
    ab, ends = ctx.saved_tensors
    return _swiglu_bwd(dh.contiguous(), ab, ends), None


_swiglu.register_autograd(_swiglu_backward, setup_context=_swiglu_setup)


def _check_combine(ye, gate, pos, ends, n_tokens: int, **rows) -> None:
    _check({"ye": ye, **rows}, {"pos": pos}, ends, gate)
    _check_pairs(pos, n_tokens, ye.shape[0])
    if gate is not None and gate.shape != pos.shape:
        raise ValueError(f"gate must be {tuple(pos.shape)}, got "
                         f"{tuple(gate.shape)}")


@torch.library.custom_op("repro_torch::moe_combine", mutates_args=())
def _combine(ye: torch.Tensor, gate: Optional[torch.Tensor],
             pos: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """The combine kernel, unit gates where ``gate`` is None (the plain
    version for a CPU tensor)."""
    N, K = pos.shape if pos.dim() == 2 else (-1, -1)
    _check_combine(ye, gate, pos, ends, N)
    if ye.device.type == "cpu":
        return ref.moe_combine(ye, gate, pos, ends)
    D = ye.shape[1]
    y = ye.new_empty((N, D))
    if N:
        _count(_build.load().repro_moe_combine(
            _build.DTYPE_CODE[ye.dtype], ye.data_ptr(),
            gate.data_ptr() if gate is not None else None, pos.data_ptr(),
            ends.data_ptr(), ends.numel(), y.data_ptr(), ye.shape[0], N, K,
            D, _stream(ye)), "moe_combine")
    return y


@_combine.register_fake
def _(ye, gate, pos, ends):
    return ye.new_empty((pos.shape[0], ye.shape[1]))


@torch.library.custom_op("repro_torch::moe_combine_bwd", mutates_args=())
def _combine_bwd(dy: torch.Tensor, ye: torch.Tensor,
                 gate: Optional[torch.Tensor], pos: torch.Tensor,
                 ends: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dye, dgate) from dy (the plain version for a CPU tensor)."""
    N, K = pos.shape if pos.dim() == 2 else (-1, -1)
    _check_combine(ye, gate, pos, ends, N, dy=dy)
    if dy.shape != (N, ye.shape[1]):
        raise ValueError(f"dy must be [{N}, {ye.shape[1]}], got "
                         f"{tuple(dy.shape)}")
    if ye.device.type == "cpu":
        return ref.moe_combine_bwd(dy, ye, gate, pos, ends)
    dye = torch.empty_like(ye)
    dgate = ye.new_empty((N, K))
    if N:
        _count(_build.load().repro_moe_combine_bwd(
            _build.DTYPE_CODE[ye.dtype], dy.data_ptr(), ye.data_ptr(),
            gate.data_ptr() if gate is not None else None, pos.data_ptr(),
            ends.data_ptr(), ends.numel(), dye.data_ptr(), dgate.data_ptr(),
            ye.shape[0], N, K, ye.shape[1], _stream(ye)), "moe_combine_bwd")
    return dye, dgate


@_combine_bwd.register_fake
def _(dy, ye, gate, pos, ends):
    return torch.empty_like(ye), ye.new_empty(pos.shape)


def _combine_setup(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs)


def _combine_backward(ctx, dy):
    ye, gate, pos, ends = ctx.saved_tensors
    dye, dgate = _combine_bwd(dy.contiguous(), ye, gate, pos, ends)
    return dye, (dgate if gate is not None else None), None, None


_combine.register_autograd(_combine_backward, setup_context=_combine_setup)
