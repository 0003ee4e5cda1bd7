"""Mamba-1 selective SSM block (Falcon-Mamba): the port of
``repro.models.ssm``.

    x -> in_proj -> (u, z)                u: [B,S,Di], z: gate branch
    u -> causal depthwise conv(K) -> silu
    (Δ, B, C) from u via x_proj/dt_proj;  A = -exp(A_log) [Di,N]
    h_t = exp(Δ_t A) h_{t-1} + Δ_t B_t u_t     (diagonal A ⇒ per-channel)
    y_t = C_t · h_t + D u_t
    out = out_proj(y * silu(z))

Full-sequence mode hands u, Δ, A, B, C and D to the selective scan over
the whole sequence: ``"flash"`` runs the CUDA kernel's wrapper
(``kernels.ssm_scan``, which runs the plain version only for a CPU
tensor), ``"dense"`` the plain sequential loop itself, ``"auto"`` flash
on a CUDA device. The JAX package runs an associative scan in chunks
(``scan_utils.chunked_recurrence``) over [B,S,Di,N] operands whose dtype
is a knob (``SCAN_DTYPE``); the kernel discretises in registers and
carries h across the sequence itself, so the chunks are not ported, and
the knob rounds only the plain loop's exp(Δ⊗A) and Δu⊗B. Decode keeps
(h [B,Di,N], conv tail [B,K-1,Di]) as fp32 state and takes one step in
plain PyTorch, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _shards, ref
from repro_torch.kernels import ssm_scan as scan_kernel
from repro_torch.models import attention, layers, rglru
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import shard

# Dtype of the scan elements exp(Δ⊗A) and Δu⊗B on the plain route
# (hillclimb lever); fp32 is the reference. The kernel keeps them fp32 in
# registers whatever it says.
SCAN_DTYPE = "float32"


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def init_mamba_block(cfg: ModelConfig, gen: torch.Generator, device,
                     dtype) -> dict:
    """Seeded random weights in the JAX package's layout: A_log = log(1..N)
    for every channel and D = 1, both fp32 (the scan reads them in fp32);
    other leaves are stored in ``dtype``."""
    d, di, n, r = cfg.d_model, d_inner(cfg), cfg.ssm_state, cfg.ssm_dt_rank
    K = cfg.ssm_conv
    A = torch.arange(1, n + 1, dtype=torch.float32,
                     device=device)[None, :].repeat(di, 1)
    conv = torch.randn((K, di), generator=gen, device=device) * K ** -0.5
    return {
        "in_proj": layers.init_linear(gen, d, 2 * di, device, dtype),
        "conv1d": conv.to(dtype),
        "conv_bias": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": layers.init_linear(gen, di, r + 2 * n, device, dtype),
        "dt_proj": layers.init_linear(gen, r, di, device, dtype, bias=True),
        "A_log": torch.log(A),
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": layers.init_linear(gen, di, d, device, dtype,
                                       scale=di ** -0.5),
    }


def _conv1d(p: dict, u: torch.Tensor,
            state: Optional[torch.Tensor] = None):
    """Causal depthwise conv plus bias. Returns (out [B,S,Di], the last
    K-1 inputs before it, zero-padded for a prompt shorter than K-1)."""
    out, new_state = rglru._conv1d(p, u, state)
    return out + p["conv_bias"].to(u.dtype), new_state


def _ssm_params(cfg: ModelConfig, p: dict, u: torch.Tensor):
    """u [B,S,Di] -> Δ [B,S,Di], B/C [B,S,N] (fp32). The projections run
    in the compute dtype; softplus takes their fp32 cast."""
    n, r = cfg.ssm_state, cfg.ssm_dt_rank
    dbc = layers.apply_linear(p["x_proj"], u)
    dt, Bc, Cc = torch.split(dbc, [r, n, n], dim=-1)
    delta = F.softplus(layers.apply_linear(p["dt_proj"], dt).float())
    return delta, Bc.float(), Cc.float()


def selective_scan(cfg: ModelConfig, p: dict, u: torch.Tensor,
                   h0: torch.Tensor, impl: str = "auto"):
    """Full-sequence scan. u [B,S,Di], h0 [B,Di,N] fp32 -> (y [B,S,Di] in
    u's dtype, h_S [B,Di,N] fp32)."""
    A = -torch.exp(p["A_log"].float())                        # [Di,N]
    delta, Bc, Cc = _ssm_params(cfg, p, u)
    args = (u, delta, A, Bc.contiguous(), Cc.contiguous(), p["D"].float(),
            h0.float())
    if attention._resolve_impl(impl, u) == "flash":
        return scan_kernel.ssm_scan(*args)
    elem = None if SCAN_DTYPE == "float32" else layers.to_dtype(SCAN_DTYPE)
    if _shards.is_dtensor(u):           # the plain loop on local shards
        return _shards.on_shards(
            lambda *a: ref.ssm_scan(*a, elem_dtype=elem), args,
            *scan_kernel.shard_placements(u))
    return ref.ssm_scan(*args, elem_dtype=elem)


def selective_step(cfg: ModelConfig, p: dict, u: torch.Tensor,
                   h: torch.Tensor):
    """One token. u [B,1,Di], h [B,Di,N] -> (y [B,1,Di], h')."""
    A = -torch.exp(p["A_log"].float())
    delta, Bc, Cc = _ssm_params(cfg, p, u)
    uf = u.float()
    dA = torch.exp(delta[:, 0, :, None] * A[None])            # [B,Di,N]
    dBu = (delta[:, 0] * uf[:, 0])[..., None] * Bc[:, 0, None, :]
    h_new = dA * h + dBu
    y = torch.einsum("bdn,bn->bd", h_new, Cc[:, 0])
    y = y + uf[:, 0] * p["D"].float()
    return y.to(u.dtype)[:, None], h_new


def init_mamba_state(cfg: ModelConfig, batch: int, device) -> dict:
    di, n, K = d_inner(cfg), cfg.ssm_state, cfg.ssm_conv
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, di, n), **f32),
            "conv": torch.zeros((batch, K - 1, di), **f32)}


def apply_mamba_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      state: Optional[dict] = None,
                      want_state: bool = False, impl: str = "auto"):
    """x [B,S,D] -> (out [B,S,D], new_state); with ``state`` (decode) S
    must be 1. ``want_state=True`` (prefill) returns the final SSM/conv
    state of a full-sequence pass; ``impl`` picks its scan."""
    uz = layers.apply_linear(p["in_proj"], x)
    uz = shard(uz, "dp", None, "tp")
    u, z = torch.chunk(uz, 2, dim=-1)
    if state is None:
        u_raw, conv_tail = _conv1d(p, u)
        u = F.silu(u_raw)
        h0 = torch.zeros((x.shape[0], d_inner(cfg), cfg.ssm_state),
                         dtype=torch.float32, device=x.device)
        y, h_last = selective_scan(cfg, p, u, h0, impl)
        new_state = None
        if want_state:
            new_state = {"h": h_last, "conv": conv_tail.float()}
    else:
        u, conv_state = _conv1d(p, u, state["conv"])
        u = F.silu(u)
        y, h_new = selective_step(cfg, p, u, state["h"])
        new_state = {"h": h_new, "conv": conv_state.float()}
    out = layers.apply_linear(p["out_proj"], y * F.silu(z))
    return out, new_state
