"""RG-LRU recurrent block (Griffin / RecurrentGemma): the port of
``repro.models.rglru``.

Recurrence (per channel):
    r_t = sigmoid(W_a x_t)                  (recurrence gate, block-diag)
    i_t = sigmoid(W_x x_t)                  (input gate, block-diag)
    a_t = exp(-c * softplus(Λ) * r_t)       (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t²) * (i_t * x_t)

Full-sequence mode computes the gates here and hands ``a`` and the gated
input (fp32) to the RG-LRU scan over the whole sequence: ``"flash"``
runs the CUDA kernel's wrapper (``kernels.rglru_scan``, which runs the
plain version only for a CPU tensor), ``"dense"`` the plain sequential
loop itself, ``"auto"`` flash on a CUDA device. The JAX package runs an
associative scan in chunks (``scan_utils.chunked_recurrence``) to bound
XLA's intermediates; the kernel carries h across the sequence itself, so
neither is ported. Decode is a single state update.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _shards, ref
from repro_torch.kernels import rglru_scan as scan_kernel
from repro_torch.models import attention, layers
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import shard

_C = 8.0


def init_rglru_block(cfg: ModelConfig, gen: torch.Generator, device,
                     dtype) -> dict:
    """Seeded random weights in the JAX package's layout. Λ stays fp32
    (the gates compute in fp32); other leaves are stored in ``dtype``."""
    d, w, hds = cfg.d_model, cfg.lru_width, cfg.lru_heads
    K = cfg.conv1d_width
    blk = w // hds
    # Λ init so that a ∈ [0.9, 0.999] roughly (Griffin appendix).
    lo, hi = 0.9 ** 2, 0.999 ** 2
    u = lo + (hi - lo) * torch.rand((w,), generator=gen, device=device)
    lam = torch.log(torch.expm1(-torch.log(u) / _C))

    def randn(shape, scale):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    return {
        "in_x": layers.init_linear(gen, d, w, device, dtype),
        "in_gate": layers.init_linear(gen, d, w, device, dtype),
        "conv1d": randn((K, w), K ** -0.5),
        "gate_a": randn((hds, blk, blk), blk ** -0.5),
        "gate_x": randn((hds, blk, blk), blk ** -0.5),
        "bias_a": torch.zeros((w,), dtype=dtype, device=device),
        "bias_x": torch.zeros((w,), dtype=dtype, device=device),
        "lam": lam,
        "out": layers.init_linear(gen, w, d, device, dtype, scale=w ** -0.5),
    }


def _block_diag(p: dict, which: str, x: torch.Tensor) -> torch.Tensor:
    """[B,S,W] through block-diagonal [heads, blk, blk] weights."""
    B, S, W = x.shape
    hds, blk, _ = p[f"gate_{which}"].shape
    # Under TP the gate heads split over TP with x's channels (whole
    # heads per shard), or nothing does.
    tp = "tp" if hds % attention._tp_size() == 0 else None
    x = shard(x, "dp", None, tp)
    w = shard(p[f"gate_{which}"], tp, None, None)
    bias = shard(p[f"bias_{which}"], tp)
    xh = x.reshape(B, S, hds, blk)
    y = torch.einsum("bshi,hij->bshj", xh, w.to(x.dtype))
    # Channels over TP again, as the gates and the scan take them (and so
    # their gradient comes back whole before it is split into heads).
    y = shard(y.reshape(B, S, W), "dp", None, "tp")
    return y + bias.to(x.dtype)


def _conv1d(p: dict, x: torch.Tensor,
            state: Optional[torch.Tensor] = None):
    """Causal depthwise conv of width K. state [B, K-1, W] for decode.
    Returns (out [B,S,W], the last K-1 inputs)."""
    K = p["conv1d"].shape[0]
    w = p["conv1d"].to(x.dtype)
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    new_state = xp[:, xp.shape[1] - (K - 1):, :]
    S = x.shape[1]
    out = xp[:, 0:S, :] * w[0]
    for i in range(1, K):           # the JAX package's summation order
        out = out + xp[:, i:i + S, :] * w[i]
    return out, new_state


def _gates(cfg: ModelConfig, p: dict, x: torch.Tensor):
    r = torch.sigmoid(_block_diag(p, "a", x).float())
    i = torch.sigmoid(_block_diag(p, "x", x).float())
    log_a = -_C * F.softplus(p["lam"].float()) * r        # [B,S,W] fp32
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    gated = mult * i * x.float()
    return a, gated


def rglru_scan(cfg: ModelConfig, p: dict, x: torch.Tensor,
               h0: torch.Tensor, impl: str = "auto"):
    """Full-sequence RG-LRU recurrence. x [B,S,W], h0 [B,W] fp32 ->
    (y [B,S,W] in x's dtype, h_S fp32)."""
    a, gated = _gates(cfg, p, x)
    if attention._resolve_impl(impl, x) == "flash":
        y, h_last = scan_kernel.rglru_scan(a, gated, h0.float())
    elif _shards.is_dtensor(gated):     # the plain loop on local shards
        y, h_last = _shards.on_shards(ref.rglru_scan, (a, gated, h0),
                                      *scan_kernel.shard_placements(gated))
    else:
        y, h_last = ref.rglru_scan(a, gated, h0)
    return y.to(x.dtype), h_last


def rglru_step(cfg: ModelConfig, p: dict, x: torch.Tensor,
               h: torch.Tensor):
    """Single-token recurrence. x [B,1,W], h [B,W] fp32."""
    a, gated = _gates(cfg, p, x)
    h_new = a[:, 0] * h + gated[:, 0]
    return h_new.to(x.dtype)[:, None, :], h_new


def init_rglru_state(cfg: ModelConfig, batch: int, device) -> dict:
    K = cfg.conv1d_width
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, cfg.lru_width), **f32),
            "conv": torch.zeros((batch, K - 1, cfg.lru_width), **f32)}


def apply_rglru_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      state: Optional[dict] = None,
                      want_state: bool = False, impl: str = "auto"):
    """Griffin recurrent block: gate branch ⊙ GELU branch, then out-proj.

    x [B,S,D] -> [B,S,D]. With ``state`` (decode) S must be 1; returns
    (out, new_state). ``want_state=True`` (prefill) returns the final
    recurrence/conv state of a full-sequence pass; ``impl`` picks the
    scan of a full-sequence pass.
    """
    gate = layers._gelu(layers.apply_linear(p["in_gate"], x))     # [B,S,W]
    xin = layers.apply_linear(p["in_x"], x)                        # [B,S,W]
    xin = shard(xin, "dp", None, "tp")
    if state is None:
        xin, conv_tail = _conv1d(p, xin)
        h0 = torch.zeros((x.shape[0], cfg.lru_width), dtype=torch.float32,
                         device=x.device)
        y, h_last = rglru_scan(cfg, p, xin, h0, impl)
        new_state = None
        if want_state:
            new_state = {"h": h_last.float(), "conv": conv_tail.float()}
    else:
        xin, conv_state = _conv1d(p, xin, state["conv"])
        y, h_new = rglru_step(cfg, p, xin, state["h"])
        new_state = {"h": h_new, "conv": conv_state.float()}
    out = layers.apply_linear(p["out"], y * gate)
    return out, new_state
