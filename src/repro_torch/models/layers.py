"""Shared layers: norms, linear, RoPE, MLPs, embeddings. Plain functions on
tensors over dict params, as in ``repro.models.layers``.

Weights arrive already in the compute dtype (``models.convert`` and
``transformer.init_params`` cast once), so the ``.to(x.dtype)`` below is
a no-op on the hot path; the JAX package casts on every call, and a cast
made once gives the same numbers. Norm scales stay fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def to_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else _DTYPES[str(name)]


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return to_dtype(cfg.compute_dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, device, dim: Optional[int] = None) -> dict:
    dim = dim or cfg.d_model
    p = {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=torch.float32, device=device)
    return p


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm / LayerNorm computed entirely in fp32, output in x's dtype
    (the JAX package's default fp32-resident path)."""
    dt = x.dtype
    x = x.float()
    if cfg.norm == "layernorm":
        x = x - x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + cfg.norm_eps)
    x = x * p["scale"]
    if cfg.norm == "layernorm":
        x = x + p["bias"]
    return x.to(dt)


# ---------------------------------------------------------------------------
# Linear
# ---------------------------------------------------------------------------

def init_linear(gen: torch.Generator, d_in: int, d_out: int, device,
                dtype: torch.dtype, bias: bool = False,
                scale: Optional[float] = None) -> dict:
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, device=device) * scale
    p = {"kernel": w.to(dtype)}
    if bias:
        p["bias"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def apply_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["kernel"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(cfg: ModelConfig, positions: torch.Tensor):
    """positions [B, S] (int) -> (sin, cos) each [B, S, head_dim/2], fp32."""
    dh = cfg.head_dim
    exps = torch.arange(0, dh, 2, dtype=torch.float32,
                        device=positions.device) / dh
    inv = 1.0 / (cfg.rope_theta ** exps)
    ang = positions[..., None].float() * inv
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, dh]; rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[:, :, None, :].to(x.dtype)
    cos = cos[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# MLP (dense)
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen, device, dtype) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "w_gate": init_linear(gen, d, f, device, dtype, bias=cfg.mlp_bias),
            "w_up": init_linear(gen, d, f, device, dtype, bias=cfg.mlp_bias),
            "w_down": init_linear(gen, f, d, device, dtype, bias=cfg.mlp_bias,
                                  scale=f ** -0.5),
        }
    return {
        "w_up": init_linear(gen, d, f, device, dtype, bias=cfg.mlp_bias),
        "w_down": init_linear(gen, f, d, device, dtype, bias=cfg.mlp_bias,
                              scale=f ** -0.5),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


def apply_mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp == "swiglu" else _gelu
        h = act(apply_linear(p["w_gate"], x)) * apply_linear(p["w_up"], x)
    else:
        h = _gelu(apply_linear(p["w_up"], x))
    return apply_linear(p["w_down"], h)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def init_embed(cfg: ModelConfig, gen, device, dtype) -> dict:
    if cfg.conv_pos:
        raise NotImplementedError(
            "conv positional embeddings (HuBERT) are not ported yet: "
            "ROADMAP.md queue item Q5 (MoE, VLM and audio)")
    w = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                    device=device) * (cfg.d_model ** -0.5)
    p = {"tokens": w.to(dtype)}
    if not cfg.tie_embeddings:
        p["head"] = init_linear(gen, cfg.d_model, cfg.vocab_size, device,
                                dtype)
    return p


def embed_tokens(cfg: ModelConfig, p: dict, tokens: torch.Tensor
                 ) -> torch.Tensor:
    x = p["tokens"].to(cdtype(cfg))[tokens.long()]
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def lm_logits(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ p["tokens"].to(x.dtype).T
    return apply_linear(p["head"], x)
