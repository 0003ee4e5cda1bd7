"""Shared layers: norms, linear, RoPE, MLPs, embeddings. Plain functions on
tensors over dict params, as in ``repro.models.layers``.

Weights arrive already in the compute dtype (``models.convert`` and
``transformer.init_params`` cast once), so the ``.to(x.dtype)`` below is
a no-op on the hot path; the JAX package casts on every call, and a cast
made once gives the same numbers. Norm scales stay fp32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import _shards
from repro_torch.models.config import ATTN, ModelConfig, YaRN
from repro_torch.sharding import gather_fsdp, shard

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


# Dtype in which norm *tensors* live (hillclimb lever). "float32"
# (default) upcasts the whole [B,S,D] activation; "compute" keeps
# tensor-sized values in the compute dtype and does only the reductions
# (mean/var) in fp32.
NORM_RESIDENT_DTYPE = "float32"


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm / LayerNorm, output in x's dtype: entirely in fp32 (the
    JAX package's default fp32-resident path), or with tensor-sized
    values in x's dtype under ``NORM_RESIDENT_DTYPE = "compute"``."""
    dt = x.dtype
    if NORM_RESIDENT_DTYPE == "float32":
        x = x.float()
        if cfg.norm == "layernorm":
            x = x - x.mean(-1, keepdim=True)
        var = (x * x).mean(-1, keepdim=True)
        x = x * torch.rsqrt(var + cfg.norm_eps)
        x = x * p["scale"]
        if cfg.norm == "layernorm":
            x = x + p["bias"]
        return x.to(dt)
    if cfg.norm == "layernorm":
        mu = x.float().mean(-1, keepdim=True)
        x = x - mu.to(dt)
    var = torch.square(x.float()).mean(-1, keepdim=True)
    inv = torch.rsqrt(var + cfg.norm_eps)
    x = x * inv.to(dt)
    x = x * p["scale"].to(dt)
    if cfg.norm == "layernorm":
        x = x + p["bias"].to(dt)
    return x


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
    if isinstance(x, DTensor):
        return _linear_sharded(p, x)
    y = x @ p["kernel"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def _linear_sharded(p: dict, x) -> torch.Tensor:
    """``apply_linear`` on DTensors, laid out as Megatron's column- and
    row-parallel layers: the weight gathered over the data-parallel axes
    (``gather_fsdp``) and sharded over TP as stored; on a mesh axis that
    shards the weight's output features, x is whole there and y comes out
    sharded; where it shards its input features, x is sharded to match
    and y is a partial sum; elsewhere x keeps its rows' sharding. The
    products run on local shards (``local_map``), so DTensor picks no
    strategy of its own, forward or backward."""
    w = gather_fsdp(p["kernel"].to(x.dtype))
    last = x.dim() - 1
    xp, yp = [], []
    for xpl, wpl in zip(x.placements, w.placements):
        if isinstance(wpl, Shard) and wpl.dim == 1:        # column
            xp.append(xpl if isinstance(xpl, Shard) and xpl.dim < last
                      else Replicate())
            yp.append(Shard(last))
        elif isinstance(wpl, Shard):                        # row
            xp.append(Shard(last))
            yp.append(Partial())
        else:
            keep = isinstance(xpl, Shard) and xpl.dim < last
            xp.append(xpl if keep else Replicate())
            yp.append(xp[-1])
    bias = p.get("bias")
    # A bias joins a column shard locally, and a partial sum after it.
    local_bias = bias is not None and not any(
        isinstance(pl, Partial) for pl in yp)
    args, in_pl = (x, w), (tuple(xp), tuple(w.placements))
    if local_bias:
        args += (bias.to(x.dtype),)
        in_pl += (tuple(Shard(0) if isinstance(pl, Shard) and pl.dim == last
                        else Replicate() for pl in yp),)
    y = _shards.on_shards(_matmul_bias, args, in_pl, tuple(yp))
    if bias is not None and not local_bias:
        y = y + bias.to(x.dtype)
    return y


def _matmul_bias(x, w, b=None):
    return x @ w if b is None else x @ w + b


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(cfg: ModelConfig, positions: torch.Tensor, kind: str):
    """positions [B, S] (int) -> (sin, cos) each [B, S, head_dim/2], fp32,
    for a block of ``kind``: the ATTN blocks of a config with
    ``rope_yarn`` rotate by YaRN's frequencies, with cos and sin times
    its attention factor (``yarn_inv_freq``); every other block by
    theta's."""
    dh = cfg.head_dim
    if cfg.rope_yarn is not None and kind == ATTN:
        inv, scale = yarn_inv_freq(cfg.rope_yarn, cfg.rope_theta, dh,
                                   positions.device)
        ang = positions[..., None].float() * inv
        return torch.sin(ang) * scale, torch.cos(ang) * scale
    exps = torch.arange(0, dh, 2, dtype=torch.float32,
                        device=positions.device) / dh
    inv = 1.0 / (cfg.rope_theta ** exps)
    ang = positions[..., None].float() * inv
    return torch.sin(ang), torch.cos(ang)


def yarn_correction_range(y: YaRN, theta: float,
                          dh: int) -> tuple[int, int]:
    """The frequency pairs over which YaRN's ramp runs: where a pair
    turns ``beta_fast`` and ``beta_slow`` times over
    ``original_max_positions``, rounded outward to whole pairs, within
    [0, dh - 1] (Hugging Face's ``find_correction_range`` with
    ``truncate``)."""
    def pair(rotations: float) -> float:
        return (dh * math.log(y.original_max_positions
                              / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    low = math.floor(pair(y.beta_fast))
    high = math.ceil(pair(y.beta_slow))
    return max(low, 0), min(high, dh - 1)


def yarn_inv_freq(y: YaRN, theta: float, dh: int,
                  device) -> tuple[torch.Tensor, float]:
    """(inverse frequencies [dh/2] fp32, attention factor): theta's
    frequencies below the ramp, the same divided by ``factor`` above it,
    blended linearly across it, as Hugging Face's
    ``_compute_yarn_parameters`` computes them."""
    pos_freqs = theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                       device=device) / dh)
    extrapolated = 1.0 / pos_freqs
    interpolated = 1.0 / (y.factor * pos_freqs)
    low, high = yarn_correction_range(y, theta, dh)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dh // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    keep = 1 - ramp                 # the share of the original frequency
    inv = interpolated * (1 - keep) + extrapolated * keep
    return inv, y.attention_factor


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
    h = shard(h, "dp", None, "tp")
    return apply_linear(p["w_down"], h)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def init_embed(cfg: ModelConfig, gen, device, dtype) -> dict:
    w = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                    device=device) * (cfg.d_model ** -0.5)
    p = {"tokens": w.to(dtype)}
    if not cfg.tie_embeddings:
        p["head"] = init_linear(gen, cfg.d_model, cfg.vocab_size, device,
                                dtype)
    if cfg.conv_pos:
        # HuBERT's grouped conv positional embedding, in the JAX layout
        # [width, D / groups, D] (lax.conv's WIO).
        w, g = cfg.conv_pos_width, cfg.conv_pos_groups
        k = torch.randn((w, cfg.d_model // g, cfg.d_model), generator=gen,
                        device=device) * ((w * cfg.d_model // g) ** -0.5)
        p["conv_pos"] = k.to(dtype)
    return p


def embed_tokens(cfg: ModelConfig, p: dict, tokens: torch.Tensor
                 ) -> torch.Tensor:
    table = p["tokens"].to(cdtype(cfg))
    if isinstance(table, DTensor):
        x = _lookup_sharded(table, tokens.long())
    else:
        x = table[tokens.long()]
    x = shard(x, "dp", None, None)
    if cfg.scale_embed:
        # A fill on the device, not a copy from the host: a CUDA graph
        # of the training pass can hold it.
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
                           device=x.device)
    return x


def _lookup_sharded(table, ids) -> torch.Tensor:
    """``table[ids]`` on DTensors: the table, vocab-(row-)sharded over
    the FSDP axis, gathered at use as every FSDP weight is, then each
    device looks up its own rows of ids (``local_map``; DTensor's own
    lookup and its backward differ between releases)."""
    table = gather_fsdp(table)
    t_pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 0 else p
                 for p in table.placements)
    i_pl = (_shards.moved(ids.placements, {d: d for d in range(ids.dim())})
            if isinstance(ids, DTensor)
            else (Replicate(),) * table.device_mesh.ndim)
    out_pl = tuple(a if isinstance(a, Shard) else
                   Shard(ids.dim()) if isinstance(b, Shard) else Replicate()
                   for a, b in zip(i_pl, t_pl))
    return _shards.on_shards(lambda t, i: t[i], (table, ids), (t_pl, i_pl),
                             out_pl)


def add_conv_pos(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x + gelu(grouped conv1d of x over the sequence), with XLA's SAME
    padding: width - 1 zeros split with the smaller half on the left (63
    left and 64 right at HuBERT's even width 128). A no-op without the
    ``conv_pos`` leaf."""
    if "conv_pos" not in p:
        return x
    w = p["conv_pos"].to(x.dtype)
    if isinstance(x, DTensor):
        # Each device convolves its own rows with the whole kernel
        # (DTensor's convolution strategies shard channels or frames).
        x = shard(x, "dp", None, None)
        pl = _shards.moved(x.placements, {0: 0})
        rep = _shards.moved(x.placements, {})
        pos = _shards.on_shards(
            lambda x, w: _conv_pos(x, w, cfg.conv_pos_groups), (x, w),
            (pl, rep), pl)
    else:
        pos = _conv_pos(x, w, cfg.conv_pos_groups)
    return x + _gelu(pos)


def _conv_pos(x: torch.Tensor, w: torch.Tensor, groups: int) -> torch.Tensor:
    """The grouped conv1d of x [B,S,D] over S with the WIO kernel ``w``,
    XLA's SAME padding."""
    w = w.permute(2, 1, 0)                             # WIO -> [D, D/g, W]
    width = w.shape[-1]
    left = (width - 1) // 2
    xt = F.pad(x.transpose(1, 2), (left, width - 1 - left))
    return F.conv1d(xt, w, groups=groups).transpose(1, 2)


def lm_logits(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        # Resharded vocab-sharded so logits come out vocab-sharded from
        # a local product.
        w = shard(p["tokens"], "tp", None)
        return x @ w.to(x.dtype).T
    return apply_linear(p["head"], x)
