"""Unified model configuration covering all assigned architecture families.

One dataclass describes dense GQA transformers, MoE (Mixtral), hybrid
recurrent (RecurrentGemma RG-LRU + local attention), pure SSM (Mamba-1),
encoder-only audio (HuBERT) and cross-attention VLM (Llama-3.2-Vision)
backbones. Layer stacks are described as a repeating *superblock pattern*
plus a remainder, so depth runs under ``jax.lax.scan`` with stacked params
(compile time and HLO size independent of depth).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

# Block kinds usable in a superblock pattern.
ATTN = "attn"          # global self-attention (+ MLP)
SWA = "swa"            # sliding-window self-attention (+ MLP)
LOCAL = "local"        # local attention, RecurrentGemma style (+ MLP)
XATTN = "xattn"        # cross-attention to frontend embeddings (+ MLP)
RGLRU = "rglru"        # RG-LRU recurrent block (+ MLP)
MAMBA = "mamba"        # Mamba-1 block (no separate MLP)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # --- layer pattern -----------------------------------------------------
    # The layer stack is `pattern` repeated, then `remainder` extra entries.
    # Default: homogeneous causal attention.
    pattern: tuple[str, ...] = (ATTN,)

    # --- attention -----------------------------------------------------------
    head_dim: Optional[int] = None           # default d_model // num_heads
    causal: bool = True                      # False => encoder-only
    qkv_bias: bool = False                   # qwen2 / starcoder2
    qk_norm: bool = False                    # qwen3
    rope: bool = True
    rope_theta: float = 10_000.0
    window: Optional[int] = None             # SWA / local-attn window
    logit_softcap: Optional[float] = None

    # --- MLP -----------------------------------------------------------------
    mlp: str = "swiglu"                      # swiglu | geglu | gelu
    mlp_bias: bool = False

    # --- norms / embeddings ----------------------------------------------------
    norm: str = "rmsnorm"                    # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    scale_embed: bool = False                # multiply embed by sqrt(d_model)
    conv_pos: bool = False                   # HuBERT conv positional embedding
    conv_pos_width: int = 128
    conv_pos_groups: int = 16

    # --- MoE -----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_loss: float = 0.02

    # --- SSM (Mamba-1) ----------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0                     # default ceil(d_model / 16)

    # --- RG-LRU (RecurrentGemma) --------------------------------------------------
    lru_width: int = 0
    lru_heads: int = 8                       # block-diagonal gate heads
    conv1d_width: int = 4

    # --- VLM / audio frontends (stubs feed precomputed embeddings) -------------
    cross_attn_every: int = 0                # kept for docs; pattern encodes it
    frontend_tokens: int = 0                 # image patches / audio frames

    # --- dtypes ------------------------------------------------------------------
    param_dtype: str = "float32"             # master weights
    compute_dtype: str = "bfloat16"

    # ---------------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim is None and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.ssm_state and not self.ssm_dt_rank:
            object.__setattr__(self, "ssm_dt_rank",
                               int(math.ceil(self.d_model / 16)))
        if self.num_layers % len(self.pattern) and self.family == "moe":
            raise ValueError("MoE stacks must tile the pattern exactly")

    # --- pattern helpers -----------------------------------------------------
    @property
    def num_repeats(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def remainder(self) -> tuple[str, ...]:
        return self.pattern[: self.num_layers % len(self.pattern)]

    @property
    def attention_free(self) -> bool:
        kinds = set(self.pattern) | set(self.remainder)
        return not (kinds & {ATTN, SWA, LOCAL, XATTN})

    @property
    def decode_supported(self) -> bool:
        return self.causal  # encoder-only models have no autoregressive step

    @property
    def subquadratic(self) -> bool:
        """True if per-token serve cost is O(1) in context length."""
        kinds = set(self.pattern) | set(self.remainder)
        return ATTN not in kinds and XATTN not in kinds

    # --- parameter counting (for MODEL_FLOPS = 6·N·D) -------------------------
    def _block_params(self, kind: str) -> int:
        d, f = self.d_model, self.d_ff
        h, kv, dh = self.num_heads, self.num_kv_heads, (self.head_dim or 0)
        n = 0
        if kind in (ATTN, SWA, LOCAL, XATTN):
            n += d * (h * dh) + 2 * d * (kv * dh) + (h * dh) * d  # q k v o
            if self.qkv_bias:
                n += (h + 2 * kv) * dh
            if self.qk_norm:
                n += 2 * dh
            n += d  # pre-norm
            if kind == XATTN:
                n += d  # kv norm (stub-side embeddings are normed)
            # MLP attached to attention blocks
            n += self._mlp_params()
        elif kind == RGLRU:
            w = self.lru_width
            n += 2 * d * w + w * d          # in-proj x2, out-proj
            n += self.conv1d_width * w      # temporal conv
            n += 2 * w * w // self.lru_heads + 2 * w  # block-diag gate projections
            n += w                          # Lambda
            n += d                          # pre-norm
            n += self._mlp_params()
        elif kind == MAMBA:
            di = self.ssm_expand * self.d_model
            dt = self.ssm_dt_rank
            s = self.ssm_state
            n += d * 2 * di                 # in_proj
            n += self.ssm_conv * di         # depthwise conv
            n += di * (dt + 2 * s)          # x_proj
            n += dt * di + di               # dt_proj
            n += di * s + di                # A_log, D
            n += di * d                     # out_proj
            n += d                          # pre-norm
        else:
            raise ValueError(kind)
        return n

    def _mlp_params(self) -> int:
        d, f = self.d_model, self.d_ff
        if self.num_experts:
            per = 3 * d * f  # swiglu experts
            return self.num_experts * per + d * self.num_experts + d  # + router + norm
        if self.mlp in ("swiglu", "geglu"):
            n = 3 * d * f
        else:
            n = 2 * d * f + (f + d if self.mlp_bias else 0)
        return n + d  # + pre-norm

    def _active_mlp_params(self) -> int:
        if not self.num_experts:
            return self._mlp_params()
        d, f = self.d_model, self.d_ff
        return self.experts_per_token * 3 * d * f + d * self.num_experts + d

    def param_count(self) -> int:
        layers = list(self.pattern) * self.num_repeats + list(self.remainder)
        n = sum(self._block_params(k) for k in layers)
        n += self.vocab_size * self.d_model          # embed
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model      # separate output head
        n += self.d_model                            # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.num_experts:
            return self.param_count()
        layers = list(self.pattern) * self.num_repeats + list(self.remainder)
        n = 0
        for k in layers:
            full = self._block_params(k)
            n += full - self._mlp_params() + self._active_mlp_params()
        n += self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        n += self.d_model
        return n


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int
    # decode: seq_len is the KV-cache / context length; one new token is fed.


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_applicability(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """None if the (arch, shape) cell runs; else a human-readable skip reason."""
    if shape.kind == "decode" and not cfg.decode_supported:
        return "encoder-only architecture: no autoregressive decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("full global attention: 524k dense KV cache is O(seq) memory "
                "and per-token compute; shape reserved for sub-quadratic archs")
    return None
