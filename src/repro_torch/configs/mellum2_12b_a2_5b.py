"""Mellum2-12B-A2.5B [hf: JetBrains/Mellum2-12B-A2.5B-Instruct].

28L, d_model 2304, 32 heads / 4 KV heads (GQA) at head_dim 128, no
attention bias; layers three sliding-window (1024) then one full, seven
times; RoPE theta 5e5, YaRN (factor 16 over 8192 positions) on the full
layers only; a sparse MLP in every layer: 64 SwiGLU experts of width 896,
top-8 renormalised, no shared expert, routed without dropping; RMSNorm
eps 1e-6, untied head, vocab 98304. The config names no q/k norm and no
aux-loss coefficient (0.001, the Qwen-MoE default, is taken), and
declares no MTP head, so none is built.
"""

from repro_torch.models.config import ATTN, SWA, ModelConfig, YaRN

CONFIG = ModelConfig(
    name="mellum2-12b-a2.5b",
    family="moe",
    num_layers=28,
    d_model=2304,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=896,
    vocab_size=98304,
    pattern=(SWA, SWA, SWA, ATTN),
    window=1024,
    rope_theta=5e5,
    rope_yarn=YaRN(factor=16.0, original_max_positions=8192,
                   beta_fast=32.0, beta_slow=1.0,
                   attention_factor=1.2772588722239782),
    num_experts=64,
    experts_per_token=8,
    moe_dropless=True,
    router_aux_loss=0.001,
)


def reduced() -> ModelConfig:
    """Two periods of the pattern at tiny widths: 16 experts top-4 of
    which this device holds experts 4-11, a window of 16, and the
    published YaRN, whose ramp at head_dim 16 blends frequency pairs 3
    and 4 and divides 5-7 by the factor."""
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=32, vocab_size=128, window=16, num_experts=16,
        experts_per_token=4, experts_held=(4, 12))
