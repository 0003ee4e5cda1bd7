"""Llama-3.2-11B-Vision backbone [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

Text decoder: 40L, d_model 4096, 32 heads / 8 KV heads, d_ff 14336, SwiGLU,
RMSNorm, RoPE theta 500000, vocab 128256, with cross-attention layers to
vision embeddings interleaved every 5th layer (8 of 40). The vision tower
is a STUB — input_specs feed precomputed patch embeddings
[B, frontend_tokens, d_model].
"""

from repro_torch.models.config import ATTN, XATTN, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    pattern=(ATTN, ATTN, ATTN, ATTN, XATTN),
    rope_theta=500000.0,
    cross_attn_every=5,
    frontend_tokens=1601,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=5, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=128, frontend_tokens=16)
