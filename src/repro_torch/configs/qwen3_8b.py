"""Qwen3-8B [hf:Qwen/Qwen3-8B; hf].

36L, d_model 4096, 32 heads / 8 KV heads (GQA), head_dim 128, d_ff 12288,
SwiGLU, RMSNorm, per-head QK-norm, RoPE theta 1e6, no bias, vocab 151936.
"""

from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    pattern=(ATTN,),
    qk_norm=True,
    rope_theta=1e6,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=128)
