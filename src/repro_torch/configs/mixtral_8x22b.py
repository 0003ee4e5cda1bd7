"""Mixtral-8x22B [arXiv:2401.04088; hf].

56L, d_model 6144, 48 heads / 8 KV heads (GQA), expert d_ff 16384,
8 experts top-2 (SwiGLU experts), sliding-window attention (4096),
RMSNorm, RoPE theta 1e6, vocab 32768.
"""

from repro_torch.models.config import SWA, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    pattern=(SWA,),
    window=4096,
    num_experts=8,
    experts_per_token=2,
    rope_theta=1e6,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=128, window=16, num_experts=4,
        moe_capacity_factor=8.0)
