"""Mixtral-8x7B [arXiv:2401.04088; hf].

32L, d_model 4096, 32 heads / 8 KV heads (GQA), expert d_ff 14336,
8 experts top-2, sliding-window attention (4096), RMSNorm, RoPE, vocab 32000.
"""

from repro_torch.models.config import SWA, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
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
