"""StarCoder2-3B [arXiv:2402.19173; hf].

30L, d_model 3072, 24 heads / 2 KV heads (GQA), d_ff 12288, GELU MLP
(non-gated), LayerNorm, RoPE, bias on projections, sliding window 4096,
tied embeddings, vocab 49152.
"""

from repro_torch.models.config import SWA, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    pattern=(SWA,),
    window=4096,
    mlp="gelu",
    mlp_bias=True,
    qkv_bias=True,
    norm="layernorm",
    norm_eps=1e-5,
    rope_theta=999999.4,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=128, window=16)
