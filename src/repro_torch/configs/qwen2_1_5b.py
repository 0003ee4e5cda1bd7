"""Qwen2-1.5B [arXiv:2407.10671; hf].

28L, d_model 1536, 12 heads / 2 KV heads (GQA), d_ff 8960, SwiGLU,
RMSNorm, RoPE theta 1e6, QKV bias, tied embeddings, vocab 151936.
"""

from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    pattern=(ATTN,),
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=128)
