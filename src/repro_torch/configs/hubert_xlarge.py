"""HuBERT-XLarge backbone [arXiv:2106.07447; unverified].

Encoder-only (bidirectional) transformer, same arch as wav2vec 2.0:
48L, d_model 1280, 16 heads (MHA), d_ff 5120, GELU MLP, LayerNorm,
conv positional embedding. vocab 504 = masked-prediction codebook size.
The CNN audio frontend is a STUB — input_specs feed precomputed frame
embeddings [B, S, d_model]; decode shapes are inapplicable (no AR step).
"""

from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    pattern=(ATTN,),
    causal=False,
    rope=False,
    conv_pos=True,
    mlp="gelu",
    mlp_bias=True,
    qkv_bias=True,
    norm="layernorm",
    norm_eps=1e-5,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=128, conv_pos_width=8, conv_pos_groups=4)
