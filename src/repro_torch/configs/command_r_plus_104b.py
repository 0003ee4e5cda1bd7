"""Command R+ 104B [hf:CohereForAI/c4ai-command-r-plus; unverified].

64L, d_model 12288, 96 heads / 8 KV heads (GQA), d_ff 33792, SwiGLU,
LayerNorm (no bias modeled as standard LN), RoPE, no QKV bias, tied
embeddings, vocab 256000. (Cohere's parallel-block residual layout is
approximated with the standard sequential pre-norm block; noted in
DESIGN.md §7.)
"""

from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    pattern=(ATTN,),
    norm="layernorm",
    norm_eps=1e-5,
    rope_theta=75e6,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=128, vocab_size=128)
