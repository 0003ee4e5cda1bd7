"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427; hf].

26L, d_model 2560, pattern = (RG-LRU, RG-LRU, local attention) — the 1:2
local-attn : recurrent ratio (26 = 8×3 + 2 remainder). 10 heads / 1 KV
head (MQA), head_dim 256, d_ff 7680 (GeGLU), lru_width 2560, local window
2048, RMSNorm, tied + scaled embeddings, vocab 256000. Attention layers
use no RoPE beyond local positions (modeled with RoPE for simplicity).
"""

from repro_torch.models.config import LOCAL, RGLRU, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    pattern=(RGLRU, RGLRU, LOCAL),
    window=2048,
    lru_width=2560,
    lru_heads=8,
    conv1d_width=4,
    mlp="geglu",
    tie_embeddings=True,
    scale_embed=True,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=5, d_model=64, num_heads=4, num_kv_heads=1,
        head_dim=16, d_ff=128, vocab_size=128, window=16, lru_width=64,
        lru_heads=4)
