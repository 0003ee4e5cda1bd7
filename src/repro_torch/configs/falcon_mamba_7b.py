"""Falcon-Mamba-7B [arXiv:2410.05355; unverified].

64 Mamba-1 blocks (attention-free), d_model 4096, d_inner 8192 (expand 2),
ssm_state 16, conv width 4, dt_rank 256, RMSNorm, vocab 65024. d_ff=0
(the Mamba block subsumes the MLP).
"""

from repro_torch.models.config import MAMBA, ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    pattern=(MAMBA,),
    rope=False,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, vocab_size=128, ssm_state=4,
        ssm_dt_rank=8)
