"""Mamba2-2.7B — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060] 64L, d_model=2560 (d_inner=5120, 80 heads of 64),
ssm_state=128, vocab=50280.
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    attention="none",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, chunk_size=256,
                  conv_width=4, n_groups=1),
    source="arXiv:2405.21060 (Mamba-2 / SSD)",
)
