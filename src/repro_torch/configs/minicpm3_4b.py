"""MiniCPM3-4B — dense decoder with Multi-head Latent Attention (MLA).

[hf:openbmb/MiniCPM3-4B] 62L, d_model=2560, 40 heads (kv=40 logical; MLA
caches a compressed latent), d_ff=6400, vocab=73448.
MLA dims per the model card: q_lora=768, kv_lora=256, qk_nope=64,
qk_rope=32, v=64.
"""
from .base import ModelConfig, MLAConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    vocab_size=73448,
    attention="mla",
    rope_theta=1e4,
    tie_embeddings=True,
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64),
    source="hf:openbmb/MiniCPM3-4B",
)
