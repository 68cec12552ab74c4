"""Granite-3.0 MoE 3B-a800m — fine-grained MoE, 40 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base] family; assigned dims:
32L, d_model=1536, 24 heads (GQA kv=8), per-expert d_ff=512,
vocab=49155, MoE 40 experts top-8.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    attention="gqa",
    rope_theta=1e4,
    tie_embeddings=True,
    moe=MoEConfig(num_experts=40, experts_per_token=8, capacity_factor=1.25),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (family card)",
)
