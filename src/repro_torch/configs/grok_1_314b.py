"""Grok-1 314B — large MoE, 8 experts top-2.

[hf:xai-org/grok-1] 64L, d_model=6144, 48 heads (GQA kv=8),
per-expert d_ff=32768, vocab=131072, MoE 8e top-2.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    attention="gqa",
    rope_theta=1e4,
    moe=MoEConfig(num_experts=8, experts_per_token=2, capacity_factor=1.25),
    source="hf:xai-org/grok-1",
)
