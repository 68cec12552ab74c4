"""Qwen2.5-32B — dense GQA decoder with QKV bias.

[hf:Qwen/Qwen2.5-0.5B] family config scaled per the assignment brief:
64L, d_model=5120, 40 heads (GQA kv=8), d_ff=27648, vocab=152064.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    attention="gqa",
    qkv_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-0.5B (family card, 32B variant dims)",
)
