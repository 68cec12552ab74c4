"""Llama-3.2-1B — small dense llama3.

[hf:meta-llama/Llama-3.2-1B] 16L, d_model=2048, 32 heads (GQA kv=8),
d_ff=8192, vocab=128256.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    attention="gqa",
    rope_theta=5e5,
    tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B",
)
