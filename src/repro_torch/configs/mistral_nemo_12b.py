"""Mistral-Nemo-12B — dense GQA decoder, 128k context.

[hf:mistralai/Mistral-Nemo-Base-2407] 40L, d_model=5120, 32 heads
(GQA kv=8, head_dim=128), d_ff=14336, vocab=131072.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    attention="gqa",
    rope_theta=1e6,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)
