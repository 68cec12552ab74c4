"""MusicGen-large — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284] 48L, d_model=2048, 32 heads (kv=32, i.e. MHA),
d_ff=8192, vocab=2048 (EnCodec codebook size). The EnCodec/conditioning
frontend is a stub: ``input_specs`` provides precomputed frame embeddings.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    attention="gqa",
    rope_theta=1e4,
    modality="audio",
    num_prefix_embeddings=256,   # conditioning frames from the codec stub
    source="arXiv:2306.05284 (MusicGen)",
)
