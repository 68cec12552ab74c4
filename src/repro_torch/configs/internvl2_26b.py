"""InternVL2-26B — InternViT-6B vision encoder + InternLM2-20B LLM.

[arXiv:2404.16821] Assigned backbone dims (the LLM we implement):
48L, d_model=6144, 48 heads (GQA kv=8), d_ff=16384, vocab=92553.
The InternViT encoder + MLP projector are a stub: ``input_specs``
provides precomputed patch embeddings of width d_model.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    attention="gqa",
    rope_theta=1e6,
    modality="vision",
    num_prefix_embeddings=1024,   # ViT patch tokens after pixel-shuffle
    source="arXiv:2404.16821 (InternVL2)",
)
