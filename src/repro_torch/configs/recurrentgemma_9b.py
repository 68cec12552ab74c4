"""RecurrentGemma-9B — Griffin-style hybrid: RG-LRU + local attention (1:2).

[arXiv:2402.19427] 38L, d_model=4096, 16 heads (MQA kv=1, head_dim=256),
d_ff=12288, vocab=256000; block pattern (rec, rec, attn), local window 2048.
"""
from .base import ModelConfig, HybridConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,   # 12 x (rec, rec, attn) + 2 trailing rec
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    attention="gqa",
    rope_theta=1e4,
    tie_embeddings=True,
    hybrid=HybridConfig(block_pattern=("rec", "rec", "attn"),
                        lru_width=4096, local_window=2048, conv_width=4),
    source="arXiv:2402.19427 (Griffin / RecurrentGemma)",
)
