"""Model / input-shape configuration dataclasses.

Every assigned architecture is expressed as a single ``ModelConfig``; the
model builder in ``repro.models.model`` consumes it to construct parameter
pytrees, train/prefill/decode step functions, and the node-level graph used
by the LazyBatching scheduler.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style)."""
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD configuration."""
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256
    conv_width: int = 4
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma / Griffin style block pattern."""
    # Pattern applied cyclically, e.g. ("rec", "rec", "attn").
    block_pattern: Tuple[str, ...] = ("rec", "rec", "attn")
    lru_width: int = 0           # 0 -> d_model
    local_window: int = 2048
    conv_width: int = 4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    source: str = ""             # citation from the assignment brief

    attention: str = "gqa"       # gqa | mla | none
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # Long-context variant: when serving ``long_500k`` on attention archs we
    # switch to a ring-buffer sliding window of this many tokens (DESIGN.md §5).
    long_context_window: int = 8192

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None

    # Modality stubs: [audio]/[vlm] archs receive ``num_prefix_embeddings``
    # precomputed frame/patch embeddings of width d_model from the frontend
    # stub in train/prefill shapes (the brief's one allowed carve-out).
    modality: Optional[str] = None       # "vision" | "audio"
    num_prefix_embeddings: int = 0

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.attention == "none" and self.ssm is None:
            raise ValueError("attention='none' requires an SSMConfig — "
                             "an attention-free arch must be SSM")

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d = self.d_model
        n = 0
        n += self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            n += d * self.vocab_size                  # unembed
        n += self.num_layers * self._block_params() + d  # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        full_ffn = 3 * d * self.d_ff * self.moe.num_experts
        act_ffn = 3 * d * self.d_ff * self.moe.experts_per_token
        return self.param_count() - self.num_layers * (full_ffn - act_ffn)

    def _attn_params(self) -> int:
        d = self.d_model
        if self.attention == "mla":
            m = self.mla
            qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
            n = d * m.q_lora_rank + m.q_lora_rank * self.num_heads * qk_dim
            n += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            n += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
            n += self.num_heads * m.v_head_dim * d
            return n
        n = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            n += self.q_dim + 2 * self.kv_dim
        return n

    def _ffn_params(self) -> int:
        d = self.d_model
        if self.moe is not None:
            router = d * self.moe.num_experts
            return router + 3 * d * self.d_ff * self.moe.num_experts
        return 3 * d * self.d_ff      # SwiGLU: gate, up, down

    def _ssm_params(self) -> int:
        s = self.ssm
        d = self.d_model
        di = s.d_inner(d)
        nh = s.n_heads(d)
        conv_dim = di + 2 * s.n_groups * s.d_state
        n = d * (2 * di + 2 * s.n_groups * s.d_state + nh)   # in_proj (z,x,B,C,dt)
        n += conv_dim * s.conv_width                          # conv1d
        n += nh * 2                                           # A_log, D
        n += di * d                                           # out_proj
        return n

    def _block_params(self) -> int:
        d = self.d_model
        if self.family == "ssm":
            return self._ssm_params() + d
        if self.hybrid is not None:
            h = self.hybrid
            pat = h.block_pattern
            lru_w = h.lru_width or d
            # recurrent block: in projections, conv, RG-LRU gates, out proj
            rec = d * lru_w * 2 + lru_w * h.conv_width + 3 * lru_w * lru_w + lru_w * d
            attn = self._attn_params()
            per = {"rec": rec + 2 * d, "attn": attn + 2 * d}
            total = sum(per[b] for b in pat) + len(pat) * self._ffn_params()
            return total // len(pat)   # average per layer
        return self._attn_params() + self._ffn_params() + 2 * d

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, 256)
        hd = min(self.head_dim, 64)
        nh = max(2, min(self.num_heads, 4))
        nkv = max(1, min(self.num_kv_heads, nh))
        if nh % nkv:
            nkv = 1
        kw = dict(
            num_layers=2 if self.hybrid is None else len(self.hybrid.block_pattern),
            d_model=d,
            num_heads=nh,
            num_kv_heads=nkv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) or 0,
            vocab_size=min(self.vocab_size, 512),
            num_prefix_embeddings=min(self.num_prefix_embeddings, 8),
            long_context_window=256,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4,
                experts_per_token=min(self.moe.experts_per_token, 2))
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                  qk_nope_head_dim=32, qk_rope_head_dim=16,
                                  v_head_dim=32)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=32,
                                            chunk_size=32)
        if self.hybrid is not None:
            kw["hybrid"] = dataclasses.replace(self.hybrid, lru_width=0,
                                               local_window=64)
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}
