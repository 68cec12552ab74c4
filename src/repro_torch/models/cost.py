"""Analytic per-node FLOPs / bytes cost model.

Used by three consumers:
  * the NPU latency model (``repro.serving.npu_model``) — per-node latency
    estimation, exactly the paper's ``NodeLatency(n)`` lookup table,
  * the SLA-aware slack predictor (Algorithm 1),
  * the roofline analysis (MODEL_FLOPS = 6·N·D terms and cross-checks).

All numbers are *forward* costs for one node (layer) at a given batch /
sequence / context. Weight bytes are separated from activation bytes because
batching amortizes weight traffic — the effect that produces the paper's
Fig. 3 throughput curve.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..configs.base import ModelConfig


@dataclass(frozen=True)
class NodeCost:
    name: str
    flops: float          # per execution of this node (whole batch)
    weight_bytes: float   # parameter traffic (batch-independent)
    act_bytes: float      # activation traffic (scales with batch)


def _attn_flops(cfg: ModelConfig, b: int, s: int, ctx: int,
                window: Optional[int]) -> float:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.attention == "mla":
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        proj = 2 * b * s * (d * m.q_lora_rank + m.q_lora_rank * h * qk
                            + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                            + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
                            + h * m.v_head_dim * d)
        eff_ctx = min(ctx, window) if window else ctx
        att = 2 * b * s * h * eff_ctx * (qk + m.v_head_dim)
        return proj + att
    proj = 2 * b * s * d * (h * hd + 2 * kv * hd + h * hd)
    eff_ctx = min(ctx, window) if window else ctx
    att = 2 * b * s * h * eff_ctx * 2 * hd
    return proj + att


def _attn_weight_bytes(cfg: ModelConfig, dtype_bytes: int) -> float:
    return cfg._attn_params() * dtype_bytes


def _mlp_flops(cfg: ModelConfig, b: int, s: int) -> float:
    return 2 * b * s * 3 * cfg.d_model * cfg.d_ff


def _moe_flops(cfg: ModelConfig, b: int, s: int) -> float:
    m = cfg.moe
    router = 2 * b * s * cfg.d_model * m.num_experts
    # capacity-bounded expert compute (sort-based dispatch, DESIGN.md §3)
    active = 2 * b * s * m.experts_per_token * 3 * cfg.d_model * cfg.d_ff
    return router + active * m.capacity_factor


def _ssm_flops(cfg: ModelConfig, b: int, s: int) -> float:
    sm = cfg.ssm
    d = cfg.d_model
    di = sm.d_inner(d)
    nh = sm.n_heads(d)
    N = sm.d_state
    proj = 2 * b * s * d * (2 * di + 2 * N + nh) + 2 * b * s * di * d
    # SSD: intra-chunk quadratic + state updates
    cs = min(sm.chunk_size, s)
    intra = 2 * b * s * cs * (N + di)        # scores + weighted sum
    states = 2 * b * s * di * N * 2          # state accumulate + output
    return proj + intra + states


def _rec_flops(cfg: ModelConfig, b: int, s: int) -> float:
    h = cfg.hybrid
    d = cfg.d_model
    w = h.lru_width or d
    proj = 2 * b * s * d * w * 2 + 2 * b * s * w * d
    gates = 2 * b * s * w * w * 2 / 16       # block-diagonal (16 blocks)
    scan = 6 * b * s * w
    return proj + gates + scan


def block_cost(cfg: ModelConfig, kind: str, batch: int, seq_q: int, ctx: int,
               *, window: Optional[int] = None, dtype_bytes: int = 2,
               name: str = "") -> NodeCost:
    """Cost of one layer over ``seq_q`` new tokens with ``ctx`` total context."""
    b, s = batch, seq_q
    d = cfg.d_model
    act_io = 2 * b * s * d * dtype_bytes     # read + write the residual stream

    if kind == "ssm":
        fl = _ssm_flops(cfg, b, s)
        wb = cfg._ssm_params() * dtype_bytes
        sm = cfg.ssm
        state_bytes = b * sm.n_heads(d) * sm.head_dim * sm.d_state * 4
        return NodeCost(name or "ssm", fl, wb, act_io + 2 * state_bytes)
    if kind == "rec":
        fl = _rec_flops(cfg, b, s) + _mlp_flops(cfg, b, s)
        h = cfg.hybrid
        w = h.lru_width or d
        wb = (2 * d * w + 2 * w * w / 16 + w * d + 3 * d * cfg.d_ff) * dtype_bytes
        state_bytes = b * w * 4
        return NodeCost(name or "rec", fl, wb, act_io + 2 * state_bytes)
    if kind == "moe":
        fl = (_attn_flops(cfg, b, s, ctx, window) + _moe_flops(cfg, b, s))
        m = cfg.moe
        active_ffn = 3 * d * cfg.d_ff * min(
            m.num_experts, m.experts_per_token * max(1, b * s))
        wb = (_attn_weight_bytes(cfg, dtype_bytes)
              + active_ffn * dtype_bytes + d * m.num_experts * 4)
        kv_bytes = b * ctx * 2 * cfg.kv_dim * dtype_bytes
        return NodeCost(name or "moe", fl, wb, act_io + kv_bytes)
    if kind == "mla":
        fl = _attn_flops(cfg, b, s, ctx, window) + _mlp_flops(cfg, b, s)
        wb = (_attn_weight_bytes(cfg, dtype_bytes) + 3 * d * cfg.d_ff * dtype_bytes)
        m = cfg.mla
        eff = min(ctx, window) if window else ctx
        kv_bytes = b * eff * (m.kv_lora_rank + m.qk_rope_head_dim) * dtype_bytes
        return NodeCost(name or "mla", fl, wb, act_io + kv_bytes)
    # dense
    fl = _attn_flops(cfg, b, s, ctx, window) + _mlp_flops(cfg, b, s)
    wb = (_attn_weight_bytes(cfg, dtype_bytes) + 3 * d * cfg.d_ff * dtype_bytes)
    eff = min(ctx, window) if window else ctx
    kv_bytes = b * eff * 2 * cfg.kv_dim * dtype_bytes
    return NodeCost(name or "dense", fl, wb, act_io + kv_bytes)


def _layer_kinds(cfg: ModelConfig) -> List[str]:
    if cfg.hybrid is not None:
        pat = cfg.hybrid.block_pattern
        return [pat[i % len(pat)] for i in range(cfg.num_layers)]
    if cfg.family == "ssm":
        return ["ssm"] * cfg.num_layers
    if cfg.moe is not None:
        return ["moe"] * cfg.num_layers
    if cfg.attention == "mla":
        return ["mla"] * cfg.num_layers
    return ["dense"] * cfg.num_layers


def _layer_window(cfg: ModelConfig, kind: str, flags_window) -> Optional[int]:
    if cfg.hybrid is not None and kind == "attn":
        return cfg.hybrid.local_window
    return flags_window


def step_costs(cfg: ModelConfig, phase: str, batch: int, seq_or_ctx: int,
               *, window: Optional[int] = None,
               dtype_bytes: int = 2) -> List[NodeCost]:
    """Full node sequence for one phase.

    phase: "prefill"/"train" — seq_or_ctx is the sequence length;
           "decode" — seq_or_ctx is the context length (one new token).
    """
    d = cfg.d_model
    nodes = []
    if phase == "decode":
        s, ctx = 1, seq_or_ctx
    else:
        s, ctx = seq_or_ctx, seq_or_ctx
    nodes.append(NodeCost("embed", 0.0, min(batch * s, cfg.vocab_size) * d * dtype_bytes,
                          batch * s * d * dtype_bytes))
    for i, kind in enumerate(_layer_kinds(cfg)):
        k = "dense" if kind == "attn" else kind
        win = cfg.hybrid.local_window if (cfg.hybrid and kind == "attn") else window
        c = block_cost(cfg, k, batch, s, ctx, window=win,
                       dtype_bytes=dtype_bytes, name=f"L{i}:{kind}")
        nodes.append(c)
    head_s = 1 if phase != "train" else s
    nodes.append(NodeCost(
        "head",
        2 * batch * head_s * d * cfg.vocab_size,
        d * cfg.vocab_size * dtype_bytes,
        batch * head_s * (d + cfg.vocab_size) * dtype_bytes))
    return nodes


def model_flops(cfg: ModelConfig, tokens: int, train: bool = False) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE); 2·N·D for inference."""
    n = cfg.active_param_count()
    per_tok = 6 * n if train else 2 * n
    return per_tok * tokens
