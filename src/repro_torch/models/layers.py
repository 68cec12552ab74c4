"""Core transformer layers of the port: RMSNorm, RoPE, SwiGLU MLP, GQA.

The dense slice of ``repro.models.layers`` in PyTorch. Layers are plain
functions over parameter dicts laid out exactly as the JAX package lays
them out — ``wq (d, H, hd)``, ``wk``/``wv (d, KV, hd)``, ``wo (H, hd, d)``,
``w_gate``/``w_up (d, ff)``, ``w_down (ff, d)``, ``scale (d,)`` — so the
JAX weights load without reshaping and tests compare like with like.

Decode updates the KV cache IN PLACE (JAX returns a new array): the slot
arena is one resident tensor per span, and a copy per token would cost a
full arena read and write.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels import flash_attention, fused_rmsnorm, ragged_decode_attention
from ..kernels.rmsnorm import row_stride

# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rms_norm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    """Row RMSNorm through the fused kernel (its plain version on CPU).
    Rows at one stride with a contiguous last axis (the prefill's
    ``x[:, -1]``) go in as they are; any other layout is copied first."""
    if not x.is_contiguous() and row_stride(x) is None:
        x = x.contiguous()
    return fused_rmsnorm(x, p["scale"], eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings (split-halves rotation, as the JAX package)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of the rotation angles, float32, of shape
    ``positions.shape + (1, head_dim // 2)``: they broadcast over the heads
    axis of an (..., H, D) input whose leading axes are ``positions``'.
    Every layer of one step rotates by the same tables, so a span computes
    them once."""
    freqs = rope_frequencies(head_dim, theta, device=positions.device)
    angles = positions[..., None].to(torch.float32) * freqs
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, rope) -> torch.Tensor:
    """Split-halves rotation of x (..., H, D) by ``rope_tables``' output."""
    cos, sin = rope
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) or (..., H, D); positions: (..., S) int absolute
    positions broadcastable to x's S axis."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, ff: int, dtype, device) -> dict:
    return {
        "w_gate": _normal(gen, (d, ff), 1.0 / math.sqrt(d), dtype, device),
        "w_up": _normal(gen, (d, ff), 1.0 / math.sqrt(d), dtype, device),
        "w_down": _normal(gen, (ff, d), 1.0 / math.sqrt(ff), dtype, device),
    }


def apply_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def _normal(gen, shape, std, dtype, device) -> torch.Tensor:
    """Seeded N(0, std²) in float32, cast to ``dtype`` (as ``Model.init``
    draws in float32 and casts)."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * std).to(dtype)


def init_attention(gen: torch.Generator, cfg, dtype, device) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": _normal(gen, (d, h, hd), s, dtype, device),
        "wk": _normal(gen, (d, kv, hd), s, dtype, device),
        "wv": _normal(gen, (d, kv, hd), s, dtype, device),
        "wo": _normal(gen, (h, hd, d), 1.0 / math.sqrt(h * hd), dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kv, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kv, hd), dtype=dtype, device=device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w (d, heads, hd) -> (..., heads, hd)."""
    d, nh, hd = w.shape
    return (x @ w.reshape(d, nh * hd)).unflatten(-1, (nh, hd))


def _qkv(p: dict, x: torch.Tensor, cfg, rope):
    """Project to q/k/v and rotate q and k by the ``rope_tables`` of their
    positions; k/v keep their KV heads (attention reads them by h // G)."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return rotate(q, rope), rotate(k, rope), v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """out (..., H, hd) @ wo (H, hd, d) -> (..., d)."""
    h, hd, d = wo.shape
    return out.flatten(-2) @ wo.reshape(h * hd, d)


def apply_attention_dense(p: dict, x: torch.Tensor, cfg, *, rope=None):
    """Full-sequence causal self-attention (prefill) through the flash
    kernel — on the CPU its plain version, the JAX model's chunked
    attention. ``rope``: the ``rope_tables`` of the positions, by default
    those of 0..S-1. Returns (out, (k, v)) with k, v of shape
    (B, S, KV, hd) so prefill can keep the cache."""
    if rope is None:
        rope = rope_tables(torch.arange(x.shape[1], device=x.device)[None, :],
                           cfg.head_dim, cfg.rope_theta)
    q, k, v = _qkv(p, x, cfg, rope)
    out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    return _out_proj(out, p["wo"]), (k, v)


def apply_attention_decode(p: dict, x: torch.Tensor, cache: dict,
                           pos: torch.Tensor, cfg, *,
                           slots: Optional[torch.Tensor] = None,
                           ctx: Optional[int] = None,
                           live: Optional[int] = None,
                           rope=None, lengths: Optional[torch.Tensor] = None):
    """Single-token decode with ragged per-row positions, through the
    ragged decode kernel — on the CPU its plain version, the JAX model's
    gathered attention.

    x: (B, d); pos: (B,) int — the index of the token being generated.
    cache: {"k": (N, T, KV, D), "v": ...}; without ``slots`` row i of the
    batch is cache row i (N == B), with ``slots`` ((B,) int32) it is the
    persistent slot-arena row ``slots[i]``. The new k/v token is written in
    place; the cache dict is returned as it came.

    ``live``: only the first ``live`` rows are real requests. Batch-bucket
    padding rows (the tail) carry an out-of-range slot; their cache writes
    are skipped — JAX drops them with ``mode="drop"``, torch's
    ``index_put_`` would raise — and their reads are clamped in range, so
    they produce garbage the caller discards.

    ``ctx``: a static bucket covering max(pos) + 1; the plain version reads
    only that many time rows, the kernel stops at each row's length.
    ``rope`` (the ``rope_tables`` of ``pos``) and ``lengths`` (``pos + 1``
    as int32) are the same for every layer of a step: a span passes them
    in once, and they are computed here when absent."""
    B, d = x.shape
    if rope is None:
        rope = rope_tables(pos, cfg.head_dim, cfg.rope_theta)
    if lengths is None:
        lengths = (pos + 1).to(torch.int32)
    q, k, v = _qkv(p, x, cfg, rope)
    n = B if live is None else live
    row_idx = (slots if slots is not None
               else torch.arange(B, device=x.device))[:n]
    ck, cv = cache["k"], cache["v"]
    ck[row_idx, pos[:n]] = k[:n].to(ck.dtype)
    cv[row_idx, pos[:n]] = v[:n].to(cv.dtype)
    out = ragged_decode_attention(q.contiguous(), ck, cv, lengths,
                                  slots=slots, ctx=ctx)
    return _out_proj(out, p["wo"]), cache


def init_attention_cache(cfg, batch: int, max_len: int, dtype,
                         device) -> dict:
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, max_len, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, kv, hd), dtype=dtype, device=device),
    }
