"""Core transformer layers of the port: RMSNorm, RoPE, SwiGLU MLP, GQA
(with an optional sliding window and an optional int8 K/V cache) and MLA
attention (with a window, absorbed prefill in the latent space).

``repro.models.layers`` in PyTorch. Layers are plain functions over
parameter dicts laid out exactly as the JAX package lays them out —
``wq (d, H, hd)``, ``wk``/``wv (d, KV, hd)``, ``wo (H, hd, d)``,
``w_gate``/``w_up (d, ff)``, ``w_down (ff, d)``, ``scale (d,)``, MLA's
``wq_a (d, q_lora)``, ``wq_b (q_lora, H, nope + rope)``, ``wkv_a (d,
kv_lora + rope)``, ``wkv_b (kv_lora, H, nope + v)``, ``wo (H, v, d)`` —
so the JAX weights load without reshaping and tests compare like with
like.

Decode updates the KV (or MLA latent) cache IN PLACE (JAX returns a new
array): the slot arena is one resident tensor per span, and a copy per
token would cost a full arena read and write.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels import flash_attention, fused_rmsnorm, ragged_decode_attention
from ..kernels.flash_attn import pick_chunk
from ..kernels.rmsnorm import row_stride
from ..sharding import is_dtensor, shard
from ..sharding import local as SL

# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rms_norm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    """Row RMSNorm through the fused kernel (its plain version on CPU).
    Rows at one stride with a contiguous last axis (the prefill's
    ``x[:, -1]``) go in as they are; any other layout is copied first."""
    if is_dtensor(x):
        return SL.rms_norm(x, p["scale"], eps, fused_rmsnorm)
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
    """Split-halves rotation of x (..., H, D) by ``rope_tables``' output.
    Under a mesh D is made whole first (its halves are split apart)."""
    if is_dtensor(x):
        x = SL.merge_ready(x, (x.ndim - 1,))
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


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``; under a mesh with x's sequence split (sequence
    parallelism) on local shards (``sharding.local.linear``)."""
    if is_dtensor(x) and SL.seq_split(x):
        return SL.linear(x, w)
    return x @ w


def apply_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(matmul(x, p["w_gate"])) \
        * matmul(x, p["w_up"])
    if h.dim() == 3:
        h = shard(h, "batch", "seq", "ffn")
    return matmul(h, p["w_down"])


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
    if is_dtensor(w):
        w = SL.merge_ready(w, (2,))
    return matmul(x, w.reshape(d, nh * hd)).unflatten(-1, (nh, hd))


def _qkv(p: dict, x: torch.Tensor, cfg, rope):
    """Project to q/k/v and rotate q and k by the ``rope_tables`` of their
    positions; k/v keep their KV heads (attention reads them by h // G)."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        bq, bk, bv = p["bq"], p["bk"], p["bv"]
        if is_dtensor(bq):
            # whole biases: a split of head_dim would reach q and k through
            # the add, and RoPE's backward through it
            bq, bk, bv = (SL.merge_ready(b, (0, 1)) for b in (bq, bk, bv))
        q, k, v = q + bq, k + bk, v + bv
    q = rotate(q, rope)
    if q.dim() == 4:
        q = shard(q, "batch", "seq", "heads", None)
    return q, rotate(k, rope), v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """out (..., H, hd) @ wo (H, hd, d) -> (..., d)."""
    h, hd, d = wo.shape
    if is_dtensor(wo):
        wo = SL.merge_ready(wo, (1,))
        out = SL.merge_ready(SL.settle(out), (out.ndim - 1,))
    return matmul(out.flatten(-2), wo.reshape(h * hd, d))


def apply_attention_dense(p: dict, x: torch.Tensor, cfg, *, rope=None,
                          window: Optional[int] = None):
    """Full-sequence causal self-attention (prefill) through the flash
    kernel — on the CPU its plain version, the JAX model's chunked
    attention. ``rope``: the ``rope_tables`` of the positions, by default
    those of 0..S-1; ``window``: a sliding window (query i attends keys
    > i - window), as the hybrid's local attention. Returns (out, (k, v))
    with k, v of shape (B, S, KV, hd) so prefill can keep the cache."""
    if rope is None:
        rope = rope_tables(torch.arange(x.shape[1], device=x.device)[None, :],
                           cfg.head_dim, cfg.rope_theta)
    q, k, v = _qkv(p, x, cfg, rope)
    if is_dtensor(q):
        out = SL.flash_attention(q, k, v, window=window,
                                 kernel=flash_attention)
    else:
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              window=window)
    y = _out_proj(out, p["wo"])
    return shard(y, "batch", "act_seq", "embed"), (k, v)


def apply_attention_decode(p: dict, x: torch.Tensor, cache: dict,
                           pos: torch.Tensor, cfg, *,
                           slots: Optional[torch.Tensor] = None,
                           ctx: Optional[int] = None,
                           live: Optional[int] = None,
                           rope=None, lengths: Optional[torch.Tensor] = None,
                           window: Optional[int] = None):
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
    in once, and they are computed here when absent.

    ``window`` (without ``slots`` only): the cache is a ring buffer of T
    time rows, as the JAX model's — the token goes to row ``pos % T`` and
    rows ``[0, min(pos + 1, T))`` are read. The slot arena is never a
    ring: the JAX engine builds it at ``max_len`` and its decode then
    reads every earlier token, and so does this one (``lengths`` stay
    ``pos + 1``).

    An int8 cache (``"k_scale"`` in it, ``init_attention_cache(quant=
    True)``) takes the new row through :func:`_quantize_rows` and its
    scale, under the same ring and ``slots`` rules. The rows read (the
    gathered arena rows, only ``ctx`` of them, with ``slots``) are then
    dequantized into the model dtype, ``int8 * scale`` with the scale cast
    first, as the reference does, and attended by the same kernel: its
    plain version is the reference's gathered decode."""
    B, d = x.shape
    ring = window is not None and slots is None
    T = cache["k"].shape[1]
    if rope is None:
        rope = rope_tables(pos, cfg.head_dim, cfg.rope_theta)
    if lengths is None:
        lengths = (torch.clamp(pos + 1, max=T) if ring
                   else pos + 1).to(torch.int32)
    q, k, v = _qkv(p, x, cfg, rope)
    n = B if live is None else live
    row_idx = (slots if slots is not None
               else torch.arange(B, device=x.device))[:n]
    t_idx = (pos % T if ring else pos)[:n]
    ck, cv = cache["k"], cache["v"]
    if "k_scale" not in cache:
        write_rows(ck, row_idx, t_idx, k[:n])
        write_rows(cv, row_idx, t_idx, v[:n])
        out = _decode_attention(q, ck, cv, lengths, slots=slots, ctx=ctx)
        return _out_proj(out, p["wo"]), cache
    for name, new in (("k", k), ("v", v)):
        vals, scale = _quantize_rows(new[:n])
        write_rows(cache[name], row_idx, t_idx, vals)
        write_rows(cache[f"{name}_scale"], row_idx, t_idx, scale)
    rows = (slice(None) if slots is None
            else torch.clamp(slots, max=ck.shape[0] - 1))
    span = T if ctx is None or slots is None else min(ctx, T)
    ck, cv = (cache[name][rows, :span].to(x.dtype)
              * cache[f"{name}_scale"][rows, :span, :, None].to(x.dtype)
              for name in ("k", "v"))
    out = _decode_attention(q, ck.contiguous(), cv.contiguous(), lengths)
    return _out_proj(out, p["wo"]), cache


def write_rows(dest: torch.Tensor, row_idx: torch.Tensor,
               t_idx: torch.Tensor, values: torch.Tensor) -> None:
    """``dest[row_idx, t_idx] = values`` in place, in dest's dtype. A
    DTensor cache (batch row i at cache row i: no slot arena under a
    mesh) is written on each rank's shard (``sharding.local.write_rows``),
    so the write never replicates the cache."""
    if is_dtensor(dest):
        SL.write_rows(dest, t_idx, values)
    else:
        dest[row_idx, t_idx] = values.to(dest.dtype)


def _decode_attention(q, k, v, lengths, *, slots=None, ctx=None):
    """The ragged decode kernel; under a mesh (a DTensor q, no slots) on
    each rank's local rows and heads."""
    if is_dtensor(q):
        return SL.ragged_decode_attention(q, k, v, lengths,
                                          kernel=ragged_decode_attention)
    return ragged_decode_attention(q.contiguous(), k, v, lengths,
                                   slots=slots, ctx=ctx)


def _quantize_rows(x: torch.Tensor):
    """x (..., D) -> (int8 values, float32 scale (...,)): the reference's
    symmetric quantization op for op — max |x| / 127 in float32, floored
    at 1e-8, then ``round(x / scale)`` (half to even, as ``jnp.round``)
    clipped to ±127."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def init_attention_cache(cfg, batch: int, max_len: int, dtype,
                         device, window: Optional[int] = None,
                         quant: bool = False) -> dict:
    """Zeroed K/V of ``min(max_len, window)`` time rows (a ring buffer
    with a ``window``, as the JAX model's); with ``quant`` int8 K/V and a
    float32 scale per (row, time, kv head), ``"k_scale"`` and
    ``"v_scale"``."""
    T = min(max_len, window) if window else max_len
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    if quant:
        return {
            "k": torch.zeros((batch, T, kv, hd), dtype=torch.int8,
                             device=device),
            "v": torch.zeros((batch, T, kv, hd), dtype=torch.int8,
                             device=device),
            "k_scale": torch.zeros((batch, T, kv), dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros((batch, T, kv), dtype=torch.float32,
                                   device=device),
        }
    return {
        "k": torch.zeros((batch, T, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, T, kv, hd), dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V2 / MiniCPM3)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg, dtype, device) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    s = 1.0 / math.sqrt(d)
    return {
        "wq_a": _normal(gen, (d, m.q_lora_rank), s, dtype, device),
        "q_norm": init_rmsnorm(m.q_lora_rank, device),
        "wq_b": _normal(gen, (m.q_lora_rank, h, qk),
                        1.0 / math.sqrt(m.q_lora_rank), dtype, device),
        "wkv_a": _normal(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim), s,
                         dtype, device),
        "kv_norm": init_rmsnorm(m.kv_lora_rank, device),
        "wkv_b": _normal(gen, (m.kv_lora_rank, h,
                               m.qk_nope_head_dim + m.v_head_dim),
                         1.0 / math.sqrt(m.kv_lora_rank), dtype, device),
        "wo": _normal(gen, (h, m.v_head_dim, d),
                      1.0 / math.sqrt(h * m.v_head_dim), dtype, device),
    }


def mla_rope_tables(positions: torch.Tensor, cfg):
    """The RoPE tables of MLA's rotated part: at ``qk_rope_head_dim``, the
    width JAX's ``apply_rope`` sees there, not at ``head_dim``."""
    return rope_tables(positions, cfg.mla.qk_rope_head_dim, cfg.rope_theta)


def _mla_q(p: dict, x: torch.Tensor, cfg, rope):
    """(q_nope, q_rope) of x (..., d): (..., H, nope) and (..., H, rope),
    the latter rotated by ``mla_rope_tables``' output."""
    m = cfg.mla
    ql = rms_norm(matmul(x, p["wq_a"]), p["q_norm"], cfg.norm_eps)
    q = _proj(ql, p["wq_b"])
    return q[..., :m.qk_nope_head_dim], rotate(q[..., m.qk_nope_head_dim:],
                                               rope)


def _mla_latent(p: dict, x: torch.Tensor, cfg, rope):
    """The cached latent of x (..., d): the normed ``ckv`` (..., kv_lora)
    and the rotated shared key part ``krope`` (..., rope)."""
    R = cfg.mla.kv_lora_rank
    kv = matmul(x, p["wkv_a"])
    ckv = rms_norm(kv[..., :R], p["kv_norm"], cfg.norm_eps)
    return ckv, rotate(kv[..., None, R:], rope)[..., 0, :]


def apply_mla_dense(p: dict, x: torch.Tensor, cfg, *, rope=None,
                    window: Optional[int] = None, absorbed: bool = False,
                    chunk: int = 2048):
    """Full-sequence MLA (prefill). Non-absorbed: per-head keys and values
    expanded from the latent through ``wkv_b``, then causal attention
    through the flash kernel with q and k at nope + rope columns and v at
    ``v_head_dim`` (MiniCPM3: 96 and 64), scaled by 1 / sqrt(nope +
    rope). ``absorbed``: attention in the latent space instead
    (:func:`_mla_absorbed_attention`, PyTorch ops, no flash, in query
    chunks of ``pick_chunk(S, chunk)``). ``window``: a sliding window
    (query i attends keys > i - window). ``rope``: the
    ``mla_rope_tables`` of the positions, by default those of 0..S-1.
    Returns (out, {"ckv": (B, S, kv_lora), "krope": (B, S, rope)})."""
    m = cfg.mla
    if rope is None:
        rope = mla_rope_tables(
            torch.arange(x.shape[1], device=x.device)[None, :], cfg)
    q_nope, q_rope = _mla_q(p, x, cfg, rope)
    ckv, k_rope = _mla_latent(p, x, cfg, rope)
    if absorbed:
        out = _mla_absorbed_attention(p, q_nope, q_rope, ckv, k_rope, cfg,
                                      window, chunk)
        y = _out_proj(out, p["wo"])
        return (shard(y, "batch", "act_seq", "embed"),
                {"ckv": ckv, "krope": k_rope})
    kvb = _proj(ckv, p["wkv_b"])
    k_nope = kvb[..., :m.qk_nope_head_dim]
    value = kvb[..., m.qk_nope_head_dim:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_nope.shape[:3], m.qk_rope_head_dim)], dim=-1)
    if is_dtensor(q):
        out = SL.flash_attention(q, k, value, window=window,
                                 kernel=flash_attention)
    else:
        out = flash_attention(q, k, value.contiguous(), window=window)
    y = _out_proj(out, p["wo"])
    return shard(y, "batch", "act_seq", "embed"), {"ckv": ckv, "krope": k_rope}


def _mla_absorbed_attention(p: dict, q_nope, q_rope, ckv, k_rope, cfg,
                            window: Optional[int], chunk: int):
    """The reference's latent-space MLA prefill: q_nope absorbed through
    ``wkv_b``'s key half into the latent (B, S, H, kv_lora), then one pass
    per query chunk (``pick_chunk(S, chunk)``; the model passes 2048, the
    JAX model's default ``attn_chunk``) over the keys it can see, with its
    dtype sequence — the two score products in the model dtype and their
    sum, float32 scale, mask and softmax, probabilities in the model dtype
    — and the context taken back out through ``wkv_b``'s value half.
    Returns (B, S, H, v_head_dim)."""
    m = cfg.mla
    S = q_nope.shape[1]
    wkv_b_k = p["wkv_b"][..., :m.qk_nope_head_dim]          # (R, H, nope)
    wkv_b_v = p["wkv_b"][..., m.qk_nope_head_dim:]          # (R, H, v)
    # under a mesh the einsums reshape their operands: no pending sum, no
    # uneven split of the 40 heads; under sequence parallelism each query
    # chunk reads every key before it and the einsums merge the heads with
    # the sequence, so each rank takes its batch rows whole
    seqpar = is_dtensor(q_nope) and SL.seq_split(q_nope)
    if seqpar:
        q_nope = SL.batch_only(q_nope)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, wkv_b_k)
    if is_dtensor(q_lat):
        settle = SL.batch_only if seqpar else SL.settle
        q_lat, q_rope, ckv, k_rope = (settle(t) for t in (q_lat, q_rope,
                                                          ckv, k_rope))
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    c = pick_chunk(S, chunk)
    outs = []
    for i in range(S // c):
        hi = (i + 1) * c
        lo = 0 if window is None else max(0, hi - c - window)
        ckv_i = ckv[:, lo:hi]
        scores = (torch.einsum("bshr,btr->bhst", q_lat[:, i * c:hi], ckv_i)
                  + torch.einsum("bshp,btp->bhst", q_rope[:, i * c:hi],
                                 k_rope[:, lo:hi]))
        scores = scores.to(torch.float32) * scale
        qpos = i * c + torch.arange(c, device=ckv.device)
        kpos = lo + torch.arange(hi - lo, device=ckv.device)
        mask = kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
        probs = torch.softmax(scores, dim=-1).to(ckv.dtype)
        ctx = torch.einsum("bhst,btr->bshr", probs, ckv_i)
        outs.append(torch.einsum("bshr,rhv->bshv", ctx, wkv_b_v))
    return torch.cat(outs, dim=1)


def apply_mla_decode(p: dict, x: torch.Tensor, cache: dict,
                     pos: torch.Tensor, cfg, *,
                     slots: Optional[torch.Tensor] = None,
                     ctx: Optional[int] = None,
                     live: Optional[int] = None, rope=None,
                     window: Optional[int] = None):
    """Absorbed-matmul MLA decode over the latent cache, in PyTorch ops
    (the JAX model computes it with jnp outside any Pallas kernel).

    x: (B, d); pos: (B,) int. cache: {"ckv": (N, T, kv_lora), "krope":
    (N, T, rope)}, row i of the batch at cache row i (no ``slots``) or at
    arena row ``slots[i]``; the step's latent row is written in place for
    the first ``live`` rows (padding rows past them carry an out-of-range
    slot: their writes are skipped, their reads clamped). ``ctx`` (with
    ``slots``, below T) bounds the scored time rows to a context bucket,
    as in the JAX model. ``window`` (without ``slots`` only, as in
    :func:`apply_attention_decode`): the cache is a ring of T rows, the
    latent row goes to ``pos % T`` and rows ``[0, min(pos + 1, T))`` are
    scored. The dtype sequence is the reference's: the two score products
    in the model dtype, their sum, then float32 for the softmax.
    ``rope``: the ``mla_rope_tables`` of ``pos``."""
    m = cfg.mla
    B, d = x.shape
    T = cache["ckv"].shape[1]
    ring = window is not None and slots is None
    if ctx is not None and (slots is None or ctx >= T):
        ctx = None
    if rope is None:
        rope = mla_rope_tables(pos, cfg)
    q_nope, q_rope = _mla_q(p, x, cfg, rope)               # (B, H, .)
    ckv_t, krope_t = _mla_latent(p, x, cfg, rope)
    n = B if live is None else live
    row_idx = (slots if slots is not None
               else torch.arange(B, device=x.device))[:n]
    ckv_full, krope_full = cache["ckv"], cache["krope"]
    t_idx = (pos % T if ring else pos)[:n]
    write_rows(ckv_full, row_idx, t_idx, ckv_t[:n])
    write_rows(krope_full, row_idx, t_idx, krope_t[:n])
    if slots is None:
        ckv, krope = ckv_full, krope_full
    else:
        gslots = torch.clamp(slots, max=ckv_full.shape[0] - 1)
        span = T if ctx is None else ctx
        ckv, krope = ckv_full[gslots, :span], krope_full[gslots, :span]

    wkv_b_k = p["wkv_b"][..., :m.qk_nope_head_dim]          # (R, H, nope)
    wkv_b_v = p["wkv_b"][..., m.qk_nope_head_dim:]          # (R, H, v)
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope, wkv_b_k)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    scores = (torch.einsum("bhr,btr->bht", q_lat, ckv)
              + torch.einsum("bhp,btp->bht", q_rope, krope)
              ).to(torch.float32) * scale
    t_idx = torch.arange(ckv.shape[1], device=x.device)[None, :]
    valid = (t_idx < torch.clamp(pos[:, None] + 1, max=T) if ring
             else t_idx <= pos[:, None])
    scores = torch.where(valid[:, None, :], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    lat = torch.einsum("bht,btr->bhr", probs, ckv)
    out = torch.einsum("bhr,rhv->bhv", lat, wkv_b_v)
    return _out_proj(out, p["wo"]), cache


def init_mla_cache(cfg, batch: int, max_len: int, dtype, device,
                   window: Optional[int] = None) -> dict:
    """Zeroed latent cache of ``min(max_len, window)`` time rows (a ring
    with a ``window``)."""
    m = cfg.mla
    T = min(max_len, window) if window else max_len
    return {
        "ckv": torch.zeros((batch, T, m.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, T, m.qk_rope_head_dim),
                             dtype=dtype, device=device),
    }
