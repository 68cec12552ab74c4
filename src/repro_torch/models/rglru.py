"""RG-LRU recurrent block of the port (Griffin / RecurrentGemma,
arXiv:2402.19427).

The port of ``repro.models.rglru``, with the JAX parameter layout
(``w_gate_branch`` / ``w_rec_branch`` (d, w), depthwise causal conv
weights ``conv_w`` (W, w) and bias ``conv_b`` (w,), the gate projections
``w_r`` / ``w_i`` (w, w), float32 ``lambda`` (w,), ``w_out`` (w, d)), so
JAX weights load leaf by leaf.

Recurrence: h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t) with
a_t = exp(-8 * softplus(lambda) * r_t) and sigmoid gates r_t, i_t, all in
float32. The JAX model runs it with ``jax.lax.associative_scan`` outside
any Pallas kernel; here the full-sequence path is a log-depth
(Hillis–Steele) scan in PyTorch ops and decode is the one-step update.

Cache per layer: ``state`` (B, w) float32, the last h, and ``conv`` (B,
W - 1, w) in the model dtype, the last W - 1 rows of ``x @ w_rec_branch``
BEFORE the conv. A prefill shorter than W - 1 tokens left-pads ``conv``
with zero rows: the causal conv's own zero padding, which the next decode
step then reads.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..sharding import is_dtensor, shard
from ..sharding import local as SL
from .layers import _normal
from .ssm import _softplus

_C = 8.0


def init_rglru_block(gen: torch.Generator, cfg, dtype, device) -> dict:
    """Seeded parameters with the JAX ``init_rglru_block`` shapes, dtypes
    and scales: N(0, 1/d) input projections, N(0, 1/w) gate and output
    projections, N(0, 0.2²) conv weights, zero conv bias, and ``lambda``
    the float32 inverse softplus of -log(a) / 8 with a uniform in
    [0.9², 0.999²]."""
    h = cfg.hybrid
    d = cfg.d_model
    w = h.lru_width or d
    s = 1.0 / math.sqrt(d)
    sw = 1.0 / math.sqrt(w)
    u = torch.rand((w,), generator=gen, dtype=torch.float32, device=device)
    a_init = 0.9 ** 2 + u * (0.999 ** 2 - 0.9 ** 2)
    lam = torch.log(torch.expm1(-torch.log(a_init) / _C))
    return {
        "w_gate_branch": _normal(gen, (d, w), s, dtype, device),
        "w_rec_branch": _normal(gen, (d, w), s, dtype, device),
        "conv_w": _normal(gen, (h.conv_width, w), 0.2, dtype, device),
        "conv_b": torch.zeros((w,), dtype=dtype, device=device),
        "w_r": _normal(gen, (w, w), sw, dtype, device),
        "w_i": _normal(gen, (w, w), sw, dtype, device),
        "lambda": lam,
        "w_out": _normal(gen, (w, d), sw, dtype, device),
    }


def _gates(p: dict, x: torch.Tensor):
    """x: (..., w) conv output -> (log_a, gated input), both float32."""
    # under rules the products read x whole over its width and the gating
    # keeps its split: each use's gradient then returns to x's own
    # placements before the two are summed (DTensor cannot always sum a
    # split gradient into a pending sum)
    xm = shard(x, "batch", "seq", None) if x.dim() == 3 else x
    r = torch.sigmoid((xm @ p["w_r"]).to(torch.float32))
    i = torch.sigmoid((xm @ p["w_i"]).to(torch.float32))
    log_a = -_C * _softplus(p["lambda"]) * r
    a2 = torch.exp(2 * log_a)
    gated = torch.sqrt(torch.clamp(1 - a2, min=1e-6)) * i \
        * x.to(torch.float32)
    return log_a, gated


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv along the sequence axis, as a sum of shifted
    copies in the reference's order (``x * w[-1]`` first, the bias last).
    x: (B, S, w); w: (W, w). On a DTensor x, on local shards."""
    if is_dtensor(x):
        return SL.channelwise(_causal_conv, x, w, b)
    W = w.shape[0]
    out = x * w[-1]
    for i in range(1, W):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[W - 1 - i]
    return out + b


def linear_scan(log_a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h_t = exp(log_a_t) * h_{t-1} + x_t from h_{-1} = 0 along axis 1, in
    log2(S) steps: at offset 1, 2, 4, ... every position t >= offset takes
    the combine of (t - offset, t), ``(la, h) <- (la' + la, h' * exp(la) +
    h)`` — the associative operator of the JAX model's
    ``lax.associative_scan``, applied as an inclusive Hillis–Steele scan.
    log_a, x: (B, S, w) float32. Returns h (B, S, w)."""
    S = x.shape[1]
    la, h = log_a, x
    off = 1
    while off < S:
        h = torch.cat([h[:, :off], h[:, :-off] * torch.exp(la[:, off:])
                       + h[:, off:]], dim=1)
        la = torch.cat([la[:, :off], la[:, :-off] + la[:, off:]], dim=1)
        off *= 2
    return h


def apply_rglru_dense(p: dict, x_in: torch.Tensor, cfg):
    """Full-sequence recurrent block. x_in: (B, S, d) -> (y (B, S, d),
    {"state": (B, w) float32, "conv": (B, W - 1, w)})."""
    gate = F.gelu(x_in @ p["w_gate_branch"], approximate="tanh")
    rec_in = x_in @ p["w_rec_branch"]
    rec = _causal_conv(rec_in, p["conv_w"], p["conv_b"])
    rec = shard(rec, "batch", "seq", "lru")
    log_a, gated = _gates(p, rec)
    h = linear_scan(log_a, gated)
    y = (h.to(x_in.dtype) * gate) @ p["w_out"]
    W = p["conv_w"].shape[0]
    conv = rec_in[:, -(W - 1):]
    if conv.shape[1] < W - 1:
        conv = F.pad(conv, (0, 0, W - 1 - conv.shape[1], 0))
    return shard(y, "batch", "act_seq", "embed"), {"state": h[:, -1],
                                                   "conv": conv}


def apply_rglru_decode(p: dict, x_in: torch.Tensor, cache: dict, cfg):
    """Single-step update. x_in: (B, d); cache rows of the batch. Returns
    (y (B, d), new cache rows) — new tensors, the caller writes them
    back."""
    gate = F.gelu(x_in @ p["w_gate_branch"], approximate="tanh")
    rec_new = x_in @ p["w_rec_branch"]
    conv_in = torch.cat([cache["conv"], rec_new[:, None]], dim=1)
    rec = torch.einsum("bwc,wc->bc", conv_in, p["conv_w"]) + p["conv_b"]
    log_a, gated = _gates(p, rec)
    h = cache["state"] * torch.exp(log_a) + gated
    y = (h.to(x_in.dtype) * gate) @ p["w_out"]
    return y, {"state": h, "conv": conv_in[:, 1:]}


def init_rglru_cache(cfg, batch: int, dtype, device) -> dict:
    h = cfg.hybrid
    w = h.lru_width or cfg.d_model
    return {
        "state": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, h.conv_width - 1, w), dtype=dtype,
                            device=device),
    }
