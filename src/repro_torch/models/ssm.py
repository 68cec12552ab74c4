"""Mamba-2 (SSD, state-space duality) mixer of the port.

The port of ``repro.models.ssm``, with the JAX parameter layout
(separate ``w_z`` / ``w_x`` / ``w_bc`` / ``w_dt`` projections, depthwise
causal conv weights ``(W, C)``, float32 ``A_log`` / ``D`` / ``dt_bias`` and
norm scale), so JAX weights load leaf by leaf.

Prefill runs the chunked SSD through ``kernels.ssd_chunked`` (the CUDA
kernels on the card, the JAX model's ``ssd_chunked`` term for term on the
CPU); the gated norm ``rms_norm(y * silu(z))`` goes through the fused
RMSNorm kernel. Decode is the one-token recurrence in plain PyTorch.

Cache per layer: ``state`` (B, nh, hd, N) float32 and ``conv`` (B, W - 1,
d_inner + 2N) in the model dtype, the last W - 1 pre-conv inputs. A
prefill shorter than W - 1 tokens left-pads ``conv`` with zero rows: the
causal conv's own zero padding, which the next decode step then reads.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ssd_chunked
from ..sharding import is_dtensor, shard
from ..sharding import local as SL
from .layers import _normal, init_rmsnorm, rms_norm


def init_ssm(gen: torch.Generator, cfg, dtype, device) -> dict:
    """Seeded parameters with the JAX ``init_ssm`` shapes, dtypes and
    scales: N(0, 1/d) projections, N(0, 0.2²) conv weights, zero conv
    biases, ``A_log = log(1..nh)``, ``D = 1``, ``dt_bias`` the inverse
    softplus of dt drawn log-uniform in [1e-3, 1e-1]."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    gn = 2 * s.n_groups * s.d_state
    scale = 1.0 / math.sqrt(d)
    u = torch.rand((nh,), generator=gen, dtype=torch.float32, device=device)
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_z": _normal(gen, (d, di), scale, dtype, device),
        "w_x": _normal(gen, (d, di), scale, dtype, device),
        "w_bc": _normal(gen, (d, gn), scale, dtype, device),
        "w_dt": _normal(gen, (d, nh), scale, dtype, device),
        "conv_x": _normal(gen, (s.conv_width, di), 0.2, dtype, device),
        "conv_bc": _normal(gen, (s.conv_width, gn), 0.2, dtype, device),
        "conv_bias_x": torch.zeros((di,), dtype=dtype, device=device),
        "conv_bias_bc": torch.zeros((gn,), dtype=dtype, device=device),
        "A_log": torch.log(torch.arange(1, nh + 1, **f32)),
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.log(torch.expm1(dt)),
        "norm": init_rmsnorm(di, device),
        "out_proj": _normal(gen, (di, d), 1.0 / math.sqrt(di), dtype, device),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = logaddexp(x, 0), without ``F.softplus``'s
    linear cut-off above its threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv along the sequence axis, as a sum of shifted
    copies. x: (B, S, C); w: (W, C). On a DTensor x, on local shards."""
    if is_dtensor(x):
        return SL.channelwise(_causal_conv, x, w, b)
    W = w.shape[0]
    out = x * w[-1]
    for i in range(1, W):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[W - 1 - i]
    return F.silu(out + b)


def _chunk_for(S: int, chunk: int) -> int:
    """The reference's rule: halve ``chunk`` until it divides S (odd S
    runs at chunk 1)."""
    while S % chunk:
        chunk //= 2
    return chunk


def apply_ssm_dense(p: dict, x_in: torch.Tensor, cfg, *, chunk=None,
                    with_cache: bool = True):
    """Full-sequence Mamba-2 mixer. x_in: (B, S, d) -> (out, cache); the
    cache is None without ``with_cache`` (training)."""
    s = cfg.ssm
    B, S, d = x_in.shape
    chunk = _chunk_for(S, chunk or s.chunk_size)
    di = s.d_inner(d)
    nh = s.n_heads(d)
    N = s.d_state

    z = x_in @ p["w_z"]
    x_raw = x_in @ p["w_x"]
    bc_raw = x_in @ p["w_bc"]
    dt = x_in @ p["w_dt"]
    xs = _causal_conv(x_raw, p["conv_x"], p["conv_bias_x"])
    bc = _causal_conv(bc_raw, p["conv_bc"], p["conv_bias_bc"])
    xs = shard(xs.reshape(B, S, nh, s.head_dim),
               "batch", "seq", "ssm_heads", None)
    Bs, Cs = bc[..., :N].contiguous(), bc[..., N:].contiguous()
    # dt's pending sum settled before the bias joins it (DTensor cannot
    # always turn the split bias into a pending sum)
    dt = shard(dt, "batch", "seq", "ssm_heads")
    dtv = _softplus(dt.to(torch.float32) + p["dt_bias"])
    dtv = shard(dtv, "batch", "seq", "ssm_heads")
    A = -torch.exp(p["A_log"])

    if is_dtensor(xs):
        y, final_state = SL.ssd_chunked(xs, dtv, A, Bs, Cs, chunk,
                                        kernel=ssd_chunked)
    else:
        y, final_state = ssd_chunked(xs, dtv, A, Bs, Cs, chunk)
    y = y + xs * p["D"][None, None, :, None].to(x_in.dtype)
    y = y.reshape(B, S, di)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]

    out = shard(out, "batch", "act_seq", "embed")
    if not with_cache:
        return out, None
    W = s.conv_width
    conv = torch.cat([x_raw, bc_raw], dim=-1)[:, -(W - 1):]
    if conv.shape[1] < W - 1:
        conv = F.pad(conv, (0, 0, W - 1 - conv.shape[1], 0))
    return out, {"state": final_state.to(torch.float32), "conv": conv}


def apply_ssm_decode(p: dict, x_in: torch.Tensor, cache: dict, cfg):
    """Single-token recurrent update. x_in: (B, d); cache rows of the batch.
    Returns (out (B, d), new cache rows) — new tensors, the caller writes
    them back."""
    s = cfg.ssm
    B, d = x_in.shape
    di = s.d_inner(d)
    nh = s.n_heads(d)
    N = s.d_state

    z = x_in @ p["w_z"]
    x_raw = x_in @ p["w_x"]
    bc_raw = x_in @ p["w_bc"]
    dt = x_in @ p["w_dt"]
    new_tail = torch.cat([x_raw, bc_raw], dim=-1)
    conv_in = torch.cat([cache["conv"], new_tail[:, None]], dim=1)
    xs_in, bc_in = conv_in[..., :di], conv_in[..., di:]
    xs = F.silu(torch.einsum("bwc,wc->bc", xs_in, p["conv_x"])
                + p["conv_bias_x"])
    bc = F.silu(torch.einsum("bwc,wc->bc", bc_in, p["conv_bc"])
                + p["conv_bias_bc"])
    xs = xs.reshape(B, nh, s.head_dim)
    Bs, Cs = bc[:, :N], bc[:, N:]
    # settled before the bias, as in apply_ssm_dense (a pending sum beside
    # a batch split has no rule for the add in every torch release)
    dt = shard(dt, "batch", "ssm_heads")
    dtv = _softplus(dt.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    decay = torch.exp(dtv * A)
    h = cache["state"]
    contrib = (dtv[..., None, None] * xs.to(torch.float32)[..., None]
               * Bs.to(torch.float32)[:, None, None, :])
    h = h * decay[..., None, None] + contrib
    if is_dtensor(h):
        # the product and sum over the state, elementwise: DTensor's einsum
        # flattens (h, p) into one dim, which a split head_dim forbids in
        # some torch releases
        y = (h * Cs.to(torch.float32)[:, None, None, :]).sum(-1).to(
            x_in.dtype)
    else:
        y = torch.einsum("bhpn,bn->bhp", h,
                         Cs.to(torch.float32)).to(x_in.dtype)
    y = y + xs * p["D"][None, :, None].to(x_in.dtype)
    if is_dtensor(y):
        y = SL.merge_ready(y, (2,))     # (heads, head_dim) merge below
    y = y.reshape(B, di)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    return out, {"state": h, "conv": conv_in[:, 1:]}


def init_ssm_cache(cfg, batch: int, dtype, device) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    nh = s.n_heads(d)
    conv_dim = s.d_inner(d) + 2 * s.n_groups * s.d_state
    return {
        "state": torch.zeros((batch, nh, s.head_dim, s.d_state),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype,
                            device=device),
    }
