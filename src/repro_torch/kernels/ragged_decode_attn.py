"""Ragged decode attention: the CUDA kernel's wrapper and plain version.

Replaces the TPU kernel ``src/repro/kernels/ragged_decode_attn.py``
(``ragged_decode_attention``). Lazily merged sub-batches have ragged
per-request progress, so row b of one merged decode step attends its own
``lengths[b]`` cached tokens. Source, bound and design notes:
``csrc/ragged_decode_attn.cu``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build


def ragged_decode_attention_plain(q, k, v, lengths, *, slots=None,
                                  ctx: Optional[int] = None):
    """The JAX model's plain decode attention in PyTorch: gather arena row
    ``min(slots[b], N - 1)`` for query row b (row b without ``slots``),
    only its first ``ctx`` time rows when ``ctx`` is given, mask positions
    ``>= lengths[b]``, and attend per KV group with float32 scores, softmax
    and P·V, cast to q.dtype at the end (in float32 it is the JAX path term
    for term).

    q: (B, H, D); k, v: (N, T, KV, D); lengths: (B,) int32. ``ctx`` is a
    static bound with max(lengths) <= ctx: reading fewer rows changes
    nothing but the cost. Returns (B, H, D) in q.dtype."""
    B, H, D = q.shape
    N, T, KV = k.shape[0], k.shape[1], k.shape[2]
    G = H // KV
    if ctx is None or ctx >= T:
        ctx = T
    if slots is None:
        rk, rv = k[:, :ctx], v[:, :ctx]
    else:
        rows = torch.clamp(slots, max=N - 1)
        rk, rv = k[rows, :ctx], v[rows, :ctx]
    qf = q.to(torch.float32).reshape(B, KV, G, D)
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bkgd,btkd->bkgt", qf, rk.to(torch.float32)) * scale
    valid = (torch.arange(ctx, device=q.device)[None, :]
             < lengths[:, None])[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, rv.to(torch.float32))
    return out.reshape(B, H, D).to(q.dtype)


def _check(q, k, v, lengths, slots):
    B, H, D = q.shape
    if k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"ragged_decode_attention: k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} must be one (N, T, KV, D) shape")
    KV = k.shape[2]
    if k.shape[3] != D or H % KV != 0:
        raise ValueError(f"ragged_decode_attention: q {tuple(q.shape)} does "
                         f"not fit k {tuple(k.shape)} (H % KV, D)")
    if D not in (32, 64, 128):
        raise ValueError(f"ragged_decode_attention: head_dim {D} not in "
                         f"(32, 64, 128)")
    for name, t in (("k", k), ("v", v), ("lengths", lengths),
                    ("slots", slots)):
        if t.device != q.device:
            raise ValueError(f"ragged_decode_attention: {name} on "
                             f"{t.device}, q on {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("ragged_decode_attention: q, k, v dtypes differ")
    for name, t in (("lengths", lengths), ("slots", slots)):
        if t.dtype != torch.int32 or t.shape != (B,):
            raise ValueError(f"ragged_decode_attention: {name} must be "
                             f"({B},) int32, got {tuple(t.shape)} {t.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths),
                    ("slots", slots)):
        if not t.is_contiguous():
            raise ValueError(f"ragged_decode_attention: {name} must be "
                             f"contiguous")


def ragged_decode_attention(q, k, v, lengths, *,
                            slots: Optional[torch.Tensor] = None,
                            ctx: Optional[int] = None,
                            block_t: int = 64):
    """q: (B, H, D); k, v: (N, T, KV, D); lengths: (B,) int32 — row i
    attends to ``k[slots[i], :lengths[i]]`` (``k[i]`` without ``slots``).
    Returns (B, H, D) in q.dtype.

    A CPU tensor takes :func:`ragged_decode_attention_plain`, which reads
    only the first ``ctx`` time rows when that static bound is given; a
    CUDA tensor launches the kernel on the current stream or raises. The
    kernel needs no ``ctx``: it stops at each row's length, in tiles of
    ``block_t`` positions."""
    if q.device.type == "cpu":
        return ragged_decode_attention_plain(q, k, v, lengths, slots=slots,
                                             ctx=ctx)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_decode_attention: unsupported device "
                         f"{q.device}")
    B, H, D = q.shape
    if slots is None:
        slots = torch.arange(B, dtype=torch.int32, device=q.device)
    _check(q, k, v, lengths, slots)
    N, T, KV = k.shape[0], k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = _build.function("ragged_decode_attn")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             slots.data_ptr(), out.data_ptr(), B, H, KV, D, N, T, block_t,
             _build.dtype_code(q.dtype),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"ragged_decode_attention: CUDA error {err} at "
                           f"launch (B={B}, H={H}, KV={KV}, D={D}, N={N}, "
                           f"T={T}, block_t={block_t})")
    ragged_decode_attention.launches += 1
    return out


ragged_decode_attention.launches = 0
