"""Flash prefill attention: the CUDA kernel's wrapper and plain version.

Replaces the TPU kernel ``src/repro/kernels/flash_attn.py``
(``flash_attention``): causal attention with a query offset and an
optional sliding window, for the prefill ``P<i>`` nodes. Source, bound and
design notes: ``csrc/flash_attn.cu``.

Under autograd (grad mode on and q, k or v requiring grad) the call goes
through :class:`FlashAttention`: the kernel's forward, and the gradient of
:func:`flash_attention_plain` at the same inputs as its backward (the JAX
package has no backward kernel).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from ._shape import causal_pairs, record, shape_only
from ._vjp import plain_vjp


def pick_chunk(s: int, target: int = 2048) -> int:
    """Largest divisor of ``s`` that is <= target."""
    c = min(s, target)
    while s % c:
        c -= 1
    return c


def flash_attention_plain(q, k, v, *, window: Optional[int] = None,
                          q_offset: int = 0, chunk: int = 2048):
    """The JAX model's ``chunked_causal_attention`` in plain PyTorch: one
    pass per query chunk over the keys that chunk can see, with float32
    scores, masked softmax and float32 P·V, cast to q.dtype at the end
    (in float32 it is the JAX function term for term).

    q: (B, S, H, Dqk); k: (B, T, KV, Dqk); v: (B, T, KV, Dv) with KV
    dividing H: query head h reads KV head h // (H // KV), so the heads
    are never repeated. The scores scale by 1 / sqrt(Dqk), and Dv may
    differ from Dqk (MLA's non-absorbed prefill). Query i sits at key
    position ``q_offset + i``. Returns (B, S, H, Dv)."""
    B, S, H, D = q.shape
    T, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    chunk = pick_chunk(S, chunk)
    qg = q.to(torch.float32).reshape(B, S, KV, G, D)
    outs = []
    for i in range(S // chunk):
        q_i = qg[:, i * chunk:(i + 1) * chunk]
        hi = min(q_offset + (i + 1) * chunk, T)    # exclusive key bound
        lo = 0 if window is None else max(0, hi - chunk - window)
        k_i = k[:, lo:hi].to(torch.float32)
        v_i = v[:, lo:hi].to(torch.float32)
        scores = torch.einsum("bskgd,btkd->bkgst", q_i, k_i) * scale
        qpos = q_offset + i * chunk + torch.arange(chunk, device=q.device)
        kpos = lo + torch.arange(hi - lo, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
        probs = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bkgst,btke->bskge", probs, v_i))
    return torch.cat(outs, dim=1).reshape(B, S, H, Dv).to(q.dtype)


# what the C entries return for a (q/k, v) width pair that the bf16 kernel
# is not compiled for (cudaErrorNotSupported; csrc/flash_attn.cu's
# tc::dispatch lists the pairs it is)
NOT_COMPILED = 801


def kernel_width(D: int, Dv: int) -> Optional[int]:
    """The kernel's compiled width (32, 64, 128 or 256) for q/k head dim
    ``D`` and v head dim ``Dv``: the smallest that holds D; None for a pair
    the kernel does not take (not multiples of 8, Dv > D, or D > 256)."""
    if D % 8 or Dv % 8 or not 0 < Dv <= D:
        return None
    return next((w for w in (32, 64, 128, 256) if D <= w), None)


def _not_compiled(what: str, D: int, Dv: int) -> ValueError:
    return ValueError(f"{what}: head dims q/k {D}, v {Dv}: the bf16 kernel "
                      f"is not compiled for the pair of widths that holds "
                      f"them")


def tc_info(B: int, S: int, T: int, H: int, KV: int, D: int, Dv: int,
            heads: Optional[int] = None):
    """The bf16 kernel instantiation a launch of these sizes runs, read on
    the card without launching it: {"regs", "spill_bytes", "ctas_per_sm",
    "smem", "heads"} (registers and local bytes a thread, by
    ``cudaFuncGetAttributes``; resident CTAs by
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; "heads" the q heads
    a CTA, the layout). ``heads`` (1 or 2, width 256 only) asks for that
    layout's instantiation instead of the one the sizes pick."""
    import ctypes
    width = kernel_width(D, Dv)
    if width is None:
        raise ValueError(f"tc_info: head dims q/k {D}, v {Dv}")
    info = (ctypes.c_int * 5)()
    if heads is None:
        fn = _build.function("flash_attn", "repro_flash_tc_info")
        err = fn(B, S, T, H, KV, width, D, Dv, ctypes.addressof(info))
    else:
        fn = _build.function("flash_attn", "repro_flash_attention_heads")
        err = fn(None, None, None, None, B, S, T, H, KV, width, D, Dv, 0, -1,
                 1.0, heads, ctypes.addressof(info), None)
    if err == NOT_COMPILED:
        raise _not_compiled("tc_info", D, Dv)
    if err:
        raise RuntimeError(f"tc_info: CUDA error {err}")
    return dict(zip(("regs", "spill_bytes", "ctas_per_sm", "smem", "heads"),
                    info))


def flash_attention(q, k, v, *, window: Optional[int] = None,
                    q_offset: int = 0):
    """q: (B, S, H, Dqk); k: (B, T, KV, Dqk); v: (B, T, KV, Dv), KV
    dividing H. Causal with ``q_offset`` (query i attends keys <= q_offset
    + i); optional sliding ``window``; scores scaled by 1 / sqrt(Dqk).
    Returns (B, S, H, Dv) in q.dtype.

    The kernel takes Dqk and Dv that are multiples of 8 with Dv <= Dqk <=
    256: it runs at the smallest of its widths 32, 64, 128 and 256 that
    holds Dqk, and the columns past Dqk (q, k) and past Dv (v) load as
    zeros. In bfloat16 V has a width of its own, the smallest that holds
    Dv, and the bf16 kernel is compiled for some pairs of the two widths
    only (MiniCPM3's MLA prefill, (96, 64), runs (128, 64): 6 k slices of
    Q·Kᵀ, P·V at 64). Any other shape raises.

    A CPU tensor takes :func:`flash_attention_plain`; a CUDA tensor
    launches the kernel on the current stream or raises: bfloat16 on the
    tensor cores (wgmma, TMA); float32 on the tensor cores too, as three
    TF32 products per product (lo*hi + hi*lo + hi*hi, wgmma), which keeps
    float32 accuracy (at width 256 its own kernel, which splits Q a k
    slice at a time into registers). The kernels do not read
    ``torch.backends.cuda.matmul.allow_tf32``: with TF32 off they are
    still float32-accurate. With grad mode on and an input requiring
    grad, the call goes through :class:`FlashAttention`."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, window, q_offset)
    return _forward(q, k, v, window, q_offset)


def flash_cost(q, k, v, window: Optional[int] = None, q_offset: int = 0):
    """(flops, bytes) of one call: q, k, v read once and the output
    written once; Q Kᵀ over Dqk columns and P V over Dv on the (query,
    key) pairs the causal mask and ``window`` keep."""
    B, S, H, D = q.shape
    Dv = v.shape[3]
    nbytes = (q.numel() + k.numel() + v.numel() + B * S * H * Dv) \
        * q.element_size()
    pairs = causal_pairs(S, k.shape[1], q_offset, window)
    return 2 * B * H * (D + Dv) * pairs, nbytes


def _forward(q, k, v, window: Optional[int], q_offset: int):
    """The shape-only path on fake or meta tensors, the plain version on
    the CPU, else one launch of the kernel."""
    if shape_only(q, k, v):
        record("flash_attention", *flash_cost(q, k, v, window, q_offset))
        return q.new_empty(q.shape[:3] + v.shape[3:])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window=window,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    width = _check(q, k, v, window)
    B, S, H, D = q.shape
    T, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    out = q.new_empty((B, S, H, Dv))
    fn = _build.function("flash_attn", "repro_flash_attention")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, S, T, H, KV, width, D, Dv, q_offset,
             -1 if window is None else window, 1.0 / math.sqrt(D),
             _build.dtype_code(q.dtype),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err == NOT_COMPILED:
        raise _not_compiled("flash_attention", D, Dv)
    if err:
        raise RuntimeError(f"flash_attention: CUDA error {err} at launch "
                           f"(B={B}, S={S}, T={T}, H={H}, KV={KV}, D={D}, "
                           f"Dv={Dv})")
    flash_attention.launches += 1
    return out


def _launch_heads(q, k, v, heads: int, window: Optional[int] = None,
                  q_offset: int = 0):
    """The bf16 kernel at width 256 on CUDA inputs in the layout ``heads``
    (1 or 2 q heads a CTA) whatever the grid; counts nothing. It compares
    the two layouts on the same inputs (``chip_smoke.py``, the card tests,
    ``tools/flash_ab.py``); the main path takes the layout the sizes pick.
    Returns the output."""
    width = _check(q, k, v, window)
    if q.device.type != "cuda" or q.dtype != torch.bfloat16 or width != 256 \
            or heads not in (1, 2):
        raise ValueError(f"_launch_heads: bf16 at width 256 and heads 1 or "
                         f"2, got {q.dtype}, width {width}, heads {heads}")
    B, S, H, D = q.shape
    T, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    out = q.new_empty((B, S, H, Dv))
    fn = _build.function("flash_attn", "repro_flash_attention_heads")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, S, T, H, KV, width, D, Dv, q_offset,
             -1 if window is None else window, 1.0 / math.sqrt(D), heads,
             None, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"_launch_heads: CUDA error {err} at launch "
                           f"(B={B}, S={S}, T={T}, H={H}, KV={KV}, heads="
                           f"{heads})")
    return out


def _check(q, k, v, window: Optional[int]) -> int:
    """Raises on inputs the kernel does not take; returns its width."""
    B, S, H, D = q.shape
    if k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3] \
            or k.shape[0] != B or k.shape[3] != D or H % k.shape[2] != 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    Dv = v.shape[3]
    width = kernel_width(D, Dv)
    if width is None:
        raise ValueError(f"flash_attention: head dims q/k {D}, v {Dv}: the "
                         f"kernel takes multiples of 8 with Dv <= Dqk <= 256")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v dtypes differ")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned "
                         "(TMA tensor maps)")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be > 0, got {window}")
    return width


flash_attention.launches = 0


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient. Forward: the kernel on the card,
    the plain version on the CPU (:func:`_forward`), saving q, k and v.
    Backward: the gradient of :func:`flash_attention_plain` at the saved
    inputs, recomputed under autograd in PyTorch ops (causal mask,
    ``window``, ``q_offset``, GQA and Dv != Dqk as the forward)."""

    @staticmethod
    def forward(ctx, q, k, v, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.window, ctx.q_offset = window, q_offset
        return _forward(q, k, v, window, q_offset)

    @staticmethod
    def backward(ctx, g):
        def plain(q, k, v):
            return flash_attention_plain(q, k, v, window=ctx.window,
                                         q_offset=ctx.q_offset)
        return (*plain_vjp(plain, ctx.saved_tensors,
                           ctx.needs_input_grad[:3], g), None, None)
