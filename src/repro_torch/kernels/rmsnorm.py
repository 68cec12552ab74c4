"""Fused RMSNorm: a Triton row kernel and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/rmsnorm.py``
(``fused_rmsnorm``): ``x * rsqrt(mean(x**2) + eps) * scale`` over the last
axis, computed in float32 and cast back to ``x.dtype``. The serving path
runs it at ln1 and ln2 of every layer and at the final norm, on every
token.

Bound on the H100: bytes. Each element is read once and written once with
four flops in between, so the floor is ``2 * x.nbytes / 3.35 TB/s``.
Design: one program per row and one pass — the row (D = 2048 at full
width) is loaded into registers once, reduced, scaled and stored, so no
float32 upcast or variance ever goes back to device memory.

The Triton kernel is built at first launch: ``triton`` is imported inside
the launching function, never when this module is imported.
"""
from __future__ import annotations

import functools

import torch


def fused_rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                        eps: float = 1e-5) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (``layers.rms_norm`` of the
    JAX package, term for term)."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * scale.to(torch.float32)
    return y.to(x.dtype)


def _rmsnorm_body(x_ptr, scale_ptr, out_ptr, D, eps,
                  BLOCK: tl.constexpr):
    row = tl.program_id(0)
    offs = tl.arange(0, BLOCK)
    mask = offs < D
    x = tl.load(x_ptr + row * D + offs, mask=mask, other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=0) / D
    s = tl.load(scale_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    y = x * tl.rsqrt(var + eps) * s
    tl.store(out_ptr + row * D + offs, y.to(out_ptr.dtype.element_ty),
             mask=mask)


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    """JIT-wrap the kernel body on first use (``tl`` becomes a module
    global here, where Triton's compiler resolves the body's names)."""
    global tl
    import triton
    import triton.language as tl
    return triton.jit(_rmsnorm_body)


def fused_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); scale: (D,). Returns rmsnorm(x) * scale in x.dtype.

    A CPU tensor takes :func:`fused_rmsnorm_plain`; a CUDA tensor launches
    the Triton kernel or raises."""
    if x.device.type == "cpu":
        return fused_rmsnorm_plain(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rmsnorm: unsupported device {x.device}")
    if scale.device != x.device:
        raise ValueError("fused_rmsnorm: scale must be on x's device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_rmsnorm: x dtype {x.dtype} not supported")
    D = x.shape[-1]
    if scale.shape != (D,):
        raise ValueError(f"fused_rmsnorm: scale {tuple(scale.shape)} != ({D},)")
    if not x.is_contiguous() or not scale.is_contiguous():
        raise ValueError("fused_rmsnorm: x and scale must be contiguous")
    out = torch.empty_like(x)
    rows = x.numel() // D
    if rows == 0:
        return out
    block = 1 << max(0, D - 1).bit_length()
    with torch.cuda.device(x.device):
        _triton_kernel()[(rows,)](x, scale, out, D, eps, BLOCK=block,
                                  num_warps=8 if block >= 2048 else 4)
    fused_rmsnorm.launches += 1
    return out


fused_rmsnorm.launches = 0
