"""Fused RMSNorm: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/rmsnorm.py``
(``fused_rmsnorm``): ``x * rsqrt(mean(x**2) + eps) * scale`` over the last
axis, computed in float32 and cast back to ``x.dtype``. The serving paths
run it at ln1 and ln2 of every layer, at the SSM's gated norm and at the
final norm, on every token: it is the most-launched kernel of both serves,
so the wrapper keeps its host work to a few attribute reads, one
``torch.empty`` and one ``ctypes`` call. Source, bound and design notes:
``csrc/rmsnorm.cu``.

Under autograd (grad mode on and an input that requires grad) the call
goes through :class:`FusedRMSNorm`, whose forward is the same launch and
whose backward is PyTorch ops in float32: the JAX package has no backward
kernel. Otherwise the wrapper launches directly, with no autograd cost.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ._shape import record, shape_only

# (x dtype, scale dtype) -> the C entry's dtype flags (bit 1: x bf16,
# bit 2: scale bf16); bit 0, the 16-byte-slot path, is added per call
_FLAGS = {(torch.float32, torch.float32): 0,
          (torch.bfloat16, torch.float32): 2,
          (torch.bfloat16, torch.bfloat16): 6}
_INT_MAX = 2 ** 31 - 1


def fused_rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                        eps: float = 1e-5) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (``layers.rms_norm`` of the
    JAX package, term for term)."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * scale.to(torch.float32)
    return y.to(x.dtype)


def row_stride(x: torch.Tensor) -> Optional[int]:
    """The one stride, in elements, between consecutive rows of x's
    ``(rows, D)`` view, when its last axis is contiguous and its leading
    axes collapse into one (``x[:, -1]`` of a contiguous (B, S, D) block
    gives S * D); None when they do not."""
    shape, strides = x.shape, x.stride()
    if not shape or (shape[-1] != 1 and strides[-1] != 1):
        return None
    stride, span = None, None
    for size, st in zip(reversed(shape[:-1]), reversed(strides[:-1])):
        if size == 1:
            continue
        if stride is None:
            stride = st
        elif st != span:
            return None
        span = st * size
    return shape[-1] if stride is None else stride


_launch = None              # the bound C entry and the raw-stream query


def _launcher():
    global _launch
    if _launch is None:
        # torch's raw current-stream query returns the handle as an int,
        # without building a Stream object per call
        _launch = (_build.function("rmsnorm", "repro_rmsnorm"),
                   torch._C._cuda_getCurrentRawStream)
    return _launch


def fused_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D) with a contiguous last axis; scale: (D,), float32 or
    x's dtype. Returns rmsnorm(x) * scale in x.dtype, contiguous.

    A CPU tensor takes :func:`fused_rmsnorm_plain`; a CUDA tensor launches
    the kernel on the current stream or raises. Rows may sit at any one
    stride (:func:`row_stride`), so a view such as ``x[:, -1]`` is read in
    place. With grad mode on and x or scale requiring grad, the call goes
    through :class:`FusedRMSNorm` and the output has a ``grad_fn``."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return FusedRMSNorm.apply(x, scale, eps)
    return _forward(x, scale, eps)


def rmsnorm_cost(x: torch.Tensor, scale: torch.Tensor):
    """(flops, bytes) of one call: x read and y written once, the scale
    read once; four operations an element."""
    return (4 * x.numel(),
            2 * x.numel() * x.element_size()
            + scale.numel() * scale.element_size())


def _forward(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    """The shape-only path on fake or meta tensors, the plain version on
    the CPU, else one launch of the kernel."""
    if shape_only(x, scale):
        record("fused_rmsnorm", *rmsnorm_cost(x, scale))
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    if not x.is_cuda:
        if x.device.type == "cpu":
            return fused_rmsnorm_plain(x, scale, eps)
        raise ValueError(f"fused_rmsnorm: unsupported device {x.device}")
    flags = _FLAGS.get((x.dtype, scale.dtype))
    if flags is None:
        raise TypeError(f"fused_rmsnorm: x {x.dtype} with scale "
                        f"{scale.dtype} not supported (x float32 or "
                        f"bfloat16; scale float32 or x's dtype)")
    if x.dim() == 0:
        raise ValueError("fused_rmsnorm: x needs a last axis")
    D = x.shape[-1]
    dev = x.get_device()
    if (scale.shape != (D,) or not scale.is_contiguous()
            or scale.get_device() != dev):
        raise ValueError(f"fused_rmsnorm: scale must be a contiguous ({D},) "
                         f"tensor on x's device, got {tuple(scale.shape)} "
                         f"on {scale.device}")
    if x.is_contiguous():
        stride = D
        out = torch.empty_like(x)
    else:
        stride = row_stride(x)
        if stride is None:
            raise ValueError(f"fused_rmsnorm: x {tuple(x.shape)} with "
                             f"strides {x.stride()} is no set of rows at one "
                             f"stride with a contiguous last axis")
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
    n = out.numel()
    if n == 0:
        return out
    rows = n // D
    if rows > _INT_MAX or stride > _INT_MAX:
        raise ValueError(f"fused_rmsnorm: {rows} rows at stride {stride} "
                         f"exceed the kernel's 32-bit sizes")
    xp, sp = x.data_ptr(), scale.data_ptr()
    es = x.element_size()
    if not (xp | sp | (stride * es) | (D * es)) & 15:
        flags |= 1                                  # 16-byte slots
    fn, raw_stream = _launch or _launcher()
    err = fn(xp, sp, out.data_ptr(), rows, D, stride, flags, eps, dev,
             raw_stream(dev))
    if err:
        raise RuntimeError(f"fused_rmsnorm: CUDA error {err} at launch "
                           f"(rows={rows}, D={D}, stride={stride}, "
                           f"flags={flags}, x {x.dtype}, scale "
                           f"{scale.dtype})")
    fused_rmsnorm.launches += 1
    return out


fused_rmsnorm.launches = 0


class FusedRMSNorm(torch.autograd.Function):
    """RMSNorm with a gradient. Forward: the kernel on the card, the plain
    version on the CPU (:func:`_forward`). Backward, in float32 PyTorch
    ops, with r = rsqrt(mean(x**2) + eps) and x_hat = x * r:
    ``dx = r * (g*s - x_hat * mean(g*s*x_hat))`` and ``dscale = sum over
    rows of g * x_hat``, each cast back to its input's dtype."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        xf = x.to(torch.float32)
        r = torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True)
                        + ctx.eps)
        x_hat = xf * r
        gf = g.to(torch.float32)
        dx = dscale = None
        if ctx.needs_input_grad[0]:
            gs = gf * scale.to(torch.float32)
            dx = (r * (gs - x_hat * torch.mean(gs * x_hat, dim=-1,
                                                keepdim=True))).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dscale = (gf * x_hat).reshape(-1, x.shape[-1]).sum(0).to(
                scale.dtype)
        return dx, dscale, None
