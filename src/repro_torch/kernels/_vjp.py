"""The backward the kernels' ``torch.autograd.Function``s share where the
JAX package has no backward kernel to port: the gradient of the plain
version, recomputed under autograd at the saved inputs."""
from __future__ import annotations

import torch


def plain_vjp(fn, saved, need, grad_out) -> tuple:
    """The gradient of ``fn(*saved)`` for ``grad_out``, one entry per saved
    input: ``None`` where ``need`` (``ctx.needs_input_grad``) is false."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        grads = iter(torch.autograd.grad(
            fn(*ins), [t for t in ins if t.requires_grad], grad_out))
    return tuple(next(grads) if n else None for n in need)
