"""AdamW, the cosine learning-rate schedule and global-norm clipping:
``repro.training.optimizer`` in PyTorch.

The schedule, the bias corrections and every update are computed in
float32 tensors on the parameters' device, as the JAX package computes
them (not in Python float64), so nothing reaches the host during a step.
Where JAX returns new trees (and the trainer donates the old ones), the
update here writes the parameters and both moments in place: at
llama3.2-1b's full width a second copy of the three would be 15 GB.

On a mesh the parameters, gradients and moments are DTensors: the moments
take each parameter's placements, each update works on the local shards,
and the global norm sums every leaf whole (DTensor reductions over a split
leaf sum all of its shards), so every rank clips by the same scale.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..sharding import is_dtensor, mesh_context
from .tree import flatten_with_paths, leaves, map_tree


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar on the parameters' device
    mu: dict             # first moment, float32, a tree like the params
    nu: dict             # second moment


def cosine_lr(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio * lr``; float32
    on ``step``'s device."""
    step = step.to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio * cfg.lr + (1 - cfg.min_lr_ratio) * cfg.lr \
        * 0.5 * (1.0 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_adamw(params) -> AdamWState:
    """Zero moments in float32 and step 0, on the parameters' device (a
    DTensor parameter's moments are DTensors of its placements)."""
    zeros = map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    device = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=zeros, nu=map_tree(torch.clone, zeros))


def _sum_squares(leaf) -> torch.Tensor:
    """The sum of a leaf's squares over the whole leaf: a plain scalar
    tensor, the same on every rank for a DTensor."""
    s = torch.sum(torch.square(leaf.to(torch.float32)))
    return s.full_tensor() if is_dtensor(s) else s


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(_sum_squares(leaf) for leaf in leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(the grads in float32 scaled to a global norm of at most
    ``max_norm``, their norm before)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    with mesh_context(leaves(grads)[0]):
        return map_tree(lambda g: g.to(torch.float32) * scale, grads), norm


_NO_DECAY = ("scale", "bias", "A_log", "D", "dt_bias", "a_param")


def _decay_mask(path) -> bool:
    """Weight decay applies unless a key of the leaf's path is one of
    ``_NO_DECAY`` (the reference's rule: the QKV biases ``bq``/``bk``/``bv``
    are decayed)."""
    return not any(k in _NO_DECAY for k in path if isinstance(k, str))


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params, grads, state: AdamWState):
    """One AdamW step, clipped to ``cfg.grad_clip``. Writes the parameters
    and the moments in place; returns (params, the new state, {"lr",
    "grad_norm"}), the norm taken before clipping. ``grads``: a tree like
    ``params``."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1, b2 = cfg.betas
    stepf = step.to(torch.float32)
    f32 = dict(dtype=torch.float32, device=stepf.device)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, **f32), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, **f32), stepf)
    flat = flatten_with_paths(params)
    with mesh_context(flat[0][1]):
        for (path, p), g, m, v in zip(flat, leaves(grads), leaves(state.mu),
                                      leaves(state.nu)):
            g = g.to(torch.float32) * scale
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if _decay_mask(path):
                delta = delta + cfg.weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
    return params, AdamWState(step, state.mu, state.nu), {
        "lr": lr, "grad_norm": gnorm}
