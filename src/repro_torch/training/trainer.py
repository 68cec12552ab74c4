"""Training loop of the port: ``repro.training.trainer`` in PyTorch.

``make_train_step`` gives one step: the model's loss, its gradient by
autograd (through the kernels' ``torch.autograd.Function``s on the card),
and one AdamW update written in place — the counterpart of the JAX step
that ``jax.jit`` compiles with the old state donated. ``train_loop`` drives
it from a batch iterator; the loss reaches the host only on log steps.

On a mesh (``repro_torch.launch.train``) the state's tensors are DTensors
and each batch becomes DTensors split over the installed rules' "batch"
axes, every rank taking its rows of the same global batch. The step runs
the same code under ``implicit_replication`` (the RoPE tables and masks
the model builds are plain tensors, read as replicated) and reports the
whole loss, the same on every rank.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ..models.model import Model
from ..sharding import current_rules, is_dtensor, mesh_context
from . import checkpoint as ckpt
from .optimizer import AdamWState, OptimizerConfig, adamw_update, init_adamw
from .tree import leaves, unflatten_like


@dataclass
class TrainState:
    params: dict
    opt: AdamWState


def value_and_grad(model: Model, params, batch: dict):
    """((loss, {"ce", "aux"}), grads): the loss and the gradient of every
    parameter leaf, in a tree like ``params`` (a leaf the loss does not
    reach gets zeros, as ``jax.grad`` gives; for a DTensor leaf a DTensor
    of its placements). The leaves must require grad (:func:`init_state`
    sets it)."""
    flat = leaves(params)
    with mesh_context(flat[0]):
        loss, parts = model.loss(params, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return (loss, parts), unflatten_like(params, grads)


def _whole(t):
    """A DTensor result read whole (a plain tensor), else t."""
    return t.full_tensor() if is_dtensor(t) else t


def make_train_step(model: Model, opt_cfg: OptimizerConfig) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics); the state's
    tensors are updated in place. ``batch``: tensors on the parameters'
    device."""

    def train_step(state: TrainState, batch: dict):
        (loss, parts), grads = value_and_grad(model, state.params, batch)
        params, opt, om = adamw_update(opt_cfg, state.params, grads,
                                       state.opt)
        metrics = {"loss": _whole(loss.detach()),
                   **{k: _whole(v.detach()) for k, v in parts.items()},
                   **om}
        return TrainState(params, opt), metrics

    return train_step


def init_state(model: Model, generator: Optional[torch.Generator] = None,
               *, device=None) -> TrainState:
    """Seeded parameters on the generator's device, each a leaf that
    requires grad, and a fresh AdamW state. Without a generator,
    ``device="meta"`` gives the state's shapes and dtypes and allocates
    nothing (``jax.eval_shape`` of the JAX ``init_state``)."""
    params = model.init(generator, device=device)
    for p in leaves(params):
        p.requires_grad_(True)
    return TrainState(params=params, opt=init_adamw(params))


@dataclass
class TrainLog:
    steps: list = field(default_factory=list)
    losses: list = field(default_factory=list)
    wall: list = field(default_factory=list)


def to_device(batch: dict, device, mesh=None) -> dict:
    """A pipeline batch of numpy arrays as tensors on ``device``; with a
    ``mesh``, as DTensors split along the installed rules' "batch" axes
    (replicated without rules), each rank keeping its rows of the batch
    it was given (every rank draws the same batch from the same seed)."""
    out = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    if mesh is None:
        return out
    from torch.distributed.tensor import Replicate, distribute_tensor
    rules = current_rules()

    def placements(t):
        if rules is None:
            return [Replicate()] * mesh.ndim
        return rules.placements(("batch",) + (None,) * (t.dim() - 1))

    return {k: distribute_tensor(t, mesh, placements(t), src_data_rank=None)
            for k, t in out.items()}


def train_loop(model: Model, opt_cfg: OptimizerConfig, data_iter,
               num_steps: int, *, generator: Optional[torch.Generator] = None,
               log_every: int = 10, checkpoint_path: Optional[str] = None,
               checkpoint_every: int = 0,
               state: Optional[TrainState] = None,
               verbose: bool = True) -> tuple:
    """Host driver: returns (final state, TrainLog). Without ``state`` the
    parameters are drawn from ``generator`` (by default one seeded 0 on
    the card). The loss is read back on steps ``0, log_every, ...`` and
    the last; the parameters are checkpointed every ``checkpoint_every``
    steps and at the end when ``checkpoint_path`` is given."""
    if state is None:
        if generator is None:
            generator = torch.Generator(device="cuda").manual_seed(0)
        state = init_state(model, generator)
    first = leaves(state.params)[0]
    device = first.device
    mesh = first.device_mesh if is_dtensor(first) else None
    step_fn = make_train_step(model, opt_cfg)
    log = TrainLog()
    t0 = time.perf_counter()
    for step, batch in enumerate(data_iter):
        if step >= num_steps:
            break
        state, metrics = step_fn(state, to_device(batch, device, mesh))
        if step % log_every == 0 or step == num_steps - 1:
            loss = float(metrics["loss"])
            log.steps.append(step)
            log.losses.append(loss)
            log.wall.append(time.perf_counter() - t0)
            if verbose:
                print(f"step {step:5d}  loss {loss:.4f}  "
                      f"lr {float(metrics['lr']):.2e}  "
                      f"gnorm {float(metrics['grad_norm']):.3f}")
        if (checkpoint_path and checkpoint_every
                and step and step % checkpoint_every == 0):
            ckpt.save(checkpoint_path, state.params, step=step)
    if checkpoint_path:
        ckpt.save(checkpoint_path, state.params, step=num_steps)
    return state, log
