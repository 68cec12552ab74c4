"""Training launcher of the port: ``repro.launch.train``'s flags, on the
card.

Trains ``--arch`` in float32 on synthetic Zipfian tokens
(``TokenPipeline``) from weights drawn with seed 0, with the hand-written
kernels in every forward pass; the TF32 settings are left as they are.
``--device cuda`` (the default) raises when no CUDA device is present;
``--device cpu`` runs the kernels' plain versions. Exits nonzero when the
loss does not fall.

The step runs on a mesh, as ``repro.launch.train`` runs the JAX step on
its host mesh: ``make_host_mesh()`` (a 1-D ``data`` mesh over the ranks
of the process group) and ``make_rules(mesh, "train")``, the training
inside ``use_rules``. Under ``torchrun`` the process group comes from the
environment (NCCL on ``--device cuda``, one card per rank by
``LOCAL_RANK``; gloo on ``--device cpu``); alone, the launcher makes a
group of one rank, so one code path serves both. Every rank draws the
same seed-0 weights and the same global batches; the parameters and the
AdamW moments are DTensors replicated over ``data`` (as the JAX launcher
leaves them), and each batch is split over ``data``, every rank taking its
rows. Rank 0 prints and writes the checkpoint (whole tensors).

An SSM or hybrid family wants ``--seq`` a multiple of 64: the scan's chunk
is halved until it divides the sequence, and below chunk 64 its backward
runs the recurrent plain version, a Python loop over chunks in every
layer (at an odd ``--seq``, one step per token).

  python -m repro_torch.launch.train --arch llama3.2-1b --steps 30 \\
      --batch 8 --seq 256
  python -m repro_torch.launch.train --device cpu --reduced --steps 20
  torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \\
      --reduced --steps 20
"""
from __future__ import annotations

import argparse
import sys
import torch

from ..configs import ARCHITECTURES, get_config
from ..data.pipeline import DataConfig, TokenPipeline
from ..models.model import Model, RuntimeFlags
from ..sharding import make_rules, use_rules
from ..training import OptimizerConfig, init_state, train_loop
from ..training.optimizer import init_adamw
from ..training.trainer import TrainState
from .mesh import (distribute, init_process_group, make_host_mesh,
                   param_pspecs)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", choices=sorted(ARCHITECTURES),
                    default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke) variant of the family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256,
                    help="tokens per sequence; SSM and hybrid families "
                         "want a multiple of 64 (see above)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="default cuda: raises when no CUDA device is "
                         "present; cpu only when given")
    return ap.parse_args(argv)


def build(args):
    """(model, optimizer config, data pipeline, generator) of the flags:
    the config (reduced when asked) in float32, warmup over a tenth of the
    steps, the pipeline seeded 0 and the weights' generator seeded 0 on
    ``args.device``."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.launch.train: no CUDA device is "
                           "available; pass --device cpu to train on the "
                           "CPU (the kernels' plain versions)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, RuntimeFlags(dtype=torch.float32))
    opt_cfg = OptimizerConfig(lr=args.lr,
                              warmup_steps=max(args.steps // 10, 1),
                              total_steps=args.steps)
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.seq,
                                    batch_size=args.batch))
    gen = torch.Generator(device=device).manual_seed(0)
    return model, opt_cfg, data, gen


def mesh_state(model, gen, mesh) -> TrainState:
    """The seeded state as DTensors on ``mesh``: the parameters placed by
    ``param_pspecs(fsdp=False)`` (replicated over a ``data`` mesh), leaves
    that require grad, and AdamW moments of their placements."""
    params = init_state(model, gen).params
    params = distribute(params, param_pspecs(params, mesh=mesh, fsdp=False),
                        mesh, requires_grad=True)
    return TrainState(params=params, opt=init_adamw(params))


def train(args):
    """Run the flags on the host mesh: (final state, TrainLog, exit code),
    1 when the loss did not fall. A process group this call had to make
    (one rank) stays up for the returned DTensors; :func:`main` ends
    it."""
    import torch.distributed as dist
    model, opt_cfg, data, gen = build(args)
    cfg = model.cfg
    init_process_group(torch.device(args.device).type)
    mesh = make_host_mesh(torch.device(args.device).type)
    rank = dist.get_rank()
    if rank == 0:
        print(f"training {cfg.name} "
              f"({'reduced' if args.reduced else 'full'}) on {args.device}: "
              f"{cfg.param_count() / 1e6:.1f}M params, {args.steps} steps "
              f"of {args.batch}x{args.seq} on a (data={mesh.size()}) mesh")
    with use_rules(make_rules(mesh, "train")):
        state = mesh_state(model, gen, mesh)
        state, log = train_loop(model, opt_cfg, iter(data), args.steps,
                                state=state,
                                checkpoint_path=(args.checkpoint if rank == 0
                                                 else None),
                                log_every=args.log_every,
                                verbose=rank == 0)
    first, last = log.losses[0], log.losses[-1]
    if rank == 0:
        print(f"loss {first:.4f} -> {last:.4f} "
              f"({(first - last) / first * 100:.1f}% reduction) "
              f"in {log.wall[-1]:.1f}s")
    if not last < first:
        print(f"training smoke FAILED: loss did not decrease "
              f"({first:.4f} -> {last:.4f} over {args.steps} steps)",
              file=sys.stderr)
        return state, log, 1
    return state, log, 0


def main(argv=None) -> int:
    import torch.distributed as dist
    try:
        return train(parse_args(argv))[2]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
