"""Training example of the PyTorch port: train a small llama-family model
on the synthetic token pipeline and verify the loss drops.

The port's counterpart of ``examples/train_small.py``, with its flags and
its gate (the loss must fall by more than 0.5). The default is the same
scaled-down config (d_model 128, 2 layers, vocab 2048); pass --d-model 512
--layers 8 --steps 300 for the ~100M run. It trains in float32 on the card
(``--device cuda``, the default; raises without one) with the kernels in
every forward pass, or on the CPU with ``--device cpu``.

  python examples/train_small_torch.py [--steps 60]
  PYTHONPATH=src python examples/train_small_torch.py --device cpu
"""
import argparse
import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.models.model import Model, RuntimeFlags  # noqa: E402
from repro_torch.training import OptimizerConfig, train_loop  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda",
                    help="default cuda: raises when no CUDA device is "
                         "present; cpu only when given")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_small_torch: no CUDA device is available; "
                           "pass --device cpu to train on the CPU")

    cfg = get_config(args.arch).reduced()
    cfg = dataclasses.replace(cfg, d_model=args.d_model,
                              num_layers=args.layers,
                              vocab_size=2048)
    model = Model(cfg, RuntimeFlags(dtype=torch.float32))
    print(f"{cfg.name} variant: {cfg.param_count() / 1e6:.1f}M params "
          f"on {device}")

    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.seq,
                                    batch_size=args.batch))
    opt = OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps)
    state, log = train_loop(model, opt, iter(data), args.steps,
                            generator=torch.Generator(
                                device=device).manual_seed(0),
                            checkpoint_path=args.checkpoint, log_every=10)
    first, last = log.losses[0], log.losses[-1]
    print(f"\nloss {first:.3f} -> {last:.3f} in {log.wall[-1]:.0f}s")
    if not last < first - 0.5:
        print("training example FAILED: expected a clear loss reduction "
              f"(more than 0.5, got {first - last:.3f})", file=sys.stderr)
        return 1
    print("training example OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
