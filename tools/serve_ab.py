#!/usr/bin/env python3
"""Serve one model's smoke trace from two checkouts in turns, on one card.

    python3 tools/serve_ab.py OTHER [--arch mamba2-2.7b] [--turns 2]

OTHER is the root of another checkout of this repository (an earlier
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists, say). Each turn is a process of its own that imports that tree's
``chip_smoke.py`` and ``repro_torch`` and runs its ``phase_serve`` (full
width, bf16, 24 Poisson requests at 20/s after a warmup over every prompt
length; the kernels of the path must launch), in the order other, this,
this, other for two turns; each tree builds its own kernels into its own
``build/`` first. Prints each run's lines and, at the end, tokens/s, the
latency and TTFT percentiles and the runs of each, the card's name and
power limit beside them. Exits 1 when a run fails, 2 without a card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the prompt lengths and kernels of chip_smoke.py's serves, by arch
PROMPTS = {"mamba2-2.7b": "(128, 257, 259, 384)"}
KERNELS = {"mamba2-2.7b": "MAMBA_KERNELS"}

RUN = """
import sys, torch
sys.path[:0] = [{root!r}, {src!r}]
import chip_smoke as smoke
smoke.PHASE[0] = "serve {tag}"
smoke.phase_serve(torch, {arch!r}, "serve {tag}", smoke.{kernels},
                  {prompts})
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    ap.add_argument("--arch", default="mamba2-2.7b", choices=tuple(PROMPTS))
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    trees = {"other": args.other.resolve(), "this": ROOT}
    order = ["other", "this", "this", "other"] * (args.turns // 2) + (
        ["other", "this"] if args.turns % 2 else [])
    summary = []
    for tag in order:
        tree = trees[tag]
        code = RUN.format(root=str(tree), src=str(tree / "src"), tag=tag,
                          arch=args.arch, kernels=KERNELS[args.arch],
                          prompts=PROMPTS[args.arch])
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, cwd=tree)
        print(out.stdout[-6000:], flush=True)
        if out.returncode:
            print(out.stderr[-4000:], file=sys.stderr)
            print(f"[serve_ab] {tag} failed (rc {out.returncode})")
            return 1
        summary += [f"{tag}: {line}" for line in out.stdout.splitlines()
                    if "tokens/s" in line or "latency p50" in line]
    print(f"[serve_ab] {smi}; {args.arch}, order {', '.join(order)}")
    print("\n".join(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
