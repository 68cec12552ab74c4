#!/usr/bin/env python3
"""Check the float32 exp of the SSD decay matrix on the CPU against float64
rounded once, in fresh processes.

    PYTHONPATH=src python3 tools/cpu_exp_check.py [--runs 30] [--jobs 1]
        [--exp float32|port] [--first none|jax|pallas] [--env NAME=VALUE ...]

Each run is a new Python process. It builds, from its own seed, the
masked decay differences that ``repro_torch.kernels.ssd_chunk.
_decay_terms`` takes the exp of (B 2, nc 4, chunk 32, nh 4: 32768
entries, dt and A drawn as ``tests/test_torch_ssm.py`` draws them), takes
their exp once, and counts the entries that differ from ``torch.exp`` in
float64 rounded to float32 by more than 1e-6 relative. ``--exp float32``
(the default) calls ``torch.exp`` on the float32 tensor; ``port`` calls
``_decay_terms``, which takes that exp in float64 on the CPU. ``--first
pallas`` first runs the JAX package's Pallas ``ssd_chunk_intra`` in
interpret mode on the inputs of the test's (2, 128, 4 heads, hd 32, N 16,
chunk 32) case, as ``test_ssd_chunk_intra_plain_matches_pallas`` does;
``jax`` only imports JAX and runs one small op; ``none`` (the default)
neither. Prints one line a run and the number of runs with any such
entry; ``--jobs`` runs that many at once (the test command runs six
pytest workers), ``--env`` sets variables in the runs' environment (e.g.
``MKL_NUM_THREADS=1``). Needs JAX (``JAX_PLATFORMS=cpu``) for ``--first
pallas`` and ``jax``. Exits 1 when any run differed.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RUN = r"""
import sys
import numpy as np
seed, first, exp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
if first in ("jax", "pallas"):
    import jax.numpy as jnp
    jnp.ones(1000).block_until_ready()
if first == "pallas":
    from repro.kernels.ssd_chunk import ssd_chunk_intra
    rng = np.random.default_rng(7)
    B, S, nh, hd, N = 2, 128, 4, 32, 16
    f = lambda a: jnp.asarray(a, jnp.float32)
    x = f(rng.standard_normal((B, S, nh, hd)))
    dt = f(np.logaddexp(rng.standard_normal((B, S, nh)), 0.0))
    A = f(-np.exp(rng.standard_normal((nh,)) * 0.3))
    Bm = f(rng.standard_normal((B, S, N)))
    Cm = f(rng.standard_normal((B, S, N)))
    ssd_chunk_intra(x, dt, A, Bm, Cm, chunk=32, interpret=True)
import torch
B, nc, chunk, nh = 2, 4, 32, 4
rng = np.random.default_rng(seed)
dtc = torch.from_numpy(np.logaddexp(rng.standard_normal((B, nc, chunk, nh)),
                                    0.0).astype(np.float32))
A = torch.from_numpy(-np.exp(rng.standard_normal(nh) * 0.3)
                     .astype(np.float32))
cum = torch.cumsum(dtc * A, dim=2)
diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
masked = torch.where(mask[None, None, :, :, None], diff,
                     torch.full((), -torch.inf))
if exp == "port":
    from repro_torch.kernels.ssd_chunk import _decay_terms
    got = _decay_terms(dtc, A, chunk)[2]
else:
    got = torch.exp(masked)
want = torch.exp(masked.double()).to(torch.float32)
off = (got - want).abs() > 1e-6 * want.abs()
print(int(off.sum()), got.numel(), float((got - want).abs().max()),
      torch.get_num_threads())
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=30)
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--exp", choices=("float32", "port"), default="float32")
    ap.add_argument("--first", choices=("none", "jax", "pallas"),
                    default="none")
    ap.add_argument("--env", nargs="*", default=[], metavar="NAME=VALUE")
    args = ap.parse_args()
    env = dict(os.environ, **dict(e.split("=", 1) for e in args.env))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT / "src"), env.get("PYTHONPATH")) if p)

    def run(seed):
        return subprocess.run(
            [sys.executable, "-c", RUN, str(seed), args.first, args.exp],
            env=env,
            capture_output=True, text=True, check=True).stdout

    bad = 0
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        outs = pool.map(run, range(args.runs))
    for seed, out in enumerate(outs):
        count, n, worst, threads = out.split()
        bad += int(count) > 0
        print(f"run {seed}: {count} of {n} entries off, max |diff| "
              f"{float(worst):.3e}, {threads} threads", flush=True)
    print(f"{bad} of {args.runs} runs had entries off (exp {args.exp}; "
          f"first {args.first}; {args.jobs} at once; env "
          f"{' '.join(args.env) or 'unchanged'})")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
