#!/usr/bin/env python3
"""One train step of the port on a CPU mesh of gloo processes, against the
same step in one process.

    PYTHONPATH=src python tools/mesh_step.py [ARCH ...]

For each family (by default llama3.2-1b at one K/V head, so the query
heads split over ``model`` and the K/V head is sliced to each rank's
group; granite-moe-3b-a800m; mamba2-2.7b; minicpm3-4b; recurrentgemma-9b,
each ``reduced()``, float32, seed-0 weights) it runs the loss, every
leaf's gradient and one ``make_train_step`` on a (data 2, model 2) mesh
of four processes with the state split by ``param_pspecs(fsdp=True)``,
under ``make_rules(mesh, "train")``, and holds them against one process:
the loss to rtol 1e-5, every whole gradient to ``||dg|| / ||g|| <=
1e-5``, the whole updated parameters to 1e-5, and every rank's local
shapes to the global shapes divided along their specs. It prints one line
per family and exits 1 on any failure. Imports no JAX, so it runs on the
machine with the card too (the ranks use its CPU).

    python tools/mesh_step.py --rank R --world N --store PATH --job JOB

is one rank (what the driver above, and ``tests/test_torch_sharding.py``,
start): ``JOB`` (``torch.save``) holds the config, the mesh's axes and
sizes, ``fsdp``, the weights (a tree of float32 tensors) and the batch
(numpy arrays); the rank joins a gloo group on the ``FileStore`` at
``PATH`` (60 s timeout) and writes ``JOB.rank<R>.out``: its global and
local shape and spec of every leaf and, from rank 0, the loss, the whole
gradients and the whole updated parameters.
"""
import argparse
import dataclasses
import datetime
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
RANK_LIMIT_S = 150          # every rank's wait, after which a run fails
FAMILIES = {"llama3.2-1b": dict(num_kv_heads=1), "granite-moe-3b-a800m": {},
            "mamba2-2.7b": {}, "minicpm3-4b": {}, "recurrentgemma-9b": {}}
MESH = (("data", 2), ("model", 2))


def rank_main(rank: int, world: int, store: str, job_path: str) -> None:
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch import mesh as M
    from repro_torch.models.model import Model, RuntimeFlags
    from repro_torch.sharding import make_rules, use_rules
    from repro_torch.training import (OptimizerConfig, TrainState,
                                      init_adamw, make_train_step,
                                      value_and_grad)
    from repro_torch.training.trainer import to_device
    from repro_torch.training.tree import flatten_with_paths, keystr

    job = torch.load(job_path, weights_only=False)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        names, sizes = zip(*job["mesh"])
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(sizes),
                          mesh_dim_names=tuple(names))
        model = Model(job["cfg"], RuntimeFlags(dtype=torch.float32))
        params = job["params"]
        specs = M.param_pspecs(params, mesh=mesh, fsdp=job["fsdp"])
        dparams = M.distribute(params, specs, mesh, requires_grad=True)
        out = {"local": {
            keystr(path): (tuple(leaf.shape), tuple(leaf.to_local().shape),
                           spec)
            for (path, leaf), spec in zip(flatten_with_paths(dparams),
                                          M.spec_leaves(specs))}}
        with use_rules(make_rules(mesh, "train")):
            batch = to_device(job["batch"], "cpu", mesh)
            (loss, _), grads = value_and_grad(model, dparams, batch)
            grads = {keystr(p): g.full_tensor()
                     for p, g in flatten_with_paths(grads)}
            state = TrainState(dparams, init_adamw(dparams))
            step = make_train_step(model, OptimizerConfig())
            state, metrics = step(state, batch)
            new = {keystr(p): v.detach().full_tensor()
                   for p, v in flatten_with_paths(state.params)}
        if rank == 0:
            out.update(loss=float(loss.full_tensor()),
                       step_loss=float(metrics["loss"]),
                       grads=grads, params=new)
        torch.save(out, f"{job_path}.rank{rank}.out")
    finally:
        dist.destroy_process_group()


def run_ranks(job: dict, world: int, workdir: Path) -> list:
    """Each rank's output for ``job``, from ``world`` processes of this
    script; raises RuntimeError (every rank killed) when one exits nonzero
    or outlives ``RANK_LIMIT_S``."""
    job_path = workdir / "job.pt"
    torch.save(job, job_path)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), "--world", str(world),
         "--store", str(workdir / "store"), "--job", str(job_path)],
        stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=ROOT)
        for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=RANK_LIMIT_S)
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"a rank outlived {RANK_LIMIT_S} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                               + (workdir / f"rank{r}.log").read_text()[-3000:])
    return [torch.load(f"{job_path}.rank{r}.out", weights_only=False)
            for r in range(world)]


def local_shape(shape, spec, sizes: dict) -> tuple:
    """The global shape divided along the spec's mesh axes (an axis the
    mesh lacks replicates)."""
    from repro_torch.sharding import axis_names
    out = []
    for n, entry in zip(shape, spec):
        k = int(np.prod([sizes.get(a, 1) for a in axis_names(entry)]))
        out.append(n // k if n % k == 0 else -1)
    return tuple(out)


def one_process(cfg, params, batch: dict):
    """(loss, {path: gradient}, {path: updated parameter}) of the same
    step in this process."""
    from repro_torch.models.model import Model, RuntimeFlags
    from repro_torch.training import (OptimizerConfig, TrainState,
                                      init_adamw, make_train_step,
                                      value_and_grad)
    from repro_torch.training.tree import flatten_with_paths, keystr, map_tree
    model = Model(cfg, RuntimeFlags(dtype=torch.float32))
    tp = map_tree(lambda t: t.clone().requires_grad_(True), params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (loss, _), grads = value_and_grad(model, tp, tb)
    state, _ = make_train_step(model, OptimizerConfig())(
        TrainState(tp, init_adamw(tp)), tb)
    return (float(loss.detach()),
            {keystr(p): g for p, g in flatten_with_paths(grads)},
            {keystr(p): v.detach() for p, v in flatten_with_paths(
                state.params)})


def check_family(arch: str, workdir: Path) -> str:
    """One family's mesh step against one process: a summary line; raises
    RuntimeError on a disagreement."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, RuntimeFlags
    cfg = dataclasses.replace(get_config(arch).reduced(), **FAMILIES[arch])
    params = Model(cfg, RuntimeFlags(dtype=torch.float32)).init(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(2, cfg.vocab_size, (4, 16)).astype(np.int32)
             for k in ("tokens", "targets")}
    outs = run_ranks(dict(cfg=cfg, mesh=list(MESH), fsdp=True,
                          params=params, batch=batch), 4, workdir)
    loss, grads, new = one_process(cfg, params, batch)
    out = outs[0]
    loss_rel = abs(out["loss"] - loss) / abs(loss)
    grad_rel = max(float((out["grads"][k] - g).norm() / g.norm())
                   for k, g in grads.items())
    param_abs = max(float((out["params"][k] - v).abs().max())
                    for k, v in new.items())
    sizes = dict(MESH)
    bad = [k for o in outs for k, (shape, loc, spec) in o["local"].items()
           if loc != local_shape(shape, spec, sizes)]
    line = (f"{arch}: loss {out['loss']:.7f} vs {loss:.7f} (rel "
            f"{loss_rel:.2e}); worst ||dg||/||g|| {grad_rel:.2e}; worst "
            f"updated parameter |d| {param_abs:.2e}; {len(outs[0]['local'])} "
            f"leaves split as their specs on every rank")
    if loss_rel > 1e-5 or grad_rel > 1e-5 or param_abs > 1e-5 or bad:
        raise RuntimeError(f"{line}; FAILED (local shapes off: {bad})")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("arch", nargs="*", default=list(FAMILIES))
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--store")
    ap.add_argument("--job")
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args.rank, args.world, args.store, args.job)
        return 0
    sys.path.insert(0, str(ROOT / "src"))
    print(f"torch {torch.__version__}; mesh {MESH} of gloo processes, "
          f"param_pspecs(fsdp=True), against one process")
    failed = 0
    for arch in args.arch:
        with tempfile.TemporaryDirectory(prefix="mesh_step_") as d:
            try:
                print(check_family(arch, Path(d)), flush=True)
            except RuntimeError as e:
                failed += 1
                print(f"[fail] {e}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
