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
        if job.get("kind") == "serve":
            out = serve_rank_main(job, mesh)
            torch.save(out if rank == 0 else
                       {k: {"local": v["local"]} for k, v in out.items()},
                       f"{job_path}.rank{rank}.out")
            return
        model = Model(job["cfg"], RuntimeFlags(dtype=torch.float32))
        params = job["params"]
        specs = M.param_pspecs(params, mesh=mesh, fsdp=job["fsdp"])
        dparams = M.distribute(params, specs, mesh, requires_grad=True)
        out = {"local": {
            keystr(path): (tuple(leaf.shape), tuple(leaf.to_local().shape),
                           spec)
            for (path, leaf), spec in zip(flatten_with_paths(dparams),
                                          M.spec_leaves(specs))}}
        rules = make_rules(mesh, "train")
        rules.mapping.update(job.get("rules", {}))
        with use_rules(rules):
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


# ---------------------------------------------------------------------------
# serve steps: launch.steps' prefill_step and serve_step on the mesh
# ---------------------------------------------------------------------------

SERVE_FAMILIES = ("llama3.2-1b", "mamba2-2.7b", "minicpm3-4b",
                  "granite-moe-3b-a800m", "recurrentgemma-9b")
SERVE_B, SERVE_S, SERVE_T = 4, 16, 24      # batch, prompt, cache rows
SERVE_WINDOW = 8                           # the llama ring's window


def serve_cases(archs=SERVE_FAMILIES) -> list:
    """(name, arch, shape name, port flag overrides, cache prefer) of
    every serve case: each family's prefill and its decode under both
    cache specs, and llama's decode over a ring (``window``) and over an
    int8 cache (``kv_quant``) under both."""
    cases = []
    for arch in archs:
        cases.append((f"{arch}/prefill", arch, "prefill_32k", {}, "trailing"))
        for prefer in ("trailing", "kv"):
            cases.append((f"{arch}/decode/{prefer}", arch, "decode_32k", {},
                          prefer))
            if arch == "llama3.2-1b":
                cases.append((f"{arch}/ring/{prefer}", arch, "decode_32k",
                              {"window": SERVE_WINDOW}, prefer))
                cases.append((f"{arch}/int8/{prefer}", arch, "decode_32k",
                              {"kv_quant": True}, prefer))
    return cases


def serve_inputs(cfg, shape: str, flags: dict, seed: int = 0) -> tuple:
    """Small inputs of a serve case, numpy trees in the port's layout:
    prefill ({"tokens": (B, S)},); decode (cache, token, pos) with a
    random cache of ``SERVE_T`` rows (a ring of ``SERVE_WINDOW``), an
    int8 cache's values in [-127, 127] and scales in [1e-3, 2e-2], and
    ragged positions (a ring's past its rows)."""
    from repro_torch.models.model import Model, RuntimeFlags
    from repro_torch.training.tree import flatten_with_paths, unflatten_like
    rng = np.random.default_rng(seed)
    tokens = lambda *shp: rng.integers(2, cfg.vocab_size, shp).astype(
        np.int32)
    if shape == "prefill_32k":
        return ({"tokens": tokens(SERVE_B, SERVE_S)},)
    model = Model(cfg, RuntimeFlags(dtype=torch.float32, **flags))
    cache = model.init_cache(SERVE_B, SERVE_T, device="cpu")

    def fill(name, leaf):
        if leaf.dtype == torch.int8:
            return rng.integers(-127, 128, leaf.shape).astype(np.int8)
        if name.endswith("_scale"):
            return rng.uniform(1e-3, 2e-2, leaf.shape).astype(np.float32)
        return (0.5 * rng.standard_normal(leaf.shape)).astype(np.float32)

    cache = unflatten_like(cache, [fill(str(path[-1]), leaf) for path, leaf
                                   in flatten_with_paths(cache)])
    pos = np.array([3, 10, 17, 23] if "window" not in flags
                   else [5, 9, 14, 23], np.int32)
    return cache, tokens(SERVE_B), pos


def _torch_tree(tree):
    """Tensors of a numpy tree, copies: a decode step writes its cache in
    place, and the caller's arrays stay as they were."""
    from repro_torch.training.tree import map_tree
    return map_tree(lambda a: torch.from_numpy(np.array(a, copy=True)), tree)


def _whole_tree(tree):
    from repro_torch.training.tree import flatten_with_paths, keystr
    return {keystr(p): (t.full_tensor() if hasattr(t, "full_tensor")
                        else t).detach().clone()
            for p, t in flatten_with_paths(tree)}


def serve_combo(case, cfg, mesh):
    """``launch.steps.build_combo`` of a serve case at ``cfg`` (a reduced
    config) in float32."""
    from repro_torch.launch.steps import build_combo
    _, arch, shape, flags, prefer = case
    overrides = {f.name: getattr(cfg, f.name)
                 for f in dataclasses.fields(cfg)}
    return build_combo(arch, shape, mesh, cfg_overrides=overrides,
                       flag_overrides=dict(flags, dtype=torch.float32),
                       cache_prefer=prefer)


def serve_step(combo, params, inputs, mesh=None) -> dict:
    """The combo's step on ``params`` and ``inputs`` (numpy trees), placed
    on ``mesh`` by the combo's specs (plain tensors without one): {"logits",
    "cache" (whole, by path), "local" (path: local shape, spec) of the
    placed inputs}."""
    from repro_torch.launch import mesh as M
    from repro_torch.sharding import make_rules, use_rules
    from repro_torch.training.tree import flatten_with_paths, keystr
    args = (params,) + tuple(_torch_tree(a) for a in inputs)
    if mesh is None:
        logits, cache = combo.fn(*args)
        return {"logits": logits.clone(), "cache": _whole_tree(cache)}
    placed = combo.place(args)
    local = {}
    for tree, spec in zip(placed, combo.spec_fn(args)):
        for (path, leaf), sp in zip(flatten_with_paths(tree),
                                    M.spec_leaves(spec)):
            local[keystr(path)] = (tuple(leaf.shape),
                                   tuple(leaf.to_local().shape), sp)
    with use_rules(make_rules(mesh, "serve")):
        logits, cache = combo.fn(*placed)
    return {"logits": logits.full_tensor(), "cache": _whole_tree(cache),
            "local": local}


def serve_rank_main(job: dict, mesh) -> dict:
    """Every serve case of ``job`` on this rank's part of ``mesh``."""
    out = {}
    for case in job["cases"]:
        arch = case[1]
        try:
            combo = serve_combo(case, job["cfgs"][arch], mesh)
            out[case[0]] = serve_step(combo, job["params"][arch],
                                      job["inputs"][case[0]], mesh)
        except Exception as e:      # noqa: BLE001 — every case is reported
            # a rule that fails, fails on every rank at the same op, before
            # any collective of that op: the ranks stay in step
            out[case[0]] = {"error": f"{type(e).__name__}: {e}"[:2000],
                            "local": {}}
    return out


def standin_mesh():
    """What ``build_combo`` reads of a (data 2, model 2) mesh, for the
    one-process step (its inputs stay plain tensors)."""
    import types
    names, sizes = zip(*MESH)
    return types.SimpleNamespace(mesh_dim_names=names, shape=sizes)


def run_serve(cases, cfgs: dict, params: dict, inputs: dict,
              workdir: Path) -> list:
    """Every rank's serve outputs for ``cases`` on the (data 2, model 2)
    mesh of four gloo processes; rank 0's hold the logits and caches."""
    return run_ranks(dict(kind="serve", mesh=list(MESH), cases=list(cases),
                          cfgs=cfgs, params=params, inputs=inputs),
                     4, workdir)


def check_serve(archs, workdir: Path) -> list:
    """The serve cases of ``archs`` (each ``reduced()``, float32, seed-0
    weights) on the mesh against one process: logits and every updated
    cache leaf to rtol 1e-5 (atol 1e-5 of the leaf's largest entry), every
    placed leaf split as its spec. Summary lines; raises RuntimeError on a
    disagreement."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, RuntimeFlags
    cases = serve_cases(archs)
    cfgs = {a: get_config(a).reduced() for a in archs}
    params = {a: Model(cfgs[a], RuntimeFlags(dtype=torch.float32)).init(
        torch.Generator().manual_seed(0)) for a in archs}
    inputs = {c[0]: serve_inputs(cfgs[c[1]], c[2], c[3]) for c in cases}
    outs = run_serve(cases, cfgs, params, inputs, workdir)
    lines, bad = [], []
    for case in cases:
        name, arch = case[0], case[1]
        ref = serve_step(serve_combo(case, cfgs[arch], standin_mesh()),
                         params[arch], inputs[name])
        got = outs[0][name]
        if "error" in got:
            bad.append(f"{name}: {got['error']}")
            lines.append(f"{name}: FAILED {got['error'][:300]}")
            continue
        worst = 0.0
        for key, r in [("logits", ref["logits"])] + list(ref["cache"].items()):
            g = got["logits"] if key == "logits" else got["cache"][key]
            err = float((g.double() - r.double()).abs().max())
            scale = float(r.double().abs().max()) or 1.0
            worst = max(worst, err / scale)
            if not torch.allclose(g.double(), r.double(), rtol=1e-5,
                                  atol=1e-5 * scale):
                bad.append(f"{name} {key}: max |d| {err:.2e}")
        split = [k for o in outs for k, (shape, loc, spec)
                 in o[name]["local"].items()
                 if loc != local_shape(shape, spec, dict(MESH))]
        bad += [f"{name} {k}: local shape off" for k in split]
        lines.append(f"{name}: logits and {len(ref['cache'])} cache leaves "
                     f"vs one process, worst max |d| / max |ref| "
                     f"{worst:.2e}")
    if bad:
        raise RuntimeError("; ".join(bad))
    return lines


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
    ap.add_argument("--serve", action="store_true",
                    help="the serve steps (prefill, decode) instead")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--store")
    ap.add_argument("--job")
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args.rank, args.world, args.store, args.job)
        return 0
    sys.path.insert(0, str(ROOT / "src"))
    if args.serve:
        archs = [a for a in args.arch if a in SERVE_FAMILIES]
        print(f"torch {torch.__version__}; mesh {MESH} of gloo processes, "
              f"launch.steps' serve steps against one process")
        with tempfile.TemporaryDirectory(prefix="mesh_serve_") as d:
            try:
                for line in check_serve(archs, Path(d)):
                    print(line, flush=True)
            except RuntimeError as e:
                print(f"[fail] {e}", flush=True)
                return 1
        return 0
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
