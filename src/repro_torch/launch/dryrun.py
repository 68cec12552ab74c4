"""Multi-pod dry-run driver: the port of ``repro.launch.dryrun``.

Proves the distribution config is coherent without the hardware: for
every (architecture × input shape) the step must trace on a production
mesh — (data=16, model=16) single-pod or (pod=2, data=16, model=16)
multi-pod — and we record its memory, cost and collective statistics.
Where the JAX package compiles for 512 placeholder host devices, this
process becomes rank 0 of a fake process group of 256 (512) ranks, and
each step runs once on fake tensors placed as DTensors of their specs
(``repro_torch.launch.steps.lower_combo``); the counts are rank 0's.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out results/dryrun [--jobs 4]
  python -m repro_torch.launch.dryrun --arch grok-1-314b --shape decode_32k --multi-pod

``--jobs N`` traces the combinations in N worker processes, each with its
own fake group. The process group is global to a process: run the dry
run in a process of its own, never inside one that has a group up.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from ..configs import ARCHITECTURES, INPUT_SHAPES
from . import collectives
from .mesh import init_fake_group, make_production_mesh
from .steps import lower_combo

_MESHES: dict = {}


def production_mesh(multi_pod: bool):
    """This process's production mesh over a fake group of its size (the
    group is made, or re-made at another size, on first use)."""
    if multi_pod not in _MESHES:
        _MESHES.clear()
        init_fake_group(512 if multi_pod else 256)
        _MESHES[multi_pod] = make_production_mesh(multi_pod=multi_pod,
                                                  device_type="cpu")
    return _MESHES[multi_pod]


def link_bytes(records) -> dict:
    """Collective operand bytes by the link the group crosses."""
    out = {"nvlink": 0, "network": 0}
    for r in records:
        out[r["link"]] += int(r["bytes"])
    return out


def run_one(arch: str, shape: str, *, multi_pod: bool,
            flag_overrides=None, fsdp_override=None,
            rules_overrides=None, verbose: bool = True) -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "ok": False}
    try:
        mesh = production_mesh(multi_pod)
        # wall-clock is the MEASURED quantity here (the trace's timing)
        t0 = time.perf_counter()
        record, _ = lower_combo(arch, shape, mesh,
                                flag_overrides=flag_overrides,
                                fsdp_override=fsdp_override,
                                rules_overrides=rules_overrides)
        coll = collectives.collective_stats(record["collectives"])
        rec.update(
            ok=True,
            trace_s=round(record["trace_s"], 2),
            total_s=round(time.perf_counter() - t0, 2),
            n_devices=int(mesh.size()),
            memory=record["memory"],
            cost=record["cost"],
            collectives=coll,
            collective_links=link_bytes(record["collectives"]),
            kernels=record["kernels"],
        )
        if verbose:
            moved = {k: "%dx/%.2fGB" % (v["count"], v["bytes"] / 1e9)
                     for k, v in coll.items()}
            kernels = {k: v["count"] for k, v in rec["kernels"].items()}
            print(f"[{arch} × {shape} × {mesh_name}] OK  trace "
                  f"{rec['trace_s']}s (with setup {rec['total_s']}s)\n"
                  f"  memory:      {rec['memory']}\n"
                  f"  cost:        {rec['cost']}\n"
                  f"  collectives: {moved}\n"
                  f"  kernels:     {kernels}", flush=True)
    except Exception as e:          # noqa: BLE001 — record, don't crash sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=20)
        if verbose:
            print(f"[{arch} × {shape} × {mesh_name}] FAIL: {rec['error']}",
                  flush=True)
    return rec


def _sweep(combos, multi_pod: bool, jobs: int):
    """The records of ``combos`` in their order, traced in ``jobs``
    processes (the trains first: they take the longest)."""
    if jobs <= 1:
        return [run_one(a, s, multi_pod=multi_pod) for a, s in combos]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    order = sorted(range(len(combos)),
                   key=lambda i: INPUT_SHAPES[combos[i][1]].kind != "train")
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=jobs, mp_context=ctx) as pool:
        futs = {i: pool.submit(run_one, *combos[i], multi_pod=multi_pod)
                for i in order}
        return [futs[i].result() for i in range(len(combos))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", choices=sorted(ARCHITECTURES), default=None)
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the (pod=2, data=16, model=16) mesh")
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch × shape) on this mesh")
    ap.add_argument("--out", default=None,
                    help="directory for per-combo JSON records")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes for the sweep (default 1)")
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s) for a in sorted(ARCHITECTURES)
                  for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        combos = [(args.arch, args.shape)]

    t0 = time.perf_counter()
    recs = _sweep(combos, args.multi_pod, args.jobs)
    n_ok = sum(r["ok"] for r in recs)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        for rec in recs:
            fn = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
            with open(os.path.join(args.out, fn), "w") as f:
                json.dump(rec, f, indent=1)
    slow = max((r for r in recs if r["ok"]), key=lambda r: r["total_s"],
               default=None)
    print(f"\n{n_ok}/{len(combos)} combinations traced OK in "
          f"{time.perf_counter() - t0:.1f} s"
          + (f"; slowest {slow['arch']} × {slow['shape']} "
             f"{slow['total_s']} s" if slow else ""))
    for r in recs:
        if not r["ok"]:
            print(f"FAILED {r['arch']} × {r['shape']}: {r['error']}")
    return 0 if n_ok == len(combos) else 1


if __name__ == "__main__":
    raise SystemExit(main())
