"""Roofline analysis from the dry run: the port of ``repro.launch.roofline``.

The terms come from traced probes (``repro_torch.launch.steps.
lower_combo``: rank 0's counts on a fake process group) at ``num_layers``
= base and 2·base, extrapolated linearly to the full depth — every
per-layer cost (flops, bytes, collective traffic) is linear in depth, and
the embedding, head and optimizer costs are the intercept:

    per_unit = (C(2·base) - C(base)) / base
    total    = C(base) - base·per_unit + num_layers·per_unit

(base = the hybrid block-pattern length, else 1; RecurrentGemma's 2
trailing rec layers are counted at the average-group rate, as in the JAX
package.) The JAX package probes unrolled because XLA's ``cost_analysis``
counts a scan body once; the port's trace is a Python loop over the
layers and has no scan, but the same two probes keep the records
comparable and give the per-layer terms the card's measurements are held
against.

Terms, per device, with the NVIDIA H100 SXM constants of
``repro_torch.launch.mesh`` (computed, not measured):

    compute    = flops / 989e12                  (bf16 tensor cores)
    memory     = bytes / 3.35e12                 (HBM3)
    collective = nvlink_bytes / 900e9 + network_bytes / 100e9

A collective's bytes go over NVLink when its group lies in one node of 8
GPUs, else over the network (one ConnectX-7 400 Gb/s port per GPU, DGX
H100 data sheet): on the production meshes both axes leave the node
(``model`` of 16 spans two nodes; ``data`` strides across nodes).

Usage:
  python -m repro_torch.launch.roofline --arch llama3.2-1b --shape train_4k --out results/roofline
  python -m repro_torch.launch.roofline --all --out results/roofline
  python -m repro_torch.launch.roofline --combo llama3.2-1b:decode_32k --mesh 1x1
  python -m repro_torch.launch.roofline --report results/roofline

Like the dry run it makes this process rank 0 of a fake process group:
run it in a process of its own.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Optional

from ..configs import ARCHITECTURES, INPUT_SHAPES, get_config, get_shape
from ..models.cost import model_flops
from . import collectives
from .dryrun import link_bytes, production_mesh
from .mesh import HBM_BW, NETWORK_BW, NVLINK_BW, PEAK_FLOPS, init_fake_group
from .steps import lower_combo

# the probe's extrapolated quantities
_KEYS = ("flops", "bytes", "coll_bytes", "coll_nvlink", "coll_network")


def _probe(arch: str, shape: str, mesh, L: int, *, extra_flags=None,
           fsdp_override=None, rules_overrides=None, **kw) -> dict:
    record, _ = lower_combo(arch, shape, mesh,
                            cfg_overrides={"num_layers": L},
                            flag_overrides=extra_flags,
                            fsdp_override=fsdp_override,
                            rules_overrides=rules_overrides, **kw)
    coll = collectives.collective_stats(record["collectives"])
    links = link_bytes(record["collectives"])
    return {
        "flops": float(record["cost"]["flops"]),
        "bytes": float(record["cost"]["bytes accessed"]),
        "coll_bytes": sum(v["bytes"] for v in coll.values()),
        "coll_nvlink": links["nvlink"],
        "coll_network": links["network"],
        "coll": coll,
        "arg_bytes": float(record["memory"]["argument_size_in_bytes"]),
        "kernels": record["kernels"],
    }


def mesh_name(mesh) -> str:
    """The JAX records' names for the production meshes, else
    ``mesh<dims>``."""
    dims = tuple(mesh.shape)
    if dims == (16, 16):
        return "pod16x16"
    if dims == (2, 16, 16):
        return "pod2x16x16"
    return "mesh" + "x".join(str(d) for d in dims)


def make_mesh(mesh_shape):
    """A mesh of ``((dims...), (axis names...))`` over a fake group of
    its size."""
    from torch.distributed.device_mesh import init_device_mesh
    dims, names = mesh_shape
    init_fake_group(math.prod(dims))
    return init_device_mesh("cpu", tuple(dims), mesh_dim_names=tuple(names))


def probe_costs(arch: str, shape: str, *, multi_pod: bool = False,
                extra_flags=None, fsdp_override=None,
                rules_overrides=None, mesh_shape=None, **kw) -> dict:
    """Linear-extrapolated per-device costs for the full-depth model.

    ``mesh_shape``: ((dims...), (axis names...)) overrides the production
    mesh — used by the hillclimb experiments that re-shape the logical
    mesh (e.g. the decode-optimized (data=32, model=8)), and by the card's
    check on a (1, 1) mesh."""
    cfg = get_config(arch)
    mesh = (make_mesh(mesh_shape) if mesh_shape is not None
            else production_mesh(multi_pod))
    base = len(cfg.hybrid.block_pattern) if cfg.hybrid is not None else 1
    # wall-clock times the roofline PROBE itself (reported as probe_s);
    # the cost estimates come from the traced counts, not timing
    t0 = time.perf_counter()
    # DTensor learns each new op's output shape by running it once more
    # (and caches that); a first probe of the same ops warms the cache so
    # that the two counted probes see the step's work alone
    _probe(arch, shape, mesh, base, extra_flags=extra_flags,
           fsdp_override=fsdp_override, rules_overrides=rules_overrides, **kw)
    c1 = _probe(arch, shape, mesh, base, extra_flags=extra_flags,
                fsdp_override=fsdp_override, rules_overrides=rules_overrides,
                **kw)
    c2 = _probe(arch, shape, mesh, 2 * base, extra_flags=extra_flags,
                fsdp_override=fsdp_override, rules_overrides=rules_overrides,
                **kw)
    dt = time.perf_counter() - t0

    out = {"arch": arch, "shape": shape, "mesh": mesh_name(mesh),
           "n_dev": int(mesh.size()), "base": base,
           "probe_s": round(dt, 1)}
    for key in _KEYS:
        per_unit = (c2[key] - c1[key]) / base
        fixed = c1[key] - base * per_unit
        out[key] = fixed + cfg.num_layers * per_unit
        out[key + "_fixed"] = fixed
        out[key + "_per_layer"] = per_unit
    # per-kind collective extrapolation
    kinds = set(c1["coll"]) | set(c2["coll"])
    out["coll_kinds"] = {}
    for k in sorted(kinds):
        b1 = c1["coll"].get(k, {}).get("bytes", 0)
        b2 = c2["coll"].get(k, {}).get("bytes", 0)
        pu = (b2 - b1) / base
        out["coll_kinds"][k] = b1 - base * pu + cfg.num_layers * pu
    out["kernels_per_layer"] = {
        k: {q: (c2["kernels"][k][q] - c1["kernels"].get(k, {}).get(q, 0))
            / base for q in ("count", "flops", "bytes")}
        for k in c2["kernels"]}
    return out


_HINTS = {
    "compute": ("compute-bound: keep the tensor cores fed — larger per-GPU "
                "tiles of the dominant matrix product, fuse the small ops "
                "around it, or shed recomputed (remat) FLOPs"),
    "memory": ("HBM-bound: cut weight, activation and KV traffic — fuse "
               "elementwise chains into the kernels, read each KV block "
               "once per query group, or quantize weights / the cache"),
    "collective": ("link-bound: reshard to shrink per-layer collectives — "
                   "keep tensor parallelism inside one NVLink node of 8 "
                   "GPUs, avoid weight all-gathers (no-FSDP serving), or "
                   "overlap collectives with compute"),
}


def _cfg(arch: str, cfg_overrides: Optional[dict]):
    cfg = get_config(arch)
    return dataclasses.replace(cfg, **cfg_overrides) if cfg_overrides \
        else cfg


def _shape(shape_name: str, batch: Optional[int]):
    shape = get_shape(shape_name)
    return shape if batch is None else dataclasses.replace(
        shape, global_batch=batch)


def analytic_bytes(arch: str, shape_name: str, n_dev: int, *,
                   cfg_overrides: Optional[dict] = None,
                   batch: Optional[int] = None) -> float:
    """Analytic per-device HBM traffic (weights + activations + KV), from
    the cost model — the cross-check for the traced 'bytes accessed'
    term, which counts every operation unfused. Train ≈ 3x forward
    traffic. ``batch`` replaces the shape's global batch."""
    from ..models.cost import step_costs
    cfg = _cfg(arch, cfg_overrides)
    shape = _shape(shape_name, batch)
    phase = {"train": "train", "prefill": "prefill",
             "decode": "decode"}[shape.kind]
    costs = step_costs(cfg, phase, shape.global_batch, shape.seq_len)
    total = sum(c.weight_bytes + c.act_bytes for c in costs)
    if shape.kind == "train":
        total *= 3.0
    return total / n_dev


def step_model_flops(arch: str, shape_name: str, *,
                     cfg_overrides: Optional[dict] = None,
                     batch: Optional[int] = None) -> float:
    """MODEL_FLOPS of one step (6·N·D training, 2·N·D inference)."""
    cfg = _cfg(arch, cfg_overrides)
    shape = _shape(shape_name, batch)
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind in ("train", "prefill") else shape.global_batch)
    return model_flops(cfg, tokens, train=shape.kind == "train")


def analytic_per_layer(arch: str, shape_name: str, n_dev: int, *,
                       batch: Optional[int] = None) -> dict:
    """Per layer-unit of the probes ((C(2·base) - C(base)) / base):
    analytic bytes, model flops and the bound they give, max(bytes /
    HBM_BW, flops / PEAK_FLOPS), in seconds per device."""
    cfg = get_config(arch)
    base = len(cfg.hybrid.block_pattern) if cfg.hybrid is not None else 1
    b = [analytic_bytes(arch, shape_name, n_dev, batch=batch,
                        cfg_overrides={"num_layers": L})
         for L in (base, 2 * base)]
    f = [step_model_flops(arch, shape_name, batch=batch,
                          cfg_overrides={"num_layers": L})
         / n_dev for L in (base, 2 * base)]
    nbytes, flops = (b[1] - b[0]) / base, (f[1] - f[0]) / base
    return {"bytes": nbytes, "flops": flops,
            "bound_s": max(nbytes / HBM_BW, flops / PEAK_FLOPS),
            "bound_by": ("bytes" if nbytes / HBM_BW >= flops / PEAK_FLOPS
                         else "operations")}


def collective_seconds(probe: dict) -> float:
    """The collective term of ``probe``'s bytes: NVLink bytes over
    ``NVLINK_BW``, the rest over ``NETWORK_BW``. A probe without the split
    (a JAX record) counts every byte as crossing the network."""
    nv = probe.get("coll_nvlink")
    if nv is None:
        return probe["coll_bytes"] / NETWORK_BW
    return nv / NVLINK_BW + probe["coll_network"] / NETWORK_BW


def terms_record(probe: dict, *, train: bool) -> dict:
    """Roofline terms + MODEL_FLOPS cross-check for one probed combo."""
    del train
    n_dev = probe.get("n_dev") or (512 if probe["mesh"] == "pod2x16x16"
                                   else 256)
    batch = probe.get("batch")
    mf = step_model_flops(probe["arch"], probe["shape"], batch=batch)
    hlo_global = probe["flops"] * n_dev
    compute = probe["flops"] / PEAK_FLOPS
    memory = probe["bytes"] / HBM_BW
    collective = collective_seconds(probe)
    dom = max(("compute", compute), ("memory", memory),
              ("collective", collective), key=lambda kv: kv[1])[0]
    total = max(compute, memory, collective)
    return {
        **probe,
        "compute_s": compute, "memory_s": memory, "collective_s": collective,
        "dominant": dom,
        "model_flops": mf,
        "hlo_flops_global": hlo_global,
        "useful_ratio": mf / hlo_global if hlo_global else 0.0,
        "mfu_bound": (mf / n_dev / PEAK_FLOPS) / total if total else 0.0,
        "analytic_memory_s": analytic_bytes(probe["arch"], probe["shape"],
                                            n_dev, batch=batch) / HBM_BW,
        "hint": _HINTS[dom],
    }


def fmt_seconds(s: float) -> str:
    if s >= 1.0:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s * 1e3:.2f}ms"
    return f"{s * 1e6:.1f}us"


def render_table(records) -> str:
    rows = ["| arch | shape | compute | memory | collective | bound | "
            "useful FLOPs | roofline MFU |",
            "|---|---|---|---|---|---|---|---|"]
    for r in sorted(records, key=lambda r: (r["arch"], r["shape"])):
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_seconds(r['compute_s'])} "
            f"| {fmt_seconds(r['memory_s'])} | {fmt_seconds(r['collective_s'])} "
            f"| **{r['dominant']}** | {r['useful_ratio'] * 100:.0f}% "
            f"| {r['mfu_bound'] * 100:.0f}% |")
    return "\n".join(rows)


def _parse_mesh(text: str):
    dims = tuple(int(d) for d in text.lower().split("x"))
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}[len(dims)]
    return dims, names


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", choices=sorted(ARCHITECTURES))
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES))
    ap.add_argument("--combo", action="append", default=[],
                    metavar="ARCH:SHAPE[:BATCH]",
                    help="a combination (repeatable), at a cut global "
                         "batch when BATCH is given")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="a (data, model) or (pod, data, model) mesh such as "
                         "1x1 or 32x8 instead of the production mesh")
    ap.add_argument("--out", default="results/roofline")
    ap.add_argument("--report", metavar="DIR",
                    help="render the markdown table from probe JSONs")
    args = ap.parse_args(argv)

    if args.report:
        recs = []
        for fn in sorted(os.listdir(args.report)):
            if fn.endswith(".json"):
                with open(os.path.join(args.report, fn)) as f:
                    rec = json.load(f)
                if "error" not in rec:
                    recs.append(rec)
        print(render_table(recs))
        return 0

    if args.all:
        combos = [(a, s) for a in sorted(ARCHITECTURES) for s in INPUT_SHAPES]
    elif args.combo:
        combos = [tuple(c.split(":")) for c in args.combo]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, --combo or --all")
        combos = [(args.arch, args.shape)]
    mesh_shape = _parse_mesh(args.mesh) if args.mesh else None
    os.makedirs(args.out, exist_ok=True)
    failed = 0
    for arch, shape, *cut in combos:
        kw = {"batch": int(cut[0])} if cut else {}
        try:
            p = probe_costs(arch, shape, multi_pod=args.multi_pod,
                            mesh_shape=mesh_shape, **kw)
            p.update(kw)
            rec = terms_record(p, train=shape == "train_4k")
            print(f"[{arch} × {shape} × {rec['mesh']}] compute "
                  f"{fmt_seconds(rec['compute_s'])} "
                  f"memory {fmt_seconds(rec['memory_s'])} "
                  f"collective {fmt_seconds(rec['collective_s'])} "
                  f"-> {rec['dominant']} (useful {rec['useful_ratio']:.2f}, "
                  f"probe {p['probe_s']}s)", flush=True)
        except Exception as e:    # noqa: BLE001
            failed += 1
            rec = {"arch": arch, "shape": shape,
                   "error": f"{type(e).__name__}: {e}"}
            print(f"[{arch} × {shape}] FAIL {rec['error']}", flush=True)
        fn = f"{arch}__{shape}__{rec.get('mesh', 'pod16x16')}.json"
        with open(os.path.join(args.out, fn), "w") as f:
            json.dump(rec, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
