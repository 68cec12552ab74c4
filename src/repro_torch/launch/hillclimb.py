"""Hillclimbing driver: hypothesis -> change -> re-trace -> record. The
port of ``repro.launch.hillclimb``, with its three targets and every step
in order.

The targets: the worst roofline fraction (minicpm3-4b × prefill_32k), the
most collective-bound (granite-moe-3b-a800m × train_4k), and the pair
most representative of the paper's own technique — lazily merged ragged
decode (qwen2.5-32b × decode_32k).

Every experiment re-probes the full roofline terms
(``repro_torch.launch.roofline``) with one named change; results land in
``results/perf/``. A step whose only change has no counterpart in the
port (the grouped decode einsum: the port's decode never repeats K/V
heads; donating the cache: the port's decode writes it in place) stays in
its place and records that it equals the step before it.

  python -m repro_torch.launch.hillclimb --target minicpm   # or granite / qwen / all

Like the dry run it makes this process rank 0 of a fake process group:
run it in a process of its own.
"""
from __future__ import annotations

import argparse
import json
import os

from .roofline import fmt_seconds, probe_costs, terms_record
from .steps import NO_COUNTERPART

# target -> list of (label, hypothesis, probe kwargs). Order matters: each
# entry is one hillclimb iteration; labels starting with '+' stack on the
# previous accepted change. The kwargs are the JAX package's.
EXPERIMENTS = {
    "qwen": {
        "arch": "qwen2.5-32b", "shape": "decode_32k",
        "steps": [
            ("baseline", "paper-faithful decode on the baseline specs: the "
             "cache split along head_dim over model, which the ragged "
             "decode kernel needs whole, so each layer all-gathers its "
             "cache (XLA instead all-reduces partial (B, H, T) scores)", {}),
            ("grouped", "no counterpart: the port's decode never repeats "
             "K/V heads (expect the baseline's numbers)",
             dict(extra_flags={"grouped_decode": True})),
            ("grouped+donate", "no counterpart: the port's decode writes "
             "the cache in place, which donation buys XLA (expect the "
             "baseline's numbers)",
             dict(extra_flags={"grouped_decode": True}, donate_cache=True)),
            ("grouped+mesh32x8", "re-shape the logical mesh to (data=32, "
             "model=8): kv (8), heads (40) and d_ff divide 8, and a model "
             "axis of 8 stays inside one NVLink node; with the cache split "
             "over kv heads the decode kernel runs on local shards (expect "
             "the per-layer cache all-gather to disappear)",
             dict(extra_flags={"grouped_decode": True}, donate_cache=True,
                  cache_prefer="kv",
                  mesh_shape=((32, 8), ("data", "model")))),
            ("+int8kv", "the remaining memory term is cache streaming; "
             "int8 symmetric per-(token, kv-head) quantization halves the "
             "cache's capacity (expect argument size about -50%; the "
             "port dequantizes the rows it reads into a bf16 copy, so its "
             "traffic falls less than the capacity)",
             dict(extra_flags={"grouped_decode": True, "kv_quant": True},
                  donate_cache=True, cache_prefer="kv",
                  mesh_shape=((32, 8), ("data", "model")))),
        ],
    },
    "minicpm": {
        "arch": "minicpm3-4b", "shape": "prefill_32k",
        "steps": [
            ("baseline", "paper-faithful MLA prefill: materialized per-head "
             "K/V, heads (40) not divisible by the model axis (16), so "
             "attention runs with the heads whole on each rank", {}),
            ("absorbed", "latent-space attention: K-side reads drop from "
             "(T, H, 96+64) to (T, R+P) = (T, 288) and no per-head K/V is "
             "formed (expect the memory term down)",
             dict(extra_flags={"mla_absorbed": True})),
            ("absorbed+headsrep", "replicate activations over heads: every "
             "score product stays local (expect fewer collectives at more "
             "compute)",
             dict(extra_flags={"mla_absorbed": True},
                  rules_overrides={"heads": None})),
            ("absorbed+seqpar", "alternative: shard the residual stream "
             "over seq (context parallelism) instead of heads — "
             "activations 16x smaller per device, attention gathers the "
             "latent cache",
             dict(extra_flags={"mla_absorbed": True},
                  rules_overrides={"heads": None, "act_seq": "model"})),
            ("seqpar-only", "ablation: is sequence parallelism alone "
             "enough, or does the absorbed form contribute?",
             dict(rules_overrides={"act_seq": "model"})),
        ],
    },
    "granite": {
        "arch": "granite-moe-3b-a800m", "shape": "train_4k",
        "steps": [
            ("baseline", "paper-faithful MoE train: expert FFN sharded over "
             "model; the tensor-parallel sum all-reduces the (e, cap, d) "
             "expert buffer", {}),
            ("moeout-rs", "constrain out_buf split over d: the all-reduce "
             "becomes a reduce-scatter and the combine defers the gather "
             "to the (t, d) output (expect the collective term down)",
             dict(rules_overrides={"moe_out": "model"})),
            ("moeout+seqpar", "+ sequence parallelism on the residual "
             "stream: saved activations and norm / residual traffic split "
             "16x over model (expect the memory term down)",
             dict(rules_overrides={"moe_out": "model", "act_seq": "model"})),
            ("expert-parallel", "re-shape to (data=32, model=8), where E=40 "
             "divides 8, and split the EXPERT dim instead: each GPU holds 5 "
             "whole experts (no ffn partial sums) and the model axis stays "
             "inside one NVLink node (expect the collective term down "
             "several x)",
             dict(mesh_shape=((32, 8), ("data", "model")),
                  param_prefer={"w_gate": 0, "w_up": 0, "w_down": 0},
                  rules_overrides={"experts": "model", "expert_ffn": None})),
        ],
    },
}


def effective(kw: dict) -> dict:
    """A step's probe kwargs as the port sees them: the flags with no
    counterpart and ``donate_cache`` dropped."""
    out = {k: v for k, v in kw.items() if k != "donate_cache"}
    flags = {k: v for k, v in out.pop("extra_flags", {}).items()
             if k not in NO_COUNTERPART}
    if flags:
        out["extra_flags"] = flags
    return out


def run_target(name: str, out_dir: str = "results/perf") -> list:
    spec = EXPERIMENTS[name]
    os.makedirs(out_dir, exist_ok=True)
    print(f"\n=== hillclimb {name}: {spec['arch']} × {spec['shape']} ===")
    prev, prev_kw, recs = None, None, []
    for label, hypothesis, kw in spec["steps"]:
        kw_eff = effective(kw)
        if prev is not None and kw_eff == prev_kw:
            rec = {**prev, "equals": prev["label"]}
        else:
            try:
                p = probe_costs(spec["arch"], spec["shape"], **kw_eff)
                rec = terms_record(p, train=spec["shape"] == "train_4k")
            except Exception as e:    # noqa: BLE001 — record, go on
                rec = {"arch": spec["arch"], "shape": spec["shape"],
                       "error": f"{type(e).__name__}: {e}"}
        rec["label"] = label
        rec["hypothesis"] = hypothesis
        fn = f"{spec['arch']}__{spec['shape']}__{label}.json"
        with open(os.path.join(out_dir, fn), "w") as f:
            json.dump(rec, f, indent=1)
        recs.append(rec)
        if "error" in rec:
            print(f"[{label:18s}] FAIL {rec['error'][:300]}", flush=True)
            continue
        line = (f"[{label:18s}] compute {fmt_seconds(rec['compute_s']):>9s} "
                f"memory {fmt_seconds(rec['memory_s']):>9s} "
                f"collective {fmt_seconds(rec['collective_s']):>9s} "
                f"dom={rec['dominant']}")
        if "equals" in rec:
            line += f"  (no counterpart: equals {rec['equals']})"
        elif prev is not None:
            tot_p = max(prev["compute_s"], prev["memory_s"],
                        prev["collective_s"])
            tot_n = max(rec["compute_s"], rec["memory_s"],
                        rec["collective_s"])
            line += f"  bound {tot_p / tot_n:5.2f}x vs prev"
        print(line, flush=True)
        prev, prev_kw = rec, kw_eff
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--target", choices=[*EXPERIMENTS, "all"], default="all")
    ap.add_argument("--out", default="results/perf")
    args = ap.parse_args(argv)
    targets = list(EXPERIMENTS) if args.target == "all" else [args.target]
    failed = sum("error" in rec for t in targets
                 for rec in run_target(t, args.out))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
