"""Serving launcher of the port.

Two engines, ONE code path — both build a :class:`ServingSession` over the
run-commit scheduling core and print the same summary line:

  * ``--engine sim``   — discrete-event simulation on the NPU latency model
    (any architecture/workload at any load, instantly; virtual time),
  * ``--engine torch`` — the real node-level ``TorchEngine`` (wall-clock
    time). It runs on the card (``--device cuda``, the default, in
    bfloat16) at full width: ``max_len`` 1024, prompts of 64, 128, 256 and
    384 tokens, 16, 32 or 64 decode steps. ``--device cpu --reduced``
    serves the reduced model in float32 with short prompts; the launcher
    never picks the CPU on its own.

  python -m repro_torch.launch.serve --engine torch --arch llama3.2-1b \\
      --policy lazyb --rate 20 --duration 2

Multi-tenant serving: ``--models "llama3.2-1b:0.6,mamba2-2.7b:0.4"``
registers one model per ``name:share`` pair (shares split ``--rate``),
generates a Poisson mixture with independent per-model RNG streams, and
arbitrates committed runs across models with ``--arbiter`` (``rr``
round-robin baseline or the SLA-aware ``least-slack``). Per-model
breakdowns print alongside the aggregate; the sim engine serves every
model through one SimExecutor, the torch engine builds one engine per
name behind a MultiBackend.

Mixed-tier serving: ``--sla-tiers "gold:0.05,bulk:0.5"`` assigns each
request one of the named SLA classes uniformly at random and reports
per-class violation rates alongside the aggregate.

Bounded-memory serving: ``--mem-slots 16`` caps the device KV pool at 16
resident request slots (the sim pays a thrash penalty past the cap; the
torch engine's paged arena hard-caps at it) and enables memory-aware
admission — overflow defers in the InfQ instead of oversubscribing
device memory. ``--mem-shares "transformer:0.6,gnmt:0.4"`` splits the
pool across the ``--models`` tenants (keys are registered MODEL names,
not SLA tiers) so neither can starve the other of slots; it requires
both ``--models`` and ``--mem-slots``.

Fault-tolerant serving: ``--fault-spec "transient:0.05,straggler:0.1x4"``
wraps the backend in a seeded deterministic chaos layer (per-model form:
``bulk=transient:0.1;gold=straggler:0.02x6``) and arms retry with capped
exponential backoff (``--max-retries``). ``--cancel-expired`` reaps
provably deadline-blown requests mid-flight at run boundaries,
``--max-queue`` bounds the ingress backlog with deadline-aware shedding,
and ``--shed`` arms brownout shedding (drop lowest-``shed_priority``
work while the protected tier's rolling attainment is below floor;
per-model priorities via ``--shed-priorities "gold:1,bulk:0"``). CI
gates on ``--assert-attainment gold:0.5`` (exit 1 below the floor) and
``--assert-no-leak`` (exit 1 if any KV slot stays resident after drain).

``--json-out stats.json`` dumps the full ServeStats — summary, per-class
AND per-model breakdowns, device-time shares, fault/retry/shed
accounting — for CI artifacts and offline analysis.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..configs import ARCHITECTURES, get_config
from ..core.arbiter import LeastSlackArbiter, RoundRobinArbiter
from ..core.policies import (CellularBatching, GraphBatching, LazyBatching,
                             Oracle, Serial)
from ..core.request import SLAClass
from ..core.slack import OracleSlackPredictor, SlackPredictor
from ..serving.backend import MultiBackend
from ..serving.faults import FaultInjectingBackend, parse_fault_specs
from ..serving.npu_model import H100_SXM, NPUPerfModel, PAPER_NPU, TPU_V5E
from ..serving.session import BrownoutConfig, RetryPolicy, ServingSession
from ..serving.server import SimExecutor
from ..serving.traffic import (bursty_trace, poisson_mixture, poisson_trace,
                               with_sla_classes)
from ..serving.workload import (LengthDist, from_model_config, get_workload)

HARDWARE = {"paper": PAPER_NPU, "v5e": TPU_V5E, "h100": H100_SXM}
# (prompt lengths, decode lengths) of the torch engine's trace: --reduced
# takes the JAX launcher's short CPU ones, full width chip_smoke.py's serve
REDUCED_LENGTHS = ((6, 8, 10, 12), (2, 3, 4, 5))
FULL_LENGTHS = ((64, 128, 256, 384), (16, 32, 64))


def build_policy(name: str, wl, perf, sla: float, max_batch: int,
                 window: float):
    if name == "serial":
        return Serial()
    if name == "graphb":
        return GraphBatching(window=window, max_batch=max_batch)
    if name == "cellular":
        return CellularBatching(max_batch=max_batch)
    if name == "lazyb":
        return LazyBatching(SlackPredictor.build([wl], perf, sla),
                            max_batch=max_batch)
    if name == "oracle":
        return Oracle(OracleSlackPredictor(sla, perf), max_batch=max_batch)
    raise KeyError(name)


def parse_tiers(spec: str):
    """Parse ``name:deadline_s[,name:deadline_s...]`` into SLA classes."""
    classes = []
    for part in spec.split(","):
        name, _, deadline = part.strip().partition(":")
        classes.append(SLAClass(name=name, deadline=float(deadline)))
    return classes


def parse_models(spec: str):
    """Parse ``name:share[,name:share...]`` into normalized (name, share)
    pairs (the share splits the aggregate ``--rate``; model names may
    contain dots/dashes, so the LAST colon separates the share)."""
    pairs = []
    for part in spec.split(","):
        name, _, share = part.strip().rpartition(":")
        try:
            value = float(share)
        except ValueError:
            value = float("nan")
        if not name or not value > 0:       # catches NaN, 0, negatives
            raise SystemExit(
                f"--models entry {part!r} must be name:positive_share")
        pairs.append((name, value))
    total = sum(s for _, s in pairs)
    return [(n, s / total) for n, s in pairs]


def _torch_workload(cfg, reduced: bool):
    prompts, decodes = REDUCED_LENGTHS if reduced else FULL_LENGTHS
    return from_model_config(
        cfg, prompt_dist=LengthDist(prompts, (1 / len(prompts),) * len(prompts)),
        decode_dist=LengthDist(decodes, (1 / len(decodes),) * len(decodes)))


def _torch_engine(name, args, max_slots=None, params=None):
    """One engine + its served workload for ``name``: full width on
    ``args.device`` unless ``args.reduced``. ``max_slots`` is THIS
    engine's arena cap (per-model engines own disjoint pools —
    multi-tenant callers split the device budget); ``params`` replaces
    the seeded random weights (the port's layout)."""
    import torch
    from ..serving.engine import TorchEngine
    arch = name if name in ARCHITECTURES else "llama3.2-1b"
    cfg = get_config(arch)
    if args.reduced:
        cfg = cfg.reduced()
    engine = TorchEngine(cfg, max_len=64 if args.reduced else 1024,
                         seed=args.seed, max_slots=max_slots,
                         dtype=getattr(torch, args.dtype),
                         device=args.device, params=params)
    return engine, _torch_workload(cfg, args.reduced)


def _split_mem_slots(mem_slots, shares, mem_shares):
    """Per-model arena caps for the torch engine: per-model engines hold
    DISJOINT pools, so the one ``--mem-slots`` device budget is split
    structurally — by ``--mem-shares`` when given (normalized; traffic
    share fills unspecified models), else by traffic share. The split is
    budget-exact: caps sum to EXACTLY ``mem_slots`` (largest-remainder
    apportionment, every model >= 1 slot), never oversubscribing the
    device the flag claims to bound. (The arbiter's share caps are for
    SHARED pools like the simulator's and would double-cap disjoint
    ones.)"""
    if mem_slots is None:
        return {}
    if mem_slots < len(shares):
        raise SystemExit(
            f"--mem-slots {mem_slots} < {len(shares)} models: every "
            f"per-model arena needs at least one slot")
    weights = {name: (mem_shares or {}).get(name, share)
               for name, share in shares}
    total_w = sum(weights.values())
    quota = {n: mem_slots * w / total_w for n, w in weights.items()}
    caps = {n: int(q) for n, q in quota.items()}
    # hand leftover slots to the largest fractional remainders
    leftovers = sorted(quota, key=lambda n: quota[n] - caps[n], reverse=True)
    for n in leftovers[:mem_slots - sum(caps.values())]:
        caps[n] += 1
    # a zero-slot arena cannot serve: bump from the largest allocation
    for n in caps:
        while caps[n] == 0:
            caps[max(caps, key=caps.get)] -= 1
            caps[n] += 1
    return caps


def parse_mem_shares(spec):
    """Parse ``name:fraction[,name:fraction...]`` per-model memory shares
    (fractions of the ``--mem-slots`` pool; must sum to <= 1)."""
    if not spec:
        return None
    shares = {}
    for part in spec.split(","):
        name, _, frac = part.strip().rpartition(":")
        try:
            value = float(frac)
        except ValueError:
            value = float("nan")
        if not name or not 0.0 < value <= 1.0:
            raise SystemExit(
                f"--mem-shares entry {part!r} must be name:fraction_in_(0,1]")
        shares[name] = value
    if sum(shares.values()) > 1.0 + 1e-9:
        raise SystemExit(f"--mem-shares oversubscribe the pool: {shares}")
    return shares


def parse_shed_priorities(spec):
    """Parse ``name:priority[,name:priority...]`` per-model shed
    priorities (ints; brownout sheds strictly-lower tiers to protect the
    highest)."""
    if not spec:
        return {}
    out = {}
    for part in spec.split(","):
        name, _, prio = part.strip().rpartition(":")
        try:
            value = int(prio)
        except ValueError:
            name = ""
        if not name:
            raise SystemExit(
                f"--shed-priorities entry {part!r} must be name:int")
        out[name] = value
    return out


def _wrap_faults(backend, args):
    """Seeded chaos layer between the session and the real backend."""
    if not args.fault_spec:
        return backend
    try:
        spec = parse_fault_specs(args.fault_spec)
    except ValueError as e:
        raise SystemExit(f"--fault-spec: {e}")
    seed = args.fault_seed if args.fault_seed is not None else args.seed
    return FaultInjectingBackend(backend, spec, seed=seed)


def _session_kwargs(args):
    """Robustness knobs shared by both launcher paths. Retry arms
    whenever faults can occur (or the budget is set explicitly); all
    knobs default OFF so fault-free runs are bit-identical to before."""
    kw = {"cancel_expired": args.cancel_expired,
          "max_queue": args.max_queue,
          "brownout": BrownoutConfig() if args.shed else None}
    if args.fault_spec or args.max_retries is not None:
        budget = 3 if args.max_retries is None else args.max_retries
        kw["retry"] = RetryPolicy(max_retries=budget)
    return kw


def _check_gates(session, stats, args) -> int:
    """CI gates: 1 on a leaked KV slot or attainment below the asserted
    floor (``tier:floor`` judges one SLA class, a bare float judges the
    aggregate), else 0."""
    failed = False
    if args.assert_no_leak:
        mem = session.backend.memory_stats()
        if mem.slots_live != 0:
            print(f"  LEAK: {mem.slots_live} KV slot(s) resident after "
                  f"drain")
            failed = True
        else:
            print("  no leaked KV slots (slots_live=0 after drain)")
    if args.assert_attainment:
        tier, _, floor_s = args.assert_attainment.rpartition(":")
        try:
            floor = float(floor_s)
        except ValueError:
            raise SystemExit(f"--assert-attainment {args.assert_attainment!r}"
                             f" must be [tier:]floor_fraction")
        if tier:
            row = stats.per_class(args.sla).get(tier)
            att = row["sla_attainment"] if row else float("nan")
            label = f"{tier}-tier"
        else:
            att = stats.attainment(args.sla)
            label = "aggregate"
        ok = not np.isnan(att) and att + 1e-12 >= floor
        print(f"  attainment gate: {label} "
              f"{att * 100:.1f}% vs floor {floor * 100:.1f}% -> "
              f"{'PASS' if ok else 'FAIL'}")
        failed = failed or not ok
    return 1 if failed else 0


def _run_session(session, trace, label, args) -> int:
    """The shared tail of every launcher path: replay, drain, report;
    returns the gates' exit code."""
    session.duration = trace.duration
    for req in trace.requests:
        session.submit(req)
    stats = session.drain()
    print_summary(label, args, stats, session.log)
    if args.json_out:
        dump_json(args.json_out, stats, session.log, args, session=session)
    return _check_gates(session, stats, args)


def print_summary(wl_name: str, args, stats, log):
    s = stats.summary(sla=args.sla)
    kind = "bursty" if args.bursty else "poisson"
    print(f"{wl_name} @ {args.rate:g} r/s ({kind})"
          f" policy={s['policy']} engine={args.engine}")
    print(f"  completed {s['completed']}  avg {s['avg_latency_ms']:.2f}ms  "
          f"p50 {s['p50_ms']:.2f}ms  p99 {s['p99_ms']:.2f}ms  "
          f"thr {s['throughput_rps']:.0f} r/s  "
          f"SLA viol {s['sla_violation_rate'] * 100:.1f}%  "
          f"avg batch {log.avg_batch_size:.1f}")
    extras = [f"{key} {s[key]}"
              for key in ("cancelled", "expired", "failed", "shed",
                          "retried")
              if key in s]
    if extras or log.faults:
        print(f"  faults {log.faults}  " + "  ".join(extras))
    per_class = stats.per_class(args.sla)
    if set(per_class) != {"default"}:
        tiers = "  ".join(f"{name} {row['sla_violation_rate'] * 100:.1f}%"
                          for name, row in per_class.items())
        print(f"  per-tier SLA viol: {tiers}")
    if len(stats.models) > 1:
        print(f"  aggregate SLA attainment "
              f"{stats.attainment(args.sla) * 100:.1f}%")
        for name, row in stats.per_model(args.sla).items():
            busy = log.busy_by_model.get(name, 0.0)
            print(f"  [{name}] completed {row['completed']}  "
                  f"p50 {row['p50_ms']:.2f}ms  p99 {row['p99_ms']:.2f}ms  "
                  f"attain {row['sla_attainment'] * 100:.1f}%  "
                  f"busy {busy * 1e3:.1f}ms")


def dump_json(path: str, stats, log, args, session=None):
    """Full ServeStats snapshot: aggregate summary + per-class + per-model
    breakdowns + device-time shares + fault/retry/shed accounting
    (NaN-safe: NaN serializes as null)."""

    def clean(obj):
        if isinstance(obj, dict):
            return {k: clean(v) for k, v in obj.items()}
        if isinstance(obj, float) and np.isnan(obj):
            return None
        return obj

    doc = {
        # exact reproduction recipe: re-running `python <argv...>` with
        # this seed regenerates the artifact bit-for-bit (sim backend)
        "invocation": {"argv": list(args.argv), "seed": args.seed},
        "args": {"engine": args.engine, "policy": args.policy,
                 "rate": args.rate, "duration": args.duration,
                 "sla": args.sla, "models": args.models,
                 "arbiter": args.arbiter, "seed": args.seed,
                 "mem_slots": args.mem_slots, "mem_shares": args.mem_shares,
                 "fault_spec": args.fault_spec,
                 "max_retries": args.max_retries,
                 "cancel_expired": args.cancel_expired,
                 "max_queue": args.max_queue, "shed": args.shed,
                 "shed_priorities": args.shed_priorities},
        "summary": clean(stats.summary(sla=args.sla)),
        "per_class": clean(stats.per_class(args.sla)),
        "per_model": clean(stats.per_model(args.sla)),
        "registered_models": stats.models,
        "rejected": stats.rejected,
        "log": {"nodes_executed": log.nodes_executed,
                "runs_executed": log.runs_executed,
                "busy_time": log.busy_time,
                "avg_batch_size": log.avg_batch_size,
                "avg_run_length": log.avg_run_length,
                "busy_by_model": dict(log.busy_by_model),
                "faults": log.faults},
    }
    if args.engine == "torch":
        doc["args"].update(device=args.device, dtype=args.dtype,
                           reduced=args.reduced, hw=args.hw)
    if session is not None:
        mem = session.backend.memory_stats()
        doc["memory"] = {"slots_live": mem.slots_live,
                         "slots_total": mem.slots_total,
                         "max_slots": mem.max_slots}
        if isinstance(session.backend, FaultInjectingBackend):
            doc["injected_faults"] = session.backend.fault_stats()
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    print(f"wrote {path}")


def add_engine_args(ap):
    """The torch engine's flags, shared with ``launch.gateway``."""
    ap.add_argument("--engine", default="sim", choices=["sim", "torch"])
    ap.add_argument("--device", default="cuda",
                    help="torch engine device (default cuda: raises when "
                         "no CUDA device is present; cpu only when given)")
    ap.add_argument("--dtype", default=None,
                    choices=["bfloat16", "float32"],
                    help="torch engine dtype (default bfloat16 on the "
                         "card, float32 on the CPU)")
    ap.add_argument("--reduced", action="store_true",
                    help="torch engine: the reduced model (cfg.reduced(), "
                         "max_len 64, short prompts) instead of full width")
    ap.add_argument("--hw", default=None, choices=sorted(HARDWARE),
                    help="latency model of the slack predictor and the sim "
                         "(default h100 for torch, paper for sim)")


def resolve_engine_args(args, argv, module: str):
    """Fill the defaults that depend on the engine and device, and the
    command line that reproduces the run."""
    torch_cpu = args.engine == "torch" and args.device == "cpu"
    if args.dtype is None:
        args.dtype = "float32" if torch_cpu else "bfloat16"
    if args.hw is None:
        args.hw = "h100" if args.engine == "torch" else "paper"
    if args.sla is None:
        # torch serves in wall-clock seconds: the card's full-width serve
        # gets chip_smoke.py's SLA, the CPU's reduced one the JAX launcher's
        args.sla = (0.1 if args.engine == "sim" else
                    60.0 if torch_cpu else 10.0)
    args.argv = ["-m", module] + list(argv)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="transformer",
                    help="paper workload or assigned architecture id")
    ap.add_argument("--models", default=None,
                    help='multi-tenant mixture "name:share[,name:share...]"'
                         ' — registers one model per entry; shares split '
                         '--rate (overrides --arch)')
    ap.add_argument("--arbiter", default="least-slack",
                    choices=["rr", "least-slack"],
                    help="cross-model dispatch arbiter (multi-model only)")
    ap.add_argument("--policy", default="lazyb",
                    choices=["serial", "graphb", "cellular", "lazyb",
                             "oracle"])
    add_engine_args(ap)
    ap.add_argument("--rate", type=float, default=200.0)
    ap.add_argument("--duration", type=float, default=1.0)
    ap.add_argument("--sla", type=float, default=None,
                    help="global SLA target in seconds (default: 0.1 for "
                         "sim; torch wall-clock: 10 on the card, 60 on "
                         "the CPU)")
    ap.add_argument("--sla-tiers", default=None,
                    help='mixed per-request SLA classes, e.g. '
                         '"gold:0.05,bulk:0.5" (uniform random assignment)')
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--mem-slots", type=int, default=None,
                    help="bound device KV memory to this many resident "
                         "request slots (sim: thrash penalty past the cap; "
                         "torch: paged-arena hard cap) and turn on "
                         "memory-aware admission")
    ap.add_argument("--mem-shares", default=None,
                    help='per-model memory shares under --mem-slots, keyed '
                         'by registered model name (NOT SLA tier), e.g. '
                         '"transformer:0.6,gnmt:0.4" (fractions of the slot '
                         'pool; keeps one tenant from starving another); '
                         'requires --models and --mem-slots')
    ap.add_argument("--fault-spec", default=None,
                    help='seeded fault injection, e.g. '
                         '"transient:0.05,oom:0.01,straggler:0.1x4" or the '
                         'per-model form "bulk=transient:0.1;gold=..." — '
                         'arms retry/backoff automatically')
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="fault-injection RNG seed (default: --seed)")
    ap.add_argument("--max-retries", type=int, default=None,
                    help="retry budget per request before FAILED "
                         "(default 3 when --fault-spec is set)")
    ap.add_argument("--cancel-expired", action="store_true",
                    help="reap provably deadline-blown requests mid-flight "
                         "at run boundaries (frees their KV slots early)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound the ingress backlog; overflow sheds the "
                         "lowest-priority / most-hopeless request")
    ap.add_argument("--shed", action="store_true",
                    help="arm brownout shedding: drop lowest-shed-priority "
                         "work while the protected tier's rolling "
                         "attainment is below floor")
    ap.add_argument("--shed-priorities", default=None,
                    help='per-model shed priorities "gold:1,bulk:0" '
                         '(higher survives brownout; requires --models)')
    ap.add_argument("--assert-attainment", default=None,
                    help='CI gate "tier:floor" (or bare "floor" for the '
                         "aggregate): exit 1 when SLA attainment lands "
                         "below the floor fraction")
    ap.add_argument("--assert-no-leak", action="store_true",
                    help="CI gate: exit 1 when any KV slot is still "
                         "resident after drain")
    ap.add_argument("--window", type=float, default=0.025)
    ap.add_argument("--bursty", action="store_true",
                    help="MMPP bursty arrivals instead of Poisson")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None,
                    help="write the full ServeStats (summary + per-class + "
                         "per-model) to this JSON file")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    resolve_engine_args(args, argv, "repro_torch.launch.serve")
    return args


def serve(args, params=None):
    """Build the session stack ``args`` describes, replay its trace and
    drain it; returns ``(session, exit code)``. ``params`` maps a model
    name to weights for its torch engine (the tests' JAX weights)."""
    params = params or {}
    perf = NPUPerfModel(HARDWARE[args.hw])

    if args.mem_shares and not args.models:
        raise SystemExit("--mem-shares splits the slot pool across the "
                         "--models mixture; pass --models (it has no "
                         "effect on a single-model run)")
    if args.mem_shares and args.mem_slots is None:
        raise SystemExit("--mem-shares describes fractions of the "
                         "--mem-slots pool; pass --mem-slots too")
    if args.shed_priorities and not args.models:
        raise SystemExit("--shed-priorities keys registered model names; "
                         "pass --models (a single-model run has one tier, "
                         "so brownout never sheds)")

    # ---- multi-tenant mixture path -------------------------------------
    if args.models:
        if args.bursty:
            raise SystemExit("--models implies Poisson mixture arrivals; "
                             "drop --bursty")
        shares = parse_models(args.models)
        mem_shares = parse_mem_shares(args.mem_shares)
        if args.engine == "torch":
            # disjoint per-model arenas: split the device slot budget
            # structurally (shares enforced by construction, not the gate)
            caps = _split_mem_slots(args.mem_slots, shares, mem_shares)
            pairs = {name: _torch_engine(name, args, caps.get(name),
                                         params.get(name))
                     for name, _ in shares}
            workloads = {name: wl for name, (_, wl) in pairs.items()}
            backend = MultiBackend({name: eng
                                    for name, (eng, _) in pairs.items()})
            arb_shares = None            # already applied per-pool
        else:
            workloads = {name: get_workload(name) for name, _ in shares}
            # model-agnostic: one for all; --mem-slots bounds the one
            # simulated device's KV pool SHARED across every registered
            # model — here the arbiter's shares do the tenant capping
            backend = SimExecutor(perf, max_slots=args.mem_slots)
            arb_shares = mem_shares
        arbiter = (RoundRobinArbiter(mem_shares=arb_shares)
                   if args.arbiter == "rr"
                   else LeastSlackArbiter(sla_default=args.sla,
                                          mem_shares=arb_shares))
        session = ServingSession(backend=_wrap_faults(backend, args),
                                 arbiter=arbiter, seed=args.seed,
                                 **_session_kwargs(args))
        prios = parse_shed_priorities(args.shed_priorities)
        for name, _ in shares:
            wl = workloads[name]
            session.register(name, wl,
                             policy=build_policy(args.policy, wl, perf,
                                                 args.sla, args.max_batch,
                                                 args.window),
                             shed_priority=prios.get(name, 0))
        trace = poisson_mixture(
            [(name, workloads[name], args.rate * share)
             for name, share in shares],
            args.duration, seed=args.seed)
        if args.sla_tiers:
            with_sla_classes(trace, parse_tiers(args.sla_tiers),
                             seed=args.seed)
        # submissions route on each request's mixture model tag
        code = _run_session(session, trace,
                            "+".join(name for name, _ in shares), args)
        return session, code

    # ---- single-model path ---------------------------------------------
    if args.engine == "torch":
        backend, wl = _torch_engine(args.arch, args, args.mem_slots,
                                    params.get(args.arch))
    else:
        wl = get_workload(args.arch)
        backend = SimExecutor(perf, max_slots=args.mem_slots)

    if args.bursty:
        trace = bursty_trace(wl, args.rate * 0.3, args.rate * 2.0,
                             switch_period=args.duration / 6,
                             duration=args.duration, seed=args.seed)
    else:
        trace = poisson_trace(wl, args.rate, args.duration, seed=args.seed)
    if args.sla_tiers:
        with_sla_classes(trace, parse_tiers(args.sla_tiers), seed=args.seed)

    policy = build_policy(args.policy, wl, perf, args.sla, args.max_batch,
                          args.window)
    session = ServingSession(policy, _wrap_faults(backend, args),
                             seed=args.seed, **_session_kwargs(args))
    return session, _run_session(session, trace, wl.name, args)


def main(argv=None) -> int:
    return serve(parse_args(argv))[1]


if __name__ == "__main__":
    sys.exit(main())
