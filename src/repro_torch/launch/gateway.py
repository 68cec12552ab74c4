"""Serve a live HTTP/SSE gateway over a ServingSession.

Network front-end counterpart to :mod:`repro_torch.launch.serve` (trace
replay): builds the same engine/policy/session stack from the same
flags, then serves it at ``POST /v1/generate`` with SSE token
streaming, ``GET /metrics`` Prometheus exposition, health/readiness
probes, bounded-ingress 429 backpressure, and graceful SIGTERM drain.
A torch engine on the card serves one warmup request per prompt length
before the gateway turns ready, so no request pays for loading the
kernels' libraries (or building them) on the event loop.

Examples::

    # sim backend at 50x wall compression, two tiers, bounded ingress
    python -m repro_torch.launch.gateway --policy lazyb --time-scale 50 \\
        --sla-tiers gold:0.05,bulk:0.5 --mem-slots 64 --max-queue 256

    # full-width llama3.2-1b on the card, real wall-clock run latencies
    python -m repro_torch.launch.gateway --engine torch \\
        --arch llama3.2-1b --time-scale 1 --port 8080

    curl -N localhost:8080/v1/generate -d \\
        '{"model": "llama3.2-1b", "sla_class": "gold"}'

Exit status: 0 after a clean drain; 1 when ``--assert-no-leak`` finds
resident KV slots after drain or ``--assert-no-stall`` saw the loop
watchdog count an event-loop stall (the CI smoke gates).
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys

import numpy as np

from ..core.arbiter import LeastSlackArbiter, RoundRobinArbiter
from ..serving.backend import MultiBackend
from ..serving.gateway import GatewayApp
from ..serving.npu_model import NPUPerfModel
from ..serving.server import SimExecutor
from ..serving.session import ServingSession
from ..serving.workload import get_workload
from .serve import (HARDWARE, _session_kwargs, _split_mem_slots,
                    _torch_engine, _wrap_faults, add_engine_args,
                    build_policy, parse_mem_shares, parse_models,
                    parse_shed_priorities, parse_tiers,
                    resolve_engine_args)


def _warm_up(engine, wl, args, perf) -> None:
    """One request per prompt length (4 decode steps each) through a
    throwaway session on the bare engine, released afterwards: the first
    launches load the kernels' libraries outside any served request."""
    if engine.device.type != "cuda":
        return
    session = ServingSession(
        build_policy("lazyb", wl, perf, args.sla, args.max_batch,
                     args.window), engine, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    for prompt_len in wl.prompt_dist.lengths:
        req = wl.sample_request(rng, 0.0)
        req.prompt_len, req.decode_len = prompt_len, 4
        req.sequence, req.prefix_len, req.cycle_len = wl.build_sequence(
            prompt_len, 4)
        session.submit(req)
    session.drain()
    for handle in list(session.handles.values()):
        session.release(handle)


def build_session(args, params=None) -> ServingSession:
    """The serve.py session stack, minus the trace: sim or torch engine,
    single- or multi-model, same policy/memory/fault/shedding knobs.
    ``params`` maps a model name to weights for its torch engine."""
    params = params or {}
    perf = NPUPerfModel(HARDWARE[args.hw])
    if args.models:
        shares = parse_models(args.models)
        mem_shares = parse_mem_shares(args.mem_shares)
        if args.engine == "torch":
            caps = _split_mem_slots(args.mem_slots, shares, mem_shares)
            pairs = {name: _torch_engine(name, args, caps.get(name),
                                         params.get(name))
                     for name, _ in shares}
            for eng, wl in pairs.values():
                _warm_up(eng, wl, args, perf)
            workloads = {name: wl for name, (_, wl) in pairs.items()}
            backend = MultiBackend({name: eng
                                    for name, (eng, _) in pairs.items()})
            arb_shares = None
        else:
            workloads = {name: get_workload(name) for name, _ in shares}
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
        return session
    if args.engine == "torch":
        backend, wl = _torch_engine(args.arch, args, args.mem_slots,
                                    params.get(args.arch))
        _warm_up(backend, wl, args, perf)
    else:
        wl = get_workload(args.arch)
        backend = SimExecutor(perf, max_slots=args.mem_slots)
    policy = build_policy(args.policy, wl, perf, args.sla, args.max_batch,
                          args.window)
    session = ServingSession(backend=_wrap_faults(backend, args),
                             seed=args.seed, **_session_kwargs(args))
    session.register(wl.name, wl, policy=policy)
    return session


def build_app(args, session=None) -> GatewayApp:
    deadlines = {}
    if args.sla_tiers:
        deadlines = {cls.name: cls.deadline
                     for cls in parse_tiers(args.sla_tiers)}
    return GatewayApp(
        session if session is not None else build_session(args),
        host=args.host, port=args.port, time_scale=args.time_scale,
        tick=args.tick_ms / 1e3, request_timeout=args.request_timeout,
        max_inflight=args.max_inflight,
        metrics_log_interval=args.metrics_log_interval,
        default_sla=args.sla, deadline_by_class=deadlines,
        seed=args.seed, drain_grace=args.drain_grace,
        stall_interval=getattr(args, "stall_interval", 0.005),
        stall_threshold=getattr(args, "stall_threshold", 0.25),
        log_enabled=not args.quiet)


def dump_json(path: str, app: GatewayApp, args) -> None:
    """Drained-run artifact: exact invocation, session stats, gateway
    counters — reproducible from the JSON alone."""

    def clean(obj):
        if isinstance(obj, dict):
            return {k: clean(v) for k, v in obj.items()}
        if isinstance(obj, float) and np.isnan(obj):
            return None
        return obj

    stats = app.drained_stats
    mem = app.session.backend.memory_stats()
    doc = {
        "invocation": {"argv": list(args.argv), "seed": args.seed},
        "args": {"engine": args.engine, "policy": args.policy,
                 "models": args.models, "arch": args.arch,
                 "sla": args.sla, "sla_tiers": args.sla_tiers,
                 "time_scale": args.time_scale,
                 "mem_slots": args.mem_slots,
                 "max_queue": args.max_queue,
                 "max_inflight": args.max_inflight,
                 "fault_spec": args.fault_spec, "seed": args.seed},
        "summary": clean(stats.summary(sla=args.sla)),
        "per_class": clean(stats.per_class(args.sla)),
        "per_model": clean(stats.per_model(args.sla)),
        "gateway": clean(app.metrics.snapshot()),
        "loop": app.sanitizer.stats.as_dict(),
        "memory": {"slots_live": mem.slots_live,
                   "slots_total": mem.slots_total,
                   "max_slots": mem.max_slots},
    }
    if args.engine == "torch":
        doc["args"].update(device=args.device, dtype=args.dtype,
                           reduced=args.reduced, hw=args.hw)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    print(f"wrote {path}", file=sys.stderr)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080,
                    help="listen port (0 = ephemeral, printed in the "
                         "ready log record)")
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="session-clock seconds per wall second (sim "
                         "backend: >1 compresses wall time; torch: keep 1)")
    ap.add_argument("--tick-ms", type=float, default=2.0,
                    help="pump interval in wall ms")
    ap.add_argument("--request-timeout", type=float, default=None,
                    help="per-request wall-clock budget in seconds; "
                         "expiry cancels the handle and reports 408")
    ap.add_argument("--max-inflight", type=int, default=None,
                    help="gateway in-flight soft bound; beyond it new "
                         "work gets 429 + Retry-After (protected-"
                         "priority requests keep headroom)")
    ap.add_argument("--metrics-log-interval", type=float, default=None,
                    help="emit a periodic metrics log record every N "
                         "wall seconds")
    ap.add_argument("--drain-grace", type=float, default=5.0,
                    help="max wall seconds to wait for handlers to "
                         "flush after drain")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress JSON access/lifecycle logs")
    ap.add_argument("--json-out", default=None,
                    help="write the drained-run artifact to this file")
    ap.add_argument("--assert-no-leak", action="store_true",
                    help="exit 1 when KV slots remain resident after "
                         "drain (CI smoke gate)")
    ap.add_argument("--stall-interval", type=float, default=0.005,
                    help="event-loop stall watchdog probe period in "
                         "wall seconds")
    ap.add_argument("--stall-threshold", type=float, default=0.25,
                    help="wakeup lag above this many wall seconds "
                         "counts as an event-loop stall")
    ap.add_argument("--assert-no-stall", action="store_true",
                    help="exit 1 when the watchdog counted any "
                         "event-loop stall (CI smoke gate)")
    # session stack (mirrors launch/serve.py)
    ap.add_argument("--arch", default="transformer")
    ap.add_argument("--models", default=None,
                    help='multi-tenant mixture "name:share[,...]"')
    ap.add_argument("--arbiter", default="least-slack",
                    choices=["rr", "least-slack"])
    ap.add_argument("--policy", default="lazyb",
                    choices=["serial", "graphb", "cellular", "lazyb",
                             "oracle"])
    add_engine_args(ap)
    ap.add_argument("--sla", type=float, default=None,
                    help="global SLA target in seconds (default: 0.1 "
                         "sim; torch: 10 on the card, 60 on the CPU)")
    ap.add_argument("--sla-tiers", default=None,
                    help='SLA classes requests may ask for, e.g. '
                         '"gold:0.05,bulk:0.5"')
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--window", type=float, default=0.025)
    ap.add_argument("--mem-slots", type=int, default=None)
    ap.add_argument("--mem-shares", default=None)
    ap.add_argument("--fault-spec", default=None)
    ap.add_argument("--fault-seed", type=int, default=None)
    ap.add_argument("--max-retries", type=int, default=None)
    ap.add_argument("--cancel-expired", action="store_true")
    ap.add_argument("--max-queue", type=int, default=None)
    ap.add_argument("--shed", action="store_true")
    ap.add_argument("--shed-priorities", default=None)
    ap.add_argument("--seed", type=int, default=0)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    resolve_engine_args(args, argv, "repro_torch.launch.gateway")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    app = build_app(args)
    asyncio.run(app.run())

    stats = app.drained_stats
    summary = stats.summary(sla=args.sla)
    print(f"gateway drained: completed {summary['completed']}  "
          f"viol {summary.get('sla_violation_rate', float('nan')) * 100:.1f}%"
          f"  429s {int(app.metrics.backpressure.total())}",
          file=sys.stderr)
    loop_stats = app.sanitizer.stats
    print(f"event loop: {loop_stats.ticks} probes  "
          f"{loop_stats.stalls} stall(s)  "
          f"max lag {loop_stats.max_lag_s * 1e3:.1f}ms  "
          f"lag p99 {loop_stats.lag_p99_s() * 1e3:.1f}ms",
          file=sys.stderr)
    if args.json_out:
        dump_json(args.json_out, app, args)
    if args.assert_no_stall and loop_stats.stalls:
        print(f"STALL: {loop_stats.stalls} event-loop stall(s) over "
              f"{args.stall_threshold}s (max lag "
              f"{loop_stats.max_lag_s:.3f}s)", file=sys.stderr)
        return 1
    if args.assert_no_leak:
        mem = app.session.backend.memory_stats()
        if mem.slots_live != 0:
            print(f"LEAK: {mem.slots_live} KV slot(s) resident after "
                  f"drain", file=sys.stderr)
            return 1
        print("no leaked KV slots (slots_live=0 after drain)",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
