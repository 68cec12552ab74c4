#!/usr/bin/env python3
"""Check the synchronization of the float32 flash prefill kernel on one card.

    python3 tools/check_flash_f32_sync.py [--out DIR]

The kernel (``flash_tf32x3_kernel`` in ``src/repro_torch/csrc/flash_attn.cu``)
hands K/V tiles from a producer warpgroup to two consumer warpgroups through
a ring of mbarriers and a staging tile guarded by a named barrier. Three
checks, in order, each printing one line per case:

  sanitizer  compute-sanitizer's racecheck, synccheck and memcheck, each on
             this script re-run with ``--target``, which launches only the
             kernel (inputs made on the host and copied over) at small
             shapes with D 64 and D 128: T no multiple of the key tile, one,
             two, three, four and five key tiles per q-tile, a query offset,
             a window and GQA. The full logs go to DIR.
  stress     200 launches at llama3.2-1b's largest prefill bucket
             (q (4, 512, 32, 64), kv (4, 512, 8, 64), causal), at S 383
             with q_offset 1 (T 384) at D 64 and D 128 (one consumer
             warpgroup, 32-key tiles), and at D 32 with a window: every
             output must equal the first bit for bit, and the first must
             agree with the plain version within 2e-5.
  jitter     the same stress on a second build of the source with
             ``-DREPRO_SYNC_JITTER``, whose warps sleep pseudo-random times
             at every hand-over: its outputs must also equal the normal
             build's first output bit for bit.

Prints the card's name and power limit first. Exits 1 when a check fails or
compute-sanitizer reports an error or a hazard, 3 when the stresses pass but
compute-sanitizer could not run the kernel (it refuses some virtualized
cards: "Device not supported"), 2 without a CUDA device, else 0.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

TOL = 2e-5
LAUNCHES = 200
# (B, S, T, H, KV, q_offset, window): key tiles per q-tile at D 64 (64 keys,
# 128-row q-tiles) and D 128 (32 keys, 64-row q-tiles) in the comments
TARGET_CASES = (
    (1, 150, 150, 2, 1, 0, None),    # D 64: 2, 3; D 128: 2, 4, 5
    (1, 20, 23, 2, 1, 3, None),      # one partial key tile
    (2, 100, 161, 4, 2, 61, 50),     # q_offset, window, GQA 2
)
# (B, S, T, H, KV, q_offset, window, D)
STRESS_CASES = (
    ("S 512", (4, 512, 512, 32, 8, 0, None, 64)),
    ("S 383, q_offset 1", (4, 383, 384, 32, 8, 1, None, 64)),
    ("D 128, S 383, q_offset 1", (4, 383, 384, 32, 8, 1, None, 128)),
    ("D 32, S 300, window 100", (2, 300, 300, 8, 2, 0, 100, 32)),
)


def inputs(torch, B, S, T, H, KV, D, seed, device):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, S, H, D), generator=g)
    k = torch.randn((B, T, KV, D), generator=g)
    v = torch.randn((B, T, KV, D), generator=g)
    return tuple(x.to(device) for x in (q, k, v))


def target(ds) -> int:
    """Launch the kernel alone (no other kernel runs on the card) for each
    target case and D; compare with the plain version on the host."""
    import torch
    import repro_torch.kernels as K
    worst = 0.0
    for D in ds:
        for i, (B, S, T, H, KV, off, win) in enumerate(TARGET_CASES):
            q, k, v = inputs(torch, B, S, T, H, KV, D, 10 + i, "cpu")
            want = K.flash_attention_plain(q, k, v, window=win, q_offset=off)
            got = K.flash_attention(q.cuda(), k.cuda(), v.cuda(), window=win,
                                    q_offset=off).cpu()
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            print(f"[target] D {D} B {B} S {S} T {T} H {H} KV {KV} q_offset "
                  f"{off} window {win}: max|err| {err:.3e}", flush=True)
    return 0 if worst <= TOL else 1


def sanitizer(out: Path) -> str:
    """racecheck, synccheck and memcheck on ``--target``: "clean" when all
    ran and reported nothing, "not run" when one could not run the target
    (a device the sanitizer does not support), else "reported"."""
    from repro_torch.kernels import _build
    tool = shutil.which("compute-sanitizer") or str(
        Path(_build.nvcc()).parent / "compute-sanitizer")
    states = []
    for name in ("racecheck", "synccheck", "memcheck"):
        log = out / f"sanitizer_{name}.log"
        cmd = [tool, "--tool", name, "--print-limit", "50", sys.executable,
               str(Path(__file__).resolve()), "--target", "64", "128"]
        if name == "racecheck":
            cmd[3:3] = ["--racecheck-report", "all"]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=480)
            text, rc = proc.stdout + proc.stderr, proc.returncode
        except (OSError, subprocess.TimeoutExpired) as e:
            text, rc = f"{type(e).__name__}: {e}", None
        log.write_text(text)
        secs = time.perf_counter() - t0
        summary = [ln.strip() for ln in text.splitlines()
                   if "SUMMARY" in ln or "hazard" in ln.lower()]
        errors = [int(n) for n in re.findall(r"ERROR SUMMARY: (\d+) error",
                                             text)]
        targets = text.count("[target]")
        ran = bool(errors) and targets == 2 * len(TARGET_CASES)
        clean = ran and rc == 0 and not any(errors) and not re.search(
            r"RACECHECK SUMMARY: [1-9]", text)
        states.append("clean" if clean else "reported" if ran else "not run")
        why = [ln.strip(" =") for ln in text.splitlines() if "Error:" in ln]
        print(f"[sanitizer] {name}: exit {rc}, {secs:.1f} s, "
              f"{targets} of {2 * len(TARGET_CASES)} target lines, "
              + {"clean": "clean", "reported": "REPORTED",
                 "not run": "DID NOT RUN"}[states[-1]]
              + f" | {' | '.join(why[:1] + summary[-2:])}", flush=True)
    return ("reported" if "reported" in states else
            "not run" if "not run" in states else "clean")


def launch_raw(torch, fn, q, k, v, off, win):
    """One launch through the C entry ``fn``, the wrapper's arguments."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, T,
             H, KV, D, off, -1 if win is None else win, 0,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention: CUDA error {err} at launch")
    return o


def jitter_function():
    """The C entry of a build of csrc/flash_attn.cu with REPRO_SYNC_JITTER,
    in build/repro_torch_jitter/."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR.parent / "repro_torch_jitter"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libflash_attn.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-DREPRO_SYNC_JITTER",
                    "-I", str(_build.CSRC), "-o", str(lib),
                    str(_build.CSRC / "flash_attn.cu")], check=True,
                   capture_output=True, text=True)
    fn = ctypes.PyDLL(str(lib)).repro_flash_attention
    fn.argtypes = _build.SIGNATURES["flash_attn"]["repro_flash_attention"]
    fn.restype = ctypes.c_int
    return fn


def per_launch_us(torch, fn, q, k, v, off, win, n=50) -> float:
    """Microseconds per launch over CUDA events around ``n`` launches in a
    row (the card, not the host, sets the pace at these shapes)."""
    launch_raw(torch, fn, q, k, v, off, win)
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        launch_raw(torch, fn, q, k, v, off, win)
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) * 1e3 / n


def stress() -> bool:
    import torch
    import repro_torch.kernels as K
    from repro_torch.kernels import _build
    fn = _build.function("flash_attn", "repro_flash_attention")
    t0 = time.perf_counter()
    jfn = jitter_function()
    print(f"[jitter] built with -DREPRO_SYNC_JITTER in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ok = True
    for label, (B, S, T, H, KV, off, win, D) in STRESS_CASES:
        q, k, v = inputs(torch, B, S, T, H, KV, D, 3, "cuda")
        want = K.flash_attention_plain(q, k, v, window=win, q_offset=off)
        normal = None
        for tag, f in (("stress", fn), ("jitter", jfn)):
            first, n_diff, worst = None, 0, 0.0
            t0 = time.perf_counter()
            for _ in range(LAUNCHES // 25):   # 25 in flight, then check
                outs = [launch_raw(torch, f, q, k, v, off, win)
                        for _ in range(25)]
                torch.cuda.synchronize()
                if first is None:
                    first = outs[0]
                for o in outs:
                    if not torch.equal(o, first):
                        n_diff += 1
                        worst = max(worst, (o - first).abs().max().item())
            secs = time.perf_counter() - t0
            err = (first - want).abs().max().item()
            good = n_diff == 0 and err <= TOL
            extra = ""
            if normal is None:
                normal = first
            else:                     # the jitter build against the normal
                same = torch.equal(first, normal)
                good = good and same
                extra = (f"; {'equal' if same else 'NOT equal'} to the "
                         f"normal build's output")
            ok = ok and good
            us = per_launch_us(torch, f, q, k, v, off, win)
            print(f"[{tag}] {label}: {LAUNCHES} launches in {secs:.2f} s "
                  f"({us:.1f} us per launch by CUDA events), {n_diff} differ "
                  f"from the first bit for bit (max |diff| {worst:.3e}), "
                  f"first vs plain max|err| {err:.3e}{extra}: "
                  f"{'ok' if good else 'FAILED'}", flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "sync_check"),
                    help="directory for compute-sanitizer's logs")
    ap.add_argument("--target", nargs="+", type=int, metavar="D",
                    help="launch only the kernel at the small cases for "
                         "these head dims (what compute-sanitizer runs)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("check_flash_f32_sync: no CUDA device", file=sys.stderr)
        return 2
    if args.target:
        return target(args.target)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[env] {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    from repro_torch.kernels import _build
    _build.build_all(["flash_attn"])       # before any process launches it
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    state = sanitizer(out)
    stable = stress()
    print(f"[done] sanitizer {state}, stress and jitter "
          f"{'bit-equal' if stable else 'FAILED'}")
    if state == "reported" or not stable:
        return 1
    return 3 if state == "not run" else 0


if __name__ == "__main__":
    sys.exit(main())
