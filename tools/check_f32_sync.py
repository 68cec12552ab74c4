#!/usr/bin/env python3
"""Check the synchronization of the float32 split-TF32 kernels, and of the
bf16 flash kernel's ring, on one card.

    python3 tools/check_f32_sync.py [flash] [ssd] [--out DIR] [--no-sanitizer]

Each target is a kernel in which a producer warpgroup hands float32 tiles,
split into TF32 hi and lo planes, to consumer warpgroups through a ring of
mbarriers and a staging tile guarded by a named barrier:

  flash  ``flash_tf32x3_kernel`` (``csrc/flash_attn.cu``, C entry
         ``repro_flash_attention``): K/V tiles to two consumer warpgroups;
         (the flash target's stress also runs the bf16
         ``flash_tc_kernel``, whose producer warp fills a ring of TMA
         stages for consumers that may skip a tile's products);
         at D 256 ``flash_tf32x3_d256_kernel``, whose producer splits K
         and V from registers into one stage of planes with a full and an
         empty barrier each, for one consumer warpgroup.
  ssd    the SSD scan's split-TF32 route (``csrc/ssd_chunk.cu``, C entry
         ``repro_ssd_chunk_tf32``): ``ssd_scores_tf32_kernel``, then
         ``ssd_intra_tf32_kernel``, whose producer hands each head's x_j^T
         planes to one consumer warpgroup per head, then the state pass.

Both by default. Per target, in order, one line per case:

  sanitizer  compute-sanitizer's racecheck, synccheck and memcheck, each on
             this script re-run with ``--target NAME``, which launches only
             the target's C entry at small shapes (inputs made and the plain
             version run on the host). flash: D 64, 128 and 256, T no
             multiple of the key tile, one to five key tiles per q-tile, a
             query offset, a window and GQA; at D 256 also MQA (8 / 1).
             ssd: one, two and four j-tiles, N
             32, 64 and 128, B 2, and heads that leave a two-head CTA's
             second warpgroup idle. The full logs go to DIR.
  stress     200 launches per case, each into new output buffers: every
             output must equal the first bit for bit, and the first must
             agree with the plain version (flash within 2e-5, ssd within
             1e-4 on y and on the final state). flash: llama3.2-1b's
             largest prefill bucket (q (4, 512, 32, 64), kv (4, 512, 8,
             64), causal), S 383 with q_offset 1 at D 64 and 128, D 32 with
             a window, recurrentgemma-9b's (q (4, 512, 16, 256), kv (4,
             512, 1, 256), window 2048) and the same at S 383 with q_offset
             1, and the bf16 kernel (``flash_tc_kernel``, within 2e-2) at
             minicpm3-4b's MLA prefill (q, k (4, 512, 40, 96), v 64 wide)
             and mistral-nemo-12b's heads (D 128, 32 / 8), each also at S
             383 with q_offset 1. ssd: mamba2-2.7b's float32 chunks (x (1, 256, 80,
             64) chunk 256, (1, 384, 80, 64) chunk 128, (1, 64, 80, 64)
             chunk 64; N 128), each with the heads per CTA the wrapper picks
             and with the other count. Each line gives microseconds per
             launch by CUDA events over 50 launches in a row.
  jitter     the same stress on a build with ``-DREPRO_SYNC_JITTER`` (into
             ``build/repro_torch_jitter/``), whose warps sleep
             pseudo-random times at every hand-over: its outputs must also
             equal the normal build's first output bit for bit.

``--no-sanitizer`` runs the stress and jitter checks alone (what a mutant
copy of a source is checked with). Prints the card's name and power limit
first. Exits 1 when a check fails or compute-sanitizer reports an error or
a hazard, 3 when the stresses pass but compute-sanitizer could not run a
target (it refuses some virtualized cards: "Device not supported"), 2
without a CUDA device, else 0 (also with ``--no-sanitizer``).
"""
from __future__ import annotations

import argparse
import ctypes
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

LAUNCHES = 200


class Case(NamedTuple):
    label: str
    launch: Callable     # (C entry) -> tuple of the outputs on the card
    error: Callable      # (outputs) -> max |err| against the plain version
    tol: float = 0.0     # its own tolerance (0: the target's)


class Target(NamedTuple):
    source: str          # csrc/<source>.cu
    entry: str           # its C entry
    tol: float
    small: Callable      # (torch) -> [Case]: what the sanitizer runs
    stress: Callable     # (torch) -> [Case]


def _stream(torch):
    return torch.cuda.current_stream().cuda_stream


# --- flash ------------------------------------------------------------------

def flash_case(torch, label, B, S, T, H, KV, off, win, D, seed, ref_device,
               Dv=None, bf16=False):
    """Inputs of a launch at q/k width D and v width Dv (D by default), in
    float32 or, with ``bf16``, rounded to bfloat16 (the bf16
    ``flash_tc_kernel``, held to 2e-2)."""
    import repro_torch.kernels as K
    Dv = Dv or D
    dtype = torch.bfloat16 if bf16 else torch.float32
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g).to(ref_device).to(dtype)
               for shape in ((B, S, H, D), (B, T, KV, D), (B, T, KV, Dv)))
    want = K.flash_attention_plain(q, k, v, window=win,
                                   q_offset=off).float()
    q, k, v = (t.cuda() for t in (q, k, v))
    width = K.flash_attn.kernel_width(D, Dv)

    def launch(fn):
        o = q.new_empty((B, S, H, Dv))
        # the scores' scale 1 / sqrt(Dqk)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B,
                 S, T, H, KV, width, D, Dv, off, -1 if win is None else win,
                 D ** -0.5, int(bf16), _stream(torch))
        if err:
            raise RuntimeError(f"flash_attention: CUDA error {err} at launch")
        return (o,)

    return Case(label, launch,
                lambda outs: (outs[0].to(ref_device).float()
                              - want).abs().max().item(),
                2e-2 if bf16 else 0.0)


def flash_small(torch):
    # (B, S, T, H, KV, q_offset, window): key tiles per q-tile at D 64 (64
    # keys, 128-row q-tiles), D 128 and D 256 (32 keys, 64-row q-tiles)
    shapes = ((1, 150, 150, 2, 1, 0, None),   # D 64: 2, 3; else 2, 4, 5
              (1, 20, 23, 2, 1, 3, None),     # one partial key tile
              (2, 100, 161, 4, 2, 61, 50))    # q_offset, window, GQA 2
    mqa = ((1, 96, 100, 8, 1, 4, 40),)        # D 256: 3 and 4, MQA
    return [flash_case(torch, f"D {D} B {B} S {S} T {T} H {H} KV {KV} "
                              f"q_offset {off} window {win}",
                       B, S, T, H, KV, off, win, D, 10 + i, "cpu")
            for D in (64, 128, 256)
            for i, (B, S, T, H, KV, off, win) in enumerate(
                shapes + (mqa if D == 256 else ()))]


def flash_stress(torch):
    return [flash_case(torch, label, *shape, 3, "cuda")
            for label, shape in (
                ("S 512", (4, 512, 512, 32, 8, 0, None, 64)),
                ("S 383, q_offset 1", (4, 383, 384, 32, 8, 1, None, 64)),
                ("D 128, S 383, q_offset 1",
                 (4, 383, 384, 32, 8, 1, None, 128)),
                ("D 32, S 300, window 100",
                 (2, 300, 300, 8, 2, 0, 100, 32)),
                ("D 256, MQA 16 / 1, S 512, window 2048",
                 (4, 512, 512, 16, 1, 0, 2048, 256)),
                ("D 256, MQA 16 / 1, S 383, q_offset 1, window 2048",
                 (4, 383, 384, 16, 1, 1, 2048, 256)))] + [
        # the bf16 kernel (no split planes; K/V by TMA through its mbarrier
        # ring) at minicpm3-4b's MLA prefill and mistral-nemo-12b's heads
        flash_case(torch, label, *shape, 3, "cuda", Dv=Dv, bf16=True)
        for label, shape, Dv in (
            ("bf16 MLA 96 / 64, S 512", (4, 512, 512, 40, 40, 0, None, 96),
             64),
            ("bf16 MLA 96 / 64, S 383, q_offset 1",
             (4, 383, 384, 40, 40, 1, None, 96), 64),
            ("bf16 D 128, G 4, S 512", (4, 512, 512, 32, 8, 0, None, 128),
             None),
            ("bf16 D 128, G 4, S 383, q_offset 1",
             (4, 383, 384, 32, 8, 1, None, 128), None))]


# --- ssd --------------------------------------------------------------------

def ssd_case(torch, label, B, S, nh, N, chunk, group, seed, ref_device):
    """The smoke's inputs (chip_smoke.kernel_ssd): the model's dt at init,
    A = -(1 ... nh). The outputs are (y_intra, the states entering each
    chunk, exp(cum), the final state); y adds the wrapper's eager y_inter."""
    import repro_torch.kernels as K
    from repro_torch.kernels.ssd_chunk import _y_inter
    hd = 64
    g = torch.Generator().manual_seed(seed)
    F = torch.nn.functional
    x = torch.randn((B, S, nh, hd), generator=g)
    Bm = torch.randn((B, S, N), generator=g)
    Cm = torch.randn((B, S, N), generator=g)
    u = torch.rand((nh,), generator=g)
    dt0 = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    dt = F.softplus(torch.randn((B, S, nh), generator=g)
                    + torch.log(torch.expm1(dt0)))
    A = -torch.arange(1, nh + 1, dtype=torch.float32)
    inp = [t.to(ref_device) for t in (x, dt, A, Bm, Cm)]
    y_ref, st_ref = K.ssd_chunked_plain(*inp, chunk)
    dev = [t.cuda() for t in inp]
    nc = S // chunk

    def launch(fn):
        f32 = dict(dtype=torch.float32, device="cuda")
        scores = torch.empty((B, nc, chunk, chunk), **f32)
        y = torch.empty_like(dev[0])
        states = torch.empty((B, nc, nh, hd, N), **f32)
        cum_exp = torch.empty((B, S, nh), **f32)
        decay = torch.empty((B, nc, nh), **f32)
        final = torch.empty((B, nh, hd, N), **f32)
        err = fn(*(t.data_ptr() for t in dev), scores.data_ptr(),
                 y.data_ptr(), states.data_ptr(), cum_exp.data_ptr(),
                 decay.data_ptr(), final.data_ptr(), B, S, nh, hd, N, chunk,
                 group, _stream(torch))
        if err:
            raise RuntimeError(f"ssd tf32: CUDA error {err} at launch")
        return y, states, cum_exp, final

    def error(outs):
        y, states, cum_exp, final = (o.to(ref_device) for o in outs)
        if nc > 1:
            y = y + _y_inter(inp[4], cum_exp, states, chunk, y.dtype)
        return max((y - y_ref).abs().max().item(),
                   (final - st_ref).abs().max().item())

    return Case(label, launch, error)


def ssd_small(torch):
    # (B, S, nh, N, chunk, heads per CTA): j-tiles per chunk 1, 2 and 4
    shapes = ((2, 128, 3, 128, 64, 2),     # nh 3: the second CTA's consumer
              (1, 256, 2, 32, 128, 1),     # warpgroup idle
              (2, 256, 3, 64, 256, 2))
    return [ssd_case(torch, f"B {B} S {S} nh {nh} N {N} chunk {c} heads per "
                            f"CTA {G}", B, S, nh, N, c, G, 10 + i, "cpu")
            for i, (B, S, nh, N, c, G) in enumerate(shapes)]


def ssd_stress(torch):
    from repro_torch.kernels.ssd_chunk import ssd_tc_heads
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    cases = []
    for S, chunk in ((256, 256), (384, 128), (64, 64)):
        picked = ssd_tc_heads(1, S, 80, chunk, n_sm)
        for G in (picked, 3 - picked):
            label = (f"chunk {chunk}, x (1, {S}, 80, 64), {G} head(s) per CTA"
                     + (" (the wrapper picks it)" if G == picked else ""))
            cases.append(ssd_case(torch, label, 1, S, 80, 128, chunk, G, 4,
                                  "cuda"))
    return cases


TARGETS = {
    "flash": Target("flash_attn", "repro_flash_attention", 2e-5,
                    flash_small, flash_stress),
    "ssd": Target("ssd_chunk", "repro_ssd_chunk_tf32", 1e-4,
                  ssd_small, ssd_stress),
}


# --- the checks -------------------------------------------------------------

def run_small(name: str) -> int:
    """Launch the target's C entry alone at its small cases; compare with the
    plain version run on the host."""
    import torch
    from repro_torch.kernels import _build
    t = TARGETS[name]
    fn = _build.function(t.source, t.entry)
    worst = 0.0
    for case in t.small(torch):
        outs = case.launch(fn)
        torch.cuda.synchronize()
        err = case.error(outs)
        worst = max(worst, err)
        print(f"[target] {name} {case.label}: max|err| {err:.3e}", flush=True)
    return 0 if worst <= t.tol else 1


def sanitizer(name: str, out: Path) -> str:
    """racecheck, synccheck and memcheck on ``--target name``: "clean" when
    all ran and reported nothing, "not run" when one could not run the
    target (a device the sanitizer does not support), else "reported"."""
    import torch
    from repro_torch.kernels import _build
    tool = shutil.which("compute-sanitizer") or str(
        Path(_build.nvcc()).parent / "compute-sanitizer")
    n_small = len(TARGETS[name].small(torch))
    states = []
    for check in ("racecheck", "synccheck", "memcheck"):
        log = out / f"{name}_sanitizer_{check}.log"
        cmd = [tool, "--tool", check, "--print-limit", "50", sys.executable,
               str(Path(__file__).resolve()), "--target", name]
        if check == "racecheck":
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
        ran = bool(errors) and targets == n_small
        clean = ran and rc == 0 and not any(errors) and not re.search(
            r"RACECHECK SUMMARY: [1-9]", text)
        states.append("clean" if clean else "reported" if ran else "not run")
        why = [ln.strip(" =") for ln in text.splitlines() if "Error:" in ln]
        print(f"[sanitizer] {name} {check}: exit {rc}, {secs:.1f} s, "
              f"{targets} of {n_small} target lines, "
              + {"clean": "clean", "reported": "REPORTED",
                 "not run": "DID NOT RUN"}[states[-1]]
              + f" | {' | '.join(why[:1] + summary[-2:])}", flush=True)
    return ("reported" if "reported" in states else
            "not run" if "not run" in states else "clean")


def jitter_function(t: Target):
    """The C entry of a build of ``csrc/<source>.cu`` with REPRO_SYNC_JITTER,
    in build/repro_torch_jitter/."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR.parent / "repro_torch_jitter"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"lib{t.source}.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-DREPRO_SYNC_JITTER",
                    "-I", str(_build.CSRC), "-o", str(lib),
                    str(_build.CSRC / f"{t.source}.cu")], check=True,
                   capture_output=True, text=True)
    fn = getattr(ctypes.PyDLL(str(lib)), t.entry)
    fn.argtypes = _build.SIGNATURES[t.source][t.entry]
    fn.restype = ctypes.c_int
    return fn


def per_launch_us(torch, launch, n=50) -> float:
    """Microseconds per launch over CUDA events around ``n`` launches in a
    row."""
    launch()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        launch()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) * 1e3 / n


def stress(name: str) -> bool:
    """LAUNCHES launches per case on the normal and the jitter build: all
    bit-equal to the first, the first within the tolerance, the jitter
    build's equal to the normal build's."""
    import torch
    from repro_torch.kernels import _build
    t = TARGETS[name]
    fn = _build.function(t.source, t.entry)
    t0 = time.perf_counter()
    jfn = jitter_function(t)
    print(f"[jitter] {name}: built with -DREPRO_SYNC_JITTER in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ok = True
    for case in t.stress(torch):
        normal = None
        for tag, f in (("stress", fn), ("jitter", jfn)):
            first, n_diff, worst = None, 0, 0.0
            t0 = time.perf_counter()
            for _ in range(LAUNCHES // 25):   # 25 in flight, then check
                outs = [case.launch(f) for _ in range(25)]
                torch.cuda.synchronize()
                if first is None:
                    first = outs[0]
                for o in outs:
                    if not all(map(torch.equal, o, first)):
                        n_diff += 1
                        worst = max(worst, max((a - b).abs().max().item()
                                               for a, b in zip(o, first)))
                del outs
            secs = time.perf_counter() - t0
            err = case.error(first)
            good = n_diff == 0 and err <= (case.tol or t.tol)
            extra = ""
            if normal is None:
                normal = first
            else:                     # the jitter build against the normal
                same = all(map(torch.equal, first, normal))
                good = good and same
                extra = (f"; {'equal' if same else 'NOT equal'} to the "
                         f"normal build's output")
            ok = ok and good
            us = per_launch_us(torch, lambda: case.launch(f))
            print(f"[{tag}] {name} {case.label}: {LAUNCHES} launches in "
                  f"{secs:.2f} s ({us:.1f} us per launch by CUDA events), "
                  f"{n_diff} differ from the first bit for bit (max |diff| "
                  f"{worst:.3e}), first vs plain max|err| {err:.3e}{extra}: "
                  f"{'ok' if good else 'FAILED'}", flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("targets", nargs="*", metavar="TARGET",
                    help=f"what to check, of {', '.join(TARGETS)} (default: "
                         f"all)")
    ap.add_argument("--out", default=str(ROOT / "build" / "sync_check"),
                    help="directory for compute-sanitizer's logs")
    ap.add_argument("--no-sanitizer", action="store_true",
                    help="run the stress and jitter checks alone")
    ap.add_argument("--target", choices=tuple(TARGETS),
                    help="launch only this target at its small cases (what "
                         "compute-sanitizer runs)")
    args = ap.parse_args()
    if set(args.targets) - set(TARGETS):
        ap.error(f"targets are {', '.join(TARGETS)}")
    import torch
    if not torch.cuda.is_available():
        print("check_f32_sync: no CUDA device", file=sys.stderr)
        return 2
    if args.target:
        return run_small(args.target)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[env] {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    names = args.targets or list(TARGETS)
    from repro_torch.kernels import _build
    # built before any process launches them
    _build.build_all([TARGETS[n].source for n in names])
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    states, stable = [], True
    for name in names:
        if not args.no_sanitizer:
            states.append(sanitizer(name, out))
        stable = stress(name) and stable
    state = ("skipped" if args.no_sanitizer else
             "reported" if "reported" in states else
             "not run" if "not run" in states else "clean")
    print(f"[done] {', '.join(names)}: sanitizer {state}, stress and jitter "
          f"{'bit-equal' if stable else 'FAILED'}")
    if state == "reported" or not stable:
        return 1
    return 3 if state == "not run" else 0


if __name__ == "__main__":
    sys.exit(main())
