#!/usr/bin/env python3
"""Time the SSD scan's tensor-core scan against the recurrent pair it
replaced, in turns, on one card; or a probe of it, a copy of this tree's
source with clock64 stamps around each phase of a tile.

    python3 tools/ssd_scan_ab.py [--cases c1 c2 c32 s127]
    python3 tools/ssd_scan_ab.py --probe [--sass] [--cases ...]

Cases, bf16 at mamba2-2.7b's widths (80 heads of 64, state 128) with
``chip_smoke.py``'s inputs (the model's dt at init, A = -(1 ... 80)):

  c1    x (1, 383, 80, 64), chunk 1: the serve's prefill of 383
  c2    x (1, 258, 80, 64), chunk 2: its prefill of 258
  c32   x (1, 384, 80, 64), chunk 32
  s127  x (1, 127, 80, 64), chunk 1: its prefill of 127

Per case: y and the final state of the scan (``ssd_chunked`` on its
``tc_scan`` route) and of the recurrent pair (``ssd_scores_kernel``, then
``ssd_recurrent_kernel``, called directly) against ``ssd_chunked_plain``
(y 5e-2, the state 1e-4, each head's ||y - y_ref|| / ||y_ref|| below
1e-2); then, in turns pair, scan, scan, pair: CUDA-event medians with the
L2 flushed, the profiler's device time per call (L2 warm) and the host's
cost per call, by ``chip_smoke.py``'s own timers, with the bound and the
scan's share of it. ptxas's report for ``ssd_tc_scan_kernel`` comes
first, with its registers, spill bytes and CTAs an SM at each state size
(``kernels.ssd_chunk.tc_scan_info``).

``--probe`` builds a copy of this tree's ``csrc/`` into
``build/ssd_scan_ab/`` whose ``ssd_tc_scan_kernel`` adds, on thread 0 of
every CTA, clock64 cycles of each phase of a tile into a device array that
``repro_probe_cycles`` reads (and zeroes): the wait on a full stage (the
first tile's apart), batch A's issue (S and Y), the decay terms (warp 0,
while A runs), (u x)'s planes with batch B's issue (the state) and the
wait for A, the pair weights (while B runs), batch C (W_d . x and W_x .
x) with the wait for B and C, and y with h's planes. Its atomics slow the
kernel a little; its output is checked like the scan's. With ``--sass`` it also
prints, from the probe library's SASS (``cuobjdump -sass``) at N 128, the
instructions between consecutive clock reads: how many, and how many of
them are exponentials (MUFU), conversions (F2F, F2FP), branches (BRA),
shared-memory loads and stores and tensor-core products (HGMMA).
Prints the card's name and power limit; exits 1 when an output disagrees,
2 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# (B, S, nh, hd, N, chunk)
CASES = {"c1": (1, 383, 80, 64, 128, 1), "c2": (1, 258, 80, 64, 128, 2),
         "c32": (1, 384, 80, 64, 128, 32), "s127": (1, 127, 80, 64, 128, 1)}
OUT = ROOT / "build" / "ssd_scan_ab"

PROBE_HEAD = (
    "namespace scan {\n\n"
    "__device__ unsigned long long probe_cycles[16];\n"
    "__device__ void probe_add(int i, long long v) {\n"
    "  atomicAdd(&probe_cycles[i], (unsigned long long)v);\n}\n")
# (text of ssd_chunk.cu, its replacement): each text must be there once
PROBE = [
    ("namespace scan {\n", PROBE_HEAD),
    ("  for (int t = 0; t < n_tiles; ++t) {\n",
     "  const long long t_start = clock64();\n"
     "  for (int t = 0; t < n_tiles; ++t) {\n"
     "    const long long c0 = clock64();\n"),
    ("    const uint32_t xs = x_tile(st);\n"
     "    mbar_wait(full(st), (t / kStages) & 1);\n",
     "    const uint32_t xs = x_tile(st);\n"
     "    const long long c1 = clock64();\n"
     "    mbar_wait(full(st), (t / kStages) & 1);\n"
     "    const long long c2 = clock64();\n"),
    ("    if (tid == 0 && t + 1 < n_tiles) load(t + 1);\n"
     "    if (warp == 0) decay_terms(t);\n    __syncthreads();\n",
     "    const long long c3 = clock64();\n"
     "    if (tid == 0 && t + 1 < n_tiles) load(t + 1);\n"
     "    if (warp == 0) decay_terms(t);\n    __syncthreads();\n"
     "    const long long c4 = clock64();\n"),
    ("    repro::wgmma_wait<1>();   // batch A is done\n",
     "    repro::wgmma_wait<1>();   // batch A is done\n"
     "    const long long c5 = clock64();\n"),
    ("    // ---- batch C: y_intra",
     "    const long long c6 = clock64();\n"
     "    // ---- batch C: y_intra"),
    ("    repro::wgmma_wait_all();   // batches B and C\n",
     "    repro::wgmma_wait_all();   // batches B and C\n"
     "    const long long c7 = clock64();\n"),
    ("    // the planes are whole, and this tile's stage and scalars are free\n"
     "    __syncthreads();\n  }\n",
     "    // the planes are whole, and this tile's stage and scalars are free\n"
     "    __syncthreads();\n"
     "    if (tid == 0) {\n"
     "      const long long c8 = clock64();\n"
     "      probe_add(0, c1 - c0); probe_add(1, c2 - c1);\n"
     "      probe_add(2, c3 - c2); probe_add(3, c4 - c3);\n"
     "      probe_add(4, c5 - c4); probe_add(5, c6 - c5);\n"
     "      probe_add(6, c7 - c6); probe_add(7, c8 - c7);\n"
     "      probe_add(8, 1);\n"
     "      if (t == 0) { probe_add(9, c2 - c1); probe_add(10, 1); }\n"
     "    }\n  }\n"
     "  if (tid == 0) { probe_add(11, clock64() - t_start); "
     "probe_add(12, 1); }\n"),
    ("// The tensor-core scan: bfloat16 x, B and C",
     "extern \"C\" int repro_probe_cycles(unsigned long long* host) {\n"
     "  cudaError_t e = cudaMemcpyFromSymbol(host, scan::probe_cycles,\n"
     "                                       sizeof(unsigned long long) * 16);\n"
     "  if (e == cudaSuccess) {\n"
     "    unsigned long long zero[16] = {0};\n"
     "    e = cudaMemcpyToSymbol(scan::probe_cycles, zero, sizeof(zero));\n"
     "  }\n  return (int)e;\n}\n\n"
     "// The tensor-core scan: bfloat16 x, B and C"),
]
# (slot of the cycles, slot of its count, label)
PHASES = ((1, 8, "wait full (every tile)"), (9, 10, "wait full (first tile)"),
          (2, 8, "batch A issue (S, Y)"),
          (3, 8, "next load, decay terms (warp 0, batch A in flight)"),
          (4, 8, "(u x) planes, batch B issue (the state), wait for A"),
          (5, 8, "pair weights (batch B in flight)"),
          (6, 8, "batch C (W_d x, W_x x), wait for B and C"),
          (7, 8, "y, h's planes"), (0, 8, "tile start"),
          (11, 12, "a CTA, start to the end of its loop (per CTA)"))


def probe_lib() -> Path:
    """The probe's library, built from a substituted copy of csrc/."""
    from repro_torch.kernels import _build
    src_dir = OUT / "probe-csrc"
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(_build.CSRC, src_dir)
    text = (src_dir / "ssd_chunk.cu").read_text()
    for old, new in PROBE:
        if text.count(old) != 1:
            raise RuntimeError(f"probe: {old!r} is not in ssd_chunk.cu "
                               f"exactly once")
        text = text.replace(old, new)
    (src_dir / "ssd_chunk.cu").write_text(text)
    lib = OUT / "libssd_chunk_probe.so"
    out = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                          str(src_dir), "-o", str(lib),
                          str(src_dir / "ssd_chunk.cu")],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed for the probe:\n{out.stdout}"
                           f"{out.stderr}")
    return lib


def sass_phases(lib: Path):
    """Instruction counts between the clock reads of the probe's kernel at
    N 128, from its SASS."""
    import re
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or str(Path(_build.nvcc()).parent
                                            / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    for body in re.split(r"\n\s*Function : ", sass):
        if "ssd_tc_scan_kernel" not in body.split("\n", 1)[0] or \
                "Li128E" not in body.split("\n", 1)[0]:
            continue
        ins = [ln for ln in body.splitlines()
               if re.match(r"\s*/\*[0-9a-f]{4}\*/", ln)]
        clocks = [i for i, ln in enumerate(ins) if "SR_CLOCKLO" in ln]
        print(f"[sass] ssd_tc_scan_kernel<128>: {len(ins)} instructions, "
              f"clock reads at {clocks}")
        for a, b in zip(clocks, clocks[1:]):
            part = ins[a:b]
            n = lambda k: sum(k in ln for ln in part)
            print(f"[sass]   {a}-{b}: {b - a} instructions, MUFU {n('MUFU')}"
                  f", F2F {n('F2F')}, BRA {n('BRA')}, LDS {n('LDS')}, STS "
                  f"{n('STS')}, HGMMA {n('HGMMA')}")


def ptxas_lines(log: str):
    kernel, lines = "?", []
    for line in log.splitlines():
        if "Function properties for" in line:
            kernel = line.split(" for ", 1)[1].strip()
        elif "ssd_tc_scan_kernel" in kernel and ("registers" in line
                                                 or "spill" in line):
            lines.append(f"{kernel[-40:]}: {line.strip()}")
        if "serialized" in line:
            lines.append(line.strip())
    return lines


def inputs(torch, B, S, nh, hd, N):
    """``chip_smoke.kernel_ssd``'s inputs."""
    g = torch.Generator(device="cuda").manual_seed(4)
    F = torch.nn.functional
    x = torch.randn((B, S, nh, hd), generator=g, device="cuda").bfloat16()
    Bm = torch.randn((B, S, N), generator=g, device="cuda").bfloat16()
    Cm = torch.randn((B, S, N), generator=g, device="cuda").bfloat16()
    u = torch.rand((nh,), generator=g, device="cuda")
    dt0 = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    dt = F.softplus(torch.randn((B, S, nh), generator=g, device="cuda")
                    + torch.log(torch.expm1(dt0)))
    A = -torch.arange(1, nh + 1, dtype=torch.float32, device="cuda")
    return x, dt, A, Bm, Cm


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probe", action="store_true",
                    help="also run the phase probe's copy")
    ap.add_argument("--sass", action="store_true",
                    help="with --probe: the probe's SASS counts per phase")
    ap.add_argument("--cases", nargs="+", default=list(CASES),
                    choices=tuple(CASES))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssd_scan_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    import repro_torch.kernels as K
    from repro_torch.kernels import _build, ssd_chunk
    print(f"[env] {smoke.smi_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    logs = _build.build_all(["ssd_chunk"])
    print(f"[ptxas] {' | '.join(ptxas_lines(logs.get('ssd_chunk', '')))}",
          flush=True)
    for n in ssd_chunk.TC_STATES:
        print(f"[info] ssd_tc_scan_kernel<{n}>: {ssd_chunk.tc_scan_info(n)}",
              flush=True)
    probe = reader = None
    if args.probe:
        OUT.mkdir(parents=True, exist_ok=True)
        lib = probe_lib()
        if args.sass:
            sass_phases(lib)
        dll = ctypes.PyDLL(str(lib))
        probe = dll.repro_ssd_chunk_tc_scan
        probe.argtypes = _build.SIGNATURES["ssd_chunk"][
            "repro_ssd_chunk_tc_scan"]
        probe.restype = ctypes.c_int
        reader = dll.repro_probe_cycles
        reader.argtypes = [ctypes.c_void_p]
        reader.restype = ctypes.c_int
    bad = 0
    for name in args.cases:
        B, S, nh, hd, N, chunk = CASES[name]
        x, dt, A, Bm, Cm = inputs(torch, B, S, nh, hd, N)
        assert K.ssd_route(x.dtype, chunk, hd, N) == "tc_scan"
        fns = {"scan": lambda: K.ssd_chunked(x, dt, A, Bm, Cm, chunk),
               "pair": lambda: ssd_chunk._launch_recurrent(x, dt, A, Bm, Cm,
                                                           chunk)}
        if probe is not None:
            def probed():
                y = torch.empty_like(x)
                st = torch.empty((B, nh, hd, N), dtype=torch.float32,
                                 device="cuda")
                err = probe(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                            Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                            st.data_ptr(), B, S, nh, hd, N, chunk,
                            torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"CUDA error {err} at launch")
                return y, st
            fns["probe"] = probed
        y_ref, st_ref = K.ssd_chunked_plain(x, dt, A, Bm, Cm, chunk)
        what = f"bf16 x{tuple(x.shape)} N {N} chunk {chunk}"
        for tag, fn in fns.items():
            y, st = fn()
            torch.cuda.synchronize()
            yf, rf = y.float(), y_ref.float()
            ok = (torch.allclose(yf, rf, rtol=5e-2, atol=5e-2)
                  and torch.allclose(st, st_ref, rtol=1e-4, atol=1e-4))
            rel = ((yf - rf).square().sum(dim=(0, 1, 3)).sqrt()
                   / rf.square().sum(dim=(0, 1, 3)).sqrt()).max().item()
            ok = ok and rel < 1e-2
            bad += not ok
            print(f"[ab] {name} {what}: {tag} max|err| y "
                  f"{(yf - rf).abs().max().item():.3e}, state "
                  f"{(st - st_ref).abs().max().item():.3e}, worst head "
                  f"{rel:.3e}{'' if ok else '  DISAGREES'}", flush=True)
        if reader is not None:
            buf = (ctypes.c_ulonglong * 16)()
            reader(ctypes.addressof(buf))
            fns["probe"]()
            torch.cuda.synchronize()
            if reader(ctypes.addressof(buf)):
                raise RuntimeError("repro_probe_cycles failed")
            print(f"[probe] {name}: {buf[8]} tiles over {buf[12]} CTAs; "
                  f"cycles per tile (thread 0 of each CTA): " + ", ".join(
                      f"{label} {buf[i] / max(buf[n], 1):.0f}"
                      for i, n, label in PHASES), flush=True)
        order = ("pair", "scan", "scan", "pair")
        res = {tag: {"events": [], "device": [], "host": []} for tag in fns}
        for tag in order:
            r = res[tag]
            r["events"].append(smoke.cuda_ms(torch, fns[tag]))
            dev, _, missing = smoke.device_ms(
                torch, fns[tag], f"{tag} {what}",
                symbols=smoke.SSD_ROUTE_SYMBOLS[
                    "tc_scan" if tag == "scan" else "recurrent"])
            r["device"].append(dev)
            r["host"].append(smoke.host_us(torch, fns[tag]))
        nbytes = ((2 * x.numel() + 2 * B * S * N) * x.element_size()
                  + 4 * (B * S * nh + nh) + 4 * B * nh * hd * N)
        nc, tri = S // chunk, chunk * (chunk + 1) // 2
        flops = B * (2 * nc * tri * N + 2 * nc * nh * tri * hd
                     + 2 * S * nh * hd * N + 2 * nc * nh * hd * N
                     + 2 * (nc - 1) * chunk * nh * hd * N)
        b_ms, b_by = smoke.bound(nbytes, flops, "bfloat16")
        fmt = lambda xs, f: ", ".join("not measured" if v is None else f(v)
                                      for v in xs)
        for tag in ("scan", "pair"):
            r = res[tag]
            devs = [v for v in r["device"] if v is not None]
            mean = sum(devs) / len(devs) if devs else None
            share = ("not measured" if mean is None
                     else f"{100 * b_ms / mean:.1f}%")
            print(f"[time] {name} {what}: {tag} device "
                  f"{fmt(r['device'], lambda v: f'{v:.4f}')} ms, events "
                  f"{fmt(r['events'], lambda v: f'{v:.4f}')} ms, host "
                  f"{fmt(r['host'], lambda v: f'{v:.1f}')} us; bound "
                  f"{b_ms * 1e3:.2f} us ({b_by}), device at {share} of it",
                  flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
