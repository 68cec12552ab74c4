#!/usr/bin/env python3
"""Time ragged decode's tensor-core kernel against the CUDA-core kernel at
recurrentgemma-9b's heads, in turns, on one card; or a probe of it, a copy
of this tree's source with clock64 stamps around each phase of a tile.

    python3 tools/decode_ab.py [--cases serve legacy3 legacy7 long]
    python3 tools/decode_ab.py --probe [--sass] [--cases ...]

Cases, bf16, 16 query heads over one kv head of 256 (G 16, D 256), with
``chip_smoke.py``'s inputs (``kernel_decode``):

  serve    q (8, 16, 256) over a slot arena (512, 1024, 1, 256), the
           smoke's first decode case (lengths 1 ... 1024, one padding row)
  legacy3  q (3, 16, 256) over a (3, 256, 1, 256) stack, no slots (the
           legacy engine's decode), lengths 1, 256, 133
  legacy7  the same at B 7
  long     q (128, 16, 256) over (128, 2048, 1, 256), every row 2048 long
           (decode_32k's rings of the local window)

Per case: the output of the tensor-core kernel (``ragged_decode_attention``
on its ``tc`` route) and of the CUDA-core kernel
(``ragged_decode_split_kernel``, called through its C entry on the same
inputs) against ``ragged_decode_attention_plain`` (2e-2); then, in turns
cores, tc, tc, cores: CUDA-event medians with the L2 flushed, the
profiler's device time per call (L2 warm) and the host's cost per call, by
``chip_smoke.py``'s own timers; the plain version's and SDPA's (the
smoke's yardstick over the gathered, head-repeated rows) device time; the
bound and each kernel's share of it. ptxas's report for
``ragged_decode_tc_kernel`` comes first, with its registers, spill bytes,
CTAs an SM, shared memory and clusters of 8 held at once at each head dim
(``kernels.ragged_decode_attn.tc_info``).

``--probe`` builds a copy of this tree's ``csrc/`` into
``build/decode_ab/`` whose ``ragged_decode_tc_kernel`` adds, on thread 0
of every CTA, clock64 cycles of each phase into a device array that
``repro_probe_cycles`` reads (and zeroes): per tile the wait for its loads
(the first tile's apart), the next tile's issue, S on the tensor cores,
the barrier after S, the softmax and P·V; per CTA the prologue (Q and the
first issues), the loop, (m, l, O) into shared memory, the first cluster
barrier, the merge over the cluster and the second cluster barrier. Its atomics slow the kernel a little; its output
is checked like the kernel's. With ``--sass`` it also prints, from the
probe library's SASS at D 256, the instructions between consecutive clock
reads: how many, and how many are exponentials (MUFU), tensor-core
products (HMMA), shared-memory matrix loads (LDSM), async copies (LDGSTS)
and branches (BRA).
Prints the card's name and power limit; exits 1 when an output disagrees,
2 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

OUT = ROOT / "build" / "decode_ab"
CASES = ("serve", "legacy3", "legacy7", "long")
TC_SYMBOLS = ("ragged_decode_tc_kernel",)
CORE_SYMBOLS = ("ragged_decode_split_kernel",)

PROBE_HEAD = (
    "namespace tc {\n\n"
    "__device__ unsigned long long probe_cycles[24];\n"
    "__device__ void probe_add(int i, long long v) {\n"
    "  atomicAdd(&probe_cycles[i], (unsigned long long)v);\n}\n")
# (text of ragged_decode_attn.cu, its replacement): each text must be there
# once
PROBE = [
    ("namespace tc {\n", PROBE_HEAD),
    ("  using C = Cfg<D>;\n  constexpr int TR = C::TR, CPR = C::CPR;\n",
     "  using C = Cfg<D>;\n  constexpr int TR = C::TR, CPR = C::CPR;\n"
     "  const long long k0 = clock64();\n"),
    ("  for (int j = 0; j < n_tiles; ++j) {\n"
     "    cp_async_wait<kStages - 2>();\n",
     "  const long long k1 = clock64();\n"
     "  for (int j = 0; j < n_tiles; ++j) {\n"
     "    const long long c0 = clock64();\n"
     "    cp_async_wait<kStages - 2>();\n"),
    ("    issue(j + kStages - 1);\n    int t0, nrows;\n",
     "    const long long c1 = clock64();\n"
     "    issue(j + kStages - 1);\n"
     "    const long long c2 = clock64();\n    int t0, nrows;\n"),
    ("                      ok1 ? sc[0][3] * scale_log2 : -INFINITY);\n"
     "    }\n    __syncthreads();\n",
     "                      ok1 ? sc[0][3] * scale_log2 : -INFINITY);\n"
     "    }\n    const long long c3 = clock64();\n    __syncthreads();\n"
     "    const long long c4 = clock64();\n"),
    ("    // 3. O += P . V over this warp's D / 4 columns, P as hi + lo\n",
     "    const long long c5 = clock64();\n"
     "    // 3. O += P . V over this warp's D / 4 columns, P as hi + lo\n"),
    ("        mma(acc[0], pl, bf[0], bf[1]);\n      }\n    }\n  }\n",
     "        mma(acc[0], pl, bf[0], bf[1]);\n      }\n    }\n"
     "    if (tid == 0) {\n"
     "      const long long c6 = clock64();\n"
     "      probe_add(0, c1 - c0); probe_add(1, c2 - c1);\n"
     "      probe_add(2, c3 - c2); probe_add(3, c4 - c3);\n"
     "      probe_add(4, c5 - c4); probe_add(5, c6 - c5);\n"
     "      probe_add(6, 1);\n"
     "      if (j == 0) { probe_add(7, c1 - c0); probe_add(8, 1); }\n"
     "    }\n  }\n"
     "  const long long k2 = clock64();\n"),
    ("  cluster_sync();   // every CTA of the group has left its (m, l, O)\n",
     "  const long long k3 = clock64();\n"
     "  cluster_sync();   // every CTA of the group has left its (m, l, O)\n"
     "  const long long k4 = clock64();\n"),
    ("  cluster_sync();   // no CTA leaves while a peer still reads its memory\n",
     "  const long long k6 = clock64();\n"
     "  cluster_sync();   // no CTA leaves while a peer still reads its memory\n"
     "  if (tid == 0) {\n"
     "    const long long k7 = clock64();\n"
     "    probe_add(9, k1 - k0); probe_add(10, k2 - k1);\n"
     "    probe_add(11, k3 - k2); probe_add(12, k4 - k3);\n"
     "    probe_add(13, k6 - k4); probe_add(14, k7 - k6);\n"
     "    probe_add(18, k7 - k0);\n"
     "    probe_add(16, 1); probe_add(17, n_tiles);\n  }\n"),
    ("// bf16 q (B, H, D), k, v (N, T, KV, D), lengths and slots (B,) int32, out\n",
     "extern \"C\" int repro_probe_cycles(unsigned long long* host) {\n"
     "  cudaError_t e = cudaMemcpyFromSymbol(host, tc::probe_cycles,\n"
     "                                       sizeof(unsigned long long) * 24);\n"
     "  if (e == cudaSuccess) {\n"
     "    unsigned long long zero[24] = {0};\n"
     "    e = cudaMemcpyToSymbol(tc::probe_cycles, zero, sizeof(zero));\n"
     "  }\n  return (int)e;\n}\n\n"
     "// bf16 q (B, H, D), k, v (N, T, KV, D), lengths and slots (B,) int32, out\n"),
]
# (slot of the cycles, slot of its count, label)
PHASES = ((0, 6, "wait for the tile's loads (every tile)"),
          (7, 8, "wait for the tile's loads (first tile)"),
          (1, 6, "issue the next tile"), (2, 6, "S on the tensor cores"),
          (3, 6, "barrier after S"), (4, 6, "softmax"),
          (5, 6, "P.V on the tensor cores"),
          (9, 16, "CTA prologue (Q, first issues) (per CTA)"),
          (10, 16, "CTA loop over its tiles (per CTA)"),
          (11, 16, "O, m, l into shared memory (per CTA)"),
          (12, 16, "first cluster barrier (per CTA)"),
          (13, 16, "the merge over the cluster (per CTA)"),
          (14, 16, "second cluster barrier (per CTA)"),
          (18, 16, "whole CTA (per CTA)"))


def probe_lib() -> Path:
    """The probe's library, built from a substituted copy of csrc/."""
    from repro_torch.kernels import _build
    src_dir = OUT / "probe-csrc"
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(_build.CSRC, src_dir)
    path = src_dir / "ragged_decode_attn.cu"
    text = path.read_text()
    for old, new in PROBE:
        if text.count(old) != 1:
            raise RuntimeError(f"probe: {old!r} is not in "
                               f"ragged_decode_attn.cu exactly once")
        text = text.replace(old, new)
    path.write_text(text)
    lib = OUT / "libragged_decode_attn_probe.so"
    out = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                          str(src_dir), "-o", str(lib), str(path)],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed for the probe:\n{out.stdout}"
                           f"{out.stderr}")
    for line in ptxas_lines(out.stdout + out.stderr):
        print(f"[ptxas] probe {line}", flush=True)
    return lib


def sass_phases(lib: Path):
    """Instruction counts between the clock reads of the probe's kernel at
    D 256, from its SASS."""
    import re
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or str(Path(_build.nvcc()).parent
                                            / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    for body in re.split(r"\n\s*Function : ", sass):
        head = body.split("\n", 1)[0]
        if "ragged_decode_tc_kernel" not in head or "Li256E" not in head:
            continue
        ins = [ln for ln in body.splitlines()
               if re.match(r"\s*/\*[0-9a-f]{4}\*/", ln)]
        clocks = [i for i, ln in enumerate(ins) if "SR_CLOCKLO" in ln]
        print(f"[sass] ragged_decode_tc_kernel<256>: {len(ins)} "
              f"instructions, clock reads at {clocks}")
        for a, b in zip(clocks, clocks[1:]):
            part = ins[a:b]
            n = lambda k: sum(k in ln for ln in part)
            print(f"[sass]   {a}-{b}: {b - a} instructions, MUFU {n('MUFU')}"
                  f", HMMA {n('HMMA')}, LDSM {n('LDSM')}, LDGSTS "
                  f"{n('LDGSTS')}, BRA {n('BRA')}")


def ptxas_lines(log: str):
    kernel, lines = "?", []
    for line in log.splitlines():
        if "Function properties for" in line:
            kernel = line.split(" for ", 1)[1].strip()
        elif "ragged_decode_tc_kernel" in kernel and ("registers" in line
                                                      or "spill" in line):
            lines.append(f"{kernel[-60:]}: {line.strip()}")
    return lines


def case(torch, K, smoke, name):
    """``chip_smoke.kernel_decode``'s case ``name``."""
    bf16 = torch.bfloat16
    if name == "serve":
        lens, slots, ctx = smoke.DECODE_CASES[0]
        return smoke.kernel_decode(torch, K, bf16, lens, slots, ctx, H=16,
                                   KV=1, D=256)
    if name == "long":
        return smoke.kernel_decode(torch, K, bf16, smoke.LONG_LENS, None,
                                   None, H=16, KV=1, D=256,
                                   T=smoke.LONG_LENS[0])
    lens = smoke.SLOTLESS_LENS[0 if name == "legacy3" else 1]
    return smoke.kernel_decode(torch, K, bf16, lens, None, None, H=16, KV=1,
                               D=256, T=256)


def clustered(torch, RD, _build, inputs, n):
    """The tensor-core kernel through its C entry at clusters of up to
    ``n`` CTAs, one span of whole 32-row tiles a CTA."""
    q, k, v, lengths, slots, ctx = inputs
    B, H, D = q.shape
    N, T, KV = k.shape[:3]
    span = T if ctx is None else min(ctx, T)
    split_t = -(-(-(-span // n)) // 32) * 32
    n_split = -(-span // split_t)
    fn = _build.function("ragged_decode_attn", "repro_ragged_decode_tc")

    def call():
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                 slots.data_ptr(), out.data_ptr(), B, H, KV, D, N, T, span,
                 n_split, split_t, min(n, n_split),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err} at launch (clusters of "
                               f"{min(n, n_split)})")
        return out
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probe", action="store_true",
                    help="also run the phase probe's copy")
    ap.add_argument("--sass", action="store_true",
                    help="with --probe: the probe's SASS counts per phase")
    ap.add_argument("--cases", nargs="+", default=list(CASES),
                    choices=CASES)
    ap.add_argument("--cluster", type=int, nargs="*", default=(),
                    help="also time the tensor-core kernel at clusters of "
                         "these many CTAs (up to 8), one span a CTA")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    import repro_torch.kernels as K
    from repro_torch.kernels import _build, ragged_decode_attn as RD
    print(f"[env] {smoke.smi_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    logs = _build.build_all(["ragged_decode_attn"])
    for line in ptxas_lines(logs.get("ragged_decode_attn", "")):
        print(f"[ptxas] {line}", flush=True)
    for D in RD.HEAD_DIMS:
        print(f"[info] ragged_decode_tc_kernel<{D}>: {RD.tc_info(D)}",
              flush=True)
    probe = reader = None
    if args.probe:
        OUT.mkdir(parents=True, exist_ok=True)
        lib = probe_lib()
        if args.sass:
            sass_phases(lib)
        dll = ctypes.PyDLL(str(lib))
        probe = dll.repro_ragged_decode_tc
        probe.argtypes = _build.SIGNATURES["ragged_decode_attn"][
            "repro_ragged_decode_tc"]
        probe.restype = ctypes.c_int
        reader = dll.repro_probe_cycles
        reader.argtypes = [ctypes.c_void_p]
        reader.restype = ctypes.c_int
    bad = 0
    for name in args.cases:
        r = case(torch, K, smoke, name)
        kernel_fn, plain_fn, lib_fn = r["fns"]
        cores_fn = r["before"][0]
        fns = {"tc": kernel_fn, "cores": cores_fn}
        if probe is not None:
            q, k, v, lengths, slots, ctx = r["inputs"]

            def probed():
                B, H, D = q.shape
                N, T, KV = k.shape[:3]
                span = T if ctx is None else min(ctx, T)
                cluster, n_split, split_t = RD.tc_plan(B, KV, D, span)
                out = torch.empty_like(q)
                err = probe(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            lengths.data_ptr(), slots.data_ptr(),
                            out.data_ptr(), B, H, KV, D, N, T, span, n_split,
                            split_t, cluster,
                            torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"CUDA error {err} at launch")
                return out
            fns["probe"] = probed
        for n in args.cluster:
            fns[f"tc{n}"] = clustered(torch, RD, _build, r["inputs"], n)
        what = f"bf16 {r['shape']}"
        ref = r["ref"]
        for tag, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            ok = torch.allclose(got.float(), ref.float(), rtol=2e-2,
                                atol=2e-2)
            bad += not ok
            print(f"[ab] {name} {what}: {tag} max|err| {err:.3e}"
                  f"{'' if ok else '  DISAGREES'}", flush=True)
        if reader is not None:
            buf = (ctypes.c_ulonglong * 24)()
            reader(ctypes.addressof(buf))
            fns["probe"]()
            torch.cuda.synchronize()
            if reader(ctypes.addressof(buf)):
                raise RuntimeError("repro_probe_cycles failed")
            print(f"[probe] {name}: {buf[6]} tiles over {buf[16]} CTAs "
                  f"({buf[17]} tiles counted); cycles (thread 0 of each "
                  f"CTA): " + ", ".join(
                      f"{label} {buf[i] / max(buf[n], 1):.0f}"
                      for i, n, label in PHASES), flush=True)
        res = {tag: {"events": [], "device": [], "host": []}
               for tag in ("cores", "tc")}
        for tag in ("cores", "tc", "tc", "cores"):
            out = res[tag]
            out["events"].append(smoke.cuda_ms(torch, fns[tag]))
            dev, _, missing = smoke.device_ms(
                torch, fns[tag], f"{tag} {what}",
                symbols=TC_SYMBOLS if tag == "tc" else CORE_SYMBOLS)
            out["device"].append(dev)
            out["host"].append(smoke.host_us(torch, fns[tag]))
        dev_plain, _, _ = smoke.device_ms(torch, plain_fn, f"plain {what}")
        dev_lib, _, _ = smoke.device_ms(torch, lib_fn, f"SDPA {what}")
        ev_lib = smoke.cuda_ms(torch, lib_fn)
        b_ms, b_by = smoke.bound(r["bytes"], r["flops"], "bfloat16")
        fmt = lambda xs, f: ", ".join("not measured" if v is None else f(v)
                                      for v in xs)
        for tag in ("tc", "cores"):
            out = res[tag]
            devs = [v for v in out["device"] if v is not None]
            mean = sum(devs) / len(devs) if devs else None
            share = ("not measured" if mean is None
                     else f"{100 * b_ms / mean:.1f}%")
            vs = ("not measured" if mean is None or dev_lib is None
                  else f"{mean / dev_lib:.2f}x")
            print(f"[time] {name} {what}: {tag} device "
                  f"{fmt(out['device'], lambda v: f'{v:.4f}')} ms, events "
                  f"{fmt(out['events'], lambda v: f'{v:.4f}')} ms, host "
                  f"{fmt(out['host'], lambda v: f'{v:.1f}')} us; bound "
                  f"{b_ms * 1e3:.2f} us ({b_by}), device at {share} of it; "
                  f"{vs} SDPA's device time", flush=True)
        show = lambda v: "not measured" if v is None else f"{v:.4f} ms"
        for n in args.cluster:
            tag = f"tc{n}"
            devs = [smoke.device_ms(torch, fns[tag], f"{tag} {what}",
                                    symbols=TC_SYMBOLS)[0]
                    for _ in range(2)]
            print(f"[time] {name} {what}: {tag} (clusters of up to {n}) "
                  f"device {fmt(devs, lambda v: f'{v:.4f}')} ms", flush=True)
        print(f"[time] {name} {what}: plain device {show(dev_plain)}; SDPA "
              f"device {show(dev_lib)}, events {show(ev_lib)}", flush=True)
        del r, fns
        torch.cuda.empty_cache()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
