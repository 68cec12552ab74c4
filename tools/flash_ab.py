#!/usr/bin/env python3
"""Time this tree's float32 flash kernel at head_dim 256 against another
checkout's and against SDPA, in turns, on one card; or against probes,
copies of it with one part of its work taken out.

    python3 tools/flash_ab.py OTHER [--cases s512 s4096 train]
    python3 tools/flash_ab.py --probe [NAME ...] [--cases ...]

OTHER is the root of another checkout of this repository (an earlier
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists, say). Its ``src/repro_torch/csrc/flash_attn.cu`` is built with the
same nvcc flags into ``build/flash_ab/`` and bound through the same C
entry, ``repro_flash_attention``; this tree's is ``_build``'s. Cases, in
float32 (the first three by default: recurrentgemma-9b's local attention,
16 q heads over one kv head of 256, window 2048):

  s512   q (4, 512, 16, 256), its prefill in ``rgemma exact``
  s4096  q (1, 4096, 16, 256), where the window binds
  train  q (8, 256, 16, 256), hybrid training's batch
  d64    q (4, 512, 32, 64), kv 8 heads, causal: llama3.2-1b's prefill
  d128   q (4, 512, 32, 128), kv 8 heads, causal: mistral-nemo-12b's

Per case: both outputs against ``flash_attention_plain`` (2e-5); then,
each in turns SDPA, other, this, this, other, SDPA: CUDA-event medians with
the L2 flushed, the profiler's device time per call (L2 warm, with the
kernels that took it) and the host's cost per call, by ``chip_smoke.py``'s
own timers; the bound (``chip_smoke.bound``) and each kernel's share of
it. ptxas's report for each library's D-256 float32 kernel comes first.
The probes remove work from the D-256 kernel only.

``--probe`` builds, for each NAME of ``PROBES`` (all by default), a copy
of this tree's ``csrc/`` whose ``flash_attn.cu`` has one part of the D-256
kernel's work removed by a text substitution, and times each copy's
kernel beside this tree's in the same turns: what the time falls by is
what that part costs on the kernel's critical path. A probe's output is
wrong by design, so only its error is printed, not checked.
Prints the card's name and power limit; exits 1 when an output disagrees,
2 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# (B, S, H, KV, D, window); the last two cases run flash_tf32x3_kernel
CASES = {"s512": (4, 512, 16, 1, 256, 2048),
         "s4096": (1, 4096, 16, 1, 256, 2048),
         "train": (8, 256, 16, 1, 256, 2048),
         "d64": (4, 512, 32, 8, 64, None),
         "d128": (4, 512, 32, 8, 128, None)}
DEFAULT_CASES = ("s512", "s4096", "train")
OUT = ROOT / "build" / "flash_ab"

# probe name: (what it removes, [(text of flash_attn.cu, its replacement)])
PROBES = {
    "no-producer": (
        "the producer's per-tile work: it loads and splits K and V for the "
        "first tile only, then hands the same planes over again",
        [("(k_empty, free_parity);\n      jitter(1);\n",
          "(k_empty, free_parity);\n      jitter(1);\n      if (j == 0)\n"),
         ("(v_empty, free_parity);\n      jitter(3);\n",
          "(v_empty, free_parity);\n      jitter(3);\n      if (j == 0)\n"),
         ("if (j + 1 < n_tiles) load_k(k_next);",
          "if (false) load_k(k_next);"),
         ("if (j + 1 < n_tiles) load_v(k_next);",
          "if (false) load_v(k_next);")]),
    "no-q-split": (
        "the consumer's per-tile Q loads and splits and the A-register "
        "waits after the first two pairs of k slices (the same A registers "
        "feed every pair)",
        [("      if (p >= 2) repro::wgmma_wait<1>();\n",
          "      if (p < 2) {\n"),
         ("          split(xs[sl][i], ah[p & 1][sl][i], al[p & 1][sl][i]);\n",
          "          split(xs[sl][i], ah[p & 1][sl][i], al[p & 1][sl][i]);\n"
          "      }\n")]),
    "no-s": (
        "the S = Q K^T wgmmas (and with them the Q splits they read)",
        [("        repro::wgmma_tf32_rs<kKeys>(s, al[p & 1][sl], kh);\n"
          "        repro::wgmma_tf32_rs<kKeys>(s, ah[p & 1][sl], kl);\n"
          "        repro::wgmma_tf32_rs<kKeys>(s, ah[p & 1][sl], kh);\n",
          "")]),
    "no-pv": (
        "the P V wgmmas",
        [("      repro::wgmma_tf32_rs<kD>(acc, pl[kk], vh);\n"
          "      repro::wgmma_tf32_rs<kD>(acc, ph[kk], vl);\n"
          "      repro::wgmma_tf32_rs<kD>(acc, ph[kk], vh);\n", "")]),
    "no-plane-split": (
        "the producer's split: it stores each float32 K and V value as "
        "its hi plane's entry and zero as its lo",
        [("        uint4 hi, lo;\n        split4(xs, hi, lo);\n"
          "        *reinterpret_cast<uint4*>(sm + kKHi",
          "        const uint4 hi = make_uint4(__float_as_uint(xs[0]), "
          "__float_as_uint(xs[1]), __float_as_uint(xs[2]), "
          "__float_as_uint(xs[3])), lo = make_uint4(0, 0, 0, 0);\n"
          "        *reinterpret_cast<uint4*>(sm + kKHi"),
         ("          uint4 hi, lo;\n          split4(xs, hi, lo);\n"
          "          const uint32_t at = VPlane::chunk",
          "          const uint4 hi = make_uint4(__float_as_uint(xs[0]), "
          "__float_as_uint(xs[1]), __float_as_uint(xs[2]), "
          "__float_as_uint(xs[3])), lo = make_uint4(0, 0, 0, 0);\n"
          "          const uint32_t at = VPlane::chunk")]),
    "no-plane-stores": (
        "the producer's plane stores after the first tile: it still splits "
        "every value, folding the results into one register",
        [("        *reinterpret_cast<uint4*>(sm + kKHi + KPlane::chunk(r, c)) = "
          "hi;\n        *reinterpret_cast<uint4*>(sm + kKLo + "
          "KPlane::chunk(r, c)) = lo;\n",
          "        if (j == 0) {\n"
          "        *reinterpret_cast<uint4*>(sm + kKHi + KPlane::chunk(r, c)) = "
          "hi;\n        *reinterpret_cast<uint4*>(sm + kKLo + "
          "KPlane::chunk(r, c)) = lo;\n        }\n"
          "        fold ^= hi.x ^ hi.y ^ hi.z ^ hi.w ^ lo.x ^ lo.y ^ lo.z ^ "
          "lo.w;\n"),
         ("          *reinterpret_cast<uint4*>(sm + kVHi + at) = hi;\n"
          "          *reinterpret_cast<uint4*>(sm + kVLo + at) = lo;\n",
          "          if (j == 0) {\n"
          "          *reinterpret_cast<uint4*>(sm + kVHi + at) = hi;\n"
          "          *reinterpret_cast<uint4*>(sm + kVLo + at) = lo;\n"
          "          }\n"
          "          fold ^= hi.x ^ hi.y ^ hi.z ^ hi.w ^ lo.x ^ lo.y ^ lo.z ^ "
          "lo.w;\n"),
         ("    float4 kx[16], vx[4][4];\n",
          "    float4 kx[16], vx[4][4];\n    uint32_t fold = 0;\n"),
         ("    }\n    return;\n  }\n\n  // consumer: rows",
          "    }\n    if (fold == 0x9e3779b9u) o[0] = 1.f;\n"
          "    return;\n  }\n\n  // consumer: rows")]),
    "phases": (
        "nothing: the first thread of each role adds its clock64 cycles "
        "per phase "
        "of every tile into a device array, which repro_probe_cycles "
        "reads (and zeroes)",
        [("// component i of x (i a constant once unrolled)\n",
          "__device__ unsigned long long probe_cycles[16];\n"
          "__device__ void probe_add(int i, long long v) {\n"
          "  atomicAdd(&probe_cycles[i], (unsigned long long)v);\n}\n"
          "// component i of x (i a constant once unrolled)\n"),
         ("    repro::mbar_wait(k_full, parity);\n    jitter(6);\n",
          "    const long long c0 = clock64();\n"
          "    repro::mbar_wait(k_full, parity);\n    jitter(6);\n"
          "    const long long c1 = clock64();\n"),
         ("    if (lane == 0) repro::mbar_arrive(k_empty);\n",
          "    if (lane == 0) repro::mbar_arrive(k_empty);\n"
          "    const long long c2 = clock64();\n"),
         ("    repro::mbar_wait(v_full, parity);\n    jitter(8);\n",
          "    const long long c3 = clock64();\n"
          "    repro::mbar_wait(v_full, parity);\n    jitter(8);\n"
          "    const long long c4 = clock64();\n"),
         ("    if (lane == 0) repro::mbar_arrive(v_empty);\n  }\n",
          "    if (lane == 0) repro::mbar_arrive(v_empty);\n"
          "    if (tid == 0) {\n"
          "      const long long c5 = clock64();\n"
          "      probe_add(0, c1 - c0); probe_add(1, c2 - c1);\n"
          "      probe_add(2, c3 - c2); probe_add(3, c4 - c3);\n"
          "      probe_add(4, c5 - c4); probe_add(5, 1);\n    }\n  }\n"),
         ("      repro::mbar_wait(k_empty, free_parity);\n",
          "      const long long p0 = clock64();\n"
          "      repro::mbar_wait(k_empty, free_parity);\n"
          "      const long long p1 = clock64();\n"),
         ("      repro::mbar_wait(v_empty, free_parity);\n",
          "      const long long p2 = clock64();\n"
          "      repro::mbar_wait(v_empty, free_parity);\n"
          "      const long long p3 = clock64();\n"),
         ("    }\n    return;\n  }\n\n  // consumer: rows",
          "      if (tid == kThreads) {\n"
          "        const long long p4 = clock64();\n"
          "        probe_add(6, p1 - p0); probe_add(7, p2 - p1);\n"
          "        probe_add(8, p3 - p2); probe_add(9, p4 - p3);\n"
          "        probe_add(10, 1);\n      }\n"
          "    }\n    return;\n  }\n\n  // consumer: rows"),
         ("  return (int)cudaErrorInvalidValue;\n}\n",
          "  return (int)cudaErrorInvalidValue;\n}\n\n"
          "extern \"C\" int repro_probe_cycles(unsigned long long* host) {\n"
          "  unsigned long long zero[16] = {0};\n"
          "  cudaError_t e = cudaMemcpyFromSymbol(host, f32::wide::probe_cycles,"
          " sizeof(zero));\n"
          "  if (e == cudaSuccess)\n"
          "    e = cudaMemcpyToSymbol(f32::wide::probe_cycles, zero, "
          "sizeof(zero));\n"
          "  return (int)e;\n}\n")]),
}
# the phases probe's slots: consumer thread 0, then producer thread 0
PHASES = ("consumer: wait K full", "S = Q K^T (Q loads and splits, 96 "
          "wgmmas)", "softmax and P split", "wait V full", "P V (12 wgmmas)",
          None, "producer: wait K empty", "K split and stores, next K loads",
          "wait V empty", "V split and stores, next V loads", None)


def bind(lib: Path):
    """(the library's C entry, its phase reader or None)."""
    from repro_torch.kernels import _build
    dll = ctypes.PyDLL(str(lib))
    fn = dll.repro_flash_attention
    fn.argtypes = _build.SIGNATURES["flash_attn"]["repro_flash_attention"]
    fn.restype = ctypes.c_int
    reader = getattr(dll, "repro_probe_cycles", None)
    if reader is not None:
        reader.argtypes = [ctypes.c_void_p]
        reader.restype = ctypes.c_int
    return fn, reader


def phase_report(torch, reader, call):
    """Cycles per tile of each phase over one ``call`` (the phases probe)."""
    buf = (ctypes.c_ulonglong * 16)()
    reader(ctypes.addressof(buf))          # zero the device array
    call()
    torch.cuda.synchronize()
    if reader(ctypes.addressof(buf)):
        raise RuntimeError("repro_probe_cycles failed")
    parts = []
    for i, label in enumerate(PHASES):
        if label is not None:
            n = buf[5] if i < 5 else buf[10]
            parts.append(f"{label} {buf[i] / max(n, 1):.0f}")
    return (f"{buf[5]} consumer and {buf[10]} producer tiles; cycles per "
            f"tile: " + ", ".join(parts))


def build(csrc_dirs):
    """{tag: ((bound C entry, phase reader), ptxas log)} for {tag: csrc
    directory}, one nvcc each, all started together."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, csrc in csrc_dirs.items():
        lib = OUT / f"libflash_attn_{tag}.so"
        procs[tag] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(lib), str(csrc / "flash_attn.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for tag, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        built[tag] = (bind(lib), log)
    return built


def probe_csrc(name: str) -> Path:
    """A copy of this tree's csrc/ with probe ``name``'s substitutions."""
    import shutil
    from repro_torch.kernels import _build
    dst = OUT / f"probe-{name}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CSRC, dst)
    src = (dst / "flash_attn.cu").read_text()
    for old, new in PROBES[name][1]:
        if src.count(old) != 1:
            raise RuntimeError(f"probe {name}: {old!r} is not in "
                               f"flash_attn.cu exactly once")
        src = src.replace(old, new)
    (dst / "flash_attn.cu").write_text(src)
    return dst


def d256_report(log: str):
    """ptxas's lines for the float32 kernels that are not templated on D
    (the D-256 ones), and any wgmma serialization it reports."""
    kernel, lines = "?", []
    for line in log.splitlines():
        if "Function properties for" in line:
            kernel = line.split(" for ", 1)[1].strip()
        elif ("flash_tf32x3_d256" in kernel or "flash_f32_cc" in kernel) and (
                "registers" in line or "spill" in line):
            lines.append(f"{kernel}: {line.strip()}")
        if "serialized" in line:
            lines.append(line.strip())
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, nargs="?",
                    help="root of the other checkout")
    ap.add_argument("--probe", nargs="*", choices=tuple(PROBES),
                    help="time probes instead (all when none is named)")
    ap.add_argument("--cases", nargs="+", default=list(DEFAULT_CASES),
                    choices=tuple(CASES))
    args = ap.parse_args()
    if (args.other is None) == (args.probe is None):
        ap.error("give OTHER or --probe")
    import torch
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    import repro_torch.kernels as K
    from repro_torch.kernels import _build
    print(f"[env] {smoke.smi_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    logs = _build.build_all(["flash_attn"])
    this = _build.function("flash_attn", "repro_flash_attention")
    if args.probe is None:
        dirs = {"other": args.other.resolve() / "src" / "repro_torch" / "csrc"}
    else:
        for name in args.probe or PROBES:
            print(f"[probe] {name}: removes {PROBES[name][0]}", flush=True)
        dirs = {name: probe_csrc(name) for name in args.probe or PROBES}
    built = build(dirs)
    this_log = logs.get("flash_attn", "")
    print(f"[ptxas] this: {' | '.join(d256_report(this_log))}")
    for tag, (_, log) in built.items():
        print(f"[ptxas] {tag}: {' | '.join(d256_report(log))}", flush=True)
    F = torch.nn.functional
    bad = 0
    for name in args.cases:
        B, S, H, KV, D, WINDOW = CASES[name]
        window = -1 if WINDOW is None else WINDOW
        g = torch.Generator(device="cuda").manual_seed(3)
        q = torch.randn((B, S, H, D), generator=g, device="cuda")
        k = torch.randn((B, S, KV, D), generator=g, device="cuda")
        v = torch.randn((B, S, KV, D), generator=g, device="cuda")

        def launch(fn):
            def call():
                o = torch.empty_like(q)
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), B, S, S, H, KV, D, D, D, 0, window,
                         D ** -0.5, 0, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"CUDA error {err} at launch")
                return o
            return call

        qt = q.transpose(1, 2).contiguous()
        kt = k.transpose(1, 2).repeat_interleave(H // KV, dim=1).contiguous()
        vt = v.transpose(1, 2).repeat_interleave(H // KV, dim=1).contiguous()
        if WINDOW is not None and WINDOW < S:   # as a boolean mask
            i = torch.arange(S, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                 - WINDOW)
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                          attn_mask=mask)
        else:
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                          is_causal=True)
        fns = {"sdpa": sdpa, "this": launch(this),
               **{tag: launch(fn) for tag, ((fn, _), _) in built.items()}}
        ref = K.flash_attention_plain(q, k, v, window=WINDOW)
        what = f"q{tuple(q.shape)} kv{tuple(k.shape)} window {WINDOW}"
        for tag in ("this", *built):
            err = (fns[tag]() - ref).abs().max().item()
            if tag in ("this", "other"):     # a probe is wrong by design
                bad += err > smoke.TOL["float32"]
            print(f"[ab] {name} {what}: {tag} max|err| {err:.3e}", flush=True)
        # in turns: SDPA, the others, this, this, the others reversed, SDPA
        order = ("sdpa", *built, "this", "this", *reversed(built), "sdpa")
        res = {tag: {"events": [], "device": [], "host": [], "ran": set()}
               for tag in fns}
        for tag in order:
            r = res[tag]
            r["events"].append(smoke.cuda_ms(torch, fns[tag]))
            dev, top, _ = smoke.device_ms(torch, fns[tag], f"{tag} {what}")
            r["device"].append(dev)
            r["ran"].update(top)
            r["host"].append(smoke.host_us(torch, fns[tag]))
        pairs = sum(min(i + 1, WINDOW or S) for i in range(S))
        b_ms, b_by = smoke.bound(
            (2 * q.numel() + k.numel() + v.numel()) * 4,
            2 * B * H * 2 * D * pairs, "float32")
        fmt = lambda xs, f: ", ".join("not measured" if x is None else f(x)
                                      for x in xs)
        for tag in ("this", *built, "sdpa"):
            r = res[tag]
            devs = [x for x in r["device"] if x is not None]
            share = (f"{100 * b_ms / (sum(devs) / len(devs)):.1f}%"
                     if devs else "not measured")
            print(f"[ab] {name} {tag}: events {fmt(r['events'], '{:.4f}'.format)}"
                  f" ms | device {fmt(r['device'], '{:.4f}'.format)} ms "
                  f"({share} of the {b_ms * 1e3:.2f} us bound, {b_by}) | host "
                  f"{fmt(r['host'], '{:.1f}'.format)} us per call | ran "
                  f"{', '.join(sorted(smoke.short_name(n) for n in r['ran']))}",
                  flush=True)
        for tag, ((_, reader), _) in built.items():
            if reader is not None:
                print(f"[ab] {name} {tag}: "
                      f"{phase_report(torch, reader, fns[tag])}", flush=True)
        del q, k, v, qt, kt, vt, fns, ref
        torch.cuda.empty_cache()
    print(f"[done] "
          f"{'all outputs within 2e-5' if not bad else f'{bad} FAILED'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
