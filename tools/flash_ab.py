#!/usr/bin/env python3
"""Time this tree's flash kernels against another checkout's and against
SDPA, in turns, on one card; or against probes and variants, copies of
this tree's source with one part of a kernel's work taken out or one
setting changed.

    python3 tools/flash_ab.py OTHER [--cases s512 s4096 train]
    python3 tools/flash_ab.py OTHER --cases mla d128 d64 d256
    python3 tools/flash_ab.py OTHER --cases d256-serve d256-s256 d256-s128 d256-s64
    python3 tools/flash_ab.py --probe [NAME ...] [--cases ...] [--layouts]

OTHER is the root of another checkout of this repository (an earlier
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists, say). Its ``src/repro_torch/csrc/flash_attn.cu`` is built with the
same nvcc flags into ``build/flash_ab/`` and bound through the same C
entry, ``repro_flash_attention``; this tree's is ``_build``'s. Cases (the
first three by default: recurrentgemma-9b's local attention, 16 q heads
over one kv head of 256, window 2048):

  s512      f32 q (4, 512, 16, 256), its prefill in ``rgemma exact``
  s4096     f32 q (1, 4096, 16, 256), where the window binds
  train     f32 q (8, 256, 16, 256), hybrid training's batch
  f32-d64   f32 q (4, 512, 32, 64), kv 8 heads, causal: llama3.2-1b's
            prefill (``flash_tf32x3_kernel``)
  f32-d128  f32 q (4, 512, 32, 128), kv 8 heads: mistral-nemo-12b's
  mla       bf16 q, k (4, 512, 40, 96), v (4, 512, 40, 64), causal:
            minicpm3-4b's prefill (``flash_tc_kernel`` at (128, 64))
  d128      bf16 q (4, 512, 32, 128), kv 8 heads: mistral-nemo-12b's
  d64       bf16 q (4, 512, 32, 64), kv 8 heads: llama3.2-1b's
  d256      bf16 q (4, 512, 16, 256), kv 1 head, window 2048:
            recurrentgemma-9b's (two heads a CTA)
  d256-s4096, -s2048, -s1024, -b2
            the same at (1, 4096), (1, 2048), (1, 1024) and (2, 512): the
            window binds at 4096; 512, 256, 128 and 128 two-head CTAs
  d256-serve, -s256, -s128, -s64
            the rgemma serve's prefills, one request at S 384, 256, 128
            and 64 (one head a CTA)

Per case: every output against ``flash_attention_plain`` (2e-5 in
float32, 2e-2 in bfloat16); then, each in turns SDPA, the others, this,
this, the others reversed, SDPA: CUDA-event medians with the L2 flushed,
the profiler's device time per call (L2 warm, with the kernels that took
it) and the host's cost per call, by ``chip_smoke.py``'s own timers; the
bound (``chip_smoke.bound``) and each kernel's share of it. ptxas's report
for each library's float32 D-256 kernels comes first, and for its bf16
``flash_tc_kernel`` instantiations when a bf16 case runs, with this
tree's instantiation per bf16 case (registers, spill bytes, CTAs an SM
holds, layout: ``kernels.flash_attn.tc_info``). ``--layouts`` adds this
tree's bf16 kernel at width 256 in each forced layout (``heads1``,
``heads2``: ``kernels.flash_attn._launch_heads``) to the turns, checked
like this tree's.

``--probe`` builds, for each NAME of ``PROBES`` (all by default), a copy
of this tree's ``csrc/`` whose ``flash_attn.cu`` is changed by a text
substitution, and times each copy's kernel beside this tree's in the same
turns. A probe that removes work (``no-*``: the float32 D-256 kernel's)
is wrong by design, so only its error is printed: what the time falls by
is what that part costs on the kernel's critical path (``no-kv-loads``
and ``pp-no-kv-loads``: the bf16 kernel's K/V loads after the ring's
first fill, in one head a CTA and in two). The others are checked like
this tree's: ``phases`` (the float32 D-256 kernel) and ``tc-phases`` (the
bf16 kernels; ``tc-phases-1cta`` with one CTA an SM at D 128) add clock64
cycles per tile of each consumer and producer phase, read back through
``repro_probe_cycles``, to see what sets the kernel's pace: in two heads
a CTA per turn of each consumer, with its wait at the turn-taking
barrier, and for thread 0 of every CTA the cycles before, in and after
its loop and the share of the SMs' time that CTAs held over the kernel's
span (global timer); ``nh1-d64`` and ``s3`` are the bf16 kernel's other
layouts (one head a CTA at D 64; a three-stage ring at D 128);
``pp-q-prefetch`` prefetches into L2 the Q tiles of the CTA 132 later.
Prints the card's name and power limit; exits 1 when an output that is
checked disagrees, 2 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# (B, S, H, KV, D, Dv, window, dtype)
CASES = {"s512": (4, 512, 16, 1, 256, 256, 2048, "float32"),
         "s4096": (1, 4096, 16, 1, 256, 256, 2048, "float32"),
         "train": (8, 256, 16, 1, 256, 256, 2048, "float32"),
         "f32-d64": (4, 512, 32, 8, 64, 64, None, "float32"),
         "f32-d128": (4, 512, 32, 8, 128, 128, None, "float32"),
         "mla": (4, 512, 40, 40, 96, 64, None, "bfloat16"),
         "d128": (4, 512, 32, 8, 128, 128, None, "bfloat16"),
         "d64": (4, 512, 32, 8, 64, 64, None, "bfloat16"),
         "d256": (4, 512, 16, 1, 256, 256, 2048, "bfloat16"),
         "d256-s4096": (1, 4096, 16, 1, 256, 256, 2048, "bfloat16"),
         "d256-s2048": (1, 2048, 16, 1, 256, 256, 2048, "bfloat16"),
         "d256-s1024": (1, 1024, 16, 1, 256, 256, 2048, "bfloat16"),
         "d256-b2": (2, 512, 16, 1, 256, 256, 2048, "bfloat16"),
         "d256-serve": (1, 384, 16, 1, 256, 256, 2048, "bfloat16"),
         "d256-s256": (1, 256, 16, 1, 256, 256, 2048, "bfloat16"),
         "d256-s128": (1, 128, 16, 1, 256, 256, 2048, "bfloat16"),
         "d256-s64": (1, 64, 16, 1, 256, 256, 2048, "bfloat16")}
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
# the bf16 kernel's probes. tc-phases: in flash_tc_kernel thread 0 of
# every CTA (consumer warpgroup 0) and lane 0 of its producer warp add
# clock64 cycles per tile of each phase, the consumer's wait on a full stage
# apart for the first tile and the later ones; in flash_tc_kernel_pp (two
# heads a CTA at D 256) thread 0 of each consumer warpgroup adds its own per
# turn, the wait at the turn-taking barrier among them, and the producer
# lane its waits and issues
TC_PHASES = [
    ("// One CTA: one q tile of 64 rows of NC heads of a KV group, one consumer",
     "__device__ unsigned long long probe_cycles[48];\n"
     "__device__ void probe_add(int i, long long v) {\n"
     "  atomicAdd(&probe_cycles[i], (unsigned long long)v);\n}\n"
     "__device__ unsigned long long probe_gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"
     "// slots 32 ... 38: cycles before the loop, in it, after it; CTAs; the\n"
     "// last exit and 2^62 - the first entry (ns); the CTAs' summed ns\n"
     "__device__ void probe_cta(long long c0, long long l0, long long l1,\n"
     "                          unsigned long long g0) {\n"
     "  const long long c1 = clock64();\n"
     "  const unsigned long long g1 = probe_gtime();\n"
     "  probe_add(32, l0 - c0); probe_add(33, l1 - l0);\n"
     "  probe_add(34, c1 - l1); probe_add(35, 1);\n"
     "  atomicMax(&probe_cycles[36], g1);\n"
     "  atomicMax(&probe_cycles[37], (1ull << 62) - g0);\n"
     "  probe_add(38, (long long)(g1 - g0));\n}\n"
     "// One CTA: one q tile of 64 rows of NC heads of a KV group, one consumer"),
    ("  const int G = H / KV;\n  const int passes = (G + NC - 1) / NC;\n",
     "  const long long t_start = clock64();\n"
     "  const int G = H / KV;\n  const int passes = (G + NC - 1) / NC;\n"),
    ("    mbar_wait(full(st), (j / kStages) & 1);\n    repro::jitter(6);\n"
     "    if (active) {\n",
     "    const long long c0 = clock64();\n"
     "    mbar_wait(full(st), (j / kStages) & 1);\n    repro::jitter(6);\n"
     "    const long long c1 = clock64();\n"
     "    if (tid == 0) {\n      probe_add(0, c1 - c0); probe_add(5, 1);\n"
     "      probe_add(j == 0 ? 11 : 13, c1 - c0); probe_add(j == 0 ? 12 : 14, "
     "1);\n    }\n"
     "    if (active) {\n"),
    ("      repro::fence_regs(s);\n\n      uint32_t pa[4][4];\n",
     "      repro::fence_regs(s);\n      const long long c2 = clock64();\n\n"
     "      uint32_t pa[4][4];\n"),
    ("                       window, scale_log2);\n\n"
     "      // O += P V at the V tile's width DV\n",
     "                       window, scale_log2);\n\n"
     "      const long long c3 = clock64();\n"
     "      // O += P V at the V tile's width DV\n"),
    ("      repro::fence_regs(acc);\n    }\n"
     "    // every consumer frees every stage",
     "      repro::fence_regs(acc);\n      if (tid == 0) {\n"
     "        const long long c4 = clock64();\n"
     "        probe_add(1, c2 - c1); probe_add(2, c3 - c2);\n"
     "        probe_add(3, c4 - c3); probe_add(4, 1);\n      }\n    }\n"
     "    // every consumer frees every stage"),
    ("  if (active) store_tile<DV>(acc, l, o, b, S, H, head, Dv, row0, lane);\n",
     "  if (tid == 0) { probe_add(9, clock64() - t_start); "
     "probe_add(10, 1); }\n"
     "  if (active) store_tile<DV>(acc, l, o, b, S, H, head, Dv, row0, lane);\n"),
    ("      mbar_wait(empty(st), ((j / kStages) & 1) ^ 1);\n"
     "      repro::jitter(1);\n",
     "      const long long p0 = clock64();\n"
     "      mbar_wait(empty(st), ((j / kStages) & 1) ^ 1);\n"
     "      repro::jitter(1);\n"
     "      const long long p1 = clock64();\n"),
    ("        tma_head_tile<DV>(v_s + st * LV::kBytes, &tv, full(st), kvh, "
     "k0, b);\n",
     "        tma_head_tile<DV>(v_s + st * LV::kBytes, &tv, full(st), kvh, "
     "k0, b);\n        probe_add(6, p1 - p0); "
     "probe_add(7, clock64() - p1); probe_add(8, 1);\n"),
    # flash_tc_kernel_pp: consumer w's slots from 16 + 8 w
    ("  // turn j: P V of tile j - 1 (j > 0), then S of tile j (j < n_tiles)\n",
     "  const long long u_start = clock64();\n"
     "  const bool probe_me = (tid & 127) == 0;\n"
     "  const int ps = 16 + 8 * wg;\n"
     "  // turn j: P V of tile j - 1 (j > 0), then S of tile j (j < n_tiles)\n"),
    ("    if (j < n_tiles) mbar_wait(full_k(st), (j / kStages) & 1);\n",
     "    const long long u0 = clock64();\n"
     "    if (j < n_tiles) mbar_wait(full_k(st), (j / kStages) & 1);\n"),
    ("    if (both) repro::named_sync(1 + wg, 256);\n",
     "    const long long u1 = clock64();\n"
     "    if (both) repro::named_sync(1 + wg, 256);\n"
     "    const long long u2 = clock64();\n"),
    ("      repro::fence_regs(acc);\n    }\n    float s[32];\n",
     "      repro::fence_regs(acc);\n    }\n"
     "    const long long u3 = clock64();\n    float s[32];\n"),
    ("    if (both && !(wg == 1 && j == n_tiles))\n",
     "    const long long u4 = clock64();\n"
     "    if (both && !(wg == 1 && j == n_tiles))\n"),
    ("                       window, scale_log2);\n  }\n\n"
     "  store_tile_tma<DV>(acc, l, my_q, &to, b, head, q0, wg, wl, lane);\n",
     "                       window, scale_log2);\n"
     "    if (probe_me) {\n      const long long u5 = clock64();\n"
     "      probe_add(ps, u1 - u0); probe_add(ps + 1, u2 - u1);\n"
     "      probe_add(ps + 2, u3 - u2); probe_add(ps + 3, u4 - u3);\n"
     "      probe_add(ps + 4, u5 - u4); probe_add(ps + 5, 1);\n"
     "      if (j == 0) probe_add(39 + wg, u1 - u0);\n    }\n  }\n"
     "  if (probe_me) {\n"
     "    probe_add(ps + 6, clock64() - u_start); probe_add(ps + 7, 1);\n"
     "  }\n\n"
     "  store_tile_tma<DV>(acc, l, my_q, &to, b, head, q0, wg, wl, lane);\n"),
    ("        mbar_wait(empty_k(st), free_parity);\n",
     "        const long long p0 = clock64();\n"
     "        mbar_wait(empty_k(st), free_parity);\n"
     "        const long long p1 = clock64();\n"),
    ("        mbar_wait(empty_v(st), free_parity);\n",
     "        const long long p2 = clock64();\n"
     "        mbar_wait(empty_v(st), free_parity);\n"
     "        const long long p3 = clock64();\n"),
    ("          tma_head_tile<DV>(v_s + st * LV::kBytes, &tv, full_v(st), kvh, "
     "k0,\n                            b);\n",
     "          tma_head_tile<DV>(v_s + st * LV::kBytes, &tv, full_v(st), kvh, "
     "k0,\n                            b);\n"
     "          probe_add(6, (p1 - p0) + (p3 - p2));\n"
     "          probe_add(7, (p2 - p1) + (clock64() - p3)); probe_add(8, 1);\n"),
    # both kernels: thread 0's whole CTA (entry to its stores done), the
    # part before its loop and after it, and the kernel's span on the
    # global timer (first entry to last exit) with the CTAs' summed spans
    ("  const long long t_start = clock64();\n",
     "  const long long t_start = clock64();\n"
     "  const long long cta_c0 = t_start;\n"
     "  const unsigned long long cta_g0 = probe_gtime();\n"),
    ("  if (active) store_tile<DV>(acc, l, o, b, S, H, head, Dv, row0, lane);\n",
     "  const long long loop_end = clock64();\n"
     "  if (active) store_tile<DV>(acc, l, o, b, S, H, head, Dv, row0, lane);\n"
     "  if (tid == 0) probe_cta(cta_c0, t_start, loop_end, cta_g0);\n"),
    ("  constexpr int D = pp::kD;\n",
     "  const long long cta_c0 = clock64();\n"
     "  const unsigned long long cta_g0 = probe_gtime();\n"
     "  constexpr int D = pp::kD;\n"),
    ("  store_tile_tma<DV>(acc, l, my_q, &to, b, head, q0, wg, wl, lane);\n"
     "}\n\n// One launch of the two-head layout",
     "  const long long loop_end = clock64();\n"
     "  store_tile_tma<DV>(acc, l, my_q, &to, b, head, q0, wg, wl, lane);\n"
     "  if (tid == 0) probe_cta(cta_c0, u_start, loop_end, cta_g0);\n}\n\n"
     "// One launch of the two-head layout"),
    # flash_tc_kernel_pp's prologue: entry to its Q issue, the Q load; the
    # part before the loop of the first wave's CTAs and the later ones'
    ("    for (int w = 0; w < (both ? 2 : 1); ++w) {\n",
     "    q_c0 = clock64();\n"
     "    for (int w = 0; w < (both ? 2 : 1); ++w) {\n"),
    ("  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kRows - 1) / kRows : 0;"
     "\n\n  if (tid == 0) {\n    for (int st = 0; st < kStages; ++st) {\n"
     "      mbar_init(full_k(st), 1);\n",
     "  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kRows - 1) / kRows : 0;"
     "\n  long long q_c0 = 0;\n"
     "\n  if (tid == 0) {\n    for (int st = 0; st < kStages; ++st) {\n"
     "      mbar_init(full_k(st), 1);\n"),
    ("  mbar_wait(qbar(wg), 0);\n  if (both && wg == 1)",
     "  mbar_wait(qbar(wg), 0);\n"
     "  if (tid == 0) {\n    probe_add(41, q_c0 - cta_c0);\n"
     "    probe_add(42, clock64() - q_c0);\n  }\n"
     "  if (both && wg == 1)"),
    ("  if (tid == 0) probe_cta(cta_c0, u_start, loop_end, cta_g0);\n",
     "  if (tid == 0) probe_cta(cta_c0, u_start, loop_end, cta_g0);\n"
     "  if (tid == 0) {\n    const int lin = blockIdx.x + gridDim.x * "
     "(blockIdx.y + gridDim.y * blockIdx.z);\n"
     "    probe_add(lin < 132 ? 43 : 44, u_start - cta_c0);\n"
     "    probe_add(lin < 132 ? 45 : 46, 1);\n  }\n"),
    ("  return tc::dispatch(q, k, v, o, sh, static_cast<cudaStream_t>(stream),\n"
     "                      info, heads);\n}\n",
     "  return tc::dispatch(q, k, v, o, sh, static_cast<cudaStream_t>(stream),\n"
     "                      info, heads);\n}\n\n"
     "extern \"C\" int repro_probe_cycles(unsigned long long* host) {\n"
     "  unsigned long long zero[48] = {0};\n"
     "  cudaError_t e = cudaMemcpyFromSymbol(host, tc::probe_cycles, "
     "sizeof(zero));\n"
     "  if (e == cudaSuccess)\n"
     "    e = cudaMemcpyToSymbol(tc::probe_cycles, zero, sizeof(zero));\n"
     "  return (int)e;\n}\n")]
# 120,000 bytes of shared memory more a CTA at D 128: one CTA an SM
ONE_CTA_D128 = ("  return 1024 + (size_t)(NC + stages<D>()) * Tile<D>::kBytes +",
                "  return (D == 128 ? 120000 : 0) + 1024 +\n"
                "         (size_t)(NC + stages<D>()) * Tile<D>::kBytes +")
PROBES.update({
    "tc-phases": (
        "nothing (bf16 flash_tc_kernel): thread 0 of each CTA and its "
        "producer lane add their clock64 cycles per phase of every tile "
        "into a device array, which repro_probe_cycles reads (and zeroes)",
        TC_PHASES),
    "tc-phases-1cta": (
        "nothing: tc-phases with one CTA an SM at D 128 (120,000 bytes of "
        "shared memory more a CTA)", TC_PHASES + [ONE_CTA_D128]),
    "no-kv-loads": (
        "the bf16 kernel's K/V loads after the ring's first fill: the "
        "producer frees each full stage again without a copy, so later "
        "tiles reuse the first ones' K and V",
        [("      if (lane == 0) {\n"
          "        mbar_expect_tx(full(st), LQ::kBytes + LV::kBytes);\n",
          "      if (lane == 0 && j >= kStages) {\n"
          "        mbar_arrive(full(st));\n"
          "      } else if (lane == 0) {\n"
          "        mbar_expect_tx(full(st), LQ::kBytes + LV::kBytes);\n")]),
    "nh1-d64": ("nothing: one head a CTA at D = DV <= 64 too (llama's G 4 "
                "takes four CTAs side by side)",
                [("    if (G >= 4) return launch_tc<D, DV, kAll, 4>(q, k, v, o, "
                  "sh, stream, info);\n"
                  "    if (G >= 2) return launch_tc<D, DV, kAll, 2>(q, k, v, o, "
                  "sh, stream, info);\n", "    (void)G;\n")]),
    "s3": ("nothing: a three-stage K/V ring at D 128 (two CTAs an SM at "
           "the MLA pair)",
           [("  return D == 128 ? 2 : D > 128 ? 3 : 4;",
             "  return D == 128 ? 3 : D > 128 ? 3 : 4;")]),
})
# flash_tc_kernel_pp's variants: no K/V loads after the two stages' first
# fill; an L2 prefetch of the Q tiles of the CTA 132 later in grid order
PROBES.update({
    "pp-no-kv-loads": (
        "the two-head kernel's K/V loads after the ring's first fill (the "
        "producer arrives on each full barrier without a copy)",
        [("        if (lane == 0) {\n"
          "          mbar_expect_tx(full_k(st), LQ::kBytes);\n",
          "        if (lane == 0 && j >= kStages) {\n"
          "          mbar_arrive(full_k(st));\n"
          "        } else if (lane == 0) {\n"
          "          mbar_expect_tx(full_k(st), LQ::kBytes);\n"),
         ("        if (lane == 0) {\n"
          "          mbar_expect_tx(full_v(st), LV::kBytes);\n",
          "        if (lane == 0 && j >= kStages) {\n"
          "          mbar_arrive(full_v(st));\n"
          "        } else if (lane == 0) {\n"
          "          mbar_expect_tx(full_v(st), LV::kBytes);\n")]),
    "pp-q-prefetch": (
        "nothing: the two-head kernel's thread 0 prefetches into L2 the Q "
        "tiles of the CTA 132 later in grid order",
        [("  if (warp >= 8) {\n    // producer warpgroup",
          "  if (tid == 0) {\n"
          "    const int n_ctas = gridDim.x * gridDim.y * gridDim.z;\n"
          "    const int lin = blockIdx.x + gridDim.x * (blockIdx.y + "
          "gridDim.y * blockIdx.z) + 132;\n"
          "    if (lin < n_ctas) {\n"
          "      const int x = lin % gridDim.x;\n"
          "      const int y = (lin / gridDim.x) % gridDim.y;\n"
          "      const int z = lin / (gridDim.x * gridDim.y);\n"
          "      const int nq0 = (gridDim.z - 1 - z) * kRows;\n"
          "      for (int w = 0; w < 2; ++w) {\n"
          "        const int hg = 2 * (x % passes) + w;\n"
          "        if (hg < G)\n"
          "          for (int a = 0; a < 4; ++a)\n"
          "            asm volatile(\"cp.async.bulk.prefetch.tensor.4d.L2."
          "global.tile [%0, {%1, %2, %3, %4}];\" :: \"l\"(reinterpret_cast"
          "<uint64_t>(&tq)), \"r\"(64 * a), \"r\"((x / passes) * G + hg), "
          "\"r\"(nq0), \"r\"(y) : \"memory\");\n"
          "      }\n    }\n  }\n"
          "  if (warp >= 8) {\n    // producer warpgroup")]),
})
# probes whose output is right and is checked (the no-* ones remove work)
CHECKED = ("phases", "tc-phases", "tc-phases-1cta", "nh1-d64", "s3",
           "pp-q-prefetch")

# each phases probe's slots: (slot of the cycles, slot of its count, label)
PHASES = {
    "phases": (
        (0, 5, "consumer: wait K full"),
        (1, 5, "S = Q K^T (Q loads and splits, 96 wgmmas)"),
        (2, 5, "softmax and P split"), (3, 5, "wait V full"),
        (4, 5, "P V (12 wgmmas)"), (6, 10, "producer: wait K empty"),
        (7, 10, "K split and stores, next K loads"),
        (8, 10, "wait V empty"), (9, 10, "V split and stores, next V loads")),
    "tc-phases": (
        (0, 5, "consumer: wait K/V full (every tile)"),
        (11, 12, "wait K/V full (first tile)"),
        (13, 14, "wait K/V full (later tiles)"),
        (1, 4, "S = Q K^T (a computed tile)"),
        (2, 4, "softmax and P pack"), (3, 4, "P V"),
        (6, 8, "producer: wait empty"), (7, 8, "TMA issue"),
        (9, 10, "thread 0's CTA, start to the end of its loop"),
        *((16 + 8 * w + i, 16 + 8 * w + n, f"two heads, consumer {w}: {what}")
          for w in (0, 1) for i, n, what in (
              (0, 5, "wait K/V full (a turn)"),
              (1, 5, "wait for its turn"), (2, 5, "P V"), (3, 5, "S"),
              (4, 5, "hand-over, stages freed, softmax and P pack"),
              (6, 7, "its CTA, start to the end of its loop"))),
        (39, 23, "two heads, consumer 0: wait K/V full, turn 0"),
        (40, 31, "two heads, consumer 1: wait K/V full, turn 0"),
        (41, 23, "two heads, CTA entry to its Q issue"),
        (42, 23, "two heads, the Q load"),
        (43, 45, "two heads, before the loop (first 132 CTAs)"),
        (44, 46, "two heads, before the loop (later CTAs)")),
}
PHASES["tc-phases-1cta"] = PHASES["tc-phases"]


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


def phase_report(torch, reader, call, name):
    """Cycles per tile of each phase over one ``call`` (probe ``name``)."""
    buf = (ctypes.c_ulonglong * 48)()
    reader(ctypes.addressof(buf))          # zero the device array
    call()
    torch.cuda.synchronize()
    if reader(ctypes.addressof(buf)):
        raise RuntimeError("repro_probe_cycles failed")
    counts = sorted({n for _, n, _ in PHASES[name]})
    parts = [f"{label} {buf[i] / max(buf[n], 1):.0f}"
             for i, n, label in PHASES[name] if buf[n]]
    line = (f"counts {', '.join(str(buf[n]) for n in counts)}; cycles per "
            f"tile: " + ", ".join(parts))
    if name.startswith("tc-phases") and buf[35]:
        # thread 0 of every CTA: its cycles before, in and after its loop;
        # the share of the SMs' time over the kernel's span that CTAs held
        span = buf[36] - ((1 << 62) - buf[37])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        n = buf[35]
        line += (f" | a CTA (thread 0, {n} CTAs): before its loop "
                 f"{buf[32] / n:.0f}, its loop {buf[33] / n:.0f}, after it "
                 f"{buf[34] / n:.0f} cycles, {buf[38] / n:.0f} ns; span "
                 f"{span} ns, CTAs held {100 * buf[38] / (sms * span):.1f} % "
                 f"of the {sms} SMs' time over it; "
                 f"{(buf[32] + buf[33] + buf[34]) / buf[38]:.3f} cycles/ns")
    return line


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


def ptxas_report(log: str, bf16: bool):
    """ptxas's lines for the float32 kernels that are not templated on D
    (the D-256 ones) and, with ``bf16``, for every ``flash_tc_kernel``
    instantiation; and any wgmma serialization it reports."""
    kernel, lines = "?", []
    for line in log.splitlines():
        if "Function properties for" in line:
            kernel = line.split(" for ", 1)[1].strip()
        elif ("flash_tf32x3_d256" in kernel or "flash_f32_cc" in kernel
              or (bf16 and "flash_tc_kernel" in kernel)) and (
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
    ap.add_argument("--layouts", action="store_true",
                    help="also time this tree's bf16 kernel at D 256 in "
                         "each forced layout (one and two heads a CTA)")
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
    bf16 = any(CASES[c][7] == "bfloat16" for c in args.cases)
    this_log = logs.get("flash_attn", "")
    print(f"[ptxas] this: {' | '.join(ptxas_report(this_log, bf16))}")
    for tag, (_, log) in built.items():
        print(f"[ptxas] {tag}: {' | '.join(ptxas_report(log, bf16))}",
              flush=True)
    F = torch.nn.functional
    bad = 0
    for name in args.cases:
        B, S, H, KV, D, Dv, WINDOW, dname = CASES[name]
        dtype = getattr(torch, dname)
        window = -1 if WINDOW is None else WINDOW
        width = K.flash_attn.kernel_width(D, Dv)
        g = torch.Generator(device="cuda").manual_seed(3)
        q = torch.randn((B, S, H, D), generator=g, device="cuda").to(dtype)
        k = torch.randn((B, S, KV, D), generator=g, device="cuda").to(dtype)
        v = torch.randn((B, S, KV, Dv), generator=g, device="cuda").to(dtype)
        if dtype == torch.bfloat16:
            print(f"[tc] {name}: this tree runs "
                  f"{K.flash_attn.tc_info(B, S, S, H, KV, D, Dv)}", flush=True)

        def launch(fn):
            def call():
                o = q.new_empty((B, S, H, Dv))
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), B, S, S, H, KV, width, D, Dv, 0,
                         window, D ** -0.5, _build.dtype_code(dtype),
                         torch.cuda.current_stream().cuda_stream)
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
        forced = {}
        if args.layouts and dtype == torch.bfloat16 and width == 256:
            FA = K.flash_attn
            forced = {f"heads{n}": (lambda n=n: FA._launch_heads(
                q, k, v, n, window=WINDOW)) for n in (1, 2)}
            for n in (1, 2):
                print(f"[tc] {name}: heads {n}: "
                      f"{FA.tc_info(B, S, S, H, KV, D, Dv, heads=n)}",
                      flush=True)
        fns = {"sdpa": sdpa, "this": launch(this), **forced,
               **{tag: launch(fn) for tag, ((fn, _), _) in built.items()}}
        ref = K.flash_attention_plain(q, k, v, window=WINDOW)
        what = (f"{dname} q{tuple(q.shape)} k{tuple(k.shape)} "
                f"v{tuple(v.shape)} window {WINDOW}")
        for tag in ("this", *forced, *built):
            err = (fns[tag]().float() - ref.float()).abs().max().item()
            if tag in ("this", "other", *forced, *CHECKED):   # no-*: wrong
                bad += err > smoke.TOL[dname]                # by design
            print(f"[ab] {name} {what}: {tag} max|err| {err:.3e}", flush=True)
        # in turns: SDPA, the others, the layouts, this, this, the layouts
        # and the others reversed, SDPA
        order = ("sdpa", *built, *forced, "this", "this", *reversed(forced),
                 *reversed(built), "sdpa")
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
            (q.numel() + k.numel() + v.numel() + B * S * H * Dv)
            * q.element_size(), 2 * B * H * (D + Dv) * pairs, dname)
        fmt = lambda xs, f: ", ".join("not measured" if x is None else f(x)
                                      for x in xs)
        for tag in ("this", *forced, *built, "sdpa"):
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
            if reader is not None and tag in PHASES:
                print(f"[ab] {name} {tag}: "
                      f"{phase_report(torch, reader, fns[tag], tag)}",
                      flush=True)
        del q, k, v, qt, kt, vt, fns, forced, ref
        torch.cuda.empty_cache()
    print(f"[done] {'every checked output within its tolerance' if not bad else f'{bad} FAILED'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
