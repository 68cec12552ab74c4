#!/usr/bin/env python3
"""Time ragged decode's kernels against each other in turns, on one card,
at the serves' head shapes; or probes of them, a copy of this tree's
source with clock64 stamps around each phase.

    python3 tools/decode_ab.py [--cases llama nemo ...] [--kernels cores tc]
    python3 tools/decode_ab.py --probe cores tc n8 [--sass] [--cases ...]
    python3 tools/decode_ab.py --variants w4 w8 [--other _scratch/parent]
    python3 tools/decode_ab.py --dtype float32 [--kernels cores n8_tf32]
        [--variants t-w2 t-s2 t-w8s2] [--probe n8_tf32]

Kernels (``--kernels``, each called through its C entry on the same
inputs, whatever route ``decode_route`` would pick):

  cores    ``ragged_decode_split_kernel`` (``_launch_split``: the CUDA
           cores, split over the context, the last CTA of a row merging
           the spans' float32 partials)
  tc       ``ragged_decode_tc_kernel`` (``_launch_tc``: the heads of a kv
           group one m16 tile of ``mma.sync``, a cluster merge), also at
           G <= 8, where its m16 tile holds G live rows
  n8       ``ragged_decode_n8_kernel`` (``_launch_n8``: bf16 at G <= 8, the
           heads the n8 side of ``mma.sync``, 16 keys its m16, a ring and
           an online softmax a warp, a cluster merge)
  n8_tf32  ``ragged_decode_n8_tf32_kernel`` (``_launch_n8_tf32``: float32
           at G <= 8, the n8 layout with every product as three TF32
           products of ``mma.sync`` m16n8k8)

A kernel runs only on the cases it takes: ``tc`` and ``n8`` bf16 ones
(``n8`` at G <= 8, D 64 or 128), ``n8_tf32`` float32 ones at G <= 8, D 64
or 128, ``cores`` every case. Without ``--kernels``: cores, tc and n8 in
bf16; cores and n8_tf32 in float32.

Cases, in ``--dtype`` (bfloat16 by default, or float32), with
``chip_smoke.py``'s inputs (``kernel_decode``):

  llama    q (8, 32, 64) over a slot arena (512, 1024, 8, 64), the
           smoke's first decode case (lengths 1 ... 1024, one padding row)
  nemo     the same at D 128: q (8, 32, 128) over (512, 1024, 8, 128)
  granite  the same at G 3: q (8, 24, 64)
  llama-one, llama-ctx64  the smoke's other two decode cases at llama's
           heads: one row of 1024 (B 1), and B 8 under a context bound of
           64
  qwen, internvl, musicgen  the same at qwen2.5-32b's heads (40 / 8 of
           128, G 5), internvl2-26b's (48 / 8 of 128, G 6) and
           musicgen-large's (32 / 32 of 64, G 1); no serve runs them on
           the card
  llama-legacy3  q (3, 32, 64) over a (3, 256, 8, 64) stack, no slots (the
           legacy engine's decode), lengths 1, 256, 133
  llama-legacy7  the same at B 7
  llama-long  q (128, 32, 64) over (128, 32768, 8, 64), every row 32768
           long (llama's decode_32k)
  serve    recurrentgemma-9b's heads (G 16, D 256): q (8, 16, 256) over a
           slot arena (512, 1024, 1, 256)
  legacy3, legacy7  q (B, 16, 256) over a (B, 256, 1, 256) stack, no slots
  long     q (128, 16, 256) over (128, 2048, 1, 256), every row 2048 long

Per case: each kernel's output against ``ragged_decode_attention_plain``
(2e-2 in bf16, 2e-5 in float32); then, in turns (the kernels in order,
then in reverse order): CUDA-event medians with the L2 flushed, the
profiler's device time per call (L2 warm) and the host's cost per call, by
``chip_smoke.py``'s own timers; the plain version's and SDPA's (the
smoke's yardstick over the gathered, head-repeated rows) device time; the
bound and each kernel's share of it. ptxas's report for both kernels comes
first, then the tensor-core kernel's registers, spill bytes, CTAs an SM,
shared memory and clusters of 8 held at once at each head dim
(``tc_info``).

``--probe KERNEL ...`` builds one copy of this tree's ``csrc/`` into
``build/decode_ab/`` whose kernels add, on thread 0 of every CTA, clock64
cycles of each phase into device arrays that ``repro_probe_*_cycles``
read (and zero), and runs each probed kernel once per case. ``tc``: per
tile the wait for its loads (the first tile's apart), the next tile's
issue, S on the tensor cores, the barrier after S, the softmax and P·V;
per CTA the prologue (Q and the first issues), the loop, (m, l, O) into
shared memory, the first cluster barrier, the merge over the cluster and
the second cluster barrier. ``n8``: per sub-tile of warp 0 the wait for
its loads (the first's apart), the next sub-tile's issue, S^T, the
softmax with P's packing, P·V; per CTA the prologue (lengths, slots, Q,
the first issues), the loop over warp 0's sub-tiles, the warps' states
and their merge with a peer's stores into CTA 0, CTA 0's wait for its
peers' bytes and its merge; the CTAs that exit at once apart.
``n8_tf32``: per sub-tile of warp 0 the wait for its loads (the first's
apart), the next sub-tile's issue, S^T (K's ldmatrix and split, three
products a k step), the softmax, P^T's shuffles and split, P·V (V's loads
and split, three products); per CTA as ``n8``.
``cores``: per CTA with rows the prologue (lengths, the exit test,
slots), Q into registers, the loop over its
rows (warp 0's), the warp merge and the write of the output or the
span's partial (with the wait for the other warps), the fence and the
arrival count, and the last CTA's merge of the partials; the CTAs that
exit at once apart. The atomics slow the kernels a little; outputs are
checked like the kernels'. With ``--sass`` it also prints, from the probe
library's SASS of the tensor-core kernel at D 256, the instructions
between consecutive clock reads: how many, and how many are exponentials
(MUFU), tensor-core products (HMMA), shared-memory matrix loads (LDSM),
async copies (LDGSTS) and branches (BRA). ``--variants w4 w8`` also
builds other layouts of the n8 kernel from substituted copies (``w4``:
four warps a CTA at both widths, rings of 6 stages at D 64; ``w8``: eight
warps at both widths, one CTA an SM at D 128) and times them in the same
turns, with this tree's plan; ``t-w2``, ``t-s2`` and ``t-w8s2`` the
float32 kernel's (two warps a CTA; two stages a warp; eight warps of two
stages at D 64). ``--other DIR`` builds another checkout's
``ragged_decode_attn.cu`` (e.g. the parent commit unpacked by ``git
archive`` into the ignored ``_scratch/``) and times its kernels
(``--other-kernels``, n8 by default) in the same turns, with this tree's
plans. ``--cluster N ...`` also times the tensor-core kernel (and
``--n8-cluster N ...`` the n8 kernel) at clusters of up to N CTAs, one
span of whole tiles a CTA.

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
CASES = ("llama", "nemo", "granite", "llama-one", "llama-ctx64",
         "llama-legacy3", "llama-legacy7", "llama-long", "qwen", "internvl",
         "musicgen", "serve", "legacy3", "legacy7", "long")
# kernel: (launcher in kernels/ragged_decode_attn.py, C entry, symbols)
KERNELS = {
    "cores": ("_launch_split", "repro_ragged_decode_attention",
              ("ragged_decode_split_kernel",)),
    "tc": ("_launch_tc", "repro_ragged_decode_tc",
           ("ragged_decode_tc_kernel",)),
    "n8": ("_launch_n8", "repro_ragged_decode_n8",
           ("ragged_decode_n8_kernel",)),
    "n8_tf32": ("_launch_n8_tf32", "repro_ragged_decode_n8_tf32",
                ("ragged_decode_n8_tf32_kernel",)),
}
# the part of ragged_decode_attn.cu a substitution scoped to a kernel
# applies to (its namespace; the n8 kernels share much text)
REGIONS = {"n8": ("namespace n8 {\n", "}  // namespace n8\n"),
           "n8_tf32": ("namespace n8t {\n", "}  // namespace n8t\n")}
LONG_LLAMA = (32768,) * 128    # llama's decode_32k: B 128, every row full

PROBE_HEAD = (
    "namespace tc {\n\n"
    "__device__ unsigned long long probe_cycles[24];\n"
    "__device__ void probe_add(int i, long long v) {\n"
    "  atomicAdd(&probe_cycles[i], (unsigned long long)v);\n}\n")


def reader(array: str, symbol: str, n: int) -> str:
    """C text of an entry that copies ``array``'s ``n`` counters out and
    zeroes them."""
    return (f"\nextern \"C\" int {symbol}(unsigned long long* host) {{\n"
            f"  cudaError_t e = cudaMemcpyFromSymbol(host, {array},\n"
            f"      sizeof(unsigned long long) * {n});\n"
            f"  if (e == cudaSuccess) {{\n"
            f"    unsigned long long zero[{n}] = {{0}};\n"
            f"    e = cudaMemcpyToSymbol({array}, zero, sizeof(zero));\n"
            f"  }}\n  return (int)e;\n}}\n")


# (text of ragged_decode_attn.cu, its replacement), per probed kernel: each
# text must be there once
PROBES = {"tc": [
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
], "n8": [(old, new, "n8") for old, new in [
    ("template <int D>\n__global__ void __launch_bounds__(Cfg<D>::kThreads, "
     "2)\nragged_decode_n8_kernel(",
     "__device__ unsigned long long n8_cycles[24];\n"
     "__device__ void n8_add(int i, long long v) {\n"
     "  atomicAdd(&n8_cycles[i], (unsigned long long)v);\n}\n\n"
     "template <int D>\n__global__ void __launch_bounds__(Cfg<D>::kThreads, "
     "2)\nragged_decode_n8_kernel("),
    ("  extern __shared__ __align__(128) unsigned char smem[];\n"
     "  const uint32_t base = tc::smem_addr(smem);\n",
     "  extern __shared__ __align__(128) unsigned char smem[];\n"
     "  const uint32_t base = tc::smem_addr(smem);\n"
     "  const long long k0 = clock64();\n"),
    ("  if (c >= n_act) return;\n",
     "  if (c >= n_act) {\n"
     "    if (tid == 0) { n8_add(20, clock64() - k0); n8_add(21, 1); }\n"
     "    return;\n  }\n"),
    ("  float m[2] = {-1e30f, -1e30f};   // heads 2t and 2t + 1\n",
     "  const long long k1 = clock64();\n"
     "  float m[2] = {-1e30f, -1e30f};   // heads 2t and 2t + 1\n"),
    ("  for (int j = 0; j < n_w; ++j) {\n"
     "    tc::cp_async_wait<C::kStages - 2>();\n",
     "  for (int j = 0; j < n_w; ++j) {\n"
     "    const long long c0 = clock64();\n"
     "    tc::cp_async_wait<C::kStages - 2>();\n"),
    ("    __syncwarp();\n    issue(j + C::kStages - 1);\n",
     "    __syncwarp();\n    const long long c1 = clock64();\n"
     "    issue(j + C::kStages - 1);\n    const long long c2 = clock64();\n"),
    ("    // base-2 exponents; keys past the sub-tile's rows -inf\n",
     "    const long long c3 = clock64();\n"
     "    // base-2 exponents; keys past the sub-tile's rows -inf\n"),
    ("    // 3. O^T += V^T . P^T, P as hi + lo: lane (g, t) holds P of key g "
     "(and\n",
     "    const long long c4 = clock64();\n"
     "    // 3. O^T += V^T . P^T, P as hi + lo: lane (g, t) holds P of key g "
     "(and\n"),
    ("      tc::mma(o[mt], a, bl0, bl1);\n    }\n  }\n",
     "      tc::mma(o[mt], a, bl0, bl1);\n    }\n"
     "    if (tid == 0) {\n      const long long c5 = clock64();\n"
     "      n8_add(0, c1 - c0); n8_add(1, c2 - c1); n8_add(2, c3 - c2);\n"
     "      n8_add(3, c4 - c3); n8_add(4, c5 - c4); n8_add(6, 1);\n"
     "      if (j == 0) { n8_add(7, c1 - c0); n8_add(8, 1); }\n"
     "    }\n  }\n  const long long k2 = clock64();\n"),
    ("  if (n_act == 1 || c > 0) return;   // a peer's stores land on "
     "their own\n",
     "  const long long k3 = clock64();\n"
     "  if (tid == 0) {\n"
     "    n8_add(9, k1 - k0); n8_add(10, k2 - k1); n8_add(11, k3 - k2);\n"
     "    n8_add(16, 1); if (n_act == 1 || c > 0) n8_add(18, k3 - k0);\n"
     "    if (n_act > 1 && c > 0) n8_add(19, 1);\n  }\n"
     "  if (n_act == 1 || c > 0) return;   // a peer's stores land on "
     "their own\n"),
    ("  wait_cluster(bar, 0);\n",
     "  wait_cluster(bar, 0);\n  const long long k5 = clock64();\n"),
    ("        make_uint2(tc::bits(o01), tc::bits(o23));\n  }\n}\n",
     "        make_uint2(tc::bits(o01), tc::bits(o23));\n  }\n"
     "  if (tid == 0) {\n    const long long k6 = clock64();\n"
     "    n8_add(13, k5 - k3); n8_add(14, k6 - k5); n8_add(22, 1);\n"
     "    n8_add(18, k6 - k0);\n  }\n}\n"),
]], "n8_tf32": [(old, new, "n8_tf32") for old, new in [
    ("template <int D>\n__global__ void __launch_bounds__(Cfg<D>::kThreads, "
     "2)\nragged_decode_n8_tf32_kernel(",
     "__device__ unsigned long long n8t_cycles[24];\n"
     "__device__ void n8t_add(int i, long long v) {\n"
     "  atomicAdd(&n8t_cycles[i], (unsigned long long)v);\n}\n\n"
     "template <int D>\n__global__ void __launch_bounds__(Cfg<D>::kThreads, "
     "2)\nragged_decode_n8_tf32_kernel("),
    ("  extern __shared__ __align__(128) unsigned char smem[];\n"
     "  const uint32_t base = tc::smem_addr(smem);\n",
     "  extern __shared__ __align__(128) unsigned char smem[];\n"
     "  const uint32_t base = tc::smem_addr(smem);\n"
     "  const long long k0 = clock64();\n"),
    ("  if (c >= n_act) return;\n",
     "  if (c >= n_act) {\n"
     "    if (tid == 0) { n8t_add(20, clock64() - k0); n8t_add(21, 1); }\n"
     "    return;\n  }\n"),
    ("  float m[2] = {-1e30f, -1e30f};   // heads 2t and 2t + 1\n",
     "  const long long k1 = clock64();\n"
     "  float m[2] = {-1e30f, -1e30f};   // heads 2t and 2t + 1\n"),
    ("  for (int j = 0; j < n_w; ++j) {\n",
     "  for (int j = 0; j < n_w; ++j) {\n"
     "    const long long c0 = clock64();\n"),
    ("    __syncwarp();\n    issue(j + C::kStages - 1);\n",
     "    __syncwarp();\n    const long long c1 = clock64();\n"
     "    issue(j + C::kStages - 1);\n    const long long c2 = clock64();\n"),
    ("    // base-2 exponents; keys past the sub-tile's rows -inf\n",
     "    const long long c3 = clock64();\n"
     "    // base-2 exponents; keys past the sub-tile's rows -inf\n"),
    ("    // 3. P^T's B fragments of k steps kk = 0, 1 (keys 0 .. 7, 8 .. "
     "15):\n",
     "    const long long c4 = clock64();\n"
     "    // 3. P^T's B fragments of k steps kk = 0, 1 (keys 0 .. 7, 8 .. "
     "15):\n"),
    ("    // 4. O^T += V^T . P^T: per k step, lane (g, t) loads columns 32 p "
     "+ 4g\n",
     "    const long long c5 = clock64();\n"
     "    // 4. O^T += V^T . P^T: per k step, lane (g, t) loads columns 32 p "
     "+ 4g\n"),
    ("        mma(o[mt], vh[mt], ph[kk][0], ph[kk][1]);\n    }\n  }\n",
     "        mma(o[mt], vh[mt], ph[kk][0], ph[kk][1]);\n    }\n"
     "    if (tid == 0) {\n      const long long c6 = clock64();\n"
     "      n8t_add(0, c1 - c0); n8t_add(1, c2 - c1); n8t_add(2, c3 - c2);\n"
     "      n8t_add(3, c4 - c3); n8t_add(4, c5 - c4); n8t_add(5, c6 - c5);\n"
     "      n8t_add(6, 1);\n"
     "      if (j == 0) { n8t_add(7, c1 - c0); n8t_add(8, 1); }\n"
     "    }\n  }\n  const long long k2 = clock64();\n"),
    ("  if (n_act == 1 || c > 0) return;   // a peer's stores land on "
     "their own\n",
     "  const long long k3 = clock64();\n"
     "  if (tid == 0) {\n"
     "    n8t_add(9, k1 - k0); n8t_add(10, k2 - k1); n8t_add(11, k3 - k2);\n"
     "    n8t_add(16, 1); if (n_act == 1 || c > 0) n8t_add(18, k3 - k0);\n"
     "    if (n_act > 1 && c > 0) n8t_add(19, 1);\n  }\n"
     "  if (n_act == 1 || c > 0) return;   // a peer's stores land on "
     "their own\n"),
    ("  n8::wait_cluster(bar, 0);\n",
     "  n8::wait_cluster(bar, 0);\n  const long long k5 = clock64();\n"),
    ("        make_float4(a.x / den, a.y / den, a.z / den, a.w / den);\n"
     "  }\n}\n",
     "        make_float4(a.x / den, a.y / den, a.z / den, a.w / den);\n"
     "  }\n"
     "  if (tid == 0) {\n    const long long k6 = clock64();\n"
     "    n8t_add(13, k5 - k3); n8t_add(14, k6 - k5); n8t_add(22, 1);\n"
     "    n8t_add(18, k6 - k0);\n  }\n}\n"),
]], "cores": [
    ("template <typename E, int D, int GC>\n__global__ void "
     "__launch_bounds__(kThreads)\nragged_decode_split_kernel(",
     "__device__ unsigned long long split_cycles[16];\n"
     "__device__ void split_add(int i, long long v) {\n"
     "  atomicAdd(&split_cycles[i], (unsigned long long)v);\n}\n\n"
     "template <typename E, int D, int GC>\n__global__ void "
     "__launch_bounds__(kThreads)\nragged_decode_split_kernel("),
    ("  const int r = lane / LPR;        // row within the warp's load\n",
     "  const int r = lane / LPR;        // row within the warp's load\n"
     "  const long long k0 = clock64();\n"),
    ("  if (split >= n_active) return;\n",
     "  if (split >= n_active) {\n"
     "    if (tid == 0) { split_add(8, clock64() - k0); split_add(9, 1); }\n"
     "    return;\n  }\n"),
    ("  for (int g0 = 0; g0 < G; g0 += GC) {\n    float qr[GC][EPL],",
     "  const long long k1 = clock64();\n"
     "  long long p_q = 0, p_loop = 0, p_write = 0;\n"
     "  for (int g0 = 0; g0 < G; g0 += GC) {\n"
     "    const long long za = clock64();\n    float qr[GC][EPL],"),
    ("    // this lane's rows: t_begin + (it * kWarps + warp) * RPW + r\n",
     "    const long long zb = clock64();\n"
     "    // this lane's rows: t_begin + (it * kWarps + warp) * RPW + r\n"),
    ("    // merge the row groups of the warp (lanes with the same chunk c)\n",
     "    const long long zc = clock64();\n"
     "    // merge the row groups of the warp (lanes with the same chunk c)\n"),
    ("    __syncthreads();\n  }\n  if (n_active == 1) return;\n",
     "    __syncthreads();\n"
     "    const long long zd = clock64();\n"
     "    p_q += zb - za; p_loop += zc - zb; p_write += zd - zc;\n  }\n"
     "  const long long k2 = clock64();\n"
     "  if (tid == 0) {\n"
     "    split_add(0, k1 - k0); split_add(1, p_q); split_add(2, p_loop);\n"
     "    split_add(3, p_write); split_add(6, 1);\n"
     "    split_add(12, t_end - t_begin);\n"
     "    if (n_active == 1) split_add(11, k2 - k0);\n  }\n"
     "  if (n_active == 1) return;\n"),
    ("  if (!s_last) return;\n",
     "  const long long k3 = clock64();\n"
     "  if (tid == 0) {\n"
     "    split_add(4, k3 - k2); split_add(7, 1);\n"
     "    if (!s_last) split_add(11, k3 - k0);\n  }\n"
     "  if (!s_last) return;\n"),
    ("  if (tid == 0) counters[group] = 0;\n}\n",
     "  if (tid == 0) {\n    counters[group] = 0;\n"
     "    const long long k4 = clock64();\n"
     "    split_add(5, k4 - k3); split_add(10, 1); split_add(11, k4 - k0);\n"
     "  }\n}\n"),
]}
# other layouts of the n8 kernels, built from substituted copies and timed
# beside them (``--variants``), each (its route, the substitutions): w4,
# four warps a CTA at both widths with rings of 6 stages at D 64 (96 KB a
# CTA); w8, eight warps at both widths (at D 128 192 KB, one CTA an SM);
# of the float32 kernel, t-w2: two warps a CTA (48 KB at D 64, 96 KB and
# two CTAs an SM at D 128); t-s2: two stages a warp (64 KB, 128 KB);
# t-w8s2: at D 64 eight warps of two stages (128 KB, one CTA an SM). The
# plans stay this tree's.
_T_WARPS = "  static constexpr int kWarps = 4;\n"
_T_STAGES = "  static constexpr int kStages = 3;           // a warp's ring\n"
VARIANTS = {
    "w4": ("n8", [("  static constexpr int kWarps = D == 64 ? 8 : 4;\n",
                   "  static constexpr int kWarps = 4;\n"),
                  ("  static constexpr int kStages = 3;\n",
                   "  static constexpr int kStages = D == 64 ? 6 : 3;\n")]),
    "w8": ("n8", [("  static constexpr int kWarps = D == 64 ? 8 : 4;\n",
                   "  static constexpr int kWarps = 8;\n")]),
    "t-w2": ("n8_tf32", [
        (_T_WARPS, "  static constexpr int kWarps = 2;\n", "n8_tf32")]),
    "t-s2": ("n8_tf32", [
        (_T_STAGES, "  static constexpr int kStages = 2;\n", "n8_tf32")]),
    "t-w8s2": ("n8_tf32", [
        (_T_WARPS, "  static constexpr int kWarps = D == 64 ? 8 : 4;\n",
         "n8_tf32"),
        (_T_STAGES, "  static constexpr int kStages = D == 64 ? 2 : 3;\n",
         "n8_tf32")]),
}
# per probed kernel: (its counters, how many, the reader's C entry)
READERS = {"tc": ("tc::probe_cycles", 24, "repro_probe_tc_cycles"),
           "n8": ("n8::n8_cycles", 24, "repro_probe_n8_cycles"),
           "n8_tf32": ("n8t::n8t_cycles", 24, "repro_probe_n8_tf32_cycles"),
           "cores": ("split_cycles", 16, "repro_probe_split_cycles")}
# per probed kernel: (slot of the cycles, slot of its count, label)
PHASES = {
    "tc": ((0, 6, "wait for the tile's loads (every tile)"),
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
           (18, 16, "whole CTA (per CTA)")),
    "n8": ((0, 6, "wait for the sub-tile's loads (every sub-tile)"),
           (7, 8, "wait for the sub-tile's loads (first sub-tile)"),
           (1, 6, "issue the next sub-tile"), (2, 6, "S^T on the tensor cores"),
           (3, 6, "softmax and P's packing"),
           (4, 6, "P.V on the tensor cores"),
           (9, 16, "prologue (lengths, slots, Q, first issues) (per CTA)"),
           (10, 16, "loop over warp 0's sub-tiles (per CTA)"),
           (11, 16, "the warps' states, their merge and a peer's "
                    "stores into CTA 0 (per CTA)"),
           (13, 22, "CTA 0 of a cluster: the wait for its peers"),
           (14, 22, "CTA 0 of a cluster: the merge and the stores"),
           (18, 16, "whole CTA (per CTA with rows)"),
           (20, 21, "CTAs without rows, until their exit")),
    "n8_tf32": ((0, 6, "wait for the sub-tile's loads (every sub-tile)"),
                (7, 8, "wait for the sub-tile's loads (first sub-tile)"),
                (1, 6, "issue the next sub-tile"),
                (2, 6, "S^T: K's ldmatrix and split, three TF32 products "
                       "a k step"),
                (3, 6, "softmax"),
                (4, 6, "P^T's shuffles and split"),
                (5, 6, "P.V: V's loads and split, three TF32 products"),
                (9, 16, "prologue (lengths, slots, Q, first issues, Q's "
                        "split) (per CTA)"),
                (10, 16, "loop over warp 0's sub-tiles (per CTA)"),
                (11, 16, "the warps' states, their merge and a peer's "
                         "stores into CTA 0 (per CTA)"),
                (13, 22, "CTA 0 of a cluster: the wait for its peers"),
                (14, 22, "CTA 0 of a cluster: the merge and the stores"),
                (18, 16, "whole CTA (per CTA with rows)"),
                (20, 21, "CTAs without rows, until their exit")),
    "cores": ((0, 6, "prologue: lengths, the exit test, slots"),
              (1, 6, "Q into registers"),
              (2, 6, "the loop over the span's rows (warp 0)"),
              (3, 6, "warp merge and output or partial write (with the "
                     "wait for the other warps)"),
              (4, 7, "fence and arrival count (rows of several spans)"),
              (5, 10, "the last CTA's merge of the partials"),
              (11, 6, "whole CTA"),
              (8, 9, "CTAs past the row's length, until their exit")),
}
# per probed kernel: the counts printed, (slot, label)
COUNTS = {"tc": ((6, "tiles"), (16, "CTAs"), (17, "tiles counted")),
          "n8": ((6, "sub-tiles of warp 0"), (16, "CTAs with rows"),
                 (19, "peers that pushed"), (22, "CTAs 0 that merged"),
                 (21, "CTAs without rows")),
          "n8_tf32": ((6, "sub-tiles of warp 0"), (16, "CTAs with rows"),
                      (19, "peers that pushed"), (22, "CTAs 0 that merged"),
                      (21, "CTAs without rows")),
          "cores": ((6, "CTAs with rows"), (9, "CTAs that exit at once"),
                    (7, "CTAs of rows with several spans"),
                    (10, "merges"), (12, "rows"))}


def build_copies(copies) -> dict:
    """``{tag: library}`` of substituted copies of a csrc/ (this tree's,
    or another checkout's), one nvcc each, all at once: ``copies`` maps a
    tag to its (old, new) substitutions, the text appended to
    ragged_decode_attn.cu and the csrc/ directory (None: this tree's). A
    substitution (old, new) must find ``old`` once in the file; (old, new,
    kernel) once in that kernel's ``REGIONS``."""
    from repro_torch.kernels import _build
    procs = {}
    for tag, (subs, tail, csrc) in copies.items():
        src_dir = OUT / f"{tag}-csrc"
        shutil.rmtree(src_dir, ignore_errors=True)
        shutil.copytree(csrc or _build.CSRC, src_dir)
        path = src_dir / "ragged_decode_attn.cu"
        text = path.read_text()
        for old, new, *region in subs:
            start, end = 0, len(text)
            if region:
                first, last = REGIONS[region[0]]
                start = text.index(first)
                end = text.index(last, start) + len(last)
            part = text[start:end]
            if part.count(old) != 1:
                where = f" ({region[0]})" if region else ""
                raise RuntimeError(f"{tag}: {old!r} is not in "
                                   f"ragged_decode_attn.cu{where} exactly "
                                   f"once")
            text = text[:start] + part.replace(old, new) + text[end:]
        path.write_text(text + tail)
        lib = OUT / f"libragged_decode_attn_{tag}.so"
        procs[tag] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(src_dir), "-o",
             str(lib), str(path)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        for line in ptxas_lines(log):
            print(f"[ptxas] {tag} {line}", flush=True)
        libs[tag] = lib
    return libs


def probe_copy(kernels):
    """The probe's substitutions, appended readers and csrc/ for
    ``kernels``."""
    subs = [sub for name in kernels for sub in PROBES[name]]
    tail = "".join(reader(READERS[n][0], READERS[n][2], READERS[n][1])
                   for n in kernels)
    return subs, tail, None


def sass_phases(lib: Path):
    """Instruction counts between the clock reads of the probe's
    tensor-core kernel at D 256, from its SASS."""
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
    """ptxas's registers and spills of the bf16 decode kernels (every
    instantiation of the tensor-core kernel; the CUDA-core kernel's bf16
    ones)."""
    kernel, lines = "?", []
    for line in log.splitlines():
        if "Function properties for" in line:
            kernel = line.split(" for ", 1)[1].strip()
        elif "ragged_decode_" in kernel and ("registers" in line
                                             or "spill" in line):
            if "split_kernel" not in kernel or "bfloat16" in kernel:
                lines.append(f"{kernel[-64:]}: {line.strip()}")
    return lines


def case(torch, K, smoke, name, dtype):
    """``chip_smoke.kernel_decode``'s case ``name`` in ``dtype``."""
    lens, slots, _ = smoke.DECODE_CASES[0]
    heads = {"llama": (32, 8, 64), "nemo": (32, 8, 128),
             "granite": (24, 8, 64), "qwen": (40, 8, 128),
             "internvl": (48, 8, 128), "musicgen": (32, 32, 64),
             "serve": (16, 1, 256)}
    if name in heads:
        H, KV, D = heads[name]
        return smoke.kernel_decode(torch, K, dtype, lens, slots, None, H=H,
                                   KV=KV, D=D)
    if name in ("llama-one", "llama-ctx64"):
        lens, slots, ctx = smoke.DECODE_CASES[1 if name == "llama-one"
                                              else 2]
        return smoke.kernel_decode(torch, K, dtype, lens, slots, ctx)
    if name == "long":
        return smoke.kernel_decode(torch, K, dtype, smoke.LONG_LENS, None,
                                   None, H=16, KV=1, D=256,
                                   T=smoke.LONG_LENS[0])
    if name == "llama-long":
        return smoke.kernel_decode(torch, K, dtype, LONG_LLAMA, None, None,
                                   T=LONG_LLAMA[0])
    stack = smoke.SLOTLESS_LENS[0 if name.endswith("3") else 1]
    H, KV, D = (32, 8, 64) if name.startswith("llama") else (16, 1, 256)
    return smoke.kernel_decode(torch, K, dtype, stack, None, None, H=H, KV=KV,
                               D=D, T=256)


def launcher(torch, RD, name, inputs):
    """``name``'s kernel through its launcher on ``inputs``."""
    q, k, v, lengths, slots, ctx = inputs
    fn = getattr(RD, KERNELS[name][0])
    return lambda: fn(q, k, v, lengths, slots, ctx)


def from_lib(torch, RD, dll, name, inputs):
    """``name``'s kernel from a library built here (the probe's, a
    variant's), planned and called as its launcher does."""
    from repro_torch.kernels import _build
    q, k, v, lengths, slots, ctx = inputs
    entry = getattr(dll, KERNELS[name][1])
    entry.argtypes = _build.SIGNATURES["ragged_decode_attn"][KERNELS[name][1]]
    entry.restype = ctypes.c_int
    B, H, D = q.shape
    N, T, KV = k.shape[:3]
    span = T if ctx is None else min(ctx, T)
    stream = lambda: torch.cuda.current_stream().cuda_stream

    if name in RD._PLANS:
        cluster, n_split, split_t = RD._PLANS[name](B, KV, D, span)

        def call():
            out = torch.empty_like(q)
            err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        lengths.data_ptr(), RD._ptr(slots), out.data_ptr(),
                        B, H, KV, D, N, T, span, n_split, split_t, cluster,
                        stream())
            if err:
                raise RuntimeError(f"probe {name}: CUDA error {err}")
            return out
        return call
    n_split, split_t = RD._plan(B, KV, span, None, RD.split_granule(D))
    G = H // KV
    n_part = B * KV * n_split * G if n_split > 1 else 0
    part_acc = torch.empty((n_part * D,), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((n_part * 2,), dtype=torch.float32,
                          device=q.device)
    counters = torch.zeros(max(B * KV, 64), dtype=torch.int32,
                           device=q.device)

    def call():
        out = torch.empty_like(q)
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    lengths.data_ptr(), RD._ptr(slots), out.data_ptr(),
                    part_acc.data_ptr(), part_ml.data_ptr(),
                    counters.data_ptr(), B, H, KV, D, N, T, n_split, split_t,
                    _build.dtype_code(q.dtype), stream())
        if err:
            raise RuntimeError(f"probe {name}: CUDA error {err}")
        return out
    return call


def clustered(torch, RD, _build, inputs, n, route="tc"):
    """A tensor-core kernel (``route`` "tc", "n8" or "n8_tf32") through its
    C entry at clusters of up to ``n`` CTAs, one span of whole tiles a
    CTA."""
    q, k, v, lengths, slots, ctx = inputs
    B, H, D = q.shape
    N, T, KV = k.shape[:3]
    span = T if ctx is None else min(ctx, T)
    tile = {"tc": RD.tc_tile_rows(D), "n8": 16 * RD.n8_warps(D),
            "n8_tf32": 16 * RD.N8_TF32_WARPS}[route]
    split_t = -(-(-(-span // n)) // tile) * tile
    n_split = -(-span // split_t)
    fn = _build.function("ragged_decode_attn",
                         f"repro_ragged_decode_{route}")

    def call():
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                 RD._ptr(slots), out.data_ptr(), B, H, KV, D, N, T, span,
                 n_split, split_t, min(n, n_split),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err} at launch (clusters of "
                               f"{min(n, n_split)})")
        return out
    return call


def takes(RD, kernel: str, bf16: bool, G: int, D: int) -> bool:
    """Whether ``kernel`` runs on a case of that dtype and shape."""
    n8 = G <= RD.N8_MAX_GROUP and D in RD.N8_HEAD_DIMS
    return {"cores": True, "tc": bf16, "n8": bf16 and n8,
            "n8_tf32": not bf16 and n8}[kernel]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--kernels", nargs="+", default=None,
                    choices=list(KERNELS),
                    help="the kernels timed in turns, in this order and "
                         "then in reverse (default: cores, tc, n8 in "
                         "bfloat16; cores, n8_tf32 in float32)")
    ap.add_argument("--probe", nargs="*", default=None,
                    choices=list(PROBES),
                    help="also run the phase probes of these kernels "
                         "(all without a name)")
    ap.add_argument("--sass", action="store_true",
                    help="with --probe tc: the probe's SASS counts per "
                         "phase")
    ap.add_argument("--variants", nargs="*", default=(),
                    choices=list(VARIANTS),
                    help="also time these layouts of the n8 kernels")
    ap.add_argument("--other", type=Path, default=None,
                    help="another checkout (e.g. the parent commit, "
                         "unpacked by git archive): also time its kernels")
    ap.add_argument("--other-kernels", nargs="+", default=["n8"],
                    choices=list(KERNELS),
                    help="with --other: which of its kernels")
    ap.add_argument("--cases", nargs="+", default=list(CASES),
                    choices=CASES)
    ap.add_argument("--cluster", type=int, nargs="*", default=(),
                    help="also time the tensor-core kernel at clusters of "
                         "these many CTAs (up to 8), one span a CTA")
    ap.add_argument("--n8-cluster", type=int, nargs="*", default=(),
                    help="the same for the n8 kernel (the float32 one in "
                         "float32)")
    args = ap.parse_args()
    import torch
    dtype = getattr(torch, args.dtype)
    bf16 = dtype == torch.bfloat16
    tol = 2e-2 if bf16 else 2e-5
    if args.kernels is None:
        args.kernels = ["cores", "tc", "n8"] if bf16 else ["cores",
                                                           "n8_tf32"]
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
    for D in RD.N8_HEAD_DIMS:
        print(f"[info] ragged_decode_n8_kernel<{D}>: "
              f"{RD.tc_info(D, 'n8')}", flush=True)
        print(f"[info] ragged_decode_n8_tf32_kernel<{D}>: "
              f"{RD.tc_info(D, 'n8_tf32')}", flush=True)
    probes = [] if args.probe is None else (args.probe or list(PROBES))
    copies = {v: (VARIANTS[v][1], "", None) for v in args.variants}
    if probes:
        copies["probe"] = probe_copy(probes)
    if args.other is not None:
        copies["other"] = ([], "", args.other / "src" / "repro_torch"
                           / "csrc")
    OUT.mkdir(parents=True, exist_ok=True)
    libs = {tag: ctypes.PyDLL(str(lib))
            for tag, lib in build_copies(copies).items()}
    dll = libs.get("probe")
    if args.sass and "tc" in probes:
        sass_phases(OUT / "libragged_decode_attn_probe.so")
    bad = 0
    for name in args.cases:
        r = case(torch, K, smoke, name, dtype)
        inputs = r["inputs"]
        fns = {}
        G = inputs[0].shape[1] // inputs[1].shape[2]
        D = inputs[0].shape[2]
        fit = lambda kn: takes(RD, kn, bf16, G, D)
        sweep = [("tc", n) for n in args.cluster if bf16] + [
            ("n8" if bf16 else "n8_tf32", n) for n in args.n8_cluster
            if fit("n8" if bf16 else "n8_tf32")]
        for route, n in sweep:
            fns[f"{route}@{n}"] = clustered(torch, RD, _build, inputs, n,
                                            route)
        kernels = [kn for kn in args.kernels if fit(kn)]
        fns.update({kn: launcher(torch, RD, kn, inputs) for kn in kernels})
        for v in args.variants:
            route = VARIANTS[v][0]
            if fit(route):
                fns[f"{route}:{v}"] = from_lib(torch, RD, libs[v], route,
                                               inputs)
                kernels.append(f"{route}:{v}")
        for kn in args.other_kernels if args.other is not None else ():
            if fit(kn):
                fns[f"{kn}:other"] = from_lib(torch, RD, libs["other"], kn,
                                              inputs)
                kernels.append(f"{kn}:other")
        for kn in probes:
            if fit(kn):
                fns[f"probe-{kn}"] = from_lib(torch, RD, dll, kn, inputs)
        what = f"{args.dtype} {r['shape']}"
        ref = r["ref"]
        for tag, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            ok = torch.allclose(got.float(), ref.float(), rtol=tol,
                                atol=tol)
            bad += not ok
            print(f"[ab] {name} {what}: {tag} max|err| {err:.3e}"
                  f"{'' if ok else '  DISAGREES'}", flush=True)
        for kn in probes:
            if f"probe-{kn}" not in fns:
                continue
            array, n_slots, symbol = READERS[kn]
            read = getattr(dll, symbol)
            read.argtypes = [ctypes.c_void_p]
            read.restype = ctypes.c_int
            buf = (ctypes.c_ulonglong * n_slots)()
            read(ctypes.addressof(buf))
            fns[f"probe-{kn}"]()
            torch.cuda.synchronize()
            if read(ctypes.addressof(buf)):
                raise RuntimeError(f"{symbol} failed")
            print(f"[probe] {name} {kn}: " + ", ".join(
                      f"{buf[i]} {label}" for i, label in COUNTS[kn])
                  + "; cycles (thread 0 of each CTA): " + ", ".join(
                      f"{label} {buf[i] / max(buf[n], 1):.0f}"
                      for i, n, label in PHASES[kn]), flush=True)
        res = {kn: {"events": [], "device": [], "host": []}
               for kn in kernels}
        for kn in [*kernels, *reversed(kernels)]:
            out = res[kn]
            out["events"].append(smoke.cuda_ms(torch, fns[kn]))
            dev, _, missing = smoke.device_ms(
                torch, fns[kn], f"{kn} {what}",
                symbols=KERNELS[kn.split(":")[0]][2])
            out["device"].append(dev)
            out["host"].append(smoke.host_us(torch, fns[kn]))
        kernel_fn, plain_fn, lib_fn = r["fns"]
        dev_plain, _, _ = smoke.device_ms(torch, plain_fn, f"plain {what}")
        dev_lib, _, _ = smoke.device_ms(torch, lib_fn, f"SDPA {what}")
        ev_lib = smoke.cuda_ms(torch, lib_fn)
        b_ms, b_by = smoke.bound(r["bytes"], r["flops"], args.dtype)
        fmt = lambda xs, f: ", ".join("not measured" if v is None else f(v)
                                      for v in xs)

        def mean(xs):
            xs = [v for v in xs if v is not None]
            return sum(xs) / len(xs) if xs else None
        base = mean(res[kernels[0]]["device"])
        for kn in kernels:
            out = res[kn]
            m = mean(out["device"])
            share = ("not measured" if m is None
                     else f"{100 * b_ms / m:.1f}%")
            vs = ("not measured" if m is None or dev_lib is None
                  else f"{m / dev_lib:.2f}x")
            rel = ("" if kn == kernels[0] or m is None or base is None
                   else f"; {base / m:.2f}x faster than {kernels[0]}")
            print(f"[time] {name} {what}: {kn} device "
                  f"{fmt(out['device'], lambda v: f'{v:.4f}')} ms, events "
                  f"{fmt(out['events'], lambda v: f'{v:.4f}')} ms, host "
                  f"{fmt(out['host'], lambda v: f'{v:.1f}')} us; bound "
                  f"{b_ms * 1e3:.2f} us ({b_by}), device at {share} of it; "
                  f"{vs} SDPA's device time{rel}", flush=True)
        show = lambda v: "not measured" if v is None else f"{v:.4f} ms"
        for route, n in sweep:
            tag = f"{route}@{n}"
            devs = [smoke.device_ms(torch, fns[tag], f"{tag} {what}",
                                    symbols=KERNELS[route][2])[0]
                    for _ in range(2)]
            print(f"[time] {name} {what}: {tag} ({route} at clusters of up "
                  f"to {n}) device {fmt(devs, lambda v: f'{v:.4f}')} ms",
                  flush=True)
        print(f"[time] {name} {what}: plain device {show(dev_plain)}; SDPA "
              f"device {show(dev_lib)}, events {show(ev_lib)}", flush=True)
        del r, fns, inputs, ref
        torch.cuda.empty_cache()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
