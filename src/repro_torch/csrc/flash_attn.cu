// Flash prefill attention: causal, with a query offset and an optional
// sliding window.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py
// (flash_attention, body _kernel). Query i of a (B, S, H, Dqk) block
// attends keys kpos <= q_offset + i (and kpos > q_offset + i - window when
// a window is given) of (B, T, KV, Dqk) keys and (B, T, KV, Dv) values
// with an online softmax (m, l, acc) in float32, its scores scaled by the
// caller's scale (1 / sqrt(Dqk)). KV may divide H: query head h reads KV
// head h / (H / KV), so the engine passes un-repeated GQA heads and no
// repeat_kv copy is ever materialized (KV == H is the TPU kernel's case).
//
// Head widths: each kernel is compiled at D = 32, 64, 128 and 256 for q
// and k, and runs at the smallest D that holds Dqk (Dv <= Dqk, both
// multiples of 8). Columns past Dqk of q and k and past Dv of v load as
// zeros, so they add nothing to a score or to the output, and only Dv
// columns are stored. The bf16 kernel also has a V width of its own, DV,
// the smallest of the same widths that holds Dv, and a compile-time count
// of Q K^T k slices: GQA passes Dqk == Dv == D (D / 16 slices); MLA's
// non-absorbed prefill (MiniCPM3: q and k 96 wide, v 64) runs the pair
// (128, 64) with 6 k slices of Q K^T and P V at N 64 into a 32-float
// accumulator, the work of 96 and 64 (its reduced() widths 48 / 32 run
// (64, 32) with 3); recurrentgemma-9b's local attention (16 q heads over 1
// kv head of 256, window 2048) runs (256, 256). The float32 kernels run V
// at the q/k width.
//
// Bound on the H100: at the serve's prefill buckets (S <= 512, D = 64) the
// bytes of q, k, v and the output; the causal half's 4 * B * H * D * S^2 / 2
// flops outweigh them on the tensor cores from S of about 700 (H 32, KV 8)
// in bfloat16, and from S of about 250 in float32, whose products cost
// three TF32 ones each.
//
// One C entry point, three kernels chosen by dtype and width (and at D =
// 256 in bfloat16 two layouts chosen by the grid):
//
// bfloat16 (what the serve runs): flash_tc_kernel<D, DV, KS, NC>, on the
// tensor cores, instantiated at the pairs (D, DV) = (32, 32), (64, 64), (128,
// 128), (256, 256), (128, 64), (64, 32), (256, 128) and (256, 64); any other
// pair is refused. One CTA per (q-tile of 64 rows, NC heads of a KV group,
// batch row) runs one consumer warpgroup per head, and every consumer reads
// each K/V tile the producer loads, so a tile serves NC * 64 query rows. NC
// is 4 at D = DV <= 64 (2 for G 2 and 3, 1 for G 1) and 1 at D = 128 (two
// heads a CTA lost in turns to one head with two CTAs an SM), at D = 256
// where the grid is small (below) and at the MLA pairs (two or four q-row
// tiles of one head a CTA lost in turns to one row tile with three CTAs an
// SM: the (128, 64) pair's CTA holds 66,600 bytes of shared memory and 160
// threads); a group of G > NC heads takes (G + NC - 1) / NC CTAs side by
// side, each loading the group's K/V tiles, mostly from L2. A producer warp
// streams K and V tiles by TMA (cp.async.bulk.tensor through 4-D tensor maps
// (B, T, KV, width) with a box of (1, 64, 1, <= 64 columns: two boxes per
// row of a tile at D = 128, four at D = 256), so rows t >= T of a batch row
// and columns past a head's width read as zeros; V's map is DV wide) into a
// ring of 2-4 stages with mbarrier completion: tile j + 1 loads while tile j
// computes. Each consumer warpgroup loads its Q tile by TMA, forms S = Q K^T
// with wgmma m64n64k16 (both operands K-major from shared memory, 128-byte
// swizzle for 64-column atoms (two at D = 128, four at 256), 64-byte
// swizzle for D = 32, the same swizzle in the tensor map and the
// descriptor), runs the online softmax on the float32 accumulator fragment
// (row max and sum over the four lanes that share a row), re-packs P as
// bf16 A-operand registers and adds P V with a second wgmma m64nDVk16 whose
// B operand is the V tile read MN-major (the transposed-B form). Tiles above
// the causal diagonal and below the window are never loaded; only the tiles
// that cross a bound or the T tail are masked. Output rows past S and
// columns past Dv are not stored. Each row's result depends on its q, its
// keys and its position only (no split over keys), so batched and isolated
// prefills agree bit for bit. The grid runs the q-tiles with the most keys
// first, so the longest CTAs start in the first wave. Tried and lost at the
// serve's shapes: overlapping one tile's softmax with the next tile's
// products inside a warpgroup (at D 64 with four consumers, with or without
// the warpgroups taking turns at the tensor cores; at D 128 and MLA, where
// ptxas then serialized the wgmmas), and rescaling l and acc only when a
// row's max grew by more than 2^8. K/V tiles are not multicast across a
// cluster (PERF.md: what the K/V loads cost at D 128 and at D 256 in two
// heads a CTA, by tools/flash_ab.py --probe no-kv-loads / pp-no-kv-loads).
//
// bfloat16 at D = 256 (recurrentgemma-9b: 16 q heads over one kv head, so
// every head of a group reads the same K/V tiles): a consumer's tile is 16
// wgmmas of S (Q and K both from shared memory), a softmax on the CUDA cores
// that takes as long as either product, then 4 of P V; one consumer a CTA
// (208 registers, its 230,456 bytes of shared memory leave one CTA an SM)
// idles the tensor cores through every softmax, and 16 CTAs read each K/V
// tile from L2. Where the two-head grid, KV * ceil(G / 2) * B * q-tiles
// CTAs, still fills the card (heads_at_256), flash_tc_kernel_pp takes two
// heads of a group a CTA: two consumer warpgroups share each K/V tile (a
// tile serves 128 query rows) and take turns at the tensor cores, one's
// softmax under the other's products, with registers moved to them by
// setmaxnreg; its output leaves through shared memory and one TMA store a
// 64-column atom, since the direct stores of eight 128-byte lines a warp
// instruction held each CTA for ~4,400 cycles (its design note below).
// Where the two-head grid would not fill the card (the serve's prefills of
// one request at S <= 384: 8-48 CTAs) flash_tc_kernel<256, DV, 16, 1> runs
// as before. Both give the same bits: the same products in the same order,
// the same softmax.
//
// float32 at D <= 128 (the exact checks, training): flash_tf32x3_kernel,
// on the tensor cores at
// float32 accuracy. The tensor cores take TF32 (10 mantissa bits), so each
// float32 operand x is split into hi = cvt.rna.tf32(x) and lo =
// cvt.rna.tf32(x - hi) (the rounding done with integer operations: the
// conversion instruction is emulated in several), and each product is
// lo*hi + hi*lo + hi*hi, accumulated in float32 by wgmma m64nNk8 TF32: three
// tensor-core products per product, as CUTLASS's FastF32 does; the lo*lo
// term and the residual below lo are about 2^-22 of the product. The kernel
// reads no allow_tf32 setting: the split is what keeps float32 accuracy
// with TF32 off. Its bound is 3 x the causal flops over the 495 TFLOP/s of
// dense TF32.
// One CTA per (q-tile of 128 rows, head, batch row; 64 rows at D = 128),
// the q-tiles with the most keys first, in warpgroups of two roles. A
// producer warpgroup copies each tile of 64 keys (32 at D = 128) of K and
// V by cp.async (16 bytes, zero-filled past T) into a float32 staging
// tile, splits it into hi and lo planes in a ring of two stages (K as it
// is, V transposed: TF32 wgmma reads B K-major only) and signals the
// stage's mbarrier; tiles above the causal diagonal or below the window
// are never loaded. Each consumer warpgroup owns 64 q rows, splits Q once
// into planes of its own, and per tile forms S = Q K^T with wgmma (A and B
// from shared memory), runs the online softmax on the accumulator (row
// max and sum over a quad; only the tiles that cross a bound or the T
// tail are masked), splits P in registers and adds P V with wgmma (A from
// registers), then frees the stage. The accumulator's columns (2 t, 2 t +
// 1) of a k slice are the A fragment's columns (t, t + 4), so the producer
// stores V's keys 2 t and 2 t + 1 of each 8 at positions t and t + 4 (a
// sum over keys does not depend on their order). Planes use the 128-byte
// swizzle that the wgmma descriptors name. Each row's result depends on
// its own q, its keys and its position only (no split over keys), so
// batched and isolated prefills agree bit for bit. Letting the two
// consumers take turns at the tensor cores (softmax of one under the
// products of the other) needs more than the 168 registers a thread has
// at 384 threads, and spilled.
// Hand-overs, in the order of a tile's life:
//  - staging tile: each producer thread waits for its own cp.async group,
//    then bar.sync 1 (the producer's 128 threads) makes the float32 tile
//    whole for all; a second bar.sync 1 after the split keeps the next
//    tile's copies out until every thread has read it;
//  - full(st) counts the 128 producer threads, each of which fences its
//    own plane stores to the async proxy (fence.proxy.async) before it
//    arrives; consumers wait on it before their wgmma reads;
//  - empty(st) counts lane 0 of each consumer warp, which arrives after
//    its warp's wgmma.wait_group 0, so the stage's reads are over before
//    the producer, waiting on it, writes the stage again;
//  - tile j uses stage j % 2 and waits for phase parity (j / 2) & 1 on
//    full, its complement on empty (a fresh barrier's "previous" phase
//    counts as done, so the first pass through each stage does not wait).
// tools/check_f32_sync.py (target flash) checks these with compute-sanitizer
// and with repeated launches, also on a build whose warps sleep at random at
// each hand-over (repro::jitter, tf32.cuh).
//
// float32 at D = 256: flash_tf32x3_d256_kernel, the same three TF32
// products per product. flash_tf32x3_kernel's layout does not fit at this
// width (Q's hi and lo planes alone are 128 KB for 64 rows, a 32-key stage
// of K and V planes 128 KB more), so Q stays as float32 and is split in
// registers. One CTA of two warpgroups per (q-tile of 64 rows, head, batch
// row), the q-tiles with the most keys first; 197,664 bytes of shared
// memory: Q as float32 (64 KB), one stage of K and V^T hi and lo planes for
// a 32-key tile (4 x 32 KB), four mbarriers. The producer warpgroup loads
// tile j + 1's float32 K and V rows from global memory into registers (keys
// past T, columns past Dqk / Dv zero) while the consumer reads tile j, and
// splits them straight into the planes (no staging tile); K and V have a
// full and an empty barrier each, so K(j + 1) is written under softmax(j)
// and P V(j), and V(j + 1) under S(j + 1). The consumer warpgroup keeps
// each 32-column block of a Q row in the order 8 t + 2 s + e for column 8 s
// + 4 e + t (chunks XOR-swizzled by row), so one 16-byte load gives a
// thread its A entries of two k slices; for S = Q K^T it loads and splits
// two k slices at a time into hi / lo A registers and starts their six
// m64n32k8 wgmmas (B the K planes) as one group, with two groups in flight
// (wgmma.wait_group 1 before a group's registers are written again); the
// softmax is flash_tf32x3_kernel's, and P V is 12 m64n256k8 wgmmas per tile
// into the 128-float accumulator. Registers: 255 a thread at 256 threads,
// no spill. The ring's hand-overs follow the rules above: each producer
// thread fences its plane stores to the async proxy before it arrives on
// full; lane 0 of each consumer warp arrives on empty after its warp's
// wgmma.wait_group 0; tile j waits for parity j & 1 on full, its complement
// on empty. Each row's result depends on its q, its keys and its position
// only, so batched and isolated prefills agree bit for bit.
//
// The tensor maps, tiles and barriers are tma.cuh's (shared with the SSD
// scan's tensor-core kernel); the library links against the CUDA runtime
// only.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "tf32.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

__device__ __forceinline__ float ex2(float x) {   // 2^x; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A launch's sizes: width is the compiled D (32, 64, 128 or 256) that holds
// Dqk, v_width the one that holds Dv (the bf16 kernel's V tile width)
struct Shape {
  int B, S, T, H, KV, width, v_width, Dqk, Dv, q_offset, window;
  float scale_log2;   // the scores' scale times log2(e)
};

// ---------------------------------------------------------------------------
// float32: three-way split TF32 on the tensor cores
// ---------------------------------------------------------------------------

namespace f32 {

using repro::cp_async16;
using repro::jitter;
using repro::named_sync;
using repro::Plane;
using repro::smem_addr;
using repro::split;
using repro::split4;

constexpr int kRows = 64;        // q rows per consumer warpgroup
constexpr int kThreads = 128;    // threads per warpgroup

// keys per tile: 64, 32 at D = 128 (shared memory)
template <int D>
__host__ __device__ constexpr int keys() { return D == 128 ? 32 : 64; }

// Shared memory: a ring of two stages of K and V planes (hi, lo), one
// float32 staging tile of K and V, and each consumer's Q planes
template <int D>
struct Layout {
  static constexpr int KN = keys<D>();
  static constexpr int NC = D == 128 ? 1 : 2;   // consumer warpgroups
  static constexpr int kStages = 2;
  using Q = Plane<kRows, D>;        // q rows x d
  using K = Plane<KN, D>;           // keys x d
  using V = Plane<D, KN>;           // d x key positions (V transposed)
  static constexpr uint32_t k_hi = 0;
  static constexpr uint32_t k_lo = k_hi + K::kBytes;
  static constexpr uint32_t v_hi = k_lo + K::kBytes;
  static constexpr uint32_t v_lo = v_hi + V::kBytes;
  static constexpr uint32_t kStageBytes = v_lo + V::kBytes;
  static constexpr uint32_t stage = kStages * kStageBytes;  // float32 K, V
  static constexpr uint32_t q = stage + 2 * KN * D * 4;     // per consumer
  static constexpr uint32_t bars = q + NC * 2 * Q::kBytes;
  static constexpr uint32_t bytes = bars + 8 * 2 * kStages;
};

template <int D>
constexpr size_t smem_bytes() {   // 1 KB of slack for the 1024-byte align
  return 1024 + Layout<D>::bytes;
}

// The consumer warpgroups' shared steps. Fragments: s[4 jj + 2 hh + e] is
// row row0 + 8 hh, key k0 + 8 jj + 2 t + e of a key tile; acc[4 jj + 2 hh +
// e] is row row0 + 8 hh, column 8 jj + 2 t + e.

// The online softmax of one tile of KN keys for the 64 rows qw ... qw + 63:
// masks the keys past T, above the causal diagonal and below the window
// (only in a tile that crosses one of them), takes each row's max and sum
// over its quad, rescales l and acc by the change of the row max and leaves
// the tile's P in s
template <int KN, int D>
__device__ __forceinline__ void softmax_tile(float (&s)[KN / 2],
                                             float (&acc)[D / 2],
                                             float (&m)[2], float (&l)[2],
                                             int k0, int qw, int row0, int t,
                                             int T, int q_offset, int window,
                                             float scale_log2) {
  const bool edge =
      k0 + KN > T || k0 + KN - 1 > q_offset + qw ||
      (window > 0 && k0 <= q_offset + qw + kRows - 1 - window);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qpos = q_offset + row0 + 8 * hh;
    const int kmax = min(qpos, T - 1) - k0 - 2 * t;
    const int kmin = (window > 0 ? qpos - window + 1 : 0) - k0 - 2 * t;
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < KN / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * jj + 2 * hh + e];
        if (edge && (8 * jj + e > kmax || 8 * jj + e < kmin)) x = -INFINITY;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[hh], mx);
    // a row that has seen no key yet keeps p = 0 and l = 0
    const float m_use = m_new == -INFINITY ? 0.f : m_new * scale_log2;
    const float corr = ex2(m[hh] * scale_log2 - m_use);
    m[hh] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < KN / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * jj + 2 * hh + e];
        x = ex2(fmaf(x, scale_log2, -m_use));
        sum += x;
      }
    l[hh] = l[hh] * corr + sum;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      acc[4 * jj + 2 * hh] *= corr;
      acc[4 * jj + 2 * hh + 1] *= corr;
    }
  }
}

// P's k slice kk, split, as A registers: columns t and t + 4 are keys 8 kk +
// 2 t and 8 kk + 2 t + 1, V's positions 8 kk + t and 8 kk + t + 4
template <int KN>
__device__ __forceinline__ void split_p(const float (&s)[KN / 2],
                                        uint32_t (&ph)[KN / 8][4],
                                        uint32_t (&pl)[KN / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < KN / 8; ++kk) {
    split(s[4 * kk], ph[kk][0], pl[kk][0]);
    split(s[4 * kk + 2], ph[kk][1], pl[kk][1]);
    split(s[4 * kk + 1], ph[kk][2], pl[kk][2]);
    split(s[4 * kk + 3], ph[kk][3], pl[kk][3]);
  }
}

// Each row's output, acc over the row's sum; rows past S and the columns
// past Dv are not stored
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           const float (&l)[2], float* o,
                                           int b, int S, int H, int h, int Dv,
                                           int row0, int t) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float den = l[hh];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    den = fmaxf(den, 1e-30f);
    const int row = row0 + 8 * hh;
    if (row >= S) continue;
    float* orow = o + (((size_t)b * S + row) * H + h) * Dv;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      if (8 * jj < Dv)
        *reinterpret_cast<float2*>(orow + 8 * jj + 2 * t) =
            make_float2(acc[4 * jj + 2 * hh] / den,
                        acc[4 * jj + 2 * hh + 1] / den);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads * (Layout<D>::NC + 1), 1)
flash_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    int S, int T, int H, int KV, int Dqk, int Dv,
                    int q_offset, int window, float scale_log2) {
  using L = Layout<D>;
  constexpr int KN = L::KN;
  constexpr int NC = L::NC;
  constexpr int CH = D / 4;         // 16-byte chunks per row of d
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* const sm = smem_raw + (base - smem_addr(smem_raw));
  auto full = [&](int st) { return base + L::bars + 8 * st; };
  auto empty = [&](int st) { return base + L::bars + 8 * (L::kStages + st); };

  // grid (H, B, q-tiles of 64 NC rows): the heads of a KV group side by
  // side, the q-tiles with the most keys first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows * NC;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int wg = tid / kThreads;    // consumers 0 ... NC - 1, then producer
  const int tw = tid % kThreads;

  // keys any row of this q-tile may attend: [k_lo, k_hi)
  const int last_q = q_offset + min(q0 + kRows * NC, S) - 1;
  const int k_hi = min(T, last_q + 1);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q_offset + q0 - window + 1);
  k_lo = (k_lo / KN) * KN;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + KN - 1) / KN : 0;

  if (tid == 0) {
    for (int st = 0; st < L::kStages; ++st) {
      repro::mbar_init(full(st), kThreads);       // every producer thread
      repro::mbar_init(empty(st), NC * 4);        // lane 0 of each consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // producer: each tile's float32 K and V by cp.async into the staging
    // tile (keys past T and columns past Dqk / Dv zero-filled from a valid
    // address), then split into a ring stage's planes: K as it is, V
    // transposed with key 8 q + e + 2 m at position 8 q + 4 e + m, the
    // order in which P's registers hold keys
    const size_t ld_k = (size_t)KV * Dqk, ld_v = (size_t)KV * Dv;
    const float* k_bh = k + ((size_t)b * T * KV + kvh) * Dqk;
    const float* v_bh = v + ((size_t)b * T * KV + kvh) * Dv;
    const float* stage_k = reinterpret_cast<const float*>(sm + L::stage);
    const float* stage_v = stage_k + KN * D;
    auto load = [&](int k0) {
      for (int i = tw; i < KN * CH; i += kThreads) {
        const int r = i / CH, c = i % CH;
        const bool row_in = k0 + r < T;
        const bool in_k = row_in && 4 * c < Dqk, in_v = row_in && 4 * c < Dv;
        cp_async16(base + L::stage + 16 * i,
                   k_bh + (in_k ? (k0 + r) * ld_k + 4 * c : 0), in_k);
        cp_async16(base + L::stage + KN * D * 4 + 16 * i,
                   v_bh + (in_v ? (k0 + r) * ld_v + 4 * c : 0), in_v);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    if (n_tiles > 0) load(k_lo);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % L::kStages;
      // each thread waits for its own copies, then the barrier makes
      // tile j's float32 staging tile whole for all of them
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      jitter(1);
      named_sync(1, kThreads);
      // the stage is free once every consumer warp has arrived on it
      // after its wgmma reads of the stage's previous tile completed
      repro::mbar_wait(empty(st), ((j / L::kStages) & 1) ^ 1);
      jitter(2);
      uint8_t* const ring = sm + st * L::kStageBytes;
      for (int i = tw; i < KN * CH; i += kThreads) {
        const int r = i / CH, c = i % CH;
        const float4 x = reinterpret_cast<const float4*>(stage_k)[i];
        const float xs[4] = {x.x, x.y, x.z, x.w};
        uint4 hi, lo;
        split4(xs, hi, lo);
        *reinterpret_cast<uint4*>(ring + L::k_hi + L::K::chunk(r, c)) = hi;
        *reinterpret_cast<uint4*>(ring + L::k_lo + L::K::chunk(r, c)) = lo;
      }
      for (int i = tw; i < D * KN / 4; i += kThreads) {
        const int d = i % D, qe = i / D;
        const int key = 8 * (qe >> 1) + (qe & 1);
        const float xs[4] = {
            stage_v[key * D + d], stage_v[(key + 2) * D + d],
            stage_v[(key + 4) * D + d], stage_v[(key + 6) * D + d]};
        uint4 hi, lo;
        split4(xs, hi, lo);
        *reinterpret_cast<uint4*>(ring + L::v_hi + L::V::chunk(d, qe)) = hi;
        *reinterpret_cast<uint4*>(ring + L::v_lo + L::V::chunk(d, qe)) = lo;
      }
      jitter(3);
      // written by the generic proxy, read by wgmma's async proxy: each
      // thread fences its own stores before its arrival (full(st) counts
      // all 128)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      repro::mbar_arrive(full(st));
      // no thread refills the staging tile before all have split it
      named_sync(1, kThreads);
      jitter(4);
      if (j + 1 < n_tiles) load(k_lo + (j + 1) * KN);
    }
    return;
  }

  // consumer wg: rows q0 + 64 wg ... q0 + 64 wg + 63
  const int qw = q0 + kRows * wg;
  const int warp = tw >> 5, lane = tw & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = qw + 16 * warp + g;   // rows row0 and row0 + 8
  const uint32_t q_hi = L::q + wg * 2 * L::Q::kBytes;
  const uint32_t q_lo = q_hi + L::Q::kBytes;
  // Q once, split into its hi and lo planes (rows past S and columns past
  // Dqk are zeros)
  for (int i = tw; i < kRows * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qw + r < S && 4 * c < Dqk)
      x = *reinterpret_cast<const float4*>(
          q + (((size_t)b * S + qw + r) * H + h) * Dqk + 4 * c);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    uint4 hi, lo;
    split4(xs, hi, lo);
    *reinterpret_cast<uint4*>(sm + q_hi + L::Q::chunk(r, c)) = hi;
    *reinterpret_cast<uint4*>(sm + q_lo + L::Q::chunk(r, c)) = lo;
  }
  jitter(5);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(2 + wg, kThreads);

  // the last key any of this warpgroup's rows attends (below: none)
  const int last_key = qw < S ? min(k_hi, q_offset + min(qw + kRows, S)) - 1
                              : -1;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % L::kStages;
    const int k0 = k_lo + j * KN;
    repro::mbar_wait(full(st), (j / L::kStages) & 1);
    jitter(6);
    if (k0 <= last_key) {
      const uint32_t ring = base + st * L::kStageBytes;
      // S = Q K^T, three TF32 products per product: lo hi, hi lo, hi hi
      float s[KN / 2];
      repro::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint64_t qh = L::Q::desc(base + q_hi, kk);
        const uint64_t ql = L::Q::desc(base + q_lo, kk);
        const uint64_t kh = L::K::desc(ring + L::k_hi, kk);
        const uint64_t kl = L::K::desc(ring + L::k_lo, kk);
        repro::wgmma_tf32_ss<KN>(s, ql, kh, kk > 0);
        repro::wgmma_tf32_ss<KN>(s, qh, kl, 1);
        repro::wgmma_tf32_ss<KN>(s, qh, kh, 1);
      }
      repro::wgmma_commit();
      repro::wgmma_wait_all();
      repro::fence_regs(s);

      softmax_tile<KN, D>(s, acc, m, l, k0, qw, row0, t, T, q_offset,
                          window, scale_log2);
      // O += P V
      uint32_t ph[KN / 8][4], pl[KN / 8][4];
      split_p<KN>(s, ph, pl);
      repro::fence_regs(acc);
      repro::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KN / 8; ++kk) {
        const uint64_t vh = L::V::desc(ring + L::v_hi, kk);
        const uint64_t vl = L::V::desc(ring + L::v_lo, kk);
        repro::wgmma_tf32_rs<D>(acc, pl[kk], vh);
        repro::wgmma_tf32_rs<D>(acc, ph[kk], vl);
        repro::wgmma_tf32_rs<D>(acc, ph[kk], vh);
      }
      repro::wgmma_commit();
      repro::wgmma_wait_all();   // this warp's reads of the stage are done
      repro::fence_regs(acc);
    }
    jitter(7);
    __syncwarp();
    if (lane == 0) repro::mbar_arrive(empty(st));
  }

  store_rows<D>(acc, l, o, b, S, H, h, Dv, row0, t);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const Shape& sh, cudaStream_t stream) {
  using L = Layout<D>;
  static int granted = 48 * 1024;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err =
      repro::allow_smem(flash_tf32x3_kernel<D>, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  constexpr int rows = kRows * L::NC;
  dim3 grid(sh.H, sh.B, (sh.S + rows - 1) / rows);
  flash_tf32x3_kernel<D><<<grid, kThreads * (L::NC + 1), smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sh.S, sh.T, sh.H,
      sh.KV, sh.Dqk, sh.Dv, sh.q_offset, sh.window, sh.scale_log2);
  return (int)cudaGetLastError();
}

// ---- D = 256: Q as float32, split into A registers a k slice at a time --

namespace wide {

constexpr int kD = 256;
constexpr int kKeys = 32;                // keys per tile
constexpr int kCh = kD / 4;              // 16-byte chunks per row of d
constexpr int kPairs = kD / 16;          // pairs of k slices of Q K^T
using KPlane = Plane<kKeys, kD>;         // keys x d
using VPlane = Plane<kD, kKeys>;         // d x key positions (V transposed)
// Shared memory: Q as float32 (64 rows of 1 KB), one stage of K and V^T
// planes (hi, lo), and the full and empty barriers of K and of V
constexpr uint32_t kQ = 0;
constexpr uint32_t kKHi = kQ + kRows * kD * 4;
constexpr uint32_t kKLo = kKHi + KPlane::kBytes;
constexpr uint32_t kVHi = kKLo + KPlane::kBytes;
constexpr uint32_t kVLo = kVHi + VPlane::kBytes;
constexpr uint32_t kBars = kVLo + VPlane::kBytes;
constexpr size_t kSmem = 1024 + kBars + 8 * 4;   // 1 KB for the align
static_assert(kSmem == 197664, "wide: 64 + 4 x 32 KB, barriers, slack");
static_assert(kSmem <= 232448, "wide: a block may have 232,448 bytes");

// Q's float32 row r keeps each 32-column block's column 8 s + 4 e + t at
// position 8 t + 2 s + e, so that a thread's A entries of four k slices
// (columns t and t + 4 of each) are two 16-byte chunks, 2 t and 2 t + 1;
// chunk c of a block sits at c ^ (r % 8), so a quarter-warp's loads hit
// distinct banks
__device__ __forceinline__ uint32_t q_chunk(int r, int block, int c) {
  return kQ + r * (kD * 4) + block * 128 + ((c ^ (r & 7)) << 4);
}

// component i of x (i a constant once unrolled)
__device__ __forceinline__ float lane_of(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

__global__ void __launch_bounds__(2 * kThreads, 1)
flash_tf32x3_d256_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int S, int T, int H, int KV, int Dqk, int Dv,
                         int q_offset, int window, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* const sm = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t k_full = base + kBars, k_empty = k_full + 8;
  const uint32_t v_full = k_full + 16, v_empty = k_full + 24;

  // grid (H, B, q-tiles of 64 rows), the q-tiles with the most keys first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tw = tid % kThreads;

  // keys any row of this q-tile may attend: [k_lo, k_hi)
  const int last_q = q_offset + min(q0 + kRows, S) - 1;
  const int k_hi = min(T, last_q + 1);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q_offset + q0 - window + 1);
  k_lo = (k_lo / kKeys) * kKeys;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kKeys - 1) / kKeys : 0;

  if (tid == 0) {
    repro::mbar_init(k_full, kThreads);   // every producer thread
    repro::mbar_init(v_full, kThreads);
    repro::mbar_init(k_empty, 4);         // lane 0 of each consumer warp
    repro::mbar_init(v_empty, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kThreads) {
    // producer: tile j + 1's float32 K (or V) rows load into registers
    // while the consumer still reads tile j's planes (keys past T and
    // columns past Dqk / Dv are zeros); once the consumer frees the
    // planes, each thread splits its registers into them: K as it is, V
    // transposed with key 8 q + e + 2 m at position 8 q + 4 e + m, the
    // order in which P's registers hold keys
    const size_t ld_k = (size_t)KV * Dqk, ld_v = (size_t)KV * Dv;
    const float* k_bh = k + ((size_t)b * T * KV + kvh) * Dqk;
    const float* v_bh = v + ((size_t)b * T * KV + kvh) * Dv;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 kx[16], vx[4][4];
    // K: chunk c of key row r, i = r * 64 + c
    auto load_k = [&](int k0) {
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int i = tw + n * kThreads, r = i / kCh, c = i % kCh;
        kx[n] = k0 + r < T && 4 * c < Dqk
                    ? *reinterpret_cast<const float4*>(
                          k_bh + (k0 + r) * ld_k + 4 * c)
                    : zero;
      }
    };
    // V: for i = c * 8 + qe, keys 8 (qe / 2) + qe % 2 + 2 m of chunk c
    auto load_v = [&](int k0) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int i = tw + n * kThreads, qe = i % 8, c = i / 8;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int r = 8 * (qe >> 1) + (qe & 1) + 2 * m;
          vx[n][m] = k0 + r < T && 4 * c < Dv
                         ? *reinterpret_cast<const float4*>(
                               v_bh + (k0 + r) * ld_v + 4 * c)
                         : zero;
        }
      }
    };
    if (n_tiles > 0) {
      load_k(k_lo);
      load_v(k_lo);
    }
    for (int j = 0; j < n_tiles; ++j) {
      // the planes are free once every consumer warp has arrived on them
      // after its wgmma reads of tile j - 1 completed
      const int free_parity = (j & 1) ^ 1;
      repro::mbar_wait(k_empty, free_parity);
      jitter(1);
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int i = tw + n * kThreads, r = i / kCh, c = i % kCh;
        const float xs[4] = {kx[n].x, kx[n].y, kx[n].z, kx[n].w};
        uint4 hi, lo;
        split4(xs, hi, lo);
        *reinterpret_cast<uint4*>(sm + kKHi + KPlane::chunk(r, c)) = hi;
        *reinterpret_cast<uint4*>(sm + kKLo + KPlane::chunk(r, c)) = lo;
      }
      jitter(2);
      // written by the generic proxy, read by wgmma's async proxy: each
      // thread fences its own stores before its arrival (full counts all
      // 128)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      repro::mbar_arrive(k_full);
      const int k_next = k_lo + (j + 1) * kKeys;
      if (j + 1 < n_tiles) load_k(k_next);

      repro::mbar_wait(v_empty, free_parity);
      jitter(3);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int i = tw + n * kThreads, qe = i % 8, c = i / 8;
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) {
          // column 4 c + dd of the chunk's four keys, in position order
          const float xs[4] = {lane_of(vx[n][0], dd), lane_of(vx[n][1], dd),
                               lane_of(vx[n][2], dd), lane_of(vx[n][3], dd)};
          uint4 hi, lo;
          split4(xs, hi, lo);
          const uint32_t at = VPlane::chunk(4 * c + dd, qe);
          *reinterpret_cast<uint4*>(sm + kVHi + at) = hi;
          *reinterpret_cast<uint4*>(sm + kVLo + at) = lo;
        }
      }
      jitter(4);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      repro::mbar_arrive(v_full);
      if (j + 1 < n_tiles) load_v(k_next);
    }
    return;
  }

  // consumer: rows q0 ... q0 + 63, 16 per warp
  const int warp = tw >> 5, lane = tw & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;          // rows r0 and r0 + 8 of the tile
  const int row0 = q0 + r0;
  // Q once, as float32 in the permuted order (rows past S and columns
  // past Dqk are zeros); read back with plain loads, so the consumer's own
  // barrier orders it
  for (int i = tw; i < kRows * kCh; i += kThreads) {
    const int r = i / kCh, c = i % kCh;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S && 4 * c < Dqk)
      x = *reinterpret_cast<const float4*>(
          q + (((size_t)b * S + q0 + r) * H + h) * Dqk + 4 * c);
    // columns 4 c + t' of the block: s = (c % 8) / 2, e = c % 2
    const int blk = c / 8, s2 = (c % 8) >> 1, e = c & 1;
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int tt = 0; tt < 4; ++tt)
      *reinterpret_cast<float*>(sm + q_chunk(r, blk, 2 * tt + (s2 >> 1)) +
                                4 * (2 * (s2 & 1) + e)) = xs[tt];
  }
  jitter(5);
  named_sync(1, kThreads);

  float acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_lo + j * kKeys;
    const int parity = j & 1;
    repro::mbar_wait(k_full, parity);
    jitter(6);

    // S = Q K^T, three TF32 products per product (lo hi, hi lo, hi hi).
    // Pair p of k slices (2 p, 2 p + 1; block p / 2, chunk 2 t + p % 2)
    // loads rows r0 and r0 + 8, splits them into A registers and starts
    // its six wgmmas as one group; the registers of pair p are written
    // again for pair p + 2, after wgmma.wait_group 1 has seen pair p done
    float s[kKeys / 2];
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;
    uint32_t ah[2][2][4], al[2][2][4];   // [pair % 2][slice][register]
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int blk = p >> 1, c = 2 * t + (p & 1);
      const float4 xa = *reinterpret_cast<const float4*>(
          sm + q_chunk(r0, blk, c));
      const float4 xb = *reinterpret_cast<const float4*>(
          sm + q_chunk(r0 + 8, blk, c));
      if (p >= 2) repro::wgmma_wait<1>();
      // slice sl: (r0, t), (r0 + 8, t), (r0, t + 4), (r0 + 8, t + 4)
      const float xs[2][4] = {{xa.x, xb.x, xa.y, xb.y},
                              {xa.z, xb.z, xa.w, xb.w}};
#pragma unroll
      for (int sl = 0; sl < 2; ++sl)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split(xs[sl][i], ah[p & 1][sl][i], al[p & 1][sl][i]);
      repro::wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        const int kk = 2 * p + sl;
        const uint64_t kh = KPlane::desc(base + kKHi, kk);
        const uint64_t kl = KPlane::desc(base + kKLo, kk);
        repro::wgmma_tf32_rs<kKeys>(s, al[p & 1][sl], kh);
        repro::wgmma_tf32_rs<kKeys>(s, ah[p & 1][sl], kl);
        repro::wgmma_tf32_rs<kKeys>(s, ah[p & 1][sl], kh);
      }
      repro::wgmma_commit();
    }
    repro::wgmma_wait_all();   // this warp's reads of the K planes are done
    repro::fence_regs(s);
    jitter(7);
    __syncwarp();
    if (lane == 0) repro::mbar_arrive(k_empty);

    softmax_tile<kKeys, kD>(s, acc, m, l, k0, q0, row0, t, T, q_offset,
                            window, scale_log2);
    // O += P V
    uint32_t ph[kKeys / 8][4], pl[kKeys / 8][4];
    split_p<kKeys>(s, ph, pl);
    repro::mbar_wait(v_full, parity);
    jitter(8);
    repro::fence_regs(acc);
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 8; ++kk) {
      const uint64_t vh = VPlane::desc(base + kVHi, kk);
      const uint64_t vl = VPlane::desc(base + kVLo, kk);
      repro::wgmma_tf32_rs<kD>(acc, pl[kk], vh);
      repro::wgmma_tf32_rs<kD>(acc, ph[kk], vl);
      repro::wgmma_tf32_rs<kD>(acc, ph[kk], vh);
    }
    repro::wgmma_commit();
    repro::wgmma_wait_all();   // this warp's reads of the V planes are done
    repro::fence_regs(acc);
    jitter(9);
    __syncwarp();
    if (lane == 0) repro::mbar_arrive(v_empty);
  }

  store_rows<kD>(acc, l, o, b, S, H, h, Dv, row0, t);
}

}  // namespace wide

int launch_wide(const void* q, const void* k, const void* v, void* o,
                const Shape& sh, cudaStream_t stream) {
  static int granted = 48 * 1024;
  cudaError_t err = repro::allow_smem(wide::flash_tf32x3_d256_kernel,
                                      wide::kSmem, &granted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(sh.H, sh.B, (sh.S + kRows - 1) / kRows);
  wide::flash_tf32x3_d256_kernel<<<grid, 2 * kThreads, wide::kSmem,
                                   stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sh.S, sh.T, sh.H,
      sh.KV, sh.Dqk, sh.Dv, sh.q_offset, sh.window, sh.scale_log2);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o,
             const Shape& sh, cudaStream_t stream) {
  switch (sh.width) {
    case 32:
      return launch<32>(q, k, v, o, sh, stream);
    case 64:
      return launch<64>(q, k, v, o, sh, stream);
    case 128:
      return launch<128>(q, k, v, o, sh, stream);
    case 256:
      return launch_wide(q, k, v, o, sh, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::pack_bf16;
using repro::smem_addr;
using repro::head_tensor_map;
using repro::Tile;
using repro::tma_head_tile;

constexpr int kRows = repro::kTileRows;   // q rows and keys per tile

// K/V ring depth: four stages at D <= 64 (16 KB of K and V), two at D =
// 128 (24 KB at DV 64, 32 KB at DV 128: three CTAs of the MLA pair fit an
// SM, where three stages left two and lost in turns) and three at D = 256
// in one head a CTA (up to 64 KB beside its one 32 KB Q tile: 230,456 bytes
// of the 232,448 a block may have; two heads a CTA: namespace pp)
template <int D>
__host__ __device__ constexpr int stages() {
  return D == 128 ? 2 : D > 128 ? 3 : 4;
}

// Q/K tiles are D wide and V tiles DV wide (DV the compiled width that
// holds Dv), NC consumers' Q tiles beside the ring
template <int D, int DV, int NC>
constexpr size_t smem_bytes() {
  // 1 KB of slack to align the tiles to the 1024-byte swizzle period
  return 1024 + (size_t)(NC + stages<D>()) * Tile<D>::kBytes +
         (size_t)stages<D>() * Tile<DV>::kBytes + 8 * (2 * stages<D>() + NC);
}

// The consumers' steps between the products. Fragments (wgmma.cuh): s[4 jj
// + 2 h + e] is row row0 + 8 h, key k0 + 8 jj + 2 (lane % 4) + e of a
// 64-key tile; acc[4 jj + 2 h + e] the same rows, column 8 jj + 2 (lane %
// 4) + e.

// The online softmax of one key tile for the 64 rows q0 ... q0 + 63: masks
// the keys past T, above the causal diagonal and below the window (only in
// a tile that crosses one of them), takes each row's max and sum over its
// quad, rescales l and acc by the change of the row max (ex2 on the
// log2-scaled scores) and packs P as bf16 A registers
template <int DV>
__device__ __forceinline__ void softmax_tile(float (&s)[32],
                                             float (&acc)[DV / 2],
                                             float (&m)[2], float (&l)[2],
                                             uint32_t (&pa)[4][4], int k0,
                                             int q0, int row0, int lane,
                                             int T, int q_offset, int window,
                                             float scale_log2) {
  const bool edge =
      k0 + kRows > T || k0 + kRows - 1 > q_offset + q0 ||
      (window > 0 && k0 <= q_offset + q0 + kRows - 1 - window);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = q_offset + row0 + 8 * h;
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * jj + 2 * h + e];
        if (edge) {
          const int kpos = k0 + 8 * jj + 2 * (lane & 3) + e;
          const bool ok = kpos < T && kpos <= qpos &&
                          (window <= 0 || kpos > qpos - window);
          if (!ok) x = -INFINITY;
        }
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    // a row that has seen no key yet keeps p = 0 and l = 0
    const float m_use = m_new == -INFINITY ? 0.f : m_new * scale_log2;
    const float corr = ex2(m[h] * scale_log2 - m_use);
    m[h] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * jj + 2 * h + e];
        x = ex2(fmaf(x, scale_log2, -m_use));
        sum += x;
      }
    l[h] = l[h] * corr + sum;
#pragma unroll
    for (int jj = 0; jj < DV / 8; ++jj) {
      acc[4 * jj + 2 * h] *= corr;
      acc[4 * jj + 2 * h + 1] *= corr;
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// 1 / a row's sum, its four lanes' parts added over the quad
__device__ __forceinline__ float inv_row_sum(float l) {
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  return 1.f / fmaxf(l, 1e-30f);
}

// Each row's output, acc over the row's sum in bf16; rows past S and
// columns past Dv are not stored
template <int DV>
__device__ __forceinline__ void store_tile(const float (&acc)[DV / 2],
                                           const float (&l)[2],
                                           __nv_bfloat16* o, int b, int S,
                                           int H, int head, int Dv, int row0,
                                           int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float inv = inv_row_sum(l[h]);
    const int row = row0 + 8 * h;
    if (row >= S) continue;
    __nv_bfloat16* orow = o + (((size_t)b * S + row) * H + head) * Dv;
#pragma unroll
    for (int jj = 0; jj < DV / 8; ++jj) {
      if (8 * jj >= Dv) continue;        // columns past Dv are not stored
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          acc[4 * jj + 2 * h] * inv, acc[4 * jj + 2 * h + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj + 2 * (lane & 3)) =
          v;
    }
  }
}

// The same output through shared memory: the warpgroup writes its 64 rows
// as bf16 into `tile` (its Q tile, dead after its last S), laid out as TMA
// loads a tile, then its first thread stores them with one TMA store per
// 64-column atom (rows past S and columns past Dv fall outside the map) and
// waits only until the copy has read shared memory. Each thread's stores
// hit 32 distinct banks (the 128-byte swizzle), where the direct stores of
// store_tile touch eight 128-byte lines a warp instruction.
template <int DV>
__device__ __forceinline__ void store_tile_tma(const float (&acc)[DV / 2],
                                               const float (&l)[2],
                                               uint32_t tile,
                                               const CUtensorMap* to,
                                               int b, int head, int q0,
                                               int wg, int wl, int lane) {
  using LV = Tile<DV>;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float inv = inv_row_sum(l[h]);
    const int r = 16 * wl + (lane >> 2) + 8 * h;
#pragma unroll
    for (int jj = 0; jj < DV / 8; ++jj) {
      const uint32_t v = pack_bf16(acc[4 * jj + 2 * h] * inv,
                                   acc[4 * jj + 2 * h + 1] * inv);
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                       tile + LV::elem(r, 8 * jj + 2 * (lane & 3))),
                   "r"(v)
                   : "memory");
    }
  }
  // written by the generic proxy, read by the TMA's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  repro::named_sync(3 + wg, 128);
  if ((threadIdx.x & 127) == 0) {
    repro::tma_store_head_tile<DV>(to, tile, head, q0, b);
    repro::bulk_commit();
    repro::bulk_wait_read();
  }
}

// One CTA: one q tile of 64 rows of NC heads of a KV group, one consumer
// warpgroup per head, and a producer warp. Every consumer reads each K/V
// tile the producer loads, so a tile serves NC * 64 query rows. Q K^T runs
// KS k slices of 16 columns: a count known at compile time (a k-slice loop
// with a run-time bound made ptxas serialize every wgmma of the kernel).
template <int D, int DV, int KS, int NC>
__global__ void __launch_bounds__(NC * 128 + 32, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int S, int T, int H, int KV,
                int Dv, int q_offset, int window, float scale_log2) {
  static_assert(KS >= 1 && KS <= D / 16, "flash_tc_kernel: k slices");
  using LQ = Tile<D>;                    // Q and K tiles
  using LV = Tile<DV>;                   // V tiles
  constexpr int kStages = stages<D>();
  constexpr int kOut = DV / 2;           // accumulator floats per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;                              // NC tiles
  const uint32_t k_s = q_s + NC * LQ::kBytes;             // kStages tiles
  const uint32_t v_s = k_s + kStages * LQ::kBytes;        // kStages tiles
  const uint32_t bars = v_s + kStages * LV::kBytes;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kStages + st); };
  auto qbar = [&](int w) { return bars + 8 * (2 * kStages + w); };

  // grid (KV * passes, B, q-tiles): a pass is NC heads of a group (G > NC
  // takes several, side by side); the q-tiles with the most keys run first,
  // so the longest CTAs start in the first wave and short ones fill the tail
  const int G = H / KV;
  const int passes = (G + NC - 1) / NC;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const int kvh = blockIdx.x / passes;
  const int pass = blockIdx.x % passes;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // keys any row of this tile may attend: [k_lo, k_hi)
  const int last_q = q_offset + min(q0 + kRows, S) - 1;
  const int k_hi = min(T, last_q + 1);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q_offset + q0 - window + 1);
  k_lo = (k_lo / kRows) * kRows;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kRows - 1) / kRows : 0;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), NC * 4);     // lane 0 of every consumer warp
    }
    for (int w = 0; w < NC; ++w) mbar_init(qbar(w), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NC * 4) {
    // producer: the K and V tiles through the ring, issued by lane 0
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages;
      mbar_wait(empty(st), ((j / kStages) & 1) ^ 1);
      repro::jitter(1);
      if (lane == 0) {
        mbar_expect_tx(full(st), LQ::kBytes + LV::kBytes);
        const int k0 = k_lo + j * kRows;
        tma_head_tile<D>(k_s + st * LQ::kBytes, &tk, full(st), kvh, k0, b);
        tma_head_tile<DV>(v_s + st * LV::kBytes, &tv, full(st), kvh, k0, b);
      }
      __syncwarp();
    }
    return;
  }

  const int wg = warp >> 2;              // consumer warpgroup = head slot
  const int wl = warp & 3;               // warp within the warpgroup
  const int t = tid & 127;
  const uint32_t my_q = q_s + wg * LQ::kBytes;
  const int hg = pass * NC + wg;
  const bool active = hg < G;
  const int head = kvh * G + hg;
  if (active) {
    if (t == 0) {
      mbar_expect_tx(qbar(wg), LQ::kBytes);
      tma_head_tile<D>(my_q, &tq, qbar(wg), head, q0, b);
    }
    mbar_wait(qbar(wg), 0);
  }
  float acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row0 = q0 + 16 * wl + (lane >> 2);   // rows row0, row0 + 8

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const int k0 = k_lo + j * kRows;
    mbar_wait(full(st), (j / kStages) & 1);
    repro::jitter(6);
    if (active) {
      // S = Q K^T over the KS k slices that hold columns of q and k
      float s[32];
      repro::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        repro::wgmma_ss_n64(s, LQ::kmajor(my_q, kk),
                            LQ::kmajor(k_s + st * LQ::kBytes, kk), kk > 0);
      repro::wgmma_commit();
      repro::wgmma_wait_all();
      repro::fence_regs(s);

      uint32_t pa[4][4];
      softmax_tile<DV>(s, acc, m, l, pa, k0, q0, row0, lane, T, q_offset,
                       window, scale_log2);

      // O += P V at the V tile's width DV
      repro::fence_regs(acc);
      repro::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        repro::wgmma_rs<DV>(acc, pa[kk],
                            LV::mnmajor(v_s + st * LV::kBytes, kk));
      repro::wgmma_commit();
      repro::wgmma_wait_all();
      repro::fence_regs(acc);
    }
    // every consumer frees every stage, an inactive one too: the producer
    // refills a stage only after all NC of them (its full wait orders the
    // arrival after the previous round's)
    repro::jitter(7);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

  if (active) store_tile<DV>(acc, l, o, b, S, H, head, Dv, row0, lane);
}

// One launch; with info, no launch: the instantiation's registers a
// thread, local (spill) bytes a thread, CTAs an SM holds, shared memory
// bytes and NC, in info[0 ... 4]
template <int D, int DV, int KS, int NC>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              const Shape& sh, cudaStream_t stream, int* info) {
  static int granted = 48 * 1024;
  constexpr size_t smem = smem_bytes<D, DV, NC>();
  constexpr int threads = NC * 128 + 32;
  auto kernel = flash_tc_kernel<D, DV, KS, NC>;
  cudaError_t err = repro::allow_smem(kernel, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  if (info != nullptr) {
    cudaFuncAttributes a{};
    err = cudaFuncGetAttributes(&a, kernel);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel,
                                                          threads, smem);
    info[0] = a.numRegs;
    info[1] = (int)a.localSizeBytes;
    info[3] = (int)smem;
    info[4] = NC;
    return (int)err;
  }
  CUtensorMap tq, tk, tv;
  if (!head_tensor_map<D>(&tq, q, sh.B, sh.S, sh.H, sh.Dqk) ||
      !head_tensor_map<D>(&tk, k, sh.B, sh.T, sh.KV, sh.Dqk) ||
      !head_tensor_map<DV>(&tv, v, sh.B, sh.T, sh.KV, sh.Dv))
    return (int)cudaErrorInvalidValue;
  dim3 grid(sh.KV * ((sh.H / sh.KV + NC - 1) / NC), sh.B,
            (sh.S + kRows - 1) / kRows);
  flash_tc_kernel<D, DV, KS, NC><<<grid, threads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), sh.S, sh.T, sh.H, sh.KV,
      sh.Dv, sh.q_offset, sh.window, sh.scale_log2);
  return (int)cudaGetLastError();
}

// ---- D = 256, two heads a CTA: consumers that take turns ---------------
//
// Two consumer warpgroups on two q heads of one KV group share every K/V
// tile (under MQA both heads attend the same keys with the same bounds, so
// both run the same tiles), and a producer warpgroup streams them. One
// warpgroup's softmax runs on the CUDA cores while the other's products run
// on the tensor cores: turn k of a warpgroup is P V of tile k - 1, then S of
// tile k, each ended by its wgmma wait, so within a warpgroup the order is
// S, wait, softmax, P V, wait as in flash_tc_kernel. Named barriers 1 and 2
// hand the turn over: warpgroup w waits on barrier 1 + w (bar.sync, 256
// threads) and, its products done, arrives on the other's (bar.arrive), so
// the turns alternate 0, 1, 0, 1, ...; warpgroup 1 arrives on barrier 1
// once before its loop (warpgroup 0 goes first) and not after its last
// turn, so every barrier's arrivals match its waits. A CTA whose second
// head is past the group (G odd, the last pass) runs its one consumer
// without turns. K and V have a ring of two stages each with barriers of
// their own: K(j) is freed by both consumers' S(j), V(j) by their P V(j),
// so the producer refills K a turn and a half before V. Registers move by
// setmaxnreg: the producer warpgroup drops to 40 a thread (one lane issues
// TMA), the consumers rise to 232 (2 x 128 x 232 + 128 x 40 = 64,512 of
// the SM's 65,536; the launch's 168 a thread is what 384 threads may
// have), room for the 128-float accumulator, S's 32 floats and P's 16 A
// registers. Shared memory: two 32 KB Q tiles, two stages of K (32 KB) and
// of V (DV wide), 197,712 bytes at DV 256: one CTA an SM. Thread 0 issues
// both Q tiles as soon as the barriers exist, ahead of the producer's
// first K/V tiles. Each warpgroup's output goes out through its Q tile
// (store_tile_tma). What bounds it (PERF.md, tools/flash_ab.py --probe
// tc-phases): a turn's products run at ~70 % of the tensor cores' rate (S
// reads both operands from shared memory), and a CTA spends about a fifth
// of its time before its loop, loading 192 KB into the SM, and a tenth
// storing; removing the K/V loads after the first fill changed nothing.
namespace pp {

constexpr int kD = 256;
constexpr int kStages = 2;
constexpr int kThreads = 3 * 128;   // consumers 0 and 1, then the producer
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(2 * 128 * kConsumerRegs + 128 * kProducerRegs <= 65536,
              "pp: the SM's registers");

template <int DV>
constexpr size_t smem_bytes() {
  // 1 KB of slack to align the tiles to the 1024-byte swizzle period
  return 1024 + (size_t)(2 + kStages) * Tile<kD>::kBytes +
         (size_t)kStages * Tile<DV>::kBytes + 8 * (4 * kStages + 2);
}
static_assert(smem_bytes<256>() <= 232448, "pp: a block's shared memory");

}  // namespace pp

template <int DV, int KS>
__global__ void __launch_bounds__(pp::kThreads, 1)
flash_tc_kernel_pp(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap to, int S, int T,
                   int H, int KV, int q_offset, int window,
                   float scale_log2) {
  constexpr int D = pp::kD;
  constexpr int kStages = pp::kStages;
  static_assert(KS >= 1 && KS <= D / 16, "flash_tc_kernel_pp: k slices");
  using LQ = Tile<D>;                    // Q and K tiles
  using LV = Tile<DV>;                   // V tiles
  constexpr int kOut = DV / 2;           // accumulator floats per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                              // 2 tiles
  const uint32_t k_s = q_s + 2 * LQ::kBytes;              // kStages tiles
  const uint32_t v_s = k_s + kStages * LQ::kBytes;        // kStages tiles
  const uint32_t bars = v_s + kStages * LV::kBytes;
  auto full_k = [&](int st) { return bars + 8 * st; };
  auto full_v = [&](int st) { return bars + 8 * (kStages + st); };
  auto empty_k = [&](int st) { return bars + 8 * (2 * kStages + st); };
  auto empty_v = [&](int st) { return bars + 8 * (3 * kStages + st); };
  auto qbar = [&](int w) { return bars + 8 * (4 * kStages + w); };

  // grid (KV * passes, B, q-tiles) as flash_tc_kernel's, two heads a pass
  const int G = H / KV;
  const int passes = (G + 1) / 2;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const int kvh = blockIdx.x / passes;
  const int pass = blockIdx.x % passes;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool both = 2 * pass + 1 < G;    // two heads: the turns are taken

  const int last_q = q_offset + min(q0 + kRows, S) - 1;
  const int k_hi = min(T, last_q + 1);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q_offset + q0 - window + 1);
  k_lo = (k_lo / kRows) * kRows;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kRows - 1) / kRows : 0;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty_k(st), both ? 8 : 4);   // lane 0 of each consumer warp
      mbar_init(empty_v(st), both ? 8 : 4);
    }
    mbar_init(qbar(0), 1);
    mbar_init(qbar(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the Q tiles first, ahead of the producer's K/V tiles in the SM's
    // load queue: the first S needs Q and K(0) only
    for (int w = 0; w < (both ? 2 : 1); ++w) {
      mbar_expect_tx(qbar(w), LQ::kBytes);
      tma_head_tile<D>(q_s + w * LQ::kBytes, &tq, qbar(w),
                       kvh * G + 2 * pass + w, q0, b);
    }
  }
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroup: its first warp's lane 0 issues K and V of tile j
    // as soon as both consumers have freed the stage's previous tile
    repro::setmaxnreg_dec<pp::kProducerRegs>();
    if (warp == 8) {
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        const int free_parity = ((j / kStages) & 1) ^ 1;
        const int k0 = k_lo + j * kRows;
        mbar_wait(empty_k(st), free_parity);
        repro::jitter(1);
        if (lane == 0) {
          mbar_expect_tx(full_k(st), LQ::kBytes);
          tma_head_tile<D>(k_s + st * LQ::kBytes, &tk, full_k(st), kvh, k0,
                           b);
        }
        mbar_wait(empty_v(st), free_parity);
        repro::jitter(2);
        if (lane == 0) {
          mbar_expect_tx(full_v(st), LV::kBytes);
          tma_head_tile<DV>(v_s + st * LV::kBytes, &tv, full_v(st), kvh, k0,
                            b);
        }
        __syncwarp();
      }
    }
    return;
  }

  repro::setmaxnreg_inc<pp::kConsumerRegs>();
  const int wg = warp >> 2;              // consumer warpgroup = head slot
  if (wg == 1 && !both) return;
  const int wl = warp & 3;
  const uint32_t my_q = q_s + wg * LQ::kBytes;
  const int head = kvh * G + 2 * pass + wg;
  float acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row0 = q0 + 16 * wl + (lane >> 2);   // rows row0, row0 + 8
  uint32_t pa[4][4];                     // P of the last tile, as A
  mbar_wait(qbar(wg), 0);
  if (both && wg == 1) repro::named_arrive(1, 256);

  // turn j: P V of tile j - 1 (j > 0), then S of tile j (j < n_tiles)
  for (int j = 0; j <= n_tiles; ++j) {
    const int st = j % kStages, sp = (j + 1) % kStages;   // tiles j, j - 1
    const int k0 = k_lo + j * kRows;
    if (j < n_tiles) mbar_wait(full_k(st), (j / kStages) & 1);
    if (j > 0) mbar_wait(full_v(sp), ((j - 1) / kStages) & 1);
    repro::jitter(6);
    if (both) repro::named_sync(1 + wg, 256);
    if (j > 0) {
      // O += P V at the V tile's width DV
      repro::fence_regs(acc);
      repro::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        repro::wgmma_rs<DV>(acc, pa[kk],
                            LV::mnmajor(v_s + sp * LV::kBytes, kk));
      repro::wgmma_commit();
      repro::wgmma_wait_all();
      repro::fence_regs(acc);
    }
    float s[32];
    if (j < n_tiles) {
      // S = Q K^T over the KS k slices that hold columns of q and k
      repro::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        repro::wgmma_ss_n64(s, LQ::kmajor(my_q, kk),
                            LQ::kmajor(k_s + st * LQ::kBytes, kk), kk > 0);
      repro::wgmma_commit();
      repro::wgmma_wait_all();
      repro::fence_regs(s);
    }
    if (both && !(wg == 1 && j == n_tiles))
      repro::named_arrive(2 - wg, 256);
    // this warp's reads of K(j) and V(j - 1) are done
    repro::jitter(7);
    __syncwarp();
    if (lane == 0) {
      if (j < n_tiles) mbar_arrive(empty_k(st));
      if (j > 0) mbar_arrive(empty_v(sp));
    }
    if (j < n_tiles)
      softmax_tile<DV>(s, acc, m, l, pa, k0, q0, row0, lane, T, q_offset,
                       window, scale_log2);
  }

  store_tile_tma<DV>(acc, l, my_q, &to, b, head, q0, wg, wl, lane);
}

// One launch of the two-head layout, or with info its report (as
// launch_tc's)
template <int DV, int KS>
int launch_pp(const void* q, const void* k, const void* v, void* o,
              const Shape& sh, cudaStream_t stream, int* info) {
  static int granted = 48 * 1024;
  constexpr size_t smem = pp::smem_bytes<DV>();
  auto kernel = flash_tc_kernel_pp<DV, KS>;
  cudaError_t err = repro::allow_smem(kernel, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  if (info != nullptr) {
    cudaFuncAttributes a{};
    err = cudaFuncGetAttributes(&a, kernel);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &info[2], kernel, pp::kThreads, smem);
    info[0] = a.numRegs;
    info[1] = (int)a.localSizeBytes;
    info[3] = (int)smem;
    info[4] = 2;
    return (int)err;
  }
  CUtensorMap tq, tk, tv, to;
  if (!head_tensor_map<pp::kD>(&tq, q, sh.B, sh.S, sh.H, sh.Dqk) ||
      !head_tensor_map<pp::kD>(&tk, k, sh.B, sh.T, sh.KV, sh.Dqk) ||
      !head_tensor_map<DV>(&tv, v, sh.B, sh.T, sh.KV, sh.Dv) ||
      !head_tensor_map<DV>(&to, o, sh.B, sh.S, sh.H, sh.Dv))
    return (int)cudaErrorInvalidValue;
  dim3 grid(sh.KV * ((sh.H / sh.KV + 1) / 2), sh.B,
            (sh.S + kRows - 1) / kRows);
  kernel<<<grid, pp::kThreads, smem, stream>>>(
      tq, tk, tv, to, sh.S, sh.T, sh.H, sh.KV, sh.q_offset, sh.window,
      sh.scale_log2);
  return (int)cudaGetLastError();
}

// The layout at D = 256 (heads a CTA) that a launch of these sizes takes:
// two where G >= 2 and the two-head grid, KV * ceil(G / 2) * B * q-tiles
// CTAs at one an SM, still fills the card's SMs; else one (the serve's
// prefills of one request at S <= 384 give 8-48 two-head CTAs, under a
// wave: one head a CTA keeps 16-96 of them and two or three an SM)
int heads_at_256(const Shape& sh) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  const int G = sh.H / sh.KV;
  const long long ctas = (long long)sh.KV * ((G + 1) / 2) * sh.B *
                         ((sh.S + kRows - 1) / kRows);
  return G >= 2 && ctas >= sms ? 2 : 1;
}

// NC consumer warpgroups by the pair (D, DV) and the group G: at DV = D <=
// 64, 4, 2 or 1 heads of a group (registers: four accumulators of 64
// columns fit); one at D = DV = 128 (two heads a CTA, each K/V tile read by
// both consumers, lost in turns at mistral-nemo-12b's G 4 to one head with
// two CTAs an SM) and at the MLA pairs (more q-row tiles of one head a CTA
// lost in turns to more, smaller CTAs); at D = 256 two (flash_tc_kernel_pp)
// or one by heads_at_256, or `heads` where a caller forces the layout. Q
// K^T runs D / 16 k slices, and at the MLA pairs 3 D / 64 where Dqk <= 3 D
// / 4 (MiniCPM3's 96 of 128: 6; its reduced 48 of 64: 3).
template <int D, int DV>
int dispatch_pair(const void* q, const void* k, const void* v, void* o,
                  const Shape& sh, cudaStream_t stream, int* info,
                  int heads) {
  constexpr int kAll = D / 16;
  if constexpr (D == 256) {
    if ((heads == 0 ? heads_at_256(sh) : heads) == 2)
      return launch_pp<DV, kAll>(q, k, v, o, sh, stream, info);
    return launch_tc<D, DV, kAll, 1>(q, k, v, o, sh, stream, info);
  } else if (heads != 0) {
    return (int)cudaErrorInvalidValue;   // a layout is forced at 256 only
  } else if constexpr (DV < D) {
    constexpr int kMla = 3 * D / 64;
    if ((sh.Dqk + 15) / 16 <= kMla)
      return launch_tc<D, DV, kMla, 1>(q, k, v, o, sh, stream, info);
    return launch_tc<D, DV, kAll, 1>(q, k, v, o, sh, stream, info);
  } else if constexpr (D == 128) {
    return launch_tc<D, DV, kAll, 1>(q, k, v, o, sh, stream, info);
  } else {
    const int G = sh.H / sh.KV;
    if (G >= 4) return launch_tc<D, DV, kAll, 4>(q, k, v, o, sh, stream, info);
    if (G >= 2) return launch_tc<D, DV, kAll, 2>(q, k, v, o, sh, stream, info);
    return launch_tc<D, DV, kAll, 1>(q, k, v, o, sh, stream, info);
  }
}

// The pairs (width, v_width) instantiated: D = DV at 32, 64, 128 and 256;
// MLA's (128, 64) (MiniCPM3's 96 / 64) and (64, 32) (its reduced 48 / 32);
// (256, 128) and (256, 64). Any other pair is refused with
// cudaErrorNotSupported.
int dispatch(const void* q, const void* k, const void* v, void* o,
             const Shape& sh, cudaStream_t stream, int* info, int heads) {
  switch (sh.width * 1000 + sh.v_width) {
    case 32032:
      return dispatch_pair<32, 32>(q, k, v, o, sh, stream, info,
                                      heads);
    case 64064:
      return dispatch_pair<64, 64>(q, k, v, o, sh, stream, info,
                                      heads);
    case 64032:
      return dispatch_pair<64, 32>(q, k, v, o, sh, stream, info,
                                      heads);
    case 128128:
      return dispatch_pair<128, 128>(q, k, v, o, sh, stream, info,
                                      heads);
    case 128064:
      return dispatch_pair<128, 64>(q, k, v, o, sh, stream, info,
                                      heads);
    case 256256:
      return dispatch_pair<256, 256>(q, k, v, o, sh, stream, info,
                                      heads);
    case 256128:
      return dispatch_pair<256, 128>(q, k, v, o, sh, stream, info,
                                      heads);
    case 256064:
      return dispatch_pair<256, 64>(q, k, v, o, sh, stream, info,
                                      heads);
    default:
      return (int)cudaErrorNotSupported;
  }
}

}  // namespace tc

// The launch's sizes, or false when the C entries refuse them: width is
// the compiled D that holds Dqk, v_width the one that holds Dv
bool make_shape(int B, int S, int T, int H, int KV, int width, int Dqk,
                int Dv, int q_offset, int window, float scale, Shape* sh) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || Dqk % 8 || Dv % 8 ||
      Dv <= 0 || Dv > Dqk || Dqk > width)
    return false;
  const int v_width = Dv <= 32 ? 32 : Dv <= 64 ? 64 : Dv <= 128 ? 128 : 256;
  *sh = Shape{B, S, T, H, KV, width, v_width, Dqk, Dv, q_offset, window,
              (float)(1.4426950408889634 * (double)scale)};
  return true;
}

}  // namespace

// q (B, S, H, Dqk), k (B, T, KV, Dqk), v (B, T, KV, Dv), o (B, S, H, Dv);
// width: the compiled D (32, 64, 128 or 256) that holds Dqk; Dqk and Dv
// multiples of 8 with Dv <= Dqk; scale: the scores' scale; window <= 0
// means no sliding window. bfloat16 takes the pairs of width and the width
// that holds Dv that tc::dispatch lists, and returns cudaErrorNotSupported
// for any other.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int T, int H, int KV, int width,
                                     int Dqk, int Dv, int q_offset,
                                     int window, float scale, int dtype,
                                     void* stream) {
  Shape sh;
  if (!make_shape(B, S, T, H, KV, width, Dqk, Dv, q_offset, window, scale,
                  &sh))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) return f32::dispatch(q, k, v, o, sh, s);
  if (dtype == repro::kBFloat16)
    return tc::dispatch(q, k, v, o, sh, s, nullptr, 0);
  return (int)cudaErrorInvalidValue;
}

// The bf16 kernel instantiation that a launch of these sizes runs, without
// launching it: info[0 ... 4] = registers a thread, local (spill) bytes a
// thread, CTAs an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// shared memory bytes a CTA, heads NC a CTA. The same return codes as
// repro_flash_attention's.
extern "C" int repro_flash_tc_info(int B, int S, int T, int H, int KV,
                                   int width, int Dqk, int Dv, int* info) {
  Shape sh;
  if (!make_shape(B, S, T, H, KV, width, Dqk, Dv, 0, -1, 1.f, &sh))
    return (int)cudaErrorInvalidValue;
  return tc::dispatch(nullptr, nullptr, nullptr, nullptr, sh, nullptr, info,
                      0);
}

// The bf16 kernel at width 256 in the layout `heads` (1 or 2 q heads a
// CTA) whatever the grid, to compare the two on the same inputs; with
// info, no launch: info as repro_flash_tc_info's. The same arguments and
// return codes as repro_flash_attention's otherwise (bfloat16 only); any
// other width or heads is refused with cudaErrorInvalidValue.
extern "C" int repro_flash_attention_heads(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int S, int T, int H, int KV,
                                           int width, int Dqk, int Dv,
                                           int q_offset, int window,
                                           float scale, int heads, int* info,
                                           void* stream) {
  Shape sh;
  if (width != 256 || (heads != 1 && heads != 2) ||
      !make_shape(B, S, T, H, KV, width, Dqk, Dv, q_offset, window, scale,
                  &sh))
    return (int)cudaErrorInvalidValue;
  return tc::dispatch(q, k, v, o, sh, static_cast<cudaStream_t>(stream),
                      info, heads);
}
