// Mamba-2 SSD chunked scan: the intra-chunk terms and the inter-chunk
// state pass.
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk.py (ssd_chunk_intra,
// body _kernel) and the associative scan of its wrapper ssd_chunked_pallas.
// Per (batch b, chunk c, head h) of x (B, S, nh, hd), dt (B, S, nh),
// A (nh,), B/C (B, S, N) (one state group, shared by all heads):
//
//   cum_i    = sum_{k <= i} dt_k * A                (within the chunk)
//   y_i      = sum_{j <= i} exp(cum_i - cum_j) * dt_j * (C_i . B_j) * x_j
//   state    = sum_j exp(total - cum_j) * dt_j * x_j (x) B_j     (hd, N)
//   cum_exp  = exp(cum),  decay = exp(total),  total = cum_{chunk-1}
//
// and then, per (b, h), h_prev[c] = sum over the chunks before c of their
// states decayed to chunk c: h_prev[0] = 0, run = run * decay[c] + state[c];
// y_inter = (C_i * exp(cum_i)) . h_prev[c]^T.
//
// Numerics: the JAX model's ssd_chunked, whose einsums round C . B^T and
// the weights W = (C . B^T) * L * dt to the input type before W . x (no-ops
// in float32, where every term matches the Pallas kernel's; one bfloat16
// rounding each in bfloat16).
//
// Bound on the H100: bytes at the serving path's shapes. At (1, 256, 80,
// 64, N 128) in bf16 the function reads x, dt, B, C once (~2.9 MB) and
// writes y and the final state (~5.2 MB): ~2.4 us at 3.35 TB/s, against
// ~0.7 GFLOP (~0.7 us on the bf16 tensor cores).
//
// Five C entry points, one per route; the wrapper picks the route by
// dtype and shape alone (kernels/ssd_chunk.py, ssd_route):
//
//   bf16, chunk < 64 dividing 64, hd 64, N 32 / 64 / 128: tensor-core scan
//   every other chunk < 64 (hd a multiple of 16, N <= 256): recurrent
//   bf16, chunk a multiple of 64, hd 64, N 32 / 64 / 128: tensor cores
//   f32, the same shapes: tensor cores as split TF32
//   everything else (long odd chunks, other hd and N): CUDA cores
//
// repro_ssd_chunk_tc_scan, bfloat16 at chunks below 64 that divide 64 (the
// halving rule from 256 gives no others: chunk 1 at every odd prefill
// length, 2 at 258, ...): ssd_tc_scan_kernel. The function does not depend
// on the chunk; the chunk only decides which pairs the reference rounds as
// T(W) . x (those inside one chunk) and which it carries through the f32
// state (those across chunks). So the sequence goes by 64-row tiles on the
// tensor cores: per tile the block diagonal of chunk x chunk blocks,
// rounded as the reference rounds it, the strictly lower rest and the
// state entering the tile kept float32-accurate (operands split into three
// bf16 terms), and the state handed to the next tile. The serial chain is
// S / 64 tiles, not S rows. Bound on the H100 at (1, 383, 80, 64, N 128),
// chunk 1: bytes, as the intra-chunk routes' (~3.2 us). The products this
// kernel issues are ~5.2 MFLOP a CTA and tile, 5.0 GFLOP there (5.1 us at
// the bf16 peak: the three-term operands triple the state's, Y's and the
// cross terms', and each of the 160 CTAs forms C . B^T itself). Layout,
// schedule and numerics: see scan::ssd_tc_scan_kernel.
//
// repro_ssd_chunk_recurrent, every other chunk below 64 (float32, chunk
// 63, other hd or N): ssd_scores_kernel, then ssd_recurrent_kernel, writing
// y and the final
// state only. The first forms the intra-chunk scores T(C_i . B_j), j <= i,
// once for all heads (n_groups is 1), summed in float64 so that their
// rounding to bf16 does not depend on an order of summation; the second
// carries each head's f32 state h (hd x N) across the sequence in
// registers, chunk by chunk, with the same roundings as the chunked form:
// inside a chunk the pairs j <= i are the rounded W . x of the reference,
// the state entering the chunk adds T((C_i exp(cum_i)) . h^T), and at the
// chunk's end h = h * exp(total) + S_c (a multiply, then an add, as the
// state pass). At chunk 1 that is h_t = h_{t-1} exp(dt_t A) + dt_t x_t
// B_t^T. This kernel's work is rank-1 f32 updates (~1.5 GFLOP at chunk 1,
// S 383, x 80 heads of 64, N 128) whose floor on the CUDA cores is 22.5
// us there: that is this design's floor, not the function's bound, which
// is the bytes (~3.2 us at that shape; the tensor-core scan above takes
// that shape in bf16). Per-CTA layout and schedule: see
// rec::ssd_recurrent_kernel.
//
// The other three routes end with the same state pass and write the
// per-chunk states, cumsum exponentials and decays for the wrapper's
// y_inter.
//
// repro_ssd_chunk_tc, bfloat16 at chunks that are multiples of 64, hd 64,
// N 32 / 64 / 128 (every chunk the mamba2-2.7b serve runs):
// ssd_intra_tc_kernel, on the tensor cores. The intra-chunk term has the
// structure of a causal flash forward pass: C_i . B_j^T takes the place of
// Q . K^T, the decay weights exp(cum_i - cum_j) * dt_j that of the softmax,
// W . x_j that of P . V. One CTA per (64-row i-tile, group of G heads,
// batch row and chunk) runs one warpgroup per head (G is 1 or 2, picked by
// the wrapper from the grid size). One thread TMA-loads C_i, the B_j tiles
// once for the G heads and each head's x_j tiles (3-D maps over (B, S, N)
// and (B, S, nh * hd)) into shared memory at once, each j-tile behind its
// own mbarrier: the working set (152 KB at chunk 256, N 128, G 2) fits, so
// no ring is refilled. Each warpgroup forms C_i . B_j^T with wgmma
// m64n64k16 (both K-major, K = N), applies the decay weights to the
// accumulator registers, rounds them to bf16 as A-operand registers and
// adds W . x_j with a second wgmma (x_j MN-major). Below the diagonal tile
// the decay exp(cum_i - cum_j) is the product of a row factor
// exp(cum_i - cum_i0) and a column factor exp(cum_i0 - cum_j) (i0 the
// i-tile's first row; both <= 1 since A < 0), taken once per row and
// column, so an entry costs two products instead of an exponential (the
// value agrees to a few float32 ulps, far inside W's bf16 rounding); on
// the diagonal tile the exponent is taken per entry, only where j <= i.
// The CTA of i-tile 0, which has the least y work, also forms the chunk
// state sum_j (x_j u_j) (x) B_j as m64nN products over k = j, with
// A = (x u)^T built in registers and split into bf16 hi + lo (one rounding
// of x u to bf16 would cost ~2^-9 of each term, ~1e-2 on a state of ~10;
// hi + lo keeps ~2^-17). No atomics: repeated launches are bit-equal. The
// grid runs i-tile 0 first, then the others by most j-tiles.
//
// repro_ssd_chunk_tf32, float32 at the tensor-core route's shapes (every
// f32 chunk of 64 and up that mamba2-2.7b runs): ssd_scores_tf32_kernel,
// then ssd_intra_tf32_kernel, on the tensor cores as split TF32 (tf32.cuh:
// three TF32 wgmma products per product, float32-accurate with TF32 off).
// Bound on the H100 at (1, 256, 80, 64, N 128), chunk 256: operations,
// ~0.68 GFLOP at 165 TFLOP/s (4.1 us), just above its bytes (x and y,
// 5.2 MB each, and the 2.6 MB final state: ~13.4 MB, 4.0 us at 3.35 TB/s).
// The bf16 design does not carry over: TF32 wgmma reads shared-memory
// operands K-major only, and float32 tiles are twice as large, so C_i and
// the B_j tiles as hi and lo planes (64 KB each at N 128) with a ring of
// x_j tiles do not fit in 227 KB. C . B^T does not depend on the head
// (n_groups is 1), so the first kernel forms it once per chunk for every
// head (one warpgroup per 64 x 64 tile pair, i-tile >= j-tile) into a
// (B, nc, chunk, chunk) buffer that stays in L2; the second reads its tile
// straight into accumulator-layout registers. One CTA per (64-row i-tile,
// group of G heads, batch row and chunk) runs a producer warpgroup, which
// streams each head's x_j as x_j^T hi and lo planes through a two-stage
// mbarrier ring, and one consumer warpgroup per head, which forms the
// decay weights W in float32 on the registers, splits them as the A
// operand of W . x_j, and (in the CTA of i-tile 0) the chunk state
// transposed, state^T = sum_j (B_j u_j)^T . x_j, with A = (B_j u_j)^T read
// from L2 into registers: only what wgmma reads from shared memory goes
// through the ring. G is 2 when a grid of two-head CTAs covers the SMs
// (ssd_tc_heads, as the bf16 kernel), else 1. Layout, schedule and the
// hand-over rules: see tf32x3::ssd_intra_tf32_kernel.
//
// repro_ssd_chunk, the shapes no other route takes (the tests' chunk 200,
// hd 16 / 32 / 128, N 256): ssd_intra_kernel on the CUDA cores. The TPU
// kernel holds a whole chunk in VMEM (B and C alone are 128 KB each in
// float32 at chunk 256, N 128).
// Here one CTA of 256 threads per (b, c, h) walks 64-row i-tiles; for each
// it loops over the j-tiles at or below it, forms C_i . B_j^T over N in
// 32-wide shared-memory slices (each thread owns a 4 x 4 block of scores),
// applies the decay weights only where j <= i, and accumulates W . x_j
// into a 4 x (hd / 16) register block of y. The (hd, N) state is then
// accumulated over 64-column slices of N. Both products run over the
// chunk's rows only, so a short chunk does not pay for a whole tile.
// Everything is float32 on the CUDA cores.
//
// Every route runs the cumsum sequentially in one thread, in the order of
// torch.cumsum, so cum agrees with the plain version's bit for bit (the
// decay exponents are differences of cums, which cancel ~1e-4 of |cum|
// otherwise).
//
// The state pass is one thread per (p, n) state entry, 256 entries per CTA,
// walking the chunks in order; it overwrites the chunk states with h_prev
// in place (S / chunk * nh * hd * N floats, so no chunk below 64 comes
// here: the recurrent route keeps none).
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "tf32.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kT = 64;          // rows of an i- or j-tile
constexpr int kNK = 32;         // N slice of the C . B^T product
constexpr int kNS = 64;         // N slice of the state
constexpr int kMaxChunk = 256;
constexpr int kMaxN = 256;

template <typename E, int HD>
__global__ void __launch_bounds__(kThreads)
ssd_intra_kernel(const E* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const E* __restrict__ Bm,
                 const E* __restrict__ Cm, E* __restrict__ y,
                 float* __restrict__ states, float* __restrict__ cum_exp,
                 float* __restrict__ decay, int S, int nh, int N,
                 int chunk) {
  constexpr int DJ = HD / 16;
  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = S / chunk;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t t0 = (size_t)b * S + (size_t)c * chunk;  // chunk's first row

  extern __shared__ float smem[];
  float* cum = smem;                   // kMaxChunk
  float* dts = cum + kMaxChunk;        // kMaxChunk
  float* u = dts + kMaxChunk;          // kMaxChunk: exp(total - cum_j) dt_j
  float* Cs = u + kMaxChunk;           // kT * (kNK + 1)
  float* Bs = Cs + kT * (kNK + 1);     // kT * (kNK + 1)
  float* Ws = Bs + kT * (kNK + 1);     // kT * (kT + 1); B slice of the state
  float* Xs = Ws + kT * (kT + 1);      // kT * HD

  const float a = A[h];
  for (int i = tid; i < chunk; i += kThreads) {
    const float d = dt[(t0 + i) * nh + h];
    dts[i] = d;
    cum[i] = d * a;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int i = 0; i < chunk; ++i) {
      s += cum[i];
      cum[i] = s;
    }
  }
  __syncthreads();
  const float total = cum[chunk - 1];
  for (int i = tid; i < chunk; i += kThreads) {
    u[i] = expf(total - cum[i]) * dts[i];
    cum_exp[(t0 + i) * nh + h] = expf(cum[i]);
  }
  if (tid == 0) decay[((size_t)b * nc + c) * nh + h] = expf(total);
  __syncthreads();

  // ---- y_intra ---------------------------------------------------------
  for (int i0 = 0; i0 < chunk; i0 += kT) {
    float acc[4][DJ];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < DJ; ++q) acc[r][q] = 0.f;

    for (int j0 = 0; j0 <= i0; j0 += kT) {
      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[r][q] = 0.f;
      for (int n0 = 0; n0 < N; n0 += kNK) {
        for (int e = tid; e < kT * kNK; e += kThreads) {
          const int r = e / kNK, k = e % kNK, n = n0 + k;
          const int ii = i0 + r, jj = j0 + r;
          Cs[r * (kNK + 1) + k] =
              (ii < chunk && n < N) ? repro::to_float(Cm[(t0 + ii) * N + n])
                                    : 0.f;
          Bs[r * (kNK + 1) + k] =
              (jj < chunk && n < N) ? repro::to_float(Bm[(t0 + jj) * N + n])
                                    : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < kNK; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty * 4 + r) * (kNK + 1) + k];
#pragma unroll
          for (int q = 0; q < 4; ++q) bv[q] = Bs[(tx + 16 * q) * (kNK + 1) + k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) s[r][q] += cv[r] * bv[q];
        }
        __syncthreads();
      }
      // decay weights, lower triangle only
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + tx + 16 * q;
          float w = 0.f;
          if (i < chunk && j <= i) {
            const float sc = repro::to_float(repro::from_float<E>(s[r][q]));
            w = repro::to_float(
                repro::from_float<E>(sc * expf(cum[i] - cum[j]) * dts[j]));
          }
          Ws[(ty * 4 + r) * (kT + 1) + tx + 16 * q] = w;
        }
      }
      // rows j >= chunk carry zero weight: load and sum only the others
      const int jn = min(kT, chunk - j0);
      for (int e = tid; e < jn * HD; e += kThreads) {
        const int r = e / HD, p = e % HD, jj = j0 + r;
        Xs[r * HD + p] = repro::to_float(x[((t0 + jj) * nh + h) * HD + p]);
      }
      __syncthreads();
      for (int k = 0; k < jn; ++k) {
        float xv[DJ];
#pragma unroll
        for (int q = 0; q < DJ; ++q) xv[q] = Xs[k * HD + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float w = Ws[(ty * 4 + r) * (kT + 1) + k];
#pragma unroll
          for (int q = 0; q < DJ; ++q) acc[r][q] += w * xv[q];
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      if (i >= chunk) continue;
      E* yrow = y + ((t0 + i) * nh + h) * HD;
#pragma unroll
      for (int q = 0; q < DJ; ++q)
        yrow[tx + 16 * q] = repro::from_float<E>(acc[r][q]);
    }
  }

  // ---- chunk state: sum_j (x_j * u_j) (x) B_j ---------------------------
  float* st = states + (((size_t)b * nc + c) * nh + h) * HD * N;
  for (int n0 = 0; n0 < N; n0 += kNS) {
    float acc[DJ][4];  // p = ty + 16 r, n = n0 + tx + 16 q
#pragma unroll
    for (int r = 0; r < DJ; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
    for (int j0 = 0; j0 < chunk; j0 += kT) {
      const int jn = min(kT, chunk - j0);
      for (int e = tid; e < jn * HD; e += kThreads) {
        const int r = e / HD, p = e % HD, jj = j0 + r;
        Xs[r * HD + p] =
            repro::to_float(x[((t0 + jj) * nh + h) * HD + p]) * u[jj];
      }
      for (int e = tid; e < jn * kNS; e += kThreads) {
        const int r = e / kNS, k = e % kNS, n = n0 + k;
        Ws[r * kNS + k] =
            n < N ? repro::to_float(Bm[(t0 + j0 + r) * N + n]) : 0.f;
      }
      __syncthreads();
      for (int k = 0; k < jn; ++k) {
        float bv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = Ws[k * kNS + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < DJ; ++r) {
          const float xv = Xs[k * HD + ty + 16 * r];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] += xv * bv[q];
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < DJ; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + tx + 16 * q;
        if (n < N) st[(size_t)(ty + 16 * r) * N + n] = acc[r][q];
      }
  }
}

// h_prev[c] = run (the state entering chunk c), run = run * decay[c] +
// state[c]; rounded as the plain version's multiply, then add.
__global__ void __launch_bounds__(kThreads)
ssd_state_pass_kernel(float* __restrict__ states,
                      const float* __restrict__ decay,
                      float* __restrict__ final_state, int nc, int nh,
                      int P) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (e >= P) return;
  float run = 0.f;
  size_t row = (size_t)b * nc * nh + h;
  float s = states[row * P + e];
  for (int c = 0; c < nc; ++c) {
    // the next chunk's state is loaded before this one is overwritten,
    // so the loads of consecutive chunks overlap
    const float s_next = c + 1 < nc ? states[(row + nh) * P + e] : 0.f;
    states[row * P + e] = run;
    run = __fadd_rn(__fmul_rn(run, decay[row]), s);
    s = s_next;
    row += nh;
  }
  final_state[((size_t)b * nh + h) * P + e] = run;
}

// the state pass over the chunk states either intra-chunk kernel wrote
int state_pass(void* states, const void* decay, void* final_state, int B,
               int nc, int nh, int P, cudaStream_t stream) {
  dim3 grid((P + kThreads - 1) / kThreads, nh, B);
  ssd_state_pass_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<float*>(states), static_cast<const float*>(decay),
      static_cast<float*>(final_state), nc, nh, P);
  return (int)cudaGetLastError();
}

template <int HD>
size_t smem_bytes() {
  return sizeof(float) * (3 * kMaxChunk + 2 * kT * (kNK + 1) +
                          kT * (kT + 1) + kT * HD);
}

template <typename E, int HD>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* states, void* cum_exp, void* decay,
           void* final_state, int B, int S, int nh, int N, int chunk,
           cudaStream_t stream) {
  static int granted = 48 * 1024;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err =
      repro::allow_smem(ssd_intra_kernel<E, HD>, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  const int nc = S / chunk;
  dim3 grid(nh, nc, B);
  ssd_intra_kernel<E, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const E*>(Bm),
      static_cast<const E*>(Cm), static_cast<E*>(y),
      static_cast<float*>(states), static_cast<float*>(cum_exp),
      static_cast<float*>(decay), S, nh, N, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return state_pass(states, decay, final_state, B, nc, nh, HD * N, stream);
}

template <typename E>
int dispatch_hd(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, void* y, void* states, void* cum_exp,
                void* decay, void* final_state, int B, int S, int nh, int hd,
                int N, int chunk, cudaStream_t stream) {
#define REPRO_SSD_CASE(HD)                                                   \
  case HD:                                                                   \
    return launch<E, HD>(x, dt, A, Bm, Cm, y, states, cum_exp, decay,        \
                         final_state, B, S, nh, N, chunk, stream);
  switch (hd) {
    REPRO_SSD_CASE(16)
    REPRO_SSD_CASE(32)
    REPRO_SSD_CASE(64)
    REPRO_SSD_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_SSD_CASE
}

// ---------------------------------------------------------------------------
// bfloat16 at chunks that are multiples of 64: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::pack_bf16;
using repro::smem_addr;
using repro::tensor_map;
using repro::Tile;
using repro::tma_tile;

constexpr int kRows = repro::kTileRows;    // rows of an i- or j-tile
constexpr int kHD = 64;                    // the head dim it takes

__device__ __forceinline__ void wg_sync(int wg) {   // one warpgroup's barrier
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Shared memory from a 1024-byte aligned base, for n_it = chunk / 64:
// C_i, the chunk's B_j tiles (n_it), each head's x_j tiles (G * n_it),
// then per head cum, dt, u (chunk floats each) and the i-tile's row
// factors (64 floats), then n_it barriers.
template <int N, int G>
size_t smem_bytes(int chunk) {
  const int n_it = chunk / kRows;
  return 1024 + (size_t)(1 + n_it) * Tile<N>::kBytes +
         (size_t)G * n_it * Tile<kHD>::kBytes +
         (size_t)G * (3 * chunk + kRows) * 4 + 8 * n_it;
}

// One head's chunk state (hd x N, row stride N) at `out`: sum_j (x_j u_j)
// (x) B_j over the chunk's j-tiles, as m64nN products over k = j. A =
// (x u)^T from registers, rows p of the head dim; the float32 products
// x_j u_j are split into bf16 hi + lo (B is exact in bf16), so the sum
// keeps them to ~2^-17 as the plain version's float32 einsum. The j-th B
// tile is at b0 + j * Tile<N>::kBytes, the j-th x tile at
// x0 + j * Tile<64>::kBytes.
template <int N>
__device__ __forceinline__ void chunk_state(float* out, uint32_t b0,
                                            const uint8_t* x0,
                                            const float* u, int n_it,
                                            uint32_t bars, int r_lo,
                                            int lane) {
  using LB = Tile<N>;
  float st[N / 2];
#pragma unroll
  for (int k = 0; k < N / 2; ++k) st[k] = 0.f;
  for (int j = 0; j < n_it; ++j) {
    mbar_wait(bars + 8 * j, 0);
    const uint8_t* xt = x0 + j * Tile<kHD>::kBytes;
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = r_lo + 8 * (r & 1);
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // x_j[p] in the 128-byte-swizzled tile: 16-byte unit p / 8 of
          // row jl, xor'ed with jl % 8
          const int jl = 16 * kk + 8 * (r >> 1) + 2 * (lane & 3) + e;
          const __nv_bfloat16 xv = *reinterpret_cast<const __nv_bfloat16*>(
              xt + jl * 128 + (((p >> 3) ^ (jl & 7)) << 4) + (p & 7) * 2);
          v[e] = __bfloat162float(xv) * u[j * kRows + jl];
        }
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[0], v[1]);
        ahi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
        alo[kk][r] = pack_bf16(v[0] - __low2float(hi),
                               v[1] - __high2float(hi));
      }
    repro::fence_regs(st);
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = LB::mnmajor(b0 + j * LB::kBytes, kk);
      repro::wgmma_rs<N>(st, ahi[kk], db);
      repro::wgmma_rs<N>(st, alo[kk], db);
    }
    repro::wgmma_commit();
    repro::wgmma_wait_all();
    repro::fence_regs(st);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float* srow = out + (size_t)(r_lo + 8 * hh) * N;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj)
      *reinterpret_cast<float2*>(srow + 8 * jj + 2 * (lane & 3)) =
          make_float2(st[4 * jj + 2 * hh], st[4 * jj + 2 * hh + 1]);
  }
}

template <int N, int G>
__global__ void __launch_bounds__(G * 128, 4 / G)
ssd_intra_tc_kernel(const __grid_constant__ CUtensorMap tmx,
                    const __grid_constant__ CUtensorMap tmb,
                    const __grid_constant__ CUtensorMap tmc,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ states,
                    float* __restrict__ cum_exp, float* __restrict__ decay,
                    int S, int nh, int chunk) {
  using LB = Tile<N>;       // a 64-row tile of B or C
  using LX = Tile<kHD>;     // a 64-row tile of one head's x
  const int n_it = chunk / kRows;
  const int nc = S / chunk;
  // grid (head groups, B * nc, i-tiles): i-tile 0, which also forms the
  // chunk state, first; then the others, most j-tiles first
  const int it = blockIdx.z == 0 ? 0 : n_it - blockIdx.z;
  const int hg = blockIdx.x;
  const int b = blockIdx.y / nc;
  const int c = blockIdx.y % nc;
  const bool with_state = it == 0;
  const int n_load = with_state ? n_it : it + 1;   // j-tiles it reads
  const int rows = n_load * kRows;                 // rows whose cum it needs
  const int i0 = it * kRows;
  const int n_heads = min(G, nh - hg * G);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;                         // warpgroup = head slot
  const int t = tid & 127;
  const int wl = t >> 5;
  const int lane = tid & 31;
  const int h = hg * G + wg;
  const int row0 = c * chunk;                      // in its batch row
  const size_t t0 = (size_t)b * S + row0;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t c_s = base;
  const uint32_t b_s = c_s + LB::kBytes;
  const uint32_t x_s = b_s + n_it * LB::kBytes;
  const uint32_t scal = x_s + G * n_it * LX::kBytes;
  const uint32_t bars = scal + G * (3 * chunk + kRows) * 4;
  uint8_t* const sbase = smem_raw + (base - raw);
  float* const cum = reinterpret_cast<float*>(sbase + (scal - base)) +
                     wg * (3 * chunk + kRows);
  float* const dts = cum + chunk;
  // i-tile 0: exp(total - cum_j) * dt_j, for the state; the others:
  // exp(cum_i0 - cum_j) * dt_j for j < i0, the column factors of W
  float* const u = dts + chunk;
  float* const rowf = u + chunk;    // exp(cum_i - cum_i0), i in the i-tile
  auto bar = [&](int j) { return bars + 8 * j; };
  auto b_tile = [&](int j) { return b_s + j * LB::kBytes; };
  auto x_tile = [&](int g, int j) {
    return x_s + (g * n_it + j) * LX::kBytes;
  };

  if (tid == 0) {
    for (int j = 0; j < n_load; ++j) mbar_init(bar(j), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // every tile the CTA reads, at once: the whole working set fits in
  // shared memory, so there is no ring to refill and no producer warp
  if (tid == 0) {
    for (int j = 0; j < n_load; ++j) {
      mbar_expect_tx(bar(j), (j == 0 ? LB::kBytes : 0) + LB::kBytes +
                                 n_heads * LX::kBytes);
      if (j == 0) tma_tile<N>(c_s, &tmc, bar(0), 0, row0 + i0, b);
      tma_tile<N>(b_tile(j), &tmb, bar(j), 0, row0 + j * kRows, b);
      for (int g = 0; g < n_heads; ++g)
        tma_tile<kHD>(x_tile(g, j), &tmx, bar(j), (hg * G + g) * kHD,
                      row0 + j * kRows, b);
    }
  }
  if (wg >= n_heads) return;

  // ---- decay terms: a sequential cumsum in torch's order -----------------
  const float a = A[h];
  for (int i = t; i < rows; i += 128) {
    const float d = dt[(t0 + i) * nh + h];
    dts[i] = d;
    cum[i] = d * a;
  }
  wg_sync(wg);
  if (t == 0) {   // 32 rows at a time: 16-byte loads, then the add chain
    float s = 0.f;
    float4* const c4 = reinterpret_cast<float4*>(cum);
    for (int k0 = 0; k0 < rows / 4; k0 += 8) {
      float4 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = c4[k0 + e];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += v[e].x;
        v[e].x = s;
        s += v[e].y;
        v[e].y = s;
        s += v[e].z;
        v[e].z = s;
        s += v[e].w;
        v[e].w = s;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) c4[k0 + e] = v[e];
    }
  }
  wg_sync(wg);
  if (with_state) {
    const float total = cum[chunk - 1];
    for (int i = t; i < chunk; i += 128) {
      u[i] = expf(total - cum[i]) * dts[i];
      cum_exp[(t0 + i) * nh + h] = expf(cum[i]);
    }
    if (t == 0) decay[((size_t)b * nc + c) * nh + h] = expf(total);
  } else {
    const float ci0 = cum[i0];
    for (int j = t; j < i0; j += 128) u[j] = expf(ci0 - cum[j]) * dts[j];
    if (t < kRows) rowf[t] = expf(cum[i0 + t] - ci0);
  }
  wg_sync(wg);

  // ---- y_intra of i-tile it: sum over j-tiles <= it of W . x_j ----------
  // W = bf16(bf16(C_i . B_j) * exp(cum_i - cum_j) * dt_j) where j <= i.
  // Below the diagonal tile (j < i0 <= i) the decay factors into
  // exp(cum_i - cum_i0) * exp(cum_i0 - cum_j), both <= 1 (A < 0), so an
  // entry costs two products; on the diagonal tile the exponent is taken
  // per entry, and only where j <= i (above, it would overflow).
  const int r_lo = 16 * wl + (lane >> 2);   // tile rows r_lo, r_lo + 8
  float rf[2] = {0.f, 0.f};
  if (!with_state) {
    rf[0] = rowf[r_lo];
    rf[1] = rowf[r_lo + 8];
  }
  float acc[kHD / 2];
#pragma unroll
  for (int k = 0; k < kHD / 2; ++k) acc[k] = 0.f;
  for (int j = 0; j <= it; ++j) {
    mbar_wait(bar(j), 0);
    float s[32];
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      repro::wgmma_ss_n64(s, LB::kmajor(c_s, kk), LB::kmajor(b_tile(j), kk),
                          kk > 0);
    repro::wgmma_commit();
    repro::wgmma_wait_all();
    repro::fence_regs(s);
    if (j < it) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float cf = u[j * kRows + 8 * jj + 2 * (lane & 3) + e];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float& v = s[4 * jj + 2 * hh + e];
            v = round_bf16(v) * rf[hh] * cf;
          }
        }
    } else {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int il = i0 + r_lo + 8 * hh;
        const float ci = cum[il];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jl = i0 + 8 * jj + 2 * (lane & 3) + e;
            float& v = s[4 * jj + 2 * hh + e];
            v = jl <= il ? round_bf16(v) * expf(ci - cum[jl]) * dts[jl]
                         : 0.f;
          }
      }
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    repro::fence_regs(acc);
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      repro::wgmma_rs<kHD>(acc, pa[kk], LX::mnmajor(x_tile(wg, j), kk));
    repro::wgmma_commit();
    repro::wgmma_wait_all();
    repro::fence_regs(acc);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    __nv_bfloat16* yrow = y + ((t0 + i0 + r_lo + 8 * hh) * nh + h) * kHD;
#pragma unroll
    for (int jj = 0; jj < kHD / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(yrow + 8 * jj + 2 * (lane & 3)) =
          __floats2bfloat162_rn(acc[4 * jj + 2 * hh],
                                acc[4 * jj + 2 * hh + 1]);
  }
  if (!with_state) return;

  // ---- chunk state: sum_j (x_j u_j) (x) B_j, (hd x N) --------------------
  chunk_state<N>(states + (((size_t)b * nc + c) * nh + h) * kHD * N, b_s,
                 sbase + (x_tile(wg, 0) - base), u, n_it, bars, r_lo, lane);
}

template <int N, int G>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* states, void* cum_exp, void* decay,
           void* final_state, int B, int S, int nh, int chunk,
           cudaStream_t stream) {
  static int granted = 48 * 1024;
  CUtensorMap mx, mb, mc;
  if (!tensor_map<kHD>(&mx, x, B, S, nh) || !tensor_map<N>(&mb, Bm, B, S, 1) ||
      !tensor_map<N>(&mc, Cm, B, S, 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<N, G>(chunk);
  cudaError_t err =
      repro::allow_smem(ssd_intra_tc_kernel<N, G>, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  const int nc = S / chunk;
  dim3 grid((nh + G - 1) / G, B * nc, chunk / kRows);
  ssd_intra_tc_kernel<N, G><<<grid, G * 128, smem, stream>>>(
      mx, mb, mc, static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(states), static_cast<float*>(cum_exp),
      static_cast<float*>(decay), S, nh, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return state_pass(states, decay, final_state, B, nc, nh, kHD * N, stream);
}

template <int N>
int dispatch_group(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, void* states,
                   void* cum_exp, void* decay, void* final_state, int B,
                   int S, int nh, int chunk, int group,
                   cudaStream_t stream) {
#define REPRO_SSD_TC_CASE(G)                                                 \
  case G:                                                                    \
    return launch<N, G>(x, dt, A, Bm, Cm, y, states, cum_exp, decay,         \
                        final_state, B, S, nh, chunk, stream);
  switch (group) {
    REPRO_SSD_TC_CASE(1)
    REPRO_SSD_TC_CASE(2)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_SSD_TC_CASE
}

}  // namespace tc

// ---------------------------------------------------------------------------
// chunks below 64: the recurrent kernel
// ---------------------------------------------------------------------------

namespace rec {

constexpr int kLanes = 8;                  // lanes per row, a slice of N each
constexpr int kRows = 16;                  // head-dim rows of a CTA
constexpr int kThreads = kRows * kLanes;   // 128
constexpr int kBlock = 48;                 // sequence rows staged at once
constexpr int kMaxChunk = 63;
constexpr int kScoreWarps = 8;             // warps per CTA of the scores

// rows of one staged block: whole chunks, up to kBlock rows; a longer
// chunk is a block of its own
__host__ __device__ __forceinline__ int block_rows(int chunk) {
  return chunk <= kBlock ? (kBlock / chunk) * chunk : chunk;
}
// staged rows, padded to whole groups of kLanes rows with rows that change
// nothing (zero x, B and C, u 0, decay 1)
__host__ __device__ __forceinline__ int padded(int rows) {
  return (rows + kLanes - 1) / kLanes * kLanes;
}

// per staged row: dt, cum, exp(cum), u = exp(total - cum) dt, exp(total)
constexpr int kScalars = 5;

template <int KQ>
size_t smem_bytes(int chunk) {
  const int R = padded(block_rows(chunk));
  return sizeof(float) * (size_t)R *
         (2 * 4 * kLanes * KQ + 2 * kRows + (chunk | 1) + kScalars);
}

template <typename E>
__device__ __forceinline__ float round_t(float v) {
  return repro::to_float(repro::from_float<E>(v));
}

// 16 bytes of E, loaded as one vector, to float in shared memory (16-byte
// aligned)
template <typename E>
__device__ __forceinline__ void store_vec(float* dst, const uint4& raw) {
  constexpr int V = 16 / sizeof(E);
  const E* v = reinterpret_cast<const E*>(&raw);
#pragma unroll
  for (int k = 0; k < V; k += 4)
    *reinterpret_cast<float4*>(dst + k) =
        make_float4(repro::to_float(v[k]), repro::to_float(v[k + 1]),
                    repro::to_float(v[k + 2]), repro::to_float(v[k + 3]));
}

// scores[(b S + s) chunk + jl] = T(C_s . B_j), j = s - s % chunk + jl <= s:
// the intra-chunk scores, one warp per pair. n_groups is 1, so they serve
// every head; the products are summed in float64 and rounded to float32
// (then to x's type), the exact float32 value of the reference's einsum,
// so that no order of summation flips their rounding to bfloat16.
template <typename E>
__global__ void __launch_bounds__(kScoreWarps * 32)
ssd_scores_kernel(const E* __restrict__ Bm, const E* __restrict__ Cm,
                  float* __restrict__ scores, long long n_pairs, int N,
                  int chunk) {
  const int lane = threadIdx.x & 31;
  const long long e =
      (long long)blockIdx.x * kScoreWarps + (threadIdx.x >> 5);
  if (e >= n_pairs) return;
  const long long t = e / chunk;          // b S + s
  const int jl = (int)(e % chunk), i = (int)(t % chunk);
  if (jl > i) return;
  const long long tj = t - i + jl;
  double acc = 0.0;
  for (int n = lane; n < N; n += 32)
    acc += (double)repro::to_float(Cm[t * N + n]) *
           (double)repro::to_float(Bm[tj * N + n]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) scores[e] = round_t<E>(__double2float_rn(acc));
}

// One CTA per (16 rows of one head's state, head, batch row): 320 CTAs of
// 128 threads at mamba2-2.7b's shapes, about 2.4 per SM. Thread (row,
// lane) holds h[p][n] and the chunk's state S[p][n] in registers for
// n = 32 q + 4 lane + e (q < KQ, e < 4), so a row's 8 lanes read 128
// contiguous bytes of a staged B or C row and the warp's 4 rows the same
// ones (a broadcast). The sequence goes by blocks of up to 48 rows (whole
// chunks, padded to groups of 8 rows that change nothing): the block's B,
// C, x rows and dt are staged to shared memory as float (all loads of a
// thread in flight at once), each chunk's cumsum is taken by one thread
// in torch's order, the weights W_rj = T(score_rj exp(cum_r - cum_j) dt_j)
// of the pairs inside one chunk are formed from ssd_scores_kernel's
// scores, and T(sum_{j<=r} W_rj x_j) is summed ahead of the recurrence (T
// the rounding to x's type). Then per row r, in order:
//   y_inter partial  C_r . h over the lane's slice (h: entering r's chunk)
//   S               += (x_r u_r) B_r
//   at a chunk's end h = h * exp(total) + S (a multiply, then an add);
//   at chunk 1 directly h = h * exp(dt_r A) + (x_r u_r) B_r,
// in groups of 8 rows that the compiler schedules as one block at chunk 1.
// After each group the partials are reduce-scattered over the 8 lanes (7
// shuffles), and lane l finishes row r0 + l: y = T(y_intra) +
// T(exp(cum_r) (C_r . h)), rounded once more.
template <typename E, int KQ>
__global__ void __launch_bounds__(kThreads)
ssd_recurrent_kernel(const E* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const E* __restrict__ Bm,
                     const E* __restrict__ Cm,
                     const float* __restrict__ scores, E* __restrict__ y,
                     float* __restrict__ final_state, int S, int nh, int hd,
                     int N, int chunk) {
  constexpr int NP = 4 * kLanes * KQ;   // N padded to whole lane rows
  constexpr int NQ = NP / 4;            // float4 per staged row
  constexpr int NPL = 4 * KQ;           // state entries per thread and row
  constexpr int V = 16 / sizeof(E);     // elements per 16-byte load
  constexpr int kBatch = 8;             // vector loads in flight per thread
  const int p0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int prow = tid / kLanes;
  const int lane = tid % kLanes;
  const int R = block_rows(chunk);
  const int RP = padded(R);
  const int wst = chunk | 1;      // W's row stride, odd: no bank conflict
  // 16-byte loads of B and C where whole rows of vectors line up
  const bool vec_n = N % V == 0 && (reinterpret_cast<uintptr_t>(Bm) |
                                    reinterpret_cast<uintptr_t>(Cm)) % 16 == 0;

  extern __shared__ float4 smem4[];
  float* const Cs = reinterpret_cast<float*>(smem4);
  float* const Bs = Cs + RP * NP;
  float* const xs = Bs + RP * NP;  // (RP, kRows): the CTA's rows of x
  float* const yi = xs + RP * kRows;   // (RP, kRows): T(y_intra)
  float* const W = yi + RP * kRows;
  float* const dts = W + RP * wst;
  float* const cum = dts + RP;
  float* const ecum = cum + RP;
  float* const u = ecum + RP;
  float* const dec = u + RP;
  const float4* const Cs4 = reinterpret_cast<const float4*>(Cs);
  const float4* const Bs4 = reinterpret_cast<const float4*>(Bs);

  const float a = A[h];
  const size_t row0 = (size_t)b * S;
  float hs[NPL], st[NPL];
#pragma unroll
  for (int m = 0; m < NPL; ++m) hs[m] = st[m] = 0.f;

  for (int s0 = 0; s0 < S; s0 += R) {
    const int rows = min(R, S - s0);   // whole chunks, as S % chunk == 0
    const int rows_p = padded(rows);
    const size_t t0 = row0 + s0;
    __syncthreads();                   // the last block's reads are done
    // ---- stage x, dt, B and C (zero past N): every load of a batch is
    // issued before the first store ------------------------------------------
    {
      uint4 rxv[2];                    // padded(63) * kRows <= 2 kThreads V
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int e = (tid + k * kThreads) * V;
        rxv[k] = make_uint4(0, 0, 0, 0);
        if (e < rows * kRows)
          rxv[k] = *reinterpret_cast<const uint4*>(
              x + ((t0 + e / kRows) * nh + h) * hd + p0 + e % kRows);
      }
      const float dv = tid < rows ? dt[(t0 + tid) * nh + h] : 0.f;
      const int n_vec = rows_p * (NP / V);
      for (int e0 = tid; e0 < n_vec; e0 += kBatch * kThreads) {
        uint4 rb[kBatch], rc[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int e = e0 + k * kThreads;
          const int r = e / (NP / V), n = e % (NP / V) * V;
          rb[k] = rc[k] = make_uint4(0, 0, 0, 0);
          if (e < n_vec && vec_n && n < N && r < rows) {
            rb[k] = *reinterpret_cast<const uint4*>(Bm + (t0 + r) * N + n);
            rc[k] = *reinterpret_cast<const uint4*>(Cm + (t0 + r) * N + n);
          }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int e = e0 + k * kThreads;
          if (e >= n_vec) break;
          const int r = e / (NP / V), n = e % (NP / V) * V;
          if (vec_n || n >= N || r >= rows) {
            store_vec<E>(Bs + r * NP + n, rb[k]);
            store_vec<E>(Cs + r * NP + n, rc[k]);
          } else {                     // a row length of no whole vectors
            for (int i = 0; i < V; ++i) {
              const size_t g = (t0 + r) * N + n + i;
              Bs[r * NP + n + i] = n + i < N ? repro::to_float(Bm[g]) : 0.f;
              Cs[r * NP + n + i] = n + i < N ? repro::to_float(Cm[g]) : 0.f;
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int e = (tid + k * kThreads) * V;
        if (e < rows_p * kRows) store_vec<E>(xs + e, rxv[k]);
      }
      if (tid < rows) dts[tid] = dv;   // rows <= 63 < kThreads
    }
    __syncthreads();
    // ---- decay terms: each chunk's cumsum in one thread, in torch's
    // order, 8 rows loaded ahead of the add chain ----------------------------
    for (int c0 = tid * chunk; c0 < rows; c0 += kThreads * chunk) {
      float s = 0.f;
      for (int k0 = 0; k0 < chunk; k0 += 8) {
        float d[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          d[k] = k0 + k < chunk ? dts[c0 + k0 + k] : 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (k0 + k >= chunk) break;
          s += d[k] * a;
          cum[c0 + k0 + k] = s;
        }
      }
    }
    __syncthreads();
    for (int r = tid; r < rows_p; r += kThreads) {
      if (r >= rows) {                 // a padding row
        ecum[r] = u[r] = 0.f;
        dec[r] = 1.f;
        continue;
      }
      const float total = cum[r - r % chunk + chunk - 1];
      ecum[r] = expf(cum[r]);
      u[r] = expf(total - cum[r]) * dts[r];
      dec[r] = expf(total);
    }
    // ---- W of the pairs j <= r inside one chunk --------------------------
    for (int e0 = tid; e0 < rows * chunk; e0 += kBatch * kThreads) {
      float sc[kBatch];                // the scores' loads first
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int e = e0 + k * kThreads;
        sc[k] = e < rows * chunk ? scores[t0 * chunk + e] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int e = e0 + k * kThreads;
        const int r = e / chunk, jl = e % chunk;
        const int j = r - r % chunk + jl;
        if (e < rows * chunk && j <= r)
          W[r * wst + jl] =
              round_t<E>(sc[k] * expf(cum[r] - cum[j]) * dts[j]);
      }
    }
    __syncthreads();
    // ---- y_intra = T(sum_{j<=r} W_rj x_j) of the rows this thread
    // finishes below (r = lane mod kLanes), ahead of the recurrence --------
    const float* const xrow = xs + prow;
#pragma unroll 2
    for (int r = lane; r < rows; r += kLanes) {
      const int c0 = r - r % chunk;
      float acc = 0.f;
      for (int j = c0; j <= r; ++j)
        acc += W[r * wst + j - c0] * xrow[j * kRows];
      yi[r * kRows + prow] = round_t<E>(acc);
    }
    // ---- the recurrence over the block's rows --------------------------
    // one row: its y_inter partial, then the state. `one` (chunk 1: every
    // row ends its chunk) is a constant in each of the two unrolled loops
    // below, so at chunk 1 a group of kLanes rows has no branch
    int cl = 0;                        // rows of the current chunk done
    const auto row = [&](int r, bool one) {
      const float xu = xrow[r * kRows] * u[r];
      float bv[NPL];
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int q = 0; q < KQ; ++q) {
        const float4 cv = Cs4[r * NQ + kLanes * q + lane];
        const float4 b4 = Bs4[r * NQ + kLanes * q + lane];
        bv[4 * q] = b4.x;
        bv[4 * q + 1] = b4.y;
        bv[4 * q + 2] = b4.z;
        bv[4 * q + 3] = b4.w;
        d0 += cv.x * hs[4 * q] + cv.y * hs[4 * q + 1];
        d1 += cv.z * hs[4 * q + 2] + cv.w * hs[4 * q + 3];
      }
      if (one) {
        const float dc = dec[r];
#pragma unroll
        for (int m = 0; m < NPL; ++m)
          hs[m] = __fadd_rn(__fmul_rn(hs[m], dc), xu * bv[m]);
      } else {
#pragma unroll
        for (int m = 0; m < NPL; ++m) st[m] += xu * bv[m];
        if (++cl == chunk) {           // the chunk ends
          const float dc = dec[r];
#pragma unroll
          for (int m = 0; m < NPL; ++m) {
            hs[m] = __fadd_rn(__fmul_rn(hs[m], dc), st[m]);
            st[m] = 0.f;
          }
          cl = 0;
        }
      }
      return d0 + d1;
    };
    for (int r0 = 0; r0 < rows_p; r0 += kLanes) {
      float part[kLanes];
      if (chunk == 1) {
#pragma unroll
        for (int k = 0; k < kLanes; ++k) part[k] = row(r0 + k, true);
      } else {
#pragma unroll
        for (int k = 0; k < kLanes; ++k) part[k] = row(r0 + k, false);
      }
      // reduce-scatter: lane l ends with the whole sum of row r0 + l
#pragma unroll
      for (int half = kLanes / 2; half >= 1; half /= 2) {
        const bool up = lane & half;
#pragma unroll
        for (int k = 0; k < half; ++k)
          part[k] = (up ? part[k + half] : part[k]) +
                    __shfl_xor_sync(0xffffffffu, up ? part[k] : part[k + half],
                                    half);
      }
      const int r = r0 + lane;
      if (r < rows) {
        const float yv = yi[r * kRows + prow] + round_t<E>(part[0] * ecum[r]);
        y[((t0 + r) * nh + h) * hd + p0 + prow] = repro::from_float<E>(yv);
      }
    }
  }
  float* const out = final_state + (((size_t)b * nh + h) * hd + p0 + prow) * N;
#pragma unroll
  for (int q = 0; q < KQ; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 4 * kLanes * q + 4 * lane + e;
      if (n < N) out[n] = hs[4 * q + e];
    }
}

template <typename E, int KQ>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* scores, void* y, void* final_state, int B,
           int S, int nh, int hd, int N, int chunk, cudaStream_t stream) {
  static int granted = 48 * 1024;
  const long long n_pairs = (long long)B * S * chunk;
  ssd_scores_kernel<E><<<(unsigned)((n_pairs + kScoreWarps - 1) / kScoreWarps),
                         kScoreWarps * 32, 0, stream>>>(
      static_cast<const E*>(Bm), static_cast<const E*>(Cm),
      static_cast<float*>(scores), n_pairs, N, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes<KQ>(chunk);
  err = repro::allow_smem(ssd_recurrent_kernel<E, KQ>, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(hd / kRows, nh, B);
  ssd_recurrent_kernel<E, KQ><<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const E*>(Bm),
      static_cast<const E*>(Cm), static_cast<const float*>(scores),
      static_cast<E*>(y), static_cast<float*>(final_state), S, nh, hd, N,
      chunk);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch_n(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, void* scores, void* y, void* final_state,
               int B, int S, int nh, int hd, int N, int chunk,
               cudaStream_t stream) {
  if (N <= 4 * kLanes)
    return launch<E, 1>(x, dt, A, Bm, Cm, scores, y, final_state, B, S, nh,
                        hd, N, chunk, stream);
  if (N <= 8 * kLanes)
    return launch<E, 2>(x, dt, A, Bm, Cm, scores, y, final_state, B, S, nh,
                        hd, N, chunk, stream);
  if (N <= 16 * kLanes)
    return launch<E, 4>(x, dt, A, Bm, Cm, scores, y, final_state, B, S, nh,
                        hd, N, chunk, stream);
  return launch<E, 8>(x, dt, A, Bm, Cm, scores, y, final_state, B, S, nh, hd,
                      N, chunk, stream);
}

}  // namespace rec

// ---------------------------------------------------------------------------
// bfloat16 at chunks below 64 that divide 64: the tensor-core scan
// ---------------------------------------------------------------------------

namespace scan {

using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::pack_bf16;
using repro::smem_addr;
using repro::tensor_map;
using repro::Tile;
using repro::tma_tile;

constexpr int kRows = repro::kTileRows;   // sequence rows of a tile
constexpr int kHD = 64;                   // the head dim it takes
constexpr int kPS = 32;                   // head-dim columns of a CTA
constexpr int kThreads = 128;             // one warpgroup
constexpr int kStages = 2;                // the ring of C, B and x tiles
// x's tile of the CTA's 32 columns; h^T's planes (N rows of the same 32
// columns) are laid out alike
using LX = Tile<kPS>;

// bf16 rounding to nearest even of a finite float, on the integer pipe:
// its bits with the low 16 cleared (a single-value conversion goes through
// the pipe of the exponentials, and cost the pair weights most of their
// time)
__device__ __forceinline__ uint32_t rne_bits(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b + 0x7fffu + ((b >> 16) & 1u)) & 0xffff0000u;
}
__device__ __forceinline__ float rne(float v) {
  return __uint_as_float(rne_bits(v));
}
// the high halves of two floats' bits as a bf16 pair, the first low
__device__ __forceinline__ uint32_t pack_hi(uint32_t b0, uint32_t b1) {
  return __byte_perm(b0, b1, 0x7632);
}

// (v0, v1) as three bf16 pairs, hi + mid + lo, whose sum keeps ~2^-24 of
// each value: the reference's f32 terms enter the bf16 tensor cores at f32
// accuracy. Paired conversions: one instruction per two values.
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float r0 = v0 - __low2float(h), r1 = v1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = pack_bf16(r0 - __low2float(m), r1 - __high2float(m));
}

// Shared memory from a 1024-byte aligned base: kStages stages of (C, B, x)
// tiles; h^T's three bf16 planes (N rows of 32 columns); (u x)'s three
// (64 rows of 32); the tile's scalars (7 arrays of 64 and G_end); then the
// barriers. Under 113 KB at N 128: two CTAs an SM.
template <int N>
struct Layout {
  static constexpr uint32_t kStage = 2 * Tile<N>::kBytes + LX::kBytes;
  static constexpr uint32_t kPlane = N * LX::kRowBytes;
  static constexpr uint32_t planes = kStages * kStage;
  static constexpr uint32_t ux = planes + 3 * kPlane;
  static constexpr uint32_t scal = ux + 3 * LX::kBytes;
  static constexpr int kScalFloats = 7 * kRows + 4;
  static constexpr uint32_t bars = scal + 4 * kScalFloats;
  static constexpr uint32_t bytes = bars + 8 * kStages;
};

// One CTA (one warpgroup) per (32 head-dim columns, head, batch row): 160
// CTAs at mamba2-2.7b's 80 heads of 64, two an SM. y[:, p] and h[p, :]
// depend on their own column p only, so the two halves of a head run
// apart; C . B^T does not depend on the head (n_groups is 1) and each CTA
// forms it itself. The sequence goes by 64-row tiles, the float32 state h
// (hd x N) carried from tile to tile in registers as h^T (rows n, columns
// p: the accumulator of an m64n32 product, N / 64 of them). Thread 0 keeps
// the next tile's C, B and x tiles in flight by TMA through a two-stage
// mbarrier ring (zero-filled past S; the padding rows get dt 0, so u 0
// and decay 1, and change nothing). Per tile:
//  - batch A of products: S = C . B^T (m64n64k16 over N) and Y = C . h^T
//    (m64n32k16 over N, h^T from three bf16 planes in shared memory);
//  - meanwhile warp 0 takes the decay terms by shuffles (decay_terms):
//    each chunk's cumsum in torch's order; G_i, the sum of dt A from the
//    tile's start to i; for the state u_j = exp(R_j) dt_j, R_j the sum
//    after j. Every dt A is <= 0, so a sum of them keeps its own
//    precision and a difference of two long ones does not (at |A| 80,
//    G_i - G_j lost ~1e-3 of the exponent): the decay between rows j < i
//    of two 8-row groups is exp(F_i + M[g_i][g_j]) exp(Bk_j) (F the sum
//    from i's group start, M the groups between, Bk the sum from j + 1 to
//    j's group end: factors <= 1 that cannot overflow), inside one group
//    exp(F_i - F_j), or the reference's exp(cum_i - cum_j) in one chunk;
//  - (u x)_j as three bf16 planes; batch B: h^T = h^T exp(G_end) + B^T .
//    (u x) (m64n32k16 over j, B's tile read as an M-major A operand);
//  - while B runs, the pair weights on S's registers, without a branch so
//    that a thread's 32 entries interleave: the pairs in one chunk W_d =
//    T(T(S) decay dt_j) (T the bf16 rounding), as the reference rounds
//    them; the pairs across chunks W_x = S decay dt_j in float32, as three
//    bf16 terms; only the 4 pairs a thread holds in its row's own 8-row
//    group take an exponential (masked before the exp: above the diagonal
//    it would overflow), the others a product of a row factor and cd_j;
//  - batch C: y_intra = W_d . x; y_inter = exp(G_i) Y + W_x . x. These are
//    the reference's float32 terms: one bf16 rounding of an operand would
//    cost ~2^-9 of each term, hi + lo ~2^-17, which made T(y_inter) round
//    the other way often enough to put y a bf16 ulp of |y_inter| (0.0625
//    at 8) off where y_intra cancels it; hi + mid + lo keeps ~2^-24
//    (split3);
//  - y = T(T(y_intra) + T(y_inter)), the reference's add in bf16; h^T's
//    new planes for the next tile.
// The serial chain is S / 64 tiles instead of S rows. No atomics: repeated
// launches are bit-equal. tools/ssd_scan_ab.py --probe reads the cycles of
// each phase.
template <int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_tc_scan_kernel(const __grid_constant__ CUtensorMap tmx,
                   const __grid_constant__ CUtensorMap tmb,
                   const __grid_constant__ CUtensorMap tmc,
                   const float* __restrict__ dt, const float* __restrict__ A,
                   __nv_bfloat16* __restrict__ y,
                   float* __restrict__ final_state, int S, int nh, int lc) {
  using L = Layout<N>;
  using LB = Tile<N>;
  constexpr int MB = N < 64 ? 1 : N / 64;   // m64 blocks of h^T's rows
  const int ps = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3;
  const int r_lo = 16 * warp + (lane >> 2);   // accumulator rows r_lo, +8
  const int chunk = 1 << lc;
  const int n_tiles = (S + kRows - 1) / kRows;
  const size_t row0 = (size_t)b * S;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  float* const dts = reinterpret_cast<float*>(sbase + L::scal);
  float* const cum = dts + kRows;   // each chunk's own cumsum
  float* const F = cum + kRows;     // sum of dt A from the row's group start
  float* const cd = F + kRows;      // exp(Bk_j) dt_j, Bk_j the sum from the
                                    // next row to the group's end
  float* const u = cd + kRows;      // exp(R_j) dt_j
  float* const eG = u + kRows;      // exp(G_i)
  float* const M = eG + kRows;      // [g][g']: the groups strictly between
  float* const gend = M + kRows;    // the tile's G_end
  auto full = [&](int st) { return base + L::bars + 8 * st; };
  auto c_tile = [&](int st) { return base + st * L::kStage; };
  auto b_tile = [&](int st) { return c_tile(st) + LB::kBytes; };
  auto x_tile = [&](int st) { return c_tile(st) + 2 * LB::kBytes; };

  // h = 0 entering the sequence: zero planes, read by wgmma's async proxy
  for (int i = tid; i < 3 * (int)L::kPlane / 16; i += kThreads)
    reinterpret_cast<uint4*>(sbase + L::planes)[i] = make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(full(st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load = [&](int t) {
    const int st = t % kStages;
    mbar_expect_tx(full(st), 2 * LB::kBytes + LX::kBytes);
    tma_tile<N>(c_tile(st), &tmc, full(st), 0, t * kRows, b);
    tma_tile<N>(b_tile(st), &tmb, full(st), 0, t * kRows, b);
    tma_tile<kPS>(x_tile(st), &tmx, full(st), (h * (kHD / kPS) + ps) * kPS,
                  t * kRows, b);
  };
  if (tid == 0) load(0);
  const float a = A[h];
  // warp 0 takes the decay terms, rows 2 lane and 2 lane + 1 of a tile
  auto dt_at = [&](int r) { return r < S ? dt[(row0 + r) * nh + h] : 0.f; };
  float dn0 = 0.f, dn1 = 0.f;
  if (warp == 0) {
    dn0 = dt_at(2 * lane);
    dn1 = dt_at(2 * lane + 1);
  }
  // ---- tile t's decay terms, in warp 0 by shuffles: lane l holds rows 2 l
  // and 2 l + 1. Every dt A is <= 0, so a sum of them keeps its own
  // precision, and a difference of two long ones does not ------------------
  auto decay_terms = [&](int t) {
    const float d0 = dn0, d1 = dn1;
    dn0 = dt_at((t + 1) * kRows + 2 * lane);   // the next tile's, ahead
    dn1 = dt_at((t + 1) * kRows + 2 * lane + 1);
    const float v0 = d0 * a, v1 = d1 * a;
    // each chunk's cumsum in torch's order: a chunk of c >= 2 rows is c /
    // 2 lanes, each adding its two rows to its left neighbour's sum
    float c0 = v0, c1 = v0 + v1;
    if (chunk == 1) c1 = v1;
    for (int k = 1; k < chunk / 2; ++k) {
      const float prev = __shfl_up_sync(0xffffffffu, c1, 1);
      if ((lane & (chunk / 2 - 1)) == k) {
        c0 = prev + v0;
        c1 = c0 + v1;
      }
    }
    const float pair = v0 + v1;
    // F (from the 8-row group's start, inclusive) over its 4 lanes; the
    // group's total at its last lane
    float gin = pair;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, gin, off);
      if ((lane & 3) >= off) gin += o;
    }
    float gex = __shfl_up_sync(0xffffffffu, gin, 1);
    if ((lane & 3) == 0) gex = 0.f;
    // Bk (from the next row to the group's end)
    float gsuf = pair;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, gsuf, off);
      if ((lane & 3) + off < 4) gsuf += o;
    }
    float gsx = __shfl_down_sync(0xffffffffu, gsuf, 1);
    if ((lane & 3) == 3) gsx = 0.f;
    // G (from the tile's start, inclusive) and R (from the next row to
    // the tile's end), over the warp
    float tin = pair;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, tin, off);
      if (lane >= off) tin += o;
    }
    float tex = __shfl_up_sync(0xffffffffu, tin, 1);
    if (lane == 0) tex = 0.f;
    float tsuf = pair;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, tsuf, off);
      if (lane + off < 32) tsuf += o;
    }
    float tsx = __shfl_down_sync(0xffffffffu, tsuf, 1);
    if (lane == 31) tsx = 0.f;
    // M[g][g'] = the totals of the groups strictly between, g > g'
    float gt[8];
#pragma unroll
    for (int g = 0; g < 8; ++g)
      gt[g] = __shfl_sync(0xffffffffu, gin, 4 * g + 3);
#pragma unroll
    for (int e = lane; e < 64; e += 32) {
      const int g = e >> 3, g1 = e & 7;
      float acc = 0.f;
#pragma unroll
      for (int k = 1; k < 7; ++k)
        if (k > g1 && k < g) acc += gt[k];
      M[e] = acc;
    }
    const int i = 2 * lane;
    dts[i] = d0;
    dts[i + 1] = d1;
    cum[i] = c0;
    cum[i + 1] = c1;
    F[i] = gex + v0;
    F[i + 1] = gin;
    cd[i] = expf(gsx + v1) * d0;
    cd[i + 1] = expf(gsx) * d1;
    eG[i] = expf(tex + v0);
    eG[i + 1] = expf(tin);
    u[i] = expf(tsx + v1) * d0;
    u[i + 1] = expf(tsx) * d1;
    if (lane == 31) *gend = tin;
  };
  float hs[MB][kPS / 2];   // h^T[n = 64 mb + r_lo + 8 hh][p = 8 jj + 2 t4 + e]
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int k = 0; k < kPS / 2; ++k) hs[mb][k] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    const int r0 = t * kRows;
    // ---- batch A: S = C . B^T (64 x 64) and Y = C . h^T (64 x 32), in
    // flight while warp 0 takes the decay terms ----------------------------
    const uint32_t xs = x_tile(st);
    mbar_wait(full(st), (t / kStages) & 1);
    float s[32], yx[kPS / 2], yi[kPS / 2];
#pragma unroll
    for (int k = 0; k < kPS / 2; ++k) yx[k] = yi[k] = 0.f;
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      repro::wgmma_ss_n64(s, LB::kmajor(c_tile(st), kk),
                          LB::kmajor(b_tile(st), kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint64_t dc = LB::kmajor(c_tile(st), kk);
#pragma unroll
      for (int q = 0; q < 3; ++q)
        repro::wgmma_ss_n32_tb(
            yx, dc, LX::mnmajor(base + L::planes + q * L::kPlane, kk), 1);
    }
    repro::wgmma_commit();

    // the stage of tile t + 1 was last read in tile t - 1, whose end every
    // thread has passed
    if (tid == 0 && t + 1 < n_tiles) load(t + 1);
    if (warp == 0) decay_terms(t);
    __syncthreads();

    // ---- (u x)_j as three bf16 planes; batch B: h^T = h^T exp(G_end) +
    // B^T . (u x) (N x 32), in flight while the pair weights are formed -
#pragma unroll
    for (int c = tid; c < kRows * kPS / 8; c += kThreads) {   // 16-byte units
      const int j = c >> 2;
      const uint32_t off = LX::elem(j, 8 * (c & 3));
      const uint4 raw = *reinterpret_cast<const uint4*>(sbase + (xs - base) +
                                                        off);
      const __nv_bfloat162* const xv =
          reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float uj = u[j];
      uint4 q[3];
      uint32_t* const q0 = &q[0].x;
      uint32_t* const q1 = &q[1].x;
      uint32_t* const q2 = &q[2].x;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(xv[k]);
        split3(f.x * uj, f.y * uj, q0[k], q1[k], q2[k]);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k)
        *reinterpret_cast<uint4*>(sbase + L::ux + k * LX::kBytes + off) = q[k];
    }
    const float decay = expf(*gend);
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int k = 0; k < kPS / 2; ++k) hs[mb][k] *= decay;
    // written by the generic proxy, read by wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        // rows n = 64 mb ... of B^T: B's tile read M-major (N 32: rows 32
        // ... 63 read past the tile and are never used)
        const uint64_t da = LB::mnmajor(b_tile(st) + mb * LB::kAtomBytes, kk);
#pragma unroll
        for (int q = 0; q < 3; ++q)
          repro::wgmma_ss_n32_tt(hs[mb], da,
                                 LX::mnmajor(base + L::ux + q * LX::kBytes,
                                             kk));
      }
    repro::wgmma_commit();
    repro::wgmma_wait<1>();   // batch A is done
    repro::fence_regs(s);
    repro::fence_regs(yx);

    // ---- pair weights on S's registers: row il = r_lo + 8 hh (8-row group
    // g_i = 2 warp + hh), column jl = 8 jj + 2 t4 + e (group jj). W_d (one
    // chunk) into s, rounded as the reference; W_x (across chunks) in
    // float32 into wx. Only the diagonal group's 4 pairs a thread take an
    // exponent, masked before the exp (above the diagonal it would
    // overflow): the reference's cum_i - cum_j in one chunk, F_i - F_j
    // across. The groups before it take exp(F_i + M[g_i][g_j]) exp(Bk_j)
    // dt_j (a row factor and cd_j, both <= 1; pairs in one chunk alike, at
    // chunks of 16 and 32, as the tensor-core route factors below its
    // diagonal tile). No branch, so the 32 entries interleave. --------------
    float wx[32];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int il = r_lo + 8 * hh, gi = 2 * warp + hh;
      const int ki = il >> lc;
      const float ci = cum[il], fi = F[il], egi = eG[il];
#pragma unroll
      for (int jj = 0; jj < kPS / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) yx[4 * jj + 2 * hh + e] *= egi;
      // the diagonal group: S, the exponent and W_d per pair (s's register
      // of group g_i picked by warp)
      float exd[2], wdd[2];
      bool sd_same[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jl = 8 * gi + 2 * t4 + e;
        sd_same[e] = (jl >> lc) == ki;
        const float in_chunk = ci - cum[jl], in_group = fi - F[jl];
        exd[e] = expf(jl > il ? -INFINITY : sd_same[e] ? in_chunk
                                                       : in_group);
        const int k = 2 * hh + e;
        const float sd = warp == 0 ? s[4 * hh + k]
                         : warp == 1 ? s[4 * (2 + hh) + k]
                         : warp == 2 ? s[4 * (4 + hh) + k]
                                     : s[4 * (6 + hh) + k];
        wdd[e] = rne(rne(sd) * exd[e] * dts[jl]);
      }
      float rf[8];   // exp(F_i + M[g_i][g]) before g_i, else 0
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float m = M[8 * gi + jj];
        rf[jj] = expf(jj < gi ? fi + m : -INFINITY);
      }
      if (lc <= 3) {   // chunks of 8 and below: one chunk, one group
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jl = 8 * jj + 2 * t4 + e;
            const bool diag = jj == gi;
            const float f = diag ? (sd_same[e] ? 0.f : exd[e] * dts[jl])
                                 : rf[jj] * cd[jl];
            float& w = s[4 * jj + 2 * hh + e];
            wx[4 * jj + 2 * hh + e] = w * f;
            w = diag && sd_same[e] ? wdd[e] : 0.f;
          }
      } else {         // chunks of 16 and 32 span groups
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jl = 8 * jj + 2 * t4 + e;
            const bool diag = jj == gi;
            const bool same = (jl >> lc) == ki;
            float& w = s[4 * jj + 2 * hh + e];
            const float f = diag ? exd[e] * dts[jl] : rf[jj] * cd[jl];
            wx[4 * jj + 2 * hh + e] = same ? 0.f : w * f;
            w = !same ? 0.f : diag ? wdd[e] : rne(rne(w) * rf[jj] * cd[jl]);
          }
      }
    }
    // as A fragments: k slice kk is columns 16 kk ... 16 kk + 15
    uint32_t wd[4][4], w3[3][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        wd[kk][r] = pack_hi(__float_as_uint(s[8 * kk + 2 * r]),
                            __float_as_uint(s[8 * kk + 2 * r + 1]));
        split3(wx[8 * kk + 2 * r], wx[8 * kk + 2 * r + 1], w3[0][kk][r],
               w3[1][kk][r], w3[2][kk][r]);
      }

    // ---- batch C: y_intra = W_d . x, y_inter = exp(G_i) Y + W_x . x -------
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dx = LX::mnmajor(xs, kk);
      repro::wgmma_rs<kPS>(yi, wd[kk], dx);
#pragma unroll
      for (int q = 0; q < 3; ++q) repro::wgmma_rs<kPS>(yx, w3[q][kk], dx);
    }
    repro::wgmma_commit();
    repro::wgmma_wait_all();   // batches B and C
    repro::fence_regs(yi);
    repro::fence_regs(yx);
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) repro::fence_regs(hs[mb]);

    // ---- y = T(T(y_intra) + T(y_inter)) on the tile's rows below S --------
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = r0 + r_lo + 8 * hh;
      if (i >= S) continue;
      __nv_bfloat16* const yrow = y + ((row0 + i) * nh + h) * kHD + ps * kPS;
#pragma unroll
      for (int jj = 0; jj < kPS / 8; ++jj) {
        const int k = 4 * jj + 2 * hh;
        const __nv_bfloat162 a = __floats2bfloat162_rn(yi[k], yi[k + 1]);
        const __nv_bfloat162 c = __floats2bfloat162_rn(yx[k], yx[k + 1]);
        *reinterpret_cast<__nv_bfloat162*>(yrow + 8 * jj + 2 * t4) =
            __floats2bfloat162_rn(__low2float(a) + __low2float(c),
                                  __high2float(a) + __high2float(c));
      }
    }

    // ---- h^T in three bf16 planes for the next tile's Y -------------------
    __syncthreads();   // every warp's reads of the planes are over
    if (t + 1 < n_tiles) {
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int n = 64 * mb + r_lo + 8 * hh;
          if (n >= N) continue;
#pragma unroll
          for (int jj = 0; jj < kPS / 8; ++jj) {
            uint32_t q3[3];
            split3(hs[mb][4 * jj + 2 * hh], hs[mb][4 * jj + 2 * hh + 1],
                   q3[0], q3[1], q3[2]);
            const uint32_t off = LX::elem(n, 8 * jj + 2 * t4);
#pragma unroll
            for (int q = 0; q < 3; ++q)
              *reinterpret_cast<uint32_t*>(sbase + L::planes +
                                           q * L::kPlane + off) = q3[q];
          }
        }
      // written by the generic proxy, read by wgmma's async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    // the planes are whole, and this tile's stage and scalars are free
    __syncthreads();
  }

  // the final state h[p][n], (B, nh, hd, N)
  float* const out =
      final_state + (((size_t)b * nh + h) * kHD + ps * kPS) * N;
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = 64 * mb + r_lo + 8 * hh;
      if (n >= N) continue;
#pragma unroll
      for (int jj = 0; jj < kPS / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          out[(size_t)(8 * jj + 2 * t4 + e) * N + n] =
              hs[mb][4 * jj + 2 * hh + e];
    }
}

// One launch; with info, no launch: the kernel's registers a thread, local
// (spill) bytes a thread, CTAs an SM holds and shared memory bytes a CTA,
// in info[0 ... 3]
template <int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* final_state, int B, int S, int nh,
           int lc, cudaStream_t stream, int* info) {
  static int granted = 48 * 1024;
  static bool carved = false;
  const size_t smem = 1024 + Layout<N>::bytes;
  auto kernel = ssd_tc_scan_kernel<N>;
  cudaError_t err = repro::allow_smem(kernel, smem, &granted);
  // two CTAs of 115 KB an SM need the largest shared-memory carveout
  if (err == cudaSuccess && !carved) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    carved = err == cudaSuccess;
  }
  if (err != cudaSuccess) return (int)err;
  if (info != nullptr) {
    cudaFuncAttributes a{};
    err = cudaFuncGetAttributes(&a, kernel);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel,
                                                          kThreads, smem);
    info[0] = a.numRegs;
    info[1] = (int)a.localSizeBytes;
    info[3] = (int)smem;
    return (int)err;
  }
  CUtensorMap mx, mb, mc;
  // x as (B, S, nh * 2 column halves of 32)
  if (!tensor_map<kPS>(&mx, x, B, S, nh * (kHD / kPS)) ||
      !tensor_map<N>(&mb, Bm, B, S, 1) || !tensor_map<N>(&mc, Cm, B, S, 1))
    return (int)cudaErrorInvalidValue;
  kernel<<<dim3(kHD / kPS, nh, B), kThreads, smem, stream>>>(
      mx, mb, mc, static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(final_state), S, nh,
      lc);
  return (int)cudaGetLastError();
}

template <typename... Args>
int dispatch_n(int N, Args... args) {
  switch (N) {
    case 32:
      return launch<32>(args...);
    case 64:
      return launch<64>(args...);
    case 128:
      return launch<128>(args...);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace scan

// ---------------------------------------------------------------------------
// float32 at chunks that are multiples of 64: split TF32 on the tensor cores
// ---------------------------------------------------------------------------

namespace tf32x3 {

using repro::cp_async16;
using repro::jitter;
using repro::mbar_arrive;
using repro::mbar_init;
using repro::mbar_wait;
using repro::named_sync;
using repro::Plane;
using repro::smem_addr;
using repro::split;
using repro::split4;

constexpr int kRows = 64;        // rows of an i- or j-tile
constexpr int kHD = 64;          // the head dim it takes
constexpr int kThreads = 128;    // threads per warpgroup
constexpr int kStages = 2;       // the ring of x_j^T planes
using XP = Plane<kHD, kRows>;    // one head's x_j^T: p rows x j positions

// scores[b, c, i, j] = C_i . B_j over the chunk's 64 x 64 tile pairs with
// i-tile >= j-tile, once for every head (n_groups is 1): one warpgroup per
// pair splits C_i and B_j into hi and lo planes (both K-major, K = N) and
// forms the tile with three TF32 wgmma products per product.
template <int N>
__global__ void __launch_bounds__(kThreads)
ssd_scores_tf32_kernel(const float* __restrict__ Bm,
                       const float* __restrict__ Cm,
                       float* __restrict__ scores, int S, int chunk) {
  using P = Plane<kRows, N>;
  constexpr int CH = N / 4;        // 16-byte chunks per row
  int it = 0;                      // blockIdx.x = it (it + 1) / 2 + jt
  while ((it + 1) * (it + 2) / 2 <= (int)blockIdx.x) ++it;
  const int jt = blockIdx.x - it * (it + 1) / 2;
  const int nc = S / chunk;
  const int c = blockIdx.y, b = blockIdx.z;
  const size_t t0 = (size_t)b * S + (size_t)c * chunk;
  const int tid = threadIdx.x;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* const sm = smem_raw + (base - smem_addr(smem_raw));
  const float* const crow = Cm + (t0 + it * kRows) * N;
  const float* const brow = Bm + (t0 + jt * kRows) * N;
#pragma unroll 4
  for (int i = tid; i < kRows * CH; i += kThreads) {
    const int r = i / CH, c4 = i % CH;
    const float4 cv = *reinterpret_cast<const float4*>(crow + r * N + 4 * c4);
    const float4 bv = *reinterpret_cast<const float4*>(brow + r * N + 4 * c4);
    const float cs[4] = {cv.x, cv.y, cv.z, cv.w};
    const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
    uint4 hi, lo;
    split4(cs, hi, lo);
    *reinterpret_cast<uint4*>(sm + P::chunk(r, c4)) = hi;
    *reinterpret_cast<uint4*>(sm + P::kBytes + P::chunk(r, c4)) = lo;
    split4(bs, hi, lo);
    *reinterpret_cast<uint4*>(sm + 2 * P::kBytes + P::chunk(r, c4)) = hi;
    *reinterpret_cast<uint4*>(sm + 3 * P::kBytes + P::chunk(r, c4)) = lo;
  }
  // written by the generic proxy, read by wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float s[32];
  repro::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    const uint64_t ch = P::desc(base, kk);
    const uint64_t cl = P::desc(base + P::kBytes, kk);
    const uint64_t bh = P::desc(base + 2 * P::kBytes, kk);
    const uint64_t bl = P::desc(base + 3 * P::kBytes, kk);
    repro::wgmma_tf32_ss<64>(s, cl, bh, kk > 0);
    repro::wgmma_tf32_ss<64>(s, ch, bl, 1);
    repro::wgmma_tf32_ss<64>(s, ch, bh, 1);
  }
  repro::wgmma_commit();
  repro::wgmma_wait_all();
  repro::fence_regs(s);
  // s[4 jj + 2 hh + e] is row 16 w + g + 8 hh, column 8 jj + 2 t + e
  const int lane = tid & 31;
  const int row = 16 * (tid >> 5) + (lane >> 2);
  float* const out = scores + ((size_t)(b * nc + c) * chunk + it * kRows) *
                                  chunk + jt * kRows;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      *reinterpret_cast<float2*>(out + (size_t)(row + 8 * hh) * chunk +
                                 8 * jj + 2 * (lane & 3)) =
          make_float2(s[4 * jj + 2 * hh], s[4 * jj + 2 * hh + 1]);
}

template <int N>
constexpr size_t scores_smem_bytes() {
  return 1024 + 4 * (size_t)Plane<kRows, N>::kBytes;
}

// Shared memory of the intra-chunk kernel, from a 1024-byte aligned base: a
// ring of kStages stages of each head's x_j^T planes (hi, lo), one float32
// staging tile of x_j per head, each head's scalars (cum, dt, u for up to
// kMaxChunk rows, the i-tile's 64 row factors), then the barriers.
template <int G>
struct Layout {
  static constexpr uint32_t kStageBytes = G * 2 * XP::kBytes;
  static constexpr uint32_t staging = kStages * kStageBytes;
  static constexpr uint32_t scal = staging + G * kRows * kHD * 4;
  static constexpr int kScalFloats = 3 * kMaxChunk + kRows;
  static constexpr uint32_t bars = scal + G * kScalFloats * 4;
  static constexpr uint32_t bytes = bars + 8 * 2 * kStages;
};

template <int G>
constexpr size_t smem_bytes() { return 1024 + Layout<G>::bytes; }

// One CTA per (64-row i-tile, group of G heads, batch row and chunk): G
// consumer warpgroups, one per head, and a producer warpgroup.
//
// The producer copies each j-tile of each head's x_j (64 rows of 64 floats)
// by cp.async into a float32 staging tile, then splits it into a ring
// stage's hi and lo planes of x_j^T (p rows, j positions; TF32 wgmma reads
// B K-major only), with key 8 q + e + 2 m at position 8 q + 4 e + m: the
// order in which the accumulator's registers become the A fragments of W.
//
// Each consumer takes its head's decay terms (a sequential cumsum in
// torch's order), then per j-tile <= its i-tile reads the scores tile from
// ssd_scores_tf32_kernel's output straight into accumulator-layout
// registers, forms the decay weights there in float32 (no rounding: in
// float32 the reference's w.to(x.dtype) does nothing), splits them into hi
// and lo A fragments and adds W . x_j with TF32 wgmma (B = the x_j^T planes).
// The CTA of i-tile 0, which has the least y work, also forms its head's
// chunk state transposed, state^T (N x hd) = sum_j (B_j u_j)^T . x_j with
// u = exp(total - cum) dt: A = (B_j u_j)^T, read from B in device memory
// (L2) into registers and split there, as m64 blocks of N (N 32 pads rows
// 32 ... 63 with zeros); B = the same x_j^T planes. It is written back as
// (hd, N). No atomics: repeated launches are bit-equal, and each head's
// result depends on its own inputs only.
//
// Hand-overs, in the order of a tile's life:
//  - staging tile: each producer thread waits for its own cp.async group,
//    then bar.sync 1 (the producer's 128 threads) makes the float32 tile
//    whole for all; a second bar.sync 1 after the split keeps the next
//    tile's copies out until every thread has read it;
//  - full(st) counts the 128 producer threads, each of which fences its
//    own plane stores to the async proxy (fence.proxy.async) before it
//    arrives; consumers wait on it before their wgmma reads;
//  - empty(st) counts lane 0 of each warp of the CTA's n_heads busy
//    consumers, which arrives after its warp's wgmma.wait_group 0 on the
//    stage's last use (the state CTA keeps tile 0 through its y and its
//    state products), so the stage's reads are over before the producer,
//    waiting on it, writes the stage again; an idle consumer (nh not a
//    multiple of G) never arrives and is not counted;
//  - tile j uses stage j % 2 and waits for phase parity (j / 2) & 1 on
//    full, its complement on empty (a fresh barrier's "previous" phase
//    counts as done, so the first pass through each stage does not wait);
//  - each consumer's scalars: bar.sync 2 + wg (its own 128 threads) after
//    the dt loads, after the cumsum and after the exponentials.
// tools/check_f32_sync.py (target ssd) checks these with compute-sanitizer
// and with repeated launches, also on a build whose warps sleep at random at
// each hand-over (repro::jitter, tf32.cuh).
template <int N, int G>
__global__ void __launch_bounds__(kThreads * (G + 1), 1)
ssd_intra_tf32_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ scores,
                      float* __restrict__ y, float* __restrict__ states,
                      float* __restrict__ cum_exp, float* __restrict__ decay,
                      int S, int nh, int chunk) {
  using L = Layout<G>;
  constexpr int MB = N < 64 ? 1 : N / 64;   // m64 blocks of the state
  const int n_it = chunk / kRows;
  const int nc = S / chunk;
  // grid (head groups, B * nc, i-tiles): i-tile 0, which also forms the
  // chunk state, first; then the others, most j-tiles first
  const int it = blockIdx.z == 0 ? 0 : n_it - blockIdx.z;
  const int hg = blockIdx.x;
  const int b = blockIdx.y / nc;
  const int c = blockIdx.y % nc;
  const bool with_state = it == 0;
  const int n_load = with_state ? n_it : it + 1;   // j-tiles it reads
  const int rows = n_load * kRows;                 // rows whose cum it needs
  const int i0 = it * kRows;
  const int n_heads = min(G, nh - hg * G);
  const int tid = threadIdx.x;
  const int wg = tid / kThreads;     // consumers 0 ... G - 1, then producer
  const int tw = tid % kThreads;
  const size_t t0 = (size_t)b * S + (size_t)c * chunk;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* const sm = smem_raw + (base - smem_addr(smem_raw));
  auto full = [&](int st) { return base + L::bars + 8 * st; };
  auto empty = [&](int st) { return base + L::bars + 8 * (kStages + st); };

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), kThreads);        // every producer thread
      mbar_init(empty(st), n_heads * 4);    // lane 0 of each busy consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == G) {
    // producer: each tile's x_j of the CTA's heads by cp.async into the
    // staging tile, then split into a ring stage's x_j^T planes
    const float* const stage_x = reinterpret_cast<const float*>(sm + L::staging);
    auto load = [&](int j) {
      for (int i = tw; i < n_heads * kRows * (kHD / 4); i += kThreads) {
        const int g = i / (kRows * (kHD / 4));
        const int r = i / (kHD / 4) % kRows, c4 = i % (kHD / 4);
        cp_async16(base + L::staging + 16 * i,
                   x + ((t0 + j * kRows + r) * nh + hg * G + g) * kHD + 4 * c4,
                   true);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    load(0);
    for (int j = 0; j < n_load; ++j) {
      const int st = j % kStages;
      // each thread waits for its own copies, then the barrier makes
      // tile j's float32 staging tile whole for all of them
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      jitter(1);
      named_sync(1, kThreads);
      // the stage is free once every busy consumer warp has arrived on it
      // after its wgmma reads of the stage's previous tile completed
      mbar_wait(empty(st), ((j / kStages) & 1) ^ 1);
      jitter(2);
      uint8_t* const ring = sm + st * L::kStageBytes;
      for (int i = tw; i < n_heads * kHD * (kRows / 4); i += kThreads) {
        const int g = i / (kHD * (kRows / 4));
        const int p = i % kHD, qe = i / kHD % (kRows / 4);
        const int key = 8 * (qe >> 1) + (qe & 1);
        const float* const xs = stage_x + g * kRows * kHD + p;
        const float v[4] = {xs[key * kHD], xs[(key + 2) * kHD],
                            xs[(key + 4) * kHD], xs[(key + 6) * kHD]};
        uint4 hi, lo;
        split4(v, hi, lo);
        uint8_t* const planes = ring + g * 2 * XP::kBytes;
        *reinterpret_cast<uint4*>(planes + XP::chunk(p, qe)) = hi;
        *reinterpret_cast<uint4*>(planes + XP::kBytes + XP::chunk(p, qe)) =
            lo;
      }
      jitter(3);
      // written by the generic proxy, read by wgmma's async proxy: each
      // thread fences its own stores before its arrival (full(st) counts
      // all 128)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full(st));
      // no thread refills the staging tile before all have split it
      named_sync(1, kThreads);
      jitter(4);
      if (j + 1 < n_load) load(j + 1);
    }
    return;
  }
  if (wg >= n_heads) return;          // an idle consumer

  // ---- decay terms: a sequential cumsum in torch's order -----------------
  const int h = hg * G + wg;
  float* const cum =
      reinterpret_cast<float*>(sm + L::scal) + wg * L::kScalFloats;
  float* const dts = cum + kMaxChunk;
  // i-tile 0: exp(total - cum_j) * dt_j, for the state; the others:
  // exp(cum_i0 - cum_j) * dt_j for j < i0, the column factors of W
  float* const u = dts + kMaxChunk;
  float* const rowf = u + kMaxChunk;  // exp(cum_i - cum_i0), i in the i-tile
  const float a = A[h];
  for (int i = tw; i < rows; i += kThreads) {
    const float d = dt[(t0 + i) * nh + h];
    dts[i] = d;
    cum[i] = d * a;
  }
  named_sync(2 + wg, kThreads);
  if (tw == 0) {   // 32 rows at a time: 16-byte loads, then the add chain
    float s = 0.f;
    float4* const c4 = reinterpret_cast<float4*>(cum);
    for (int k0 = 0; k0 < rows / 4; k0 += 8) {
      float4 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = c4[k0 + e];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += v[e].x;
        v[e].x = s;
        s += v[e].y;
        v[e].y = s;
        s += v[e].z;
        v[e].z = s;
        s += v[e].w;
        v[e].w = s;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) c4[k0 + e] = v[e];
    }
  }
  named_sync(2 + wg, kThreads);
  if (with_state) {
    const float total = cum[chunk - 1];
    for (int i = tw; i < chunk; i += kThreads) {
      u[i] = expf(total - cum[i]) * dts[i];
      cum_exp[(t0 + i) * nh + h] = expf(cum[i]);
    }
    if (tw == 0) decay[((size_t)b * nc + c) * nh + h] = expf(total);
  } else {
    const float ci0 = cum[i0];
    for (int j = tw; j < i0; j += kThreads) u[j] = expf(ci0 - cum[j]) * dts[j];
    if (tw < kRows) rowf[tw] = expf(cum[i0 + tw] - ci0);
  }
  named_sync(2 + wg, kThreads);

  // ---- y_intra of i-tile it: sum over j-tiles <= it of W . x_j ----------
  // W = (C_i . B_j) * exp(cum_i - cum_j) * dt_j where j <= i. Below the
  // diagonal tile (j < i0 <= i) the decay factors into exp(cum_i - cum_i0)
  // * exp(cum_i0 - cum_j), both <= 1 (A < 0); on the diagonal tile the
  // exponent is taken per entry, and only where j <= i (above, it would
  // overflow).
  const int warp = tw >> 5, lane = tw & 31, t = lane & 3;
  const int r_lo = 16 * warp + (lane >> 2);   // tile rows r_lo, r_lo + 8
  float rf[2] = {0.f, 0.f};
  if (!with_state) {
    rf[0] = rowf[r_lo];
    rf[1] = rowf[r_lo + 8];
  }
  const float* const srow =
      scores + ((size_t)(b * nc + c) * chunk + i0 + r_lo) * chunk;
  float acc[kHD / 2];
#pragma unroll
  for (int k = 0; k < kHD / 2; ++k) acc[k] = 0.f;
  for (int j = 0; j <= it; ++j) {
    const int st = j % kStages;
    const uint32_t planes = base + st * L::kStageBytes + wg * 2 * XP::kBytes;
    // s[4 jj + 2 hh + e]: row r_lo + 8 hh, column 8 jj + 2 t + e of the
    // tile (the accumulator layout), from the scores in device memory
    float s[32];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 v = *reinterpret_cast<const float2*>(
            srow + (size_t)8 * hh * chunk + j * kRows + 8 * jj + 2 * t);
        s[4 * jj + 2 * hh] = v.x;
        s[4 * jj + 2 * hh + 1] = v.y;
      }
    // below the diagonal tile the decay is factored into row and column
    // terms, exp(cum_i - cum_i0) * (exp(cum_i0 - cum_j) dt_j): two products
    // an entry, no exponent (an exponent per entry gave y the same error
    // and cost 7-37 % more time, PERF.md)
    if (j < it) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float cf = u[j * kRows + 8 * jj + 2 * t + e];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float& v = s[4 * jj + 2 * hh + e];
            v = v * rf[hh] * cf;
          }
        }
    } else {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int il = i0 + r_lo + 8 * hh;
        const float ci = cum[il];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jl = j * kRows + 8 * jj + 2 * t + e;
            float& v = s[4 * jj + 2 * hh + e];
            v = jl <= il ? v * expf(ci - cum[jl]) * dts[jl] : 0.f;
          }
      }
    }
    // W's k slice kk, split, as A registers: columns t and t + 4 are keys
    // 8 kk + 2 t and 8 kk + 2 t + 1, the planes' positions 8 kk + t and
    // 8 kk + t + 4
    uint32_t ph[kRows / 8][4], pl[kRows / 8][4];
#pragma unroll
    for (int kk = 0; kk < kRows / 8; ++kk) {
      split(s[4 * kk], ph[kk][0], pl[kk][0]);
      split(s[4 * kk + 2], ph[kk][1], pl[kk][1]);
      split(s[4 * kk + 1], ph[kk][2], pl[kk][2]);
      split(s[4 * kk + 3], ph[kk][3], pl[kk][3]);
    }
    mbar_wait(full(st), (j / kStages) & 1);
    jitter(5);
    repro::fence_regs(acc);
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 8; ++kk) {
      const uint64_t xh = XP::desc(planes, kk);
      const uint64_t xl = XP::desc(planes + XP::kBytes, kk);
      repro::wgmma_tf32_rs<kHD>(acc, pl[kk], xh);
      repro::wgmma_tf32_rs<kHD>(acc, ph[kk], xl);
      repro::wgmma_tf32_rs<kHD>(acc, ph[kk], xh);
    }
    repro::wgmma_commit();
    repro::wgmma_wait_all();   // this warp's reads of the stage are done
    repro::fence_regs(acc);
    if (!with_state) {         // the state CTA keeps tile 0 for the state
      jitter(6);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }
  }
  // acc[4 jj + 2 hh + e] is row r_lo + 8 hh, column 8 jj + 2 t + e
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float* const yrow = y + ((t0 + i0 + r_lo + 8 * hh) * nh + h) * kHD;
#pragma unroll
    for (int jj = 0; jj < kHD / 8; ++jj)
      *reinterpret_cast<float2*>(yrow + 8 * jj + 2 * t) =
          make_float2(acc[4 * jj + 2 * hh], acc[4 * jj + 2 * hh + 1]);
  }
  if (!with_state) return;

  // ---- chunk state, transposed: sum_j (B_j u_j)^T . x_j, (N x hd) --------
  float sacc[MB][kHD / 2];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int k = 0; k < kHD / 2; ++k) sacc[mb][k] = 0.f;
  for (int j = 0; j < n_it; ++j) {
    const int st = j % kStages;
    const uint32_t planes = base + st * L::kStageBytes + wg * 2 * XP::kBytes;
    const float* const brow = Bm + (t0 + j * kRows) * N;
    const float* const uj = u + j * kRows;
    mbar_wait(full(st), (j / kStages) & 1);   // tile 0: already complete
    jitter(5);
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // A fragment of k slice kk: row n = 64 mb + r_lo + 8 (r & 1),
        // column t + 4 (r >> 1), i.e. key 8 kk + 2 t + (r >> 1)
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int kq = 0; kq < 4; ++kq)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int n = 64 * mb + r_lo + 8 * (r & 1);
            const int jl = 8 * (4 * half + kq) + 2 * t + (r >> 1);
            const float v = n < N ? brow[(size_t)jl * N + n] * uj[jl] : 0.f;
            split(v, ah[kq][r], al[kq][r]);
          }
        repro::fence_regs(sacc[mb]);
        repro::wgmma_fence();
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
          const uint64_t xh = XP::desc(planes, 4 * half + kq);
          const uint64_t xl = XP::desc(planes + XP::kBytes, 4 * half + kq);
          repro::wgmma_tf32_rs<kHD>(sacc[mb], al[kq], xh);
          repro::wgmma_tf32_rs<kHD>(sacc[mb], ah[kq], xl);
          repro::wgmma_tf32_rs<kHD>(sacc[mb], ah[kq], xh);
        }
        repro::wgmma_commit();
        repro::wgmma_wait_all();
        repro::fence_regs(sacc[mb]);
      }
    jitter(7);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }
  // sacc[mb][4 jj + 2 hh + e] is state[p = 8 jj + 2 t + e][n = 64 mb +
  // r_lo + 8 hh]
  float* const out = states + (((size_t)b * nc + c) * nh + h) * kHD * N;
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = 64 * mb + r_lo + 8 * hh;
      if (n >= N) continue;
#pragma unroll
      for (int jj = 0; jj < kHD / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          out[(size_t)(8 * jj + 2 * t + e) * N + n] =
              sacc[mb][4 * jj + 2 * hh + e];
    }
}

template <int N, int G>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* scores, void* y, void* states,
           void* cum_exp, void* decay, void* final_state, int B, int S,
           int nh, int chunk, cudaStream_t stream) {
  static int granted_scores = 48 * 1024, granted = 48 * 1024;
  const int n_it = chunk / kRows;
  const int nc = S / chunk;
  cudaError_t err = repro::allow_smem(ssd_scores_tf32_kernel<N>,
                                      scores_smem_bytes<N>(), &granted_scores);
  if (err != cudaSuccess) return (int)err;
  ssd_scores_tf32_kernel<N><<<dim3(n_it * (n_it + 1) / 2, nc, B), kThreads,
                              scores_smem_bytes<N>(), stream>>>(
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<float*>(scores), S, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = repro::allow_smem(ssd_intra_tf32_kernel<N, G>, smem_bytes<G>(),
                          &granted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nh + G - 1) / G, B * nc, n_it);
  ssd_intra_tf32_kernel<N, G><<<grid, kThreads * (G + 1), smem_bytes<G>(),
                                stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(scores), static_cast<float*>(y),
      static_cast<float*>(states), static_cast<float*>(cum_exp),
      static_cast<float*>(decay), S, nh, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return state_pass(states, decay, final_state, B, nc, nh, kHD * N, stream);
}

template <int N>
int dispatch_group(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* scores, void* y,
                   void* states, void* cum_exp, void* decay,
                   void* final_state, int B, int S, int nh, int chunk,
                   int group, cudaStream_t stream) {
  if (group == 1)
    return launch<N, 1>(x, dt, A, Bm, Cm, scores, y, states, cum_exp, decay,
                        final_state, B, S, nh, chunk, stream);
  if (group == 2)
    return launch<N, 2>(x, dt, A, Bm, Cm, scores, y, states, cum_exp, decay,
                        final_state, B, S, nh, chunk, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tf32x3

}  // namespace

// The intra-chunk kernel, then the state pass: `states` ends up holding
// the state entering each chunk, `final_state` (B, nh, hd, N) the last.
extern "C" int repro_ssd_chunk(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* states, void* cum_exp, void* decay,
                               void* final_state, int B, int S, int nh,
                               int hd, int N, int chunk, int dtype,
                               void* stream) {
  if (B <= 0 || S <= 0 || nh <= 0 || N <= 0 || N > kMaxN || chunk <= 0 ||
      chunk > kMaxChunk || S % chunk != 0 || !final_state)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return dispatch_hd<float>(x, dt, A, Bm, Cm, y, states, cum_exp, decay,
                              final_state, B, S, nh, hd, N, chunk, s);
  if (dtype == repro::kBFloat16)
    return dispatch_hd<__nv_bfloat16>(x, dt, A, Bm, Cm, y, states, cum_exp,
                                      decay, final_state, B, S, nh, hd, N,
                                      chunk, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route: bfloat16 x, B and C with hd 64, N 32, 64 or 128 and
// a chunk that is a multiple of 64; `group` heads per CTA (1 or 2). The
// same outputs as repro_ssd_chunk.
extern "C" int repro_ssd_chunk_tc(const void* x, const void* dt,
                                  const void* A, const void* Bm,
                                  const void* Cm, void* y, void* states,
                                  void* cum_exp, void* decay,
                                  void* final_state, int B, int S, int nh,
                                  int hd, int N, int chunk, int group,
                                  void* stream) {
  if (B <= 0 || S <= 0 || nh <= 0 || hd != tc::kHD || chunk <= 0 ||
      chunk % tc::kRows != 0 || chunk > kMaxChunk || S % chunk != 0 ||
      !final_state)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 32:
      return tc::dispatch_group<32>(x, dt, A, Bm, Cm, y, states, cum_exp,
                                    decay, final_state, B, S, nh, chunk,
                                    group, s);
    case 64:
      return tc::dispatch_group<64>(x, dt, A, Bm, Cm, y, states, cum_exp,
                                    decay, final_state, B, S, nh, chunk,
                                    group, s);
    case 128:
      return tc::dispatch_group<128>(x, dt, A, Bm, Cm, y, states, cum_exp,
                                     decay, final_state, B, S, nh, chunk,
                                     group, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The recurrent route: any chunk below 64, float32 or bfloat16, hd a
// multiple of 16, N up to 256. Writes the intra-chunk scores (B, S, chunk)
// to `scores`, then y and `final_state` (B, nh, hd, N): no per-chunk
// states, cumsums or decays.
extern "C" int repro_ssd_chunk_recurrent(const void* x, const void* dt,
                                         const void* A, const void* Bm,
                                         const void* Cm, void* scores,
                                         void* y, void* final_state, int B,
                                         int S, int nh, int hd, int N,
                                         int chunk, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || nh <= 0 || hd <= 0 || hd % rec::kRows != 0 ||
      N <= 0 || N > kMaxN || chunk <= 0 || chunk > rec::kMaxChunk ||
      S % chunk != 0 || !final_state || !scores)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0)   // x rows: 16-byte loads
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return rec::dispatch_n<float>(x, dt, A, Bm, Cm, scores, y, final_state, B,
                                  S, nh, hd, N, chunk, s);
  if (dtype == repro::kBFloat16)
    return rec::dispatch_n<__nv_bfloat16>(x, dt, A, Bm, Cm, scores, y,
                                          final_state, B, S, nh, hd, N, chunk,
                                          s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core scan: bfloat16 x, B and C with hd 64, N 32, 64 or 128 and
// a chunk below 64 that divides 64. Writes y and `final_state` (B, nh, hd,
// N) only, as the recurrent route.
extern "C" int repro_ssd_chunk_tc_scan(const void* x, const void* dt,
                                       const void* A, const void* Bm,
                                       const void* Cm, void* y,
                                       void* final_state, int B, int S,
                                       int nh, int hd, int N, int chunk,
                                       void* stream) {
  if (B <= 0 || S <= 0 || nh <= 0 || hd != scan::kHD || chunk <= 0 ||
      chunk >= scan::kRows || scan::kRows % chunk != 0 || S % chunk != 0 ||
      !final_state)
    return (int)cudaErrorInvalidValue;
  const int lc = __builtin_ctz((unsigned)chunk);   // chunk divides 64
  return scan::dispatch_n(N, x, dt, A, Bm, Cm, y, final_state, B, S, nh, lc,
                          static_cast<cudaStream_t>(stream), nullptr);
}

// The tensor-core scan's kernel at state size N, read without a launch:
// registers and local (spill) bytes a thread, CTAs an SM holds, shared
// memory bytes a CTA, in info[0 ... 3].
extern "C" int repro_ssd_tc_scan_info(int N, int* info) {
  if (info == nullptr) return (int)cudaErrorInvalidValue;
  return scan::dispatch_n(N, nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, nullptr, 0, 0, 0, 0, nullptr, info);
}

// The split-TF32 route: float32 x, B and C with hd 64, N 32, 64 or 128 and
// a chunk that is a multiple of 64; `group` heads per CTA (1 or 2). Writes
// the scores of the chunk's tile pairs (B, nc, chunk, chunk) to `scores`,
// then the same outputs as repro_ssd_chunk.
extern "C" int repro_ssd_chunk_tf32(const void* x, const void* dt,
                                    const void* A, const void* Bm,
                                    const void* Cm, void* scores, void* y,
                                    void* states, void* cum_exp, void* decay,
                                    void* final_state, int B, int S, int nh,
                                    int hd, int N, int chunk, int group,
                                    void* stream) {
  if (B <= 0 || S <= 0 || nh <= 0 || hd != tf32x3::kHD || chunk <= 0 ||
      chunk % tf32x3::kRows != 0 || chunk > kMaxChunk || S % chunk != 0 ||
      !final_state || !scores)
    return (int)cudaErrorInvalidValue;
  // 16-byte loads and copies of x, B and C rows
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm) |
       reinterpret_cast<uintptr_t>(Cm)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 32:
      return tf32x3::dispatch_group<32>(x, dt, A, Bm, Cm, scores, y, states,
                                        cum_exp, decay, final_state, B, S,
                                        nh, chunk, group, s);
    case 64:
      return tf32x3::dispatch_group<64>(x, dt, A, Bm, Cm, scores, y, states,
                                        cum_exp, decay, final_state, B, S,
                                        nh, chunk, group, s);
    case 128:
      return tf32x3::dispatch_group<128>(x, dt, A, Bm, Cm, scores, y, states,
                                         cum_exp, decay, final_state, B, S,
                                         nh, chunk, group, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
