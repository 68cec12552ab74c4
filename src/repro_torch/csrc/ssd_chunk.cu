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
// states decayed to chunk c: h_prev[0] = 0, run = run * decay[c] + state[c].
// The wrapper adds y_inter = (C_i * exp(cum_i)) . h_prev[c]^T in PyTorch.
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
// Design: the TPU kernel holds a whole chunk in VMEM (B and C alone are
// 128 KB each in float32 at chunk 256, N 128). Here one CTA of 256 threads
// per (b, c, h) walks 64-row i-tiles; for each it loops over the j-tiles
// at or below it, forms C_i . B_j^T over N in 32-wide shared-memory slices
// (each thread owns a 4 x 4 block of scores), applies the decay weights
// only where j <= i (the exponent is never taken above the diagonal, where
// it would overflow), and accumulates W . x_j into a 4 x (hd / 16) register
// block of y. The (hd, N) state is then accumulated over 64-column slices
// of N. Both products run over the chunk's rows only, so a short chunk
// (chunk 1 at an odd prefill length) does not pay for a whole tile. The
// cumsum runs sequentially in one thread, in the order of
// torch.cumsum, so its exponents agree with the plain version's bit for
// bit (their differences cancel ~1e-4 of |cum| otherwise). Everything is
// float32 on the CUDA cores; wgmma, TMA and sharing C . B^T across the
// heads (it is head-independent) are the perf steps after this one.
//
// The state pass is one thread per (p, n) state entry, 256 entries per CTA,
// walking the chunks in order; it overwrites the chunk states with h_prev
// in place (at chunk 1 they are S * nh * hd * N floats).
#include <math.h>
#include <stdint.h>

#include "common.cuh"

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
  const int P = HD * N;
  dim3 pgrid((P + kThreads - 1) / kThreads, nh, B);
  ssd_state_pass_kernel<<<pgrid, kThreads, 0, stream>>>(
      static_cast<float*>(states), static_cast<const float*>(decay),
      static_cast<float*>(final_state), nc, nh, P);
  return (int)cudaGetLastError();
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
