// Flash prefill attention: causal, with a query offset and an optional
// sliding window.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py
// (flash_attention, body _kernel). Query i of a (B, S, H, D) block attends
// keys kpos <= q_offset + i (and kpos > q_offset + i - window when a window
// is given) of (B, T, KV, D) keys and values with an online softmax
// (m, l, acc) in float32. KV may divide H: query head h reads KV head
// h / (H / KV), so the engine passes un-repeated GQA heads and no
// repeat_kv copy is ever materialized (KV == H is the TPU kernel's case).
//
// Bound on the H100: FLOPs at long S (4 * B * H * D * S^2 / 2 for the causal
// half), and launch latency at the engine's short prompt buckets, where
// one layer's prefill is a few microseconds of work.
//
// Design: one CTA per (q-tile of 64 rows, head, batch row), looping over
// 64-key tiles only up to the causal bound (and from the window's lower
// bound), so fully masked tiles are never loaded. Each of the 256 threads
// owns a 4 x 4 block of the score tile and a 4 x (D / 16) block of the
// output accumulator in registers; Q, K, V and P tiles live in float32
// shared memory, rows padded by one word against bank conflicts. The
// products run on the CUDA cores in float32, not on the tensor cores: a
// wgmma / TMA pipeline is the perf step that comes after this one.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each

template <typename E, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
                 const E* __restrict__ v, E* __restrict__ o, int S, int T,
                 int H, int KV, int q_offset, int window, float scale) {
  constexpr int DJ = D / 16;  // output columns per thread
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  extern __shared__ float smem[];
  float* Qs = smem;                       // kBQ * (D + 1)
  float* Ks = Qs + kBQ * (D + 1);         // kBK * (D + 1)
  float* Vs = Ks + kBK * (D + 1);         // kBK * D
  float* Ps = Vs + kBK * D;               // kBQ * (kBK + 1)

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = q0 + r;
    Qs[r * (D + 1) + d] =
        s < S ? repro::to_float(q[(((size_t)b * S + s) * H + h) * D + d])
              : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -1e30f;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[r][j] = 0.f;
  }

  // keys any row of this tile may attend: [k_lo, k_hi)
  const int last_q = q_offset + min(q0 + kBQ, S) - 1;
  const int k_hi = min(T, last_q + 1);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q_offset + q0 - window + 1);
  k_lo = (k_lo / kBK) * kBK;
  __syncthreads();

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int t = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (t < T) {
        const size_t off = (((size_t)b * T + t) * KV + kvh) * D + d;
        kx = repro::to_float(k[off]);
        vx = repro::to_float(v[off]);
      }
      Ks[c * (D + 1) + d] = kx;
      Vs[c * D + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = Qs[(ty * 4 + r) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] += qv[r] * kv[j];
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q_offset + q0 + ty * 4 + r;
      bool ok[4];
      float mx = -1e30f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < T && kpos <= qpos &&
                (window <= 0 || kpos > qpos - window);
        s[r][j] = ok[j] ? s[r][j] * scale : -1e30f;
        mx = fmaxf(mx, s[r][j]);
      }
      // the 16 threads of one row are one half-warp: xor 8..1 stays inside
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[r][j] - m_new) : 0.f;
        Ps[(ty * 4 + r) * (kBK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[r][j] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = Ps[(ty * 4 + r) * (kBK + 1) + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[r][j] += p * vv[j];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int s_idx = q0 + ty * 4 + r;
    if (s_idx >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    E* orow = o + (((size_t)b * S + s_idx) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      orow[tx + 16 * j] = repro::from_float<E>(acc[r][j] / den);
  }
}

template <typename E, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int T, int H, int KV, int q_offset, int window,
           cudaStream_t stream) {
  static int granted = 48 * 1024;
  const size_t smem = sizeof(float) *
      ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D +
       (size_t)kBQ * (kBK + 1));
  cudaError_t err = repro::allow_smem(flash_fwd_kernel<E, D>, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)D));
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<E, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<E*>(o), S, T, H, KV, q_offset,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
               int S, int T, int H, int KV, int D, int q_offset, int window,
               cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<E, 32>(q, k, v, o, B, S, T, H, KV, q_offset, window,
                           stream);
    case 64:
      return launch<E, 64>(q, k, v, o, B, S, T, H, KV, q_offset, window,
                           stream);
    case 128:
      return launch<E, 128>(q, k, v, o, B, S, T, H, KV, q_offset, window,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// window <= 0 means no sliding window.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int T, int H, int KV, int D,
                                     int q_offset, int window, int dtype,
                                     void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return dispatch_d<float>(q, k, v, o, B, S, T, H, KV, D, q_offset, window,
                             s);
  if (dtype == repro::kBFloat16)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, S, T, H, KV, D, q_offset,
                                     window, s);
  return (int)cudaErrorInvalidValue;
}
