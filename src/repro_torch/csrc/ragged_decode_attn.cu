// Ragged decode attention over the serving engine's slot arena.
//
// Replaces the TPU kernel src/repro/kernels/ragged_decode_attn.py
// (ragged_decode_attention, body _kernel). Row b of a merged decode batch
// attends k/v[slots[b], :lengths[b]] of an (N, T, KV, D) arena with an
// online softmax (m, l, acc) kept in float32; GQA is handled per KV group,
// without repeating K/V heads. Padding rows carry an out-of-range slot and
// read the clamped row min(slot, N - 1), as the TPU kernel's gather does.
//
// Bound on the H100: the bytes of K/V read. One decode step touches every
// live row's sum(lengths) * KV * D * 2 elements once and does 4 flops per
// element pair, far below the ~295 flop/byte ridge, so the floor is
// bytes / 3.35 TB/s.
//
// Design: one CTA per (b, kv_head), so the G = H / KV query heads of a
// group share every K/V tile the CTA loads into shared memory. The tile
// loop stops at lengths[b]: a short row reads only its own context, never
// the arena's capacity. Scores, probabilities and the accumulator stay in
// float32 shared memory. This first version has no split over T, so a
// batch of B rows fills only B * KV of the 132 SMs; a flash-decoding split
// is the next step when the decode step is the bottleneck.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename E, int D>
__global__ void __launch_bounds__(kThreads)
ragged_decode_kernel(const E* __restrict__ q, const E* __restrict__ k,
                     const E* __restrict__ v, const int* __restrict__ lengths,
                     const int* __restrict__ slots, E* __restrict__ out,
                     int H, int KV, int N, int T, int block_t, float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;                        // G * D
  float* k_s = q_s + G * D;                 // block_t * (D + 1), padded
  float* v_s = k_s + block_t * (D + 1);     // block_t * D
  float* p_s = v_s + block_t * D;           // G * block_t
  float* acc_s = p_s + G * block_t;         // G * D
  float* m_s = acc_s + G * D;               // G
  float* l_s = m_s + G;                     // G
  float* c_s = l_s + G;                     // G

  int slot = slots[b];
  slot = slot < 0 ? 0 : (slot > N - 1 ? N - 1 : slot);
  const int len = min(lengths[b], T);

  const E* qrow = q + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = repro::to_float(qrow[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -1e30f;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const size_t t_stride = (size_t)KV * D;
  const size_t base = (size_t)slot * T * t_stride + (size_t)kvh * D;
  const E* kb = k + base;
  const E* vb = v + base;

  for (int t0 = 0; t0 < len; t0 += block_t) {
    const int nt = min(block_t, len - t0);
    for (int i = tid; i < block_t * D; i += kThreads) {
      const int t = i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      if (t < nt) {
        const size_t off = (size_t)(t0 + t) * t_stride + d;
        kx = repro::to_float(kb[off]);
        vx = repro::to_float(vb[off]);
      }
      k_s[t * (D + 1) + d] = kx;
      v_s[t * D + d] = vx;
    }
    __syncthreads();

    for (int i = tid; i < G * block_t; i += kThreads) {
      const int g = i / block_t, t = i % block_t;
      float s = -1e30f;
      if (t < nt) {
        const float* qg = q_s + g * D;
        const float* kt = k_s + t * (D + 1);
        float a = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) a += qg[d] * kt[d];
        s = a * scale;
      }
      p_s[i] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float* pg = p_s + g * block_t;
      float mx = -1e30f;
      for (int t = lane; t < block_t; t += 32) mx = fmaxf(mx, pg[t]);
      mx = repro::warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < block_t; t += 32) {
        const float p = t < nt ? expf(pg[t] - m_new) : 0.f;
        pg[t] = p;
        sum += p;
      }
      sum = repro::warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      const float* pg = p_s + g * block_t;
      float a = acc_s[i] * c_s[g];
      for (int t = 0; t < nt; ++t) a += pg[t] * v_s[t * D + d];
      acc_s[i] = a;
    }
    __syncthreads();
  }

  E* orow = out + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += kThreads)
    orow[i] = repro::from_float<E>(acc_s[i] / fmaxf(l_s[i / D], 1e-30f));
}

template <typename E, int D>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           const void* slots, void* out, int B, int H, int KV, int N, int T,
           int block_t, cudaStream_t stream) {
  static int granted = 48 * 1024;
  const int G = H / KV;
  const size_t smem = sizeof(float) *
      ((size_t)2 * G * D + (size_t)block_t * (D + 1) + (size_t)block_t * D +
       (size_t)G * block_t + 3 * (size_t)G);
  cudaError_t err = repro::allow_smem(ragged_decode_kernel<E, D>, smem,
                                      &granted);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)D));
  dim3 grid(B, KV);
  ragged_decode_kernel<E, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const int*>(lengths),
      static_cast<const int*>(slots), static_cast<E*>(out), H, KV, N, T,
      block_t, scale);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch_d(const void* q, const void* k, const void* v,
               const void* lengths, const void* slots, void* out, int B,
               int H, int KV, int D, int N, int T, int block_t,
               cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<E, 32>(q, k, v, lengths, slots, out, B, H, KV, N, T,
                           block_t, stream);
    case 64:
      return launch<E, 64>(q, k, v, lengths, slots, out, B, H, KV, N, T,
                           block_t, stream);
    case 128:
      return launch<E, 128>(q, k, v, lengths, slots, out, B, H, KV, N, T,
                            block_t, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int repro_ragged_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* slots, void* out, int B, int H, int KV, int D, int N, int T,
    int block_t, int dtype, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || block_t <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return dispatch_d<float>(q, k, v, lengths, slots, out, B, H, KV, D, N, T,
                             block_t, s);
  if (dtype == repro::kBFloat16)
    return dispatch_d<__nv_bfloat16>(q, k, v, lengths, slots, out, B, H, KV,
                                     D, N, T, block_t, s);
  return (int)cudaErrorInvalidValue;
}
