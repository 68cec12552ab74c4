// Ragged decode attention over the serving engine's slot arena, split over
// the context (flash-decoding).
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
// bytes / 3.35 TB/s. The kernel stays on the CUDA cores; what it has to get
// right is parallelism and how the bytes move.
//
// Design: grid (n_split, KV, B). CTA (s, kv, b) owns positions
// [s * split_t, (s + 1) * split_t) of row b's context for the G = H / KV
// query heads of group kv; n_split (at most kMaxSplits) and split_t are
// planned on the host from the static context bound
// (kernels/ragged_decode_attn.py: split_plan), so a batch of 8 rows at a
// context of 1024 runs 512 CTAs on the 132 SMs. A CTA whose span starts at
// or past lengths[b] exits at once. Each warp reads K and V rows straight
// from the arena with 16-byte vector loads, D / 8 (bf16) or D / 4 (f32)
// neighbouring lanes per row, so one load instruction covers 32 / LPR
// rows (a row wider than a warp's loads, f32 at D = 256, gives each of
// the 32 lanes VPL = 2 chunks of it, chunks c and c + 32), and keeps up to
// 8 such rows of K and V in flight per lane as raw
// registers, widened to float only where they are used; q for the heads
// lives in registers, each dot product is reduced with shuffles over the
// row's lanes, and every lane group keeps its own online softmax. The
// groups of a warp merge by shuffles, the warps of a CTA once through
// shared memory. A row with one live span writes its output directly.
// Otherwise each span writes a float32 partial (m, l, acc) to scratch, and
// the last CTA of the (b, kv) group to arrive — it learns so from a
// per-group counter, after __threadfence — merges the partials (one warp
// per head weighs the spans, then every thread sums four neighbouring
// outputs over them, 16-byte loads of eight spans in flight), writes the
// output and resets the counter for the next launch. So the split adds no launch. Heads are processed GC at
// a time (a compile-time chunk of at most 8) to bound the registers at
// G = 16, D = 128 and 256 (recurrentgemma-9b's MQA: one kv head of 256 for
// 16 q heads, two chunks of 8).
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

constexpr int kMaxSplits = 64;  // spans per row (split_plan caps it)

// 16 bytes of E: loaded raw, widened to float where they are used
template <typename E>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void widen(uint4 x, float* out) {
    out[0] = __uint_as_float(x.x); out[1] = __uint_as_float(x.y);
    out[2] = __uint_as_float(x.z); out[3] = __uint_as_float(x.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ void widen(uint4 x, float* out) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <typename E>
__device__ __forceinline__ uint4 load16(const E* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// a += x * w, componentwise
__device__ __forceinline__ void fma4(float4& a, float4 x, float w) {
  a.x = fmaf(x.x, w, a.x);
  a.y = fmaf(x.y, w, a.y);
  a.z = fmaf(x.z, w, a.z);
  a.w = fmaf(x.w, w, a.w);
}

// merge (m2, l2, a2) into (m, l, a)
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2,
                                      float& ca, float& cb) {
  const float mn = fmaxf(m, m2);
  ca = expf(m - mn);
  cb = expf(m2 - mn);
  l = l * ca + l2 * cb;
  m = mn;
}

template <typename E, int D, int GC>
__global__ void __launch_bounds__(kThreads)
ragged_decode_split_kernel(const E* __restrict__ q, const E* __restrict__ k,
                           const E* __restrict__ v,
                           const int* __restrict__ lengths,
                           const int* __restrict__ slots, E* __restrict__ out,
                           float* __restrict__ part_acc,
                           float* __restrict__ part_ml,
                           int* __restrict__ counters, int H, int KV, int N,
                           int T, int n_split, int split_t, float scale) {
  constexpr int EPV = Vec<E>::n;   // elements per 16-byte vector
  constexpr int VPL = D / EPV > 32 ? D / EPV / 32 : 1;  // vectors per lane
  constexpr int EPL = EPV * VPL;   // elements per lane
  constexpr int LPR = D / EPL;     // lanes per row
  constexpr int RPW = 32 / LPR;    // rows per warp load
  // rows in flight per lane, 32 bytes each per vector (fewer at GC = 8,
  // which holds 2 * 8 * EPL floats of q and acc)
  constexpr int kUnroll = GC >= 8 ? (VPL > 1 ? 2 : 4) : 8;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = lane % LPR;        // 16-byte chunks c + LPR * i of the row
  const int r = lane / LPR;        // row within the warp's load

  // a length past the planned spans (above ctx) is cut there, as the plain
  // version reads only ctx rows; every CTA it counts on then exists
  const int len = max(0, min(min(lengths[b], T), n_split * split_t));
  const int n_active = max(1, (len + split_t - 1) / split_t);
  if (split >= n_active) return;
  const int t_begin = split * split_t;
  const int t_end = min(t_begin + split_t, len);
  int slot = slots[b];
  slot = slot < 0 ? 0 : (slot > N - 1 ? N - 1 : slot);

  __shared__ float s_acc[kWarps][GC][D];
  __shared__ float s_m[kWarps][GC];
  __shared__ float s_l[kWarps][GC];
  __shared__ int s_last;

  const size_t t_stride = (size_t)KV * D;
  const size_t base = (size_t)slot * T * t_stride + (size_t)kvh * D + c * EPV;
  const E* kb = k + base;
  const E* vb = v + base;
  const size_t group = (size_t)b * KV + kvh;

  for (int g0 = 0; g0 < G; g0 += GC) {
    float qr[GC][EPL], acc[GC][EPL], m[GC], l[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      m[g] = -1e30f;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
      if (g0 + g < G) {
        const E* qh = q + ((size_t)b * H + (size_t)kvh * G + g0 + g) * D +
                      c * EPV;
#pragma unroll
        for (int i = 0; i < VPL; ++i)
          Vec<E>::widen(load16(qh + i * LPR * EPV), qr[g] + i * EPV);
#pragma unroll
        for (int e = 0; e < EPL; ++e) qr[g][e] *= scale;
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) qr[g][e] = 0.f;
      }
    }

    // this lane's rows: t_begin + (it * kWarps + warp) * RPW + r
    for (int t0 = t_begin + warp * RPW; t0 < t_end;
         t0 += kWarps * RPW * kUnroll) {
      uint4 kraw[kUnroll][VPL], vraw[kUnroll][VPL];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * kWarps * RPW + r;
        ok[u] = t < t_end;
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
          kraw[u][i] = vraw[u][i] = make_uint4(0u, 0u, 0u, 0u);
          if (ok[u]) {
            kraw[u][i] = load16(kb + (size_t)t * t_stride + i * LPR * EPV);
            vraw[u][i] = load16(vb + (size_t)t * t_stride + i * LPR * EPV);
          }
        }
      }
      float s[GC][kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float kx[EPL];
#pragma unroll
        for (int i = 0; i < VPL; ++i) Vec<E>::widen(kraw[u][i], kx + i * EPV);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) a = fmaf(qr[g][e], kx[e], a);
#pragma unroll
          for (int off = LPR / 2; off > 0; off >>= 1)
            a += __shfl_xor_sync(0xffffffffu, a, off);
          s[g][u] = ok[u] ? a : -1e30f;
        }
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) mx = fmaxf(mx, s[g][u]);
        const float corr = expf(m[g] - mx);
        m[g] = mx;
        l[g] *= corr;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          s[g][u] = ok[u] ? expf(s[g][u] - mx) : 0.f;
          l[g] += s[g][u];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float vx[EPL];
#pragma unroll
        for (int i = 0; i < VPL; ++i) Vec<E>::widen(vraw[u][i], vx + i * EPV);
#pragma unroll
        for (int g = 0; g < GC; ++g)
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            acc[g][e] = fmaf(s[g][u], vx[e], acc[g][e]);
      }
    }

    // merge the row groups of the warp (lanes with the same chunk c)
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m[g], off);
        const float l2 = __shfl_xor_sync(0xffffffffu, l[g], off);
        float ca, cb;
        merge(m[g], l[g], m2, l2, ca, cb);
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const float a2 = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
          acc[g][e] = acc[g][e] * ca + a2 * cb;
        }
      }
    }
    if (r == 0) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          s_acc[warp][g][(c + LPR * (e / EPV)) * EPV + e % EPV] = acc[g][e];
        if (c == 0) {
          s_m[warp][g] = m[g];
          s_l[warp][g] = l[g];
        }
      }
    }
    __syncthreads();
    // merge the warps; then write the output or this span's partial
    for (int i = tid; i < GC * D; i += kThreads) {
      const int g = i / D, d = i % D;
      if (g0 + g >= G) continue;
      float mm = s_m[0][g], ll = s_l[0][g], aa = s_acc[0][g][d];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        float ca, cb;
        merge(mm, ll, s_m[w][g], s_l[w][g], ca, cb);
        aa = aa * ca + s_acc[w][g][d] * cb;
      }
      const int h = g0 + g;
      if (n_active == 1) {
        out[((size_t)b * H + (size_t)kvh * G + h) * D + d] =
            repro::from_float<E>(aa / fmaxf(ll, 1e-30f));
      } else {
        const size_t p = (group * n_split + split) * G + h;
        part_acc[p * D + d] = aa;
        if (d == 0) {
          part_ml[2 * p] = mm;
          part_ml[2 * p + 1] = ll;
        }
      }
    }
    __syncthreads();
  }
  if (n_active == 1) return;

  // the last span of the group to arrive merges the partials
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(counters + group, 1);
    s_last = prev == n_active - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  __shared__ float s_w[kMaxSplits][GC];  // exp(m_s - M) per span and head
  __shared__ float s_inv[GC];            // 1 / sum_s l_s exp(m_s - M)
  for (int g0 = 0; g0 < G; g0 += GC) {
    const int ng = min(GC, G - g0);
    // one warp per head: the spans' maxima and weights, lanes over spans
    for (int g = warp; g < ng; g += kWarps) {
      const size_t p0 = group * n_split * G + g0 + g;
      float mm = -1e30f;
      for (int s = lane; s < n_active; s += 32)
        mm = fmaxf(mm, __ldcg(part_ml + 2 * (p0 + (size_t)s * G)));
      mm = repro::warp_max(mm);
      float ll = 0.f;
      for (int s = lane; s < n_active; s += 32) {
        const size_t p = p0 + (size_t)s * G;
        const float w = expf(__ldcg(part_ml + 2 * p) - mm);
        s_w[s][g] = w;
        ll += __ldcg(part_ml + 2 * p + 1) * w;
      }
      ll = repro::warp_sum(ll);
      if (lane == 0) s_inv[g] = 1.f / fmaxf(ll, 1e-30f);
    }
    __syncthreads();
    // every thread sums four neighbouring outputs over the spans with
    // 16-byte loads, eight spans' loads in flight: the merge of a group
    // of many heads (MQA at G 16, D 256: 16 x 256 outputs over up to 32
    // spans, all in this one CTA) is bound by the latency of its loads
    constexpr int D4 = D / 4;
    const size_t span4 = (size_t)G * D4;    // float4s from span to span
    for (int i = tid; i < ng * D4; i += kThreads) {
      const int g = i / D4, d4 = i % D4;
      const float4* pa = reinterpret_cast<const float4*>(
                             part_acc + (group * n_split * G + g0 + g) * D) +
                         d4;
      float4 a[2] = {make_float4(0.f, 0.f, 0.f, 0.f),
                     make_float4(0.f, 0.f, 0.f, 0.f)};
      int s = 0;
      for (; s + 8 <= n_active; s += 8) {
        float4 x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) x[u] = __ldcg(pa + (s + u) * span4);
#pragma unroll
        for (int u = 0; u < 8; ++u) fma4(a[u & 1], x[u], s_w[s + u][g]);
      }
      for (; s < n_active; ++s)
        fma4(a[0], __ldcg(pa + s * span4), s_w[s][g]);
      const float inv = s_inv[g];
      const float r[4] = {(a[0].x + a[1].x) * inv, (a[0].y + a[1].y) * inv,
                          (a[0].z + a[1].z) * inv, (a[0].w + a[1].w) * inv};
      E* o = out + ((size_t)b * H + (size_t)kvh * G + g0 + g) * D + 4 * d4;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = repro::from_float<E>(r[e]);
    }
    __syncthreads();
  }
  if (tid == 0) counters[group] = 0;
}

template <typename E, int D, int GC>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           const void* slots, void* out, void* part_acc, void* part_ml,
           void* counters, int B, int H, int KV, int N, int T, int n_split,
           int split_t, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)D));
  dim3 grid(n_split, KV, B);
  ragged_decode_split_kernel<E, D, GC><<<grid, kThreads, 0, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const int*>(lengths),
      static_cast<const int*>(slots), static_cast<E*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml),
      static_cast<int*>(counters), H, KV, N, T, n_split, split_t, scale);
  return (int)cudaGetLastError();
}

template <typename E, int D>
int dispatch_g(int G, const void* q, const void* k, const void* v,
               const void* lengths, const void* slots, void* out,
               void* part_acc, void* part_ml, void* counters, int B, int H,
               int KV, int N, int T, int n_split, int split_t,
               cudaStream_t stream) {
#define REPRO_LAUNCH(GC)                                                   \
  return launch<E, D, GC>(q, k, v, lengths, slots, out, part_acc, part_ml, \
                          counters, B, H, KV, N, T, n_split, split_t, stream)
  if (G == 1) REPRO_LAUNCH(1);
  if (G == 2) REPRO_LAUNCH(2);
  if (G <= 4) REPRO_LAUNCH(4);
  REPRO_LAUNCH(8);
#undef REPRO_LAUNCH
}

template <typename E>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const void* lengths, const void* slots, void* out,
               void* part_acc, void* part_ml, void* counters, int B, int H,
               int KV, int N, int T, int n_split, int split_t,
               cudaStream_t stream) {
  const int G = H / KV;
  switch (D) {
    case 32:
      return dispatch_g<E, 32>(G, q, k, v, lengths, slots, out, part_acc,
                               part_ml, counters, B, H, KV, N, T, n_split,
                               split_t, stream);
    case 64:
      return dispatch_g<E, 64>(G, q, k, v, lengths, slots, out, part_acc,
                               part_ml, counters, B, H, KV, N, T, n_split,
                               split_t, stream);
    case 128:
      return dispatch_g<E, 128>(G, q, k, v, lengths, slots, out, part_acc,
                                part_ml, counters, B, H, KV, N, T, n_split,
                                split_t, stream);
    case 256:
      return dispatch_g<E, 256>(G, q, k, v, lengths, slots, out, part_acc,
                                part_ml, counters, B, H, KV, N, T, n_split,
                                split_t, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// part_acc: (B * KV, n_split, G, D) float32 and part_ml: (B * KV, n_split,
// G, 2) float32 scratch, unused when n_split == 1; counters: B * KV int32,
// zero before the launch and zero again after it.
extern "C" int repro_ragged_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* slots, void* out, void* part_acc, void* part_ml,
    void* counters, int B, int H, int KV, int D, int N, int T, int n_split,
    int split_t, int dtype, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || n_split <= 0 || split_t <= 0 ||
      n_split > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return dispatch_d<float>(D, q, k, v, lengths, slots, out, part_acc,
                             part_ml, counters, B, H, KV, N, T, n_split,
                             split_t, s);
  if (dtype == repro::kBFloat16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, lengths, slots, out,
                                     part_acc, part_ml, counters, B, H, KV, N,
                                     T, n_split, split_t, s);
  return (int)cudaErrorInvalidValue;
}
