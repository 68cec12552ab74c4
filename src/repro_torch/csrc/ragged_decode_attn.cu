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
// live row's sum(lengths) * KV * D * 2 elements once and does 4 * G flops
// per K/V element pair (G = H / KV query heads share each pair): G
// flop/byte in bf16, 16 at recurrentgemma-9b's G 16. The tensor cores'
// ridge is ~295 flop/byte and the CUDA cores' ~20 (67 TFLOP/s over 3.35
// TB/s): at G <= 8 the CUDA cores stay below theirs and the floor is
// bytes / 3.35 TB/s, but at G 16 a CUDA-core kernel is bound by its own
// arithmetic (and its shuffles and exponentials) before the bytes. So
// there are four kernels in this file:
//
//  - ragged_decode_split_kernel (below): the CUDA cores, for the shapes
//    no other kernel takes (float32 above 8 heads a group, head dims 32
//    and 256 at G <= 8); what it has to get right is parallelism and how
//    the bytes move.
//  - ragged_decode_tc_kernel (further down): bf16 at 8 < G <= 16 on the
//    tensor cores, one pass over K/V for all heads of a group, the spans
//    of a (b, kv) group merged across a thread-block cluster.
//  - ragged_decode_n8_kernel: bf16 at G <= 8 (D 64 and 128), the heads
//    the n8 side of the product, a ring and a softmax a warp.
//  - ragged_decode_n8_tf32_kernel (last): float32 at G <= 8 (D 64 and
//    128), the same layout with every product as three TF32 products.
//
// ragged_decode_split_kernel. Design: grid (n_split, KV, B). CTA (s, kv,
// b) owns positions [s * split_t, (s + 1) * split_t) of row b's context
// for the G = H / KV query heads of group kv; n_split (at most
// kMaxSplits) and split_t are planned on the host from the static context bound
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
// a time (a compile-time chunk of at most 8) to bound the registers; a
// float32 group above 8 heads (recurrentgemma-9b's MQA in float32: one kv
// head of 256 for 16 q heads) goes in two chunks of 8, each reading the
// span's K/V again.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "tf32.cuh"

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
  int slot = slots != nullptr ? slots[b] : b;   // no slots: row b
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
// zero before the launch and zero again after it; slots null: row b.
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

// ---------------------------------------------------------------------------
// ragged_decode_tc_kernel: bf16 at 8 < G <= 16 query heads a kv head, on the
// tensor cores (recurrentgemma-9b's MQA: G 16 at D 256).
//
// Replaces, like the kernel above, the TPU kernel
// src/repro/kernels/ragged_decode_attn.py (_kernel), which computes each
// group as a (G, D) x (D, block_t) product on the MXU. Here the G <= 16
// query heads of a group pad one m16 tile of mma.sync.m16n8k16 (bf16
// operands, float32 accumulators), so K and V are read once for all heads:
//
//   S = Q . K^T   Q goes in unscaled: the products of bf16 values are
//                 exact and summed in float32, as the reference's float32
//                 dot of the widened values; S times 1 / sqrt(D) after it
//                 (and times log2(e): the softmax runs in base 2, ex2 on
//                 the MUFU pipe, one instruction an exponential);
//   P             the online softmax in float32 (m and l per head);
//   O += P . V    P enters as two bf16 terms, hi = bf16(p) and
//                 lo = bf16(p - hi): P keeps about 2^-16 of its float32
//                 value, where one bf16 term would keep 2^-8 (the
//                 reference keeps P in float32).
//
// Why mma.sync and not wgmma: a wgmma tile is 64 rows and a group has at
// most 16 heads, so three quarters of every product would be padding; and
// once on the tensor cores the work is memory-bound (G flop/byte, 16 at
// G 16 in bf16, against a ridge of ~295), so what decides the time is
// the bytes in flight, which a ring of cp.async stages gives, not the
// product's issue rate.
//
// Design: grid (cluster, KV, B), one thread-block cluster of `cluster`
// CTAs (at most 8, launched with cudaLaunchKernelEx) per (b, kv) group.
// The row's context [0, min(lengths[b], span, n_split * split_t)) is cut
// into spans of split_t rows, planned on the host from static sizes
// (kernels/ragged_decode_attn.py: tc_plan). CTA c walks spans c,
// c + cluster, c + 2 * cluster, ... and carries one online softmax across
// them in registers, so every split_t runs on the same code. It reads its
// spans by tiles of TR rows (32 at D 256, 64 below) through a ring of
// kStages K and V tiles in shared memory, loaded by 16-byte cp.async:
// rows past the span's end are zero-filled and never read from the arena
// (at KV > 1 a tile's rows lie KV * D apart). A tile's 16-byte chunks are
// XOR-swizzled by row, so the ldmatrix reads that feed the fragments
// (.trans for V) hit no bank twice. No tensor map is encoded: the host does
// nothing per call but the launch. Per tile, with four warps:
//   1. warp w computes S for keys 8w .. 8w + 7 of the tile (and
//      8(w + 4) .. at TR 64) over all of D, and writes it scaled, and -inf
//      past the span's end, to a 16 x TR float32 tile in shared memory;
//   2. after a barrier every warp reads the whole S tile and runs the same
//      online softmax on it (the same operations on the same values, so the
//      warps' m and l stay equal), keeping P as hi / lo A fragments;
//   3. warp w accumulates O for its D / 4 columns (a 16 x D / 4 float32
//      accumulator, D / 8 registers a thread).
// Q's loads are issued first and the K/V tiles' next, so Q's latency hides
// under that of lengths and slots, which the K/V addresses wait for. After
// its last tile each CTA leaves its (m, l, O) in its own shared memory;
// after a cluster barrier, CTA c merges its share of the group's G * D
// outputs over the peers in rank order, reading each peer's (m, l) of a
// head and its 16-byte piece of O together (DSMEM, every peer's read in
// flight at once: one round trip), merged online,
// divides and writes bf16. No partial goes to device memory, and no
// counter or fence is needed. A CTA with no rows (its spans start past the
// row's length, or the length is 0: the output is then zeros, as the TPU
// kernel's) still arrives at both cluster barriers, with m = -1e30, l = 0
// and O = 0.
namespace {
namespace tc {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 16;       // the m16 tile: a group's query heads
constexpr int kStages = 3;       // the ring of K / V tiles
constexpr int kMaxCluster = 8;   // portable cluster size (tc_plan caps it)
constexpr int kChains = 4;       // accumulators of S: independent products

template <int D>
struct Cfg {
  static constexpr int TR = D == 256 ? 32 : 64;  // rows a tile
  static constexpr int CPR = D / 8;              // 16-byte chunks a row
  static constexpr int kTile = TR * D * 2;       // bytes of K (or V) a tile
  static constexpr int kStage = 2 * kTile;
  static constexpr int kSStride = TR + 4;        // floats a row of the S tile
  static constexpr int kNT = D / 32;             // n8 tiles of O a warp
  static constexpr int kKS = TR / 16;            // k16 steps of P . V
  static constexpr int kKB = TR / 8 / kWarps;    // key blocks of S a warp
  // shared memory: the ring (after the last tile: this CTA's O, 16 x D
  // float32), Q (16 x D bf16), the S tile, this CTA's (m, l) per head
  static constexpr int kQ = kStages * kStage;
  static constexpr int kS = kQ + kHeads * D * 2;
  static constexpr int kML = kS + kHeads * kSStride * 4;
  static constexpr int kBytes = kML + kHeads * 8;
  static_assert(kHeads * D * 4 <= kQ, "O fits in the ring");
  static_assert(TR * CPR % kThreads == 0 && kKB >= 1, "tile shape");
  static constexpr int kQL = (kHeads * CPR + kThreads - 1) / kThreads;
};

// byte offset of 16-byte chunk c of row r in a tile D columns wide: a
// row's chunks XOR-swizzled by the row, so the 8 rows (8-aligned) of one
// ldmatrix matrix fall in 8 different bank groups
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  if constexpr (D >= 64)
    return (uint32_t)(r * (D / 8) + (c ^ (r & 7))) << 4;
  else  // D 32: two rows a 128-byte line
    return (uint32_t)(r * (D / 8) + (c ^ ((r >> 1) & 3))) << 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float ex2(float x) {   // 2^x; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr)
      : "memory");
}

// d += a . b: m16n8k16, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// (p0, p1) of neighbouring columns as hi + lo, two bf16 pairs: p0 in the
// low half of each, as the fragments take the lower column there
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
}

// every CTA of the cluster arrives (release) and waits (acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// the address of shared-memory address `addr` in cluster CTA `rank`
__device__ __forceinline__ uint32_t peer(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float2 ld_peer2(uint32_t addr) {
  float2 x;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(x.x), "=f"(x.y)
               : "r"(addr)
               : "memory");
  return x;
}

__device__ __forceinline__ float4 ld_peer4(uint32_t addr) {
  float4 x;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(addr)
               : "memory");
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
ragged_decode_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ lengths,
                        const int* __restrict__ slots,
                        __nv_bfloat16* __restrict__ out, int H, int KV, int N,
                        int T, int span, int n_split, int split_t,
                        float scale_log2) {
  using C = Cfg<D>;
  constexpr int TR = C::TR, CPR = C::CPR;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  float* s_tile = reinterpret_cast<float*>(smem + C::kS);
  const int cs = gridDim.x;        // CTAs of the cluster
  const int c = cluster_rank();
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;         // a fragment's rows g and g + 8
  const int t = lane & 3;          // and its column pair 2t, 2t + 1

  // Q's loads first: its latency then hides under that of lengths and
  // slots, which the K/V addresses wait for
  const __nv_bfloat16* qg = q + ((size_t)b * H + (size_t)kvh * G) * D;
  uint4 qx[C::kQL];               // 16-byte chunks e = tid + 128 i
#pragma unroll
  for (int i = 0; i < C::kQL; ++i) {
    const int e = tid + i * kThreads;
    qx[i] = e / CPR < G
                ? __ldg(reinterpret_cast<const uint4*>(qg + (size_t)e * 8))
                : make_uint4(0u, 0u, 0u, 0u);
  }
  const int len = max(0, min(min(lengths[b], span), n_split * split_t));
  int slot = slots != nullptr ? slots[b] : b;   // no slots: row b
  slot = slot < 0 ? 0 : (slot > N - 1 ? N - 1 : slot);
  const size_t t_stride = (size_t)KV * D;
  const size_t row0 = (size_t)slot * T * t_stride + (size_t)kvh * D;
  const __nv_bfloat16* kb = k + row0;
  const __nv_bfloat16* vb = v + row0;

  // this CTA's spans c, c + cs, ... below n_active, by tiles of TR rows
  const int n_active = (len + split_t - 1) / split_t;
  const int tps = (split_t + TR - 1) / TR;     // tiles of a whole span
  const int n_mine = c < n_active ? (n_active - 1 - c) / cs + 1 : 0;
  int n_tiles = 0;
  if (n_mine > 0) {
    const int last = c + (n_mine - 1) * cs;
    const int rows = min(split_t, len - last * split_t);
    n_tiles = (n_mine - 1) * tps + (rows + TR - 1) / TR;
  }
  // tile j of this CTA: its first row and how many rows it has
  auto tile = [&](int j, int& t0, int& nrows) {
    const int s = c + (j / tps) * cs;
    t0 = s * split_t + (j % tps) * TR;
    nrows = min(min(t0 + TR, (s + 1) * split_t), len) - t0;
  };
  // tile j's K and V into stage j % kStages, one cp.async group a tile
  // (an empty group past the last tile keeps the count of groups)
  auto issue = [&](int j) {
    if (j < n_tiles) {
      int t0, nrows;
      tile(j, t0, nrows);
      const uint32_t st = base + (j % kStages) * C::kStage;
#pragma unroll
      for (int i = 0; i < TR * CPR / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int r = e / CPR, ch = e % CPR;
        const bool ok = r < nrows;
        const size_t off = (size_t)(t0 + (ok ? r : 0)) * t_stride + ch * 8;
        cp_async16(st + swz<D>(r, ch), kb + off, ok);
        cp_async16(st + C::kTile + swz<D>(r, ch), vb + off, ok);
      }
    }
    cp_async_commit();
  };

  // the first tiles' loads, then Q of the group's heads (rows G .. 15
  // zero) into shared memory
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue(j);
#pragma unroll
  for (int i = 0; i < C::kQL; ++i) {
    const int e = tid + i * kThreads;
    if (e < kHeads * CPR)
      *reinterpret_cast<uint4*>(smem + C::kQ + swz<D>(e / CPR, e % CPR)) =
          qx[i];
  }
  __syncthreads();
  uint32_t qf[D / 16][4];          // Q's A fragments, one a k16 step
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldsm_x4(qf[ks], base + C::kQ +
                        swz<D>((lane & 7) + 8 * ((lane >> 3) & 1),
                               2 * ks + (lane >> 4)));

  float m[2] = {-1e30f, -1e30f};   // rows g and g + 8
  float l[2] = {0.f, 0.f};
  float acc[C::kNT][4];
#pragma unroll
  for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();
    // tile j is in for every thread; tile j - 1's stage and the S tile
    // are free
    __syncthreads();
    issue(j + kStages - 1);
    int t0, nrows;
    tile(j, t0, nrows);
    const uint32_t kt = base + (j % kStages) * C::kStage;
    const uint32_t vt = kt + C::kTile;

    // 1. S for this warp's key blocks, in kChains accumulators (k16 steps
    // ks, ks + kChains, ...) for independent chains of products; stored
    // times scale * log2(e), the softmax's base-2 exponents
#pragma unroll
    for (int i = 0; i < C::kKB; ++i) {
      const int kb8 = warp + i * kWarps;
      float sc[kChains][4] = {};
#pragma unroll
      for (int j2 = 0; j2 < D / 32; ++j2) {
        uint32_t bf[4];
        ldsm_x4(bf, kt + swz<D>(kb8 * 8 + (lane & 7), 4 * j2 + (lane >> 3)));
        mma(sc[(2 * j2) % kChains], qf[2 * j2], bf[0], bf[1]);
        mma(sc[(2 * j2 + 1) % kChains], qf[2 * j2 + 1], bf[2], bf[3]);
      }
#pragma unroll
      for (int ch = 1; ch < kChains; ++ch)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[0][e] += sc[ch][e];
      const int col = kb8 * 8 + 2 * t;
      const bool ok0 = col < nrows, ok1 = col + 1 < nrows;
      *reinterpret_cast<float2*>(s_tile + g * C::kSStride + col) =
          make_float2(ok0 ? sc[0][0] * scale_log2 : -INFINITY,
                      ok1 ? sc[0][1] * scale_log2 : -INFINITY);
      *reinterpret_cast<float2*>(s_tile + (g + 8) * C::kSStride + col) =
          make_float2(ok0 ? sc[0][2] * scale_log2 : -INFINITY,
                      ok1 ? sc[0][3] * scale_log2 : -INFINITY);
    }
    __syncthreads();

    // 2. the online softmax over the tile, the same in every warp: this
    // thread's columns 16 ks + 2t, + 1, + 8, + 9 of rows g and g + 8
    float p[2][C::kKS][4];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int ks = 0; ks < C::kKS; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* row =
            s_tile + (g + 8 * h) * C::kSStride + 16 * ks + 2 * t;
        const float2 lo = *reinterpret_cast<const float2*>(row);
        const float2 hi = *reinterpret_cast<const float2*>(row + 8);
        p[h][ks][0] = lo.x;
        p[h][ks][1] = lo.y;
        p[h][ks][2] = hi.x;
        p[h][ks][3] = hi.y;
        mx[h] = fmaxf(mx[h], fmaxf(fmaxf(lo.x, lo.y), fmaxf(hi.x, hi.y)));
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);
      corr[h] = ex2(m[h] - mn);
      m[h] = mn;
      float sum = 0.f;
#pragma unroll
      for (int ks = 0; ks < C::kKS; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[h][ks][e] = ex2(p[h][ks][e] - mn);   // ex2(-inf) = 0
          sum += p[h][ks][e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[h] = l[h] * corr[h] + sum;
    }
#pragma unroll
    for (int nt = 0; nt < C::kNT; ++nt) {
      acc[nt][0] *= corr[0];
      acc[nt][1] *= corr[0];
      acc[nt][2] *= corr[1];
      acc[nt][3] *= corr[1];
    }

    // 3. O += P . V over this warp's D / 4 columns, P as hi + lo
#pragma unroll
    for (int ks = 0; ks < C::kKS; ++ks) {
      uint32_t ph[4], pl[4];
      split_pair(p[0][ks][0], p[0][ks][1], ph[0], pl[0]);
      split_pair(p[1][ks][0], p[1][ks][1], ph[1], pl[1]);
      split_pair(p[0][ks][2], p[0][ks][3], ph[2], pl[2]);
      split_pair(p[1][ks][2], p[1][ks][3], ph[3], pl[3]);
      const int vrow = 16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1);
      if constexpr (C::kNT >= 2) {
#pragma unroll
        for (int nt = 0; nt < C::kNT; nt += 2) {
          uint32_t bf[4];
          ldsm_x4_t(bf, vt + swz<D>(vrow, warp * C::kNT + nt + (lane >> 4)));
          mma(acc[nt], ph, bf[0], bf[1]);
          mma(acc[nt], pl, bf[0], bf[1]);
          mma(acc[nt + 1], ph, bf[2], bf[3]);
          mma(acc[nt + 1], pl, bf[2], bf[3]);
        }
      } else {
        uint32_t bf[2];
        ldsm_x2_t(bf, vt + swz<D>(vrow, warp));
        mma(acc[0], ph, bf[0], bf[1]);
        mma(acc[0], pl, bf[0], bf[1]);
      }
    }
  }

  // 4. this CTA's (m, l, O) into its shared memory, O where the ring was
  cp_async_wait<0>();
  __syncthreads();
  float* s_o = reinterpret_cast<float*>(smem);   // 16 x D
#pragma unroll
  for (int nt = 0; nt < C::kNT; ++nt) {
    const int col = (warp * C::kNT + nt) * 8 + 2 * t;
    *reinterpret_cast<float2*>(s_o + g * D + col) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(s_o + (g + 8) * D + col) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
  float2* s_ml = reinterpret_cast<float2*>(smem + C::kML);   // (m, l)
  if (warp == 0 && t == 0) {
    s_ml[g] = make_float2(m[0], l[0]);
    s_ml[g + 8] = make_float2(m[1], l[1]);
  }
  cluster_sync();   // every CTA of the group has left its (m, l, O)

  // 5. CTA c merges float4s [c * per, (c + 1) * per) of the group's G * D
  // outputs over the cluster's CTAs in rank order: every peer's (m, l) of
  // the float4's head and its float4 of O read together (DSMEM, all in
  // flight at once), then merged online into (M, L, a)
  const int n4 = G * D / 4;
  const int per = (n4 + cs - 1) / cs;
  const uint32_t ml_at = smem_addr(s_ml);
  __nv_bfloat16* og = out + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = c * per + tid; i < min(n4, (c + 1) * per); i += kThreads) {
    const int h = 4 * i / D;
    float2 ml[kMaxCluster];
    float4 x[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < cs) {
        ml[r] = ld_peer2(peer(ml_at + 8 * h, r));
        x[r] = ld_peer4(peer(base + 16 * i, r));
      }
    float mm = -1e30f, ll = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < cs) {
        const float mn = fmaxf(mm, ml[r].x);
        const float ca = ex2(mm - mn), cb = ex2(ml[r].x - mn);
        ll = ll * ca + ml[r].y * cb;
        a.x = a.x * ca + x[r].x * cb;
        a.y = a.y * ca + x[r].y * cb;
        a.z = a.z * ca + x[r].z * cb;
        a.w = a.w * ca + x[r].w * cb;
        mm = mn;
      }
    const float den = fmaxf(ll, 1e-30f);
    const __nv_bfloat162 o01 = __floats2bfloat162_rn(a.x / den, a.y / den);
    const __nv_bfloat162 o23 = __floats2bfloat162_rn(a.z / den, a.w / den);
    *reinterpret_cast<uint2*>(og + 4 * i) = make_uint2(bits(o01), bits(o23));
  }
  cluster_sync();   // no CTA leaves while a peer still reads its memory
}

template <int D>
cudaLaunchConfig_t config(int cluster, int KV, int B, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, KV, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Cfg<D>::kBytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int D>
cudaError_t grant() {
  static int granted = 48 * 1024;
  return repro::allow_smem(ragged_decode_tc_kernel<D>, Cfg<D>::kBytes,
                           &granted);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           const void* slots, void* out, int B, int H, int KV, int N, int T,
           int span, int n_split, int split_t, int cluster,
           cudaStream_t stream) {
  cudaError_t err = grant<D>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<D>(cluster, KV, B, stream, attr);
  // the scores' scale times log2(e): the softmax runs in base 2
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  err = cudaLaunchKernelEx(
      &cfg, ragged_decode_tc_kernel<D>,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
      static_cast<const int*>(slots), static_cast<__nv_bfloat16*>(out), H, KV,
      N, T, span, n_split, split_t, scale_log2);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// registers and local (spill) bytes a thread, CTAs an SM, shared memory
// bytes a CTA, clusters of kMaxCluster CTAs the card holds at once
template <int D>
int info(int* out) {
  cudaError_t err = grant<D>();
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, ragged_decode_tc_kernel<D>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], ragged_decode_tc_kernel<D>, kThreads, Cfg<D>::kBytes);
  if (err == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        config<D>(kMaxCluster, 1, 1, nullptr, attr);
    err = cudaOccupancyMaxActiveClusters(&out[4], ragged_decode_tc_kernel<D>,
                                         &cfg);
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[3] = Cfg<D>::kBytes;
  return 0;
}

}  // namespace tc
}  // namespace

// bf16 q (B, H, D), k, v (N, T, KV, D), lengths (B,) int32, slots (B,)
// int32 or null (row b), out (B, H, D) bf16, at 8 < H / KV <= 16; row b
// attends positions below min(lengths[b], span, n_split * split_t) of
// arena row min(slots[b], N - 1); `cluster` CTAs (at most 8) per (b, kv)
// group.
extern "C" int repro_ragged_decode_tc(const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      const void* slots, void* out, int B,
                                      int H, int KV, int D, int N, int T,
                                      int span, int n_split, int split_t,
                                      int cluster, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || H / KV > tc::kHeads || N <= 0 ||
      span <= 0 || span > T || n_split <= 0 || split_t <= 0 ||
      cluster < 1 || cluster > tc::kMaxCluster)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_TC(DD)                                                     \
  return tc::launch<DD>(q, k, v, lengths, slots, out, B, H, KV, N, T, span, \
                        n_split, split_t, cluster, s)
  switch (D) {
    case 32: REPRO_TC(32);
    case 64: REPRO_TC(64);
    case 128: REPRO_TC(128);
    case 256: REPRO_TC(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_TC
}

// info: registers, spill bytes, CTAs an SM, shared memory bytes, clusters
// of 8 held at once, for the instantiation at head dim D
extern "C" int repro_ragged_decode_tc_info(int D, int* info) {
  switch (D) {
    case 32: return tc::info<32>(info);
    case 64: return tc::info<64>(info);
    case 128: return tc::info<128>(info);
    case 256: return tc::info<256>(info);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// ragged_decode_n8_kernel: bf16 at G <= 8 query heads a kv head, on the
// tensor cores (llama3.2-1b and mistral-nemo-12b at G 4, granite-moe-3b-
// a800m at G 3, each with eight kv heads).
//
// Replaces, like the kernels above, the TPU kernel
// src/repro/kernels/ragged_decode_attn.py (_kernel). Bound: the bytes of
// K/V (G flop/byte, 4 at G 4 in bf16). At the serves' shapes that bound
// is 2.2 us (D 64) and 4.4 us (D 128), so what the split kernel loses
// there is latency: a chain of dependent loads before the first K/V byte
// (lengths, then slots, then K/V), few bytes in flight (registers), a
// shuffle reduction per head per key, and a second pass of float32
// partials through L2 behind a fence and an arrival counter. This kernel
// keeps ragged_decode_tc_kernel's rules (one pass over K/V for the G
// heads, a cp.async ring, P as bf16 hi + lo, a cluster merge through
// DSMEM, one launch, no scratch) and turns the product around, so that G
// <= 8 heads fill the n8 side of mma.sync.m16n8k16 and 16 keys its m16:
//
//   S^T = K . Q^T   A: 16 keys by 16 columns of D (ldmatrix from the
//                   ring); B: Q^T, the G heads as columns (heads G .. 7
//                   zero), loaded once from device memory into registers;
//                   Q unscaled, S times log2(e) / sqrt(D) after it;
//   P^T             the online softmax per head (a column: 8 lanes share
//                   it) in base 2, float32;
//   O^T += V^T . P^T  A: 16 columns of D by the 16 keys (ldmatrix.trans of
//                   V); B: P^T as hi + lo, made from S^T's accumulators
//                   in registers: each 8 x 8 block packed to bf16 and
//                   transposed by movmatrix.
//
// Design: grid (cluster, KV, B), a thread-block cluster of `cluster` CTAs
// (at most 8) per (b, kv) group, planned on the host from static sizes
// (kernels/ragged_decode_attn.py: n8_plan); CTA c walks spans c, c +
// cluster, ... of split_t rows. Each of its W warps (8 at D 64, 4 at D
// 128) walks its own 16-row sub-tiles of those spans (warp w the CTA's
// sub-tiles w, w + W, ...) through its own ring of kStages stages (16-byte cp.async, rows past
// the span's end zero-filled and never read from the arena, chunks XOR-
// swizzled by row for ldmatrix) with its own online softmax: the loop has
// no CTA barrier, only cp.async.wait_group and __syncwarp. lengths, slots
// and Q are issued together, so the K/V addresses wait on one latency. A
// CTA whose spans start past the row's length exits at once (a cluster
// barrier waits only for threads that have not exited), except CTA 0,
// which writes zeros for a row of length 0. After the loop the warps
// leave (m, l, O) where their rings were and merge in warp order; a row
// with one CTA of rows writes its output there. Otherwise the merge is
// pushed to CTA 0: at the start CTA 0 readies an mbarrier that expects the
// bytes of its peers' slots, and every CTA with rows arrives at the
// cluster barrier (each waits on it before it first touches a peer);
// after its loop a peer stores its merged (m, l, O) into its slot of CTA
// 0's shared memory with st.async, whose bytes count on that mbarrier as
// they land, and exits; CTA 0 waits on the mbarrier (a wait past ~10 s
// traps) and merges the slots in rank order from its own memory. Only CTA
// 0 waits for another CTA; no fence, no arrival and no DSMEM load.
namespace {
namespace n8 {

constexpr int kHeads = 8;        // the n8 side: a group's query heads
constexpr int kRows = 16;        // the m16 side: keys of a warp's sub-tile
constexpr int kMaxCluster = 8;   // portable cluster size (n8_plan caps it)

template <int D>
struct Cfg {
  // eight warps at D 64 and four at D 128, so that the CTA's rows are a
  // short chain of sub-tiles for each; a warp's ring: 3 stages of 4 KB (D
  // 64) or 8 KB (D 128): 96 KB a CTA, two CTAs an SM (eight warps at D
  // 128 would take 192 KB, one CTA an SM, and lost: PERF.md)
  static constexpr int kWarps = D == 64 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kStages = 3;
  static constexpr int CPR = D / 8;              // 16-byte chunks a row
  static constexpr int kTile = kRows * D * 2;    // bytes of K (or V)
  static constexpr int kStage = 2 * kTile;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kMT = D / 16;             // k16 steps of S, m16 of O
  static constexpr int kCopies = kRows * CPR / 32;   // K copies a lane
  // after the loop, where the rings were: the warps' O (kWarps x 8 x D
  // float32) and (m, l), then the CTA's merged O (8 x D) and (m, l)
  static constexpr int kWarpML = kWarps * kHeads * D * 4;
  static constexpr int kCtaO = kWarpML + kWarps * kHeads * 8;
  static constexpr int kCtaML = kCtaO + kHeads * D * 4;
  static constexpr int kBytes = kWarps * kRing;
  static_assert(kCtaML + kHeads * 8 <= kBytes, "states fit in the rings");
  // after the rings, in CTA 0 of a cluster: the barrier its peers arrive
  // on, then a slot a peer for its (O, (m, l)), written by the peer
  static constexpr int kBar = kBytes;
  static constexpr int kMail = kBar + 16;
  static constexpr int kSlot = kHeads * D * 4 + kHeads * 8;
  static constexpr int bytes(int cluster) {
    return kMail + (cluster - 1) * kSlot;
  }
  static_assert(kRows * CPR % 32 == 0 && D >= 64, "tile shape");
};

// the 8 x 8 bf16 matrix whose row g, columns 2t and 2t + 1 lane (g, t)
// holds, transposed in registers
__device__ __forceinline__ uint32_t transpose8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// stores into a peer's shared memory that count their bytes on the
// peer's barrier `bar` when they land (no fence, no arrival)
__device__ __forceinline__ void st_peer(uint32_t addr, float x,
                                        uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "f"(x), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_peer2(uint32_t addr, float x, float y,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr),
      "f"(x), "f"(y), "r"(bar)
      : "memory");
}

// a wait for phase `parity` of the barrier at `bar` that acquires at
// cluster scope (the peers' stores); past ~10 s of clock it traps, so a
// lost arrival is a launch error and not a hung card
__device__ __forceinline__ void wait_cluster(uint32_t bar, int parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    if (clock64() - t0 > (1ll << 34)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 2)
ragged_decode_n8_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ lengths,
                        const int* __restrict__ slots,
                        __nv_bfloat16* __restrict__ out, int H, int KV, int N,
                        int T, int span, int n_split, int split_t,
                        float scale_log2) {
  using C = Cfg<D>;
  constexpr int kWarps = C::kWarps, kThreads = C::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = tc::smem_addr(smem);
  const int cs = gridDim.x;        // CTAs of the cluster
  const int c = tc::cluster_rank();
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;         // an accumulator's rows g and g + 8
  const int t = lane & 3;          // and its column pair 2t, 2t + 1

  // lengths and slots first, Q under their latency (no slots: row b)
  const int len_in = lengths[b];
  const int slot_in = slots != nullptr ? slots[b] : b;
  uint32_t qf[C::kMT][2];          // Q^T's B fragments: head g, columns
  {                                // 16 ks + 2t, + 1 and 16 ks + 2t + 8, + 9
    const unsigned int* qh = reinterpret_cast<const unsigned int*>(
        q + ((size_t)b * H + (size_t)kvh * G + (g < G ? g : 0)) * D + 2 * t);
#pragma unroll
    for (int ks = 0; ks < C::kMT; ++ks) {
      qf[ks][0] = g < G ? __ldg(qh + 8 * ks) : 0u;
      qf[ks][1] = g < G ? __ldg(qh + 8 * ks + 4) : 0u;
    }
  }
  const int len = max(0, min(min(len_in, span), n_split * split_t));
  const int n_active = (len + split_t - 1) / split_t;   // spans with rows
  const int n_act = max(1, min(cs, n_active));          // CTAs with rows
  if (c >= n_act) return;
  // a row of several CTAs: CTA 0 readies the barrier its peers will
  // arrive on, and every CTA with rows arrives at the cluster barrier
  // (each waits on it before its first access to a peer's memory)
  const uint32_t bar = base + C::kBar;
  if (n_act > 1) {
    if (c == 0 && tid == 0) {
      // one arrival (this one) and the bytes of every peer's slot
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                   : "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar),
          "r"((n_act - 1) * (G * D * 4 + G * 8))
          : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }
  const int slot = slot_in < 0 ? 0 : (slot_in > N - 1 ? N - 1 : slot_in);
  const size_t t_stride = (size_t)KV * D;
  const size_t row0 = (size_t)slot * T * t_stride + (size_t)kvh * D;
  const __nv_bfloat16* kb = k + row0;
  const __nv_bfloat16* vb = v + row0;

  // this CTA's spans c, c + cs, ... below n_active, in sub-tiles of 16
  // rows; this warp's: sub-tiles warp, warp + kWarps, ...
  const int sps = (split_t + kRows - 1) / kRows;   // sub-tiles a span
  const int n_mine = c < n_active ? (n_active - 1 - c) / cs + 1 : 0;
  int n_sub = 0;
  if (n_mine > 0) {
    const int last = c + (n_mine - 1) * cs;
    const int rows = min(split_t, len - last * split_t);
    n_sub = (n_mine - 1) * sps + (rows + kRows - 1) / kRows;
  }
  const int n_w = n_sub > warp ? (n_sub - 1 - warp) / kWarps + 1 : 0;
  // this warp's sub-tile j: its first row and how many rows it has
  auto sub = [&](int j, int& t0, int& nrows) {
    const int u = warp + j * kWarps;
    const int s = c + (u / sps) * cs;
    t0 = s * split_t + (u % sps) * kRows;
    nrows = min(min(t0 + kRows, (s + 1) * split_t), len) - t0;
  };
  const uint32_t ring = base + warp * C::kRing;
  // sub-tile j's K and V into stage j % kStages of this warp's ring, one
  // cp.async group a sub-tile (an empty group past the last keeps the
  // count of groups)
  auto issue = [&](int j) {
    if (j < n_w) {
      int t0, nrows;
      sub(j, t0, nrows);
      const uint32_t st = ring + (j % C::kStages) * C::kStage;
#pragma unroll
      for (int i = 0; i < C::kCopies; ++i) {
        const int e = lane + 32 * i;
        const int r = e / C::CPR, ch = e % C::CPR;
        const bool ok = r < nrows;
        const size_t off = (size_t)(t0 + (ok ? r : 0)) * t_stride + ch * 8;
        tc::cp_async16(st + tc::swz<D>(r, ch), kb + off, ok);
        tc::cp_async16(st + C::kTile + tc::swz<D>(r, ch), vb + off, ok);
      }
    }
    tc::cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < C::kStages - 1; ++j) issue(j);

  float m[2] = {-1e30f, -1e30f};   // heads 2t and 2t + 1
  float l[2] = {0.f, 0.f};         // this lane's share: keys g and g + 8
  float o[C::kMT][4];              // O^T: rows (D) 16 mt + g, + 8; columns
#pragma unroll                     // (heads) 2t, 2t + 1
  for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;

  for (int j = 0; j < n_w; ++j) {
    tc::cp_async_wait<C::kStages - 2>();
    // sub-tile j is in for every lane; sub-tile j - 1's stage is free
    __syncwarp();
    issue(j + C::kStages - 1);
    int t0, nrows;
    sub(j, t0, nrows);
    const uint32_t kt = ring + (j % C::kStages) * C::kStage;
    const uint32_t vt = kt + C::kTile;

    // 1. S^T for the sub-tile's 16 keys over all of D, two chains
    float sc[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < C::kMT; ++ks) {
      uint32_t a[4];
      tc::ldsm_x4(a, kt + tc::swz<D>((lane & 7) + 8 * ((lane >> 3) & 1),
                                     2 * ks + (lane >> 4)));
      tc::mma(sc[ks & 1], a, qf[ks][0], qf[ks][1]);
    }
    // base-2 exponents; keys past the sub-tile's rows -inf
    const bool ok0 = g < nrows, ok1 = g + 8 < nrows;
    float s[4];                    // (key g, key g + 8) x (head 2t, 2t + 1)
    s[0] = ok0 ? (sc[0][0] + sc[1][0]) * scale_log2 : -INFINITY;
    s[1] = ok0 ? (sc[0][1] + sc[1][1]) * scale_log2 : -INFINITY;
    s[2] = ok1 ? (sc[0][2] + sc[1][2]) * scale_log2 : -INFINITY;
    s[3] = ok1 ? (sc[0][3] + sc[1][3]) * scale_log2 : -INFINITY;

    // 2. the online softmax of each head over the 8 lanes that share t
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(s[h], s[2 + h]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float mn = fmaxf(m[h], mx);
      corr[h] = tc::ex2(m[h] - mn);
      m[h] = mn;
      s[h] = tc::ex2(s[h] - mn);           // ex2(-inf) = 0
      s[2 + h] = tc::ex2(s[2 + h] - mn);
      l[h] = l[h] * corr[h] + s[h] + s[2 + h];
    }
#pragma unroll
    for (int mt = 0; mt < C::kMT; ++mt) {
      o[mt][0] *= corr[0];
      o[mt][1] *= corr[1];
      o[mt][2] *= corr[0];
      o[mt][3] *= corr[1];
    }

    // 3. O^T += V^T . P^T, P as hi + lo: lane (g, t) holds P of key g (and
    // g + 8) for heads 2t, 2t + 1; transposed, keys 2t, 2t + 1 (and + 8)
    // for head g, the B fragment's
    uint32_t hi0, lo0, hi1, lo1;
    tc::split_pair(s[0], s[1], hi0, lo0);
    tc::split_pair(s[2], s[3], hi1, lo1);
    const uint32_t bh0 = transpose8(hi0), bh1 = transpose8(hi1);
    const uint32_t bl0 = transpose8(lo0), bl1 = transpose8(lo1);
#pragma unroll
    for (int mt = 0; mt < C::kMT; ++mt) {
      uint32_t a[4];
      tc::ldsm_x4_t(a, vt + tc::swz<D>((lane & 7) + 8 * (lane >> 4),
                                       2 * mt + ((lane >> 3) & 1)));
      tc::mma(o[mt], a, bh0, bh1);
      tc::mma(o[mt], a, bl0, bl1);
    }
  }

  // 4. every warp's (m, l, O) where the rings were, then merged in warp
  // order: the row's output, or this CTA's (m, l, O) for the cluster
  tc::cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 4);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 8);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 16);
  }
  float* s_wo = reinterpret_cast<float*>(smem);             // [w][head][D]
  float2* s_wml = reinterpret_cast<float2*>(smem + C::kWarpML);
  {
    float* wo = s_wo + warp * kHeads * D;
#pragma unroll
    for (int mt = 0; mt < C::kMT; ++mt) {
      const int d = 16 * mt + g;
      wo[2 * t * D + d] = o[mt][0];
      wo[(2 * t + 1) * D + d] = o[mt][1];
      wo[2 * t * D + d + 8] = o[mt][2];
      wo[(2 * t + 1) * D + d + 8] = o[mt][3];
    }
    if (g == 0) {
      s_wml[warp * kHeads + 2 * t] = make_float2(m[0], l[0]);
      s_wml[warp * kHeads + 2 * t + 1] = make_float2(m[1], l[1]);
    }
  }
  __syncthreads();
  float* s_co = reinterpret_cast<float*>(smem + C::kCtaO);  // [head][D]
  float2* s_cml = reinterpret_cast<float2*>(smem + C::kCtaML);
  __nv_bfloat16* og = out + ((size_t)b * H + (size_t)kvh * G) * D;
  // a peer writes its merged (m, l, O) into its slot of CTA 0's mailbox
  if (n_act > 1)
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const uint32_t mail = c > 0 ? tc::peer(base + C::kMail + (c - 1) * C::kSlot,
                                         0)
                              : 0u;
  const uint32_t bar0 = c > 0 ? tc::peer(bar, 0) : 0u;
  for (int i = tid; i < G * D; i += kThreads) {
    const int h = i / D, d = i % D;
    float mm = -1e30f, ll = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float2 ml = s_wml[w * kHeads + h];
      const float mn = fmaxf(mm, ml.x);
      const float ca = tc::ex2(mm - mn), cb = tc::ex2(ml.x - mn);
      ll = ll * ca + ml.y * cb;
      a = a * ca + s_wo[(w * kHeads + h) * D + d] * cb;
      mm = mn;
    }
    if (n_act == 1) {
      og[i] = __float2bfloat16_rn(a / fmaxf(ll, 1e-30f));
    } else if (c == 0) {
      s_co[i] = a;
      if (d == 0) s_cml[h] = make_float2(mm, ll);
    } else {
      st_peer(mail + 4 * i, a, bar0);
      if (d == 0) st_peer2(mail + kHeads * D * 4 + 8 * h, mm, ll, bar0);
    }
  }
  if (n_act == 1 || c > 0) return;   // a peer's stores land on their own

  // 5. CTA 0 merges the group's G * D outputs over its own (m, l, O) and
  // its peers' slots, in rank order, once every peer's bytes have landed
  __syncthreads();
  wait_cluster(bar, 0);
  const int n4 = G * D / 4;
  for (int i = tid; i < n4; i += kThreads) {
    const int h = 4 * i / D;
    float2 ml[kMaxCluster];
    float4 x[kMaxCluster];
    ml[0] = s_cml[h];
    x[0] = reinterpret_cast<const float4*>(s_co)[i];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      if (r < n_act) {
        const unsigned char* slot_r = smem + C::kMail + (r - 1) * C::kSlot;
        ml[r] = reinterpret_cast<const float2*>(slot_r + kHeads * D * 4)[h];
        x[r] = reinterpret_cast<const float4*>(slot_r)[i];
      }
    float mm = -1e30f, ll = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n_act) {
        const float mn = fmaxf(mm, ml[r].x);
        const float ca = tc::ex2(mm - mn), cb = tc::ex2(ml[r].x - mn);
        ll = ll * ca + ml[r].y * cb;
        a.x = a.x * ca + x[r].x * cb;
        a.y = a.y * ca + x[r].y * cb;
        a.z = a.z * ca + x[r].z * cb;
        a.w = a.w * ca + x[r].w * cb;
        mm = mn;
      }
    const float den = fmaxf(ll, 1e-30f);
    const __nv_bfloat162 o01 = __floats2bfloat162_rn(a.x / den, a.y / den);
    const __nv_bfloat162 o23 = __floats2bfloat162_rn(a.z / den, a.w / den);
    *reinterpret_cast<uint2*>(og + 4 * i) =
        make_uint2(tc::bits(o01), tc::bits(o23));
  }
}

template <int D>
cudaLaunchConfig_t config(int cluster, int KV, int B, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, KV, B);
  cfg.blockDim = dim3(Cfg<D>::kThreads);
  cfg.dynamicSmemBytes = Cfg<D>::bytes(cluster);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int D>
cudaError_t grant() {
  static int granted = 48 * 1024;
  return repro::allow_smem(ragged_decode_n8_kernel<D>,
                           Cfg<D>::bytes(kMaxCluster), &granted);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           const void* slots, void* out, int B, int H, int KV, int N, int T,
           int span, int n_split, int split_t, int cluster,
           cudaStream_t stream) {
  cudaError_t err = grant<D>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<D>(cluster, KV, B, stream, attr);
  // the scores' scale times log2(e): the softmax runs in base 2
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  err = cudaLaunchKernelEx(
      &cfg, ragged_decode_n8_kernel<D>,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
      static_cast<const int*>(slots), static_cast<__nv_bfloat16*>(out), H, KV,
      N, T, span, n_split, split_t, scale_log2);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// registers and local (spill) bytes a thread, CTAs an SM and shared
// memory bytes a CTA at clusters of 4 (the serves'), clusters of
// kMaxCluster CTAs the card holds at once
template <int D>
int info(int* out) {
  cudaError_t err = grant<D>();
  cudaFuncAttributes a;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&a, ragged_decode_n8_kernel<D>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], ragged_decode_n8_kernel<D>, Cfg<D>::kThreads,
        Cfg<D>::bytes(4));
  if (err == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        config<D>(kMaxCluster, 1, 1, nullptr, attr);
    err = cudaOccupancyMaxActiveClusters(&out[4], ragged_decode_n8_kernel<D>,
                                         &cfg);
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[3] = Cfg<D>::bytes(4);
  return 0;
}

}  // namespace n8
}  // namespace

// bf16 q (B, H, D), k, v (N, T, KV, D), lengths (B,) int32, slots (B,)
// int32 or null (row b), out (B, H, D) bf16, at H / KV <= 8 and D 64 or
// 128; row b attends positions below min(lengths[b], span, n_split *
// split_t) of arena row min(slots[b], N - 1); `cluster` CTAs (at most 8)
// per (b, kv) group.
extern "C" int repro_ragged_decode_n8(const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      const void* slots, void* out, int B,
                                      int H, int KV, int D, int N, int T,
                                      int span, int n_split, int split_t,
                                      int cluster, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || H / KV > n8::kHeads || N <= 0 ||
      span <= 0 || span > T || n_split <= 0 || split_t <= 0 ||
      cluster < 1 || cluster > n8::kMaxCluster)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return n8::launch<64>(q, k, v, lengths, slots, out, B, H, KV, N, T,
                            span, n_split, split_t, cluster, s);
    case 128:
      return n8::launch<128>(q, k, v, lengths, slots, out, B, H, KV, N, T,
                             span, n_split, split_t, cluster, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// info: registers, spill bytes, CTAs an SM, shared memory bytes, clusters
// of 8 held at once, for the instantiation at head dim D (64 or 128)
extern "C" int repro_ragged_decode_n8_info(int D, int* info) {
  switch (D) {
    case 64: return n8::info<64>(info);
    case 128: return n8::info<128>(info);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// ragged_decode_n8_tf32_kernel: float32 at G <= 8 query heads a kv head, on
// the tensor cores as split TF32 (the float32 exact checks of llama3.2-1b
// and mistral-nemo-12b at G 4 and of granite-moe-3b-a800m at G 3).
//
// Replaces, like the kernels above, the TPU kernel
// src/repro/kernels/ragged_decode_attn.py (_kernel), here in float32.
// Bound: the bytes of K/V (G / 2 flop/byte in float32, 2 at G 4), 8.77 us at
// mistral-nemo-12b's exact shape. It keeps ragged_decode_n8_kernel's layout
// and rules: 16 keys the m16 side and the G <= 8 heads the n8 side (S^T =
// K . Q^T, O^T += V^T . P^T); a cp.async ring, an online softmax in base 2
// and no CTA barrier a warp; CTAs past a row's length exit at once; a
// cluster of at most 8 CTAs a (b, kv) group, planned from static sizes
// (kernels/ragged_decode_attn.py: n8_tf32_plan); the push merge into CTA 0
// by st.async; one launch, no scratch; a null slot pointer reads row b.
// Every product runs on mma.sync.m16n8k8 with TF32 operands as three
// products, lo.hi + hi.lo + hi.hi accumulated in float32 (tf32.cuh: x = hi
// + lo, both TF32; the lo.lo term and the residual are ~2^-22 of x), so the
// output keeps float32 accuracy and no allow_tf32 setting is read:
//
//   Q   split once, into registers: Q^T's hi and lo B fragments (head g,
//       columns 8 ks + t and 8 ks + t + 4), D / 2 registers;
//   K   A fragments by ldmatrix (one 32-bit word is two b16, so lane (g, t)
//       gets key g, column t of each 8 x 4 float block, as m16n8k8's TF32
//       A fragment wants), split as they leave shared memory;
//   P   split from the float32 softmax. P^T's B fragment wants (key, head
//       g), where S^T's accumulators hold (key g, heads 2t, 2t + 1): each
//       value comes from its holder by __shfl_sync, two shuffles a value
//       (a holder keeps two heads, a reader wants one of them);
//   V   V^T's A fragment wants (column d, key) out of (key, d) rows, and no
//       32-bit transposing load exists (ldmatrix.trans and movmatrix move
//       b16). So P.V takes the orders that plain 16-byte loads give: its
//       k step kk takes keys 8 kk + 2t (k index t) and 8 kk + 2t + 1 (t +
//       4), two neighbouring rows, and O^T's rows are permuted,
//       m tiles 2p and 2p + 1 holding columns 32 p + 4g .. 32 p + 4g + 3
//       (rows g and g + 8 of tile 2p the first two, of tile 2p + 1 the last
//       two). One 16-byte load of a key row gives a lane its A words of two
//       m tiles, and the output leaves as 16-byte stores.
//
// The tiles keep the bf16 kernels' swizzle (16-byte chunk c of row r at c
// ^ (r & 7)): ldmatrix's rows and the V loads (lanes (g, t) of a quarter
// warp at chunk 8p + g of rows 2t, 2t + 1 mod 8) each hit 8 different bank
// groups. The three products of a k step go to different ones of four
// accumulators of S^T, and P.V's products run over all m tiles in turn, so
// no product waits on the one before it.
//
// Shared memory doubles against bf16: 16 rows of K and V are 8 KB at D 64
// and 16 KB at D 128. A warp's sub-tile is a serial chain of ldmatrix,
// splits and products (~2,250 cycles at D 128 on the card, ~1,650 at D 64:
// 128 splits of five integer and float operations and 96 TF32 products),
// and the CTA of a row's longest span is the kernel's time, so a CTA keeps
// four warps at both widths, each with three stages: 96 KB and two CTAs an
// SM at D 64, 192 KB and one CTA an SM at D 128. (Two warps of 96 KB at D
// 128, two CTAs an SM, and rows by the bulk copy engine, one row a lane
// and a stage barrier a warp, were slower: PERF.md.)
namespace {
namespace n8t {

using n8::kHeads;
using n8::kMaxCluster;
using n8::kRows;

template <int D>
struct Cfg {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kStages = 3;           // a warp's ring
  static constexpr int CPR = D / 4;              // 16-byte chunks a row
  static constexpr int kTile = kRows * D * 4;    // bytes of K (or V)
  static constexpr int kStage = 2 * kTile;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kKS = D / 8;              // k8 steps of S^T
  static constexpr int kMT = D / 16;             // m16 tiles of O^T
  static constexpr int kCopies = kRows * CPR / 32;   // K copies a lane
  // after the loop, where the rings were: the warps' O (kWarps x 8 heads,
  // rows of kOS floats) and (m, l), then the CTA's merged O (8 x D) and
  // (m, l)
  static constexpr int kOS = D + 4;
  static constexpr int kWarpML = kWarps * kHeads * kOS * 4;
  static constexpr int kCtaO = kWarpML + kWarps * kHeads * 8;
  static constexpr int kCtaML = kCtaO + kHeads * D * 4;
  static constexpr int kBytes = kWarps * kRing;
  static_assert(kCtaML + kHeads * 8 <= kBytes, "states fit in the rings");
  // after the rings, in CTA 0 of a cluster: the barrier its peers arrive
  // on, then a slot a peer for its (O, (m, l)), written by the peer
  static constexpr int kBar = kBytes;
  static constexpr int kMail = kBar + 16;
  static constexpr int kSlot = kHeads * D * 4 + kHeads * 8;
  static constexpr int bytes(int cluster) {
    return kMail + (cluster - 1) * kSlot;
  }
  static_assert(kRows * CPR % 32 == 0 && D % 32 == 0 && D >= 64,
                "tile shape");
};

// byte offset of 16-byte chunk c (four floats) of row r in a float32 tile
// D columns wide, chunks XOR-swizzled by the row
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * (D / 4) + (c ^ (r & 7))) << 4;
}

// d += a . b: m16n8k8, TF32 operands, float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 2)
ragged_decode_n8_tf32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const int* __restrict__ lengths,
                             const int* __restrict__ slots,
                             float* __restrict__ out, int H, int KV, int N,
                             int T, int span, int n_split, int split_t,
                             float scale_log2) {
  using C = Cfg<D>;
  constexpr int kWarps = C::kWarps, kThreads = C::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = tc::smem_addr(smem);
  const int cs = gridDim.x;        // CTAs of the cluster
  const int c = tc::cluster_rank();
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;         // an accumulator's rows g and g + 8
  const int t = lane & 3;          // and its column pair 2t, 2t + 1

  // lengths and slots first, Q under their latency (no slots: row b)
  const int len_in = lengths[b];
  const int slot_in = slots != nullptr ? slots[b] : b;
  float qx[C::kKS][2];             // Q^T's B fragments: head g, columns
  {                                // 8 ks + t and 8 ks + t + 4
    const float* qp =
        q + ((size_t)b * H + (size_t)kvh * G + (g < G ? g : 0)) * D + t;
#pragma unroll
    for (int ks = 0; ks < C::kKS; ++ks) {
      qx[ks][0] = g < G ? __ldg(qp + 8 * ks) : 0.f;
      qx[ks][1] = g < G ? __ldg(qp + 8 * ks + 4) : 0.f;
    }
  }
  const int len = max(0, min(min(len_in, span), n_split * split_t));
  const int n_active = (len + split_t - 1) / split_t;   // spans with rows
  const int n_act = max(1, min(cs, n_active));          // CTAs with rows
  if (c >= n_act) return;
  // a row of several CTAs: CTA 0 readies the barrier its peers will
  // arrive on, and every CTA with rows arrives at the cluster barrier
  // (each waits on it before its first access to a peer's memory)
  const uint32_t bar = base + C::kBar;
  if (n_act > 1) {
    if (c == 0 && tid == 0) {
      // one arrival (this one) and the bytes of every peer's slot
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                   : "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar),
          "r"((n_act - 1) * (G * D * 4 + G * 8))
          : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }
  const int slot = slot_in < 0 ? 0 : (slot_in > N - 1 ? N - 1 : slot_in);
  const size_t t_stride = (size_t)KV * D;
  const size_t row0 = (size_t)slot * T * t_stride + (size_t)kvh * D;
  const float* kb = k + row0;
  const float* vb = v + row0;

  // this CTA's spans c, c + cs, ... below n_active, in sub-tiles of 16
  // rows; this warp's: sub-tiles warp, warp + kWarps, ...
  const int sps = (split_t + kRows - 1) / kRows;   // sub-tiles a span
  const int n_mine = c < n_active ? (n_active - 1 - c) / cs + 1 : 0;
  int n_sub = 0;
  if (n_mine > 0) {
    const int last = c + (n_mine - 1) * cs;
    const int rows = min(split_t, len - last * split_t);
    n_sub = (n_mine - 1) * sps + (rows + kRows - 1) / kRows;
  }
  const int n_w = n_sub > warp ? (n_sub - 1 - warp) / kWarps + 1 : 0;
  // this warp's sub-tile j: its first row and how many rows it has
  auto sub = [&](int j, int& t0, int& nrows) {
    const int u = warp + j * kWarps;
    const int s = c + (u / sps) * cs;
    t0 = s * split_t + (u % sps) * kRows;
    nrows = min(min(t0 + kRows, (s + 1) * split_t), len) - t0;
  };
  const uint32_t ring = base + warp * C::kRing;
  // this lane's copies of a sub-tile: chunk ch of its rows r0, r0 + kRPI,
  // ... (kRPI rows a copy instruction), at offsets from the sub-tile's
  // first row that are the same for every sub-tile
  constexpr int kRPI = 32 / C::CPR;
  const int ch = lane % C::CPR, r0 = lane / C::CPR;
  const size_t lane_off = (size_t)r0 * t_stride + ch * 4;
  const size_t step = (size_t)kRPI * t_stride;
  // sub-tile j's K and V into stage j % kStages of this warp's ring, one
  // cp.async group a sub-tile (an empty group past the last keeps the
  // count of groups); rows past the sub-tile's end are zero-filled
  auto issue = [&](int j) {
    if (j < n_w) {
      int t0, nrows;
      sub(j, t0, nrows);
      const uint32_t st = ring + (j % C::kStages) * C::kStage;
      const float* ks = kb + (size_t)t0 * t_stride;
      const float* vs = vb + (size_t)t0 * t_stride;
      size_t o = lane_off;
#pragma unroll
      for (int i = 0; i < C::kCopies; ++i, o += step) {
        const int r = r0 + kRPI * i;
        const bool ok = r < nrows;
        const size_t src = ok ? o : (size_t)ch * 4;   // row t0 past the end
        const uint32_t dst = st + swz<D>(r, ch);
        repro::cp_async16(dst, ks + src, ok);
        repro::cp_async16(dst + C::kTile, vs + src, ok);
      }
    }
    tc::cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < C::kStages - 1; ++j) issue(j);

  // Q as hi + lo, once (after the first issues: its loads are in by now)
  uint32_t qh[C::kKS][2], ql[C::kKS][2];
#pragma unroll
  for (int ks = 0; ks < C::kKS; ++ks) {
    repro::split(qx[ks][0], qh[ks][0], ql[ks][0]);
    repro::split(qx[ks][1], qh[ks][1], ql[ks][1]);
  }

  float m[2] = {-1e30f, -1e30f};   // heads 2t and 2t + 1
  float l[2] = {0.f, 0.f};         // this lane's share: keys g and g + 8
  float o[C::kMT][4];              // O^T: rows (D, permuted) g, g + 8;
#pragma unroll                     // columns (heads) 2t, 2t + 1
  for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;
  // P^T's holders: lanes (2t, g / 2) and (2t + 1, g / 2) hold keys 8 kk +
  // 2t and 8 kk + 2t + 1 for heads g & ~1 and g | 1
  const int src = 8 * t + (g >> 1);
  const bool odd = g & 1;

  for (int j = 0; j < n_w; ++j) {
    tc::cp_async_wait<C::kStages - 2>();
    // sub-tile j is in for every lane; sub-tile j - 1's stage is free
    __syncwarp();
    issue(j + C::kStages - 1);
    int t0, nrows;
    sub(j, t0, nrows);
    const uint32_t kt = ring + (j % C::kStages) * C::kStage;
    const unsigned char* vt = smem + (kt - base) + C::kTile;

    // 1. S^T for the sub-tile's 16 keys over all of D: per k8 step lo.hi,
    // hi.lo and hi.hi, dealt over four accumulators in turn
    float sc[4][4] = {};
#pragma unroll
    for (int ks = 0; ks < C::kKS; ++ks) {
      uint32_t a[4], ah[4], al[4];
      tc::ldsm_x4(a, kt + swz<D>((lane & 7) + 8 * ((lane >> 3) & 1),
                                 2 * ks + (lane >> 4)));
#pragma unroll
      for (int i = 0; i < 4; ++i)
        repro::split(__uint_as_float(a[i]), ah[i], al[i]);
      mma(sc[(3 * ks) & 3], al, qh[ks][0], qh[ks][1]);
      mma(sc[(3 * ks + 1) & 3], ah, ql[ks][0], ql[ks][1]);
      mma(sc[(3 * ks + 2) & 3], ah, qh[ks][0], qh[ks][1]);
    }
    // base-2 exponents; keys past the sub-tile's rows -inf
    const bool ok0 = g < nrows, ok1 = g + 8 < nrows;
    float s[4];                    // (key g, key g + 8) x (head 2t, 2t + 1)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = (sc[0][e] + sc[1][e]) + (sc[2][e] + sc[3][e]);
      s[e] = (e < 2 ? ok0 : ok1) ? x * scale_log2 : -INFINITY;
    }

    // 2. the online softmax of each head over the 8 lanes that share t
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(s[h], s[2 + h]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float mn = fmaxf(m[h], mx);
      corr[h] = tc::ex2(m[h] - mn);
      m[h] = mn;
      s[h] = tc::ex2(s[h] - mn);           // ex2(-inf) = 0
      s[2 + h] = tc::ex2(s[2 + h] - mn);
      l[h] = l[h] * corr[h] + s[h] + s[2 + h];
    }
#pragma unroll
    for (int mt = 0; mt < C::kMT; ++mt) {
      o[mt][0] *= corr[0];
      o[mt][1] *= corr[1];
      o[mt][2] *= corr[0];
      o[mt][3] *= corr[1];
    }

    // 3. P^T's B fragments of k steps kk = 0, 1 (keys 0 .. 7, 8 .. 15):
    // lane (g, t) takes P of head g at keys 8 kk + 2t and 8 kk + 2t + 1
    // from their holders, as hi + lo
    uint32_t ph[2][2], pl[2][2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float e = __shfl_sync(0xffffffffu, s[2 * kk], src + 4 * i);
        const float f = __shfl_sync(0xffffffffu, s[2 * kk + 1], src + 4 * i);
        repro::split(odd ? f : e, ph[kk][i], pl[kk][i]);
      }

    // 4. O^T += V^T . P^T: per k step, lane (g, t) loads columns 32 p + 4g
    // .. + 3 of key rows 8 kk + 2t (x0) and 8 kk + 2t + 1 (x1): the A
    // words of m tiles 2p (columns + 0, + 1) and 2p + 1 (+ 2, + 3)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t vh[C::kMT][4], vl[C::kMT][4];
#pragma unroll
      for (int p = 0; p < C::kMT / 2; ++p) {
        const float4 x0 = *reinterpret_cast<const float4*>(
            vt + swz<D>(8 * kk + 2 * t, 8 * p + g));
        const float4 x1 = *reinterpret_cast<const float4*>(
            vt + swz<D>(8 * kk + 2 * t + 1, 8 * p + g));
        const float a0[4] = {x0.x, x0.y, x1.x, x1.y};
        const float a1[4] = {x0.z, x0.w, x1.z, x1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          repro::split(a0[i], vh[2 * p][i], vl[2 * p][i]);
          repro::split(a1[i], vh[2 * p + 1][i], vl[2 * p + 1][i]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < C::kMT; ++mt)
        mma(o[mt], vl[mt], ph[kk][0], ph[kk][1]);
#pragma unroll
      for (int mt = 0; mt < C::kMT; ++mt)
        mma(o[mt], vh[mt], pl[kk][0], pl[kk][1]);
#pragma unroll
      for (int mt = 0; mt < C::kMT; ++mt)
        mma(o[mt], vh[mt], ph[kk][0], ph[kk][1]);
    }
  }

  // 5. every warp's (m, l, O) where the rings were, then merged in warp
  // order: the row's output, or this CTA's (m, l, O) for the cluster
  tc::cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 4);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 8);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 16);
  }
  float* s_wo = reinterpret_cast<float*>(smem);          // [w][head][kOS]
  float2* s_wml = reinterpret_cast<float2*>(smem + C::kWarpML);
  {
    float* wo = s_wo + warp * kHeads * C::kOS;
#pragma unroll
    for (int p = 0; p < C::kMT / 2; ++p) {
      const int d = 32 * p + 4 * g;
      *reinterpret_cast<float4*>(wo + 2 * t * C::kOS + d) = make_float4(
          o[2 * p][0], o[2 * p][2], o[2 * p + 1][0], o[2 * p + 1][2]);
      *reinterpret_cast<float4*>(wo + (2 * t + 1) * C::kOS + d) =
          make_float4(o[2 * p][1], o[2 * p][3], o[2 * p + 1][1],
                      o[2 * p + 1][3]);
    }
    if (g == 0) {
      s_wml[warp * kHeads + 2 * t] = make_float2(m[0], l[0]);
      s_wml[warp * kHeads + 2 * t + 1] = make_float2(m[1], l[1]);
    }
  }
  __syncthreads();
  float* s_co = reinterpret_cast<float*>(smem + C::kCtaO);  // [head][D]
  float2* s_cml = reinterpret_cast<float2*>(smem + C::kCtaML);
  float* og = out + ((size_t)b * H + (size_t)kvh * G) * D;
  // a peer writes its merged (m, l, O) into its slot of CTA 0's mailbox
  if (n_act > 1)
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const uint32_t mail = c > 0 ? tc::peer(base + C::kMail + (c - 1) * C::kSlot,
                                         0)
                              : 0u;
  const uint32_t bar0 = c > 0 ? tc::peer(bar, 0) : 0u;
  for (int i = tid; i < G * D; i += kThreads) {
    const int h = i / D, d = i % D;
    float mm = -1e30f, ll = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float2 ml = s_wml[w * kHeads + h];
      const float mn = fmaxf(mm, ml.x);
      const float ca = tc::ex2(mm - mn), cb = tc::ex2(ml.x - mn);
      ll = ll * ca + ml.y * cb;
      a = a * ca + s_wo[(w * kHeads + h) * C::kOS + d] * cb;
      mm = mn;
    }
    if (n_act == 1) {
      og[i] = a / fmaxf(ll, 1e-30f);
    } else if (c == 0) {
      s_co[i] = a;
      if (d == 0) s_cml[h] = make_float2(mm, ll);
    } else {
      n8::st_peer(mail + 4 * i, a, bar0);
      if (d == 0) n8::st_peer2(mail + kHeads * D * 4 + 8 * h, mm, ll, bar0);
    }
  }
  if (n_act == 1 || c > 0) return;   // a peer's stores land on their own

  // 6. CTA 0 merges the group's G * D outputs over its own (m, l, O) and
  // its peers' slots, in rank order, once every peer's bytes have landed
  __syncthreads();
  n8::wait_cluster(bar, 0);
  const int n4 = G * D / 4;
  for (int i = tid; i < n4; i += kThreads) {
    const int h = 4 * i / D;
    float2 ml[kMaxCluster];
    float4 x[kMaxCluster];
    ml[0] = s_cml[h];
    x[0] = reinterpret_cast<const float4*>(s_co)[i];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      if (r < n_act) {
        const unsigned char* slot_r = smem + C::kMail + (r - 1) * C::kSlot;
        ml[r] = reinterpret_cast<const float2*>(slot_r + kHeads * D * 4)[h];
        x[r] = reinterpret_cast<const float4*>(slot_r)[i];
      }
    float mm = -1e30f, ll = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n_act) {
        const float mn = fmaxf(mm, ml[r].x);
        const float ca = tc::ex2(mm - mn), cb = tc::ex2(ml[r].x - mn);
        ll = ll * ca + ml[r].y * cb;
        a.x = a.x * ca + x[r].x * cb;
        a.y = a.y * ca + x[r].y * cb;
        a.z = a.z * ca + x[r].z * cb;
        a.w = a.w * ca + x[r].w * cb;
        mm = mn;
      }
    const float den = fmaxf(ll, 1e-30f);
    reinterpret_cast<float4*>(og)[i] =
        make_float4(a.x / den, a.y / den, a.z / den, a.w / den);
  }
}

template <int D>
cudaLaunchConfig_t config(int cluster, int KV, int B, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, KV, B);
  cfg.blockDim = dim3(Cfg<D>::kThreads);
  cfg.dynamicSmemBytes = Cfg<D>::bytes(cluster);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int D>
cudaError_t grant() {
  static int granted = 48 * 1024;
  return repro::allow_smem(ragged_decode_n8_tf32_kernel<D>,
                           Cfg<D>::bytes(kMaxCluster), &granted);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           const void* slots, void* out, int B, int H, int KV, int N, int T,
           int span, int n_split, int split_t, int cluster,
           cudaStream_t stream) {
  cudaError_t err = grant<D>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<D>(cluster, KV, B, stream, attr);
  // the scores' scale times log2(e): the softmax runs in base 2
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  err = cudaLaunchKernelEx(
      &cfg, ragged_decode_n8_tf32_kernel<D>, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(lengths), static_cast<const int*>(slots),
      static_cast<float*>(out), H, KV, N, T, span, n_split, split_t,
      scale_log2);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// registers and local (spill) bytes a thread, CTAs an SM and shared
// memory bytes a CTA at clusters of 4 (the exact checks'), clusters of
// kMaxCluster CTAs the card holds at once
template <int D>
int info(int* out) {
  cudaError_t err = grant<D>();
  cudaFuncAttributes a;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&a, ragged_decode_n8_tf32_kernel<D>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], ragged_decode_n8_tf32_kernel<D>, Cfg<D>::kThreads,
        Cfg<D>::bytes(4));
  if (err == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        config<D>(kMaxCluster, 1, 1, nullptr, attr);
    err = cudaOccupancyMaxActiveClusters(
        &out[4], ragged_decode_n8_tf32_kernel<D>, &cfg);
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[3] = Cfg<D>::bytes(4);
  return 0;
}

}  // namespace n8t
}  // namespace

// float32 q (B, H, D), k, v (N, T, KV, D), lengths (B,) int32, slots (B,)
// int32 or null (row b), out (B, H, D) float32, at H / KV <= 8 and D 64 or
// 128; row b attends positions below min(lengths[b], span, n_split *
// split_t) of arena row min(slots[b], N - 1); `cluster` CTAs (at most 8)
// per (b, kv) group.
extern "C" int repro_ragged_decode_n8_tf32(const void* q, const void* k,
                                           const void* v, const void* lengths,
                                           const void* slots, void* out,
                                           int B, int H, int KV, int D,
                                           int N, int T, int span,
                                           int n_split, int split_t,
                                           int cluster, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || H / KV > n8t::kHeads || N <= 0 ||
      span <= 0 || span > T || n_split <= 0 || split_t <= 0 ||
      cluster < 1 || cluster > n8t::kMaxCluster)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return n8t::launch<64>(q, k, v, lengths, slots, out, B, H, KV, N, T,
                             span, n_split, split_t, cluster, s);
    case 128:
      return n8t::launch<128>(q, k, v, lengths, slots, out, B, H, KV, N, T,
                              span, n_split, split_t, cluster, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// info: registers, spill bytes, CTAs an SM, shared memory bytes, clusters
// of 8 held at once, for the instantiation at head dim D (64 or 128)
extern "C" int repro_ragged_decode_n8_tf32_info(int D, int* info) {
  switch (D) {
    case 64: return n8t::info<64>(info);
    case 128: return n8t::info<128>(info);
    default: return (int)cudaErrorInvalidValue;
  }
}
