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
// Bound on the H100: at the serve's prefill buckets (S <= 512, D = 64) the
// bytes of q, k, v and the output; the causal half's 4 * B * H * D * S^2 / 2
// flops outweigh them on the tensor cores from S of about 700 (H 32, KV 8).
//
// One C entry point, two kernels chosen by dtype:
//
// bfloat16 (what the serve runs): flash_tc_kernel, on the tensor cores.
// One CTA per (q-tile of 64 rows, NC heads of a KV group, batch row) runs
// one consumer warpgroup per head (NC is 4 for D <= 64 and 2 for D = 128,
// by registers; a group of G > NC heads takes (G + NC - 1) / NC CTAs side
// by side, each loading the group's K/V tiles, mostly from L2), so
// each K/V tile is loaded once per NC heads instead of once per head. A
// producer warp streams K and V tiles by TMA (cp.async.bulk.tensor through
// 3-D tensor maps (B, T, KV * D) with a box of (1, 64, <= 64 columns), so
// rows t >= T read as zeros per batch row) into a ring of 3-4 stages with
// mbarrier completion: tile j + 1 loads while tile j computes. Each
// consumer warpgroup loads its Q tile by TMA, forms S = Q K^T
// with wgmma m64n64k16 (both operands K-major from shared memory, 128-byte
// swizzle for D = 64 and two 64-column atoms for D = 128, 64-byte swizzle
// for D = 32, the same swizzle in the tensor map and the descriptor), runs
// the online softmax on the float32 accumulator fragment (row max and sum
// over the four lanes that share a row), re-packs P as bf16 A-operand
// registers and adds P V with a second wgmma whose B operand is the V tile
// read MN-major (the transposed-B form). Tiles above the causal diagonal
// and below the window are never loaded; only the tiles that cross a bound
// or the T tail are masked. Output rows past S are not stored. The grid
// runs the q-tiles with the most keys first, so the longest CTAs start in
// the first wave. Overlapping one tile's softmax with the next tile's
// products inside a warpgroup, with or without the warpgroups taking turns
// at the tensor cores, was tried and lost time at the serve's shapes.
//
// float32 (the exact checks, TF32 off): flash_fwd_kernel, on the CUDA
// cores, since the tensor cores have no full-float32 product. One CTA per
// (q-tile of 64 rows, head, batch row), looping over 64-key tiles up to the
// causal bound; each of 256 threads owns a 4 x 4 block of the score tile
// and a 4 x (D / 16) block of the accumulator; Q, K, V and P tiles live in
// float32 shared memory. No bfloat16 input reaches it.
//
// The tensor maps, tiles and barriers are tma.cuh's (shared with the SSD
// scan's tensor-core kernel); the library links against the CUDA runtime
// only.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int T,
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
        s < S ? q[(((size_t)b * S + s) * H + h) * D + d] : 0.f;
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
        kx = k[off];
        vx = v[off];
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
    float* orow = o + (((size_t)b * S + s_idx) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = acc[r][j] / den;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int T, int H, int KV, int q_offset, int window,
           cudaStream_t stream) {
  static int granted = 48 * 1024;
  const size_t smem = sizeof(float) *
      ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D +
       (size_t)kBQ * (kBK + 1));
  cudaError_t err = repro::allow_smem(flash_fwd_kernel<D>, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)D));
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, T, H, KV,
      q_offset, window, scale);
  return (int)cudaGetLastError();
}

int dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
               int S, int T, int H, int KV, int D, int q_offset, int window,
               cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<32>(q, k, v, o, B, S, T, H, KV, q_offset, window,
                        stream);
    case 64:
      return launch<64>(q, k, v, o, B, S, T, H, KV, q_offset, window,
                        stream);
    case 128:
      return launch<128>(q, k, v, o, B, S, T, H, KV, q_offset, window,
                         stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

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
using repro::tensor_map;
using repro::Tile;
using repro::tma_tile;

constexpr int kRows = repro::kTileRows;   // q rows and keys per tile

// K/V ring depth: four 16 KB stages (K and V) at D <= 64, three 32 KB ones
// at D = 128
template <int D>
__host__ __device__ constexpr int stages() { return D == 128 ? 3 : 4; }

__device__ __forceinline__ float ex2(float x) {   // 2^x; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D, int NC>
constexpr size_t smem_bytes() {
  // 1 KB of slack to align the tiles to the 1024-byte swizzle period
  return 1024 + (size_t)(NC + 2 * stages<D>()) * Tile<D>::kBytes +
         8 * (2 * stages<D>() + NC);
}

template <int D, int NC>
__global__ void __launch_bounds__(NC * 128 + 32, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int S, int T, int H, int KV,
                int q_offset, int window, float scale_log2) {
  using L = Tile<D>;
  constexpr int kStages = stages<D>();
  constexpr int kOut = D / 2;            // accumulator floats per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;                              // NC tiles
  const uint32_t k_s = q_s + NC * L::kBytes;              // kStages tiles
  const uint32_t v_s = k_s + kStages * L::kBytes;         // kStages tiles
  const uint32_t bars = v_s + kStages * L::kBytes;
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
    // producer: the K and V tiles through the ring
    if (lane == 0) {
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        mbar_wait(empty(st), ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * L::kBytes);
        const int k0 = k_lo + j * kRows;
        tma_tile<D>(k_s + st * L::kBytes, &tk, full(st), kvh * D, k0, b);
        tma_tile<D>(v_s + st * L::kBytes, &tv, full(st), kvh * D, k0, b);
      }
    }
    return;
  }

  const int wg = warp >> 2;              // consumer warpgroup = head slot
  const int wl = warp & 3;               // warp within the warpgroup
  const int t = tid & 127;
  const uint32_t my_q = q_s + wg * L::kBytes;
  const int hg = pass * NC + wg;
  const bool active = hg < G;
  const int head = kvh * G + hg;
  if (active) {
    if (t == 0) {
      mbar_expect_tx(qbar(wg), L::kBytes);
      tma_tile<D>(my_q, &tq, qbar(wg), head * D, q0, b);
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
    mbar_wait(full(st), (j / kStages) & 1);
    if (active) {
      const int k0 = k_lo + j * kRows;
      float s[32];
      repro::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        repro::wgmma_ss_n64(s, L::kmajor(my_q, kk),
                            L::kmajor(k_s + st * L::kBytes, kk), kk > 0);
      repro::wgmma_commit();
      repro::wgmma_wait_all();
      repro::fence_regs(s);

      const bool edge = k0 + kRows > T ||
                        k0 + kRows - 1 > q_offset + q0 ||
                        (window > 0 &&
                         k0 <= q_offset + q0 + kRows - 1 - window);
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
        for (int jj = 0; jj < D / 8; ++jj) {
          acc[4 * jj + 2 * h] *= corr;
          acc[4 * jj + 2 * h + 1] *= corr;
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
        repro::wgmma_rs<D>(acc, pa[kk],
                              L::mnmajor(v_s + st * L::kBytes, kk));
      repro::wgmma_commit();
      repro::wgmma_wait_all();
      repro::fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

  if (!active) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float den = l[h];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    const float inv = 1.f / fmaxf(den, 1e-30f);
    const int row = row0 + 8 * h;
    if (row >= S) continue;
    __nv_bfloat16* orow = o + (((size_t)b * S + row) * H + head) * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          acc[4 * jj + 2 * h] * inv, acc[4 * jj + 2 * h + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj + 2 * (lane & 3)) =
          v;
    }
  }
}

template <int D, int NC>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int S, int T, int H, int KV, int q_offset, int window,
              cudaStream_t stream) {
  static int granted = 48 * 1024;
  CUtensorMap tq, tk, tv;
  if (!tensor_map<D>(&tq, q, B, S, H) || !tensor_map<D>(&tk, k, B, T, KV) ||
      !tensor_map<D>(&tv, v, B, T, KV))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<D, NC>();
  cudaError_t err = repro::allow_smem(flash_tc_kernel<D, NC>, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  dim3 grid(KV * ((H / KV + NC - 1) / NC), B, (S + kRows - 1) / kRows);
  flash_tc_kernel<D, NC><<<grid, NC * 128 + 32, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, T, H, KV, q_offset,
      window, scale_log2);
  return (int)cudaGetLastError();
}

// NC consumer warpgroups: 4 at D <= 64, 2 at D = 128 (registers), never
// more than the G heads of a group
template <int D>
int dispatch_nc(const void* q, const void* k, const void* v, void* o, int B,
                int S, int T, int H, int KV, int q_offset, int window,
                cudaStream_t stream) {
  const int G = H / KV;
  const int nc_max = D == 128 ? 2 : 4;
  const int nc = G >= nc_max ? nc_max : (G >= 2 ? 2 : 1);
  if (nc == 4)
    return launch_tc<D, (D == 128 ? 2 : 4)>(q, k, v, o, B, S, T, H, KV,
                                            q_offset, window, stream);
  if (nc == 2)
    return launch_tc<D, 2>(q, k, v, o, B, S, T, H, KV, q_offset, window,
                           stream);
  return launch_tc<D, 1>(q, k, v, o, B, S, T, H, KV, q_offset, window,
                         stream);
}

int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int T, int H, int KV, int D, int q_offset, int window,
             cudaStream_t stream) {
  switch (D) {
    case 32:
      return dispatch_nc<32>(q, k, v, o, B, S, T, H, KV, q_offset, window,
                             stream);
    case 64:
      return dispatch_nc<64>(q, k, v, o, B, S, T, H, KV, q_offset, window,
                             stream);
    case 128:
      return dispatch_nc<128>(q, k, v, o, B, S, T, H, KV, q_offset, window,
                              stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

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
    return dispatch_d(q, k, v, o, B, S, T, H, KV, D, q_offset, window, s);
  if (dtype == repro::kBFloat16)
    return tc::dispatch(q, k, v, o, B, S, T, H, KV, D, q_offset, window, s);
  return (int)cudaErrorInvalidValue;
}
