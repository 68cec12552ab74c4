// Fused RMSNorm over the last axis.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (fused_rmsnorm, body
// _kernel): per row of x (rows, D),
//
//   y = (x * rsqrt(sum(x^2) / D + eps)) * scale
//
// in float32, rounded once to x's type (round to nearest even, as torch's
// cast). x is float32 or bfloat16; scale is float32 or x's type.
//
// Bound on the H100: bytes. The function reads x once and the scale once
// and writes y once, 2 * x.nbytes + 4 * D bytes with a float32 scale, and
// does four flops per element, far below the ~295 flop/byte ridge. The
// serving paths call it on decode rows (B <= 8), where one launch is the
// floor, and on prefill blocks (up to 1024 rows of 2048, 384 of 5120).
//
// Design: one CTA per row, so a row's sum never depends on how many rows
// the call has or where the row sits (batched tokens equal isolated ones).
// The row is cut into slots of 16 bytes (8 bf16 or 4 f32 values); a CTA of
// `threads` threads gives thread t the slots t, t + threads, ... (kPer of
// them, kPer in 1, 2, 4, 8, chosen with `threads` from D and the type
// alone). Each thread issues all its 16-byte loads of x, and of the scale
// when kPer <= 4, before it uses any, keeps them raw in registers, and
// widens them to float where they are used: one pass over device memory.
// The row's sum of squares is taken in float32, in a fixed order: the
// thread's own slots, then repro::warp_sum, then one small shared array
// summed by every thread in warp order. Rows wider than 8 slots x 512
// threads (D > 32768 bf16, 16384 f32) take kPer = 0, which loops over the
// row twice (the second read mostly hits L2).
//
// A row stride that is not the width lets the kernel read x[:, -1] of a
// (B, S, D) block in place. Where a pointer, the width or the row stride
// is no multiple of 16 bytes, the same slots are read and written element
// by element (kVec false): same order of summation, same result, bit for
// bit. TMA, wgmma and clusters buy nothing for one streaming pass and are
// not used.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 512;

// W values of E in one slot, kept as raw 32-bit words
template <typename E, int W>
struct Raw {
  static constexpr int kWords = W * (int)sizeof(E) / 4;
  uint32_t w[kWords];

  // the slot at p: `valid` of its W values lie inside the row
  template <bool kVec>
  __device__ __forceinline__ void load(const E* p, int valid) {
    if constexpr (kVec) {
#pragma unroll
      for (int c = 0; c < kWords / 4; ++c) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + c);
        w[4 * c] = u.x; w[4 * c + 1] = u.y; w[4 * c + 2] = u.z;
        w[4 * c + 3] = u.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kWords; ++i) w[i] = 0u;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        if (k >= valid) break;
        if constexpr (sizeof(E) == 4) {
          w[k] = __float_as_uint(__ldg(reinterpret_cast<const float*>(p) + k));
        } else {
          const uint32_t b =
              __ldg(reinterpret_cast<const unsigned short*>(p) + k);
          w[k >> 1] |= b << (16 * (k & 1));
        }
      }
    }
  }

  __device__ __forceinline__ float get(int k) const {
    if constexpr (sizeof(E) == 4) {
      return __uint_as_float(w[k]);
    } else {
      return (k & 1) ? __uint_as_float(w[k >> 1] & 0xffff0000u)
                     : __uint_as_float(w[k >> 1] << 16);
    }
  }
};

template <typename E>
__device__ __forceinline__ uint32_t bits(float v) {
  if constexpr (sizeof(E) == 4) {
    return __float_as_uint(v);
  } else {
    return (uint32_t)__bfloat16_as_ushort(repro::from_float<E>(v));
  }
}

// y's W values (`valid` of them inside the row) rounded to E, stored at p
template <typename E, int W, bool kVec>
__device__ __forceinline__ void store(E* p, const float* y, int valid) {
  if constexpr (kVec) {
    uint32_t w[4];
    if constexpr (sizeof(E) == 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = bits<E>(y[k]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = bits<E>(y[2 * k]) | (bits<E>(y[2 * k + 1]) << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (k >= valid) break;
      if constexpr (sizeof(E) == 4)
        reinterpret_cast<uint32_t*>(p)[k] = bits<E>(y[k]);
      else
        reinterpret_cast<unsigned short*>(p)[k] = (unsigned short)bits<E>(y[k]);
    }
  }
}

// one CTA per row of x (row r at x + r * stride), y contiguous (rows, D)
template <typename T, typename S, int kPer, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ y, int D, long long stride, float eps) {
  constexpr int W = 16 / (int)sizeof(T);
  constexpr bool kEarlyScale = kPer > 0 && kPer <= 4;
  const int n = (D + W - 1) / W;                 // slots per row
  const T* xr = x + (long long)blockIdx.x * stride;
  T* yr = y + (long long)blockIdx.x * D;
  __shared__ float part[kMaxThreads / 32];

  float ss = 0.f;
  // kPer > 0: the row's slots of this thread, raw; kPer == 0: unused
  Raw<T, W> xv[kPer > 0 ? kPer : 1];
  Raw<S, W> sv[kEarlyScale ? kPer : 1];
  if constexpr (kPer > 0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = threadIdx.x + i * blockDim.x;
      if (j < n) {
        xv[i].template load<kVec>(xr + j * W, D - j * W);
        if constexpr (kEarlyScale)
          sv[i].template load<kVec>(scale + j * W, D - j * W);
      } else {
#pragma unroll
        for (int c = 0; c < Raw<T, W>::kWords; ++c) xv[i].w[c] = 0u;
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float v = xv[i].get(k);
        ss += v * v;
      }
  } else {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      xv[0].template load<kVec>(xr + j * W, D - j * W);
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float v = xv[0].get(k);
        ss += v * v;
      }
    }
  }

  ss = repro::warp_sum(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
  const int n_warps = blockDim.x >> 5;
  for (int w = 0; w < n_warps; ++w) total += part[w];
  const float r = rsqrtf(total / (float)D + eps);

  if constexpr (kPer > 0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = threadIdx.x + i * blockDim.x;
      if (j >= n) continue;
      Raw<S, W> s;
      if constexpr (kEarlyScale)
        s = sv[i];
      else
        s.template load<kVec>(scale + j * W, D - j * W);
      float out[W];
#pragma unroll
      for (int k = 0; k < W; ++k) out[k] = (xv[i].get(k) * r) * s.get(k);
      store<T, W, kVec>(yr + j * W, out, D - j * W);
    }
  } else {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      Raw<S, W> s;
      xv[0].template load<kVec>(xr + j * W, D - j * W);
      s.template load<kVec>(scale + j * W, D - j * W);
      float out[W];
#pragma unroll
      for (int k = 0; k < W; ++k) out[k] = (xv[0].get(k) * r) * s.get(k);
      store<T, W, kVec>(yr + j * W, out, D - j * W);
    }
  }
}

template <typename T, typename S, int kPer>
cudaError_t launch(bool vec, const void* x, const void* scale, void* y,
                   int rows, int D, long long stride, int threads, float eps,
                   cudaStream_t s) {
  if (vec)
    rmsnorm_kernel<T, S, kPer, true><<<rows, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale),
        static_cast<T*>(y), D, stride, eps);
  else
    rmsnorm_kernel<T, S, kPer, false><<<rows, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale),
        static_cast<T*>(y), D, stride, eps);
  return cudaGetLastError();
}

// slots per thread and threads per CTA from D and the type alone
template <typename T, typename S>
cudaError_t dispatch(bool vec, const void* x, const void* scale, void* y,
                     int rows, int D, long long stride, float eps,
                     cudaStream_t s) {
  constexpr int W = 16 / (int)sizeof(T);
  if (vec && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(
                   scale) | reinterpret_cast<uintptr_t>(y)) % 16 != 0 ||
              D % W != 0 || stride % W != 0))
    return cudaErrorMisalignedAddress;
  const int n = (D + W - 1) / W;
  int per = 1;
  while (per <= 8 && (n + per - 1) / per > kMaxThreads) per *= 2;
  const int threads =
      per > 8 ? kMaxThreads : ((n + per - 1) / per + 31) / 32 * 32;
  switch (per) {
    case 1: return launch<T, S, 1>(vec, x, scale, y, rows, D, stride, threads,
                                   eps, s);
    case 2: return launch<T, S, 2>(vec, x, scale, y, rows, D, stride, threads,
                                   eps, s);
    case 4: return launch<T, S, 4>(vec, x, scale, y, rows, D, stride, threads,
                                   eps, s);
    case 8: return launch<T, S, 8>(vec, x, scale, y, rows, D, stride, threads,
                                   eps, s);
    default: return launch<T, S, 0>(vec, x, scale, y, rows, D, stride,
                                    threads, eps, s);
  }
}

}  // namespace

// x: rows of D values, row r at x + r * stride elements; y: (rows, D).
// flags: bit 0 (vec) says that every pointer, D and the stride are whole
// 16-byte slots (the wrapper checks; a false claim returns
// cudaErrorMisalignedAddress); bit 1 x is bfloat16 (else float32); bit 2
// the scale is bfloat16 (else float32; bfloat16 only with a bfloat16 x).
// One int for the three keeps the host's per-call argument conversions
// few. Launches on `device`, made current for the launch when it is not.
// Returns cudaGetLastError() after the launch.
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y,
                             int rows, int D, int stride, int flags,
                             float eps, int device, void* stream) {
  if (rows <= 0 || D <= 0 || stride < 0 || (flags & ~7) != 0)
    return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = flags & 1;
  switch (flags >> 1) {
    case 0:
      err = dispatch<float, float>(vec, x, scale, y, rows, D, stride, eps, s);
      break;
    case 1:
      err = dispatch<__nv_bfloat16, float>(vec, x, scale, y, rows, D, stride,
                                           eps, s);
      break;
    case 3:
      err = dispatch<__nv_bfloat16, __nv_bfloat16>(vec, x, scale, y, rows, D,
                                                   stride, eps, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (current != device) cudaSetDevice(current);
  return (int)err;
}
