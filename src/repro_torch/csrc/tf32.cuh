// Split TF32: float32 products on Hopper's tensor cores at float32 accuracy,
// shared by the float32 flash prefill kernel (flash_attn.cu) and the
// float32 SSD chunk scan (ssd_chunk.cu), sm_90a only.
//
// The tensor cores take TF32 (10 mantissa bits), so each float32 operand x
// is split into hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi) (the
// rounding done with integer operations: the conversion instruction is
// emulated in several), and each product is lo*hi + hi*lo + hi*hi,
// accumulated in float32 by wgmma m64nNk8 TF32: three tensor-core products
// per product, as CUTLASS's FastF32 does; the lo*lo term and the residual
// below lo are about 2^-22 of the product. No allow_tf32 setting is read.
//
// Also here: the K-major shared-memory plane that TF32 wgmma reads, the
// 16-byte cp.async, a named barrier, and the synchronization check's jitter
// hook.
#pragma once

#include <stdint.h>

#include "wgmma.cuh"

namespace repro {

// cvt.rna.tf32.f32's rounding (to nearest on the low 13 mantissa bits,
// ties away from zero) for finite x, on the integer pipe
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo (+ a residual of about 2^-22 x), both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
__device__ __forceinline__ void split4(const float (&x)[4], uint4& hi,
                                       uint4& lo) {
  split(x[0], hi.x, lo.x);
  split(x[1], hi.y, lo.y);
  split(x[2], hi.z, lo.z);
  split(x[3], hi.w, lo.w);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// A TF32 plane of R rows x C columns as wgmma reads it K-major (C along
// K) with the 128-byte swizzle: atoms of 32 columns, each R rows of 128
// bytes, whose 16-byte chunk c of row r sits at chunk c ^ (r % 8).
template <int R, int C>
struct Plane {
  static constexpr int kAtomBytes = R * 128;
  static constexpr int kBytes = C / 32 * kAtomBytes;
  // byte offset of the 4-column chunk (r, c4)
  static __device__ __forceinline__ uint32_t chunk(int r, int c4) {
    return (c4 >> 3) * kAtomBytes + r * 128 + (((c4 & 7) ^ (r & 7)) << 4);
  }
  // descriptor of k slice kk (columns 8 kk ... 8 kk + 7)
  static __device__ __forceinline__ uint64_t desc(uint32_t base, int kk) {
    return wgmma_desc(base + (kk >> 2) * kAtomBytes + (kk & 3) * 32, 16,
                      1024, 1);
  }
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// arrive on named barrier `id` (of `threads`) without waiting for it
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The synchronization check's builds (-DREPRO_SYNC_JITTER, made only by
// tools/check_f32_sync.py) make each warp sleep a pseudo-random 0-4 us at
// every point where a ring stage or a staging tile passes from one role to
// the other. An access that a missing wait left unordered then lands at
// another time in every launch, and a repeated-launch stress sees the
// output change. The normal build compiles it to nothing.
__device__ __forceinline__ void jitter(uint32_t site) {
#ifdef REPRO_SYNC_JITTER
  uint32_t x = (uint32_t)clock() ^ (site << 24) ^
               ((threadIdx.x >> 5) * 0x9e3779b9u) ^
               ((blockIdx.x + 131u * blockIdx.y + 8191u * blockIdx.z) *
                0x85ebca6bu);
  x ^= x >> 15;
  x *= 0x2c1b3c6du;
  x ^= x >> 12;
  x = __shfl_sync(0xffffffffu, x, 0);   // one sleep per warp
  __nanosleep(x & 4095u);
  __syncwarp();
#else
  (void)site;
#endif
}

}  // namespace repro
