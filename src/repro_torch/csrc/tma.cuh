// Hopper TMA (cp.async.bulk.tensor), mbarrier and shared-memory tile helpers
// shared by the tensor-core kernels (sm_90a only).
//
// A Tile<D> is a 64 x D bf16 tile as TMA writes it into shared memory: one
// atom of 64 rows x kAtomCols columns, or D / 64 of them above D = 64 (two
// at D = 128, four at D = 256), each row kRowBytes long and swizzled
// (128-byte swizzle for 64-column atoms, 64-byte for D = 32). The same
// swizzle goes into the tensor map and into the wgmma descriptors.
//
// The tensor-map encoder cuTensorMapEncodeTiled is a driver symbol; it is
// looked up once through cudaGetDriverEntryPoint(ByVersion), so a library
// that uses it links against the CUDA runtime only.
#pragma once

#include <stdint.h>

#include <cuda.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace repro {

constexpr int kTileRows = 64;

template <int D>
struct Tile {
  static constexpr int kAtoms = D > 64 ? D / 64 : 1;
  static constexpr int kAtomCols = D > 64 ? 64 : D;
  static constexpr int kRowBytes = kAtomCols * 2;            // 128 or 64
  static constexpr int kLayout = kRowBytes == 128 ? 1 : 2;   // B128 / B64
  static constexpr int kAtomBytes = kTileRows * kRowBytes;
  static constexpr int kBytes = kAtoms * kAtomBytes;
  static constexpr int kGroupBytes = 8 * kRowBytes;          // 8-row group
  // K-major operand (rows along M or N, D along K) for k slice kk (16
  // columns of D)
  static __device__ __forceinline__ uint64_t kmajor(uint32_t base, int kk) {
    const int col = kk * 16;
    const uint32_t addr = base + (col / kAtomCols) * kAtomBytes +
                          (col % kAtomCols) * 2;
    return wgmma_desc(addr, 16, kGroupBytes, kLayout);
  }
  // MN-major B operand (rows along K, D along N) for k slice kk (16 rows)
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t base, int kk) {
    return wgmma_desc(base + kk * 16 * kRowBytes, kAtomBytes, kGroupBytes,
                      kLayout);
  }
  // byte offset of element (row r, column c): the 16-byte unit c / 8 of
  // its atom's row, xor'ed with r % 8 (128-byte swizzle) or r / 2 % 4
  // (64-byte); a tile one atom wide may hold more than 64 rows, row after
  // row
  static __device__ __forceinline__ uint32_t elem(int r, int c) {
    const int cc = c % kAtomCols;
    const int sw = kRowBytes == 128 ? (r & 7) : ((r >> 1) & 3);
    return (c / kAtomCols) * kAtomBytes + r * kRowBytes +
           (((cc >> 3) ^ sw) << 4) + (cc & 7) * 2;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// A wait that outlasts ~10 s of clock traps: a lost arrival becomes a
// launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    if (clock64() - t0 > (1ll << 34)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}
// the 64 x D tile at (column col, row row, batch row b), all its atoms
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int b) {
  using L = Tile<D>;
#pragma unroll
  for (int a = 0; a < L::kAtoms; ++a)
    tma_load(dst + a * L::kAtomBytes, map, bar, col + a * L::kAtomCols, row,
             b);
}
// the same through a 4-D map of (width, heads, rows, B) (see
// head_tensor_map): the 64 x D tile of head `head` at row `row`
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}
template <int D>
__device__ __forceinline__ void tma_head_tile(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int head, int row,
                                              int b) {
  using L = Tile<D>;
#pragma unroll
  for (int a = 0; a < L::kAtoms; ++a)
    tma_load4(dst + a * L::kAtomBytes, map, bar, a * L::kAtomCols, head, row,
              b);
}
// the reverse: the 64 x D tile at `src` in shared memory (laid out as
// tma_head_tile leaves it) stored to head `head`, rows `row` ..., batch row
// b through a 4-D map; rows and columns past the map's bounds are not
// written. One thread issues it; bulk_commit and bulk_wait_read follow.
__device__ __forceinline__ void tma_store4(const CUtensorMap* map,
                                           uint32_t src, int c0, int c1,
                                           int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
template <int D>
__device__ __forceinline__ void tma_store_head_tile(const CUtensorMap* map,
                                                    uint32_t src, int head,
                                                    int row, int b) {
  using L = Tile<D>;
#pragma unroll
  for (int a = 0; a < L::kAtoms; ++a)
    tma_store4(map, src + a * L::kAtomBytes, a * L::kAtomCols, head, row, b);
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until the committed bulk stores have read their shared memory (the
// writes to global memory go on after it)
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, rows, heads * D) bf16 tensor seen through boxes of (1, 64,
// kAtomCols); rows past `rows` of a batch row read as zeros.
template <int D>
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int rows,
                int heads) {
  using L = Tile<D>;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)heads * D, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)heads * D * 2,
                                 (cuuint64_t)rows * heads * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)L::kAtomCols, (cuuint32_t)kTileRows,
                             1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      L::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

// A (B, rows, heads, width) bf16 tensor, width <= D, seen through boxes
// of (kAtomCols, 1, 64, 1) over (width, heads, rows, B): columns past
// `width` of each head and rows past `rows` read as zeros, so a head
// narrower than the tile (MLA's 96 q/k and 64 v columns in a 128-column
// tile) loads with zero columns and never reads its neighbour's. The
// tile lands in shared memory as tensor_map's does.
template <int D>
bool head_tensor_map(CUtensorMap* map, const void* ptr, int B, int rows,
                     int heads, int width) {
  using L = Tile<D>;
  EncodeTiled encode = encoder();
  if (encode == nullptr || width > D) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)width * 2,
                                 (cuuint64_t)heads * width * 2,
                                 (cuuint64_t)rows * heads * width * 2};
  const cuuint32_t box[4] = {(cuuint32_t)L::kAtomCols, 1,
                             (cuuint32_t)kTileRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      L::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

}  // namespace repro
