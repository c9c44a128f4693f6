// Shared pieces of the Hopper flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): tile geometry, dtype conversion and the tile loader. The
// tensor-core kernels (flash_fwd_sm90.cu, flash_bwd_sm90.cu) take only the
// dtype codes, the mask value and allow_smem from here.
//
// Layout: q, k, v, o and their gradients are [B, S, H, D] with the last
// dimension contiguous, read by stride, so the wrapper needs no
// [B, S, H, D] <-> [B*H, S, D] copies. lse and delta are [B*H, S] f32.
//
// Every block works on one head (blockIdx.y = b * H + h) and one 64-row
// tile (blockIdx.x). Its 256 threads form a 16 x 16 grid: thread
// (ty, tx) owns rows ty + 16 * i (i < 4) and columns tx + 16 * j of every
// tile product, so the 16 threads that share a row sit in one half-warp
// and reduce a row with four xor-shuffles. Tiles live in shared memory as
// f32 with a row stride of D + 1 words, which keeps the column walks of
// the products free of bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kTile = 64;      // query rows and key rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kRows = 4;       // rows of a 64-row tile owned by one thread
constexpr float kNegInf = -1e30f;  // the mask value of the Pallas kernels

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// Shared-memory words of one [kTile, D] tile.
template <int D>
__host__ __device__ constexpr int tile_words() {
  return kTile * (D + 1);
}

// Copies rows [row0, row0 + kTile) of one head into `dst` as f32 times
// `scale`; rows at or past S read as 0 (the ragged edge). `src` points at
// element [b, 0, h, 0]; consecutive threads read consecutive d.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int S, int H, float scale) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    const int row = row0 + r;
    float x = 0.f;
    if (row < S) x = to_float(src[(size_t)row * H * D + c]) * scale;
    dst[r * (D + 1) + c] = x;
  }
}

// Sum or max over the 16 threads of a half-warp that share a row.
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Offset of element [b, 0, h, 0] of a [B, S, H, D] tensor.
__device__ __forceinline__ size_t head_base(int bh, int S, int H, int D) {
  const int b = bh / H;
  const int h = bh % H;
  return ((size_t)b * S * H + h) * D;
}

// Raises the dynamic shared-memory cap of `kernel` once per instantiation
// (above 48 KB a block must opt in).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace flash
