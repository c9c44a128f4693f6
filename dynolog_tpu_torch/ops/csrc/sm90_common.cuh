// Hopper (sm_90a) building blocks of the tensor-core flash kernels
// (flash_fwd_sm90.cu, flash_bwd_sm90.cu), as inline PTX:
//
// - mbarriers: init, arrive with an expected transaction count, wait on a
//   phase parity;
// - TMA: a 4-D tile copied from device memory into shared memory by one
//   thread, described by a CUtensorMap passed as a __grid_constant__
//   kernel parameter, completing on an mbarrier;
// - wgmma: shared-memory matrix descriptors, and
//   wgmma.mma_async.m64nNk16.f32.bf16.bf16 with A from shared memory or
//   from registers, plus its fence, commit and wait;
// - tiles: a [64, D] bf16 tile as the TMA lays it out in shared memory,
//   with its wgmma descriptors, and the store of an accumulator's rows;
// - on the host, tensor maps over a [B, S, H, D] bf16 tensor, encoded by
//   cuTensorMapEncodeTiled reached through cudaGetDriverEntryPoint, so the
//   library links no -lcuda (cuda.h is included for its types only).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int kTile = 64;       // query rows and key rows per tile
constexpr int kThreads = 128;   // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;
// Added to the CUresult of a tensor map cuTensorMapEncodeTiled refuses, so
// the caller tells it from a cudaError_t.
constexpr int kEncodeError = 10000;
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA);
// a __syncthreads() after it makes it visible to the other threads.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrives once and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase with parity `parity` has completed. A phase that
// never completes (a copy that was never issued, a wrong byte count) traps
// after about ten seconds, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - start > 20000000000LL) __trap();
  } while (!done);
}

// ------------------------------------------------------------------- TMA

// Copies the box of `map` at coordinates (c0, c1, c2, c3), innermost first,
// into shared memory at `dst`; the bytes count against `bar`'s phase.
// Coordinates past the tensor's edge read as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ----------------------------------------------------------------- wgmma

// The descriptor's layout type for rows of `row_bytes` swizzled at that
// width (TMA's CU_TENSOR_MAP_SWIZZLE_128B, _64B, _32B).
__host__ __device__ constexpr int swizzle_layout(int row_bytes) {
  return row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), layout type. Tiles sit on 1024-byte boundaries,
// so the swizzle's base offset is 0.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  uint64_t d = (smem_addr(p) & 0x3FFFF) >> 4;
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)layout << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Orders the compiler's uses of accumulator registers after a wgmma_wait
// (the wgmma writes them asynchronously).
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A bf16 pair in one b32, `lo` in the low half (round to nearest even).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator layout of m64nNk16 (f32, N/2 registers a thread): register i
// of thread t holds row 16 (t / 32) + (t % 32) / 4 + 8 ((i % 4) / 2) and
// column 8 (i / 4) + 2 (t % 4) + i % 2.
__device__ __forceinline__ int acc_row(int i) {
  return 16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4 + 8 * ((i % 4) / 2);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i / 4) + 2 * (threadIdx.x % 4) + i % 2;
}

// The m64n64 f32 accumulator `acc` as the register A operands of the four
// k-steps of a product over its 64 columns, each value x carried as a pair
// of bf16, hi = bf16(x) and lo = bf16(x - hi) (round to nearest even), so
// that hi + lo keeps 16 significant bits of x: a product takes `hi` and
// then `lo`. The A fragment of k-step kk holds the accumulator's columns
// [16 kk, 16 kk + 16) of the same rows, so no value leaves its thread.
__device__ __forceinline__ void wgmma_a_fragments(const float (&acc)[32],
                                                  uint32_t (&hi)[4][4],
                                                  uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = acc[8 * kk + 2 * r];
      const float x1 = acc[8 * kk + 2 * r + 1];
      __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
      hi[kk][r] = *reinterpret_cast<uint32_t*>(&h);
      lo[kk][r] = *reinterpret_cast<uint32_t*>(&l);
    }
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16. kTransB = 0 takes B
// K-major (its N rows hold K contiguous values), 1 takes it MN-major.
// `accumulate` = 0 overwrites D.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // D[64 x 16] (+)= A[64 x 16] B[16 x 16], A from registers (four b32 of
  // packed bf16 pairs, as wgmma_a_fragments lays them out), B from shared
  // memory.
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate), "n"(kTransB));
  }
};

template <>
struct Wgmma<32> {
  // D[64 x 32] (+)= A[64 x 16] B[16 x 32], A from registers (four b32 of
  // packed bf16 pairs, as wgmma_a_fragments lays them out), B from shared
  // memory.
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate), "n"(kTransB));
  }
};

template <>
struct Wgmma<64> {
  // D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory.
  template <int kTransB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t desc_a,
                                            uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransB));
  }
  // D[64 x 64] (+)= A[64 x 16] B[16 x 64], A from registers (four b32 of
  // packed bf16 pairs, as wgmma_a_fragments lays them out), B from shared
  // memory.
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate), "n"(kTransB));
  }
};

template <>
struct Wgmma<128> {
  // D[64 x 128] (+)= A[64 x 16] B[16 x 128], A from registers (four b32 of
  // packed bf16 pairs, as wgmma_a_fragments lays them out), B from shared
  // memory.
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate), "n"(kTransB));
  }
};

// ----------------------------------------------------------------- tiles

// One [64, D] bf16 tile in shared memory as the TMA lays it out: D / W
// boxes of 64 rows x W = min(D, 64) columns, rows W * 2 bytes long and
// swizzled at that width, boxes one after the other.
template <int D>
struct Tile {
  static constexpr int W = D < 64 ? D : 64;
  static constexpr int kRowBytes = W * 2;
  static constexpr int kBoxBytes = kTile * kRowBytes;
  static constexpr int kBoxes = D / W;
  static constexpr int kBytes = kBoxes * kBoxBytes;
  static constexpr int kLayout = swizzle_layout(kRowBytes);
  static constexpr int kSteps = D / 16;  // k-steps of a product over D

  // The tile as a K-major operand over columns [16 kk, 16 kk + 16): its 64
  // rows are M (or N), the 16 columns K. Rows are kRowBytes apart, groups
  // of 8 rows 8 kRowBytes apart; the k-step moves the start within a row.
  static __device__ __forceinline__ uint64_t kmajor(const char* tile,
                                                    int kk) {
    const int col = 16 * kk;
    return make_desc(tile + (col / W) * kBoxBytes + (col % W) * 2, 16,
                     8 * kRowBytes, kLayout);
  }
  // The tile as an MN-major B operand over rows [16 kk, 16 kk + 16): the
  // rows are K, all D columns N. W columns lie contiguous in a row, the
  // next W columns one box (LBO) further; groups of 8 rows are 8 kRowBytes
  // (SBO) apart.
  static __device__ __forceinline__ uint64_t mnmajor(const char* tile,
                                                     int kk) {
    return make_desc(tile + 16 * kk * kRowBytes, kBoxBytes, 8 * kRowBytes,
                     kLayout);
  }
  // Issues the TMA copy of rows [row0, row0 + 64) of head (b, h).
  static __device__ __forceinline__ void load(char* tile,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int row0, int h,
                                              int b) {
#pragma unroll
    for (int i = 0; i < kBoxes; ++i)
      tma_load_4d(tile + i * kBoxBytes, map, bar, i * W, h, row0, b);
  }
};

// The first 1024-byte boundary at or after `p` (the 128-byte swizzle's
// period), where the tiles start.
__device__ __forceinline__ char* align_1024(char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// Stores rows [row0, row0 + 64) of an m64nD f32 accumulator, times `mul`,
// into the [B, S, H, D] bf16 tensor `out` at head (b, h); rows at or past
// S are not written.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           bf16* out, int b, int h, int H,
                                           int S, int row0, float mul) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = row0 + acc_row(i);
    if (row < S) {
      const size_t off = (((size_t)b * S + row) * H + h) * D + acc_col(i);
      *reinterpret_cast<uint32_t*>(out + off) =
          pack_bf16(acc[i] * mul, acc[i + 1] * mul);
    }
  }
}

// ------------------------------------------------------------ host side

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA library the runtime loaded, or
// nullptr.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// Tensor map over a [B, S, H, D] bf16 tensor, dimensions (D, H, S, B)
// innermost first and read by stride, with a box of `rows` rows of one
// head and min(D, 64) columns, swizzled at the box's row width (128, 64 or
// 32 bytes). Returns cuTensorMapEncodeTiled's CUresult
// (CUDA_ERROR_NOT_FOUND if the entry point is missing).
inline CUresult encode_bshd(CUtensorMap* map, const void* base, int B, int S,
                            int H, int D, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint32_t w = D < 64 ? D : 64;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {w, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      w * 2 == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : w * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Encodes one tensor map of 64-row boxes per [B, S, H, D] tensor of
// `ptrs`; 0, or kEncodeError + the CUresult of the first one refused.
template <int N>
inline int encode_maps(CUtensorMap (&maps)[N], const void* const (&ptrs)[N],
                       int B, int H, int S, int D) {
  for (int i = 0; i < N; ++i) {
    const CUresult r = encode_bshd(&maps[i], ptrs[i], B, S, H, D, kTile);
    if (r != CUDA_SUCCESS) return kEncodeError + (int)r;
  }
  return 0;
}

}  // namespace sm90

// Returns CALL(D) for a head dimension the kernels are built for.
#define SM90_DISPATCH_D(D_, CALL)          \
  switch (D_) {                            \
    case 16: return CALL(16);              \
    case 32: return CALL(32);              \
    case 64: return CALL(64);              \
    case 128: return CALL(128);            \
    default: return cudaErrorInvalidValue; \
  }
