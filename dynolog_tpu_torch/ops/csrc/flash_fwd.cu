// Flash-attention forward for Hopper (sm_90a), f32 on the CUDA cores. bf16
// inputs take the tensor-core kernel of flash_fwd_sm90.cu instead.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (dynolog_tpu/ops/flash_attention.py:62-110, launched by `_flash_forward`
// at :113-140): O = softmax(Q K^T * rsqrt(D), causal) V by the online-softmax
// recurrence, plus the per-row lse = m + log(l) (l == 0 guarded to 1) that
// the backward kernels recompute probabilities from.
//
// What bounds it on the H100: the work is 2 * S^2 * D * B * H / 2 FLOP
// (causal) against O(S * D) bytes, so it is bound by operations, not by
// memory. This kernel computes in f32 on the CUDA cores, exactly as the
// Pallas kernel casts its blocks to f32 before each dot, at the 67 TFLOP/s
// f32 rate; a tensor-core f32 path would be TF32 and change what f32
// means. What the design does about the bound: the [S, S] score matrix is
// never written to device memory (each block keeps a 64 x 64 tile in
// shared memory), each K/V tile is read from device memory once per query
// tile, 4 x 4 register micro-tiles give four FMAs per shared-memory load,
// tiles past the causal diagonal are skipped, and the heaviest query tiles
// (last ones, under causal masking) are scheduled first.
#include "flash_common.cuh"

namespace flash {

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int H, int S, int causal) {
  constexpr int LD = D + 1;
  constexpr int LP = kTile + 1;
  constexpr int DC = D / 16;  // output columns owned by one thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + tile_words<D>();
  float* sV = sK + tile_words<D>();
  float* sP = sV + tile_words<D>();  // [kTile, kTile + 1]

  const int n_tiles = (S + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;  // heaviest tiles first
  const int bh = blockIdx.y;
  const size_t base = head_base(bh, S, H, D);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int q0 = qt * kTile;
  const float scale = rsqrtf((float)D);

  load_tile<D>(sQ, q + base, q0, S, H, scale);

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  // Key tiles past this query tile's diagonal are fully masked.
  const int n_kt = causal ? min(n_tiles, qt + 1) : n_tiles;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // the previous tile's sK, sV and sP are consumed
    load_tile<D>(sK, k + base, kt * kTile, S, H, 1.f);
    load_tile<D>(sV, v + base, kt * kTile, S, H, 1.f);
    __syncthreads();

    float s[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[kRows], b[4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kt * kTile + tx + 16 * j;
        if (kp >= S || (causal && kp > qp)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty + 16 * i) * LP + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = sP[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float vv = sV[kk * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* out = o + base + (size_t)row * H * D;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      out[tx + 16 * j] = from_float<T>(acc[i][j] / l_safe);
    if (tx == 0) lse[(size_t)bh * S + row] = m[i] + logf(l_safe);
  }
}

template <int D, typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int S, int causal,
                       cudaStream_t stream) {
  const size_t smem =
      (3 * tile_words<D>() + kTile * (kTile + 1)) * sizeof(float);
  static cudaError_t setup = allow_smem(flash_fwd_kernel<D, T>, smem);
  if (setup != cudaSuccess) return setup;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  flash_fwd_kernel<D, T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, H, S,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int H, int S, int D, int causal,
                         cudaStream_t stream) {
  switch (D) {
    case 16: return launch_fwd<16, T>(q, k, v, o, lse, B, H, S, causal, stream);
    case 32: return launch_fwd<32, T>(q, k, v, o, lse, B, H, S, causal, stream);
    case 64: return launch_fwd<64, T>(q, k, v, o, lse, B, H, S, causal, stream);
    case 128: return launch_fwd<128, T>(q, k, v, o, lse, B, H, S, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace flash

// q, k, v, o: [B, S, H, D] contiguous, dtype 0 = f32 (bf16 is
// flash_fwd_sm90.cu's); lse: [B * H, S] f32. Returns the launch's
// cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int H, int S, int D, int causal,
                         int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == flash::kF32)
    return flash::dispatch_fwd<float>(q, k, v, o, lse, B, H, S, D, causal, st);
  return cudaErrorInvalidValue;
}
