// Flash-attention backward for Hopper (sm_90a), f32 on the CUDA cores: dQ,
// and fused dK/dV. bf16 inputs take the tensor-core kernels of
// flash_bwd_sm90.cu instead.
//
// Replaces the two Pallas TPU kernels of `_flash_backward`
// (dynolog_tpu/ops/flash_attention.py:235-290):
//   flash_dq_kernel  <- `_dq_kernel`  (:143-181): per query tile, recompute
//     P = exp(Q K^T * scale - lse) over the key tiles up to the diagonal,
//     dP = dO V^T, dS = P * (dP - delta), dQ = scale * dS K;
//   flash_dkv_kernel <- `_dkv_kernel` (:184-232): per key tile, over the
//     query tiles from its diagonal down, dV += P^T dO and
//     dK += dS^T (Q * scale).
// delta = rowsum(dO * O) is computed by the wrapper ([B * H, S] f32), as
// the reference computes it in jnp outside its kernels.
//
// What bounds them on the H100: three (dQ) and four (dK/dV) S x S x D
// products per head against O(S * D) bytes, so both are bound by
// operations. These kernels compute in f32 on the CUDA cores, as the
// Pallas kernels do after casting their blocks to f32, at the 67 TFLOP/s
// f32 rate; a tensor-core f32 path would be TF32 and change what f32
// means. What the design does about the bound: probabilities are
// recomputed from lse, so no [S, S] matrix
// reaches device memory; the two S x S x D products that share operands
// (Q K^T and dO V^T) run in one pass over D; each thread keeps 4 x 4 score
// micro-tiles and its dQ (or dK and dV) rows in registers; fully masked
// tiles are skipped; and on Hopper's parallel grid the sequential
// accumulation over tiles that the TPU grid carried becomes a loop inside
// one block, so no atomics are needed.
#include "flash_common.cuh"

namespace flash {

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int S, int causal) {
  constexpr int LD = D + 1;
  constexpr int LP = kTile + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;  // Q * scale
  float* sDO = sQ + tile_words<D>();
  float* sK = sDO + tile_words<D>();
  float* sV = sK + tile_words<D>();
  float* sDS = sV + tile_words<D>();  // [kTile, kTile + 1]

  const int n_tiles = (S + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;  // heaviest tiles first
  const int bh = blockIdx.y;
  const size_t base = head_base(bh, S, H, D);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int q0 = qt * kTile;
  const float scale = rsqrtf((float)D);

  load_tile<D>(sQ, q + base, q0, S, H, scale);
  load_tile<D>(sDO, dout + base, q0, S, H, 1.f);
  float row_lse[kRows], row_delta[kRows], acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    row_lse[i] = row < S ? lse[(size_t)bh * S + row] : 0.f;
    row_delta[i] = row < S ? delta[(size_t)bh * S + row] : 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  const int n_kt = causal ? min(n_tiles, qt + 1) : n_tiles;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<D>(sK, k + base, kt * kTile, S, H, 1.f);
    load_tile<D>(sV, v + base, kt * kTile, S, H, 1.f);
    __syncthreads();

    float s[kRows][4], dp[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[kRows], g[kRows], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        a[i] = sQ[(ty + 16 * i) * LD + d];
        g[i] = sDO[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = sK[(tx + 16 * j) * LD + d];
        bv[j] = sV[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(g[i], bv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kt * kTile + tx + 16 * j;
        const bool masked = kp >= S || (causal && kp > qp);
        const float p = masked ? 0.f : expf(s[i][j] - row_lse[i]);
        sDS[(ty + 16 * i) * LP + tx + 16 * j] = p * (dp[i][j] - row_delta[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float ds[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) ds[i] = sDS[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float kv = sK[kk * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(ds[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    T* out = dq + base + (size_t)row * H * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) out[tx + 16 * j] = from_float<T>(acc[i][j] * scale);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int S, int causal) {
  constexpr int LD = D + 1;
  constexpr int LP = kTile + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + tile_words<D>();
  float* sQ = sV + tile_words<D>();  // Q * scale
  float* sDO = sQ + tile_words<D>();
  float* sPt = sDO + tile_words<D>();  // P^T  [kTile, kTile + 1]
  float* sDSt = sPt + kTile * LP;      // dS^T [kTile, kTile + 1]
  float* sLse = sDSt + kTile * LP;     // [kTile]
  float* sDelta = sLse + kTile;        // [kTile]

  const int n_tiles = (S + kTile - 1) / kTile;
  const int kt = blockIdx.x;  // under causal masking, low tiles are heaviest
  const int bh = blockIdx.y;
  const size_t base = head_base(bh, S, H, D);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int k0 = kt * kTile;
  const float scale = rsqrtf((float)D);

  load_tile<D>(sK, k + base, k0, S, H, 1.f);
  load_tile<D>(sV, v + base, k0, S, H, 1.f);
  float acc_k[kRows][DC], acc_v[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // The first query tile whose rows can see this key tile.
  const int qt_start = causal ? kt : 0;
  for (int qt = qt_start; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<D>(sQ, q + base, q0, S, H, scale);
    load_tile<D>(sDO, dout + base, q0, S, H, 1.f);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      sLse[threadIdx.x] = row < S ? lse[(size_t)bh * S + row] : 0.f;
      sDelta[threadIdx.x] = row < S ? delta[(size_t)bh * S + row] : 0.f;
    }
    __syncthreads();

    // Transposed tiles: rows are keys (ty + 16 i), columns queries
    // (tx + 16 j).
    float st[kRows][4], dpt[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float ak[kRows], av[kRows], bq[4], bg[4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        ak[i] = sK[(ty + 16 * i) * LD + d];
        av[i] = sV[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bq[j] = sQ[(tx + 16 * j) * LD + d];
        bg[j] = sDO[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(ak[i], bq[j], st[i][j]);
          dpt[i][j] = fmaf(av[i], bg[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int kp = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int qp = q0 + c;
        const bool masked = qp >= S || (causal && qp < kp);
        const float p = masked ? 0.f : expf(st[i][j] - sLse[c]);
        sPt[(ty + 16 * i) * LP + c] = p;
        sDSt[(ty + 16 * i) * LP + c] = p * (dpt[i][j] - sDelta[c]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
      float p[kRows], ds[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        p[i] = sPt[(ty + 16 * i) * LP + qq];
        ds[i] = sDSt[(ty + 16 * i) * LP + qq];
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float g = sDO[qq * LD + tx + 16 * j];
        const float qs = sQ[qq * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc_v[i][j] = fmaf(p[i], g, acc_v[i][j]);
          acc_k[i][j] = fmaf(ds[i], qs, acc_k[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= S) continue;
    T* out_k = dk + base + (size_t)row * H * D;
    T* out_v = dv + base + (size_t)row * H * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      out_k[tx + 16 * j] = from_float<T>(acc_k[i][j]);
      out_v[tx + 16 * j] = from_float<T>(acc_v[i][j]);
    }
  }
}

template <int D, typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int H, int S, int causal,
                      cudaStream_t stream) {
  const size_t smem =
      (4 * tile_words<D>() + kTile * (kTile + 1)) * sizeof(float);
  static cudaError_t setup = allow_smem(flash_dq_kernel<D, T>, smem);
  if (setup != cudaSuccess) return setup;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  flash_dq_kernel<D, T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, H, S, causal);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int S, int causal,
                       cudaStream_t stream) {
  const size_t smem =
      (4 * tile_words<D>() + 2 * kTile * (kTile + 1) + 2 * kTile) *
      sizeof(float);
  static cudaError_t setup = allow_smem(flash_dkv_kernel<D, T>, smem);
  if (setup != cudaSuccess) return setup;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  flash_dkv_kernel<D, T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, H, S, causal);
  return cudaGetLastError();
}

#define FLASH_DISPATCH_D(D_, CALL) \
  switch (D_) {                    \
    case 16: return CALL(16);      \
    case 32: return CALL(32);      \
    case 64: return CALL(64);      \
    case 128: return CALL(128);    \
    default: return cudaErrorInvalidValue; \
  }

template <typename T>
cudaError_t dispatch_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int B, int H, int S, int D, int causal,
                        cudaStream_t st) {
#define CALL(DD) \
  launch_dq<DD, T>(q, k, v, dout, lse, delta, dq, B, H, S, causal, st)
  FLASH_DISPATCH_D(D, CALL)
#undef CALL
}

template <typename T>
cudaError_t dispatch_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, int B, int H, int S, int D,
                         int causal, cudaStream_t st) {
#define CALL(DD) \
  launch_dkv<DD, T>(q, k, v, dout, lse, delta, dk, dv, B, H, S, causal, st)
  FLASH_DISPATCH_D(D, CALL)
#undef CALL
}

}  // namespace flash

// q, k, v, dout, dq: [B, S, H, D] contiguous, dtype 0 = f32 (bf16 is
// flash_bwd_sm90.cu's); lse, delta: [B * H, S] f32. Returns the launch's
// cudaError_t.
extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int B, int H, int S, int D, int causal,
                        int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == flash::kF32)
    return flash::dispatch_dq<float>(q, k, v, dout, lse, delta, dq, B, H, S,
                                     D, causal, st);
  return cudaErrorInvalidValue;
}

// As flash_dq; dk and dv: [B, S, H, D] contiguous.
extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, int B, int H, int S, int D,
                         int causal, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == flash::kF32)
    return flash::dispatch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                      S, D, causal, st);
  return cudaErrorInvalidValue;
}
