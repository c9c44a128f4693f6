// Flash-attention backward for Hopper's tensor cores (sm_90a), bf16: dQ,
// and fused dK/dV.
//
// Replaces, for bf16 inputs, the two Pallas TPU kernels of `_flash_backward`
// (dynolog_tpu/ops/flash_attention.py:235-290):
//   flash_dq_kernel  <- `_dq_kernel`  (:143-181): per 64-query tile, over
//     the key tiles up to the diagonal, S = Q K^T, dP = dO V^T,
//     P = exp(scale S - lse), dS = P (dP - delta), dQ += dS K; dQ * scale;
//   flash_dkv_kernel <- `_dkv_kernel` (:184-232): per 64-key tile, over the
//     query tiles from its diagonal down, S^T = K Q^T, P^T as above,
//     dV += P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T - delta),
//     dK += dS^T Q; dK * scale.
// f32 inputs keep the CUDA-core kernels of flash_bwd.cu.
//
// What bounds them on the H100: three (dQ) and four (dK/dV) S x S x D
// products per head against O(S D) bytes, so both are bound by operations,
// at the 989 TFLOP/s bf16 tensor-core rate. What the design does about it:
// - every product is a wgmma (m64nNk16, f32 accumulators), one warpgroup
//   per block; the score-shaped products (S, dP) read both operands from
//   shared memory and run in flight together, and the products that take
//   P or dS (dV, dK, dQ) take them as the A operand from registers: the
//   f32 accumulator fragment of P or dS repacks into bf16 A fragments in
//   place, so neither touches shared memory;
// - tiles arrive by TMA into swizzled bf16 shared memory, straight from the
//   [B, S, H, D] tensors (4-D tensor maps, no transposes); the tile that
//   stays (K, V for dK/dV; Q, dO for dQ) is loaded once, the tiles that
//   stream come through a 2-stage ring on mbarriers, and tile i+1's copy
//   is issued before tile i's products;
// - the products that need an operand transposed (dO and Q in dV, dK; K in
//   dQ) read the same tiles as MN-major B operands;
// - `scale` is applied to the f32 accumulators (to S before the exp, to dK
//   and dQ at the end), never to a bf16 operand: 1/sqrt(128) is not exact
//   in bf16;
// - the ragged S edge reads zeros from the TMA and is masked; fully masked
//   tiles are skipped; blocks run heaviest tiles first.
// Numerics: the tensor cores take bf16 operands, so P and dS, formed in
// f32, enter the products that take them as a pair of bf16 each,
// hi = bf16(x) and lo = bf16(x - hi), one wgmma per half (16 significant
// bits; this costs a third more tensor work in dQ and half more in dK/dV).
// Rounding them once to bf16, as flash backward kernels commonly do,
// moves an element of dQ, dK or dV by a bf16 ulp of a large P or dS term
// whenever the f32 value lands on the other side of a rounding boundary
// from the plain version's, which summed its f32 values in another order:
// more than one bf16 ulp of a small output element. With the pair, every
// output stays within one bf16 ulp of the plain versions.
// flash_dq_plain and flash_dkv_plain with round_like_kernel=True split P
// and dS the same way.
#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace flash_tc {

using namespace sm90;

// Shared memory of both kernels: six tiles (two loaded once, a 2-stage
// ring of two), lse and delta rows per stage, three mbarriers, and slack to
// put the tiles on a 1024-byte boundary (the 128-byte swizzle's period).
template <int D>
constexpr size_t smem_bytes() {
  return 6 * Tile<D>::kBytes + 4 * kTile * sizeof(float) +
         3 * sizeof(uint64_t) + 1024;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int S, int causal) {
  using T = Tile<D>;
  extern __shared__ char smem_raw[];
  char* sK = align_1024(smem_raw);
  char* sV = sK + T::kBytes;
  char* ring = sV + T::kBytes;  // stage s: Q at 2 s, dO at 2 s + 1 tiles
  float* sLse = reinterpret_cast<float*>(ring + 4 * T::kBytes);  // [2][64]
  float* sDelta = sLse + 2 * kTile;                              // [2][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sDelta + 2 * kTile);
  uint64_t* bar_kv = bars + 2;

  const int n_tiles = (S + kTile - 1) / kTile;
  const int bh = blockIdx.x;
  const int kt = blockIdx.y;  // under causal masking, low tiles are heaviest
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = kt * kTile;
  const int qt0 = causal ? kt : 0;  // first query tile that sees these keys
  const int n_it = n_tiles - qt0;
  const int tid = threadIdx.x;
  const float scale = rsqrtf((float)D);
  const float scale_log2 = scale * kLog2e;

  // Query rows [q0, q0 + 64) into ring stage s: Q and dO by TMA (thread
  // 0), lse (times log2 e) and delta by the first 64 threads.
  auto fetch = [&](int s, int q0) {
    if (tid == 0) {
      mbar_expect_tx(&bars[s], 2 * T::kBytes);
      T::load(ring + 2 * s * T::kBytes, &tm_q, &bars[s], q0, h, b);
      T::load(ring + (2 * s + 1) * T::kBytes, &tm_do, &bars[s], q0, h, b);
    }
    if (tid < kTile) {
      const int row = q0 + tid;
      const bool in = row < S;
      sLse[s * kTile + tid] = in ? lse[(size_t)bh * S + row] * kLog2e : 0.f;
      sDelta[s * kTile + tid] = in ? delta[(size_t)bh * S + row] : 0.f;
    }
  };

  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init(bar_kv, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * T::kBytes);
    T::load(sK, &tm_k, bar_kv, k0, h, b);
    T::load(sV, &tm_v, bar_kv, k0, h, b);
  }
  fetch(0, qt0 * kTile);
  __syncthreads();

  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  mbar_wait(bar_kv, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it & 1;
    const int q0 = (qt0 + it) * kTile;
    // Stage s ^ 1 was freed by the __syncthreads() that ended tile it - 1.
    if (it + 1 < n_it) fetch(s ^ 1, q0 + kTile);
    mbar_wait(&bars[s], (it >> 1) & 1);
    const char* sQ = ring + 2 * s * T::kBytes;
    const char* sDO = sQ + T::kBytes;
    const float* rLse = sLse + s * kTile;
    const float* rDelta = sDelta + s * kTile;

    // S^T = K Q^T and dP^T = V dO^T (rows keys, columns queries), in
    // flight together.
    float pt[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::kSteps; ++kk)
      Wgmma<64>::ss<0>(pt, T::kmajor(sK, kk), T::kmajor(sQ, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < T::kSteps; ++kk)
      Wgmma<64>::ss<0>(dpt, T::kmajor(sV, kk), T::kmajor(sDO, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pt);
    fence_regs(dpt);

    // P^T = exp(scale S^T - lse), 0 where masked (query past S, or before
    // the key under causal masking), and dS^T = P^T (dP^T - delta), in f32
    // and in place.
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = acc_col(i);
      const int q = q0 + c;
      const bool masked = q >= S || (causal && q < k0 + acc_row(i));
      pt[i] = masked ? 0.f : exp2f(pt[i] * scale_log2 - rLse[c]);
      dpt[i] = pt[i] * (dpt[i] - rDelta[c]);
    }
    uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
    wgmma_a_fragments(pt, p_hi, p_lo);
    wgmma_a_fragments(dpt, ds_hi, ds_lo);

    // dV += P^T dO and dK += dS^T Q: P^T and dS^T from registers, dO and Q
    // as MN-major B operands.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Wgmma<D>::template rs<1>(acc_v, p_hi[kk], T::mnmajor(sDO, kk), 1);
      Wgmma<D>::template rs<1>(acc_v, p_lo[kk], T::mnmajor(sDO, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Wgmma<D>::template rs<1>(acc_k, ds_hi[kk], T::mnmajor(sQ, kk), 1);
      Wgmma<D>::template rs<1>(acc_k, ds_lo[kk], T::mnmajor(sQ, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_v);
    fence_regs(acc_k);
    __syncthreads();  // every warp is done with stage s and its rows
  }

  store_rows<D>(acc_k, dk, b, h, H, S, k0, scale);
  store_rows<D>(acc_v, dv, b, h, H, S, k0, 1.f);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int H, int S, int causal) {
  using T = Tile<D>;
  extern __shared__ char smem_raw[];
  char* sQ = align_1024(smem_raw);
  char* sDO = sQ + T::kBytes;
  char* ring = sDO + T::kBytes;  // stage s: K at 2 s, V at 2 s + 1 tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + 4 * T::kBytes +
                                               4 * kTile * sizeof(float));
  uint64_t* bar_q = bars + 2;

  const int n_tiles = (S + kTile - 1) / kTile;
  const int bh = blockIdx.x;
  const int qt = n_tiles - 1 - blockIdx.y;  // heaviest tiles first
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = qt * kTile;
  const int n_it = causal ? qt + 1 : n_tiles;
  const int tid = threadIdx.x;
  const float scale = rsqrtf((float)D);
  const float scale_log2 = scale * kLog2e;

  auto fetch = [&](int s, int kt) {
    if (tid == 0) {
      mbar_expect_tx(&bars[s], 2 * T::kBytes);
      T::load(ring + 2 * s * T::kBytes, &tm_k, &bars[s], kt * kTile, h, b);
      T::load(ring + (2 * s + 1) * T::kBytes, &tm_v, &bars[s], kt * kTile, h,
              b);
    }
  };

  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init(bar_q, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * T::kBytes);
    T::load(sQ, &tm_q, bar_q, q0, h, b);
    T::load(sDO, &tm_do, bar_q, q0, h, b);
  }
  fetch(0, 0);

  // Each thread's two rows: acc_row(0) and acc_row(2) = acc_row(0) + 8.
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + acc_row(2 * r);
    row_lse[r] = row < S ? lse[(size_t)bh * S + row] * kLog2e : 0.f;
    row_delta[r] = row < S ? delta[(size_t)bh * S + row] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(bar_q, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it & 1;
    const int k0 = it * kTile;
    if (it + 1 < n_it) fetch(s ^ 1, it + 1);
    mbar_wait(&bars[s], (it >> 1) & 1);
    const char* sK = ring + 2 * s * T::kBytes;
    const char* sV = sK + T::kBytes;

    // S = Q K^T and dP = dO V^T, in flight together.
    float p[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::kSteps; ++kk)
      Wgmma<64>::ss<0>(p, T::kmajor(sQ, kk), T::kmajor(sK, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < T::kSteps; ++kk)
      Wgmma<64>::ss<0>(dp, T::kmajor(sDO, kk), T::kmajor(sV, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(p);
    fence_regs(dp);

    // P = exp(scale S - lse), 0 where masked (key past S, or after the
    // query under causal masking); dS = P (dP - delta), in place.
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i % 4) / 2;
      const int kp = k0 + acc_col(i);
      const bool masked = kp >= S || (causal && kp > q0 + acc_row(i));
      const float pr = masked ? 0.f : exp2f(p[i] * scale_log2 - row_lse[r]);
      p[i] = pr * (dp[i] - row_delta[r]);
    }
    uint32_t ds_hi[4][4], ds_lo[4][4];
    wgmma_a_fragments(p, ds_hi, ds_lo);

    // dQ += dS K (dS from registers, K MN-major).
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Wgmma<D>::template rs<1>(acc, ds_hi[kk], T::mnmajor(sK, kk), 1);
      Wgmma<D>::template rs<1>(acc, ds_lo[kk], T::mnmajor(sK, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warp is done with stage s
  }

  store_rows<D>(acc, dq, b, h, H, S, q0, scale);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int H,
              int S, int causal, cudaStream_t stream) {
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, dout};
  if (int err = encode_maps(maps, ptrs, B, H, S, D)) return err;
  const size_t smem = smem_bytes<D>();
  static cudaError_t setup = flash::allow_smem(flash_dq_kernel<D>, smem);
  if (setup != cudaSuccess) return setup;
  const dim3 grid(B * H, (S + kTile - 1) / kTile);
  flash_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse,
      (const float*)delta, (bf16*)dq, H, S, causal);
  return cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int H, int S, int causal, cudaStream_t stream) {
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, dout};
  if (int err = encode_maps(maps, ptrs, B, H, S, D)) return err;
  const size_t smem = smem_bytes<D>();
  static cudaError_t setup = flash::allow_smem(flash_dkv_kernel<D>, smem);
  if (setup != cudaSuccess) return setup;
  const dim3 grid(B * H, (S + kTile - 1) / kTile);
  flash_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse,
      (const float*)delta, (bf16*)dk, (bf16*)dv, H, S, causal);
  return cudaGetLastError();
}

}  // namespace flash_tc

// q, k, v, dout, dq: [B, S, H, D] bf16, contiguous, 16-byte aligned;
// lse, delta: [B * H, S] f32. Returns 0, the launch's cudaError_t, or
// sm90::kEncodeError + the CUresult of a refused tensor map. dtype must be
// bf16 (1); f32 goes to flash_bwd.cu's kernels.
extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int B, int H, int S, int D, int causal,
                        int dtype, void* stream) {
  if (dtype != flash::kBF16) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define CALL(DD) \
  flash_tc::launch_dq<DD>(q, k, v, dout, lse, delta, dq, B, H, S, causal, st)
  SM90_DISPATCH_D(D, CALL)
#undef CALL
}

// As flash_dq; dk and dv: [B, S, H, D] bf16, contiguous.
extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, int B, int H, int S, int D,
                         int causal, int dtype, void* stream) {
  if (dtype != flash::kBF16) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define CALL(DD)                                                              \
  flash_tc::launch_dkv<DD>(q, k, v, dout, lse, delta, dk, dv, B, H, S, causal, \
                           st)
  SM90_DISPATCH_D(D, CALL)
#undef CALL
}
