// Flash-attention forward for Hopper's tensor cores (sm_90a), bf16.
//
// Replaces, for bf16 inputs, the Pallas TPU kernel `_fwd_kernel`
// (dynolog_tpu/ops/flash_attention.py:62-110, launched by `_flash_forward`
// at :113-140): per 64-query tile, over the key tiles up to the diagonal,
// S = Q K^T, the online softmax (running row max m and sum l, O rescaled
// by exp(m_old - m_new)), O += P V; then out = O / l and the per-row
// lse = m + log(l) (l == 0 guarded to 1, natural log) that the backward
// kernels recompute probabilities from. f32 inputs keep the CUDA-core
// kernel of flash_fwd.cu.
//
// What bounds it on the H100: two S x S x D products per head against
// O(S D) bytes, so it is bound by operations, at the 989 TFLOP/s bf16
// tensor-core rate. What the design does about it (the loop of
// flash_bwd_sm90.cu's dQ kernel: one query tile that stays, key tiles that
// stream):
// - both products are wgmma (m64nNk16, f32 accumulators), one warpgroup
//   per block: S = Q K^T reads both operands from shared memory (Q and K
//   K-major); O += P V takes P as the A operand from registers, the f32
//   accumulator fragment of P repacked in place into bf16 A fragments, and
//   V as an MN-major B operand of the same tile, so P never touches shared
//   memory and nothing is transposed;
// - tiles arrive by TMA into swizzled bf16 shared memory, straight from the
//   [B, S, H, D] tensors (4-D tensor maps); Q is loaded once, K and V come
//   through a 2-stage ring on mbarriers, and tile i+1's copy is issued
//   before tile i's products;
// - the softmax runs on the S accumulator fragment in registers: a row's
//   64 values sit in the 4 threads of a quad, so its max and sum take two
//   xor-shuffles; `scale` multiplies the f32 scores inside the exp2
//   (scale log2 e folded in), never a bf16 operand;
// - the ragged S edge reads zeros from the TMA and is masked to -1e30 with
//   the causal diagonal, only on the tiles that need it; tiles past the
//   diagonal are skipped; blocks run heaviest tiles first.
// Numerics: P, formed in f32, enters P V as a pair of bf16, hi = bf16(x)
// and lo = bf16(x - hi), one wgmma per half (16 significant bits; half more
// tensor work than one rounding). Rounding P once to bf16 moves an element
// of O by a bf16 ulp of a large P term whenever the f32 value lands on the
// other side of a rounding boundary from the plain version's, more than
// one bf16 ulp of a small element (scripts/torch_flash_rounding.py). With
// the pair, O stays within one bf16 ulp of the f32 flash_forward_plain.
#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace flash_tc {

using namespace sm90;

// Shared memory: the Q tile, a 2-stage ring of K and V tiles, three
// mbarriers, and slack to put the tiles on a 1024-byte boundary.
template <int D>
constexpr size_t fwd_smem_bytes() {
  return 5 * Tile<D>::kBytes + 3 * sizeof(uint64_t) + 1024;
}

// Max (kMax) or sum over the 4 threads of a quad, which hold one row of an
// m64nN accumulator.
template <bool kMax>
__device__ __forceinline__ float quad_reduce(float x) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     bf16* __restrict__ out, float* __restrict__ lse, int H,
                     int S, int causal) {
  using T = Tile<D>;
  extern __shared__ char smem_raw[];
  char* sQ = align_1024(smem_raw);
  char* ring = sQ + T::kBytes;  // stage s: K at 2 s, V at 2 s + 1 tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + 4 * T::kBytes);
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
    mbar_expect_tx(bar_q, T::kBytes);
    T::load(sQ, &tm_q, bar_q, q0, h, b);
  }
  fetch(0, 0);

  // Each thread's two rows, acc_row(0) and acc_row(2) = acc_row(0) + 8:
  // the running max of the unscaled scores and the running sum of P.
  float row_m[2] = {flash::kNegInf, flash::kNegInf};
  float row_l[2] = {0.f, 0.f};
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

    // S = Q K^T.
    float p[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::kSteps; ++kk)
      Wgmma<64>::ss<0>(p, T::kmajor(sQ, kk), T::kmajor(sK, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(p);

    // Keys past S, or after the query under causal masking, score -1e30:
    // only the diagonal tile and the tile holding the edge have any.
    if ((causal && it == qt) || k0 + kTile > S) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kp = k0 + acc_col(i);
        if (kp >= S || (causal && kp > q0 + acc_row(i))) p[i] = flash::kNegInf;
      }
    }

    // Online softmax: m_new = max(m, rowmax S), P = exp(scale (S - m_new)),
    // l = l alpha + rowsum P, O = O alpha with alpha = exp(scale (m - m_new)).
    float m_new[2] = {row_m[0], row_m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i % 4) / 2;
      m_new[r] = fmaxf(m_new[r], p[i]);
    }
    float alpha[2], m_scaled[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = quad_reduce<true>(m_new[r]);
      alpha[r] = exp2f((row_m[r] - m_new[r]) * scale_log2);
      m_scaled[r] = m_new[r] * scale_log2;
      row_m[r] = m_new[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i % 4) / 2;
      p[i] = exp2f(fmaf(p[i], scale_log2, -m_scaled[r]));
      sum[r] += p[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      row_l[r] = row_l[r] * alpha[r] + quad_reduce<false>(sum[r]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i % 4) / 2];
    uint32_t p_hi[4][4], p_lo[4][4];
    wgmma_a_fragments(p, p_hi, p_lo);

    // O += P V (P from registers, V MN-major).
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Wgmma<D>::template rs<1>(acc, p_hi[kk], T::mnmajor(sV, kk), 1);
      Wgmma<D>::template rs<1>(acc, p_lo[kk], T::mnmajor(sV, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warp is done with stage s
  }

  // out = O / l and lse = m scale + log l, with l == 0 taken as 1.
  float l_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l_safe[r] = row_l[r] == 0.f ? 1.f : row_l[r];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] /= l_safe[(i % 4) / 2];
  store_rows<D>(acc, out, b, h, H, S, q0, 1.f);
  if (tid % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + acc_row(2 * r);
      if (row < S)
        lse[(size_t)bh * S + row] = row_m[r] * scale + logf(l_safe[r]);
    }
  }
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int H, int S, int causal,
               cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  if (int err = encode_maps(maps, ptrs, B, H, S, D)) return err;
  const size_t smem = fwd_smem_bytes<D>();
  static cudaError_t setup = flash::allow_smem(flash_fwd_kernel<D>, smem);
  if (setup != cudaSuccess) return setup;
  const dim3 grid(B * H, (S + kTile - 1) / kTile);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], (bf16*)o, (float*)lse, H, S, causal);
  return cudaGetLastError();
}

}  // namespace flash_tc

// q, k, v, o: [B, S, H, D] bf16, contiguous, 16-byte aligned; lse:
// [B * H, S] f32. Returns 0, the launch's cudaError_t, or
// sm90::kEncodeError + the CUresult of a refused tensor map. dtype must be
// bf16 (1); f32 goes to flash_fwd.cu's kernel.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int H, int S, int D, int causal,
                         int dtype, void* stream) {
  if (dtype != flash::kBF16) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define CALL(DD) \
  flash_tc::launch_fwd<DD>(q, k, v, o, lse, B, H, S, causal, st)
  SM90_DISPATCH_D(D, CALL)
#undef CALL
}
