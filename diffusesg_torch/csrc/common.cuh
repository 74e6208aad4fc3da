// Shared pieces of the Hopper kernels: a row-preparation kernel for the
// backward kernels' LayerNorm'd recompute operands, a bf16 tile GEMM on the
// tensor cores (WMMA 16x16x16, fp32 accumulate) with a fused per-element
// epilogue, and small device helpers (erf-GELU, SiLU, bf16 rounding, warp
// sums, the mma.sync pieces).
//
// Row preparation: one warp per row.  A source functor hands over eight
// consecutive raw values of row m (`raw8`: the noise affine, a plain load),
// the warp keeps the row in registers, takes LayerNorm statistics over all K
// (two passes: mean, then the mean of squared deviations, as the reference
// LayerNorm), and writes the normalized row once in bf16.  The forward
// GEMMs' prologues (hg::LnPanel) repeat this arithmetic on shared memory.
//
// WMMA GEMM: C[m, n] = epi(m, n, sum_k A[m, k] * W[n, k]), W in the PyTorch
// Linear layout [N, K] (the column-major B operand WMMA wants) and A = [a1 |
// a2] row-major.  128x64 output per 128-thread block, K step 32, each warp a
// 64x32 quadrant of 4x2 WMMA fragments, a 3-stage cp.async ring, and an
// epilogue over an fp32 staging tile with 16-byte stores.  It serves every
// GEMM of the backward kernels and nothing else: the forward GEMMs
// (swin_attn, patch_merge, patch_breakup, readout) run on wgmma
// (hopper_gemm.cuh).
//
// The backward kernels need two more operand layouts and a split of K:
//   TA: A is stored [K, M] (token-major), so C = A^T-stored x B contracts
//       over the token axis: the weight gradients dW = d(out)^T x in;
//   TB: the second operand is stored [K, N], so C = A x W with W untransposed:
//       the input gradients d(in) = d(out) x W.
// With gridDim.z > 1 block z covers K range [z * kchunk, (z + 1) * kchunk) and
// its epilogue writes an fp32 partial; ``reduce_partials`` (backward.cuh, with
// the backward row pass and the column sums) adds the partials in a fixed
// order, so the result is the same from run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace dsg {

using bf16 = __nv_bfloat16;

constexpr float kLnEps = 1e-6f;  // every LayerNorm of the model (flax default)
constexpr int kBM = 128, kBN = 64, kBK = 32, kThreads = 128, kStages = 3;
constexpr int kLdA = kBK + 8;  // bf16 elements; rows stay 16-byte aligned
constexpr int kLdC = kBN + 4;  // floats
constexpr int kLdAT = kBM + 8;  // A tile stored [kBK][kBM] (TA)
constexpr int kLdBT = kBN + 8;  // B tile stored [kBK][kBN] (TB)

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the same for N independent values at once (their shuffles interleave),
// each summed over aligned groups of LANES lanes
template <int LANES = 32, int N>
__device__ __forceinline__ void warp_sum_n(float (&v)[N]) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], o);
}

// Loads of data that no kernel writes while it runs (weights, biases,
// LayerNorm parameters, a launch's inputs): plain asm without `volatile` or a
// memory clobber, so the compiler may move them ahead of stores it cannot
// prove apart, and an epilogue's loads overlap instead of queueing behind
// each store.
__device__ __forceinline__ float ld_ro(const float* p) {
  float v;
  asm("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float4 ld_ro4(const float* p) {  // 16-byte aligned
  float4 v;
  asm("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}
__device__ __forceinline__ void ld_ro8(const bf16* p, float v[8]) {  // 16-byte aligned
  uint4 u;
  asm("ld.global.nc.v4.b32 {%0, %1, %2, %3}, [%4];"
      : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
      : "l"(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// eight consecutive bf16 (16-byte aligned) -> float
__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// ------------------------------------------------ register-level MMA pieces
//
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) with fragments loaded by
// ldmatrix, for the kernels that keep intermediate tiles in registers (the
// forward window core, the fused MLP).  Lane l holds, with g = l / 4 and
// t = l % 4: of the 16x16 A tile a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..),
// a[2] = (g, 2t+8..), a[3] = (g+8, 2t+8..); of the 16x8 B tile (k x n)
// b[0] = (k 2t..2t+1, n g), b[1] = (k 2t+8.., n g); of the 16x8 fp32
// accumulator c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..2t+1).

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, each matrix transposed (a B operand stored k-major)
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// two 8x8 matrices; lanes 0..15 give the row addresses
__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a b for one 16x8x16 tile
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// A fragment of a 16x16 tile of a row-major bf16 tile in shared memory
// (row stride ld elements), rows r0.., columns k0..
__device__ __forceinline__ void load_a16(uint32_t a[4], const bf16* tile, int ld, int r0, int k0,
                                         int lane) {
  ldsm_x4(a, tile + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// B fragments of two n-tiles (n0.., n0+8..) x k16 from an [n][k] row-major
// tile (a Linear weight, or K of attention): {b0, b1} of n0, then of n0 + 8
__device__ __forceinline__ void load_b16x2(uint32_t b[4], const bf16* tile, int ld, int n0,
                                           int k0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// B fragment of one n-tile x k16 from an [n][k] row-major tile
__device__ __forceinline__ void load_b16(uint32_t b[2], const bf16* tile, int ld, int n0, int k0,
                                         int lane) {
  ldsm_x2(b, tile + (n0 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// ------------------------------------------------------- row preparation

// A plain row-major bf16 [M, K] source.
struct RowSrc {
  const bf16* x;
  int K;
  __device__ void raw8(int m, int k, float v[8]) const { load8(x + (size_t)m * K + k, v); }
};

// LayerNorm of source row `row` by one warp, written in bf16 to `out` (the
// row's first element, device or shared memory); the row is held in
// registers (MAXV vectors of 8 per lane: K <= 256 * MAXV).
template <class Src, int MAXV>
__device__ __forceinline__ void ln_row(const Src& src, int row, int K, int lane,
                                       const float* __restrict__ gamma,
                                       const float* __restrict__ beta, bf16* out) {
  float v[MAXV][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int k = (i * 32 + lane) * 8;
    if (k < K) {
      src.raw8(row, k, v[i]);
#pragma unroll
      for (int t = 0; t < 8; ++t) s += v[i][t];
    }
  }
  const float mean = warp_sum(s) / K;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int k = (i * 32 + lane) * 8;
    if (k < K) {
#pragma unroll
      for (int t = 0; t < 8; ++t) q += (v[i][t] - mean) * (v[i][t] - mean);
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / K + kLnEps);
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int k = (i * 32 + lane) * 8;
    if (k < K) {
      float o[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) o[t] = (v[i][t] - mean) * rstd * gamma[k + t] + beta[k + t];
      store8(out + k, o);
    }
  }
}

// out[m, :] = bf16(LayerNorm(src row m)), one warp per row.
template <class Src, int MAXV>
__global__ void __launch_bounds__(256)
ln_rows_kernel(Src src, const float* __restrict__ gamma, const float* __restrict__ beta,
               bf16* __restrict__ out, int M, int K) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  ln_row<Src, MAXV>(src, row, K, lane, gamma, beta, out + (size_t)row * K);
}

template <class Src>
cudaError_t launch_ln_rows(const Src& src, const float* gamma, const float* beta, bf16* out,
                           int M, int K, cudaStream_t stream) {
  if (M <= 0 || K <= 0 || K % 8 != 0) return cudaErrorInvalidValue;
  const dim3 grid((M + 7) / 8), block(256);
  if (K <= 256) ln_rows_kernel<Src, 1><<<grid, block, 0, stream>>>(src, gamma, beta, out, M, K);
  else if (K <= 512) ln_rows_kernel<Src, 2><<<grid, block, 0, stream>>>(src, gamma, beta, out, M, K);
  else if (K <= 768) ln_rows_kernel<Src, 3><<<grid, block, 0, stream>>>(src, gamma, beta, out, M, K);
  else if (K <= 1536) ln_rows_kernel<Src, 6><<<grid, block, 0, stream>>>(src, gamma, beta, out, M, K);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// ------------------------------------------------------------------- GEMM

// A = [a1 | a2] along K, both row-major bf16 (a2 may be null with K2 = 0).
struct GemmA {
  const bf16* a1;
  const bf16* a2;
  int K1, K2;
};

inline GemmA rows(const void* a, int K) {
  return GemmA{static_cast<const bf16*>(a), nullptr, K, 0};
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <class Site, class Epi, bool TA, bool TB>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(GemmA A, Epi epi, const bf16* __restrict__ W, int M, int N, int K, int kchunk) {
  using namespace nvcuda;
  constexpr int kStageElems = (kBM + kBN) * kLdA;
  static_assert(kBK * kLdAT <= kBM * kLdA && kBK * kLdBT <= kBN * kLdA, "stage size");
  constexpr int kRingBytes = kStages * kStageElems * 2;
  constexpr int kCsBytes = kBM * kLdC * 4;
  // the cp.async ring, then (after the K loop) the fp32 output tile
  __shared__ __align__(128) unsigned char smem[kRingBytes > kCsBytes ? kRingBytes : kCsBytes];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);

  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = kbeg + kchunk < K ? kbeg + kchunk : K;
  const int ktiles = (kend - kbeg + kBK - 1) / kBK;

  auto load_stage = [&](int stage, int k0) {
    bf16* As = ring + stage * kStageElems;
    bf16* Bs = As + kBM * kLdA;
    if constexpr (TA) {  // A stored [K, M]: 16-byte vectors run along m
#pragma unroll
      for (int i = tid; i < kBK * kBM / 8; i += kThreads) {
        const int r = i / (kBM / 8), mm = (i % (kBM / 8)) * 8;
        const int k = k0 + r, m = m0 + mm;
        const bool ok = m < M && k < kend;
        cp_async16(As + r * kLdAT + mm, ok ? A.a1 + (size_t)k * M + m : A.a1, ok);
      }
    } else {
#pragma unroll
      for (int i = tid; i < kBM * kBK / 8; i += kThreads) {
        const int r = i / (kBK / 8), kk = (i % (kBK / 8)) * 8;
        const int m = m0 + r, k = k0 + kk;
        const bool ok = m < M && k < kend;
        const bf16* src = A.a1;
        if (ok)
          src = k < A.K1 ? A.a1 + (size_t)m * A.K1 + k : A.a2 + (size_t)m * A.K2 + (k - A.K1);
        cp_async16(As + r * kLdA + kk, src, ok);
      }
    }
    if constexpr (TB) {  // W stored [K, N]: vectors run along n
#pragma unroll
      for (int i = tid; i < kBK * kBN / 8; i += kThreads) {
        const int r = i / (kBN / 8), nn = (i % (kBN / 8)) * 8;
        const int k = k0 + r, n = n0 + nn;
        const bool ok = n < N && k < kend;
        cp_async16(Bs + r * kLdBT + nn, ok ? W + (size_t)k * N + n : W, ok);
      }
    } else {
#pragma unroll
      for (int i = tid; i < kBN * kBK / 8; i += kThreads) {
        const int r = i / (kBK / 8), kk = (i % (kBK / 8)) * 8;
        const int n = n0 + r, k = k0 + kk;
        const bool ok = n < N && k < kend;
        cp_async16(Bs + r * kLdA + kk, ok ? W + (size_t)n * K + k : W, ok);
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 32;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(s, kbeg + s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed
    __syncthreads();               // ... for every thread; stage (kt-1) is free again
    const int nk = kt + kStages - 1;
    if (nk < ktiles) load_stage(nk % kStages, kbeg + nk * kBK);
    cp_async_commit();
    const bf16* as = ring + (kt % kStages) * kStageElems;
    const bf16* bs = as + kBM * kLdA;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      using LayA = std::conditional_t<TA, wmma::col_major, wmma::row_major>;
      using LayB = std::conditional_t<TB, wmma::row_major, wmma::col_major>;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayA> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayB> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (TA) wmma::load_matrix_sync(fa[i], as + kk * kLdAT + wm + i * 16, kLdAT);
        else wmma::load_matrix_sync(fa[i], as + (wm + i * 16) * kLdA + kk, kLdA);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if constexpr (TB) wmma::load_matrix_sync(fb[j], bs + kk * kLdBT + wn + j * 16, kLdBT);
        else wmma::load_matrix_sync(fb[j], bs + (wn + j * 16) * kLdA + kk, kLdA);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring before Cs overwrites it

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * kLdC + wn + j * 16, acc[i][j], kLdC,
                              wmma::mem_row_major);
  __syncthreads();
  const bool vec_rows = N % 8 == 0;  // 16-byte aligned rows of the output
  for (int i = tid; i < kBM * kBN / 8; i += kThreads) {
    const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const float4 lo = *reinterpret_cast<const float4*>(Cs + r * kLdC + c);
    const float4 hi = *reinterpret_cast<const float4*>(Cs + r * kLdC + c + 4);
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const int cnt = N - n < 8 ? N - n : 8;
    epi.store(m, n, v, cnt, vec_rows && cnt == 8);
  }
}

template <class Site, class Epi>
cudaError_t launch_gemm(const GemmA& A, const Epi& epi, const bf16* W, int M, int N,
                        cudaStream_t stream) {
  const int K = A.K1 + A.K2;
  if (M <= 0 || N <= 0 || K <= 0 || A.K1 % 8 != 0 || A.K2 % 8 != 0)
    return cudaErrorInvalidValue;
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  gemm_kernel<Site, Epi, false, false><<<grid, kThreads, 0, stream>>>(A, epi, W, M, N, K, K);
  return cudaGetLastError();
}

// C[m, n] = epi(sum_k a[m, k] * w[k, n]): a [M, K] row-major, w [K, N]
// row-major (a Linear weight [out = K, in = N] taken untransposed).
template <class Site, class Epi>
cudaError_t launch_gemm_nn(const void* a, const void* w, const Epi& epi, int M, int N, int K,
                           cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || N % 8 != 0) return cudaErrorInvalidValue;
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  gemm_kernel<Site, Epi, false, true><<<grid, kThreads, 0, stream>>>(
      rows(a, K), epi, static_cast<const bf16*>(w), M, N, K, K);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- epilogue

// y = acc + bias[n] (bias may be null), stored as OutT; `cnt` columns from
// n, 16-byte vectors when `vec`.
template <class OutT>
struct Epilogue {
  OutT* out;
  const float* bias;
  int N;
  __device__ void store(int m, int n, const float* acc, int cnt, bool vec) const {
    const size_t base = (size_t)m * N + n;
    float y[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) y[t] = acc[t] + (bias && t < cnt ? bias[n + t] : 0.f);
    if constexpr (sizeof(OutT) == 2) {
      if (vec) store8(out + base, y);
      else
        for (int t = 0; t < cnt; ++t) out[base + t] = __float2bfloat16(y[t]);
    } else {
      if (vec) {
        reinterpret_cast<float4*>(out + base)[0] = make_float4(y[0], y[1], y[2], y[3]);
        reinterpret_cast<float4*>(out + base)[1] = make_float4(y[4], y[5], y[6], y[7]);
      } else {
        for (int t = 0; t < cnt; ++t) out[base + t] = y[t];
      }
    }
  }
};

using StoreBf16 = Epilogue<bf16>;
using StoreF32 = Epilogue<float>;

}  // namespace dsg
