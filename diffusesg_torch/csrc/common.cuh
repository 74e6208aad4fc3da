// Shared pieces of the Hopper kernels: a row-preparation kernel for the
// LayerNorm'd (and gathered) GEMM operands, a bf16 tile GEMM on the tensor
// cores (WMMA 16x16x16, fp32 accumulate) with a fused per-element epilogue,
// and small device helpers (erf-GELU, SiLU, bf16 rounding, warp sums).
//
// Row preparation: one warp per row.  A source functor hands over eight
// consecutive raw values of row m (`raw8`: a gather, the noise affine, a
// plain load), the warp keeps the row in registers, takes LayerNorm
// statistics over all K (two passes: mean, then the mean of squared
// deviations, as the reference LayerNorm), and writes the normalized row
// once in bf16; `emit` lets a source store its raw values too (the noise
// affine's output, needed again by the residual).  So every element's
// prologue work runs once, not once per output tile.
//
// GEMM: C[m, n] = epi(m, n, sum_k A[m, k] * W[n, k]), W in the PyTorch
// Linear layout [N, K] (the column-major B operand WMMA wants) and A = [a1 |
// a2] row-major, two sources so a concatenated skip is never materialized.
// 128x64 output per 128-thread block, K step 32, each warp a 64x32 quadrant
// of 4x2 WMMA fragments, a 3-stage cp.async ring so the next tiles load
// while the current one multiplies, and an epilogue that handles eight
// columns per thread with 16-byte stores.  No wgmma or TMA yet.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace dsg {

using bf16 = __nv_bfloat16;

constexpr float kLnEps = 1e-6f;  // every LayerNorm of the model (flax default)
constexpr int kBM = 128, kBN = 64, kBK = 32, kThreads = 128, kStages = 3;
constexpr int kLdA = kBK + 8;  // bf16 elements; rows stay 16-byte aligned
constexpr int kLdC = kBN + 4;  // floats

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

// ------------------------------------------------------- row preparation

// A plain row-major bf16 [M, K] source.
struct RowSrc {
  const bf16* x;
  int K;
  __device__ void raw8(int m, int k, float v[8]) const { load8(x + (size_t)m * K + k, v); }
  __device__ void emit(int, int, const float*) const {}
};

// out[m, :] = bf16(LayerNorm(src row m)), one warp per row, the row held in
// registers (MAXV vectors of 8 per lane: K <= 256 * MAXV).
template <class Src, int MAXV>
__global__ void __launch_bounds__(256)
ln_rows_kernel(Src src, const float* __restrict__ gamma, const float* __restrict__ beta,
               bf16* __restrict__ out, int M, int K) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
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
      store8(out + (size_t)row * K + k, o);
      src.emit(row, k, v[i]);
    }
  }
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

// Call sites of the GEMM: an empty tag type per site, so each launch has a
// kernel name of its own in a profile.
struct SwinQkv {};
struct SwinProj {};
struct MlpFc1 {};
struct MlpFc2 {};
struct MergeProj {};
struct BreakupIn {};
struct BreakupOut {};
struct ReadoutFc1 {};
struct ReadoutFc2 {};

template <class Site, class Epi>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(GemmA A, Epi epi, const bf16* __restrict__ W, int M, int N, int K) {
  using namespace nvcuda;
  constexpr int kStageElems = (kBM + kBN) * kLdA;
  constexpr int kRingBytes = kStages * kStageElems * 2;
  constexpr int kCsBytes = kBM * kLdC * 4;
  // the cp.async ring, then (after the K loop) the fp32 output tile
  __shared__ __align__(128) unsigned char smem[kRingBytes > kCsBytes ? kRingBytes : kCsBytes];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);

  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int ktiles = (K + kBK - 1) / kBK;

  auto load_stage = [&](int stage, int k0) {
    bf16* As = ring + stage * kStageElems;
    bf16* Bs = As + kBM * kLdA;
#pragma unroll
    for (int i = tid; i < kBM * kBK / 8; i += kThreads) {
      const int r = i / (kBK / 8), kk = (i % (kBK / 8)) * 8;
      const int m = m0 + r, k = k0 + kk;
      const bool ok = m < M && k < K;
      const bf16* src = A.a1;
      if (ok) src = k < A.K1 ? A.a1 + (size_t)m * A.K1 + k : A.a2 + (size_t)m * A.K2 + (k - A.K1);
      cp_async16(As + r * kLdA + kk, src, ok);
    }
#pragma unroll
    for (int i = tid; i < kBN * kBK / 8; i += kThreads) {
      const int r = i / (kBK / 8), kk = (i % (kBK / 8)) * 8;
      const int n = n0 + r, k = k0 + kk;
      const bool ok = n < N && k < K;
      cp_async16(Bs + r * kLdA + kk, ok ? W + (size_t)n * K + k : W, ok);
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
    if (s < ktiles) load_stage(s, s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed
    __syncthreads();               // ... for every thread; stage (kt-1) is free again
    const int nk = kt + kStages - 1;
    if (nk < ktiles) load_stage(nk % kStages, nk * kBK);
    cp_async_commit();
    const bf16* as = ring + (kt % kStages) * kStageElems;
    const bf16* bs = as + kBM * kLdA;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(fa[i], as + (wm + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], bs + (wn + j * 16) * kLdA + kk, kLdA);
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
  gemm_kernel<Site, Epi><<<grid, kThreads, 0, stream>>>(A, epi, W, M, N, K);
  return cudaGetLastError();
}

inline GemmA rows(const void* a, int K) {
  return GemmA{static_cast<const bf16*>(a), nullptr, K, 0};
}

// ---------------------------------------------------------------- epilogue

enum class Act { kNone, kGelu };
enum class Res {
  kNone,
  kRounded,  // out = res + bf16(y): the MLP residual, branch rounded first
  kSum,      // out = res + y, one rounding: the attention residual
};

// y = act(acc + bias[n]) (bias may be null), then the residual, stored as
// OutT; `cnt` columns from n, 16-byte vectors when `vec`.
template <Act ACT, Res RES, class OutT>
struct Epilogue {
  OutT* out;
  const float* bias;
  const bf16* res;  // [M, N], RES != kNone
  int N;
  __device__ void store(int m, int n, const float* acc, int cnt, bool vec) const {
    const size_t base = (size_t)m * N + n;
    float rv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if constexpr (RES != Res::kNone) {
      if (vec) load8(res + base, rv);
      else
        for (int t = 0; t < cnt; ++t) rv[t] = __bfloat162float(res[base + t]);
    }
    float y[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float v = acc[t] + (bias && t < cnt ? bias[n + t] : 0.f);
      if constexpr (ACT == Act::kGelu) v = gelu_erf(v);
      if constexpr (RES == Res::kRounded) v = rv[t] + round_bf16(v);
      if constexpr (RES == Res::kSum) v = rv[t] + v;
      y[t] = v;
    }
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

using StoreBf16 = Epilogue<Act::kNone, Res::kNone, bf16>;
using StoreF32 = Epilogue<Act::kNone, Res::kNone, float>;
using GeluBf16 = Epilogue<Act::kGelu, Res::kNone, bf16>;
using ResidBf16 = Epilogue<Act::kNone, Res::kRounded, bf16>;
using AddResidBf16 = Epilogue<Act::kNone, Res::kSum, bf16>;

}  // namespace dsg
