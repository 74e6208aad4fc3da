// Shared pieces of the backward kernels (token_mlp_bwd, swin_attn_bwd):
//
//   * launch_gemm_tn: dW[i, j] = sum_t a[t, i] * b[t, j], the contraction
//     over the token axis (K = tokens, up to 262,144 at batch 64) with a tiny
//     output.  K is split over gridDim.z so the grid fills the card; each
//     split writes an fp32 partial and reduce_partials sums them;
//   * col_sums: per-column sums over tokens of a bf16 [T, N] matrix (the
//     bias gradients), as per-block partials for the same reduction;
//   * ln_bwd_rows: the row pass that closes both backward kernels: the
//     LayerNorm vjp per token (one warp per row, statistics recomputed in
//     fp32), the noise affine's vjp for the attention half, and the sums
//     over tokens (d gamma, d beta, d scale, d shift) kept in registers
//     across a block's rows and written once per block;
//   * reduce_partials: out[g, i] = sum_s part[(g * S + s) * ld + off + i].
//
// Every reduction over tokens is two-phase (per-block fp32 partials, then
// one reduction in a fixed order): no atomics, so every gradient is the same
// bit for bit from run to run.
#pragma once

#include <cuda_fp16.h>

#include "common.cuh"

namespace dsg {

// GEMM call sites of the backward kernels (kernel names in a profile)
struct MlpBwdFc1 {};
struct MlpBwdDm {};
struct MlpBwdDw1 {};
struct MlpBwdDw2 {};
struct MlpBwdDhn {};
struct SwinBwdQkv {};
struct SwinBwdDattn {};
struct SwinBwdDwproj {};
struct SwinBwdDwqkv {};
struct SwinBwdDhn {};

__device__ __forceinline__ float gelu_erf_grad(float v) {
  // d/dv [v * Phi(v)] = Phi(v) + v * phi(v)
  const float cdf = 0.5f * (1.f + erff(v * 0.70710678118654752f));
  return cdf + v * 0.3989422804014327f * expf(-0.5f * v * v);
}

__device__ __forceinline__ float silu_grad(float v) {
  const float s = 1.f / (1.f + expf(-v));
  return s * (1.f + v * (1.f - s));
}

__device__ __forceinline__ void load8f(const float* p, float v[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

__device__ __forceinline__ void load8h(const __half* p, float v[8]) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __half22float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8h(__half* p, const float v[8]) {
  uint4 u;
  __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// --------------------------------------------------------------- epilogues
// All output widths of the backward GEMMs are multiples of 8, so the
// epilogues store whole 16-byte vectors (the launchers check N % 8).

// fc1 recomputed: u = acc + b1; m = gelu(u) in bf16 and gelu'(u) in fp16
// (values in [-0.13, 1.13]: fp16 keeps 11 bits where bf16 keeps 8).
struct GeluAndGradEpi {
  bf16* m;
  __half* gp;
  const float* bias;
  int N;
  __device__ void store(int r, int n, const float* acc, int, bool) const {
    float mv[8], gv[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float u = acc[t] + bias[n + t];
      mv[t] = gelu_erf(u);
      gv[t] = gelu_erf_grad(u);
    }
    const size_t base = (size_t)r * N + n;
    store8(m + base, mv);
    store8h(gp + base, gv);
  }
};

// du = bf16(acc * gelu'(u))
struct MulGradEpi {
  bf16* out;
  const __half* gp;
  int N;
  __device__ void store(int r, int n, const float* acc, int, bool) const {
    const size_t base = (size_t)r * N + n;
    float g[8], y[8];
    load8h(gp + base, g);
#pragma unroll
    for (int t = 0; t < 8; ++t) y[t] = acc[t] * g[t];
    store8(out + base, y);
  }
};

// fp32 partial of split z at out + z * M * N
struct PartialF32 {
  float* out;
  int N;
  size_t MN;
  __device__ void store(int r, int n, const float* acc, int, bool) const {
    float* p = out + blockIdx.z * MN + (size_t)r * N + n;
    reinterpret_cast<float4*>(p)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
};

// part[z, i, j] = sum over split z's tokens t of a[t, i] * b[t, j]; a [T, M],
// b [T, N] row-major bf16; `splits` partials of [M, N] fp32.
template <class Site>
cudaError_t launch_gemm_tn(const void* a, const void* b, float* part, int M, int N, int T,
                           int splits, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || T <= 0 || M % 8 || N % 8 || splits < 1) return cudaErrorInvalidValue;
  int kchunk = (T + splits - 1) / splits;
  kchunk = (kchunk + kBK - 1) / kBK * kBK;
  if ((long long)kchunk * (splits - 1) >= T) return cudaErrorInvalidValue;  // an empty split
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, splits);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidConfiguration;
  PartialF32 epi{part, N, (size_t)M * N};
  gemm_kernel<Site, PartialF32, true, true><<<grid, kThreads, 0, stream>>>(
      GemmA{static_cast<const bf16*>(a), nullptr, 0, 0}, epi, static_cast<const bf16*>(b), M, N,
      T, kchunk);
  return cudaGetLastError();
}

// ------------------------------------------------------------ reductions

// out[g * N + i] = sum_{s < S} part[(g * S + s) * ld + off + i]; grid (ceil(N / 256), G)
static __global__ void __launch_bounds__(256)
reduce_partials_kernel(const float* __restrict__ part, float* __restrict__ out, int S, int N,
                       size_t ld, int off) {
  const int i = blockIdx.x * 256 + threadIdx.x, g = blockIdx.y;
  if (i >= N) return;
  const float* p = part + (size_t)g * S * ld + off + i;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += p[(size_t)s * ld];
  out[(size_t)g * N + i] = acc;
}

inline cudaError_t reduce_partials(const float* part, float* out, int G, int S, int N, size_t ld,
                                   int off, cudaStream_t stream) {
  if (G <= 0 || S <= 0 || N <= 0) return cudaErrorInvalidValue;
  dim3 grid((N + 255) / 256, G);
  reduce_partials_kernel<<<grid, 256, 0, stream>>>(part, out, S, N, ld, off);
  return cudaGetLastError();
}

// part[s, n] = sum of x[t, n] over the rows t of split s; block (32, 8):
// threadIdx.x a vector of 8 columns, threadIdx.y a row lane.
static __global__ void __launch_bounds__(256)
col_sums_kernel(const bf16* __restrict__ x, float* __restrict__ part, int T, int N,
                int rows_per_split) {
  __shared__ float red[8][32][9];
  const int col = (blockIdx.x * 32 + threadIdx.x) * 8;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = r0 + rows_per_split < T ? r0 + rows_per_split : T;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (col < N) {
    for (int r = r0 + threadIdx.y; r < r1; r += 8) {
      float v[8];
      load8(x + (size_t)r * N + col, v);
#pragma unroll
      for (int t = 0; t < 8; ++t) acc[t] += v[t];
    }
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) red[threadIdx.y][threadIdx.x][t] = acc[t];
  __syncthreads();
  if (threadIdx.y == 0 && col < N) {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float s = 0.f;
#pragma unroll
      for (int y = 0; y < 8; ++y) s += red[y][threadIdx.x][t];
      part[(size_t)blockIdx.y * N + col + t] = s;
    }
  }
}

// out[n] = sum_t x[t, n] through `splits` partials of [N] in `part`
inline cudaError_t col_sums(const void* x, float* part, float* out, int T, int N, int splits,
                            cudaStream_t stream) {
  if (T <= 0 || N <= 0 || N % 8 || splits < 1) return cudaErrorInvalidValue;
  const int rows = (T + splits - 1) / splits;
  if ((long long)rows * (splits - 1) >= T) return cudaErrorInvalidValue;
  dim3 grid((N / 8 + 31) / 32, splits), block(32, 8);
  col_sums_kernel<<<grid, block, 0, stream>>>(static_cast<const bf16*>(x), part, T, N, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(part, out, 1, splits, N, N, 0, stream);
}

// ------------------------------------------------------- backward row pass
//
// grid (bps, G): group g holds rows [g * HW, (g + 1) * HW) (a sample, for
// the affine's per-sample sums; G = 1 for the MLP half), block x of the
// group takes every bps-th run of 8 rows, one warp per row.
//
//   AFFINE = false (MLP half):   h = x;  dx = dres + LNvjp(dhn)
//   AFFINE = true  (attention):  pre = shift + x * (scale + 1),
//                                h = bf16(silu(pre)) as the forward rounds it,
//                                da = dres + LNvjp(dhn), dpre = da * silu'(pre),
//                                dx = dpre * (scale + 1)
//   LNvjp(dhn) = rstd * (dh - mean(dh) - hbar * mean(dh * hbar)), dh = dhn * gamma
//
// part[(g * bps + x), :] = [sum dhn * hbar | sum dhn | sum dpre * x | sum dpre]
// over the block's rows (the last two only when AFFINE), each C wide.
template <bool AFFINE, int MAXV>
__global__ void __launch_bounds__(256)
ln_bwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ss,
                   const bf16* __restrict__ dres, const float* __restrict__ dhn,
                   const float* __restrict__ gamma, bf16* __restrict__ dx,
                   float* __restrict__ part, int HW, int C) {
  constexpr int NC = AFFINE ? 4 : 2;
  extern __shared__ float sums[];  // [NC * C]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.y;
  for (int i = threadIdx.x; i < NC * C; i += 256) sums[i] = 0.f;

  float acc[NC][MAXV][8];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < MAXV; ++i)
#pragma unroll
      for (int t = 0; t < 8; ++t) acc[c][i][t] = 0.f;

  for (int r = blockIdx.x * 8 + warp; r < HW; r += gridDim.x * 8) {
    const size_t row = (size_t)g * HW + r;
    float h[MAXV][8], sc1[MAXV][8], pre[MAXV][8];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int k = (i * 32 + lane) * 8;
      if (k < C) {
        load8(x + row * C + k, h[i]);
        if constexpr (AFFINE) {
          float sh[8];
          load8(ss + (size_t)g * 2 * C + k, sc1[i]);
          load8(ss + (size_t)g * 2 * C + C + k, sh);
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            sc1[i][t] += 1.f;
            pre[i][t] = sh[t] + h[i][t] * sc1[i][t];
            h[i][t] = round_bf16(silu(pre[i][t]));
          }
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) s += h[i][t];
      }
    }
    const float mean = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int k = (i * 32 + lane) * 8;
      if (k < C) {
#pragma unroll
        for (int t = 0; t < 8; ++t) q += (h[i][t] - mean) * (h[i][t] - mean);
      }
    }
    const float rstd = rsqrtf(warp_sum(q) / C + kLnEps);
    // h becomes hbar; d holds dhn, then dh = dhn * gamma
    float d[MAXV][8];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int k = (i * 32 + lane) * 8;
      if (k < C) {
        float gm[8];
        load8f(dhn + row * C + k, d[i]);
        load8f(gamma + k, gm);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          h[i][t] = (h[i][t] - mean) * rstd;
          acc[0][i][t] += d[i][t] * h[i][t];
          acc[1][i][t] += d[i][t];
          d[i][t] *= gm[t];
          s1 += d[i][t];
          s2 += d[i][t] * h[i][t];
        }
      }
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int k = (i * 32 + lane) * 8;
      if (k < C) {
        float dr[8], o[8];
        load8(dres + row * C + k, dr);
        if constexpr (AFFINE) {
          float xv[8];
          load8(x + row * C + k, xv);
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const float da = dr[t] + rstd * (d[i][t] - m1 - h[i][t] * m2);
            const float dpre = da * silu_grad(pre[i][t]);
            acc[2][i][t] += dpre * xv[t];
            acc[3][i][t] += dpre;
            o[t] = dpre * sc1[i][t];
          }
        } else {
#pragma unroll
          for (int t = 0; t < 8; ++t) o[t] = dr[t] + rstd * (d[i][t] - m1 - h[i][t] * m2);
        }
        store8(dx + row * C + k, o);
      }
    }
  }

  // the block's eight warps add their sums in warp order
  for (int w = 0; w < 8; ++w) {
    __syncthreads();
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < MAXV; ++i) {
          const int k = (i * 32 + lane) * 8;
          if (k < C) {
#pragma unroll
            for (int t = 0; t < 8; ++t) sums[c * C + k + t] += acc[c][i][t];
          }
        }
    }
  }
  __syncthreads();
  float* out = part + ((size_t)g * gridDim.x + blockIdx.x) * NC * C;
  for (int i = threadIdx.x; i < NC * C; i += 256) out[i] = sums[i];
}

template <bool AFFINE>
cudaError_t launch_ln_bwd_rows(const void* x, const void* ss, const void* dres, const float* dhn,
                               const float* gamma, void* dx, float* part, int G, int HW, int C,
                               int bps, cudaStream_t stream) {
  if (G <= 0 || HW <= 0 || C <= 0 || C % 8 || C > 768 || bps < 1) return cudaErrorInvalidValue;
  const dim3 grid(bps, G);
  const size_t smem = (AFFINE ? 4 : 2) * C * sizeof(float);
  const bf16 *xp = static_cast<const bf16*>(x), *sp = static_cast<const bf16*>(ss),
             *dp = static_cast<const bf16*>(dres);
  bf16* op = static_cast<bf16*>(dx);
  if (C <= 256)
    ln_bwd_rows_kernel<AFFINE, 1><<<grid, 256, smem, stream>>>(xp, sp, dp, dhn, gamma, op, part, HW, C);
  else if (C <= 512)
    ln_bwd_rows_kernel<AFFINE, 2><<<grid, 256, smem, stream>>>(xp, sp, dp, dhn, gamma, op, part, HW, C);
  else
    ln_bwd_rows_kernel<AFFINE, 3><<<grid, 256, smem, stream>>>(xp, sp, dp, dhn, gamma, op, part, HW, C);
  return cudaGetLastError();
}

}  // namespace dsg
