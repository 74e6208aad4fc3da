// Shared pieces of the backward kernels (token_mlp_bwd, swin_attn_bwd):
//
//   * the weight gradients dW[i, j] = sum_t a[t, i] b[t, j], a contraction
//     over the token axis (K = tokens, up to 262,144 at batch 64) with a
//     small output, run on the wgmma GEMM (hopper_gemm.cuh) with both
//     operands read MN-major as TMA brings them, 64 tokens a box: the tile
//     is 128 x 96 or 128 x 192 (`with_tokens_tile`), K is split over the
//     grid's z so that the output tiles times the splits fill the card (the
//     plan is Python's, from the tile and occupancy `tokens_tile` reports),
//     and each split writes an fp32 partial;
//   * epilogues of the backward's products on the same GEMM (the MLP's
//     recompute and the GELU's vjp where the chain is not fused);
//   * col_sums: per-column sums over tokens of a bf16 [T, N] matrix (the
//     bias gradients), as per-block partials;
//   * ln_bwd_rows: the row pass that closes the attention half (and the MLP
//     half where it is not fused): the LayerNorm vjp per token (one warp per
//     row, statistics recomputed in fp32), the noise affine's vjp for the
//     attention half, and the sums over tokens (d gamma, d beta, d scale,
//     d shift) kept by each warp's row group in shared memory across a
//     block's rows, added in a fixed order and written once per block;
//   * reduce_partials: out[g, i] = sum_s part[(g * S + s) * ld + off + i].
//
// Every reduction over tokens is two-phase (per-block fp32 partials, then
// one reduction in a fixed order): no atomics, so every gradient is the same
// bit for bit from run to run.
#pragma once

#include <cuda_fp16.h>

#include "hopper_gemm.cuh"

namespace dsg {

// Call sites of the backward kernels (kernel names in a profile): the fused
// MLP row tile, and the products on the wgmma GEMM
struct MlpBwdFused {};
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

// gelu(v) = v Phi(v) and its derivative Phi(v) + v phi(v), from one erf
__device__ __forceinline__ void gelu_and_grad(float v, float& m, float& g) {
  const float cdf = 0.5f * (1.f + erff(v * 0.70710678118654752f));
  m = v * cdf;
  g = cdf + v * 0.3989422804014327f * expf(-0.5f * v * v);
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

// fc1 recomputed (the MLP chain): u = acc + b1; m = gelu(u) in bf16 and
// gelu'(u) in fp16 (values in [-0.13, 1.13]: fp16 keeps 11 bits where bf16
// keeps 8).
struct GeluAndGradEpi : hg::RowEpi {
  bf16* m;
  __half* gp;
  const float* bias;
  int N;
  __device__ void put8(int r, int n, float v[8]) const {
    hg::add_bias8(bias, n, v);
    float gv[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) gelu_and_grad(v[t], v[t], gv[t]);
    const size_t base = (size_t)r * N + n;
    store8(m + base, v);
    store8h(gp + base, gv);
  }
};

// du = bf16(acc * gelu'(u))
struct MulGradEpi : hg::RowEpi {
  bf16* out;
  const __half* gp;
  int N;
  __device__ void put8(int r, int n, float v[8]) const {
    const size_t base = (size_t)r * N + n;
    float g[8];
    load8h(gp + base, g);
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] *= g[t];
    store8(out + base, v);
  }
};

// ------------------------------------------------- the weight gradients

// The token-axis tile of a weight gradient with J output columns: 192
// columns a tile where they divide J, else 96; `f` gets a value of the tile.
template <class F>
int with_tokens_tile(int J, F f) {
  if (J <= 0 || J % 8) return -1;
  if (J % 192 == 0) return f(hg::TokensN192{});
  return f(hg::TokensN96{});
}

// part[z] = a^T b over split z's tokens (a [T, I], b [T, J], fp32 partials
// [I, J] at part + z * ld), on the tile with_tokens_tile picks.
template <class Site>
cudaError_t launch_wgrad(const void* a, const void* b, float* part, size_t ld, int I, int J,
                         int T, int splits, int kchunk, cudaStream_t s) {
  const hg::PartialEpi epi{{}, part, J, ld};
  return (cudaError_t)with_tokens_tile(J, [&](auto tile) -> int {
    return hg::launch<decltype(tile), Site>(GemmA{static_cast<const bf16*>(a), nullptr, T, 0},
                                            hg::NoPanel{}, epi, static_cast<const bf16*>(b), I,
                                            J, 1, s, splits, kchunk);
  });
}

// The tile of a weight gradient with J columns for the wrapper's split plan:
// geom = {rows, columns, blocks an SM holds, 0}; -1 for a J no tile covers.
template <class Site>
int wgrad_tile(int J, int* geom) {
  return with_tokens_tile(J, [&](auto tile) -> int {
    return hg::tile_query<decltype(tile), Site, hg::NoPanel, hg::PartialEpi>(64, geom);
  });
}

// ------------------------------------------------------------ reductions

// out[g * N + i] = sum_{s < S} part[(g * S + s) * ld + off + i]; grid
// (ceil(N / X), G), block (X, Y): (32, 32) where S >= 128, (32, 8) where
// S >= 8, else (256, 1).  Row lane y sums the splits s = y, y + Y, ... of
// column i (a lane's loads in flight together), and the Y lanes' sums are
// added in the order y = 0, 1, ..., a fixed order, so the result is the same
// bit for bit from run to run.
static __global__ void __launch_bounds__(1024)
reduce_partials_kernel(const float* __restrict__ part, float* __restrict__ out, int S, int N,
                       size_t ld, int off) {
  __shared__ float red[32][33];
  const int i = blockIdx.x * blockDim.x + threadIdx.x, g = blockIdx.y;
  float acc = 0.f;
  if (i < N) {
    const float* p = part + (size_t)g * S * ld + off + i;
#pragma unroll 4
    for (int s = threadIdx.y; s < S; s += blockDim.y) acc += p[(size_t)s * ld];
  }
  if (blockDim.y == 1) {
    if (i < N) out[(size_t)g * N + i] = acc;
    return;
  }
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && i < N) {
    float v = red[0][threadIdx.x];
    for (int y = 1; y < blockDim.y; ++y) v += red[y][threadIdx.x];
    out[(size_t)g * N + i] = v;
  }
}

inline cudaError_t reduce_partials(const float* part, float* out, int G, int S, int N, size_t ld,
                                   int off, cudaStream_t stream) {
  if (G <= 0 || S <= 0 || N <= 0 || G > 65535) return cudaErrorInvalidValue;
  const dim3 block(S >= 8 ? 32 : 256, S >= 128 ? 32 : S >= 8 ? 8 : 1),
      grid((N + block.x - 1) / block.x, G);
  reduce_partials_kernel<<<grid, block, 0, stream>>>(part, out, S, N, ld, off);
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
// group takes every bps-th run of 8 * (32 / LPR) rows, LPR lanes per row (16
// where C <= 128, so a warp holds two rows at once; else 32).
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
//
// The pass waits on loads: a row's x, dhn and dres come from device memory
// and its sums follow them.  So a row's loads are issued together where
// the registers allow (C <= 512), and each warp's row group keeps its
// column sums in a slice of shared memory rather than in registers, which
// leaves room for two or three blocks an SM (ln_bwd_rows_launch).
template <bool AFFINE, int MAXV, int LPR>
__global__ void __launch_bounds__(256, MAXV == 1 ? 3 : MAXV == 2 ? 2 : 1)
ln_bwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ss,
                   const bf16* __restrict__ dres, const float* __restrict__ dhn,
                   const float* __restrict__ gamma, bf16* __restrict__ dx,
                   float* __restrict__ part, int HW, int C) {
  constexpr int NC = AFFINE ? 4 : 2, RPW = 32 / LPR;  // rows a warp holds at once
  // [8 RPW][NC * C]: the column sums of each warp's row group, in order
  extern __shared__ float sums[];
  const int warp = threadIdx.x >> 5, sub = (threadIdx.x & 31) / LPR, lane = threadIdx.x % LPR;
  const int g = blockIdx.y;
  // a sum over the LPR lanes of a row
  auto row_sum = [](float v) {
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  };
  for (int i = threadIdx.x; i < 8 * RPW * NC * C; i += 256) sums[i] = 0.f;
  __syncthreads();
  float* mine = sums + (warp * RPW + sub) * NC * C;
  // mine[c][k..k+7] += a * b, or + a where b is null, each one rounding as
  // a register accumulator's fused multiply-add (a lane's own columns: no
  // other thread writes them)
  auto add8 = [&](int c, int k, const float a[8], const float* b) {
    float4* p = reinterpret_cast<float4*>(mine + c * C + k);
    float v[8];
    load8f(mine + c * C + k, v);
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = b ? __fmaf_rn(a[t], b[t], v[t]) : v[t] + a[t];
    p[0] = make_float4(v[0], v[1], v[2], v[3]);
    p[1] = make_float4(v[4], v[5], v[6], v[7]);
  };

  for (int r0 = (blockIdx.x * 8 + warp) * RPW; r0 < HW; r0 += gridDim.x * 8 * RPW) {
    const int r = r0 + sub;
    const bool live = r < HW;  // the lanes of a row past HW only join the sums
    const size_t row = (size_t)g * HW + (live ? r : r0);
    // up to C = 512 every load of the row comes first (x, dhn, dres), so
    // their latencies overlap; wider rows load dhn and dres where they are
    // used (three rows' registers would not fit)
    constexpr bool kEarly = MAXV <= 2;
    float xr[MAXV][8], d[MAXV][8], dr[MAXV][8];
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int k = (i * LPR + lane) * 8;
      if (k < C && live) {
        load8(x + row * C + k, xr[i]);
        if constexpr (kEarly) {
          load8f(dhn + row * C + k, d[i]);
          load8(dres + row * C + k, dr[i]);
        }
      }
    }
    float h[MAXV][8], sc1[MAXV][8], pre[MAXV][8];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int k = (i * LPR + lane) * 8;
      if (k < C && live) {
#pragma unroll
        for (int t = 0; t < 8; ++t) h[i][t] = xr[i][t];
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
    const float mean = row_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int k = (i * LPR + lane) * 8;
      if (k < C && live) {
#pragma unroll
        for (int t = 0; t < 8; ++t) q += (h[i][t] - mean) * (h[i][t] - mean);
      }
    }
    const float rstd = rsqrtf(row_sum(q) / C + kLnEps);
    // h becomes hbar; d holds dhn, then dh = dhn * gamma
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int k = (i * LPR + lane) * 8;
      if (k < C && live) {
        float gm[8];
        load8f(gamma + k, gm);
        if constexpr (!kEarly) load8f(dhn + row * C + k, d[i]);
#pragma unroll
        for (int t = 0; t < 8; ++t) h[i][t] = (h[i][t] - mean) * rstd;
        add8(0, k, d[i], h[i]);
        add8(1, k, d[i], nullptr);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          d[i][t] *= gm[t];
          s1 += d[i][t];
          s2 += d[i][t] * h[i][t];
        }
      }
    }
    const float m1 = row_sum(s1) / C, m2 = row_sum(s2) / C;
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int k = (i * LPR + lane) * 8;
      if (k < C && live) {
        float o[8];
        if constexpr (!kEarly) {
          load8(dres + row * C + k, dr[i]);
          if constexpr (AFFINE) load8(x + row * C + k, xr[i]);
        }
        if constexpr (AFFINE) {
          float dp[8];
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const float da = dr[i][t] + rstd * (d[i][t] - m1 - h[i][t] * m2);
            dp[t] = da * silu_grad(pre[i][t]);
            o[t] = dp[t] * sc1[i][t];
          }
          add8(2, k, dp, xr[i]);
          add8(3, k, dp, nullptr);
        } else {
#pragma unroll
          for (int t = 0; t < 8; ++t) o[t] = dr[i][t] + rstd * (d[i][t] - m1 - h[i][t] * m2);
        }
        store8(dx + row * C + k, o);
      }
    }
  }

  // the block's eight warps' sums in warp order, a warp's row groups in
  // order within it
  __syncthreads();
  float* out = part + ((size_t)g * gridDim.x + blockIdx.x) * NC * C;
  for (int i = threadIdx.x; i < NC * C; i += 256) {
    float v = 0.f;
    for (int q = 0; q < 8 * RPW; ++q) v += sums[q * NC * C + i];
    out[i] = v;
  }
}

// The row pass's shared memory (its row groups' column sums), opted in past
// the 48 KB default once on each device.
template <bool AFFINE, int MAXV, int LPR>
cudaError_t ln_bwd_rows_launch(dim3 grid, const bf16* x, const bf16* ss, const bf16* dres,
                               const float* dhn, const float* gamma, bf16* dx, float* part, int HW,
                               int C, cudaStream_t stream) {
  constexpr int NC = AFFINE ? 4 : 2;
  const size_t smem = (size_t)8 * (32 / LPR) * NC * C * sizeof(float);
  static PerDevice ready;
  const cudaError_t err = ready.once([](int&) {
    return cudaFuncSetAttribute(ln_bwd_rows_kernel<AFFINE, MAXV, LPR>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                8 * (32 / LPR) * NC * (8 * LPR * MAXV) * (int)sizeof(float));
  });
  if (err != cudaSuccess) return err;
  ln_bwd_rows_kernel<AFFINE, MAXV, LPR><<<grid, 256, smem, stream>>>(x, ss, dres, dhn, gamma, dx,
                                                                     part, HW, C);
  return cudaGetLastError();
}

template <bool AFFINE>
cudaError_t launch_ln_bwd_rows(const void* x, const void* ss, const void* dres, const float* dhn,
                               const float* gamma, void* dx, float* part, int G, int HW, int C,
                               int bps, cudaStream_t stream) {
  if (G <= 0 || HW <= 0 || C <= 0 || C % 8 || C > 768 || bps < 1) return cudaErrorInvalidValue;
  const dim3 grid(bps, G);
  const bf16 *xp = static_cast<const bf16*>(x), *sp = static_cast<const bf16*>(ss),
             *dp = static_cast<const bf16*>(dres);
  bf16* op = static_cast<bf16*>(dx);
  if (C <= 128)
    return ln_bwd_rows_launch<AFFINE, 1, 16>(grid, xp, sp, dp, dhn, gamma, op, part, HW, C, stream);
  if (C <= 256)
    return ln_bwd_rows_launch<AFFINE, 1, 32>(grid, xp, sp, dp, dhn, gamma, op, part, HW, C, stream);
  if (C <= 512)
    return ln_bwd_rows_launch<AFFINE, 2, 32>(grid, xp, sp, dp, dhn, gamma, op, part, HW, C, stream);
  return ln_bwd_rows_launch<AFFINE, 3, 32>(grid, xp, sp, dp, dhn, gamma, op, part, HW, C, stream);
}

}  // namespace dsg
