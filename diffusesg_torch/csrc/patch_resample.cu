// patch_merge / patch_breakup: the U-Net's stage resampling on Hopper.
//
// patch_merge replaces diffusesg_tpu/ops/patch_resample.py::_merge_kernel
// (entry fused_patch_merge): 2x2 space-to-depth with the h-offset fastest,
// [x(0,0), x(1,0), x(0,1), x(1,1)], then LayerNorm(4C), then Linear 4C->2C
// without bias.  One launch of the wgmma GEMM (hopper_gemm.cuh, mode (a)):
// its prologue gathers each merged token's four neighbours by index math
// straight into the block's swizzled A panel (cp.async, every load in
// flight) and normalizes the rows in place with the row pass's arithmetic
// (hg::LnPanel: fp32, two passes, one rounding to bf16), so the
// gathered rows never reach device memory; the epilogue stores bf16.  The
// panel holds all of K = 4C: 128 rows up to K = 384 (VG 64x64), 64 rows up
// to 768 (VG 32x32, COCO 20x20, and COCO 40x40, where 128-row tiles would
// split N), and at K = 1536 (VG 16x16) 64 rows in 192 KB with one consumer
// warpgroup and a two-slot ring of W (hg::PanelDeep).  Where the row tiles
// do not fill the card the wrapper splits N (merge_plan in
// ops/patch_resample.py), each split redoing its rows' gather and LayerNorm.
//
// patch_breakup replaces diffusesg_tpu/ops/patch_resample.py::_breakup_kernel
// (entry fused_patch_breakup): Linear Cin->4c, LayerNorm(4c), depth-to-space
// (chunk k -> ho = k % 2, wo = k // 2), LayerNorm(c), Linear c->c.  Both
// products run on the wgmma GEMM (hopper_gemm.cuh).  Where 4c <= 384 (VG
// 32x32 and COCO 20x20, 384 -> 96) two launches:
//   1. the first GEMM, A = [x | skip] streamed by TMA from both sources (the
//      U-Net's skip concatenation is never materialized), one block holding
//      whole 4c-wide output rows (64 x 384); its epilogue stages the fp32
//      rows in shared memory, takes LN1 over each (fp32, two passes), rounds
//      to bf16, takes LN2 over each c-chunk and stores the four output
//      tokens' rows at their depth-to-space positions;
//   2. the second GEMM, those rows as its resident panel.
// Wider rows (4c = 768, 1536: VG 16x16 and 8x8, COCO 10x10) do not fit one
// block's registers or shared memory in fp32, so there the first GEMM writes
// fp32 rows, one row pass (breakup_rows_kernel, one warp per input token)
// does what the fused epilogue does, and the second GEMM follows: three
// launches.  The plain version takes LN1 on fp32 and LN2 on bf16, and so do
// both paths.
//
// Bound on the H100: operations at most shapes (2 * 4C * 2C FLOP per merged
// token against ~10 C bytes; the breakup's first product is Cin x 4c per
// input token), bytes for the widest-grid merge and breakup (C=96).
//
// The backwards (patch_merge_bwd, patch_breakup_bwd; the TPU differentiates
// the XLA composition, so they replace no Pallas kernel) recompute what they
// need from the saved inputs, at the plain version's precision: bf16
// operands, fp32 accumulation, fp32 LayerNorm statistics and vjps, every
// product on the wgmma GEMM, every sum over tokens two-phase (per-block fp32
// partials, then one fixed-order reduction; no atomics).
//   merge:   dhn = dy W (bf16, where the plain version rounds it); a row pass,
//            one warp a merged token, gathers its four neighbours (MergeRows),
//            recomputes LayerNorm's statistics and hn (stored for dW), takes
//            the LayerNorm vjp and scatters dx back into [B, H, W, C];
//            dW = dy^T hn over tokens.
//   breakup: y = [x | skip] W_in^T (fp32, the forward's first product
//            recomputed); dh2 = dout W_out (bf16, as the plain version
//            rounds it); a row pass, one warp an input token, recomputes
//            LN1, LN2 and h2 (stored for dW_out), takes LN2's vjp per chunk
//            with dh2 read at the depth-to-space positions (space-to-depth
//            by addressing), then LN1's vjp, and writes dy, which the plain
//            version feeds its products in fp32, as three bf16 terms whose
//            sum is its fp32 value exactly; [dx | dskip] = dy W_in (the
//            three terms against W_in stacked three times, one fp32 sum,
//            two outputs) and dW_in = dy^T [x | skip] (the terms' partials
//            added by the reduction), dW_out = dout^T h2.
// The weight gradients are written in bf16, the weights' type, as the plain
// version rounds them; the LayerNorm parameters' in fp32.  Profile names carry
// the sites' tags (MergeProj*, BreakupIn*, BreakupOut*, breakup_rows_kernel*).
// Bound on the H100: operations for the breakups (dx and dW_in, 4 Cin 4c
// FLOP an input token, about 13 % of it reached at VG 8x8), bytes for the
// merge at C = 96; the row passes are bound by their rows' bytes.
#include <type_traits>

#include "backward.cuh"

namespace dsg {

// Row source of patch_merge's panel: merged token m = (b, i, j) of the
// H/2 x W/2 grid is four pieces of C, its neighbours q = 0..3 at (2i + q % 2,
// 2j + q / 2); with t = m / (W/2) = b H/2 + i, neighbour q's pixel is
// (2t + q % 2) W + 2j + q / 2 (H even), so a row costs one division.
struct MergeRows {
  static constexpr int kPieces = 4;
  const bf16* x;  // [B, H, W, C]
  int H, W, C;
  __device__ const bf16* piece(int m, int q) const {
    const int t = m / (W / 2), j = m - t * (W / 2);
    return x + ((size_t)(2 * t + (q & 1)) * W + 2 * j + (q >> 1)) * C;
  }
  __device__ void pre8(int, int, float*) const {}
};

// The GEMM tile and prologue of patch_merge at width C (K = 4C): 128-row
// panels up to K = 384 unless `wide` (the wrapper's plan, where 128-row
// tiles would split N beyond the blocks an SM holds) asks for 64 rows, 64
// rows up to K = 768, the one-warpgroup tile up to 1536; `f` gets a value of
// the tile type and of the prologue's type.
template <class F>
int merge_tile(int C, int wide, F f) {
  const int K = 4 * C;
  if (C <= 0 || C % 8 || K > 1536) return -1;
  if (K > 768) return f(hg::PanelDeep{}, hg::LnPanel<MergeRows, 6, 2, 32>{});
  if (K > 384) return f(hg::PanelWide{}, hg::LnPanel<MergeRows, 3, 2, 32>{});
  if (wide) return f(hg::PanelWide{}, hg::LnPanel<MergeRows, 3, 2, 16>{});
  return f(hg::PanelTall{}, hg::LnPanel<MergeRows, 3, 2, 16>{});
}

// First-GEMM rows y (fp32, 4c wide; shared or device memory) of input
// tokens m -> their four output tokens each: LN1 over the row, rounded to
// bf16, LN2 over each c-chunk, stored at the depth-to-space positions (chunk
// q -> row offset q % 2, column offset q / 2 of the 2H x 2W grid).  One warp
// takes ROWS rows at once (their loads and reductions interleave); lane l
// holds columns q c + 32 t + l (c <= 32 MAXJ).
struct BreakupRows {
  bf16* a;  // [B, 2H, 2W, c]
  const float* g1;
  const float* b1;
  const float* g2;
  const float* b2;
  int H, W, c;

  // m[j] < 0: no row in slot j
  template <int MAXJ, int ROWS>
  __device__ void rows_of(const float* const (&y)[ROWS], const int (&m)[ROWS], int lane) const {
    float v[ROWS][4][MAXJ], s[ROWS], d[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      s[j] = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int t = 0; t < MAXJ; ++t) {
          const int k = 32 * t + lane;
          v[j][q][t] = k < c && m[j] >= 0 ? y[j][q * c + k] : 0.f;
          s[j] += v[j][q][t];
        }
    }
    warp_sum_n(s);
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      s[j] /= 4 * c;
      d[j] = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int t = 0; t < MAXJ; ++t)
          if (32 * t + lane < c) d[j] += (v[j][q][t] - s[j]) * (v[j][q][t] - s[j]);
    }
    warp_sum_n(d);
    float g[MAXJ], bt[MAXJ];
#pragma unroll
    for (int t = 0; t < MAXJ; ++t) {
      const int k = 32 * t + lane;
      g[t] = k < c ? ld_ro(g2 + k) : 0.f, bt[t] = k < c ? ld_ro(b2 + k) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float s2[ROWS], d2[ROWS];
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const float rstd = rsqrtf(d[j] / (4 * c) + kLnEps);
        s2[j] = 0.f;
#pragma unroll
        for (int t = 0; t < MAXJ; ++t) {
          const int k = q * c + 32 * t + lane;
          if (32 * t + lane < c) {
            v[j][q][t] = round_bf16((v[j][q][t] - s[j]) * rstd * ld_ro(g1 + k) + ld_ro(b1 + k));
            s2[j] += v[j][q][t];
          }
        }
      }
      warp_sum_n(s2);
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        s2[j] /= c;
        d2[j] = 0.f;
#pragma unroll
        for (int t = 0; t < MAXJ; ++t)
          if (32 * t + lane < c) d2[j] += (v[j][q][t] - s2[j]) * (v[j][q][t] - s2[j]);
      }
      warp_sum_n(d2);
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        if (m[j] < 0) continue;
        const float rstd2 = rsqrtf(d2[j] / c + kLnEps);
        const int x = m[j] % W, yy = (m[j] / W) % H, b = m[j] / (W * H);
        bf16* dst = a + (((size_t)b * 2 * H + 2 * yy + (q & 1)) * 2 * W + 2 * x + (q >> 1)) * c;
#pragma unroll
        for (int t = 0; t < MAXJ; ++t) {
          const int k = 32 * t + lane;
          if (k < c) dst[k] = __float2bfloat16((v[j][q][t] - s2[j]) * rstd2 * g[t] + bt[t]);
        }
      }
    }
  }
};

// The fused first GEMM's epilogue: BreakupRows over the block's staged fp32
// rows (4c <= 384), four rows a warp at a time.
struct BreakupRowsEpi : BreakupRows {
  static constexpr bool kWholeRows = true;
  __device__ void rows(const float* stage, int ld, int m0, int n, int warp, int lane) const {
    for (int r0 = warp; r0 < n; r0 += 32) {
      const float* y[4];
      int m[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        y[j] = stage + (r0 + 8 * j) * ld;
        m[j] = r0 + 8 * j < n ? m0 + r0 + 8 * j : -1;
      }
      rows_of<3, 4>(y, m, lane);
    }
  }
};

// The same over fp32 rows in device memory, one warp per input token.
template <int MAXJ>
__global__ void __launch_bounds__(256)
breakup_rows_kernel(BreakupRows e, const float* __restrict__ y, int M) {
  const int m = blockIdx.x * 8 + (threadIdx.x >> 5);
  const float* row[1] = {y + (size_t)m * 4 * e.c};
  const int mm[1] = {m < M ? m : -1};
  e.rows_of<MAXJ, 1>(row, mm, threadIdx.x & 31);
}

// Which path the first GEMM takes: whole rows in one block (4c <= 384).
inline bool breakup_fused(int dim) { return dim <= hg::StreamLine::BN; }

}  // namespace dsg

using namespace dsg;

extern "C" int dsg_patch_merge(const void* x, const void* ln_g, const void* ln_b, const void* w,
                               void* out, int B, int H, int W, int C, int c_out, int wide, int per,
                               void* stream) {
  if (H % 2 || W % 2) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * (H / 2) * (W / 2);
  return merge_tile(C, wide, [&](auto tile, auto pro) -> int {
    using T = decltype(tile);
    const decltype(pro) gather_ln{MergeRows{static_cast<const bf16*>(x), H, W, C},
                                  static_cast<const float*>(ln_g), static_cast<const float*>(ln_b)};
    const hg::Bf16Epi epi{{}, static_cast<bf16*>(out), nullptr, c_out};
    return hg::launch<T, MergeProj>(rows(x, 4 * C), gather_ln, epi, static_cast<const bf16*>(w), M,
                                    c_out, per, s);
  });
}

// The GEMM tile of patch_merge at width C (64-row panels where K <= 384 if
// `wide`), for the wrapper's plan: geom = {rows, columns, blocks an SM holds,
// 0}; -1 for a C no tile covers, else 0 or a CUDA error.
extern "C" int dsg_patch_merge_tile(int C, int wide, int* geom) {
  return merge_tile(C, wide, [&](auto tile, auto pro) -> int {
    return hg::tile_query<decltype(tile), MergeProj, decltype(pro), hg::Bf16Epi>(4 * C, geom);
  });
}

extern "C" int dsg_patch_breakup(const void* x, const void* skip, int C1, int C2,
                                 const void* w_in, const void* ln1_g, const void* ln1_b,
                                 const void* ln2_g, const void* ln2_b, const void* w_out,
                                 void* y_buf, void* a_buf, void* out, int B, int H, int W, int dim,
                                 int in_per, int out_per, void* stream) {
  if (dim % 64 || C1 % 8 || C2 % 8 || dim / 4 > 384) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * H * W, c = dim / 4;
  const GemmA a{static_cast<const bf16*>(x), static_cast<const bf16*>(skip), C1, C2};
  const BreakupRows rows_of{static_cast<bf16*>(a_buf), static_cast<const float*>(ln1_g),
                            static_cast<const float*>(ln1_b), static_cast<const float*>(ln2_g),
                            static_cast<const float*>(ln2_b), H, W, c};
  const bf16* w1 = static_cast<const bf16*>(w_in);
  cudaError_t err;
  if (breakup_fused(dim)) {
    err = hg::launch<hg::StreamLine, BreakupIn>(a, hg::NoPanel{}, BreakupRowsEpi{rows_of}, w1, M,
                                                dim, 1, s);
  } else {
    const hg::F32Epi epi1{{}, static_cast<float*>(y_buf), dim};
    err = hg::launch<hg::StreamRows, BreakupIn>(a, hg::NoPanel{}, epi1, w1, M, dim, in_per, s);
    if (err != cudaSuccess) return err;
    const dim3 grid((M + 7) / 8);
    const float* y = static_cast<const float*>(y_buf);
    if (c <= 96) breakup_rows_kernel<3><<<grid, 256, 0, s>>>(rows_of, y, M);
    else if (c <= 192) breakup_rows_kernel<6><<<grid, 256, 0, s>>>(rows_of, y, M);
    else breakup_rows_kernel<12><<<grid, 256, 0, s>>>(rows_of, y, M);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  const hg::Bf16Epi epi2{{}, static_cast<bf16*>(out), nullptr, c};
  return hg::launch<hg::PanelRows, BreakupOut>(rows(a_buf, c),
                                               hg::CopyPanel{static_cast<const bf16*>(a_buf)},
                                               epi2, static_cast<const bf16*>(w_out), 4 * M, c,
                                               out_per, s);
}

// The GEMM tiles of patch_breakup for the wrapper's plan: the first product
// (which = 0, Cin -> dim) or the second (1, c -> c); geom = {rows, columns,
// blocks an SM holds, whole rows (the fused path)}; -1 for a width no tile
// covers, else 0 or a CUDA error.
extern "C" int dsg_patch_breakup_tile(int cin, int dim, int which, int* geom) {
  if (dim % 64 || dim / 4 > 384) return -1;
  if (which == 1) return hg::tile_query<hg::PanelRows, BreakupOut, hg::CopyPanel, hg::Bf16Epi>(
      dim / 4, geom);
  return breakup_fused(dim)
             ? hg::tile_query<hg::StreamLine, BreakupIn, hg::NoPanel, BreakupRowsEpi>(cin, geom)
             : hg::tile_query<hg::StreamRows, BreakupIn, hg::NoPanel, hg::F32Epi>(cin, geom);
}


// ------------------------------------------------------------------ backward

namespace dsg {

// The backward's wide products (merge's dhn, the breakup's y and [dx |
// dskip]; N = 4C, 4c or Cin, multiples of 192 at the models' widths) run on
// hg::StreamWide and hg::StreamWideT.
using hg::StreamWide;
using hg::StreamWideT;

// Call sites of the backward (kernel names in a profile)
struct BreakupInBwdY {};
struct MergeProjBwdDhn {};
struct MergeProjBwdRows {};
struct MergeProjBwdDw {};
struct BreakupOutBwdDh {};
struct BreakupOutBwdDw {};
struct BreakupInBwdDx {};
struct BreakupInBwdDw {};
struct BreakupInBwdSums {};

// out[m, n] = bf16(acc) into two matrices side by side: columns [0, Na) of
// `a` ([M, Na]), then [0, Nb) of `b` (Na a multiple of 8)
struct SplitBf16Epi : hg::RowEpi {
  bf16* a;
  bf16* b;
  int Na, Nb;
  __device__ void put8(int m, int n, float v[8]) const {
    if (n < Na) store8(a + (size_t)m * Na + n, v);
    else store8(b + (size_t)m * Nb + n - Na, v);
  }
};

__device__ __forceinline__ void store8f(float* p, const float v[8]) {  // 16-byte aligned
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void put_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void put_out(bf16* p, float v) { *p = __float2bfloat16(v); }

// out[g * ldo + i] = sum_{s < S} part[s * lds + g * N + i] (i < N, g < G), in
// fp32 or rounded once to bf16; grid (ceil(N / X), G), block (X, Y) as
// backward.cuh's reduce_partials: row lane y sums the splits s = y, y + Y,
// ..., and the Y lanes' sums are added in the order y = 0, 1, ...: a fixed
// order, so the result is the same bit for bit from run to run
template <class Site, class Out>
__global__ void __launch_bounds__(1024)
resample_reduce_kernel(const float* __restrict__ part, Out* __restrict__ out, int S, int N,
                       size_t lds, size_t ldo) {
  __shared__ float red[32][33];
  const int i = blockIdx.x * blockDim.x + threadIdx.x, g = blockIdx.y;
  float acc = 0.f;
  if (i < N) {
    const float* p = part + (size_t)g * N + i;
#pragma unroll 4
    for (int s = threadIdx.y; s < S; s += blockDim.y) acc += p[(size_t)s * lds];
  }
  if (blockDim.y == 1) {
    if (i < N) put_out(out + (size_t)g * ldo + i, acc);
    return;
  }
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && i < N) {
    float v = red[0][threadIdx.x];
    for (int y = 1; y < blockDim.y; ++y) v += red[y][threadIdx.x];
    put_out(out + (size_t)g * ldo + i, v);
  }
}

template <class Site, class Out>
cudaError_t resample_reduce(const float* part, Out* out, int G, int S, int N, size_t lds,
                            size_t ldo, cudaStream_t stream) {
  if (G <= 0 || S <= 0 || N <= 0 || G > 65535) return cudaErrorInvalidValue;
  const dim3 block(S >= 8 ? 32 : 256, S >= 128 ? 32 : S >= 8 ? 8 : 1),
      grid((N + block.x - 1) / block.x, G);
  resample_reduce_kernel<Site, Out><<<grid, block, 0, stream>>>(part, out, S, N, lds, ldo);
  return cudaGetLastError();
}

// patch_merge's backward row pass, four warps a block, one warp a merged
// token m at a time (m = 4 blockIdx.x + warp, then every 4 gridDim.x): lane
// l holds the vectors k = 8 (32 i + l) of the K = 4C row, piece k / C of the
// gather.  LayerNorm's statistics as the forward's prologue takes them
// (fp32, two passes, each vector summed as a pairwise tree); hn =
// bf16(hbar gamma + beta) is stored for dW; with dh = dhn gamma,
//   dx = rstd (dh - mean(dh) - hbar mean(dh hbar))
// is rounded to bf16 and scattered to the pixels the row came from.  The
// sums over tokens (d gamma = sum dhn hbar, d beta = sum dhn) run in shared
// memory, a warp's own [2K] where each lane owns its columns, and the four
// warps' are added in warp order into the block's partial part[block, 2K].
template <class Site, int MAXV>
__global__ void __launch_bounds__(128)
merge_rows_bwd_kernel(const MergeRows src, const float* __restrict__ gamma,
                      const float* __restrict__ beta, const bf16* __restrict__ dhn,
                      bf16* __restrict__ hn, bf16* __restrict__ dx, float* __restrict__ part,
                      int M) {
  extern __shared__ float4 smem4[];
  float* sums = reinterpret_cast<float*>(smem4);
  const int K = 4 * src.C, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* mine = sums + warp * 2 * K;
  for (int i = lane; i < 2 * K; i += 32) mine[i] = 0.f;
  __syncwarp();
  for (int m = blockIdx.x * 4 + warp; m < M; m += gridDim.x * 4) {
    float v[MAXV][8], d[MAXV][8];
    size_t off[MAXV];
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int k = (32 * i + lane) * 8;
      off[i] = 0;
      if (k < K) {
        const int q = k / src.C;
        off[i] = (size_t)(src.piece(m, q) - src.x) + (k - q * src.C);
        load8(src.x + off[i], v[i]);
        load8(dhn + (size_t)m * K + k, d[i]);
      }
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < MAXV; ++i)
      if ((32 * i + lane) * 8 < K) s += hg::sum8(v[i]);
    const float mean = warp_sum(s) / K;
    float qd = 0.f;
#pragma unroll
    for (int i = 0; i < MAXV; ++i)
      if ((32 * i + lane) * 8 < K) qd += hg::sq_dev8(v[i], mean);
    const float rstd = rsqrtf(warp_sum(qd) / K + kLnEps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int k = (32 * i + lane) * 8;
      if (k < K) {
        float g[8], bt[8], o[8], pg[8], pb[8];
        load8f(gamma + k, g);
        load8f(beta + k, bt);
        load8f(mine + k, pg);
        load8f(mine + K + k, pb);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          v[i][t] = (v[i][t] - mean) * rstd;
          o[t] = v[i][t] * g[t] + bt[t];
          pg[t] += d[i][t] * v[i][t];
          pb[t] += d[i][t];
          d[i][t] *= g[t];
          s1 += d[i][t];
          s2 += d[i][t] * v[i][t];
        }
        store8f(mine + k, pg);
        store8f(mine + K + k, pb);
        store8(hn + (size_t)m * K + k, o);
      }
    }
    const float m1 = warp_sum(s1) / K, m2 = warp_sum(s2) / K;
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      if ((32 * i + lane) * 8 < K) {
        float o[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) o[t] = rstd * (d[i][t] - m1 - v[i][t] * m2);
        store8(dx + off[i], o);
      }
    }
  }
  __syncthreads();
  float* out = part + (size_t)blockIdx.x * 2 * K;
  for (int i = threadIdx.x; i < 2 * K; i += 128) {
    float acc = sums[i];
    for (int w = 1; w < 4; ++w) acc += sums[w * 2 * K + i];
    out[i] = acc;
  }
}

// patch_breakup's backward row pass, four warps a block, one warp an input
// token m at a time: lane l holds columns q c + 32 t + l of its 4c-wide rows
// (as BreakupRows).  From y, the first product in fp32, LN1's statistics,
// a1 = bf16(LN1(y)) and, per chunk q, LN2's statistics and h2 =
// bf16(LN2(a1_q)), each as BreakupRows takes it; h2 is stored at its
// depth-to-space position (for dW_out), and dh2 is read there.  Then
//   da1_q = rstd2 (dh - mean(dh) - xhat2 mean(dh xhat2)),  dh = dh2 gamma2,
//   dy    = rstd1 (da - mean(da) - xhat1 mean(da xhat1)),   da = da1 gamma1,
// both fp32 (da1 stays in registers), and dy is written as three bf16 terms
// [hi | mid | lo] (a [M, 12c] row), hi = bf16(dy), mid = bf16(dy - hi), lo =
// bf16(dy - hi - mid), whose sum is dy's fp32 value exactly.  The sums over
// tokens (d gamma1, d beta1 over 4c; d gamma2, d beta2 over c) run in a
// warp's own [10c] of shared memory, added in warp order into part[block].
template <int MAXJ>
__global__ void __launch_bounds__(128)
breakup_rows_kernel_bwd(const BreakupRows e, const float* __restrict__ y,
                        const bf16* __restrict__ dh, bf16* __restrict__ dy,
                        float* __restrict__ part, int M) {
  extern __shared__ float sums[];  // [4][d gamma1 4c | d beta1 4c | d gamma2 c | d beta2 c]
  const int c = e.c, D = 4 * c, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* mine = sums + warp * 10 * c;
  for (int i = lane; i < 10 * c; i += 32) mine[i] = 0.f;
  __syncwarp();
  float g2[MAXJ], b2[MAXJ];
#pragma unroll
  for (int t = 0; t < MAXJ; ++t) {
    const int k = 32 * t + lane;
    g2[t] = k < c ? ld_ro(e.g2 + k) : 0.f, b2[t] = k < c ? ld_ro(e.b2 + k) : 0.f;
  }
  // up to c = 192 a token's dh2 rows are loaded with its y row, so that their
  // latencies overlap; the widest rows load them chunk by chunk (the
  // registers of both rows would not fit beside the sums)
  constexpr bool kEarly = MAXJ <= 6;
  for (int m = blockIdx.x * 4 + warp; m < M; m += gridDim.x * 4) {
    const int px = m % e.W, py = (m / e.W) % e.H, pb = m / (e.W * e.H);
    // the output token of chunk q (depth-to-space): its row of h2 and dh2
    auto pos = [&](int q) {
      return (((size_t)pb * 2 * e.H + 2 * py + (q & 1)) * 2 * e.W + 2 * px + (q >> 1)) * c;
    };
    float xh[4][MAXJ], da[4][MAXJ];
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int t = 0; t < MAXJ; ++t) {
        const int k = 32 * t + lane;
        xh[q][t] = k < c ? y[(size_t)m * D + q * c + k] : 0.f;
        if constexpr (kEarly) da[q][t] = k < c ? __bfloat162float(dh[pos(q) + k]) : 0.f;
        s += xh[q][t];
      }
    s = warp_sum(s);
    s /= D;
    float d = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int t = 0; t < MAXJ; ++t)
        if (32 * t + lane < c) d += (xh[q][t] - s) * (xh[q][t] - s);
    d = warp_sum(d);
    const float rstd1 = rsqrtf(d / D + kLnEps);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int t = 0; t < MAXJ; ++t) xh[q][t] = (xh[q][t] - s) * rstd1;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float a[MAXJ], s2 = 0.f;
#pragma unroll
      for (int t = 0; t < MAXJ; ++t) {
        const int k = 32 * t + lane;
        a[t] = 0.f;
        if (k < c) {
          a[t] = round_bf16(xh[q][t] * ld_ro(e.g1 + q * c + k) + ld_ro(e.b1 + q * c + k));
          s2 += a[t];
        }
      }
      s2 = warp_sum(s2);
      s2 /= c;
      float d2 = 0.f;
#pragma unroll
      for (int t = 0; t < MAXJ; ++t)
        if (32 * t + lane < c) d2 += (a[t] - s2) * (a[t] - s2);
      d2 = warp_sum(d2);
      const float rstd2 = rsqrtf(d2 / c + kLnEps);
      const size_t p = pos(q);
      float s1 = 0.f, s3 = 0.f;
#pragma unroll
      for (int t = 0; t < MAXJ; ++t) {
        const int k = 32 * t + lane;
        if (k < c) {
          const float xh2 = (a[t] - s2) * rstd2;
          e.a[p + k] = __float2bfloat16(xh2 * g2[t] + b2[t]);
          const float g = kEarly ? da[q][t] : __bfloat162float(dh[p + k]);
          mine[8 * c + k] += g * xh2;
          mine[9 * c + k] += g;
          a[t] = xh2;
          da[q][t] = g * g2[t];
          s1 += da[q][t];
          s3 += da[q][t] * xh2;
        } else {
          da[q][t] = 0.f;
        }
      }
      const float m1 = warp_sum(s1) / c, m2 = warp_sum(s3) / c;
#pragma unroll
      for (int t = 0; t < MAXJ; ++t)
        if (32 * t + lane < c) da[q][t] = rstd2 * (da[q][t] - m1 - a[t] * m2);
    }
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int t = 0; t < MAXJ; ++t) {
        const int j = q * c + 32 * t + lane;
        if (32 * t + lane < c) {
          mine[j] += da[q][t] * xh[q][t];
          mine[D + j] += da[q][t];
          da[q][t] *= ld_ro(e.g1 + j);
          t1 += da[q][t];
          t2 += da[q][t] * xh[q][t];
        }
      }
    const float n1 = warp_sum(t1) / D, n2 = warp_sum(t2) / D;
    bf16* row = dy + (size_t)m * 3 * D;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int t = 0; t < MAXJ; ++t) {
        const int j = q * c + 32 * t + lane;
        if (32 * t + lane < c) {
          const float v = rstd1 * (da[q][t] - n1 - xh[q][t] * n2);
          const bf16 hi = __float2bfloat16(v);
          const float r = v - __bfloat162float(hi);
          const bf16 mid = __float2bfloat16(r);
          row[j] = hi;
          row[D + j] = mid;
          row[2 * D + j] = __float2bfloat16(r - __bfloat162float(mid));
        }
      }
  }
  __syncthreads();
  float* out = part + (size_t)blockIdx.x * 10 * c;
  for (int i = threadIdx.x; i < 10 * c; i += 128) {
    float acc = sums[i];
    for (int w = 1; w < 4; ++w) acc += sums[w * 10 * c + i];
    out[i] = acc;
  }
}

// The row passes' shared memory: four warps' sums, [2K] (merge) or [10c]
// (breakup) floats each
inline size_t merge_rows_smem(int K) { return (size_t)4 * 2 * K * sizeof(float); }
inline size_t breakup_rows_smem(int c) { return (size_t)4 * 10 * c * sizeof(float); }

// a row pass's opt-in to the shared memory of its widest rows, once on each
// device
template <class Site, int V>
cudaError_t rows_bwd_ready(const void* kernel, size_t bytes) {
  static PerDevice ready;
  return ready.once([&](int&) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  });
}

// The row passes at width K = 4C (merge) or c (breakup): `f` gets the
// vectors or columns a lane holds as a compile-time int
template <class F>
int with_merge_rows(int K, F f) {
  if (K <= 0 || K % 8 || K > 1536) return -1;
  if (K <= 256) return f(std::integral_constant<int, 1>{});
  if (K <= 512) return f(std::integral_constant<int, 2>{});
  if (K <= 768) return f(std::integral_constant<int, 3>{});
  return f(std::integral_constant<int, 6>{});
}

template <class F>
int with_breakup_rows(int c, F f) {
  if (c <= 0 || c > 384) return -1;
  if (c <= 32) return f(std::integral_constant<int, 1>{});
  if (c <= 96) return f(std::integral_constant<int, 3>{});
  if (c <= 192) return f(std::integral_constant<int, 6>{});
  return f(std::integral_constant<int, 12>{});
}

}  // namespace dsg

#define DSG_TRY(...)                       \
  do {                                     \
    cudaError_t err_ = (__VA_ARGS__);      \
    if (err_ != cudaSuccess) return err_;  \
  } while (0)

// Backward of patch_merge.  dy [M, c_out] (M = B H/2 W/2 merged tokens);
// dy_k / w_k, k wide: the operands of dhn = dy W with K a multiple of 16
// (the wrapper pads dy's columns and W's rows with zeros where c_out is
// not).  Scratch: dhn [M, 4C] bf16, hn [M, 4C] bf16, part_w [splits_w,
// c_out 4C], part_ln [rows, 8C].  Outputs: dx [B, H, W, C] bf16, dw [c_out,
// 4C] bf16, dln [8C] fp32 (d gamma | d beta).
extern "C" int dsg_patch_merge_bwd(const void* x, const void* ln_g, const void* ln_b,
                                   const void* dy, const void* dy_k, const void* w_k, int k,
                                   void* dhn_buf, void* hn_buf, void* part_w, void* part_ln,
                                   void* dx, void* dw, void* dln, int B, int H, int W, int C,
                                   int c_out, int dhn_per, int row_blocks, int splits_w,
                                   int kchunk_w, void* stream) {
  if (H % 2 || W % 2 || C % 8 || 4 * C > 1536 || c_out % 8 || k % 16 || row_blocks < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * (H / 2) * (W / 2), K = 4 * C;
  bf16* dhn = static_cast<bf16*>(dhn_buf);
  bf16* hn = static_cast<bf16*>(hn_buf);
  const hg::Bf16Epi epi{{}, dhn, nullptr, K};
  DSG_TRY(hg::launch<StreamWideT, MergeProjBwdDhn>(rows(dy_k, k), hg::NoPanel{}, epi,
                                                   static_cast<const bf16*>(w_k), M, K, dhn_per,
                                                   s));
  const int rc = with_merge_rows(K, [&](auto v) -> int {
    constexpr int V = decltype(v)::value;
    auto kernel = merge_rows_bwd_kernel<MergeProjBwdRows, V>;
    cudaError_t err =
        rows_bwd_ready<MergeProjBwdRows, V>((const void*)kernel, merge_rows_smem(1536));
    if (err != cudaSuccess) return err;
    kernel<<<row_blocks, 128, merge_rows_smem(K), s>>>(
        MergeRows{static_cast<const bf16*>(x), H, W, C}, static_cast<const float*>(ln_g),
        static_cast<const float*>(ln_b), dhn, hn, static_cast<bf16*>(dx),
        static_cast<float*>(part_ln), M);
    return cudaGetLastError();
  });
  if (rc != 0) return rc;
  const size_t ld = (size_t)c_out * K;
  float* pw = static_cast<float*>(part_w);
  DSG_TRY(launch_wgrad<MergeProjBwdDw>(dy, hn, pw, ld, c_out, K, M, splits_w, kchunk_w, s));
  DSG_TRY(resample_reduce<MergeProjBwdDw>(pw, static_cast<bf16*>(dw), 1, splits_w, c_out * K, ld,
                                          0, s));
  return resample_reduce<MergeProjBwdRows>(static_cast<const float*>(part_ln),
                                           static_cast<float*>(dln), 1, row_blocks, 2 * K, 2 * K,
                                           0, s);
}

// Backward of patch_breakup.  dout [B, 2H, 2W, c] (c = dim / 4), x [M, C1]
// and skip [M, C2] (M = B H W; skip null where C2 = 0).  Scratch: y [M, dim]
// fp32, dh [4M, c] bf16, h2 [4M, c] bf16, dy [M, 3 dim] bf16, w3 [3 dim,
// Cin] bf16, part_w [splits_out c c + splits_in 3 dim Cin], part_ln [rows,
// 10c].  Outputs: dx [M, C1], dskip [M, C2], dw_in [dim, Cin], dw_out [c, c]
// (bf16), dln [10c] fp32 (d gamma1 | d beta1 | d gamma2 | d beta2).
extern "C" int dsg_patch_breakup_bwd(
    const void* x, const void* skip, int C1, int C2, const void* w_in, const void* ln1_g,
    const void* ln1_b, const void* ln2_g, const void* ln2_b, const void* w_out, const void* dout,
    void* y_buf, void* dh_buf, void* h2_buf, void* dy_buf, void* w3_buf, void* part_w,
    void* part_ln, void* dx, void* dskip, void* dw_in, void* dw_out, void* dln, int B, int H,
    int W, int dim, int in_per, int dh_per, int dx_per, int row_blocks, int splits_out,
    int kchunk_out,
    int splits_in, int kchunk_in, void* stream) {
  if (dim % 64 || dim / 4 > 384 || C1 % 8 || C2 % 8 || (C1 + C2) % 16 || row_blocks < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * H * W, c = dim / 4, cin = C1 + C2;
  // 1. y = [x | skip] W_in^T in fp32, as the forward's wide path computes it
  const hg::F32Epi epi_y{{}, static_cast<float*>(y_buf), dim};
  DSG_TRY(hg::launch<StreamWide, BreakupInBwdY>(
      GemmA{static_cast<const bf16*>(x), static_cast<const bf16*>(skip), C1, C2}, hg::NoPanel{},
      epi_y, static_cast<const bf16*>(w_in), M, dim, in_per, s));
  // 2. dh2 = dout W_out, rounded to bf16 as the plain version rounds it
  bf16* dh = static_cast<bf16*>(dh_buf);
  const hg::Bf16Epi epi_dh{{}, dh, nullptr, c};
  DSG_TRY(hg::launch<hg::StreamRowsT, BreakupOutBwdDh>(rows(dout, c), hg::NoPanel{}, epi_dh,
                                                        static_cast<const bf16*>(w_out), 4 * M,
                                                        c, dh_per, s));
  // 3. the row pass: h2, dy, the LayerNorms' partials
  const BreakupRows e{static_cast<bf16*>(h2_buf), static_cast<const float*>(ln1_g),
                      static_cast<const float*>(ln1_b), static_cast<const float*>(ln2_g),
                      static_cast<const float*>(ln2_b), H, W, c};
  const int rc = with_breakup_rows(c, [&](auto v) -> int {
    constexpr int J = decltype(v)::value;
    auto kernel = breakup_rows_kernel_bwd<J>;
    cudaError_t err =
        rows_bwd_ready<BreakupInBwdSums, J>((const void*)kernel, breakup_rows_smem(384));
    if (err != cudaSuccess) return err;
    kernel<<<row_blocks, 128, breakup_rows_smem(c), s>>>(
        e, static_cast<const float*>(y_buf), dh, static_cast<bf16*>(dy_buf),
        static_cast<float*>(part_ln), M);
    return cudaGetLastError();
  });
  if (rc != 0) return rc;
  // 4. dW_out = dout^T h2 over the 4M output tokens
  float* pw = static_cast<float*>(part_w);
  DSG_TRY(launch_wgrad<BreakupOutBwdDw>(dout, h2_buf, pw, (size_t)c * c, c, c, 4 * M,
                                        splits_out, kchunk_out, s));
  DSG_TRY(resample_reduce<BreakupOutBwdDw>(pw, static_cast<bf16*>(dw_out), 1, splits_out, c * c,
                                           (size_t)c * c, 0, s));
  // 5. [dx | dskip] = [hi | mid | lo] [W_in; W_in; W_in]: one fp32 sum, rounded once
  bf16* w3 = static_cast<bf16*>(w3_buf);
  for (int q = 0; q < 3; ++q)
    DSG_TRY(cudaMemcpyAsync(w3 + (size_t)q * dim * cin, w_in, (size_t)dim * cin * sizeof(bf16),
                            cudaMemcpyDeviceToDevice, s));
  const SplitBf16Epi epi_dx{{}, static_cast<bf16*>(dx), static_cast<bf16*>(dskip), C1, C2};
  DSG_TRY(hg::launch<StreamWideT, BreakupInBwdDx>(rows(dy_buf, 3 * dim), hg::NoPanel{}, epi_dx,
                                                  w3, M, cin, dx_per, s));
  // 6. dW_in = dy^T [x | skip]: partials of the three terms' rows, summed by the reduction
  float* pin = pw + (size_t)splits_out * c * c;
  const size_t lx = (size_t)3 * dim * C1, ls = (size_t)3 * dim * C2;
  DSG_TRY(launch_wgrad<BreakupInBwdDw>(dy_buf, x, pin, lx, 3 * dim, C1, M, splits_in, kchunk_in,
                                       s));
  bf16* dwi = static_cast<bf16*>(dw_in);
  DSG_TRY(resample_reduce<BreakupInBwdDw>(pin, dwi, dim, 3 * splits_in, C1, (size_t)dim * C1, cin,
                                          s));
  if (C2 > 0) {
    float* pskip = pin + (size_t)splits_in * lx;
    DSG_TRY(launch_wgrad<BreakupInBwdDw>(dy_buf, skip, pskip, ls, 3 * dim, C2, M, splits_in,
                                         kchunk_in, s));
    DSG_TRY(resample_reduce<BreakupInBwdDw>(pskip, dwi + C1, dim, 3 * splits_in, C2,
                                            (size_t)dim * C2, cin, s));
  }
  return resample_reduce<BreakupInBwdSums>(static_cast<const float*>(part_ln),
                                           static_cast<float*>(dln), 1, row_blocks, 10 * c,
                                           (size_t)10 * c, 0, s);
}

// Blocks of a backward row pass an SM holds (its registers and shared
// memory): which = 0 merge's at K = width (4C), 1 the breakup's at c =
// width; -1 for a width no row pass covers, else <= 0 on a CUDA error.
extern "C" int dsg_patch_resample_bwd_rows_per_sm(int which, int width) {
  auto occupancy = [](const void* kernel, size_t smem, cudaError_t ready) -> int {
    int n = 0;
    if (ready == cudaSuccess)
      ready = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, 128, smem);
    return ready == cudaSuccess ? n : -(int)ready;
  };
  if (which == 0)
    return with_merge_rows(width, [&](auto v) -> int {
      constexpr int V = decltype(v)::value;
      const void* kernel = (const void*)merge_rows_bwd_kernel<MergeProjBwdRows, V>;
      return occupancy(kernel, merge_rows_smem(width),
                       rows_bwd_ready<MergeProjBwdRows, V>(kernel, merge_rows_smem(1536)));
    });
  return with_breakup_rows(width, [&](auto v) -> int {
    constexpr int J = decltype(v)::value;
    const void* kernel = (const void*)breakup_rows_kernel_bwd<J>;
    return occupancy(kernel, breakup_rows_smem(width),
                     rows_bwd_ready<BreakupInBwdSums, J>(kernel, breakup_rows_smem(384)));
  });
}

// The GEMM tiles of the backwards for the wrappers' plans, at K = k (the
// products) or J = k output columns (the weight gradients): which = 0
// merge's dhn, 1 merge's dW, 2 breakup's y, 3 its dh2, 4 its [dx | dskip],
// 5 its dW_out, 6 its dW_in; geom = {rows, columns, blocks an SM holds, 0};
// -1 for a width no tile covers, else 0 or a CUDA error.
extern "C" int dsg_patch_resample_bwd_tile(int which, int k, int* geom) {
  switch (which) {
    case 0:
      return hg::tile_query<StreamWideT, MergeProjBwdDhn, hg::NoPanel, hg::Bf16Epi>(k, geom);
    case 1:
      return wgrad_tile<MergeProjBwdDw>(k, geom);
    case 2:
      return hg::tile_query<StreamWide, BreakupInBwdY, hg::NoPanel, hg::F32Epi>(k, geom);
    case 3:
      return hg::tile_query<hg::StreamRowsT, BreakupOutBwdDh, hg::NoPanel, hg::Bf16Epi>(k, geom);
    case 4:
      return hg::tile_query<StreamWideT, BreakupInBwdDx, hg::NoPanel, SplitBf16Epi>(k, geom);
    case 5:
      return wgrad_tile<BreakupOutBwdDw>(k, geom);
    case 6:
      return wgrad_tile<BreakupInBwdDw>(k, geom);
    default:
      return -1;
  }
}
