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
#include "hopper_gemm.cuh"

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

