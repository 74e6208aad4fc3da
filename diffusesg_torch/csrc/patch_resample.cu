// patch_merge / patch_breakup: the U-Net's stage resampling on Hopper.
//
// patch_merge replaces diffusesg_tpu/ops/patch_resample.py::_merge_kernel
// (entry fused_patch_merge): 2x2 space-to-depth with the h-offset fastest,
// [x(0,0), x(1,0), x(0,1), x(1,1)], then LayerNorm(4C), then Linear 4C->2C
// without bias.  Two launches: a row preparation that gathers the four
// neighbours by index math and normalizes them (one warp per merged token,
// written once in bf16), then the WMMA tile GEMM (common.cuh).
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

// Row source for merged token m = (b, i, j) of the H/2 x W/2 grid, k in [0, 4C).
struct MergeSrc {
  const bf16* x;  // [B, H, W, C]
  int H, W, C;
  __device__ void raw8(int m, int k, float v[8]) const {
    const int wo2 = W / 2, ho2 = H / 2;
    const int j = m % wo2, i = (m / wo2) % ho2, b = m / (wo2 * ho2);
    const int q = k / C, ch = k % C;
    const int ho = q & 1, wo = q >> 1;
    load8(x + (((size_t)b * H + 2 * i + ho) * W + 2 * j + wo) * C + ch, v);
  }
};

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
                               void* a_buf, void* out, int B, int H, int W, int C, int c_out,
                               void* stream) {
  if (H % 2 || W % 2 || C % 8) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * (H / 2) * (W / 2);
  MergeSrc src{static_cast<const bf16*>(x), H, W, C};
  cudaError_t err = launch_ln_rows(src, static_cast<const float*>(ln_g),
                                   static_cast<const float*>(ln_b), static_cast<bf16*>(a_buf),
                                   M, 4 * C, s);
  if (err != cudaSuccess) return err;
  StoreBf16 epi{static_cast<bf16*>(out), nullptr, c_out};
  return launch_gemm<MergeProj>(rows(a_buf, 4 * C), epi, static_cast<const bf16*>(w), M, c_out, s);
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
