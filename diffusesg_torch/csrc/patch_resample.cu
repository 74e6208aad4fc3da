// patch_merge / patch_breakup: the U-Net's stage resampling on Hopper.
//
// patch_merge replaces diffusesg_tpu/ops/patch_resample.py::_merge_kernel
// (entry fused_patch_merge): 2x2 space-to-depth with the h-offset fastest,
// [x(0,0), x(1,0), x(0,1), x(1,1)], then LayerNorm(4C), then Linear 4C->2C
// without bias.  Two launches: a row preparation that gathers the four
// neighbours by index math and normalizes them (one warp per merged token,
// written once in bf16), then the tile GEMM.
//
// patch_breakup replaces diffusesg_tpu/ops/patch_resample.py::_breakup_kernel
// (entry fused_patch_breakup): Linear Cin->4c, LayerNorm(4c), depth-to-space
// (chunk k -> ho = k % 2, wo = k // 2), LayerNorm(c), Linear c->c.  Four
// launches: the first GEMM reads [x | skip] from both sources (the U-Net's
// skip concatenation is never materialized) and writes fp32; a row pass
// applies LN1 and rounds to bf16; a second row pass scatters by
// depth-to-space index math and applies LN2; the last GEMM projects.
//
// Bound on the H100 at the VG shapes: operations at most shapes (2 * 4C * 2C
// FLOP per merged token against ~10 C bytes; the breakup's first product is
// Cin x 4c per input token), bytes for the widest-grid merge and breakup
// (C=96), where the row passes' extra bf16 round trips matter; they read and
// write 16-byte vectors so the gathers stay coalesced along the channels.
#include "common.cuh"

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
  __device__ void emit(int, int, const float*) const {}
};

// Row source over an fp32 row-major [M, K] matrix.
struct F32RowSrc {
  const float* y;
  int K;
  __device__ void raw8(int m, int k, float v[8]) const {
    const float4* p = reinterpret_cast<const float4*>(y + (size_t)m * K + k);
    const float4 a = p[0], b = p[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  __device__ void emit(int, int, const float*) const {}
};

// Row source for output token m = (b, Y, X) of the 2H x 2W grid, k in [0, c):
// channel k of chunk (wo * 2 + ho) of input token (b, Y / 2, X / 2).
struct ScatterSrc {
  const bf16* z;  // [B, H, W, 4c], LN1 already applied
  int H, W, c;
  __device__ void raw8(int m, int k, float v[8]) const {
    const int W2 = 2 * W, H2 = 2 * H;
    const int X = m % W2, Y = (m / W2) % H2, b = m / (W2 * H2);
    const int chunk = (X & 1) * 2 + (Y & 1);
    load8(z + (((size_t)b * H + (Y >> 1)) * W + (X >> 1)) * 4 * c + chunk * c + k, v);
  }
  __device__ void emit(int, int, const float*) const {}
};

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
  StoreBf16 epi{static_cast<bf16*>(out), nullptr, nullptr, c_out};
  return launch_gemm<MergeProj>(rows(a_buf, 4 * C), epi, static_cast<const bf16*>(w), M, c_out, s);
}

extern "C" int dsg_patch_breakup(const void* x, const void* skip, int C1, int C2,
                                 const void* w_in, const void* ln1_g, const void* ln1_b,
                                 const void* ln2_g, const void* ln2_b, const void* w_out,
                                 void* y_buf, void* z_buf, void* a_buf, void* out, int B, int H,
                                 int W, int dim, void* stream) {
  if (dim % 32 || C1 % 8 || C2 % 8) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * H * W, c = dim / 4;
  GemmA a{static_cast<const bf16*>(x), static_cast<const bf16*>(skip), C1, C2};
  StoreF32 epi1{static_cast<float*>(y_buf), nullptr, nullptr, dim};
  cudaError_t err = launch_gemm<BreakupIn>(a, epi1, static_cast<const bf16*>(w_in), M, dim, s);
  if (err != cudaSuccess) return err;

  F32RowSrc src1{static_cast<const float*>(y_buf), dim};
  err = launch_ln_rows(src1, static_cast<const float*>(ln1_g), static_cast<const float*>(ln1_b),
                       static_cast<bf16*>(z_buf), M, dim, s);
  if (err != cudaSuccess) return err;

  ScatterSrc src2{static_cast<const bf16*>(z_buf), H, W, c};
  err = launch_ln_rows(src2, static_cast<const float*>(ln2_g), static_cast<const float*>(ln2_b),
                       static_cast<bf16*>(a_buf), 4 * M, c, s);
  if (err != cudaSuccess) return err;

  StoreBf16 epi3{static_cast<bf16*>(out), nullptr, nullptr, c};
  return launch_gemm<BreakupOut>(rows(a_buf, c), epi3, static_cast<const bf16*>(w_out), 4 * M, c, s);
}
