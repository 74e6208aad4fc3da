// token_mlp: the MLP half of a Swin block on Hopper, over flattened tokens.
//
// Replaces the MLP half of diffusesg_tpu/ops/swin_block_v3.py::_kernel and
// the whole of diffusesg_tpu/ops/mlp_block_kernel.py::_kernel (entry
// fused_mlp_block, which v3 calls for the C=768 blocks whose MLP does not
// fuse on the TPU):
//
//   out = x + fc2(gelu_erf(fc1(LN2(x))))
//
// Three launches: LN2 per token (one warp per row, written once in bf16);
// fc1 as a GEMM with bias + exact erf-GELU in its epilogue, writing the
// [M, 4C] hidden in bf16; fc2 with bias + residual in its epilogue.
//
// Bound on the H100 at the VG shapes: operations (16 C^2 FLOP per token
// against 4 C bytes in and out, C >= 96).  The matmuls run on the tensor
// cores in bf16 with fp32 accumulation; LN2(x) (2 C bytes per token) and
// the hidden (8 C bytes) are written to device memory once and read back
// once, which keeps each GEMM a plain tile GEMM.  Keeping them on chip is
// later work.
#include "common.cuh"

using namespace dsg;

extern "C" int dsg_token_mlp(const void* x, const void* ln_g, const void* ln_b, const void* w1,
                             const void* b1, const void* w2, const void* b2, void* hn_buf,
                             void* hid_buf, void* out, int M, int C, int hidden, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RowSrc src{static_cast<const bf16*>(x), C};
  cudaError_t err = launch_ln_rows(src, static_cast<const float*>(ln_g),
                                   static_cast<const float*>(ln_b), static_cast<bf16*>(hn_buf),
                                   M, C, s);
  if (err != cudaSuccess) return err;
  GeluBf16 epi1{static_cast<bf16*>(hid_buf), static_cast<const float*>(b1), nullptr, hidden};
  err = launch_gemm<MlpFc1>(rows(hn_buf, C), epi1, static_cast<const bf16*>(w1), M, hidden, s);
  if (err != cudaSuccess) return err;
  ResidBf16 epi2{static_cast<bf16*>(out), static_cast<const float*>(b2),
                 static_cast<const bf16*>(x), C};
  return launch_gemm<MlpFc2>(rows(hid_buf, hidden), epi2, static_cast<const bf16*>(w2), M, C, s);
}
