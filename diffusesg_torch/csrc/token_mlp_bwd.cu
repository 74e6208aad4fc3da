// token_mlp_bwd: backward of the MLP half of a Swin block on Hopper.
//
// Replaces diffusesg_tpu/ops/mlp_block_kernel.py::_mlp_bwd_kernel (entry
// mlp_bwd_call) and ::_mlp_bwd_export_kernel, the variant the TPU needs at
// C = 768 because fp32 dW1/dW2 do not fit its VMEM.  On this card every
// intermediate streams through device memory anyway, so all four widths take
// the same launches and the weight gradients of C = 768 are computed here
// too, by the same split-K GEMM.
//
// Forward:  out = x + fc2(gelu_erf(fc1(LN(x)))),  saved: x only.
// Given x, dout [M, C]:
//   1. row pass:  hn = bf16(LN(x))                        (as the forward)
//   2. GEMM:      u = hn W1^T + b1;  m = bf16(gelu(u)), gp = fp16(gelu'(u))
//   3. GEMM:      du = bf16((dout W2) * gp)               (W2 untransposed)
//   4. GEMM^T:    dW2 = dout^T m,  dW1 = du^T hn          (K = tokens, split)
//   5. col sums:  db2 = sum dout,  db1 = sum du
//   6. GEMM:      dhn = du W1  (fp32)                     (W1 untransposed)
//   7. row pass:  dx = dout + LNvjp(dhn);  d gamma, d beta partials
//   8. reductions of every partial, in a fixed order.
// The GELU derivative is that of the exact erf form the forward uses.
//
// Bound on the H100 at the VG shapes: operations (five M x C x 4C products,
// 40 C^2 FLOP per token against 6 C bytes of x, dout and dx).  The products
// run on the tensor cores (bf16 in, fp32 accumulate); hn, m, gp, du (bf16 or
// fp16) and dhn (fp32) pass through device memory once each, which fusing the
// chain would remove.
#include "backward.cuh"

using namespace dsg;

#define DSG_TRY(expr)                      \
  do {                                     \
    cudaError_t err_ = (expr);             \
    if (err_ != cudaSuccess) return err_;  \
  } while (0)

extern "C" int dsg_token_mlp_bwd(
    const void* x, const void* dout, const void* ln_g, const void* ln_b, const void* w1,
    const void* b1, const void* w2,
    // scratch
    void* hn_buf, void* m_buf, void* gp_buf, void* du_buf, void* dhn_buf, void* part_w1,
    void* part_w2, void* part_b1, void* part_b2, void* part_ln,
    // outputs
    void* dx, void* dgamma_dbeta, void* dw1, void* db1, void* dw2, void* db2,
    int M, int C, int hidden, int splits_w, int splits_b1, int splits_b2, int ln_blocks,
    void* stream) {
  if (C % 8 || hidden % 8 || C > 768) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gamma = static_cast<const float*>(ln_g);
  float* dhn = static_cast<float*>(dhn_buf);

  RowSrc src{static_cast<const bf16*>(x), C};
  DSG_TRY(launch_ln_rows(src, gamma, static_cast<const float*>(ln_b),
                         static_cast<bf16*>(hn_buf), M, C, s));
  GeluAndGradEpi epi1{static_cast<bf16*>(m_buf), static_cast<__half*>(gp_buf),
                      static_cast<const float*>(b1), hidden};
  DSG_TRY(launch_gemm<MlpBwdFc1>(rows(hn_buf, C), epi1, static_cast<const bf16*>(w1), M, hidden, s));
  MulGradEpi epi2{static_cast<bf16*>(du_buf), static_cast<const __half*>(gp_buf), hidden};
  DSG_TRY(launch_gemm_nn<MlpBwdDm>(dout, w2, epi2, M, hidden, C, s));

  // dW2 [C, hidden] = dout^T m;  dW1 [hidden, C] = du^T hn
  DSG_TRY(launch_gemm_tn<MlpBwdDw2>(dout, m_buf, static_cast<float*>(part_w2), C, hidden, M,
                                    splits_w, s));
  DSG_TRY(reduce_partials(static_cast<const float*>(part_w2), static_cast<float*>(dw2), 1,
                          splits_w, C * hidden, (size_t)C * hidden, 0, s));
  DSG_TRY(launch_gemm_tn<MlpBwdDw1>(du_buf, hn_buf, static_cast<float*>(part_w1), hidden, C, M,
                                    splits_w, s));
  DSG_TRY(reduce_partials(static_cast<const float*>(part_w1), static_cast<float*>(dw1), 1,
                          splits_w, C * hidden, (size_t)C * hidden, 0, s));
  DSG_TRY(col_sums(dout, static_cast<float*>(part_b2), static_cast<float*>(db2), M, C,
                   splits_b2, s));
  DSG_TRY(col_sums(du_buf, static_cast<float*>(part_b1), static_cast<float*>(db1), M, hidden,
                   splits_b1, s));

  StoreF32 epi3{dhn, nullptr, nullptr, C};
  DSG_TRY(launch_gemm_nn<MlpBwdDhn>(du_buf, w1, epi3, M, C, hidden, s));
  DSG_TRY(launch_ln_bwd_rows<false>(x, nullptr, dout, dhn, gamma, dx,
                                    static_cast<float*>(part_ln), 1, M, C, ln_blocks, s));
  return reduce_partials(static_cast<const float*>(part_ln), static_cast<float*>(dgamma_dbeta), 1,
                         ln_blocks, 2 * C, (size_t)2 * C, 0, s);
}
