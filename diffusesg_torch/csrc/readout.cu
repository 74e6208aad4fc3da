// readout: the denoiser's two-layer output heads on Hopper.
//
// Replaces diffusesg_tpu/ops/readout_kernel.py::_kernel (entry
// fused_readout_mlp):
//
//   out = gelu_erf(x @ W1^T + b1) @ W2^T + b2       W2: [out, hidden], out 1..16
//
// It is the shared tile GEMM launched twice, not token_mlp: no LayerNorm
// and no residual.  Launch 1 writes the bf16 hidden with bias + exact
// erf-GELU fused; launch 2 reads it back and writes fp32 outputs, masking
// the 1..16 real columns inside the 64-wide tile (nothing is padded in
// memory).
//
// Bound on the H100 at the VG shapes (x [B*4096, 96] and [B*64, 96]):
// bytes.  2 * 96 * 96 FLOP per token against 192 bytes in is ~96 FLOP/byte,
// below the card's ridge, so the time is the activations' traffic; the
// hidden adds one bf16 write and read of the same size, which doubles the
// bytes of the fully fused form and is the first thing to remove when this
// kernel is made fast.
#include "common.cuh"

using namespace dsg;

extern "C" int dsg_readout(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, void* hid_buf, void* out, int M, int C, int hidden,
                           int n_out, void* stream) {
  if (n_out < 1 || n_out > 16) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GeluBf16 epi1{static_cast<bf16*>(hid_buf), static_cast<const float*>(b1), hidden};
  cudaError_t err = launch_gemm<ReadoutFc1>(rows(x, C), epi1, static_cast<const bf16*>(w1), M, hidden, s);
  if (err != cudaSuccess) return err;
  StoreF32 epi2{static_cast<float*>(out), static_cast<const float*>(b2), n_out};
  return launch_gemm<ReadoutFc2>(rows(hid_buf, hidden), epi2, static_cast<const bf16*>(w2), M, n_out, s);
}
