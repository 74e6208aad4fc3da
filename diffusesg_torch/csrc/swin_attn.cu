// swin_attn: the attention half of one Swin block on Hopper.
//
// Replaces diffusesg_tpu/ops/swin_block_v3.py::_kernel (entry
// fused_swin_block_v3), attention half:
//
//   a   = silu(shift + x * (scale + 1))                    (noise affine)
//   y   = a + proj(W-MSA(qkv(LN1(a))))                      (+ shift mask)
//
// Four launches on the caller's stream:
//   1. row preparation, one warp per token: the noise affine a (written, the
//      residual needs it) and LN1(a), in registers, written once in bf16;
//   2. the qkv GEMM, bias in its epilogue;
//   3. the window-attention core (window_attn_kernel, swin_window.cuh), one
//      block per (window, head): scores Q K^T on the tensor cores, +
//      relative-position bias (+ the -100 shift mask), softmax with a max per
//      head and row, P V; window 8 (L = 64) or window 10 (L = 100, padded to
//      112 rows in shared memory);
//   4. the proj GEMM, bias and the residual a in its epilogue.
// The cyclic roll of shifted windows is folded into the core's index math:
// window token (r, c) of the rolled grid reads and writes raster position
// ((r + shift) % H, (c + shift) % W), and every other step is per token, so
// the block consumes and produces the unrolled layout and no roll is copied.
//
// Bound on the H100 at the VG and COCO shapes: operations.  Per token the block does
// 8 C^2 + 4 L C multiply-adds against 4 C bytes of activations in and out,
// far above the card's ~295 FLOP/byte ridge for C >= 96.  The design keeps
// the matmuls on the tensor cores (bf16 in, fp32 accumulate) and the
// per-window score matrix in shared memory; between the launches it writes
// a, LN1(a), qkv and the attention output in bf16 (6 C + 3 C bytes per
// token), which the fully fused form of later work removes.
#include "swin_window.cuh"

using namespace dsg;

extern "C" int dsg_swin_attn(const void* x, const void* ss, const void* ln_g, const void* ln_b,
                             const void* wqkv, const void* bqkv, const void* wproj,
                             const void* bproj, const void* rel_bias, const void* mask,
                             void* a_buf, void* hn_buf, void* qkv_buf, void* attn_buf, void* out,
                             int B, int H, int W, int C, int num_heads, int window, int shift,
                             void* stream) {
  if (!window_length_supported(window * window) || C != num_heads * kHD || H % window ||
      W % window)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * H * W;
  AffineSrc src{static_cast<const bf16*>(x), static_cast<const bf16*>(ss),
                static_cast<bf16*>(a_buf), C, H * W};
  cudaError_t err = launch_ln_rows(src, static_cast<const float*>(ln_g),
                                   static_cast<const float*>(ln_b), static_cast<bf16*>(hn_buf),
                                   M, C, s);
  if (err != cudaSuccess) return err;

  StoreBf16 epi_qkv{static_cast<bf16*>(qkv_buf), static_cast<const float*>(bqkv), nullptr,
                    3 * C};
  err = launch_gemm<SwinQkv>(rows(hn_buf, C), epi_qkv, static_cast<const bf16*>(wqkv), M, 3 * C, s);
  if (err != cudaSuccess) return err;

  PackedWindows lay{static_cast<const bf16*>(qkv_buf), static_cast<bf16*>(attn_buf), H, W, C,
                    window, shift};
  const int nw = (H / window) * (W / window);
  const float* rel = static_cast<const float*>(rel_bias);
  const float* msk = static_cast<const float*>(mask);
  const float scale = 1.f / sqrtf((float)kHD);
  err = window * window == 64
            ? launch_window_attn<64>(lay, rel, msk, nw, scale, B * nw, num_heads, s)
            : launch_window_attn<100>(lay, rel, msk, nw, scale, B * nw, num_heads, s);
  if (err != cudaSuccess) return err;

  AddResidBf16 epi_p{static_cast<bf16*>(out), static_cast<const float*>(bproj),
                     static_cast<const bf16*>(a_buf), C};
  return launch_gemm<SwinProj>(rows(attn_buf, C), epi_p, static_cast<const bf16*>(wproj), M, C, s);
}
