// window_attention: fused window attention alone on Hopper.
//
// Replaces diffusesg_tpu/ops/window_attention.py::_fused_kernel (entry
// fused_window_attention_qkhd):
//
//   out[w, h] = softmax(scale q[w, h] k[w, h]^T + rel_bias[h] (+ mask[w % nW])) v[w, h]
//
// q, k, v and out are separate contiguous [nWB, nH, L, hd] bf16 tensors,
// rel_bias [nH, L, L] and mask [nW, L, L] fp32.  One launch of the window
// core the Swin block uses (window_attn_kernel, swin_window.cuh) with its
// second operand layout: no packed qkv rows, no window gather, no shift, the
// scale handed in.  A block serves one head and one mask class and walks a
// run of windows (swin_block_v3.window_core_plan); scores and probabilities
// stay in registers and the bias is staged once per block, so device memory
// sees q, k, v once and out once, which is what the TPU kernel keeps in VMEM
// for.  head_dim 32 with L = 64 or 100.
//
// Bound on the H100: bytes.  4 L^2 hd FLOP per window and head against
// 4 L hd 2 bytes of q, k, v, out: L / 2 = 32 to 50 FLOP per byte, far under
// the card's ~295 FLOP/byte ridge, so the design moves each operand once, in
// 16-byte cp.async loads that overlap the previous window's compute.
#include "swin_window.cuh"

using namespace dsg;

extern "C" int dsg_window_attention(const void* q, const void* k, const void* v,
                                    const void* rel_bias, const void* mask, void* out, int nwb,
                                    int num_heads, int L, int head_dim, int mask_n, int wpb,
                                    float scale, void* stream) {
  if (!window_length_supported(L) || head_dim != kHD || nwb <= 0) return -1;
  if (mask && (mask_n <= 0 || nwb % mask_n)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SplitWindows lay{{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v)},
                   static_cast<bf16*>(out), num_heads, L};
  const float* rel = static_cast<const float*>(rel_bias);
  const float* msk = static_cast<const float*>(mask);
  return L == 64 ? launch_window_attn<64>(lay, rel, msk, mask_n, wpb, scale, nwb, num_heads, s)
                 : launch_window_attn<100>(lay, rel, msk, mask_n, wpb, scale, nwb, num_heads, s);
}

// Blocks of the core an SM holds at window length L (the card's occupancy),
// for the wrapper's grid plan; -1 for another L or an error.
extern "C" int dsg_window_attention_per_sm(int L) {
  if (!window_length_supported(L)) return -1;
  return L == 64 ? window_attn_blocks_per_sm<64, SplitWindows>()
                 : window_attn_blocks_per_sm<100, SplitWindows>();
}
