// swin_attn: the attention half of one Swin block on Hopper.
//
// Replaces diffusesg_tpu/ops/swin_block_v3.py::_kernel (entry
// fused_swin_block_v3), attention half:
//
//   a   = silu(shift + x * (scale + 1))                    (noise affine)
//   y   = a + proj(W-MSA(qkv(LN1(a))))                      (+ shift mask)
//
// Three launches on the caller's stream:
//   1. the qkv GEMM on wgmma (hopper_gemm.cuh, mode (a)): its prologue
//      (hg::LnPanel over AffineRows) reads x and scale_shift, forms a
//      (rounded to bf16) and LN1(a) with the row pass's two-pass statistics,
//      straight into the block's swizzled A panel; the epilogue adds bqkv
//      and stores bf16 qkv rows in raster order;
//   2. the window-attention core (window_attn_kernel, swin_window.cuh): a
//      block per head, mask class and run of windows (windows per block from
//      swin_block_v3.window_core_plan), the bias staged once in shared
//      memory, scores, softmax and probabilities in registers (mma.sync),
//      the next window's q, k, v loading while this one computes; window 8
//      (L = 64) or window 10 (L = 100: 104 score columns, 112 rows);
//   3. the proj GEMM on wgmma (mode (a)), the attention output as its panel;
//      the epilogue adds bproj and the residual a, recomputed from x and
//      scale_shift and rounded to bf16 as the prologue rounds it.
// The cyclic roll of shifted windows is folded into the core's index math:
// window token (r, c) of the rolled grid reads and writes raster position
// ((r + shift) % H, (c + shift) % W), and every other step is per token, so
// the block consumes and produces the unrolled layout and no roll is copied.
//
// Bound on the H100 at the VG and COCO shapes: operations.  Per token the
// block does 8 C^2 + 4 L C multiply-adds against 4 C bytes of activations
// in and out, far above the card's ~295 FLOP/byte ridge for C >= 96.  Between
// the launches only qkv (6 C bytes per token) and the attention output (2 C)
// go through device memory; x is read twice (prologue, residual).  Where a
// stage's 128-row tiles cannot fill the card (C768, COCO's 10x10 C384) the
// wrapper takes 64-row tiles and splits the GEMMs' N across blocks
// (swin_block_v3.attn_gemm_plan, from the tiles and occupancy
// dsg_swin_attn_gemm_tile reports), each block redoing its rows' prologue.
#include "hopper_gemm.cuh"
#include "swin_window.cuh"

using namespace dsg;

namespace {

// proj epilogue: out = bf16(a + (acc + bproj)), a recomputed from x and
// scale_shift (the plain version's one rounding of the residual sum)
struct ProjEpi : hg::RowEpi {
  bf16* out;
  const float* bias;
  const bf16* x;
  const bf16* ss;
  int C, HW;
  __device__ void put8(int m, int n, float v[8]) const {
    const size_t o = (size_t)m * C + n;
    const bf16* s = ss + (size_t)(m / HW) * 2 * C + n;
    float xv[8], sc[8], sh[8];
    ld_ro8(x + o, xv);
    ld_ro8(s, sc);
    ld_ro8(s + C, sh);
    hg::add_bias8(bias, n, v);
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = noise_affine(xv[t], sc[t], sh[t]) + v[t];
    store8(out + o, v);
  }
};

}  // namespace

extern "C" int dsg_swin_attn(const void* x, const void* ss, const void* ln_g, const void* ln_b,
                             const void* wqkv, const void* bqkv, const void* wproj,
                             const void* bproj, const void* rel_bias, const void* mask,
                             void* qkv_buf, void* attn_buf, void* out, int B, int H, int W, int C,
                             int num_heads, int window, int shift, int wpb, int wide,
                             int qkv_per, int proj_per, void* stream) {
  if (!window_length_supported(window * window) || C != num_heads * kHD || H % window ||
      W % window)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * H * W;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* ssb = static_cast<const bf16*>(ss);
  return with_tile(C, wide, [&](auto tile, auto pro) -> int {
    using T = decltype(tile);
    const decltype(pro) qkv_pro{AffineRows{xb, ssb, C, H * W}, static_cast<const float*>(ln_g),
                                static_cast<const float*>(ln_b)};
    const hg::Bf16Epi qkv_epi{{}, static_cast<bf16*>(qkv_buf), static_cast<const float*>(bqkv),
                              3 * C};
    cudaError_t err = hg::launch<T, SwinQkv>(rows(x, C), qkv_pro, qkv_epi,
                                             static_cast<const bf16*>(wqkv), M, 3 * C, qkv_per, s);
    if (err != cudaSuccess) return err;

    PackedWindows lay{static_cast<const bf16*>(qkv_buf), static_cast<bf16*>(attn_buf), H, W, C,
                      window, shift};
    const int nw = (H / window) * (W / window);
    const float* rel = static_cast<const float*>(rel_bias);
    const float* msk = static_cast<const float*>(mask);
    const float scale = 1.f / sqrtf((float)kHD);
    err = window * window == 64
              ? launch_window_attn<64>(lay, rel, msk, nw, wpb, scale, B * nw, num_heads, s)
              : launch_window_attn<100>(lay, rel, msk, nw, wpb, scale, B * nw, num_heads, s);
    if (err != cudaSuccess) return err;

    const ProjEpi proj_epi{{}, static_cast<bf16*>(out), static_cast<const float*>(bproj), xb, ssb,
                           C, H * W};
    const hg::CopyPanel attn_rows{static_cast<const bf16*>(attn_buf)};
    return hg::launch<T, SwinProj>(rows(attn_buf, C), attn_rows, proj_epi,
                                   static_cast<const bf16*>(wproj), M, C, proj_per, s);
  });
}

// The GEMM tile of the qkv (which = 0) or proj (1) launch at width C (64-row
// panels if `wide`), for the wrapper's plan: geom = {rows, columns, blocks an
// SM holds, 0}; -1 for a C no tile covers, else 0 or a CUDA error.
extern "C" int dsg_swin_attn_gemm_tile(int C, int which, int wide, int* geom) {
  return with_tile(C, wide, [&](auto tile, auto pro) -> int {
    using T = decltype(tile);
    return which == 0 ? hg::tile_query<T, SwinQkv, decltype(pro), hg::Bf16Epi>(C, geom)
                      : hg::tile_query<T, SwinProj, hg::CopyPanel, ProjEpi>(C, geom);
  });
}

// Blocks of swin_attn's window core an SM holds at window length L (the card's
// occupancy), for the wrapper's grid plan; -1 for another L or an error.
extern "C" int dsg_swin_attn_core_per_sm(int L) {
  if (!window_length_supported(L)) return -1;
  return L == 64 ? window_attn_blocks_per_sm<64, PackedWindows>()
                 : window_attn_blocks_per_sm<100, PackedWindows>();
}

