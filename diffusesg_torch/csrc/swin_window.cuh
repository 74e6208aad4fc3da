// Pieces the forward and backward of the Swin attention half share: the
// noise-affine row source, the window geometry (window 8, head_dim 32) and
// the map from a window's token to its raster row, with the cyclic shift of
// shifted windows folded in.
#pragma once

#include "common.cuh"

namespace dsg {

// Row source: a = bf16(silu(shift + x * (scale + 1))); emit stores a, which
// the residual needs again.
struct AffineSrc {
  const bf16* x;   // [M, C]
  const bf16* ss;  // [B, 2C]  scale | shift
  bf16* a;         // [M, C]   output: the noise affine (null: not stored)
  int C, HW;
  __device__ void raw8(int m, int k, float v[8]) const {
    float xv[8], sc[8], sh[8];
    const int b = m / HW;
    load8(x + (size_t)m * C + k, xv);
    load8(ss + (size_t)b * 2 * C + k, sc);
    load8(ss + (size_t)b * 2 * C + C + k, sh);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = round_bf16(silu(sh[i] + xv[i] * (sc[i] + 1.f)));
  }
  __device__ void emit(int m, int k, const float* v) const {
    if (a) store8(a + (size_t)m * C + k, v);
  }
};

constexpr int kL = 64;   // window 8: tokens per window
constexpr int kHD = 32;  // head dim of every VG stage
constexpr int kLdQ = kHD + 8;
constexpr int kLdS = kL + 4;
constexpr int kLdP = kL + 8;

__device__ __forceinline__ size_t window_token_row(int wi, int t, int H, int W, int window,
                                                   int shift) {
  const int nww = W / window, nw = (H / window) * nww;
  const int b = wi / nw, wl = wi % nw;
  const int y = ((wl / nww) * window + t / window + shift) % H;
  const int x = ((wl % nww) * window + t % window + shift) % W;
  return ((size_t)b * H + y) * W + x;
}

}  // namespace dsg
