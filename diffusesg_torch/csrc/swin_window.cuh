// Pieces the forward and backward of the Swin attention half share: the
// noise-affine row source, the window geometry (window 8 or 10, head_dim 32),
// the map from a window's token to its raster row with the cyclic shift of
// shifted windows folded in, one softmax row, and the forward window core
// `window_attn_kernel`, a template over the window length and over where its
// operands lie (swin_attn.cu: packed qkv rows in raster order;
// window_attention.cu: separate q, k, v in [window, head, token, hd] order).
//
// A window of L tokens is padded to LP, the next multiple of the 16-row MMA
// tile (64 -> 64, 100 -> 112).  Rows L..LP-1 of Q, K, V (and dO) are ZERO in
// shared memory, score columns >= L are left out of the row max and sum and
// get probability 0, padded query rows get probability 0 everywhere and are
// never stored; rel_bias and mask stay unpadded [.., L, L] in device memory.
// A block has one warp per row tile: 4 warps at L = 64, 7 at L = 100.
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

constexpr int kHD = 32;  // head dim of every stage of both models
constexpr int kLdQ = kHD + 8;

// The window lengths the cores are instantiated for: window 8 (L = 64) and
// window 10 (L = 100).  Every entry point checks its window with this and
// dispatches `L == 64 ? core<64> : core<100>`.
inline bool window_length_supported(int L) { return L == 64 || L == 100; }

// Geometry of a window of L_ tokens in shared memory.
template <int L_>
struct WinGeom {
  static constexpr int L = L_;
  static constexpr int LP = (L + 15) / 16 * 16;  // rows and columns of the padded tiles
  static constexpr int NT = LP / 16;             // 16-row tiles = warps of a block
  static constexpr int kThreads = 32 * NT;
  static constexpr int NC = (LP + 31) / 32;  // score columns a lane owns: lane + 32 j
  static constexpr int LdS = LP + 4;         // fp32 score rows
  static constexpr int LdP = LP + 8;         // bf16 probability rows
  static constexpr int kFwdSmemBytes = 3 * LP * kLdQ * 2 + LP * LdS * 4 + LP * LdP * 2;
  static constexpr int kBwdSmemBytes = 4 * LP * kLdQ * 2 + 2 * LP * LdS * 4 + 2 * LP * LdP * 2;
};

__device__ __forceinline__ size_t window_token_row(int wi, int t, int H, int W, int window,
                                                   int shift) {
  const int nww = W / window, nw = (H / window) * nww;
  const int b = wi / nw, wl = wi % nw;
  const int y = ((wl / nww) * window + t / window + shift) % H;
  const int x = ((wl % nww) * window + t % window + shift) % W;
  return ((size_t)b * H + y) * W + x;
}

// Softmax of one score row (r < L) across a warp: p[j] is the probability of
// column lane + 32 j (0 for a column >= L).  srow: the raw Q K^T row in shared
// memory; rb, mk: that row of rel_bias and of the mask (null: none).
template <class G>
__device__ __forceinline__ void softmax_row(const float* srow, const float* rb, const float* mk,
                                            float scale, int lane, float p[G::NC]) {
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < G::NC; ++j) {
    const int c = lane + 32 * j;
    p[j] = -INFINITY;
    if (c < G::L) {
      p[j] = srow[c] * scale + rb[c];
      if (mk) p[j] += mk[c];
      mx = fmaxf(mx, p[j]);
    }
  }
  mx = warp_max(mx);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < G::NC; ++j) {
    p[j] = lane + 32 * j < G::L ? expf(p[j] - mx) : 0.f;
    sum += p[j];
  }
  const float inv = 1.f / warp_sum(sum);
#pragma unroll
  for (int j = 0; j < G::NC; ++j) p[j] *= inv;
}

// Operands of the Swin block's core: packed qkv rows [M, 3C] and the output
// [M, C], both in raster order; window `wi` of the rolled grid, head h.
struct PackedWindows {
  const bf16* qkv;
  bf16* out;
  int H, W, C, window, shift;
  __device__ const bf16* src(int which, int wi, int h, int t) const {
    return qkv + window_token_row(wi, t, H, W, window, shift) * 3 * C + which * C + h * kHD;
  }
  __device__ bf16* dst(int wi, int h, int t) const {
    return out + window_token_row(wi, t, H, W, window, shift) * C + h * kHD;
  }
};

// Operands of window attention alone: q, k, v and out, each a contiguous
// [nWB, nH, L, hd] tensor.
struct SplitWindows {
  const bf16* qkv[3];
  bf16* out;
  int nH, L;
  __device__ const bf16* src(int which, int wi, int h, int t) const {
    return qkv[which] + (((size_t)wi * nH + h) * L + t) * kHD;
  }
  __device__ bf16* dst(int wi, int h, int t) const {
    return out + (((size_t)wi * nH + h) * L + t) * kHD;
  }
};

// out = softmax(scale Q K^T + rel_bias[h] (+ mask[wi % mask_n])) V for window
// blockIdx.x and head blockIdx.y.  grid (windows, heads), G::kThreads threads,
// G::kFwdSmemBytes of dynamic shared memory.
template <int L, class Lay>
__global__ void __launch_bounds__(WinGeom<L>::kThreads)
window_attn_kernel(Lay lay, const float* __restrict__ rel_bias, const float* __restrict__ mask,
                   int mask_n, float scale) {
  using namespace nvcuda;
  using G = WinGeom<L>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + G::LP * kLdQ;
  bf16* Vs = Ks + G::LP * kLdQ;
  float* Ss = reinterpret_cast<float*>(Vs + G::LP * kLdQ);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + G::LP * G::LdS);

  const int wi = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = warp * 16;

  // this window's q, k, v for head h: LP tokens x 3 x 4 vectors of 8, the
  // padded tokens zero
  for (int i = tid; i < G::LP * 3 * (kHD / 8); i += G::kThreads) {
    const int t = i / (3 * (kHD / 8)), rest = i % (3 * (kHD / 8));
    const int which = rest / (kHD / 8), d = (rest % (kHD / 8)) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (t < L) u = *reinterpret_cast<const uint4*>(lay.src(which, wi, h, t) + d);
    *reinterpret_cast<uint4*>(Qs + which * G::LP * kLdQ + t * kLdQ + d) = u;
  }
  __syncthreads();

  // S = Q K^T: warp w owns rows 16w..16w+15, all LP columns
  {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[G::NT];
#pragma unroll
    for (int j = 0; j < G::NT; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < kHD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, Qs + row0 * kLdQ + kk, kLdQ);
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, Ks + j * 16 * kLdQ + kk, kLdQ);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < G::NT; ++j)
      wmma::store_matrix_sync(Ss + row0 * G::LdS + j * 16, acc[j], G::LdS, wmma::mem_row_major);
  }
  __syncwarp();

  // softmax over each of this warp's rows (max per head and row)
  const float* rb = rel_bias + (size_t)h * L * L;
  const float* mk = mask ? mask + (size_t)(wi % mask_n) * L * L : nullptr;
  for (int r = row0; r < row0 + 16; ++r) {
    float p[G::NC];
    if (r < L) {
      softmax_row<G>(Ss + r * G::LdS, rb + r * L, mk ? mk + r * L : nullptr, scale, lane, p);
    } else {
#pragma unroll
      for (int j = 0; j < G::NC; ++j) p[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < G::NC; ++j)
      if (lane + 32 * j < G::LP) Ps[r * G::LdP + lane + 32 * j] = __float2bfloat16(p[j]);
  }
  __syncwarp();

  // O = P V: warp w owns rows 16w..16w+15, both 16-column halves of hd
  {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
#pragma unroll
    for (int kk = 0; kk < G::LP; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, Ps + row0 * G::LdP + kk, G::LdP);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Vs + kk * kLdQ + j * 16, kLdQ);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Ss + row0 * G::LdS + j * 16, acc[j], G::LdS, wmma::mem_row_major);
  }
  __syncwarp();

  // write this warp's rows (those that are tokens) x 32 columns
  for (int i = lane; i < 16 * (kHD / 8); i += 32) {
    const int t = row0 + i / (kHD / 8), d = (i % (kHD / 8)) * 8;
    if (t >= L) continue;
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = Ss[t * G::LdS + d + q];
    store8(lay.dst(wi, h, t) + d, v);
  }
}

// Launch of the forward core for window length L; the block's shared memory
// passes the 48 KB static limit at L = 100, so it is dynamic and opted into.
template <int L, class Lay>
cudaError_t launch_window_attn(const Lay& lay, const float* rel_bias, const float* mask,
                               int mask_n, float scale, int n_windows, int num_heads,
                               cudaStream_t s) {
  using G = WinGeom<L>;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(window_attn_kernel<L, Lay>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           G::kFwdSmemBytes);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  if (n_windows <= 0 || num_heads <= 0 || num_heads > 65535) return cudaErrorInvalidValue;
  dim3 grid(n_windows, num_heads);
  window_attn_kernel<L, Lay><<<grid, G::kThreads, G::kFwdSmemBytes, s>>>(lay, rel_bias, mask,
                                                                        mask_n > 0 ? mask_n : 1,
                                                                        scale);
  return cudaGetLastError();
}

}  // namespace dsg
