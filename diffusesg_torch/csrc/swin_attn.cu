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
//   3. the window-attention core, one block per (window, head): scores
//      Q K^T on the tensor cores, + relative-position bias (+ the -100 shift
//      mask), softmax with a max per head and row, P V;
//   4. the proj GEMM, bias and the residual a in its epilogue.
// The cyclic roll of shifted windows is folded into the core's index math:
// window token (r, c) of the rolled grid reads and writes raster position
// ((r + shift) % H, (c + shift) % W), and every other step is per token, so
// the block consumes and produces the unrolled layout and no roll is copied.
//
// Bound on the H100 at the VG shapes: operations.  Per token the block does
// 8 C^2 + 4 L C multiply-adds against 4 C bytes of activations in and out,
// far above the card's ~295 FLOP/byte ridge for C >= 96.  The design keeps
// the matmuls on the tensor cores (bf16 in, fp32 accumulate) and the
// per-window score matrix in shared memory; between the launches it writes
// a, LN1(a), qkv and the attention output in bf16 (6 C + 3 C bytes per
// token), which the fully fused form of later work removes.
#include "common.cuh"

namespace dsg {

// Row source: a = bf16(silu(shift + x * (scale + 1))); emit stores a, which
// the residual needs again.
struct AffineSrc {
  const bf16* x;   // [M, C]
  const bf16* ss;  // [B, 2C]  scale | shift
  bf16* a;         // [M, C]   output: the noise affine
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
  __device__ void emit(int m, int k, const float* v) const { store8(a + (size_t)m * C + k, v); }
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

// grid (B * nW, nH), 128 threads.  qkv [M, 3C] raster order, out [M, C].
__global__ void __launch_bounds__(128)
window_attn_kernel(const bf16* __restrict__ qkv, const float* __restrict__ rel_bias,
                   const float* __restrict__ mask, bf16* __restrict__ out, int H, int W, int C,
                   int window, int shift, float scale) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 Qs[kL * kLdQ];
  __shared__ __align__(128) bf16 Ks[kL * kLdQ];
  __shared__ __align__(128) bf16 Vs[kL * kLdQ];
  __shared__ __align__(128) float Ss[kL * kLdS];
  __shared__ __align__(128) bf16 Ps[kL * kLdP];

  const int wi = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nw = (H / window) * (W / window);

  // gather this window's q, k, v for head h: 64 tokens x 3 x 4 vectors of 8
  for (int i = tid; i < kL * 3 * (kHD / 8); i += 128) {
    const int t = i / (3 * (kHD / 8)), rest = i % (3 * (kHD / 8));
    const int which = rest / (kHD / 8), d = (rest % (kHD / 8)) * 8;
    const size_t row = window_token_row(wi, t, H, W, window, shift);
    const uint4 u =
        *reinterpret_cast<const uint4*>(qkv + row * 3 * C + which * C + h * kHD + d);
    bf16* dst = which == 0 ? Qs : (which == 1 ? Ks : Vs);
    *reinterpret_cast<uint4*>(dst + t * kLdQ + d) = u;
  }
  __syncthreads();

  // S = Q K^T: warp w owns rows 16w..16w+15, all 64 columns
  {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < kHD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, Qs + warp * 16 * kLdQ + kk, kLdQ);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, Ks + j * 16 * kLdQ + kk, kLdQ);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Ss + warp * 16 * kLdS + j * 16, acc[j], kLdS, wmma::mem_row_major);
  }
  __syncwarp();

  // softmax over each of this warp's rows (max per head and row)
  const float* rb = rel_bias + (size_t)h * kL * kL;
  const float* mk = mask ? mask + (size_t)(wi % nw) * kL * kL : nullptr;
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    float s0 = Ss[r * kLdS + lane] * scale + rb[r * kL + lane];
    float s1 = Ss[r * kLdS + lane + 32] * scale + rb[r * kL + lane + 32];
    if (mk) {
      s0 += mk[r * kL + lane];
      s1 += mk[r * kL + lane + 32];
    }
    const float mx = warp_max(fmaxf(s0, s1));
    const float e0 = expf(s0 - mx), e1 = expf(s1 - mx);
    const float inv = 1.f / warp_sum(e0 + e1);
    Ps[r * kLdP + lane] = __float2bfloat16(e0 * inv);
    Ps[r * kLdP + lane + 32] = __float2bfloat16(e1 * inv);
  }
  __syncwarp();

  // O = P V: warp w owns rows 16w..16w+15, both 16-column halves of hd
  {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
#pragma unroll
    for (int kk = 0; kk < kL; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, Ps + warp * 16 * kLdP + kk, kLdP);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Vs + kk * kLdQ + j * 16, kLdQ);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Ss + warp * 16 * kLdS + j * 16, acc[j], kLdS, wmma::mem_row_major);
  }
  __syncwarp();

  // write this warp's 16 rows x 32 columns back to raster order
  for (int i = lane; i < 16 * (kHD / 8); i += 32) {
    const int t = warp * 16 + i / (kHD / 8), d = (i % (kHD / 8)) * 8;
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = Ss[t * kLdS + d + q];
    const size_t row = window_token_row(wi, t, H, W, window, shift);
    store8(out + row * C + h * kHD + d, v);
  }
}

}  // namespace dsg

using namespace dsg;

extern "C" int dsg_swin_attn(const void* x, const void* ss, const void* ln_g, const void* ln_b,
                             const void* wqkv, const void* bqkv, const void* wproj,
                             const void* bproj, const void* rel_bias, const void* mask,
                             void* a_buf, void* hn_buf, void* qkv_buf, void* attn_buf, void* out,
                             int B, int H, int W, int C, int num_heads, int window, int shift,
                             void* stream) {
  if (window * window != kL || C != num_heads * kHD || H % window || W % window) return -1;
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

  dim3 grid(B * (H / window) * (W / window), num_heads);
  window_attn_kernel<<<grid, 128, 0, s>>>(
      static_cast<const bf16*>(qkv_buf), static_cast<const float*>(rel_bias),
      static_cast<const float*>(mask), static_cast<bf16*>(attn_buf), H, W, C, window, shift,
      1.f / sqrtf((float)kHD));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  AddResidBf16 epi_p{static_cast<bf16*>(out), static_cast<const float*>(bproj),
                     static_cast<const bf16*>(a_buf), C};
  return launch_gemm<SwinProj>(rows(attn_buf, C), epi_p, static_cast<const bf16*>(wproj), M, C, s);
}
