// swin_attn_bwd: backward of the attention half of a Swin block on Hopper.
//
// Replaces diffusesg_tpu/ops/swin_block_v3.py::_attn_bwd_kernel (entry
// _attn_bwd_call).  Forward (swin_attn.cu), saved: x and scale_shift only:
//
//   a = bf16(silu(shift + x * (scale + 1)));  hn = bf16(LN1(a))
//   qkv = bf16(hn Wqkv^T + bqkv);  P = softmax(scale_a Q K^T + bias (+ mask))
//   attn = bf16(bf16(P) V);  y = a + attn Wproj^T + bproj
//
// Given x, scale_shift and dy, everything is recomputed:
//   1. row pass + GEMM:  hn, qkv                         (as the forward)
//   2. GEMM:             dattn = bf16(dy Wproj)          (Wproj untransposed)
//   3. window core, per (window, head), all in shared memory at L = 64 or
//      L = 100 (padded to 112 rows and columns, swin_window.cuh), head_dim 32:
//      S, P, O = bf16(P) V -> attn;  dP = dO V^T;
//      dS = P * (dP - rowsum(P * dP));  dQ = scale_a dS K;  dK = scale_a dS^T Q;
//      dV = bf16(P)^T dO -> dqkv;  d(rel_bias)[head] += dS in registers over
//      the windows a block walks, one fp32 partial per block
//   4. GEMM^T (K = tokens, split):  dWproj = dy^T attn,  dWqkv = dqkv^T hn
//   5. col sums:         dbproj = sum dy,  dbqkv = sum dqkv
//   6. GEMM:             dhn = dqkv Wqkv  (fp32)
//   7. row pass:         da = dy + LN1vjp(dhn);  dpre = da * silu'(pre);
//                        dx = dpre * (scale + 1);  per-sample sums of dpre * x
//                        and dpre -> d(scale_shift);  d gamma, d beta
//   8. reductions of every partial, in a fixed order.
// rowsum(P * dP) equals rowsum(dO * O), the softmax vjp's usual form.  As in
// the forward, the cyclic roll is folded into the core's index math, so dy
// arrives and dx leaves in the unrolled layout and the mask is chosen by the
// rolled window index.  d(rel_bias) is written as [nH, L, L] directly.
//
// Bound on the H100 at the VG and COCO shapes: operations (22 C^2 + 12 L C
// FLOP per token against 6 C bytes of x, dy and dx).  Every product runs on
// the tensor cores (bf16 in, fp32 accumulate); the softmax, its vjp and all sums over
// tokens are fp32.  hn, qkv, dattn, attn, dqkv (bf16) and dhn (fp32) pass
// through device memory once each.
#include "backward.cuh"
#include "swin_window.cuh"

namespace dsg {

// This warp's 16 rows x 32 columns of fp32 `stage` (row stride G::LdS),
// scaled, to the raster rows of window `wi` at column `col` of `out` (row
// stride ld); padded rows are not tokens and are skipped.
template <class G>
__device__ __forceinline__ void store_rows(const float* stage, bf16* out, int ld, int col,
                                           float mul, int warp, int lane, int wi, int H, int W,
                                           int window, int shift) {
  for (int i = lane; i < 16 * (kHD / 8); i += 32) {
    const int t = warp * 16 + i / (kHD / 8), d = (i % (kHD / 8)) * 8;
    if (t >= G::L) continue;
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = stage[t * G::LdS + d + q] * mul;
    store8(out + window_token_row(wi, t, H, W, window, shift) * ld + col + d, v);
  }
}

// grid (nblk, nH), G::kThreads threads (one warp per 16-row tile),
// G::kBwdSmemBytes of dynamic shared memory.  Block x walks windows x,
// x + nblk, ...; drel_part [nblk, nH, L, L].
template <int L>
__global__ void __launch_bounds__(WinGeom<L>::kThreads)
window_attn_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dattn,
                       const float* __restrict__ rel_bias, const float* __restrict__ mask,
                       bf16* __restrict__ attn, bf16* __restrict__ dqkv,
                       float* __restrict__ drel_part, int n_windows, int H, int W, int C,
                       int window, int shift, float scale) {
  using namespace nvcuda;
  using G = WinGeom<L>;
  constexpr int LP = G::LP, LdS = G::LdS, LdP = G::LdP;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + LP * kLdQ;
  bf16* Vs = Ks + LP * kLdQ;
  bf16* dOs = Vs + LP * kLdQ;
  float* Ss = reinterpret_cast<float*>(dOs + LP * kLdQ);  // P in fp32
  float* Ds = Ss + LP * LdS;                              // dP, then a staging tile
  bf16* Ps = reinterpret_cast<bf16*>(Ds + LP * LdS);      // bf16(P)
  bf16* dSs = Ps + LP * LdP;                              // bf16(dS)

  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nw = (H / window) * (W / window);
  const float* rb = rel_bias + (size_t)h * L * L;
  const int row0 = warp * 16;

  float drel[16][G::NC];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int j = 0; j < G::NC; ++j) drel[r][j] = 0.f;

  for (int wi = blockIdx.x; wi < n_windows; wi += gridDim.x) {
    __syncthreads();  // the previous window's readers are done with the tiles
    // gather q, k, v and dO of head h: LP tokens x 4 matrices x 4 vectors of
    // 8, the padded tokens zero
    for (int i = tid; i < LP * 4 * (kHD / 8); i += G::kThreads) {
      const int t = i / (4 * (kHD / 8)), rest = i % (4 * (kHD / 8));
      const int which = rest / (kHD / 8), d = (rest % (kHD / 8)) * 8;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (t < L) {
        const size_t row = window_token_row(wi, t, H, W, window, shift);
        const bf16* src = which < 3 ? qkv + row * 3 * C + which * C + h * kHD + d
                                    : dattn + row * C + h * kHD + d;
        u = *reinterpret_cast<const uint4*>(src);
      }
      *reinterpret_cast<uint4*>(Qs + which * LP * kLdQ + t * kLdQ + d) = u;
    }
    __syncthreads();

    // S = Q K^T: warp w owns rows 16w..16w+15
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
        wmma::store_matrix_sync(Ss + row0 * LdS + j * 16, acc[j], LdS, wmma::mem_row_major);
    }
    __syncwarp();

    // softmax per row, as the forward: P fp32 stays in Ss, bf16(P) to Ps;
    // padded rows and columns hold 0
    const float* mk = mask ? mask + (size_t)(wi % nw) * L * L : nullptr;
    for (int r = row0; r < row0 + 16; ++r) {
      float p[G::NC];
      if (r < L) {
        softmax_row<G>(Ss + r * LdS, rb + r * L, mk ? mk + r * L : nullptr, scale, lane, p);
      } else {
#pragma unroll
        for (int j = 0; j < G::NC; ++j) p[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < G::NC; ++j) {
        const int c = lane + 32 * j;
        if (c < LP) {
          Ss[r * LdS + c] = p[j];
          Ps[r * LdP + c] = __float2bfloat16(p[j]);
        }
      }
    }
    __syncwarp();

    // O = bf16(P) V -> attn (the proj weight gradient needs it)
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
      wmma::fill_fragment(acc[0], 0.f);
      wmma::fill_fragment(acc[1], 0.f);
#pragma unroll
      for (int kk = 0; kk < LP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, Ps + row0 * LdP + kk, LdP);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, Vs + kk * kLdQ + j * 16, kLdQ);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Ds + row0 * LdS + j * 16, acc[j], LdS, wmma::mem_row_major);
    }
    __syncwarp();
    store_rows<G>(Ds, attn, C, h * kHD, 1.f, warp, lane, wi, H, W, window, shift);
    __syncwarp();

    // dP = dO V^T (zero in the padded columns: V's padded rows are zero)
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[G::NT];
#pragma unroll
      for (int j = 0; j < G::NT; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < kHD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, dOs + row0 * kLdQ + kk, kLdQ);
#pragma unroll
        for (int j = 0; j < G::NT; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, Vs + j * 16 * kLdQ + kk, kLdQ);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < G::NT; ++j)
        wmma::store_matrix_sync(Ds + row0 * LdS + j * 16, acc[j], LdS, wmma::mem_row_major);
    }
    __syncwarp();

    // dS = P * (dP - rowsum(P * dP)), fp32; into the bias gradient and, bf16, dSs
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row0 + rr;
      float pv[G::NC], dv[G::NC];
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < G::NC; ++j) {
        const int c = lane + 32 * j;
        const bool in = r < L && c < L;
        pv[j] = in ? Ss[r * LdS + c] : 0.f;
        dv[j] = in ? Ds[r * LdS + c] : 0.f;
        dot += pv[j] * dv[j];
      }
      const float delta = warp_sum(dot);
#pragma unroll
      for (int j = 0; j < G::NC; ++j) {
        const int c = lane + 32 * j;
        const float ds = pv[j] * (dv[j] - delta);
        drel[rr][j] += ds;
        if (c < LP) dSs[r * LdP + c] = __float2bfloat16(ds);
      }
    }
    __syncthreads();  // dK and dV read every warp's rows of dSs and Ps

    // dQ = scale dS K (rows: queries)
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
      wmma::fill_fragment(acc[0], 0.f);
      wmma::fill_fragment(acc[1], 0.f);
#pragma unroll
      for (int kk = 0; kk < LP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, dSs + row0 * LdP + kk, LdP);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, Ks + kk * kLdQ + j * 16, kLdQ);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Ds + row0 * LdS + j * 16, acc[j], LdS, wmma::mem_row_major);
    }
    __syncwarp();
    store_rows<G>(Ds, dqkv, 3 * C, h * kHD, scale, warp, lane, wi, H, W, window, shift);
    __syncwarp();

    // dK = scale dS^T Q and dV = bf16(P)^T dO (rows: keys)
#pragma unroll
    for (int which = 1; which <= 2; ++which) {
      const bf16* lhs = which == 1 ? dSs : Ps;  // read transposed
      const bf16* rhs = which == 1 ? Qs : dOs;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
      wmma::fill_fragment(acc[0], 0.f);
      wmma::fill_fragment(acc[1], 0.f);
#pragma unroll
      for (int kk = 0; kk < LP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
        wmma::load_matrix_sync(fa, lhs + kk * LdP + row0, LdP);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, rhs + kk * kLdQ + j * 16, kLdQ);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Ds + row0 * LdS + j * 16, acc[j], LdS, wmma::mem_row_major);
      __syncwarp();
      store_rows<G>(Ds, dqkv, 3 * C, which * C + h * kHD, which == 1 ? scale : 1.f, warp, lane,
                    wi, H, W, window, shift);
      __syncwarp();
    }
  }

  float* out = drel_part + ((size_t)blockIdx.x * gridDim.y + h) * L * L;
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    if (row0 + rr >= L) continue;
#pragma unroll
    for (int j = 0; j < G::NC; ++j)
      if (lane + 32 * j < L) out[(row0 + rr) * L + lane + 32 * j] = drel[rr][j];
  }
}

template <int L>
cudaError_t launch_window_attn_bwd(const bf16* qkv, const bf16* dattn, const float* rel_bias,
                                   const float* mask, bf16* attn, bf16* dqkv, float* drel_part,
                                   int n_windows, int core_blocks, int num_heads, int H, int W,
                                   int C, int window, int shift, float scale, cudaStream_t s) {
  using G = WinGeom<L>;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(window_attn_bwd_kernel<L>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           G::kBwdSmemBytes);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  dim3 grid(core_blocks, num_heads);
  window_attn_bwd_kernel<L><<<grid, G::kThreads, G::kBwdSmemBytes, s>>>(
      qkv, dattn, rel_bias, mask, attn, dqkv, drel_part, n_windows, H, W, C, window, shift, scale);
  return cudaGetLastError();
}

}  // namespace dsg

using namespace dsg;

#define DSG_TRY(expr)                      \
  do {                                     \
    cudaError_t err_ = (expr);             \
    if (err_ != cudaSuccess) return err_;  \
  } while (0)

extern "C" int dsg_swin_attn_bwd(
    const void* x, const void* ss, const void* dy, const void* ln_g, const void* ln_b,
    const void* wqkv, const void* bqkv, const void* wproj, const void* rel_bias,
    const void* mask,
    // scratch
    void* hn_buf, void* qkv_buf, void* dattn_buf, void* attn_buf, void* dqkv_buf, void* dhn_buf,
    void* part_wqkv, void* part_wproj, void* part_bqkv, void* part_bproj, void* part_rel,
    void* part_rows,
    // outputs
    void* dx, void* dss, void* dgamma_dbeta, void* dwqkv, void* dbqkv, void* dwproj,
    void* dbproj, void* drel,
    int B, int H, int W, int C, int num_heads, int window, int shift, int splits_wqkv,
    int splits_wproj, int splits_bqkv, int splits_bproj, int core_blocks, int bps,
    void* stream) {
  if (!window_length_supported(window * window) || C != num_heads * kHD || H % window ||
      W % window || C > 768)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int HW = H * W, M = B * HW;
  const int n_windows = B * (H / window) * (W / window);
  if (core_blocks < 1 || core_blocks > n_windows) return -1;
  const float* gamma = static_cast<const float*>(ln_g);
  float* dhn = static_cast<float*>(dhn_buf);

  AffineSrc src{static_cast<const bf16*>(x), static_cast<const bf16*>(ss), C, HW};
  DSG_TRY(launch_ln_rows(src, gamma, static_cast<const float*>(ln_b),
                         static_cast<bf16*>(hn_buf), M, C, s));
  StoreBf16 epi_qkv{static_cast<bf16*>(qkv_buf), static_cast<const float*>(bqkv), 3 * C};
  DSG_TRY(launch_gemm<SwinBwdQkv>(rows(hn_buf, C), epi_qkv, static_cast<const bf16*>(wqkv), M,
                                  3 * C, s));
  StoreBf16 epi_da{static_cast<bf16*>(dattn_buf), nullptr, C};
  DSG_TRY(launch_gemm_nn<SwinBwdDattn>(dy, wproj, epi_da, M, C, C, s));

  const float scale = 1.f / sqrtf((float)kHD);
  const bf16* qkv_c = static_cast<const bf16*>(qkv_buf);
  const bf16* dattn_c = static_cast<const bf16*>(dattn_buf);
  const float* rel = static_cast<const float*>(rel_bias);
  const float* msk = static_cast<const float*>(mask);
  bf16* attn_o = static_cast<bf16*>(attn_buf);
  bf16* dqkv_o = static_cast<bf16*>(dqkv_buf);
  float* rel_part = static_cast<float*>(part_rel);
  DSG_TRY(window * window == 64
              ? launch_window_attn_bwd<64>(qkv_c, dattn_c, rel, msk, attn_o, dqkv_o, rel_part,
                                           n_windows, core_blocks, num_heads, H, W, C, window,
                                           shift, scale, s)
              : launch_window_attn_bwd<100>(qkv_c, dattn_c, rel, msk, attn_o, dqkv_o, rel_part,
                                            n_windows, core_blocks, num_heads, H, W, C, window,
                                            shift, scale, s));
  const int rel_n = num_heads * window * window * window * window;
  DSG_TRY(reduce_partials(rel_part, static_cast<float*>(drel), 1, core_blocks, rel_n,
                          (size_t)rel_n, 0, s));

  // dWproj [C, C] = dy^T attn;  dWqkv [3C, C] = dqkv^T hn
  DSG_TRY(launch_gemm_tn<SwinBwdDwproj>(dy, attn_buf, static_cast<float*>(part_wproj), C, C, M,
                                        splits_wproj, s));
  DSG_TRY(reduce_partials(static_cast<const float*>(part_wproj), static_cast<float*>(dwproj), 1,
                          splits_wproj, C * C, (size_t)C * C, 0, s));
  DSG_TRY(launch_gemm_tn<SwinBwdDwqkv>(dqkv_buf, hn_buf, static_cast<float*>(part_wqkv), 3 * C, C,
                                       M, splits_wqkv, s));
  DSG_TRY(reduce_partials(static_cast<const float*>(part_wqkv), static_cast<float*>(dwqkv), 1,
                          splits_wqkv, 3 * C * C, (size_t)3 * C * C, 0, s));
  DSG_TRY(col_sums(dy, static_cast<float*>(part_bproj), static_cast<float*>(dbproj), M, C,
                   splits_bproj, s));
  DSG_TRY(col_sums(dqkv_buf, static_cast<float*>(part_bqkv), static_cast<float*>(dbqkv), M, 3 * C,
                   splits_bqkv, s));

  StoreF32 epi_dhn{dhn, nullptr, C};
  DSG_TRY(launch_gemm_nn<SwinBwdDhn>(dqkv_buf, wqkv, epi_dhn, M, C, 3 * C, s));
  float* rows_part = static_cast<float*>(part_rows);  // [B * bps, 4C]
  DSG_TRY(launch_ln_bwd_rows<true>(x, ss, dy, dhn, gamma, dx, rows_part, B, HW, C, bps, s));
  DSG_TRY(reduce_partials(rows_part, static_cast<float*>(dgamma_dbeta), 1, B * bps, 2 * C,
                          (size_t)4 * C, 0, s));
  return reduce_partials(rows_part, static_cast<float*>(dss), B, bps, 2 * C, (size_t)4 * C, 2 * C,
                         s);
}
