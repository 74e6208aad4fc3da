// swin_attn_bwd: backward of the attention half of a Swin block on Hopper.
//
// Replaces diffusesg_tpu/ops/swin_block_v3.py::_attn_bwd_kernel (entry
// _attn_bwd_call).  Forward (swin_attn.cu), saved: x and scale_shift only:
//
//   a = bf16(silu(shift + x * (scale + 1)));  hn = bf16(LN1(a))
//   qkv = bf16(hn Wqkv^T + bqkv);  P = softmax(scale_a Q K^T + bias (+ mask))
//   attn = bf16(bf16(P) V);  y = a + attn Wproj^T + bproj
//
// Given x, scale_shift and dy, everything is recomputed.  Every product runs
// on wgmma (hopper_gemm.cuh) or, inside the window core, on mma.sync:
//   1. hn, qkv: one launch of a Hopper GEMM with the noise affine and LN1
//      as its panel prologue (with_tile; the forward's roundings), column
//      split 0 storing hn;
//   2. dattn = bf16(dy Wproj): A streamed, Wproj read MN-major;
//   3. the window core (window_attn_bwd_kernel), per head and run of one
//      mask class's windows, as the forward core: S, P in registers; dP = dO
//      V^T; dS = P (dP - rowsum(P dP)); d(rel_bias) += dS in registers
//      across the run (one fp32 partial a block); O -> attn, dQ -> dqkv from
//      a warp's query rows; bf16 P and dS through shared memory for dK =
//      scale dS^T Q and dV = P^T dO from its key rows;
//   4. dWqkv = dqkv^T hn and dWproj = dy^T attn: the token-axis contraction,
//      split over the tokens into one buffer of partials;
//   5. col sums:  dbproj = sum dy,  dbqkv = sum dqkv;
//   6. dhn = dqkv Wqkv (fp32): A streamed, Wqkv read MN-major;
//   7. row pass:  da = dy + LN1vjp(dhn);  dpre = da * silu'(pre);
//                 dx = dpre * (scale + 1);  per-sample sums of dpre * x and
//                 dpre -> d(scale_shift);  d gamma, d beta;
//   8. reductions of every partial, in a fixed order (no atomics: bit-equal
//      from launch to launch).
// As in the forward, the cyclic roll is folded into the core's index math,
// so dy arrives and dx leaves in the unrolled layout and the mask is chosen
// by the rolled window index.
//
// Bound on the H100: operations at the VG and COCO shapes (22 C^2 + 12 L C
// FLOP per token against the bytes the launches must move: x, dy, dx, and
// hn, qkv, dattn, attn and dqkv (bf16) and dhn (fp32), each written once and
// read again by the next launch).  The products run at wgmma's rate; what
// remains far from the bound is the row pass (step 7, one warp a row) and
// the two column sums.
#include "backward.cuh"
#include "swin_window.cuh"

#define DSG_TRY(...)                       \
  do {                                     \
    cudaError_t err_ = (__VA_ARGS__);      \
    if (err_ != cudaSuccess) return err_;  \
  } while (0)

namespace dsg {

// Geometry of the backward core: the forward's (score tiles, staged bias)
// plus dO in the ring stage and bf16 P and dS of every query row, [LP][LdP].
template <int L_>
struct BwdGeom : FwdGeom<L_> {
  using F = FwdGeom<L_>;
  static constexpr int kStageElems = 4 * F::LP * kLdQ;  // q, k, v, dO of one window
  static constexpr int LdP = F::LP + 8;
  static constexpr int kSmemBytes =
      2 * kStageElems * 2 + F::LP * F::LdB * 4 + 2 * F::LP * LdP * 2;
  static constexpr int kBlocksPerSm = L_ == 64 ? 2 : 1;
};

// The backward window core.  grid (classes * blocks per class, heads), as
// the forward core (window_core_plan), BwdGeom::kThreads threads.  Block
// (x, h) stages rel_bias[h] + mask[class] once and walks its run of windows,
// q, k, v and dO double-buffered through a cp.async ring.  Warp w owns query
// rows 16w..16w+15, in registers (mma.sync):
//   S = Q K^T, P = softmax (fp32, as the forward);  dP = dO V^T;
//   dS = P (dP - rowsum(P dP));  d(rel_bias) += dS (fp32, the same registers
//   across the block's windows: one partial a block);
//   O = bf16(P) V -> attn;  dQ = scale bf16(dS) K -> dqkv;
// then bf16 P and dS go to shared memory and warp w owns keys 16w..16w+15:
//   dK = scale bf16(dS)^T Q,  dV = bf16(P)^T dO -> dqkv
// (A operands by ldmatrix.trans of the [query][key] tiles).  drel_part
// [blocks, nH, L, L].
template <int L>
__global__ void __launch_bounds__(BwdGeom<L>::kThreads, BwdGeom<L>::kBlocksPerSm)
window_attn_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dattn,
                       const float* __restrict__ rel_bias, const float* __restrict__ mask,
                       bf16* __restrict__ attn, bf16* __restrict__ dqkv,
                       float* __restrict__ drel_part, int n_windows, int classes, int wpb, int H,
                       int W, int C, int window, int shift, float scale) {
  using G = BwdGeom<L>;
  constexpr int LP = G::LP, NN = G::NN, LdP = G::LdP, KC = G::KC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  float* Bs = reinterpret_cast<float*>(ring + 2 * G::kStageElems);
  bf16* Ps = reinterpret_cast<bf16*>(Bs + LP * G::LdB);  // bf16(P) [query][key]
  bf16* dSs = Ps + LP * LdP;                            // bf16(dS) [query][key]

  const int h = blockIdx.y, cls = blockIdx.x % classes;
  const int first = blockIdx.x / classes * wpb;
  const int per_class = (n_windows - cls + classes - 1) / classes;
  const int count = min(wpb, per_class - first);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, row0 = warp * 16;

  // q, k, v and dO of run window j into ring stage j & 1: LP tokens x 4 x 4
  // vectors of 8; the padded tokens zero-filled
  auto load = [&](int j) {
    const int wi = cls + classes * (first + j);
    bf16* st = ring + (j & 1) * G::kStageElems;
    for (int i = tid; i < LP * 4 * (kHD / 8); i += G::kThreads) {
      const int tk = i / (4 * (kHD / 8)), rest = i % (4 * (kHD / 8));
      const int which = rest / (kHD / 8), d = (rest % (kHD / 8)) * 8;
      const bool ok = tk < L;  // a padded token reads nothing (token 0's address)
      const size_t row = window_token_row(wi, ok ? tk : 0, H, W, window, shift);
      const bf16* src = which < 3 ? qkv + row * 3 * C + which * C + h * kHD + d
                                  : dattn + row * C + h * kHD + d;
      cp_async16(st + which * LP * kLdQ + tk * kLdQ + d, src, ok);
    }
    cp_async_commit();
  };
  // P and dS past the score columns stay zero (read as keys LP - 8.. of dK, dV)
  for (int i = tid; i < 2 * LP * LdP / 8; i += G::kThreads)
    reinterpret_cast<uint4*>(Ps)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (count > 0) load(0);
  stage_bias<G>(Bs, rel_bias, mask, h, cls, tid);

  float drel[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) drel[n][0] = drel[n][1] = drel[n][2] = drel[n][3] = 0.f;

  for (int j = 0; j < count; ++j) {
    if (j + 1 < count) load(j + 1);
    else cp_async_commit();  // an empty group keeps the wait count uniform
    cp_async_wait<1>();      // window j has landed ...
    __syncthreads();         // ... for every thread (and, at j = 0, the bias)
    const bf16* Qs = ring + (j & 1) * G::kStageElems;
    const bf16* Ks = Qs + LP * kLdQ;
    const bf16* Vs = Ks + LP * kLdQ;
    const bf16* dOs = Vs + LP * kLdQ;
    const int wi = cls + classes * (first + j);

    float p[NN][4], sum[2];
    window_scores<G>(p, Qs, Ks, row0, lane);
    window_softmax<G>(p, sum, Bs, row0, lane, scale);
    // dP = dO V^T (V's rows as K's in S); delta = rowsum(P dP), P fp32
    float dp[NN][4];
    window_scores<G>(dp, dOs, Vs, row0, lane);
    float delta[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[n][e] *= sum[e >> 1];
        delta[e >> 1] += p[n][e] * dp[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 1);
      delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 2);
    }
    // dS = P (dP - delta) in dp; into d(rel_bias); bf16 P and dS to shared
#pragma unroll
    for (int n = 0; n < NN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[n][e] = p[n][e] * (dp[n][e] - delta[e >> 1]);
        drel[n][e] += dp[n][e];
      }
      const int c = n * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(Ps + (row0 + g) * LdP + c) = pack_bf16(p[n][0], p[n][1]);
      *reinterpret_cast<uint32_t*>(Ps + (row0 + g + 8) * LdP + c) = pack_bf16(p[n][2], p[n][3]);
      *reinterpret_cast<uint32_t*>(dSs + (row0 + g) * LdP + c) = pack_bf16(dp[n][0], dp[n][1]);
      *reinterpret_cast<uint32_t*>(dSs + (row0 + g + 8) * LdP + c) =
          pack_bf16(dp[n][2], dp[n][3]);
    }

    // O = bf16(P) V and dQ = bf16(dS) K: the accumulator tiles 2c, 2c + 1 of
    // P (dS) are the A fragment of k step c (tile NN, past the last, zero)
    float o[kHD / 8][4] = {}, dq[kHD / 8][4] = {};
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t pa[4], sa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 2 * c + half;
        pa[2 * half] = n < NN ? pack_bf16(p[n][0], p[n][1]) : 0u;
        pa[2 * half + 1] = n < NN ? pack_bf16(p[n][2], p[n][3]) : 0u;
        sa[2 * half] = n < NN ? pack_bf16(dp[n][0], dp[n][1]) : 0u;
        sa[2 * half + 1] = n < NN ? pack_bf16(dp[n][2], dp[n][3]) : 0u;
      }
#pragma unroll
      for (int d0 = 0; d0 < kHD; d0 += 16) {
        uint32_t vb[4], kb[4];  // {b0, b1} of d0.., then of d0 + 8..
        ldsm_x4_t(vb, Vs + (c * 16 + (lane & 15)) * kLdQ + d0 + (lane >> 4) * 8);
        ldsm_x4_t(kb, Ks + (c * 16 + (lane & 15)) * kLdQ + d0 + (lane >> 4) * 8);
        mma16816(o[d0 / 8], pa, vb[0], vb[1]);
        mma16816(o[d0 / 8 + 1], pa, vb[2], vb[3]);
        mma16816(dq[d0 / 8], sa, kb[0], kb[1]);
        mma16816(dq[d0 / 8 + 1], sa, kb[2], kb[3]);
      }
    }
    // this warp's query rows: attn = bf16(O), dqkv[:, q] = bf16(scale dQ)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = row0 + g + 8 * half;
      if (t < L) {
        const size_t row = window_token_row(wi, t, H, W, window, shift);
        bf16* ao = attn + row * C + h * kHD;
        bf16* qo = dqkv + row * 3 * C + h * kHD;
#pragma unroll
        for (int n = 0; n < kHD / 8; ++n) {
          const int d = n * 8 + 2 * t4;
          *reinterpret_cast<uint32_t*>(ao + d) = pack_bf16(o[n][2 * half], o[n][2 * half + 1]);
          *reinterpret_cast<uint32_t*>(qo + d) =
              pack_bf16(scale * dq[n][2 * half], scale * dq[n][2 * half + 1]);
        }
      }
    }
    __syncthreads();  // every warp's rows of P and dS are in shared memory

    // keys 16w..16w+15: dK = scale bf16(dS)^T Q, dV = bf16(P)^T dO; the A
    // fragments (key x query) by ldmatrix.trans of the [query][key] tiles
    float dk[kHD / 8][4] = {}, dv[kHD / 8][4] = {};
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t sa[4], pa[4];
      const int qr = c * 16 + (lane & 7) + ((lane >> 4) << 3), kc = row0 + ((lane >> 3) & 1) * 8;
      ldsm_x4_t(sa, dSs + qr * LdP + kc);
      ldsm_x4_t(pa, Ps + qr * LdP + kc);
#pragma unroll
      for (int d0 = 0; d0 < kHD; d0 += 16) {
        uint32_t qb[4], ob[4];
        ldsm_x4_t(qb, Qs + (c * 16 + (lane & 15)) * kLdQ + d0 + (lane >> 4) * 8);
        ldsm_x4_t(ob, dOs + (c * 16 + (lane & 15)) * kLdQ + d0 + (lane >> 4) * 8);
        mma16816(dk[d0 / 8], sa, qb[0], qb[1]);
        mma16816(dk[d0 / 8 + 1], sa, qb[2], qb[3]);
        mma16816(dv[d0 / 8], pa, ob[0], ob[1]);
        mma16816(dv[d0 / 8 + 1], pa, ob[2], ob[3]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = row0 + g + 8 * half;
      if (t < L) {
        bf16* ko = dqkv + window_token_row(wi, t, H, W, window, shift) * 3 * C + C + h * kHD;
#pragma unroll
        for (int n = 0; n < kHD / 8; ++n) {
          const int d = n * 8 + 2 * t4;
          *reinterpret_cast<uint32_t*>(ko + d) =
              pack_bf16(scale * dk[n][2 * half], scale * dk[n][2 * half + 1]);
          *reinterpret_cast<uint32_t*>(ko + C + d) =
              pack_bf16(dv[n][2 * half], dv[n][2 * half + 1]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage j & 1, P and dS
  }
  cp_async_wait<0>();

  float* out = drel_part + ((size_t)blockIdx.x * gridDim.y + h) * L * L;
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + g + 8 * (e >> 1), c = n * 8 + 2 * t4 + (e & 1);
      if (r < L && c < L) out[r * L + c] = drel[n][e];
    }
}

template <int L>
cudaError_t window_attn_bwd_opt_in() {
  static PerDevice ready;
  return ready.once([](int&) {
    return cudaFuncSetAttribute(window_attn_bwd_kernel<L>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                BwdGeom<L>::kSmemBytes);
  });
}

// Blocks of the backward core an SM holds at window length L (the card's
// occupancy); -1 on an error.
template <int L>
int window_attn_bwd_blocks_per_sm() {
  int n = 0;
  if (window_attn_bwd_opt_in<L>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, window_attn_bwd_kernel<L>,
                                                    BwdGeom<L>::kThreads,
                                                    BwdGeom<L>::kSmemBytes) != cudaSuccess)
    return -1;
  return n;
}

// The blocks of a core grid of `classes` mask classes and `wpb` windows per
// block (the d(rel_bias) partials the launch writes per head).
inline int core_blocks(int n_windows, int classes, int wpb) {
  return classes * ((n_windows / classes + wpb - 1) / wpb);
}

template <int L>
cudaError_t launch_window_attn_bwd(const bf16* qkv, const bf16* dattn, const float* rel_bias,
                                   const float* mask, bf16* attn, bf16* dqkv, float* drel_part,
                                   int n_windows, int classes, int wpb, int num_heads, int H,
                                   int W, int C, int window, int shift, float scale,
                                   cudaStream_t s) {
  using G = BwdGeom<L>;
  DSG_TRY(window_attn_bwd_opt_in<L>());
  dim3 grid(core_blocks(n_windows, classes, wpb), num_heads);
  window_attn_bwd_kernel<L><<<grid, G::kThreads, G::kSmemBytes, s>>>(
      qkv, dattn, rel_bias, mask, attn, dqkv, drel_part, n_windows, classes, wpb, H, W, C,
      window, shift, scale);
  return cudaGetLastError();
}

}  // namespace dsg

using namespace dsg;


extern "C" int dsg_swin_attn_bwd(
    const void* x, const void* ss, const void* dy, const void* ln_g, const void* ln_b,
    const void* wqkv, const void* bqkv, const void* wproj, const void* rel_bias,
    const void* mask,
    // scratch
    void* hn_buf, void* qkv_buf, void* dattn_buf, void* attn_buf, void* dqkv_buf, void* dhn_buf,
    void* part_w, void* part_bqkv, void* part_bproj, void* part_rel, void* part_rows,
    // outputs: dw [4C^2] holds dWqkv [3C, C] then dWproj [C, C]
    void* dx, void* dss, void* dgamma_dbeta, void* dw, void* dbqkv, void* dbproj, void* drel,
    int B, int H, int W, int C, int num_heads, int window, int shift, int wide, int qkv_per,
    int dattn_per, int dhn_per, int splits_w, int kchunk_w, int splits_bqkv, int splits_bproj,
    int core_wpb, int bps, void* stream) {
  if (!window_length_supported(window * window) || C != num_heads * kHD || H % window ||
      W % window || C > 768)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int HW = H * W, M = B * HW;
  const int nw = (H / window) * (W / window), n_windows = B * nw;
  const int classes = mask ? nw : 1;
  if (core_wpb < 1) return -1;
  const float* gamma = static_cast<const float*>(ln_g);
  float* dhn = static_cast<float*>(dhn_buf);

  // hn and qkv recomputed: the forward's qkv GEMM (noise affine + LN1 its
  // panel prologue), hn stored from column split 0
  const int rc = with_tile(C, wide, [&](auto tile, auto pro) -> int {
    using Pro = hg::StoreRows<decltype(pro)>;
    const Pro qkv_pro{{AffineRows{static_cast<const bf16*>(x), static_cast<const bf16*>(ss), C, HW},
                       gamma, static_cast<const float*>(ln_b)},
                      static_cast<bf16*>(hn_buf)};
    const hg::Bf16Epi epi{{}, static_cast<bf16*>(qkv_buf), static_cast<const float*>(bqkv), 3 * C};
    return hg::launch<decltype(tile), SwinBwdQkv>(rows(x, C), qkv_pro, epi,
                                                  static_cast<const bf16*>(wqkv), M, 3 * C,
                                                  qkv_per, s);
  });
  if (rc != 0) return rc;
  const hg::Bf16Epi epi_da{{}, static_cast<bf16*>(dattn_buf), nullptr, C};
  DSG_TRY(hg::launch<hg::StreamRowsT, SwinBwdDattn>(rows(dy, C), hg::NoPanel{}, epi_da,
                                                     static_cast<const bf16*>(wproj), M, C,
                                                     dattn_per, s));

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
                                           n_windows, classes, core_wpb, num_heads, H, W, C,
                                           window, shift, scale, s)
              : launch_window_attn_bwd<100>(qkv_c, dattn_c, rel, msk, attn_o, dqkv_o, rel_part,
                                            n_windows, classes, core_wpb, num_heads, H, W, C,
                                            window, shift, scale, s));
  const int rel_n = num_heads * window * window * window * window;
  DSG_TRY(reduce_partials(rel_part, static_cast<float*>(drel), 1,
                          core_blocks(n_windows, classes, core_wpb), rel_n, (size_t)rel_n, 0, s));

  // dWqkv [3C, C] = dqkv^T hn and dWproj [C, C] = dy^T attn, one partial buffer
  const size_t ld = (size_t)4 * C * C;
  float* pw = static_cast<float*>(part_w);
  DSG_TRY(launch_wgrad<SwinBwdDwqkv>(dqkv_buf, hn_buf, pw, ld, 3 * C, C, M, splits_w, kchunk_w, s));
  DSG_TRY(launch_wgrad<SwinBwdDwproj>(dy, attn_buf, pw + (size_t)3 * C * C, ld, C, C, M, splits_w,
                                      kchunk_w, s));
  DSG_TRY(reduce_partials(pw, static_cast<float*>(dw), 1, splits_w, 4 * C * C, ld, 0, s));
  DSG_TRY(col_sums(dy, static_cast<float*>(part_bproj), static_cast<float*>(dbproj), M, C,
                   splits_bproj, s));
  DSG_TRY(col_sums(dqkv_buf, static_cast<float*>(part_bqkv), static_cast<float*>(dbqkv), M, 3 * C,
                   splits_bqkv, s));

  const hg::F32Epi epi_dhn{{}, dhn, C};
  DSG_TRY(hg::launch<hg::StreamRowsT, SwinBwdDhn>(rows(dqkv_buf, 3 * C), hg::NoPanel{}, epi_dhn,
                                                   static_cast<const bf16*>(wqkv), M, C, dhn_per,
                                                   s));
  float* rows_part = static_cast<float*>(part_rows);  // [B * bps, 4C]
  DSG_TRY(launch_ln_bwd_rows<true>(x, ss, dy, dhn, gamma, dx, rows_part, B, HW, C, bps, s));
  DSG_TRY(reduce_partials(rows_part, static_cast<float*>(dgamma_dbeta), 1, B * bps, 2 * C,
                          (size_t)4 * C, 0, s));
  return reduce_partials(rows_part, static_cast<float*>(dss), B, bps, 2 * C, (size_t)4 * C, 2 * C,
                         s);
}

// The tiles of swin_attn_bwd's GEMM launches at width C, for the wrapper's
// plan: which = 0 the qkv recompute (64-row panels if `wide`), 1 the
// streamed products (dy Wproj, dqkv Wqkv), 2 the weight gradients (C output
// columns); geom = {rows, columns, blocks an SM holds, 0}; -1 for a C no
// tile covers.
extern "C" int dsg_swin_attn_bwd_tile(int C, int which, int wide, int* geom) {
  switch (which) {
    case 0:
      return with_tile(C, wide, [&](auto tile, auto pro) -> int {
        return hg::tile_query<decltype(tile), SwinBwdQkv, hg::StoreRows<decltype(pro)>,
                              hg::Bf16Epi>(C, geom);
      });
    case 1:
      return hg::tile_query<hg::StreamRowsT, SwinBwdDattn, hg::NoPanel, hg::Bf16Epi>(C, geom);
    case 2:
      return wgrad_tile<SwinBwdDwqkv>(C, geom);
    default:
      return -1;
  }
}

// Blocks of the backward window core an SM holds at window length L, for the
// wrapper's grid plan (window_core_plan); -1 for another L or an error.
extern "C" int dsg_swin_attn_bwd_core_per_sm(int L) {
  if (!window_length_supported(L)) return -1;
  return L == 64 ? window_attn_bwd_blocks_per_sm<64>() : window_attn_bwd_blocks_per_sm<100>();
}
