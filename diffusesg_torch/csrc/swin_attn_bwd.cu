// swin_attn_bwd: backward of the attention half of a Swin block on Hopper.
//
// Replaces diffusesg_tpu/ops/swin_block_v3.py::_attn_bwd_kernel (entry
// _attn_bwd_call).  Forward (swin_attn.cu), saved: x and scale_shift only:
//
//   a = bf16(silu(shift + x * (scale + 1)));  hn = bf16(LN1(a))
//   qkv = bf16(hn Wqkv^T + bqkv);  P = softmax(scale_a Q K^T + bias (+ mask))
//   attn = bf16(bf16(P) V);  y = a + attn Wproj^T + bproj
//
// Given x, scale_shift and dy, everything is recomputed.  VG's 64x64 C96
// stage runs steps 1-3 and 5-7 as one kernel (window_attn_bwd_kernel_fused,
// below), which keeps qkv, dattn and dhn on chip; every other stage runs them
// as a chain of launches, every product on wgmma (hopper_gemm.cuh) or,
// inside the window core, on mma.sync:
//   1. hn, qkv: one launch of a Hopper GEMM with the noise affine and LN1
//      as its panel prologue (with_tile; the forward's roundings), column
//      split 0 storing hn;
//   2. dattn = bf16(dy Wproj): A streamed, Wproj read MN-major (128 x 192
//      tiles from C192, with_stream_tile);
//   3. the window core (window_attn_bwd_kernel), per head and run of one
//      mask class's windows, as the forward core: S, P in registers; dP = dO
//      V^T; dS = P (dP - rowsum(P dP)); d(rel_bias) += dS in registers
//      across the run (one fp32 partial a block); O -> attn, dQ -> dqkv from
//      a warp's query rows; bf16 P and dS through shared memory for dK =
//      scale dS^T Q and dV = P^T dO from its key rows;
//   4. dWqkv = dqkv^T hn and dWproj = dy^T attn: the token-axis contraction,
//      split over the tokens into one buffer of partials;
//   5. col sums:  dbproj = sum dy,  dbqkv = sum dqkv;
//   6. dhn = dqkv Wqkv (fp32): A streamed, Wqkv read MN-major (as step 2);
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

// The tile of the chain's streamed products dy Wproj and dqkv Wqkv (N = C,
// Wproj and Wqkv read MN-major) at width C: 128 x 192 from C192, where it
// halves the passes over A against 96 columns (on the H100 the whole
// backward launch is 3-12 % faster with it at batch 1000, and 1 % slower at
// C96, where half its columns are empty), else 128 x 96; `f` gets a value of
// the tile type.
template <class F>
int with_stream_tile(int C, F f) {
  return C >= 192 ? f(hg::StreamWideT{}) : f(hg::StreamRowsT{});
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

// ================================================ the fused window kernel
//
// window_attn_bwd_kernel_fused: steps 1-3, 5 (dbqkv), 6 and 7 above in one
// launch, for VG's 64x64 C96 stage (window 8).  Block x walks windows x, x +
// grid, ... (one block an SM), in three roles that work on different
// windows at once:
//   - two row warpgroups build window w + 1's buffers while the heads run on
//     window w: its rows through a table (window_token_row: the cyclic roll
//     is index math), the sample's scale | shift row, dy's and x's rows, and
//     the noise affine + LN1 of x's rows into a swizzled panel (hg::LnPanel,
//     the forward's roundings); then the epilogue of window w - 1, a row pass
//     over dhn handed over in shared memory: da = dy + LN1vjp(dhn), dpre =
//     da silu'(pre), dx = dpre (scale + 1), and the window's sums of dhn hbar,
//     dhn, dpre x, dpre and dy;
//   - the head warpgroup, per head: q, k, v = panel Wqkv_h^T (m64n96) and dO
//     = bf16(dy Wproj[:, head]) (m64n32) on wgmma; the backward core on
//     mma.sync as window_attn_bwd_kernel (S, P, dP = dO V^T, dS = P (dP -
//     rowsum(P dP)); d(rel_bias) added into the block's fp32 partial in
//     device memory, each element owned by one thread across the block's
//     windows; O -> attn; bf16 P and dS through shared memory for dK, dV);
//     dq, dk, dv (bf16) into a K-major swizzled tile and to dqkv, the tile's
//     column sums (dbqkv), and dhn += dqkv_h Wqkv_h (m64n64 a slice, Wqkv
//     read MN-major) in registers across the heads; hn to device memory;
//   - the producer warpgroup: warp 0 streams by TMA each head's 96 rows of
//     Wqkv and 32 rows of Wproj^T (the head's columns of Wproj) a K slice a
//     slot, then the 96 rows again for dhn; warps 1-3 stage each head's
//     rel_bias (+ mask[class]) in fp32.
// The roles hand over through mbarriers (a window's buffers ready, dhn full
// and empty); the head warpgroup takes the registers the others give up
// (setmaxnreg).  qkv, dattn and dhn never reach device memory: the launch
// writes hn, attn and dqkv (the weight gradients' operands), dx, the
// windows' partials [n_windows, 8C] and the blocks' d(rel_bias) partials;
// fixed-order reductions (reduce_partials) and the two weight gradients
// close it.  No atomics: a relaunch is bit-equal.
//
// What bounds it (clock64 stamps per phase, 64x64 C96 at batch 1000): both
// the head warpgroup (about 32,000 cycles a window) and the row warpgroups
// (about 31,000 alone: the exact SiLU, its derivative and the LN1 statistics
// twice a window, once for the panel and once for the vjp) wait on latency;
// together they share the SM's issue slots and take about 40,000.  Shared
// memory and registers bound the shapes: two windows' panels, the head's q,
// k, v, dO, P and dS, the handed-over dhn and two windows' x take 222 KB at
// C96; at C192 the panels alone double, and at C384 dhn is 96 KB, so every
// other stage (C >= 192, window 10) runs the chain.

namespace {

// The noise affine of a window's rows as the LN1 panel's source: panel row r
// is x's row rows[r]; the sample's scale | shift row is staged.
struct BwdWindowRows {
  static constexpr int kPieces = 1;
  const bf16* x;
  const int* rows;
  const bf16* ss;
  int C;
  __device__ const bf16* piece(int r, int) const { return x + (size_t)rows[r] * C; }
  __device__ void pre8(int r, int k, float v[8]) const {
    float sc[8], sh[8];
    load8(ss + k, sc);
    load8(ss + C + k, sh);
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = noise_affine(v[t], sc[t], sh[t]);
  }
};

template <int MAXV, int ROWS, int LPR>
using BwdLn = hg::LnPanel<BwdWindowRows, MAXV, ROWS, LPR>;

// The tile of one C at window 8: a window's 64 rows; three roles, each a
// warpgroup or two (kernel comment); a ring of STAGES 16 KB slots.  Shared
// memory: the LN1 and dy panels, two of each (the window the heads run on,
// the one the row warps fill), the stage (q, k, v, dO of a head, [4][64]
// [kLdQ]; the dqkv tile once the core is done), P's and dS's rows [64][136]
// bf16, the staged bias [L][LdB] fp32, the ring, dhn [64][C + 8] fp32 (the
// heads' accumulators handed to the row warps; their column sums once read),
// two windows' x rows for the epilogue and two scale | shift rows.
template <int C_, int STAGES_, class Ln_>
struct BwdTile {
  static constexpr int C = C_, L = 64, STAGES = STAGES_, S = hg::kSlice;
  using G = FwdGeom<L>;
  using Ln = Ln_;
  static constexpr int LP = G::LP, R = LP;
  static constexpr int KS = (C + S - 1) / S;  // K slices of C
  // threads: the head warpgroup, two row warpgroups, the producer warpgroup
  static constexpr int kHead = 128, kRows = 256, kThreads = kHead + kRows + 128;
  static constexpr int kHeadRegs = 224, kRowRegs = 128, kProducerRegs = 32;
  static_assert(kHead * kHeadRegs + kRows * kRowRegs + 128 * kProducerRegs <= 65536, "registers");
  static constexpr int kPanelBytes = R * KS * S * 2;
  static constexpr int kStageBytes = 4 * LP * kLdQ * 2;
  static constexpr int kPdsLd = 136;  // bf16 a row: P's 64, then dS's 64
  static constexpr int kPdsBytes = LP * kPdsLd * 2;
  static constexpr int kBiasBytes = L * G::LdB * 4;
  static constexpr int kQdBytes = 128 * S * 2;  // Wqkv_h's 96 rows and Wproj^T_h's 32
  static constexpr int kHBytes = 96 * S * 2;    // Wqkv_h's 96 rows
  static constexpr int kSlotBytes = kQdBytes;
  static constexpr int kDhnLd = C + 8;  // floats a row of the handed-over dhn
  static constexpr int kDhnBytes = R * kDhnLd * 4, kXBytes = 2 * R * C * 2;  // x: two windows
  static constexpr int LPR = C <= 128 ? 16 : 32;  // the epilogue's lanes a row
  static constexpr int MAXV = (C / 8 + LPR - 1) / LPR;
  static constexpr int kSmemBytes = 1024 + 4 * kPanelBytes + kStageBytes + kPdsBytes +
                                    kBiasBytes + STAGES * kSlotBytes + kDhnBytes + kXBytes +
                                    2 * 2 * C * 2;
  static_assert(C % 32 == 0 && L == 64, "tile");
  static_assert(kStageBytes % 1024 == 0 && kPanelBytes % 1024 == 0, "1024-byte aligned regions");
  static_assert(2 * R * S * 2 <= kStageBytes, "the dqkv tile in the stage");
  static_assert(STAGES >= 2 && kSmemBytes <= hg::kMaxDynSmem, "shared memory");
  static_assert(kRows / 32 * 5 * C * 4 <= kDhnBytes, "the row warps' sums over dhn's rows");
};

struct BwdMaps {
  CUtensorMap wqkv, wprojt;  // Wqkv [3C, C] and Wproj^T [C, C], boxes {64, 32}
};

struct BwdArgs {
  const bf16* x;
  const bf16* ss;
  const bf16* dy;
  const float* ln_g;
  const float* ln_b;
  const float* bqkv;
  const float* rel;   // [nH, L, L]
  const float* mask;  // [nw, L, L] or null
  bf16* hn;           // [M, C]
  bf16* attn;         // [M, C]
  bf16* dqkv;         // [M, 3C]
  bf16* dx;           // [M, C]
  float* part_rel;    // [grid, nH, L, L]
  float* part_win;    // [n_windows, 8C]: dgamma | dbeta | dscale | dshift | dbproj | dbqkv
  int n_windows, H, W, window, shift, nw, heads;
  float scale;
};

// the head warpgroup's threads only (named barrier 3; the row warps take 1,
// which hg::LnPanel and hg::consumer_sync use)
__device__ __forceinline__ void head_sync() { asm volatile("bar.sync 3, 128;\n" ::: "memory"); }

// rel_bias[h] + mask[cls] into Bs [L][LdB] (zero past column L) by the `n`
// threads t of the producer's staging warps, float4 loads along the rows
template <class G>
__device__ __forceinline__ void stage_bias_rows(float* Bs, const float* rel, const float* mask,
                                                int t, int n) {
  constexpr int L = G::L, Q = G::LdB / 4, U = 2;  // float4 a row; loads in flight
  for (int i0 = t; i0 < L * Q; i0 += U * n) {
    float4 v[U], m[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * n, r = i / Q, c = (i % Q) * 4;
      const bool in = i < L * Q && c < L;
      v[u] = in ? ld_ro4(rel + r * L + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      m[u] = in && mask ? ld_ro4(mask + r * L + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * n;
      if (mask) v[u].x += m[u].x, v[u].y += m[u].y, v[u].z += m[u].z, v[u].w += m[u].w;
      if (i < L * Q) *reinterpret_cast<float4*>(Bs + (i / Q) * G::LdB + (i % Q) * 4) = v[u];
    }
  }
}

// grid (blocks), T::kThreads threads, T::kSmemBytes of dynamic shared memory.
// Block x walks windows x, x + grid, ...; window w's panels are buffer w & 1.
template <class T>
__global__ void __launch_bounds__(T::kThreads, 1)
window_attn_bwd_kernel_fused(const __grid_constant__ BwdMaps maps,
                             const __grid_constant__ BwdArgs a) {
  constexpr int C = T::C, L = T::L, LP = T::LP, R = T::R, S = T::S, ST = T::STAGES,
                KS = T::KS;
  using G = typename T::G;
  constexpr int NN = G::NN, KC = G::KC, PL = T::kPdsLd;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[ST], empty[ST], bias_full, bias_empty, ready[2],
      dhn_full, dhn_empty;
  __shared__ int rows[2][R];
  unsigned char* base = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  bf16* lnp = reinterpret_cast<bf16*>(base);                        // [2] LN1 panels
  bf16* dyp = reinterpret_cast<bf16*>(base + 2 * T::kPanelBytes);   // [2] dy panels
  unsigned char* after = base + 4 * T::kPanelBytes;
  bf16* stage = reinterpret_cast<bf16*>(after);
  bf16* pds = reinterpret_cast<bf16*>(after + T::kStageBytes);
  float* biasb = reinterpret_cast<float*>(after + T::kStageBytes + T::kPdsBytes);
  unsigned char* ring = after + T::kStageBytes + T::kPdsBytes + T::kBiasBytes;
  float* dstage = reinterpret_cast<float*>(ring + ST * T::kSlotBytes);  // [R][kDhnLd]
  bf16* xs = reinterpret_cast<bf16*>(dstage + R * T::kDhnLd);           // [2][R][C]
  bf16* ssv = xs + 2 * R * C;                                           // [2][2C]
  bf16* tile = stage;  // dq | dk | dv of the head, 2 slices

  const int nb = gridDim.x;
  const int count = (a.n_windows - (int)blockIdx.x + nb - 1) / nb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      hg::mbar_init(&full[s], 1);
      hg::mbar_init(&empty[s], 4);
    }
    hg::mbar_init(&bias_full, 3);
    hg::mbar_init(&bias_empty, 4);
    hg::mbar_init(&ready[0], 1);
    hg::mbar_init(&ready[1], 1);
    hg::mbar_init(&dhn_full, 1);
    hg::mbar_init(&dhn_empty, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // ------------------------------------------------------- the producer
  if (threadIdx.x >= T::kHead + T::kRows) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::kProducerRegs));
    const int pw = warp - (T::kHead + T::kRows) / 32;
    if (pw == 0 && lane == 0) {  // every ring unit, in the head warps' order
      int it = 0;
      auto slot = [&](unsigned bytes) {
        const int s = it % ST;
        hg::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        hg::mbar_expect_tx(&full[s], bytes);
        return ring + s * T::kSlotBytes;
      };
      for (int w = 0; w < count; ++w)
        for (int h = 0; h < a.heads; ++h) {
          for (int ks = 0; ks < KS; ++ks, ++it) {  // the head's q, k, v rows and Wproj^T rows
            unsigned char* sl = slot(T::kQdBytes);
#pragma unroll
            for (int q = 0; q < 3; ++q)
              hg::tma_load(&maps.wqkv, sl + q * kHD * S * 2, &full[it % ST], ks * S,
                           q * C + h * kHD);
            hg::tma_load(&maps.wprojt, sl + 96 * S * 2, &full[it % ST], ks * S, h * kHD);
          }
          for (int ks = 0; ks < KS; ++ks, ++it) {  // the head's q, k, v rows again, for dhn
            unsigned char* sl = slot(T::kHBytes);
#pragma unroll
            for (int q = 0; q < 3; ++q)
              hg::tma_load(&maps.wqkv, sl + q * kHD * S * 2, &full[it % ST], ks * S,
                           q * C + h * kHD);
          }
        }
    } else if (pw > 0) {  // each (window, head)'s bias, one buffer
      int j = 0;
      for (int w = 0; w < count; ++w) {
        const int wi = blockIdx.x + w * nb;
        const float* maskc = a.mask ? a.mask + (size_t)(wi % a.nw) * L * L : nullptr;
        for (int h = 0; h < a.heads; ++h, ++j) {
          hg::mbar_wait(&bias_empty, (j & 1) ^ 1);
          stage_bias_rows<G>(biasb, a.rel + (size_t)h * L * L, maskc,
                             threadIdx.x - (T::kHead + T::kRows) - 32, 96);
          __syncwarp();
          if (lane == 0) hg::mbar_arrive(&bias_full);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------ the row warps
  if (threadIdx.x >= T::kHead) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::kRowRegs));
    const int tid = threadIdx.x - T::kHead, rw = tid >> 5;
    constexpr int RW = T::kRows / 32;
    auto rows_sync = [] { hg::consumer_sync(T::kRows); };
    // window w's rows, scale | shift, dy and LN1 panels into buffer w & 1;
    // hn to device memory
    auto prologue = [&](int w) {
      const int wi = blockIdx.x + w * nb, p = w & 1;
      int* rt = rows[p];
      bf16* sv = ssv + p * 2 * C;
      for (int r = tid; r < R; r += T::kRows)
        rt[r] = static_cast<int>(window_token_row(wi, r, a.H, a.W, a.window, a.shift));
      const bf16* ssb = a.ss + (size_t)(wi / a.nw) * 2 * C;
      for (int i = tid; i < 2 * C / 8; i += T::kRows) cp_async16(sv + 8 * i, ssb + 8 * i, true);
      rows_sync();  // the row table
      bf16* dp = dyp + p * (T::kPanelBytes / 2);
      bf16* xp = xs + p * R * C;
      for (int i = tid; i < R * (C / 8); i += T::kRows) {
        const int r = i / (C / 8), k = (i % (C / 8)) * 8;
        cp_async16(hg::swizzled(dp, R, r, k), a.dy + (size_t)rt[r] * C + k, true);
        cp_async16(xp + r * C + k, a.x + (size_t)rt[r] * C + k, true);  // for the epilogue
      }
      // its copies wait for every group of the thread (ss's, dy's and x's too)
      bf16* lp = lnp + p * (T::kPanelBytes / 2);
      const typename T::Ln ln{BwdWindowRows{a.x, rt, sv, C}, a.ln_g, a.ln_b};
      ln.fill(lp, R, 0, L, C, RW, rw, lane);
      hg::fence_proxy_async();
      rows_sync();
      if (tid == 0) hg::mbar_arrive(&ready[p]);
    };
    if (count > 0) prologue(0);
    for (int w = 0; w < count; ++w) {
      if (w + 1 < count) prologue(w + 1);
      // the epilogue of window w, a row pass: lane group (rw, sub) takes rows
      // (j RW + rw) RPW + sub, LPR lanes a row, 8 columns a lane
      const int wi = blockIdx.x + w * nb, p = w & 1;
      const int* rt = rows[p];
      const bf16* sv = ssv + p * 2 * C;
      bf16* dp = dyp + p * (T::kPanelBytes / 2);
      const bf16* xp = xs + p * R * C;
      hg::mbar_wait(&dhn_full, w & 1);
      constexpr int LPR = T::LPR, MAXV = T::MAXV, RPW = 32 / LPR, NR = L / (RW * RPW);
      const int sub = lane / LPR, ln = lane % LPR;
      auto row_sum = [](float v) {
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        return v;
      };
      float sums[5][MAXV][8];
#pragma unroll
      for (int c = 0; c < 5; ++c)
#pragma unroll
        for (int i = 0; i < MAXV; ++i)
#pragma unroll
          for (int t = 0; t < 8; ++t) sums[c][i][t] = 0.f;
#pragma unroll 1
      for (int j = 0; j < NR; ++j) {
        const int r = (j * RW + rw) * RPW + sub;
        // per element: pre, a = bf16(silu(pre)) as the forward rounds it and
        // silu'(pre), from one exp(-pre) (silu and silu_grad's own terms)
        float xr[MAXV][8], d[MAXV][8], dr[MAXV][8], h[MAXV][8], sc1[MAXV][8], sg[MAXV][8];
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < MAXV; ++i) {
          const int k = (i * LPR + ln) * 8;
          if (k < C) {
            float sh[8];
            load8(xp + r * C + k, xr[i]);
            load8f(dstage + r * T::kDhnLd + k, d[i]);
            load8(hg::swizzled(dp, R, r, k), dr[i]);
            load8(sv + k, sc1[i]);
            load8(sv + C + k, sh);
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              sc1[i][t] += 1.f;
              const float pre = sh[t] + xr[i][t] * sc1[i][t];
              const float e = expf(-pre), sig = 1.f / (1.f + e);
              h[i][t] = round_bf16(pre / (1.f + e));
              sg[i][t] = sig * (1.f + pre * (1.f - sig));
              s += h[i][t];
            }
          }
        }
        const float mean = row_sum(s) / C;
        float q = 0.f;
#pragma unroll
        for (int i = 0; i < MAXV; ++i)
          if ((i * LPR + ln) * 8 < C) {
#pragma unroll
            for (int t = 0; t < 8; ++t) q += (h[i][t] - mean) * (h[i][t] - mean);
          }
        const float rstd = rsqrtf(row_sum(q) / C + kLnEps);
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int i = 0; i < MAXV; ++i) {
          const int k = (i * LPR + ln) * 8;
          if (k < C) {
            float gm[8];
            load8f(a.ln_g + k, gm);
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              h[i][t] = (h[i][t] - mean) * rstd;
              sums[0][i][t] += d[i][t] * h[i][t];
              sums[1][i][t] += d[i][t];
              d[i][t] *= gm[t];
              s1 += d[i][t];
              s2 += d[i][t] * h[i][t];
            }
          }
        }
        const float m1 = row_sum(s1) / C, m2 = row_sum(s2) / C;
#pragma unroll
        for (int i = 0; i < MAXV; ++i) {
          const int k = (i * LPR + ln) * 8;
          if (k < C) {
            float o[8];
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              const float da = dr[i][t] + rstd * (d[i][t] - m1 - h[i][t] * m2);
              const float dpre = da * sg[i][t];
              sums[2][i][t] += dpre * xr[i][t];
              sums[3][i][t] += dpre;
              sums[4][i][t] += dr[i][t];
              o[t] = dpre * sc1[i][t];
            }
            store8(a.dx + (size_t)rt[r] * C + k, o);
          }
        }
      }
      // the window's sums: a warp's row groups (lanes ln and ln + LPR), then
      // the warps in order, through dhn's rows (read by now)
      if constexpr (RPW == 2) {
#pragma unroll
        for (int c = 0; c < 5; ++c)
#pragma unroll
          for (int i = 0; i < MAXV; ++i)
#pragma unroll
            for (int t = 0; t < 8; ++t)
              sums[c][i][t] += __shfl_xor_sync(0xffffffffu, sums[c][i][t], 16);
      }
      rows_sync();  // every row of dhn is read
      float* wsum = dstage;  // [RW][5C]
      if (sub == 0) {
#pragma unroll
        for (int c = 0; c < 5; ++c)
#pragma unroll
          for (int i = 0; i < MAXV; ++i) {
            const int k = (i * LPR + ln) * 8;
            if (k < C) {
              float* o = wsum + rw * 5 * C + c * C + k;
              *reinterpret_cast<float4*>(o) =
                  make_float4(sums[c][i][0], sums[c][i][1], sums[c][i][2], sums[c][i][3]);
              *reinterpret_cast<float4*>(o + 4) =
                  make_float4(sums[c][i][4], sums[c][i][5], sums[c][i][6], sums[c][i][7]);
            }
          }
      }
      rows_sync();
      float* pwin = a.part_win + (size_t)wi * 8 * C;
      for (int i = tid; i < 5 * C; i += T::kRows) {
        float v = wsum[i];
        for (int q = 1; q < RW; ++q) v += wsum[q * 5 * C + i];
        pwin[i] = v;
      }
      rows_sync();  // the warps' sums are read: the head warps may hand over the next dhn
      if (tid == 0) hg::mbar_arrive(&dhn_empty);
    }
    return;
  }

  // ------------------------------------------------------ the head warps
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::kHeadRegs));
  const int tid = threadIdx.x;
  const int g = lane >> 2, t4 = lane & 3, row0 = warp * 16;
  // accumulator element (row, col) of the warpgroup: row er + 8 i, col 8 j +
  // ec + {0, 1} -> acc[4 j + 2 i + {0, 1}]
  const int er = 16 * warp + g, ec = 2 * t4;
  auto slot_of = [&](int i) {
    return reinterpret_cast<const bf16*>(ring + (i % ST) * T::kSlotBytes);
  };
  auto wait_full = [&](int i) { hg::mbar_wait(&full[i % ST], (i / ST) & 1); };
  auto release = [&](int i) {
    if (lane == 0) hg::mbar_arrive(&empty[i % ST]);
  };
  const bf16* Qs = stage;
  const bf16* Ks = Qs + LP * kLdQ;
  const bf16* Vs = Ks + LP * kLdQ;
  const bf16* dOs = Vs + LP * kLdQ;
  const bf16* dSs = pds + 64;  // P (r, c) at r * PL + c, dS at r * PL + 64 + c

  int it = 0, j = 0;  // ring units; (window, head) pairs (the bias's phases)
  float dhn[KS][32];
  for (int w = 0; w < count; ++w) {
    const int p = w & 1;
    const int* rt = rows[p];
    bf16* panel = lnp + p * (T::kPanelBytes / 2);
    bf16* dypanel = dyp + p * (T::kPanelBytes / 2);
    const int wi = blockIdx.x + w * nb;
    hg::mbar_wait(&ready[p], (w >> 1) & 1);
    for (int i = tid; i < L * (C / 8); i += T::kHead) {  // hn for dWqkv
      const int r = i / (C / 8), k = (i % (C / 8)) * 8;
      *reinterpret_cast<uint4*>(a.hn + (size_t)rt[r] * C + k) =
          *reinterpret_cast<const uint4*>(hg::swizzled(panel, R, r, k));
    }
    // dhn's accumulators live from here to the hand-over (the wgmmas read them)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int i = 0; i < 32; ++i) dhn[ks][i] = 0.f;

    for (int h = 0; h < a.heads; ++h, ++j) {
      // q, k, v = panel Wqkv_h^T and dO = dy Wproj[:, head], a K slice a slot
      float acc[48], acc2[16];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int i = it + ks;
        wait_full(i);
        const uint64_t da = hg::sw128_desc(panel + ks * R * S);
        const uint64_t dd = hg::sw128_desc(dypanel + ks * R * S);
        const uint64_t db = hg::sw128_desc(slot_of(i));
        const uint64_t dw = hg::sw128_desc(slot_of(i) + 96 * S);
        hg::wgmma_fence();
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (ks * S + 16 * t < C) {
            hg::Wgmma<96>::mma(acc, da + 2 * t, db + 2 * t, ks + t > 0);
            hg::Wgmma<32>::mma(acc2, dd + 2 * t, dw + 2 * t, ks + t > 0);
          }
        hg::wgmma_commit();
        hg::wgmma_wait<1>();
        hg::fence_regs(acc);
        hg::fence_regs(acc2);
        if (ks > 0) release(i - 1);
      }
      hg::wgmma_wait<0>();
      hg::fence_regs(acc);
      hg::fence_regs(acc2);
      release(it + KS - 1);
      it += KS;
      // + bqkv, bf16, into the stage ([q | k | v | dO][token][d])
#pragma unroll
      for (int jj = 0; jj < 12; ++jj) {
        const int which = jj / 4, d = 8 * (jj % 4) + ec;
        const float2 bq = __ldg(reinterpret_cast<const float2*>(a.bqkv + which * C + h * kHD + d));
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<uint32_t*>(stage + (which * LP + er + 8 * i) * kLdQ + d) =
              pack_bf16(acc[4 * jj + 2 * i] + bq.x, acc[4 * jj + 2 * i + 1] + bq.y);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<uint32_t*>(stage + (3 * LP + er + 8 * i) * kLdQ + 8 * jj + ec) =
              pack_bf16(acc2[4 * jj + 2 * i], acc2[4 * jj + 2 * i + 1]);
      head_sync();  // q, k, v and dO

      // the backward core: warp w takes query rows 16 w .. 16 w + 15
      float p_[NN][4], sum[2];
      window_scores<G>(p_, Qs, Ks, row0, lane);
      hg::mbar_wait(&bias_full, j & 1);
      window_softmax<G>(p_, sum, biasb, row0, lane, a.scale);
      __syncwarp();
      if (lane == 0) hg::mbar_arrive(&bias_empty);  // the bias is in registers
      float dp[NN][4];
      window_scores<G>(dp, dOs, Vs, row0, lane);
      float delta[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p_[n][e] *= sum[e >> 1];
          delta[e >> 1] += p_[n][e] * dp[n][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 1);
        delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 2);
      }
      // dS = P (dP - delta) in dp; into the block's d(rel_bias) partial; bf16
      // P and dS to shared memory
      float* pr = a.part_rel + ((size_t)blockIdx.x * a.heads + h) * L * L;
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float2 v;
          v.x = p_[n][2 * half] * (dp[n][2 * half] - delta[half]);
          v.y = p_[n][2 * half + 1] * (dp[n][2 * half + 1] - delta[half]);
          dp[n][2 * half] = v.x, dp[n][2 * half + 1] = v.y;
          const int r = row0 + g + 8 * half, c = n * 8 + 2 * t4;
          float2* q = reinterpret_cast<float2*>(pr + r * L + c);
          if (w > 0) {
            const float2 o = *q;
            v.x = o.x + v.x, v.y = o.y + v.y;
          }
          *q = v;
          *reinterpret_cast<uint32_t*>(pds + r * PL + c) =
              pack_bf16(p_[n][2 * half], p_[n][2 * half + 1]);
          *reinterpret_cast<uint32_t*>(pds + r * PL + 64 + c) =
              pack_bf16(dp[n][2 * half], dp[n][2 * half + 1]);
        }
      // O = bf16(P) V and dQ = bf16(dS) K from the registers (the accumulator
      // tiles 2c, 2c + 1 are the A fragment of k step c)
      float o[kHD / 8][4] = {}, dq[kHD / 8][4] = {};
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        uint32_t pa[4], sa[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = 2 * c + half;
          pa[2 * half] = pack_bf16(p_[n][0], p_[n][1]);
          pa[2 * half + 1] = pack_bf16(p_[n][2], p_[n][3]);
          sa[2 * half] = pack_bf16(dp[n][0], dp[n][1]);
          sa[2 * half + 1] = pack_bf16(dp[n][2], dp[n][3]);
        }
#pragma unroll
        for (int d0 = 0; d0 < kHD; d0 += 16) {
          uint32_t vb[4], kb[4];
          ldsm_x4_t(vb, Vs + (c * 16 + (lane & 15)) * kLdQ + d0 + (lane >> 4) * 8);
          ldsm_x4_t(kb, Ks + (c * 16 + (lane & 15)) * kLdQ + d0 + (lane >> 4) * 8);
          mma16816(o[d0 / 8], pa, vb[0], vb[1]);
          mma16816(o[d0 / 8 + 1], pa, vb[2], vb[3]);
          mma16816(dq[d0 / 8], sa, kb[0], kb[1]);
          mma16816(dq[d0 / 8 + 1], sa, kb[2], kb[3]);
        }
      }
      // attn = bf16(O) of this warp's query rows
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        bf16* ao = a.attn + (size_t)rt[row0 + g + 8 * half] * C + h * kHD;
#pragma unroll
        for (int n = 0; n < kHD / 8; ++n)
          *reinterpret_cast<uint32_t*>(ao + n * 8 + 2 * t4) =
              pack_bf16(o[n][2 * half], o[n][2 * half + 1]);
      }
      head_sync();  // every warp's rows of P and dS

      // keys 16 w .. 16 w + 15: dK = scale bf16(dS)^T Q, dV = bf16(P)^T dO
      float dk[kHD / 8][4] = {}, dv[kHD / 8][4] = {};
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        uint32_t sa[4], pa[4];
        const int qr = c * 16 + (lane & 7) + ((lane >> 4) << 3), kc = row0 + ((lane >> 3) & 1) * 8;
        ldsm_x4_t(sa, dSs + qr * PL + kc);
        ldsm_x4_t(pa, pds + qr * PL + kc);
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
      head_sync();  // every warp is done with the stage and P and dS

      // dq, dk, dv of rows 16 w + g (+ 8): bf16 into the tile [dq | dk | dv]
      // (K-major, swizzled) and into dqkv
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = row0 + g + 8 * half;
        bf16* out = a.dqkv + (size_t)rt[t] * 3 * C + h * kHD;
#pragma unroll
        for (int n = 0; n < kHD / 8; ++n) {
          const int d = n * 8 + 2 * t4;
          const uint32_t vq = pack_bf16(a.scale * dq[n][2 * half], a.scale * dq[n][2 * half + 1]);
          const uint32_t vk = pack_bf16(a.scale * dk[n][2 * half], a.scale * dk[n][2 * half + 1]);
          const uint32_t vv = pack_bf16(dv[n][2 * half], dv[n][2 * half + 1]);
          *reinterpret_cast<uint32_t*>(hg::swizzled(tile, R, t, n * 8) + 2 * t4) = vq;
          *reinterpret_cast<uint32_t*>(hg::swizzled(tile, R, t, kHD + n * 8) + 2 * t4) = vk;
          *reinterpret_cast<uint32_t*>(hg::swizzled(tile, R, t, 2 * kHD + n * 8) + 2 * t4) = vv;
          *reinterpret_cast<uint32_t*>(out + d) = vq;
          *reinterpret_cast<uint32_t*>(out + C + d) = vk;
          *reinterpret_cast<uint32_t*>(out + 2 * C + d) = vv;
        }
      }
      hg::fence_proxy_async();
      head_sync();  // the tile

      // dhn += dqkv_h Wqkv_h, a slice of 64 of C's columns a slot
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int i = it + ks;
        wait_full(i);
        const uint64_t db = hg::mn128_desc(slot_of(i), S * S * 2);
        hg::fence_regs(dhn[ks]);
        hg::wgmma_fence();
#pragma unroll
        for (int t = 0; t < 6; ++t)
          hg::Wgmma<64, 0, 1>::mma(dhn[ks], hg::sw128_desc(tile + (t >> 2) * R * S) + 2 * (t & 3),
                                   db + 128 * t);
        hg::wgmma_commit();
        hg::wgmma_wait<1>();
        hg::fence_regs(dhn[ks]);
        if (ks > 0) release(i - 1);
      }
      // the window's column sums of dq | dk | dv (dbqkv) while the products run
      if (tid < 3 * kHD) {
        float v = 0.f;
#pragma unroll 8
        for (int r = 0; r < L; ++r)
          v += __bfloat162float(*(hg::swizzled(tile, R, r, tid & ~7) + (tid & 7)));
        a.part_win[(size_t)wi * 8 * C + 5 * C + (tid / kHD) * C + h * kHD + tid % kHD] = v;
      }
      hg::wgmma_wait<0>();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) hg::fence_regs(dhn[ks]);
      release(it + KS - 1);
      it += KS;
      head_sync();  // the tile's products are done before the next head's stage
    }

    // hand dhn to the row warps once they have read the last window's
    if (w > 0) hg::mbar_wait(&dhn_empty, (w - 1) & 1);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int col = ks * S + 8 * jj + ec;
          if (col < C)
            *reinterpret_cast<float2*>(dstage + (er + 8 * i) * T::kDhnLd + col) =
                make_float2(dhn[ks][4 * jj + 2 * i], dhn[ks][4 * jj + 2 * i + 1]);
        }
    head_sync();
    if (tid == 0) hg::mbar_arrive(&dhn_full);
  }
}

// The tile of each C at window length L; f gets a value of its type; -1 for
// another (those shapes run the chain).
template <class F>
int with_bwd_tile(int C, int L, F f) {
  if (L != 64) return -1;
  switch (C) {
    case 96: return f(BwdTile<96, 3, BwdLn<2, 1, 8>>{});
    default: return -1;
  }
}

template <class T>
cudaError_t bwd_opt_in() {
  static PerDevice ready;
  return ready.once([](int&) {
    return cudaFuncSetAttribute(window_attn_bwd_kernel_fused<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  });
}

template <class T>
cudaError_t launch_bwd_fused(const BwdArgs& a, const bf16* wqkv, const bf16* wprojt, int blocks,
                             cudaStream_t s) {
  DSG_TRY(bwd_opt_in<T>());
  if (blocks <= 0 || blocks > a.n_windows || a.heads * kHD != T::C) return cudaErrorInvalidValue;
  BwdMaps maps;
  if (!hg::make_map(&maps.wqkv, wqkv, T::C, 3 * T::C, kHD) ||
      !hg::make_map(&maps.wprojt, wprojt, T::C, T::C, kHD))
    return cudaErrorInvalidValue;
  window_attn_bwd_kernel_fused<T><<<blocks, T::kThreads, T::kSmemBytes, s>>>(maps, a);
  return cudaGetLastError();
}

}  // namespace


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
  DSG_TRY((cudaError_t)with_stream_tile(C, [&](auto tile) -> int {
    return hg::launch<decltype(tile), SwinBwdDattn>(rows(dy, C), hg::NoPanel{}, epi_da,
                                                    static_cast<const bf16*>(wproj), M, C,
                                                    dattn_per, s);
  }));

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
  DSG_TRY((cudaError_t)with_stream_tile(C, [&](auto tile) -> int {
    return hg::launch<decltype(tile), SwinBwdDhn>(rows(dqkv_buf, 3 * C), hg::NoPanel{}, epi_dhn,
                                                  static_cast<const bf16*>(wqkv), M, C, dhn_per,
                                                  s);
  }));
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
      return with_stream_tile(C, [&](auto tile) -> int {
        return hg::tile_query<decltype(tile), SwinBwdDattn, hg::NoPanel, hg::Bf16Epi>(C, geom);
      });
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

// The backward of the attention half through window_attn_bwd_kernel_fused
// (the shapes dsg_swin_attn_bwd_fused_tile covers): the kernel over `blocks`
// blocks, then the fixed-order reductions of its partials and the two weight
// gradients.  wprojt is Wproj^T [C, C]; scratch: hn, attn [M, C] and dqkv
// [M, 3C] bf16, part_rel [blocks, nH, L, L], part_win [B nw, 8C], part_b [B,
// 8C] and part_w [splits_w, 4C^2] fp32; dbias [4C] holds dbproj then dbqkv.
extern "C" int dsg_swin_attn_bwd_fused(
    const void* x, const void* ss, const void* dy, const void* ln_g, const void* ln_b,
    const void* wqkv, const void* bqkv, const void* wprojt, const void* rel_bias,
    const void* mask,
    // scratch
    void* hn_buf, void* attn_buf, void* dqkv_buf, void* part_rel, void* part_win, void* part_b,
    void* part_w,
    // outputs: dw [4C^2] holds dWqkv [3C, C] then dWproj [C, C]
    void* dx, void* dss, void* dgamma_dbeta, void* dw, void* dbias, void* drel, int B, int H,
    int W, int C, int num_heads, int window, int shift, int blocks, int splits_w, int kchunk_w,
    void* stream) {
  if (!window_length_supported(window * window) || C != num_heads * kHD || H % window ||
      W % window || B <= 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int L = window * window, M = B * H * W;
  const int nw = (H / window) * (W / window);
  const BwdArgs a{static_cast<const bf16*>(x),      static_cast<const bf16*>(ss),
                  static_cast<const bf16*>(dy),     static_cast<const float*>(ln_g),
                  static_cast<const float*>(ln_b),  static_cast<const float*>(bqkv),
                  static_cast<const float*>(rel_bias), static_cast<const float*>(mask),
                  static_cast<bf16*>(hn_buf),       static_cast<bf16*>(attn_buf),
                  static_cast<bf16*>(dqkv_buf),     static_cast<bf16*>(dx),
                  static_cast<float*>(part_rel),    static_cast<float*>(part_win),
                  B * nw, H, W, window, shift, nw, num_heads, 1.f / sqrtf((float)kHD)};
  const bf16* wq = static_cast<const bf16*>(wqkv);
  const bf16* wpt = static_cast<const bf16*>(wprojt);
  const int rc = with_bwd_tile(C, L, [&](auto tile) -> int {
    return launch_bwd_fused<decltype(tile)>(a, wq, wpt, blocks, s);
  });
  if (rc != 0) return rc;
  const int rel_n = num_heads * L * L;
  DSG_TRY(reduce_partials(static_cast<float*>(part_rel), static_cast<float*>(drel), 1, blocks,
                          rel_n, (size_t)rel_n, 0, s));
  // the windows' partials: per sample (d scale_shift), then over the samples
  float* pb = static_cast<float*>(part_b);
  DSG_TRY(reduce_partials(static_cast<float*>(part_win), pb, B, nw, 8 * C, (size_t)8 * C, 0, s));
  DSG_TRY(reduce_partials(pb, static_cast<float*>(dss), B, 1, 2 * C, (size_t)8 * C, 2 * C, s));
  DSG_TRY(reduce_partials(pb, static_cast<float*>(dgamma_dbeta), 1, B, 2 * C, (size_t)8 * C, 0,
                          s));
  DSG_TRY(reduce_partials(pb, static_cast<float*>(dbias), 1, B, 4 * C, (size_t)8 * C, 4 * C, s));
  // dWqkv [3C, C] = dqkv^T hn and dWproj [C, C] = dy^T attn, one partial buffer
  const size_t ld = (size_t)4 * C * C;
  float* pw = static_cast<float*>(part_w);
  DSG_TRY(launch_wgrad<SwinBwdDwqkv>(dqkv_buf, hn_buf, pw, ld, 3 * C, C, M, splits_w, kchunk_w, s));
  DSG_TRY(launch_wgrad<SwinBwdDwproj>(dy, attn_buf, pw + (size_t)3 * C * C, ld, C, C, M, splits_w,
                                      kchunk_w, s));
  return reduce_partials(pw, static_cast<float*>(dw), 1, splits_w, 4 * C * C, ld, 0, s);
}

// The fused kernel's tile at width C and window length L, for the wrapper's
// plan: geom = {rows, 0, blocks an SM holds (the card's occupancy), 0}; -1
// for a (C, L) it does not cover (the chain runs there).
extern "C" int dsg_swin_attn_bwd_fused_tile(int C, int L, int* geom) {
  return with_bwd_tile(C, L, [&](auto tile) -> int {
    using T = decltype(tile);
    int per_sm = 0;
    if (bwd_opt_in<T>() != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, window_attn_bwd_kernel_fused<T>,
                                                      T::kThreads, T::kSmemBytes) != cudaSuccess ||
        per_sm <= 0)
      return -2;
    geom[0] = T::R, geom[1] = 0, geom[2] = per_sm, geom[3] = 0;
    return 0;
  });
}
