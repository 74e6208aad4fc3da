// Pieces the forward and backward of the Swin attention half share: the
// noise-affine row source and the qkv GEMM's tile (`with_tile`: the forward
// and the backward's recompute run the same), the window geometry (window 8
// or 10, head_dim 32), the map from a window's token to its raster row with
// the cyclic shift of shifted windows folded in, the scores, softmax and
// bias staging of a warp's query rows in registers (`window_scores`,
// `window_softmax`, `stage_bias`; the backward core, swin_attn_bwd.cu, runs
// them too), and the forward window core `window_attn_kernel`, a template
// over the window length and over where its operands lie (swin_attn.cu:
// packed qkv rows in raster order; window_attention.cu: separate q, k, v in
// [window, head, token, hd] order).
//
// The forward core replaces the window attention of
// diffusesg_tpu/ops/window_attention.py::_fused_kernel and of
// diffusesg_tpu/ops/swin_block_v3.py::_kernel.  Bound on the H100: bytes (4 L^2
// hd FLOP per window and head against 4 L hd 2 bytes of q, k, v, out: 32-50
// FLOP per byte, far under the ~295 ridge), so the design keeps everything
// but q, k, v and out on chip and overlaps their loads with compute:
//   - S = Q K^T by mma.sync m16n8k16 (fragments from ldmatrix), the row max
//     and sum by quad shuffles and P = bf16(softmax) all in registers; P is
//     the A operand of P V as it stands (the accumulator layout of two score
//     tiles is the A layout of one k16 step), V comes by ldmatrix.trans.
//     Scores and softmax fp32, P rounded to bf16 before P V, as the plain
//     version (ops/window_attention.py).  Score columns pad to the next
//     multiple of 8 (100 -> 104), the P V depth to 112, where P is zero.
//   - rel_bias[h] (+ mask[class]) is summed once per block into shared memory
//     in fp32 and read in the accumulator's own layout, not per element and
//     row from device memory.  (A fused fp32 bias adds in another order than
//     s + rel + mask; the tolerances cover it.)
//   - A block serves one head and one mask class and walks a run of that
//     class's windows; a two-stage cp.async ring loads window j + 1 while j
//     computes.  The run length comes from a grid plan on the host
//     (swin_block_v3.window_core_plan) that fills the SMs in one wave.
//
// A window of L tokens is padded to LP, the next multiple of the 16-row MMA
// tile (64 -> 64, 100 -> 112).  Rows L..LP-1 of Q, K, V (and dO) are ZERO in
// shared memory, score columns >= L are left out of the row max and sum and
// get probability 0, padded query rows get probability 0 everywhere and are
// never stored; rel_bias and mask stay unpadded [.., L, L] in device memory.
// A block has one warp per row tile: 4 warps at L = 64, 7 at L = 100.
#pragma once

#include "hopper_gemm.cuh"

namespace dsg {

// The noise affine of one element: a = bf16(silu(shift + x * (scale + 1))),
// held in fp32 (the qkv prologue's LN1 input and the proj epilogue's residual).
__device__ __forceinline__ float noise_affine(float x, float scale, float shift) {
  return round_bf16(silu(shift + x * (scale + 1.f)));
}

// Row source of the qkv panel: the raw x rows of tokens m come in, and
// `pre8` turns them into a = silu(shift + x * (scale + 1)) rounded to bf16;
// hg::LnPanel then takes LN1 over them in place.
struct AffineRows {
  static constexpr int kPieces = 1;
  const bf16* x;
  const bf16* ss;  // [B, 2C]  scale | shift
  int C, HW;
  __device__ const bf16* piece(int m, int) const { return x + (size_t)m * C; }
  __device__ void pre8(int m, int k, float v[8]) const {
    float sc[8], sh[8];
    const bf16* p = ss + (size_t)(m / HW) * 2 * C + k;
    ld_ro8(p, sc);
    ld_ro8(p + C, sh);
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = noise_affine(v[t], sc[t], sh[t]);
  }
};

template <int MAXV, int ROWS, int LPR>
using AffineLnPanel = hg::LnPanel<AffineRows, MAXV, ROWS, LPR>;

// The GEMM tile of a width C: 128-row panels up to C = 384 (two blocks an SM
// up to C = 192), 64-row panels (K up to 768) above, or wherever `wide`
// asks for them (the wrapper's plan, where 128-row tiles are too few to fill
// the card: a block's LayerNorm prologue then covers half the rows); `f`
// gets a value of the tile type and of the qkv prologue's type.
template <class F>
int with_tile(int C, int wide, F f) {
  if (C % 32 || C <= 0 || C > 768) return -1;
  if (wide || C > 384) return f(hg::PanelWide{}, AffineLnPanel<3, 2, 32>{});
  if (C <= 128) return f(hg::PanelRows{}, AffineLnPanel<1, 4, 16>{});
  if (C <= 256) return f(hg::PanelRows{}, AffineLnPanel<1, 4, 32>{});
  return f(hg::PanelTall{}, AffineLnPanel<2, 4, 32>{});
}

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
};

__device__ __forceinline__ size_t window_token_row(int wi, int t, int H, int W, int window,
                                                   int shift) {
  const int nww = W / window, nw = (H / window) * nww;
  const int b = wi / nw, wl = wi % nw;
  const int y = ((wl / nww) * window + t / window + shift) % H;
  const int x = ((wl % nww) * window + t % window + shift) % W;
  return ((size_t)b * H + y) * W + x;
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

// Geometry of the forward core: score columns padded to the next multiple of
// 8 (the n width of an m16n8k16 tile: 64 -> 64, 100 -> 104); the K depth of
// P V to LP (P is zero past L); the staged bias rows strided so that the
// accumulator layout's float2 reads hit 32 distinct banks (stride = 8 mod 32).
template <int L_>
struct FwdGeom {
  static constexpr int L = L_;
  static constexpr int LP = WinGeom<L>::LP;        // rows of Q, K, V tiles (zero past L)
  static constexpr int NT = WinGeom<L>::NT;        // warps: one per 16 query rows
  static constexpr int kThreads = 32 * NT;
  static constexpr int NN = (L + 7) / 8;           // score n-tiles of 8 columns
  static constexpr int KC = LP / 16;               // k16 steps of P V
  static constexpr int LdB = (L + 23) / 32 * 32 + 8;  // fp32 bias row stride
  static constexpr int kStageElems = 3 * LP * kLdQ;   // q, k, v of one window
  static constexpr int kSmemBytes = 2 * kStageElems * 2 + LP * LdB * 4;
  // blocks an SM should hold (the register budget of __launch_bounds__);
  // the grid plan reads what the card reports (window_attn_blocks_per_sm)
  static constexpr int kBlocksPerSm = L == 64 ? 4 : 2;
};

// S = Q K^T of a warp's 16 query rows (row0..) against every key, all NN
// column tiles of 8, in registers (mma.sync; Q and K rows in shared memory,
// row stride kLdQ)
template <class G>
__device__ __forceinline__ void window_scores(float (&s)[G::NN][4], const bf16* Qs,
                                              const bf16* Ks, int row0, int lane) {
  uint32_t qa[2][4];
  load_a16(qa[0], Qs, kLdQ, row0, 0, lane);
  load_a16(qa[1], Qs, kLdQ, row0, 16, lane);
#pragma unroll
  for (int n = 0; n < G::NN; ++n) {
    uint32_t kb[4];  // {b0, b1} of d 0..15, then of d 16..31
    ldsm_x4(kb, Ks + (n * 8 + (lane & 7)) * kLdQ + (lane >> 3) * 8);
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    mma16816(s[n], qa[0], kb[0], kb[1]);
    mma16816(s[n], qa[1], kb[2], kb[3]);
  }
}

// softmax of rows row0 + g (elements 0, 1) and row0 + g + 8 (2, 3) of the
// scores in place: fp32, scale S + the staged bias (row stride LdB),
// columns >= L out; the quad of lanes 4g..4g+3 holds each row.  s becomes
// exp(s - max) and sum the reciprocal of each row's sum: P = s * sum.
template <class G>
__device__ __forceinline__ void window_softmax(float (&s)[G::NN][4], float (&sum)[2],
                                               const float* Bs, int row0, int lane,
                                               float scale) {
  const int g = lane >> 2, t4 = lane & 3;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < G::NN; ++n) {
    const int c = n * 8 + 2 * t4;
    const float2 b[2] = {*reinterpret_cast<const float2*>(Bs + (row0 + g) * G::LdB + c),
                         *reinterpret_cast<const float2*>(Bs + (row0 + g + 8) * G::LdB + c)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float bias = e & 1 ? b[e >> 1].y : b[e >> 1].x;
      s[n][e] = c + (e & 1) < G::L ? s[n][e] * scale + bias : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
  }
  sum[0] = sum[1] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
#pragma unroll
  for (int n = 0; n < G::NN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = expf(s[n][e] - mx[e >> 1]);  // exp(-inf) = 0 past L
      sum[e >> 1] += s[n][e];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    sum[i] = 1.f / sum[i];
  }
}

// The bias of head h and mask class cls (mask null: none) into Bs, once per
// block: [LP][LdB] fp32, rel_bias + mask, zero past L.
template <class G>
__device__ __forceinline__ void stage_bias(float* Bs, const float* rel_bias, const float* mask,
                                           int h, int cls, int tid) {
  const float* rb = rel_bias + (size_t)h * G::L * G::L;
  const float* mk = mask ? mask + (size_t)cls * G::L * G::L : nullptr;
  for (int i = tid; i < G::LP * (G::LdB / 4); i += G::kThreads) {
    const int r = i / (G::LdB / 4), c = (i % (G::LdB / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < G::L && c < G::L) {
      v = *reinterpret_cast<const float4*>(rb + r * G::L + c);
      if (mk) {
        const float4 m = *reinterpret_cast<const float4*>(mk + r * G::L + c);
        v.x += m.x, v.y += m.y, v.z += m.z, v.w += m.w;
      }
    }
    *reinterpret_cast<float4*>(Bs + r * G::LdB + c) = v;
  }
}

// out = softmax(scale Q K^T + rel_bias[h] (+ mask[c])) V.  grid (classes *
// blocks per class, heads), FwdGeom::kThreads threads, kSmemBytes of dynamic
// shared memory.  Block (x, h) serves head h and mask class c = x % classes
// (classes = 1 without a mask) and walks the windows wi = c + classes * j of
// its run j in [x / classes * wpb, + wpb), clipped to the windows there are.
// It stages rel_bias[h] + mask[c] once, in fp32, and double-buffers the
// windows' q, k, v through a cp.async ring, so the next window loads while
// this one computes.  Each warp owns 16 query rows: S = Q K^T, the row max
// and sum (quad shuffles) and P stay in registers; P becomes the bf16 A
// operand of P V directly; O goes out through the warp's own Q rows of the
// stage, in 16-byte stores.
template <int L, class Lay>
__global__ void __launch_bounds__(FwdGeom<L>::kThreads, FwdGeom<L>::kBlocksPerSm)
window_attn_kernel(Lay lay, const float* __restrict__ rel_bias, const float* __restrict__ mask,
                   int n_windows, int classes, int wpb, float scale) {
  using G = FwdGeom<L>;
  constexpr int LP = G::LP, NN = G::NN;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  float* Bs = reinterpret_cast<float*>(ring + 2 * G::kStageElems);

  const int h = blockIdx.y, cls = blockIdx.x % classes;
  const int first = blockIdx.x / classes * wpb;
  const int per_class = (n_windows - cls + classes - 1) / classes;
  const int count = min(wpb, per_class - first);
  if (count <= 0) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, row0 = warp * 16;

  // q, k, v of run window j into ring stage j & 1: LP tokens x 3 x 4 vectors
  // of 8; the padded tokens zero-filled
  auto load = [&](int j) {
    const int wi = cls + classes * (first + j);
    bf16* st = ring + (j & 1) * G::kStageElems;
    for (int i = tid; i < LP * 3 * (kHD / 8); i += G::kThreads) {
      const int tk = i / (3 * (kHD / 8)), rest = i % (3 * (kHD / 8));
      const int which = rest / (kHD / 8), d = (rest % (kHD / 8)) * 8;
      const bool ok = tk < L;  // a padded token reads nothing (token 0's address)
      cp_async16(st + which * LP * kLdQ + tk * kLdQ + d, lay.src(which, wi, h, ok ? tk : 0) + d,
                 ok);
    }
    cp_async_commit();
  };
  load(0);

  // the bias of this head and class, once
  stage_bias<G>(Bs, rel_bias, mask, h, cls, tid);

  for (int j = 0; j < count; ++j) {
    if (j + 1 < count) load(j + 1);
    else cp_async_commit();  // an empty group keeps the wait count uniform
    cp_async_wait<1>();      // window j has landed ...
    __syncthreads();         // ... for every thread (and, at j = 0, the bias)
    bf16* Qs = ring + (j & 1) * G::kStageElems;
    const bf16* Ks = Qs + LP * kLdQ;
    const bf16* Vs = Ks + LP * kLdQ;

    float s[NN][4], sum[2];
    window_scores<G>(s, Qs, Ks, row0, lane);
    window_softmax<G>(s, sum, Bs, row0, lane, scale);

    // O = bf16(P) V: P's accumulator tiles 2c, 2c+1 are the A fragment of
    // k step c; tile NN (past the last) is zero
    float o[kHD / 8][4] = {};
#pragma unroll
    for (int c = 0; c < G::KC; ++c) {
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 2 * c + half;
        if (n < NN) {
          pa[2 * half] = pack_bf16(s[n][0] * sum[0], s[n][1] * sum[0]);
          pa[2 * half + 1] = pack_bf16(s[n][2] * sum[1], s[n][3] * sum[1]);
        } else {
          pa[2 * half] = pa[2 * half + 1] = 0u;
        }
      }
#pragma unroll
      for (int d0 = 0; d0 < kHD; d0 += 16) {
        uint32_t vb[4];  // {b0, b1} of d0.., then of d0 + 8..
        ldsm_x4_t(vb, Vs + (c * 16 + (lane & 15)) * kLdQ + d0 + (lane >> 4) * 8);
        mma16816(o[d0 / 8], pa, vb[0], vb[1]);
        mma16816(o[d0 / 8 + 1], pa, vb[2], vb[3]);
      }
    }

    // bf16(O) into this warp's own Q rows (read into registers above), then
    // out in 16-byte vectors, tokens only
    __syncwarp();
    bf16* Os = Qs + row0 * kLdQ;
#pragma unroll
    for (int n = 0; n < kHD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(Os + g * kLdQ + n * 8 + 2 * t4) = pack_bf16(o[n][0], o[n][1]);
      *reinterpret_cast<uint32_t*>(Os + (g + 8) * kLdQ + n * 8 + 2 * t4) =
          pack_bf16(o[n][2], o[n][3]);
    }
    __syncwarp();
    const int wi = cls + classes * (first + j);
#pragma unroll
    for (int i = lane; i < 16 * (kHD / 8); i += 32) {
      const int r = i / (kHD / 8), d = (i % (kHD / 8)) * 8;
      if (row0 + r < L)
        *reinterpret_cast<uint4*>(lay.dst(wi, h, row0 + r) + d) =
            *reinterpret_cast<const uint4*>(Os + r * kLdQ + d);
    }
    __syncthreads();  // every warp is done with stage j & 1 before it refills
  }
  cp_async_wait<0>();
}

// Opt the forward core into its dynamic shared memory, which passes the
// 48 KB static limit (once; the result is kept).
template <int L, class Lay>
cudaError_t window_attn_opt_in() {
  static const cudaError_t err = cudaFuncSetAttribute(
      window_attn_kernel<L, Lay>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FwdGeom<L>::kSmemBytes);
  return err;
}

// Blocks of the forward core an SM holds, as the card reports it for the
// kernel's registers and shared memory: the grid plan on the host
// (swin_block_v3.window_core_plan) aims at this times the SMs.  -1 on an
// error.
template <int L, class Lay>
int window_attn_blocks_per_sm() {
  int n = 0;
  if (window_attn_opt_in<L, Lay>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, window_attn_kernel<L, Lay>,
                                                    FwdGeom<L>::kThreads,
                                                    FwdGeom<L>::kSmemBytes) != cudaSuccess)
    return -1;
  return n;
}

// Launch of the forward core for window length L: `classes` mask classes
// (1 without a mask; n_windows a multiple of it), `wpb` windows per block
// (swin_block_v3.window_core_plan).
template <int L, class Lay>
cudaError_t launch_window_attn(const Lay& lay, const float* rel_bias, const float* mask,
                               int classes, int wpb, float scale, int n_windows, int num_heads,
                               cudaStream_t s) {
  using G = FwdGeom<L>;
  const cudaError_t err = window_attn_opt_in<L, Lay>();
  if (err != cudaSuccess) return err;
  if (!mask) classes = 1;
  if (n_windows <= 0 || num_heads <= 0 || num_heads > 65535 || classes <= 0 || wpb <= 0 ||
      n_windows % classes)
    return cudaErrorInvalidValue;
  const int per_class = n_windows / classes;
  dim3 grid(classes * ((per_class + wpb - 1) / wpb), num_heads);
  window_attn_kernel<L, Lay><<<grid, G::kThreads, G::kSmemBytes, s>>>(lay, rel_bias, mask,
                                                                     n_windows, classes, wpb,
                                                                     scale);
  return cudaGetLastError();
}

}  // namespace dsg
