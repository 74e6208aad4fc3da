// token_mlp_bwd: backward of the MLP half of a Swin block on Hopper.
//
// Replaces diffusesg_tpu/ops/mlp_block_kernel.py::_mlp_bwd_kernel (entry
// mlp_bwd_call) and ::_mlp_bwd_export_kernel, the variant the TPU needs at
// C = 768 because fp32 dW1/dW2 do not fit its VMEM.
//
// Forward:  out = x + fc2(gelu_erf(fc1(LN(x)))),  saved: x only.  Given x and
// dout [M, C], with hn = bf16(LN(x)), u = hn W1^T + b1, m = bf16(gelu(u)):
//   du = bf16((dout W2) gelu'(u)),  dhn = du W1,  dx = dout + LNvjp(dhn),
//   dW1 = du^T hn,  dW2 = dout^T m,  db1 = sum du,  db2 = sum dout,
//   d gamma = sum dhn hbar,  d beta = sum dhn,
// the GELU's derivative that of the exact erf form the forward uses.
//
// Bound on the H100: operations at C >= 192 (40 C^2 FLOP per token), bytes
// at C96 (x, dout, dx, and hn, m and du written once and read once more by
// the weight gradients: about 44 C bytes per token).  Two designs, both on
// wgmma:
//
// C = 96 and 192: one fused row-tile kernel (mlp_bwd_kernel) and the weight
// gradients.  A block owns 128 token rows, two consumer warpgroups of 64
// rows each and a producer warp.  Its prologue takes LN(x) into a resident
// swizzled panel (hg::LnPanel, as the forward GEMMs) and stores it once by
// TMA as hn; TMA brings dout into a second panel.  The block then walks the
// hidden dimension in chunks of 64, W1's chunk [64, C] and W2's [C, 64]
// streaming through a two-slot ring; per chunk a warpgroup computes
//   u = hn W1c^T and dm = dout W2c       (two wgmmas, K = C; W2c MN-major)
//   m = bf16(gelu(u + b1)), du = bf16(dm gelu'(u + b1))   in registers,
// stores m for the weight gradients, writes du into a swizzled tile that TMA
// stores as well, sums du's columns over its rows by warp shuffles (db1,
// one partial a warpgroup), and accumulates dhn += du W1c (du's tile as the
// K-major A, the same W1 chunk read MN-major) in a [64, C] fp32
// accumulator.  The epilogue stages dhn in the ring and x in the hn panel
// and does the LayerNorm vjp a row per warp, the row's statistics
// recomputed from x: dx = dout + LNvjp(dhn), and the block's partials of
// d gamma, d beta and db2.  Neither gelu'(u) nor dhn
// reaches device memory, and no row pass runs beside it.  C = 384 does not
// fit this tile: its [64, 384] fp32 dhn is 192 registers a thread beside the
// chunk's 64, over the 255 a thread can hold (and 128 rows of hn and dout
// panels with a two-slot ring of 96 KB chunks pass the 227 KB of shared
// memory); C = 768 doubles both.
//
// C = 384 and 768: the chain, every product on the wgmma GEMM: fc1
// recomputed with LN(x) as its panel prologue (hn stored from column split
// 0), m and gelu'(u) (fp16) from its epilogue; du = (dout W2) gelu'(u) with
// W2 read MN-major; dhn = du W1 (fp32) likewise, both on the 128 x 192
// streamed tile (hg::StreamWideT); the row pass
// (ln_bwd_rows) for dx, d gamma and d beta; col_sums for the biases.
//
// The weight gradients dW1 = du^T hn and dW2 = dout^T m are the token-axis
// contraction (backward.cuh, launch_wgrad) into one buffer of fp32 partials
// and one fixed-order reduction; every sum over tokens is reduced the same
// way, so the gradients are bit-equal from launch to launch.
#include "backward.cuh"

using namespace dsg;

#define DSG_TRY(...)                       \
  do {                                     \
    cudaError_t err_ = (__VA_ARGS__);      \
    if (err_ != cudaSuccess) return err_;  \
  } while (0)

namespace {

// The fused row tile at width C: 128 rows (two consumer warpgroups and a
// producer warpgroup, whose registers the consumers take: setmaxnreg), hidden
// chunks of 64, a two-slot ring; Ln: the LayerNorm prologue's lanes a row
// and rows a pass (as swin_attn's qkv prologue at the same width).
template <int C_, int MAXV, int ROWS, int LPR>
struct MlpBwdTile {
  static constexpr int C = C_, BM = 128, BH = 64, STAGES = 2;
  static constexpr int kSlices = (C + hg::kSlice - 1) / hg::kSlice;  // 64-column slices
  static constexpr int kConsumers = 256, kThreads = kConsumers + 128;
  // registers a thread of a consumer (producer) warpgroup holds: the [64, C]
  // fp32 dhn accumulator and a chunk's u and dm beside it
  static constexpr int kConsumerRegs = 232, kProducerRegs = 40;
  static_assert(kConsumers * kConsumerRegs + 128 * kProducerRegs <= 65536, "registers");
  static constexpr int kPanelBytes = BM * kSlices * hg::kSlice * 2;  // hn or dout
  static constexpr int kW1Bytes = kSlices * BH * hg::kSlice * 2;    // W1 rows [h0, h0 + 64) x C
  static constexpr int kW2Bytes = C * BH * 2;                       // W2 [C, h0 .. h0 + 64)
  static constexpr int kStageBytes = kW1Bytes + kW2Bytes;
  static constexpr int kTileBytes = 64 * BH * 2;  // a warpgroup's du tile
  static constexpr int kColBytes = 4 * BH * 4;     // its warps' column sums of du
  static constexpr size_t kSmemBytes =
      1024 + 2 * kPanelBytes + STAGES * kStageBytes + 2 * (kTileBytes + kColBytes);
  using Ln = hg::LnPanel<hg::PlainRows, MAXV, ROWS, LPR>;
  static_assert(C % 32 == 0 && kStageBytes % 1024 == 0, "tile");
  static_assert((size_t)BM * C * 4 <= (size_t)STAGES * kStageBytes, "dhn staging");
  static_assert(BM * C * 2 <= kPanelBytes, "x staging");
  static_assert(kSmemBytes <= (size_t)hg::kMaxDynSmem, "shared memory");
};

template <int C> struct MlpBwdConfig;
template <> struct MlpBwdConfig<96> { using T = MlpBwdTile<96, 1, 4, 16>; };
template <> struct MlpBwdConfig<192> { using T = MlpBwdTile<192, 1, 4, 32>; };

struct MlpBwdMaps {
  CUtensorMap dout, w1, w2;  // loads: dout [M, C], W1 [hidden, C], W2 [C, hidden]
  CUtensorMap hn, du;        // stores: hn [M, C], du [M, hidden]
};

// the 128 threads of warpgroup g (named barriers 2 and 3)
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + g) : "memory");
}

// grid ceil(M / 128), T::kThreads threads, T::kSmemBytes of dynamic shared
// memory.  part [2 * blocks, hidden + 3C]: row 2x + g holds warpgroup g of
// block x's column sums of du (db1), row 2x its block's d gamma | d beta |
// db2 and row 2x + 1 zeros there.
template <class T, class Site>
__global__ void __launch_bounds__(T::kThreads, 1)
mlp_bwd_kernel(const __grid_constant__ MlpBwdMaps maps, const bf16* __restrict__ x,
               const float* __restrict__ ln_g, const float* __restrict__ ln_b,
               const float* __restrict__ b1, bf16* __restrict__ m_out, float* __restrict__ part,
               bf16* __restrict__ dx, int M, int hidden) {
  constexpr int C = T::C, BM = T::BM, S = hg::kSlice;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[T::STAGES], empty[T::STAGES], dout_bar;
  unsigned char* base = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  bf16* hn_panel = reinterpret_cast<bf16*>(base);
  bf16* do_panel = reinterpret_cast<bf16*>(base + T::kPanelBytes);
  unsigned char* ring = base + 2 * T::kPanelBytes;
  bf16* tiles = reinterpret_cast<bf16*>(ring + T::STAGES * T::kStageBytes);

  const int m0 = blockIdx.x * BM, nch = hidden / T::BH, ld = hidden + 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      hg::mbar_init(&full[s], 1);
      hg::mbar_init(&empty[s], T::kConsumers / 32);
    }
    hg::mbar_init(&dout_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= T::kConsumers / 32) {  // the producer: dout's panel, then the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::kProducerRegs));
    if (warp == T::kConsumers / 32 && lane == 0) {
      hg::mbar_expect_tx(&dout_bar, T::kPanelBytes);
      for (int sl = 0; sl < T::kSlices; ++sl)
        hg::tma_load(&maps.dout, do_panel + sl * BM * S, &dout_bar, sl * S, m0);
      for (int j = 0; j < nch; ++j) {
        const int s = j % T::STAGES;
        hg::mbar_wait(&empty[s], ((j / T::STAGES) & 1) ^ 1);
        hg::mbar_expect_tx(&full[s], T::kStageBytes);
        unsigned char* slot = ring + s * T::kStageBytes;
        for (int sl = 0; sl < T::kSlices; ++sl)
          hg::tma_load(&maps.w1, slot + sl * T::BH * S * 2, &full[s], sl * S, j * T::BH);
        hg::tma_load(&maps.w2, slot + T::kW1Bytes, &full[s], j * T::BH, 0);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::kConsumerRegs));

  const int wg = warp >> 2, r0 = wg * 64, tid = threadIdx.x & 127;
  // LN(x) of the block's rows into the hn panel, stored once as hn
  const typename T::Ln ln{hg::PlainRows{x, C}, ln_g, ln_b};
  ln.fill(hn_panel, BM, m0, M, C, T::kConsumers / 32, warp, lane);
  hg::fence_proxy_async();
  hg::consumer_sync(T::kConsumers);
  if (threadIdx.x == 0) {
    for (int sl = 0; sl < T::kSlices; ++sl)
      hg::tma_store(&maps.hn, hn_panel + sl * BM * S, sl * S, m0);
    hg::bulk_commit();
  }
  hg::mbar_wait(&dout_bar, 0);

  bf16* dut = tiles + wg * 64 * T::BH;
  float* colsum = reinterpret_cast<float*>(tiles + 2 * 64 * T::BH) + wg * 4 * T::BH;
  float* part_b1 = part + (size_t)(2 * blockIdx.x + wg) * ld;
  // accumulator element (row, col) of a warpgroup: row 16 (warp % 4) + lane / 4
  // + 8 i, col 8 j + 2 (lane % 4) + {0, 1} -> acc[4 j + 2 i + {0, 1}]
  const int er = 16 * (warp & 3) + (lane >> 2), ec = 2 * (lane & 3);
  float acc_dhn[C / 2];
#pragma unroll
  for (int i = 0; i < C / 2; ++i) acc_dhn[i] = 0.f;

  for (int j = 0; j < nch; ++j) {
    const int s = j % T::STAGES, h0 = j * T::BH;
    hg::mbar_wait(&full[s], (j / T::STAGES) & 1);
    const bf16* w1c = reinterpret_cast<const bf16*>(ring + s * T::kStageBytes);
    const bf16* w2c = w1c + T::kW1Bytes / 2;
    // the previous chunk's store has read the du tile, its column sums are read
    if (tid == 0) hg::bulk_wait_read<0>();
    group_sync(wg);
    // u = hn W1c^T (W1's rows K-major), dm = dout W2c (W2's rows are K:
    // MN-major)
    constexpr int NP = T::BH;
    float acc_u[NP / 2], acc_dm[NP / 2];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc_u[i] = 0.f, acc_dm[i] = 0.f;
    hg::fence_regs(acc_u);
    hg::fence_regs(acc_dm);
    hg::wgmma_fence();
#pragma unroll
    for (int sl = 0; sl < T::kSlices; ++sl) {
      const uint64_t da = hg::sw128_desc(hn_panel + sl * BM * S + r0 * S);
      const uint64_t db = hg::sw128_desc(w1c + sl * T::BH * S);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (sl * S + 16 * t < C) hg::Wgmma<NP>::mma(acc_u, da + 2 * t, db + 2 * t);
    }
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      const uint64_t da = hg::sw128_desc(do_panel + (kk / 4) * BM * S + r0 * S) + 2 * (kk % 4);
      hg::Wgmma<NP, 0, 1>::mma(acc_dm, da, hg::mn128_desc(w2c, S * S * 2) + 128 * kk);
    }
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_regs(acc_u);
    hg::fence_regs(acc_dm);
    // m = bf16(gelu(u)) to device memory, du = bf16(dm gelu'(u)) into the
    // tile (rows past M zero), and du's column sums over the warp's rows
    float cs[NP / 8][2];
#pragma unroll
    for (int jj = 0; jj < NP / 8; ++jj) {
      const int col = 8 * jj;
      const float2 bias = *reinterpret_cast<const float2*>(b1 + h0 + col + ec);
      cs[jj][0] = cs[jj][1] = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = er + 8 * i;
        const bool live = m0 + r0 + r < M;
        float m_0, g0, m_1, g1;
        gelu_and_grad(acc_u[4 * jj + 2 * i] + bias.x, m_0, g0);
        gelu_and_grad(acc_u[4 * jj + 2 * i + 1] + bias.y, m_1, g1);
        const float d0 = live ? round_bf16(acc_dm[4 * jj + 2 * i] * g0) : 0.f;
        const float d1 = live ? round_bf16(acc_dm[4 * jj + 2 * i + 1] * g1) : 0.f;
        if (live)
          *reinterpret_cast<uint32_t*>(m_out + (size_t)(m0 + r0 + r) * hidden + h0 + col + ec) =
              pack_bf16(m_0, m_1);
        *reinterpret_cast<uint32_t*>(hg::swizzled(dut, 64, r, col) + ec) = pack_bf16(d0, d1);
        cs[jj][0] += d0;
        cs[jj][1] += d1;
      }
    }
    // the sums of the warp's 8 row groups (lanes alike mod 4), in a fixed order
#pragma unroll
    for (int jj = 0; jj < NP / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) cs[jj][e] += __shfl_xor_sync(0xffffffffu, cs[jj][e], o);
    if (lane < 4) {
#pragma unroll
      for (int jj = 0; jj < NP / 8; ++jj)
        *reinterpret_cast<float2*>(colsum + (warp & 3) * T::BH + 8 * jj + ec) =
            make_float2(cs[jj][0], cs[jj][1]);
    }
    hg::fence_proxy_async();
    group_sync(wg);
    if (tid == 0) {
      hg::tma_store(&maps.du, dut, h0, m0 + r0);
      hg::bulk_commit();
    }
    // dhn += du W1c: du's tile K-major (K = the chunk's 64 hidden columns),
    // the W1 chunk MN-major (its rows are K, C columns in 64-wide boxes)
    hg::fence_regs(acc_dhn);
    hg::wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)
      hg::Wgmma<C, 0, 1>::mma(acc_dhn, hg::sw128_desc(dut) + 2 * t,
                              hg::mn128_desc(w1c, T::BH * S * 2) + 128 * t);
    hg::wgmma_commit();
    // db1: the warpgroup's column sums of du, its four warps added in order
    if (tid < T::BH)
      part_b1[h0 + tid] = ((colsum[tid] + colsum[T::BH + tid]) + colsum[2 * T::BH + tid]) +
                          colsum[3 * T::BH + tid];
    hg::wgmma_wait<0>();
    hg::fence_regs(acc_dhn);
    if (lane == 0) hg::mbar_arrive(&empty[s]);
  }

  // epilogue: x of the block's rows into the hn panel (free once every u is
  // done and its store has read it), dhn staged in the ring (fp32 [BM, C],
  // columns swizzled within 32 by the row, so the accumulator's writes and
  // the row pass's reads spread over the banks), then the LayerNorm vjp a row
  // per warp, every operand in shared memory
  if (tid == 0) hg::bulk_wait_read<0>();
  hg::consumer_sync(T::kConsumers);  // both warpgroups are done with the ring and the panel
  bf16* xs = hn_panel;
  for (int i = threadIdx.x; i < BM * (C / 8); i += T::kConsumers) {
    const int r = i / (C / 8), k = (i - r * (C / 8)) * 8;
    const bool ok = m0 + r < M;
    cp_async16(xs + r * C + k, ok ? x + (size_t)(m0 + r) * C + k : x, ok);
  }
  cp_async_commit();
  float* st = reinterpret_cast<float*>(ring);
  auto sw = [](int r, int c) { return r * C + (c ^ ((r & 3) << 3)); };
#pragma unroll
  for (int jj = 0; jj < C / 8; ++jj)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + er + 8 * i;
      *reinterpret_cast<float2*>(st + sw(r, 8 * jj + ec)) =
          make_float2(acc_dhn[4 * jj + 2 * i], acc_dhn[4 * jj + 2 * i + 1]);
    }
  cp_async_wait<0>();
  hg::consumer_sync(T::kConsumers);

  constexpr int NV = C / 32;  // columns a lane: lane + 32 v
  float sg[NV], sb[NV], sd[NV], gam[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) sg[v] = sb[v] = sd[v] = 0.f, gam[v] = ld_ro(ln_g + lane + 32 * v);
  for (int r = warp; r < BM && m0 + r < M; r += T::kConsumers / 32) {
    const size_t m = (size_t)(m0 + r);
    float xv[NV], hb[NV], dh[NV], dov[NV];
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      xv[v] = __bfloat162float(xs[r * C + lane + 32 * v]);
      s += xv[v];
    }
    const float mean = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) q += (xv[v] - mean) * (xv[v] - mean);
    const float rstd = rsqrtf(warp_sum(q) / C + kLnEps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = lane + 32 * v;
      const float d = st[sw(r, c)];
      hb[v] = (xv[v] - mean) * rstd;
      dov[v] = __bfloat162float(*(hg::swizzled(do_panel, BM, r, c & ~7) + (c & 7)));
      sg[v] += d * hb[v];
      sb[v] += d;
      sd[v] += dov[v];
      dh[v] = d * gam[v];
      s1 += dh[v];
      s2 += dh[v] * hb[v];
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      dx[m * C + lane + 32 * v] = __float2bfloat16(dov[v] + rstd * (dh[v] - s1 - hb[v] * s2));
  }
  // the block's sums, warps added in order: d gamma | d beta | db2
  hg::consumer_sync(T::kConsumers);  // every row of the staged dhn is read
  float* red = st;  // [8 warps][3C]
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = lane + 32 * v;
    red[warp * 3 * C + c] = sg[v];
    red[warp * 3 * C + C + c] = sb[v];
    red[warp * 3 * C + 2 * C + c] = sd[v];
  }
  hg::consumer_sync(T::kConsumers);
  float* out = part + (size_t)2 * blockIdx.x * ld + hidden;
  for (int k = threadIdx.x; k < 3 * C; k += T::kConsumers) {
    float v = 0.f;
    for (int w = 0; w < T::kConsumers / 32; ++w) v += red[w * 3 * C + k];
    out[k] = v;
    out[ld + k] = 0.f;
  }
}

template <class T>
cudaError_t fused_ready() {
  static PerDevice ready;
  return ready.once([](int&) {
    return cudaFuncSetAttribute(mlp_bwd_kernel<T, MlpBwdFused>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)T::kSmemBytes);
  });
}

template <class T>
cudaError_t launch_fused(const void* x, const void* dout, const float* ln_g, const float* ln_b,
                         const void* w1, const float* b1, const void* w2, void* hn, void* m,
                         void* du, float* part, void* dx, int M, int hidden, cudaStream_t s) {
  constexpr int C = T::C;
  if (M <= 0 || hidden <= 0 || hidden % T::BH) return cudaErrorInvalidValue;
  MlpBwdMaps maps;
  if (!hg::make_map(&maps.dout, dout, C, M, T::BM) || !hg::make_map(&maps.w1, w1, C, hidden, T::BH) ||
      !hg::make_map(&maps.w2, w2, hidden, C, C) || !hg::make_map(&maps.hn, hn, C, M, T::BM) ||
      !hg::make_map(&maps.du, du, hidden, M, 64))
    return cudaErrorInvalidValue;
  DSG_TRY(fused_ready<T>());
  mlp_bwd_kernel<T, MlpBwdFused><<<(M + T::BM - 1) / T::BM, T::kThreads, T::kSmemBytes, s>>>(
      maps, static_cast<const bf16*>(x), ln_g, ln_b, b1, static_cast<bf16*>(m), part,
      static_cast<bf16*>(dx), M, hidden);
  return cudaGetLastError();
}

// `f` gets the fused tile of C (96, 192); -1 for a C the chain takes
template <class F>
int with_fused(int C, F f) {
  switch (C) {
    case 96: return f(MlpBwdConfig<96>::T{});
    case 192: return f(MlpBwdConfig<192>::T{});
    default: return -1;
  }
}

// The chain's fc1 recompute: LN(x) the panel's prologue (hn stored from
// column split 0), on swin_attn's qkv tiles at the same K (64-row panels
// above C384 or where `wide` asks for them, as swin_attn's with_tile)
template <class F>
int with_fc1_tile(int C, int wide, F f) {
  using hg::LnPanel;
  using hg::PlainRows;
  if (C % 32 || C <= 0 || C > 768) return -1;
  if (wide || C > 384) return f(hg::PanelWide{}, hg::StoreRows<LnPanel<PlainRows, 3, 2, 32>>{});
  if (C <= 128) return f(hg::PanelRows{}, hg::StoreRows<LnPanel<PlainRows, 1, 4, 16>>{});
  if (C <= 256) return f(hg::PanelRows{}, hg::StoreRows<LnPanel<PlainRows, 1, 4, 32>>{});
  return f(hg::PanelTall{}, hg::StoreRows<LnPanel<PlainRows, 2, 4, 32>>{});
}

}  // namespace

extern "C" int dsg_token_mlp_bwd(
    const void* x, const void* dout, const void* ln_g, const void* ln_b, const void* w1,
    const void* b1, const void* w2,
    // scratch
    void* hn_buf, void* m_buf, void* gp_buf, void* du_buf, void* dhn_buf, void* part_w,
    void* part_vec, void* part_b1, void* part_b2, void* part_ln,
    // outputs: dx [M, C]; dw [2, C * hidden] (dW1 [hidden, C], dW2 [C, hidden]);
    // vecs [hidden + 3C] (db1 | d gamma | d beta | db2)
    void* dx, void* dw, void* vecs,
    int M, int C, int hidden, int fused, int wide, int fc1_per, int dm_per, int dhn_per, int splits_w,
    int kchunk_w, int splits_b1, int splits_b2, int ln_blocks, void* stream) {
  if (M <= 0 || C % 32 || C > 768 || hidden % 64) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gamma = static_cast<const float*>(ln_g);
  const float* beta = static_cast<const float*>(ln_b);
  const float* bias1 = static_cast<const float*>(b1);
  float* vec = static_cast<float*>(vecs);
  if (fused) {
    const int blocks = (M + 127) / 128;
    const int rc = with_fused(C, [&](auto tile) -> int {
      return launch_fused<decltype(tile)>(x, dout, gamma, beta, w1, bias1, w2, hn_buf, m_buf,
                                          du_buf, static_cast<float*>(part_vec), dx, M, hidden, s);
    });
    if (rc != 0) return rc;
    DSG_TRY(reduce_partials(static_cast<const float*>(part_vec), vec, 1, 2 * blocks, hidden + 3 * C,
                            (size_t)hidden + 3 * C, 0, s));
  } else {
    const int rc = with_fc1_tile(C, wide, [&](auto tile, auto pro) -> int {
      using Pro = decltype(pro);
      const Pro fc1_pro{{hg::PlainRows{static_cast<const bf16*>(x), C}, gamma, beta},
                        static_cast<bf16*>(hn_buf)};
      const GeluAndGradEpi epi{{}, static_cast<bf16*>(m_buf), static_cast<__half*>(gp_buf), bias1,
                               hidden};
      return hg::launch<decltype(tile), MlpBwdFc1>(rows(x, C), fc1_pro, epi,
                                                   static_cast<const bf16*>(w1), M, hidden,
                                                   fc1_per, s);
    });
    if (rc != 0) return rc;
    const MulGradEpi epi_du{{}, static_cast<bf16*>(du_buf), static_cast<const __half*>(gp_buf),
                            hidden};
    DSG_TRY(hg::launch<hg::StreamWideT, MlpBwdDm>(rows(dout, C), hg::NoPanel{}, epi_du,
                                                   static_cast<const bf16*>(w2), M, hidden, dm_per,
                                                   s));
    DSG_TRY(col_sums(du_buf, static_cast<float*>(part_b1), vec, M, hidden, splits_b1, s));
    DSG_TRY(col_sums(dout, static_cast<float*>(part_b2), vec + hidden + 2 * C, M, C, splits_b2, s));
    const hg::F32Epi epi_dhn{{}, static_cast<float*>(dhn_buf), C};
    DSG_TRY(hg::launch<hg::StreamWideT, MlpBwdDhn>(rows(du_buf, hidden), hg::NoPanel{}, epi_dhn,
                                                    static_cast<const bf16*>(w1), M, C, dhn_per,
                                                    s));
    DSG_TRY(launch_ln_bwd_rows<false>(x, nullptr, dout, static_cast<const float*>(dhn_buf), gamma,
                                      dx, static_cast<float*>(part_ln), 1, M, C, ln_blocks, s));
    DSG_TRY(reduce_partials(static_cast<const float*>(part_ln), vec + hidden, 1, ln_blocks, 2 * C,
                            (size_t)2 * C, 0, s));
  }
  // dW1 [hidden, C] = du^T hn and dW2 [C, hidden] = dout^T m, one partial buffer
  const size_t ld = (size_t)2 * C * hidden;
  float* pw = static_cast<float*>(part_w);
  DSG_TRY(launch_wgrad<MlpBwdDw1>(du_buf, hn_buf, pw, ld, hidden, C, M, splits_w, kchunk_w, s));
  DSG_TRY(launch_wgrad<MlpBwdDw2>(dout, m_buf, pw + (size_t)C * hidden, ld, C, hidden, M,
                                  splits_w, kchunk_w, s));
  return reduce_partials(pw, static_cast<float*>(dw), 1, splits_w, 2 * C * hidden, ld, 0, s);
}

// The tiles of token_mlp_bwd's launches at width C, for the wrapper's plan:
// which = 0 the fused row tile {rows, hidden chunk, blocks an SM, 1} (-1 for
// a C the chain takes), 1 the chain's fc1 (64-row panels if `wide`), 2 its
// streamed products (dout W2, du W1); 3 the weight gradients' tile at C
// output columns ({rows, columns, blocks an SM, 0}); -1 for widths no tile
// covers.
extern "C" int dsg_token_mlp_bwd_tile(int C, int which, int wide, int* geom) {
  switch (which) {
    case 0:
      return with_fused(C, [&](auto tile) -> int {
        using T = decltype(tile);
        int per_sm = 0;
        cudaError_t err = fused_ready<T>();
        if (err == cudaSuccess)
          err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &per_sm, mlp_bwd_kernel<T, MlpBwdFused>, T::kThreads, T::kSmemBytes);
        if (err != cudaSuccess) return err;
        geom[0] = T::BM, geom[1] = T::BH, geom[2] = per_sm, geom[3] = 1;
        return 0;
      });
    case 1:
      return with_fc1_tile(C, wide, [&](auto tile, auto pro) -> int {
        return hg::tile_query<decltype(tile), MlpBwdFc1, decltype(pro), GeluAndGradEpi>(C, geom);
      });
    case 2:
      return hg::tile_query<hg::StreamWideT, MlpBwdDm, hg::NoPanel, MulGradEpi>(C, geom);
    case 3:
      return wgrad_tile<MlpBwdDw1>(C, geom);
    default:
      return -1;
  }
}
