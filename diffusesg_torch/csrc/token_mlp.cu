// token_mlp: the MLP half of a Swin block on Hopper, over flattened tokens.
//
// Replaces the MLP half of diffusesg_tpu/ops/swin_block_v3.py::_kernel and
// the whole of diffusesg_tpu/ops/mlp_block_kernel.py::_kernel (entry
// fused_mlp_block, which v3 calls for the C=768 blocks whose MLP does not
// fuse on the TPU):
//
//   out = x + bf16(fc2(bf16(gelu_erf(fc1(bf16(LN2(x))) + b1))) + b2)
//
// LN2 in fp32 (two passes), fc1 and fc2 accumulated in fp32, the exact erf
// GELU; the [M, 4C] hidden never reaches device memory, as the TPU kernel
// keeps it in VMEM.
//
// What bounds it on the H100.  A hidden element of a token costs 4 C tensor
// FLOP (fc1 and fc2) and about 25 instructions on the CUDA cores (bias, the
// branch-free erff, the product, the bf16 packing).  An SM does 4096 bf16 FLOP
// a clock on its tensor cores and issues 4 warp instructions: at C96 and C192
// the erf epilogue takes longer than the products (without it a chunk of 64
// hidden columns would take 0.8 and 1.1 us instead of 1.9 and 2.2 at 128
// rows); at C384 and C768 the products do (fc1 at 32 columns a warpgroup
// reads more shared memory a FLOP than the tensor cores take).  L2 is not the
// limit: a C384 chunk takes as long on 33 SMs as on 132.
//
// Design (token_mlp_kernel_wg, one instantiation per C, MlpConfig):
//   - a producer warp streams the weights by TMA (cp.async.bulk.tensor,
//     128-byte swizzle, tensor maps encoded per launch) into a ring of STAGES
//     slots guarded by mbarriers (hopper_gemm.cuh's pieces): per hidden chunk
//     of 64, F1 tiles of W1 (the chunk's 64 rows x up to 192 of C), then F2
//     tiles of W2 (192 of C's rows, or all C, x the chunk's 64 columns).  Its
//     warpgroup gives its registers to the consumers (setmaxnreg 40 / 232).
//     Ring depth: 12 slots of 8 or 16 KB (C64, C96), 7 of 24 KB (C192, C384),
//     5 of 24 KB beside C768's 96 KB panel;
//   - two consumer warpgroups; the block's LN2 rows are a resident swizzled
//     panel (hg::LnPanel, the qkv GEMM's prologue) that fc1 reads as its A;
//   - C <= 192, 128 rows a block: each warpgroup owns 64 rows and every fc2
//     column (C / 2 accumulator registers a thread).  fc1 on wgmma m64n64k16
//     from shared memory; bias + erf-GELU + bf16 in registers, where the fc1
//     accumulator is already fc2's A fragment: fc2 runs on wgmma m64nCk16
//     with A from registers.  The warpgroups ping-pong (named barriers 2 and 3
//     pass a turn): in its turn a warpgroup issues fc2 of chunk j - 1 and fc1
//     of chunk j, passes the turn, waits for them and runs chunk j's GELU while
//     the other warpgroup's products run;
//   - C >= 384, 64 rows a block: fc2's columns are split across the
//     warpgroups, 192 each (96 registers; a warpgroup holding 384 would need
//     192).  Each warpgroup runs fc1 for 32 of the chunk's 64 hidden columns
//     (m64n32k16, a group per W1 tile, each tile back to the ring as the next
//     is issued), GELUs them into a bf16 hidden tile in shared memory, and
//     after a barrier both multiply the whole tile by their W2 tile
//     (m64n192k16 from shared memory);
//   - C768 cuts a row tile's 768 fc2 columns into two column groups, a block
//     each (kGroups), which both recompute the rows' fc1 (1.5x the FLOP of the
//     MLP): a warpgroup cannot hold 64 x 384 fp32 beside fc1's registers;
//   - epilogue: a whole tile stages bf16(y + b2) in the panel and stores x +
//     it in 16-byte vectors; a part of one writes its fp32 partial.
//
// Grid plan (ops/mlp_block_kernel.py::mlp_fwd_plan, from the tile and the
// occupancy dsg_token_mlp_tile reports): a launch's work is T tiles (row
// tiles x column groups) x n hidden chunks, units u = (u / n, u % n), and
// block b of G takes units [b U / G, (b + 1) U / G) (Units).  Where whole
// tiles fill the card's waves, G = T and every block finishes its tile; else
// G = the SMs, each walking its share, a part of a tile at either end.  A
// tile cut between blocks is summed by the closing pass, its fp32 partials
// added in block order, then b2, the rounding and x, so the result is
// bit-equal from run to run (no atomics).  The wrapper allocates the
// partials: two slots a block.
#include "hopper_gemm.cuh"

using namespace dsg;

namespace {

// The units of a launch (tiles x hidden chunks) and their cut over G blocks:
// block b takes [start(b), start(b + 1)).
struct Units {
  long long U;  // tiles x n
  int n, G;     // hidden chunks a tile, blocks
  __host__ __device__ int start(int b) const { return (int)((long long)b * U / G); }
  // the block whose units hold u
  __host__ __device__ int block_of(long long u) const {
    return (int)(((u + 1) * G + U - 1) / U) - 1;
  }
  // the partial slot of block b's share of tile t: 2b for the tile it
  // begins in, 2b + 1 for the next
  __host__ __device__ int slot(int b, int t) const { return 2 * b + (start(b) / n != t); }
};

// ------------------------------------------------------------- the kernel

// The tile of one C: BM rows a block, hidden chunks of BH = 64.  kCols: fc2's
// columns split across the two consumer warpgroups (64 rows), else each owns
// 64 of 128 rows.  kGroups: the column groups a row tile's fc2 columns are cut
// into, one block each (a block recomputes its rows' fc1).  A chunk is F1 W1
// tiles of kSlices1 64-column slices of C, then the block's F2 W2 tiles of NT
// rows; a ring slot holds one.
template <int C_, int STAGES_, class Ln_>
struct MlpWgTile {
  static constexpr int C = C_, BH = 64, STAGES = STAGES_, S = hg::kSlice;
  static constexpr bool kCols = C >= 384;
  static constexpr int kGroups = C > 384 ? 2 : 1;
  static constexpr int CN = C / kGroups;                   // a block's fc2 columns
  static constexpr int BM = kCols ? 64 : 128;
  static constexpr int kSlices = (C + S - 1) / S;          // the panel's K slices
  static constexpr int kSlices1 = kCols ? 3 : kSlices;     // of a W1 tile
  static constexpr int F1 = kSlices / kSlices1, NT = kCols ? 192 : C, F2 = CN / NT;
  static constexpr int kTiles = F1 + F2;                   // ring tiles a chunk
  static constexpr int N1 = kCols ? BH / 2 : BH;           // fc1 columns a warpgroup
  static constexpr int N2 = kCols ? CN / 2 : C;            // fc2 columns a warpgroup
  static constexpr int kW1Bytes = kSlices1 * BH * S * 2, kW2Bytes = NT * BH * 2;
  static constexpr int kSlotBytes = kW1Bytes > kW2Bytes ? kW1Bytes : kW2Bytes;
  static constexpr int kPanelBytes = BM * kSlices * S * 2;
  static constexpr int kHidBytes = kCols ? BM * BH * 2 : 0;  // the bf16 hidden tile
  static constexpr int kSmemBytes = 1024 + kPanelBytes + STAGES * kSlotBytes + kHidBytes;
  static constexpr int kConsumers = 256, kThreads = kConsumers + 128;
  static constexpr int kConsumerRegs = 232, kProducerRegs = 40;
  using Ln = Ln_;
  static_assert(kConsumers * kConsumerRegs + 128 * kProducerRegs <= 65536, "registers");
  static_assert(kSlices % kSlices1 == 0 && CN % NT == 0 && NT <= 256 && C % 32 == 0, "tile");
  static_assert(!kCols || F2 == 2, "one W2 tile a warpgroup");
  // the ring holds what the warpgroups have not released while one waits
  // for its next tiles (ping-pong: chunk j - 1's W2 and chunk j's W1, and
  // the other's a chunk behind; split columns: chunk j - 1's W2 and two W1
  // tiles), with room to load ahead
  static_assert(STAGES >= 3 && STAGES > (kCols ? F2 + 2 : 2 * kTiles), "ring depth");
  static_assert(kSmemBytes <= hg::kMaxDynSmem, "shared memory");
};

struct MlpMaps {
  CUtensorMap w1, w2;  // W1 [hidden, C] in boxes {64, 64}; W2 [C, hidden] in {64, NT}
};

// a turn of the tensor cores for warpgroup g (named barriers 2 and 3): g
// waits for it, or passes it to g
__device__ __forceinline__ void turn_wait(int g) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(2 + g) : "memory");
}
__device__ __forceinline__ void turn_pass(int g) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 + g) : "memory");
}

// grid G (the plan's blocks), T::kThreads threads, T::kSmemBytes of dynamic
// shared memory.  Its units' tiles t are row tile t / kGroups, column group t
// % kGroups.  part: two [BM, CN] fp32 slots a block (Units::slot), for tiles
// the block has a part of.
template <class T>
__global__ void __launch_bounds__(T::kThreads, 1)
token_mlp_kernel_wg(const __grid_constant__ MlpMaps maps, const bf16* __restrict__ x,
                    const float* __restrict__ ln_g, const float* __restrict__ ln_b,
                    const float* __restrict__ b1, const float* __restrict__ b2,
                    float* __restrict__ part, bf16* __restrict__ out, int M, const Units un) {
  constexpr int C = T::C, BM = T::BM, BH = T::BH, S = T::S, ST = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[ST], empty[ST];
  unsigned char* base = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  bf16* panel = reinterpret_cast<bf16*>(base);
  unsigned char* ring = base + T::kPanelBytes;
  bf16* hid = reinterpret_cast<bf16*>(ring + ST * T::kSlotBytes);

  const int n = un.n, u0 = un.start(blockIdx.x), u1 = un.start(blockIdx.x + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      hg::mbar_init(&full[s], 1);
      hg::mbar_init(&empty[s], T::kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= T::kConsumers / 32) {  // the producer: every unit's tiles, in order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::kProducerRegs));
    if (warp == T::kConsumers / 32 && lane == 0) {
      int it = 0;
      for (int u = u0; u < u1; ++u) {
        const int h0 = (u % n) * BH, cg = (u / n) % T::kGroups;
        for (int k = 0; k < T::kTiles; ++k, ++it) {  // W1 tiles (k < F1), then W2 tiles
          const int s = it % ST;
          hg::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
          unsigned char* slot = ring + s * T::kSlotBytes;
          if (k < T::F1) {
            hg::mbar_expect_tx(&full[s], T::kW1Bytes);
            for (int q = 0; q < T::kSlices1; ++q)
              hg::tma_load(&maps.w1, slot + q * BH * S * 2, &full[s], (k * T::kSlices1 + q) * S, h0);
          } else {
            hg::mbar_expect_tx(&full[s], T::kW2Bytes);
            hg::tma_load(&maps.w2, slot, &full[s], h0, cg * T::CN + (k - T::F1) * T::NT);
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::kConsumerRegs));

  const int wg = warp >> 2;
  // accumulator element (row, col) of a warpgroup: row er + 8 i, col 8 j + ec
  // + {0, 1} -> acc[4 j + 2 i + {0, 1}]
  const int er = 16 * (warp & 3) + (lane >> 2), ec = 2 * (lane & 3);
  const int r0 = T::kCols ? 0 : 64 * wg;  // the warpgroup's first row
  const typename T::Ln ln{hg::PlainRows{x, C}, ln_g, ln_b};
  auto slot_of = [&](int i) { return reinterpret_cast<const bf16*>(ring + (i % ST) * T::kSlotBytes); };
  auto wait_full = [&](int i) { hg::mbar_wait(&full[i % ST], (i / ST) & 1); };
  auto release = [&](int i) {
    if (lane == 0) hg::mbar_arrive(&empty[i % ST]);
  };
  // fc1's products with W1 tile f of a chunk, at ring position i: acc +=
  // panel rows x the warpgroup's columns of the tile (tile 0's first
  // product overwrites acc)
  auto fc1_tile = [&](int i, int f, float (&acc)[T::N1 / 2]) {
    const bf16* w = slot_of(i) + (T::kCols ? 32 * wg * S : 0);
#pragma unroll
    for (int q = 0; q < T::kSlices1; ++q) {
      const int sl = f * T::kSlices1 + q;
      const uint64_t da = hg::sw128_desc(panel + sl * BM * S + r0 * S);
      const uint64_t db = hg::sw128_desc(w + q * BH * S);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (sl * S + 16 * t < C) hg::Wgmma<T::N1>::mma(acc, da + 2 * t, db + 2 * t, sl + t > 0);
    }
  };
  // bias + erf-GELU of the warpgroup's fc1 columns of chunk h0, as bf16 pairs
  // in accumulator order (element pair p: row er + 8 (p & 1), col 8 (p / 2) +
  // ec): fc2's A fragments where a warpgroup owns its rows
  auto gelu = [&](int h0, const float (&acc)[T::N1 / 2], uint32_t (&h)[T::N1 / 4]) {
#pragma unroll
    for (int p = 0; p < T::N1 / 4; ++p) {
      const float2 bias = *reinterpret_cast<const float2*>(b1 + h0 + 8 * (p >> 1) + ec);
      h[p] = pack_bf16(gelu_erf(acc[2 * p] + bias.x), gelu_erf(acc[2 * p + 1] + bias.y));
    }
  };

  if (!T::kCols && wg == 1) turn_pass(0);  // warpgroup 0 takes the first turn
  float acc2[T::N2 / 2];
  int it = 0;  // ring tiles taken so far; every warpgroup walks every tile
  for (int t = u0 / n; t * n < u1; ++t) {
    const int cb = max(u0, t * n) - t * n, segs = min(u1, (t + 1) * n) - t * n - cb;
    const int m0 = t / T::kGroups * BM, c0 = t % T::kGroups * T::CN;
    const int n0 = c0 + (T::kCols ? T::N2 * wg : 0);  // the warpgroup's first fc2 column
    if (t != u0 / n) hg::consumer_sync(T::kConsumers);  // the last tile's epilogue read the panel
    ln.fill(panel, BM, m0, M, C, T::kConsumers / 32, warp, lane);
    hg::fence_proxy_async();
    hg::consumer_sync(T::kConsumers);

    if constexpr (!T::kCols) {
      // ping-pong: in its turn a warpgroup issues fc2 of chunk j - 1 (A: the
      // fragments of its GELU) and fc1 of chunk j as one group, passes the
      // turn, waits for them and runs chunk j's GELU while the other
      // warpgroup's products run.  Ring tiles of chunk j: 2j (W1), 2j + 1 (W2).
      float acc1[T::N1 / 2];
      uint32_t h[T::N1 / 4];
      auto fc2 = [&](int j) {  // the segment's first fc2 overwrites acc2
        wait_full(it + 2 * j + 1);
        const uint64_t db = hg::sw128_desc(slot_of(it + 2 * j + 1));
#pragma unroll
        for (int kk = 0; kk < BH / 16; ++kk)
          hg::WgmmaRs<C>::mma(acc2, h + 4 * kk, db + 2 * kk, j + kk > 0);
      };
      for (int j = 0; j <= segs; ++j) {
        turn_wait(wg);
        hg::wgmma_fence();
        if (j > 0) fc2(j - 1);
        if (j < segs) {
          wait_full(it + 2 * j);
          fc1_tile(it + 2 * j, 0, acc1);
        }
        hg::wgmma_commit();
        turn_pass(1 - wg);
        hg::wgmma_wait<0>();
        hg::fence_regs(acc1);
        if (j > 0) release(it + 2 * (j - 1) + 1);
        if (j < segs) {
          release(it + 2 * j);
          gelu((cb + j) * BH, acc1, h);
        }
      }
    } else {
      // split columns, W1 streamed: each W1 tile's products are a group, and
      // issuing one waits for the group before (the last tile's, or fc2 of
      // the chunk before), whose tiles go back to the ring.  Then chunk j's
      // GELU into the hidden tile and, after a barrier, its fc2.  Ring tiles
      // of chunk j: kTiles j + f (W1), kTiles j + F1 + k (W2).
      float acc1[T::N1 / 2];
      for (int j = 0; j < segs; ++j) {
        const int i = it + T::kTiles * j;
#pragma unroll
        for (int f = 0; f < T::F1; ++f) {
          wait_full(i + f);
          hg::wgmma_fence();
          fc1_tile(i + f, f, acc1);
          hg::wgmma_commit();
          hg::wgmma_wait<1>();
          if (f > 0) {
            release(i + f - 1);
          } else if (j > 0) {
#pragma unroll
            for (int k = T::F1; k < T::kTiles; ++k) release(i - T::kTiles + k);
          }
        }
        hg::wgmma_wait<0>();
        hg::fence_regs(acc1);
        release(i + T::F1 - 1);
        uint32_t h[T::N1 / 4];
        gelu((cb + j) * BH + 32 * wg, acc1, h);
        hg::consumer_sync(T::kConsumers);  // both warpgroups' fc2 of chunk j - 1 read the tile
#pragma unroll
        for (int p = 0; p < T::N1 / 4; ++p) {
          const int row = er + 8 * (p & 1), col = 32 * wg + 8 * (p >> 1) + ec;
          *reinterpret_cast<uint32_t*>(hg::swizzled(hid, BM, row, col & ~7) + (col & 7)) = h[p];
        }
        hg::fence_proxy_async();
        hg::consumer_sync(T::kConsumers);  // both halves of the tile are written
#pragma unroll
        for (int k = T::F1; k < T::kTiles; ++k) wait_full(i + k);
        const uint64_t da = hg::sw128_desc(hid);
        const uint64_t db = hg::sw128_desc(slot_of(i + T::F1 + wg));
        hg::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BH / 16; ++kk)
          hg::Wgmma<T::N2>::mma(acc2, da + 2 * kk, db + 2 * kk, j + kk > 0);
        hg::wgmma_commit();
      }
      hg::wgmma_wait<0>();
#pragma unroll
      for (int k = T::F1; k < T::kTiles; ++k) release(it + T::kTiles * (segs - 1) + k);
    }
    hg::fence_regs(acc2);
    it += segs * T::kTiles;

    if (segs < n) {  // a part of the tile: its fp32 partial, b2 and x in the closing pass
      float* p = part + (size_t)un.slot(blockIdx.x, t) * BM * T::CN;
#pragma unroll
      for (int j = 0; j < T::N2 / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = r0 + er + 8 * i;
          if (m0 + row < M)
            *reinterpret_cast<float2*>(p + (size_t)row * T::CN + n0 - c0 + 8 * j + ec) =
                make_float2(acc2[4 * j + 2 * i], acc2[4 * j + 2 * i + 1]);
        }
      continue;
    }
    // the whole tile: bf16(y + b2) into the panel (every fc1 of both
    // warpgroups is done), then out = x + it in 16-byte vectors
    hg::consumer_sync(T::kConsumers);
#pragma unroll
    for (int j = 0; j < T::N2 / 8; ++j) {
      const int col = n0 + 8 * j + ec;
      const float2 bias = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + er + 8 * i;
        *reinterpret_cast<uint32_t*>(hg::swizzled(panel, BM, row, col & ~7) + (col & 7)) =
            pack_bf16(acc2[4 * j + 2 * i] + bias.x, acc2[4 * j + 2 * i + 1] + bias.y);
      }
    }
    hg::consumer_sync(T::kConsumers);
    for (int v = threadIdx.x; v < BM * (T::CN / 8); v += T::kConsumers) {
      const int r = v / (T::CN / 8), k = c0 + (v % (T::CN / 8)) * 8;
      if (m0 + r >= M) continue;
      float xv[8], yv[8];
      load8(x + (size_t)(m0 + r) * C + k, xv);
      load8(hg::swizzled(panel, BM, r, k), yv);
#pragma unroll
      for (int q = 0; q < 8; ++q) xv[q] += yv[q];
      store8(out + (size_t)(m0 + r) * C + k, xv);
    }
  }
  if (!T::kCols && wg == 0) turn_wait(0);  // warpgroup 1's last pass
}

// ------------------------------------------------------ the closing pass

// out = x + bf16(sum of a cut tile's partials + b2), the partials added in
// the order of their blocks.  Blocks (i, y) take the tile that block i of the
// main launch began and left unfinished at its end, if there is one, each y a
// run of 256 vectors of 8.  Tile t: row tile t / groups, columns [c0, c0 +
// CN), c0 = t % groups CN.
__global__ void __launch_bounds__(256)
mlp_close_kernel(const float* __restrict__ part, const float* __restrict__ b2,
                 const bf16* __restrict__ x, bf16* __restrict__ out, int M, int C, int BM,
                 int groups, const Units un) {
  const int i = blockIdx.x, n = un.n, CN = C / groups;
  const int u0 = un.start(i), u1 = un.start(i + 1), t = (u1 - 1) / n;
  if (t * n < u0 || (t + 1) * n <= u1) return;  // begun before block i, or whole in it
  const int last = un.block_of((long long)(t + 1) * n - 1);
  const int m0 = t / groups * BM, c0 = t % groups * CN, rows = min(BM, M - m0);
  for (int e = (blockIdx.y * blockDim.x + threadIdx.x) * 8; e < rows * CN;
       e += gridDim.y * blockDim.x * 8) {
    const int r = e / CN, col = e % CN;
    float y[8] = {};
    for (int b = i; b <= last; ++b) {
      const float* p = part + ((size_t)un.slot(b, t) * BM + r) * CN + col;
      const float4 lo = *reinterpret_cast<const float4*>(p);
      const float4 hi = *reinterpret_cast<const float4*>(p + 4);
      y[0] += lo.x, y[1] += lo.y, y[2] += lo.z, y[3] += lo.w;
      y[4] += hi.x, y[5] += hi.y, y[6] += hi.z, y[7] += hi.w;
    }
    const size_t at = (size_t)(m0 + r) * C + c0 + col;
    float xv[8];
    load8(x + at, xv);
#pragma unroll
    for (int q = 0; q < 8; ++q) xv[q] += round_bf16(y[q] + b2[c0 + col + q]);
    store8(out + at, xv);
  }
}

// ------------------------------------------------------------------- host

// The tile each C runs.
template <int C> struct MlpConfig;
template <> struct MlpConfig<64> {
  using T = MlpWgTile<64, 12, hg::LnPanel<hg::PlainRows, 1, 4, 16>>;
};
template <> struct MlpConfig<96> {
  using T = MlpWgTile<96, 12, hg::LnPanel<hg::PlainRows, 1, 4, 16>>;
};
template <> struct MlpConfig<192> {
  using T = MlpWgTile<192, 7, hg::LnPanel<hg::PlainRows, 1, 4, 32>>;
};
template <> struct MlpConfig<384> {
  using T = MlpWgTile<384, 7, hg::LnPanel<hg::PlainRows, 2, 2, 32>>;
};
template <> struct MlpConfig<768> {
  using T = MlpWgTile<768, 5, hg::LnPanel<hg::PlainRows, 3, 1, 32>>;
};

// Opt the kernel into its dynamic shared memory (once on each device; the
// result is kept).
template <class T>
cudaError_t token_mlp_opt_in() {
  static PerDevice ready;
  return ready.once([](int&) {
    return cudaFuncSetAttribute(token_mlp_kernel_wg<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  });
}

// geom = {BM, BH, blocks an SM holds as the card reports it for the kernel's
// registers and shared memory, column groups}: what the wrapper's grid plan
// needs.
template <class T>
int token_mlp_tile(int* geom) {
  int per_sm = 0;
  if (token_mlp_opt_in<T>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, token_mlp_kernel_wg<T>, T::kThreads,
                                                    T::kSmemBytes) != cudaSuccess ||
      per_sm <= 0)
    return -2;
  geom[0] = T::BM, geom[1] = T::BH, geom[2] = per_sm, geom[3] = T::kGroups;
  return 0;
}

template <class T>
cudaError_t launch_token_mlp(const bf16* x, const float* ln_g, const float* ln_b, const bf16* w1,
                             const float* b1, const bf16* w2, const float* b2, float* part,
                             bf16* out, int M, int hidden, int blocks, cudaStream_t s) {
  const cudaError_t opt = token_mlp_opt_in<T>();
  if (opt != cudaSuccess) return opt;
  const int tiles = (M + T::BM - 1) / T::BM * T::kGroups, nch = hidden / T::BH;
  const Units un{(long long)tiles * nch, nch, blocks};
  const bool whole = tiles % blocks == 0;  // every block takes whole tiles
  if (hidden % T::BH || blocks <= 0 || blocks > un.U || (!whole && !part))
    return cudaErrorInvalidValue;
  MlpMaps maps;
  if (!hg::make_map(&maps.w1, w1, T::C, hidden, T::BH) ||
      !hg::make_map(&maps.w2, w2, hidden, T::C, T::NT))
    return cudaErrorInvalidValue;
  token_mlp_kernel_wg<T><<<blocks, T::kThreads, T::kSmemBytes, s>>>(maps, x, ln_g, ln_b, b1, b2,
                                                                     part, out, M, un);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || whole) return err;
  const dim3 grid(blocks, (T::BM * T::CN / 8 + 255) / 256);
  mlp_close_kernel<<<grid, 256, 0, s>>>(part, b2, x, out, M, T::C, T::BM, T::kGroups, un);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dsg_token_mlp(const void* x, const void* ln_g, const void* ln_b, const void* w1,
                             const void* b1, const void* w2, const void* b2, void* part,
                             void* out, int M, int C, int hidden, int blocks, void* stream) {
  if (M <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto launch) {
    return launch(static_cast<const bf16*>(x), static_cast<const float*>(ln_g),
                  static_cast<const float*>(ln_b), static_cast<const bf16*>(w1),
                  static_cast<const float*>(b1), static_cast<const bf16*>(w2),
                  static_cast<const float*>(b2), static_cast<float*>(part),
                  static_cast<bf16*>(out), M, hidden, blocks, s);
  };
  switch (C) {
    case 64: return run(launch_token_mlp<MlpConfig<64>::T>);
    case 96: return run(launch_token_mlp<MlpConfig<96>::T>);
    case 192: return run(launch_token_mlp<MlpConfig<192>::T>);
    case 384: return run(launch_token_mlp<MlpConfig<384>::T>);
    case 768: return run(launch_token_mlp<MlpConfig<768>::T>);
    default: return -1;
  }
}

// The tile of C and its occupancy (token_mlp_tile); -1 for a C it is not
// built for.
extern "C" int dsg_token_mlp_tile(int C, int* geom) {
  switch (C) {
    case 64: return token_mlp_tile<MlpConfig<64>::T>(geom);
    case 96: return token_mlp_tile<MlpConfig<96>::T>(geom);
    case 192: return token_mlp_tile<MlpConfig<192>::T>(geom);
    case 384: return token_mlp_tile<MlpConfig<384>::T>(geom);
    case 768: return token_mlp_tile<MlpConfig<768>::T>(geom);
    default: return -1;
  }
}
