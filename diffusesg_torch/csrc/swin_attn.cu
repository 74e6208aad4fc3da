// swin_attn: the attention half of one Swin block on Hopper, as one kernel.
//
// Replaces diffusesg_tpu/ops/swin_block_v3.py::_kernel (entry
// fused_swin_block_v3), attention half:
//
//   a   = silu(shift + x * (scale + 1))                    (noise affine)
//   y   = a + proj(W-MSA(qkv(LN1(a))))                      (+ shift mask)
//
// What bounds it on the H100: operations.  Per token the block does 8 C^2 +
// 4 L C multiply-adds against 4 C bytes of x in and y out, far above the
// card's ~295 FLOP/byte ridge for C >= 96.  Run as three launches (qkv GEMM,
// window core, proj GEMM), it moved 18 C bytes a token more than that through
// device memory (qkv written and read back, 12 C; the attention output
// written and read, 4 C; x read again for the residual, 2 C) and paid three
// wave tails.  Here q, k, v and the attention output never leave the SM, as
// the TPU kernel keeps them in VMEM.  What the clock64 stamps of a block
// showed instead (VG 64x64 C96 and COCO 40x40 C96, batch 64): every phase
// waits on latency, not on the tensor cores.  The LN1 prologue (its SiLU)
// was a third of a block, the bias gathered from device memory in the
// accumulator layout (eight rows a load) half of each head's attention, and
// a lane of heads alone left the tensor cores idle through its softmax.
// Hence the design:
//   - a block takes one window (R rows: 64 at L = 64; a window of 100
//     padded to 112) and a group of heads; its rows are gathered through
//     window_token_row once, into a table in shared memory, so the cyclic
//     roll of shifted windows stays index math and the block consumes and
//     produces the unrolled layout;
//   - prologue: the noise affine and LN1 of its rows, once, into a resident
//     128-byte-swizzled panel (hg::LnPanel, two-pass fp32 statistics, a and
//     LN1(a) rounded to bf16 as the plain version rounds them, every lane
//     of a row busy); a itself goes into y's rows, where the epilogue adds
//     the projection to it (the SiLU once a token, not twice);
//   - a producer warp streams, by TMA into a ring of 12 KB slots guarded by
//     mbarriers, each head's 96 rows of Wqkv (its q, k and v rows) a K slice
//     at a time, then the group's columns of Wproj in tiles of NP output
//     columns; where shared memory allows, three more producer warps stage
//     each head's rel_bias (+ mask[class]) ahead, in float4 rows, into
//     buffers laid out for the accumulator's reads (stage_table);
//   - per head: one or two consumer warpgroups (a 64-row m-tile each; at
//     R = 112 the second starts at row 48) compute q, k, v on wgmma
//     (m64n96k16) from the panel, add bqkv and round to bf16 into shared
//     memory (padded tokens zero); then a warp per 16 query rows runs the
//     window core's mma.sync steps (window_scores, window_softmax, P V:
//     fp32 scores and softmax in registers, P rounded to bf16); O, rounded
//     to bf16, goes into a second swizzled panel at the head's 32 columns.
//     At C >= 192 (L = 64) two head lanes of one warpgroup each work on
//     alternate heads, so one lane's products run under the other's softmax;
//     they take the ring's units in turn (turn_wait / turn_pass);
//   - proj: the O panel times the group's Wproj columns on wgmma, NP output
//     columns at a time; the epilogue adds bproj and the residual a and
//     writes y in bf16.
// Where whole windows with every head cannot fill one wave of resident
// blocks (few windows: VG's 8x8 C768, COCO's 10x10 C384), or a block cannot
// hold every head's output (GMAX), the plan (swin_block_v3.attn_plan, from
// dsg_swin_attn_tile's tile and occupancy) splits the heads into groups over
// grid y; each group writes its proj sums as fp32 partials and a closing pass
// (window_attn_kernel_close) adds them in group order with bproj and a.  No
// atomics: a relaunch is bit-equal, and a row's sums do not depend on which
// block or tile position it falls in.
#include "swin_window.cuh"

using namespace dsg;

namespace {

// The block's rows as the LN1 panel's source: panel row r is x's row
// rows[r] (the table in shared memory); every row of a window is of one
// sample, whose scale | shift row ss (staged in shared memory) is.  The
// noise affine's output a (bf16-valued) is also stored into y's own rows
// (`keep`), where the epilogue (or the closing pass) adds the projection to
// it: the residual is formed once.
struct WindowRows {
  static constexpr int kPieces = 1;
  const bf16* x;
  const int* rows;
  const bf16* ss;
  bf16* keep;
  int C;
  __device__ const bf16* piece(int r, int) const { return x + (size_t)rows[r] * C; }
  __device__ void pre8(int r, int k, float v[8]) const {
    float sc[8], sh[8];
    load8(ss + k, sc);
    load8(ss + C + k, sh);
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = noise_affine(v[t], sc[t], sh[t]);
    store8(keep + (size_t)rows[r] * C + k, v);
  }
};

// rel_bias[h] + mask[class] of score row r, columns c and c + 1, from device
// memory; zero outside the window.  The sum is the one stage_bias forms.
template <int L>
struct TableBias {
  const float* rel;
  const float* mask;  // null: none
  __device__ float2 operator()(int r, int c) const {
    if (r >= L || c >= L) return make_float2(0.f, 0.f);
    float2 b = __ldg(reinterpret_cast<const float2*>(rel + r * L + c));
    if (mask) {
      const float2 m = __ldg(reinterpret_cast<const float2*>(mask + r * L + c));
      b.x += m.x, b.y += m.y;
    }
    return b;
  }
};

// 16 bytes from L2 (this kernel wrote them: not through the read-only path
// or L1), and their conversion
__device__ __forceinline__ uint4 ld_cg16(const void* p) {
  uint4 u;
  asm volatile("ld.global.cg.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
               : "l"(p));
  return u;
}
__device__ __forceinline__ void unpack8(const uint4& u, float v[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

// The tile of one (C, L).  A block takes one window: R rows, RT 64-row
// m-tiles (the last one ending at row R), at most GMAX heads (the O panel's
// width).  LANES head lanes of RT consumer warpgroups each work on the
// block's heads in turn (lane l takes heads l, l + LANES, ...), each with a
// stage of its own; every consumer warp builds the LN1 panel and takes part
// in proj (the lanes alternate over the column tiles too).  A ring of STAGES
// 12 KB slots; NB staged bias buffers [L][LdB] (0: each warp reads its
// elements of rel_bias + mask from device memory); MINB blocks an SM asked of
// the register allocation; the LN1 prologue's row grouping Ln.  Shared
// memory: the LN1 panel [KS][R][64], the O panel [KO][R][64], the ring, the
// lanes' stages of q, k, v ([LANES][3][LP][kLdQ]; the proj epilogue's tiles
// reuse them), the bias buffers, and the block's vectors: its sample's
// scale | shift row (bf16) and bproj.  The producer is a warp, or with two
// consumer warpgroups or staged bias a warpgroup: warp 0 streams the ring,
// warps 1..3 stage the bias.
template <int C_, int L_, int LANES_, int GMAX_, int STAGES_, int NB_, int MINB_, class Ln_>
struct AttnTile {
  static constexpr int C = C_, L = L_, LANES = LANES_, GMAX = GMAX_, STAGES = STAGES_,
                       NB = NB_, MINB = MINB_, S = hg::kSlice;
  using G = FwdGeom<L>;
  using Ln = Ln_;
  static constexpr int LP = G::LP, R = LP;
  static constexpr int RT = (R + 63) / 64;       // m-tiles = warpgroups of a lane
  static constexpr int NWG = RT * LANES;
  static constexpr int kLaneWarps = 4 * RT;      // consumer warps of a lane
  static constexpr int kConsumers = 128 * NWG;
  static constexpr int kProducers = NWG > 1 || NB > 0 ? 128 : 32;
  static constexpr int kThreads = kConsumers + kProducers;
  static constexpr int KS = (C + S - 1) / S;          // K slices of qkv (the LN1 panel)
  static constexpr int KO = (kHD * GMAX + S - 1) / S;  // K slices of proj (the O panel)
  static constexpr int NP = C % 96 == 0 ? 96 : 64;    // proj columns a tile
  static constexpr int kSlotBytes = 96 * S * 2;        // a head's q, k, v rows or NP proj rows
  static constexpr int kLnBytes = R * KS * S * 2, kOBytes = R * KO * S * 2;
  static constexpr int kStageBytes = 3 * LP * kLdQ * 2;  // a lane's
  static constexpr int kEpiLd = 36;  // floats a row of a warp's epilogue tile (16 x 32)
  static_assert(kLaneWarps * 16 * kEpiLd * 4 <= kStageBytes, "epilogue tiles in the stage");
  static constexpr int kBiasBytes = L * G::LdB * 4;
  static constexpr int kVecBytes = 2 * C * 2 + C * 4;  // ss row; bproj
  static constexpr int kSmemBytes = 1024 + kLnBytes + kOBytes + STAGES * kSlotBytes +
                                    LANES * kStageBytes + NB * kBiasBytes + kVecBytes;
  static_assert(C % 32 == 0 && C % NP == 0 && C <= 768, "tile");
  static_assert(R >= 64 && R <= 128 && NWG <= 2, "rows and warpgroups");
  static_assert(G::NT <= kLaneWarps, "a warp per 16 query rows");
  static_assert(NB == 0 || kProducers == 128, "bias staged by producer warps 1..3");
  static_assert(STAGES >= 2 && kSmemBytes <= hg::kMaxDynSmem, "shared memory");
  // the first row of m-tile t
  __device__ static int m_tile(int t) { return min(64 * t, R - 64); }
};

struct AttnMaps {
  CUtensorMap wqkv, wproj;  // Wqkv [3C, C] in boxes {64, 32}; Wproj [C, C] in boxes {64, NP}
};

struct AttnArgs {
  const bf16* x;
  const bf16* ss;
  const float* ln_g;
  const float* ln_b;
  const float* bqkv;
  const float* bproj;
  const float* rel;   // [nH, L, L]
  const float* mask;  // [classes, L, L] or null
  float* part;        // [groups, M, C] where the heads are split
  bf16* out;
  int M, H, W, window, shift, classes, heads, gh;
  float scale;
};

// a lane's consumer threads only (named barriers 2 and 3)
template <class T>
__device__ __forceinline__ void lane_sync(int l) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(2 + l), "n"(T::kLaneWarps * 32) : "memory");
}

// The ring's turn between two lanes (named barriers 4 and 5): lane l waits
// for it, or passes it to lane l.  The lanes take the ring's units (a head's
// q, k, v slices, a proj tile's slices) in turn, so every slot is waited for
// in the order it was filled: an mbarrier's parity tells two phases apart
// only while no waiter runs a whole ring ahead of the slot's last filling.
template <class T>
__device__ __forceinline__ void turn_wait(int l) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(4 + l), "n"(T::kConsumers) : "memory");
}
template <class T>
__device__ __forceinline__ void turn_pass(int l) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(4 + l), "n"(T::kConsumers) : "memory");
}

// rel_bias[h] + mask[cls] into a bias buffer [L][LdB] (zero past column L),
// by the `n` threads t of the staging warps: float4 loads along the rows,
// U in flight a thread.  The sum is the one stage_bias forms.
template <class T>
__device__ __forceinline__ void stage_table(float* Bs, const float* rel, const float* mask,
                                            int t, int n) {
  constexpr int L = T::L, Q = T::G::LdB / 4, U = 8;  // float4 a row; loads in flight
  for (int i0 = t; i0 < L * Q; i0 += U * n) {
    float4 v[U], m[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * n, r = i / Q, c = (i % Q) * 4;
      const bool in = i < L * Q && c < L;
      v[u] = in ? __ldg(reinterpret_cast<const float4*>(rel + r * L + c))
                : make_float4(0.f, 0.f, 0.f, 0.f);
      m[u] = in && mask ? __ldg(reinterpret_cast<const float4*>(mask + r * L + c))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * n;
      if (mask) v[u].x += m[u].x, v[u].y += m[u].y, v[u].z += m[u].z, v[u].w += m[u].w;
      if (i < L * Q) *reinterpret_cast<float4*>(Bs + (i / Q) * T::G::LdB + (i % Q) * 4) = v[u];
    }
  }
}

// grid (windows, head groups), T::kThreads threads, T::kSmemBytes of dynamic
// shared memory.  Block (x, y) takes window cls + classes (x / classes), cls
// = x % classes (so a mask class's windows are adjacent in x), and heads
// [y gh, min((y + 1) gh, heads)).  Ring slots, in order: each head's KS
// slices of its q, k, v rows (head j's taken by lane j % LANES), then each
// proj column tile's K slices over the group's heads.  These are the ring's
// units: unit u (head u, then tile u - nh) is lane u % LANES's, and with
// two lanes the lanes take their units in turn (turn_wait / turn_pass).
template <class T>
__global__ void __launch_bounds__(T::kThreads, T::MINB)
window_attn_kernel_fused(const __grid_constant__ AttnMaps maps,
                         const __grid_constant__ AttnArgs a) {
  constexpr int C = T::C, L = T::L, LP = T::LP, R = T::R, S = T::S, ST = T::STAGES;
  constexpr int NB = T::NB, NBUF = NB > 0 ? NB : 1;  // NBUF: arrays of NB, never empty
  using G = typename T::G;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[ST], empty[ST];
  __shared__ __align__(8) uint64_t bias_full[NBUF], bias_empty[NBUF];
  __shared__ int rows[R];  // x's row of each panel row; -1 past the window's tokens
  unsigned char* base = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  bf16* panel = reinterpret_cast<bf16*>(base);
  bf16* opanel = reinterpret_cast<bf16*>(base + T::kLnBytes);
  unsigned char* ring = base + T::kLnBytes + T::kOBytes;
  unsigned char* stages = ring + ST * T::kSlotBytes;
  float* biasb = reinterpret_cast<float*>(stages + T::LANES * T::kStageBytes);
  bf16* ssv = reinterpret_cast<bf16*>(biasb + NB * T::kBiasBytes / 4);  // [2C]
  float* bproj = reinterpret_cast<float*>(ssv + 2 * C);                  // [C]

  const int cls = blockIdx.x % a.classes;
  const int wi = cls + a.classes * (blockIdx.x / a.classes);
  const int h0 = blockIdx.y * a.gh, nh = min(a.gh, a.heads - h0);
  const int ko = (kHD * nh + S - 1) / S;  // K slices of the group's proj
  const float* maskc = a.mask ? a.mask + (size_t)cls * L * L : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      hg::mbar_init(&full[s], 1);
      hg::mbar_init(&empty[s], T::kLaneWarps);
    }
    for (int b = 0; b < NB; ++b) {
      hg::mbar_init(&bias_full[b], 3);
      hg::mbar_init(&bias_empty[b], T::kLaneWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int r = threadIdx.x; r < R; r += T::kThreads)
    rows[r] = r < L ? static_cast<int>(window_token_row(wi, r, a.H, a.W, a.window, a.shift)) : -1;
  __syncthreads();

  if (warp >= T::kConsumers / 32) {  // the producers
    const int pw = warp - T::kConsumers / 32;
    if (pw == 0 && lane == 0) {  // every ring slot, in the consumers' order
      int it = 0;
      auto slot = [&](unsigned bytes) {
        const int s = it % ST;
        hg::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        hg::mbar_expect_tx(&full[s], bytes);
        return s;
      };
      for (int h = h0; h < h0 + nh; ++h)
        for (int ks = 0; ks < T::KS; ++ks, ++it) {  // the head's q, k, v rows, K slice ks
          const int s = slot(T::kSlotBytes);
#pragma unroll
          for (int q = 0; q < 3; ++q)
            hg::tma_load(&maps.wqkv, ring + s * T::kSlotBytes + q * kHD * S * 2, &full[s], ks * S,
                         q * C + h * kHD);
        }
      for (int t = 0; t < C / T::NP; ++t)
        for (int ks = 0; ks < ko; ++ks, ++it) {  // Wproj rows of tile t, the group's columns
          const int s = slot(T::NP * S * 2);
          hg::tma_load(&maps.wproj, ring + s * T::kSlotBytes, &full[s], h0 * kHD + ks * S,
                       t * T::NP);
        }
    } else if (NB > 0 && pw > 0) {  // each head's bias, into buffer j % NB
      for (int j = 0; j < nh; ++j) {
        const int b = j % NBUF;
        hg::mbar_wait(&bias_empty[b], ((j / NBUF) & 1) ^ 1);
        stage_table<T>(biasb + b * T::kBiasBytes / 4, a.rel + (size_t)(h0 + j) * L * L, maskc,
                       threadIdx.x - T::kConsumers - 32, 96);
        __syncwarp();
        if (lane == 0) hg::mbar_arrive(&bias_full[b]);
      }
    }
    return;
  }

  const int wg = warp >> 2, ln_ = wg / T::RT, mt = wg % T::RT, r0 = T::m_tile(mt);
  const int lw = warp - ln_ * T::kLaneWarps;  // the warp's place in its lane
  bf16* stage = reinterpret_cast<bf16*>(stages + ln_ * T::kStageBytes);
  // accumulator element (row, col) of a warpgroup: row er + 8 i, col 8 j +
  // ec + {0, 1} -> acc[4 j + 2 i + {0, 1}]
  const int er = 16 * (warp & 3) + (lane >> 2), ec = 2 * (lane & 3);
  const bool attends = lw < G::NT;  // query rows 16 lw .. 16 lw + 15
  const int row0 = lw * 16;
  auto slot_of = [&](int i) {
    return reinterpret_cast<const bf16*>(ring + (i % ST) * T::kSlotBytes);
  };
  auto wait_full = [&](int i) { hg::mbar_wait(&full[i % ST], (i / ST) & 1); };
  auto release = [&](int i) {
    if (lane == 0) hg::mbar_arrive(&empty[i % ST]);
  };

  // the O panel's columns past the group's heads (an odd count) read as zero
  if (kHD * nh < ko * S)
    for (int i = threadIdx.x; i < R * 4; i += T::kConsumers)
      *reinterpret_cast<uint4*>(hg::swizzled(opanel, R, i >> 2, kHD * nh + 8 * (i & 3))) =
          make_uint4(0u, 0u, 0u, 0u);

  // the block's vectors, in the same group of copies as the LN1 panel's rows
  {
    const bf16* ssb = a.ss + (size_t)(wi / ((a.H / a.window) * (a.W / a.window))) * 2 * C;
    for (int i = threadIdx.x; i < 2 * C / 8 + C / 4; i += T::kConsumers)
      if (i < 2 * C / 8)
        cp_async16(ssv + 8 * i, ssb + 8 * i, true);
      else
        cp_async16(bproj + 4 * (i - 2 * C / 8), a.bproj + 4 * (i - 2 * C / 8), true);
  }
  // LN1(a) of the window's tokens; the padded rows are left as they are and
  // never stored
  const typename T::Ln ln{WindowRows{a.x, rows, ssv, a.out, C}, a.ln_g, a.ln_b};
  ln.fill(panel, R, 0, L, C, T::kConsumers / 32, warp, lane);
  hg::fence_proxy_async();
  hg::consumer_sync(T::kConsumers);

  constexpr bool kTurns = T::LANES > 1;
  if (kTurns && ln_ == 1) turn_pass<T>(0);  // lane 0 takes the first unit
  for (int j = ln_; j < nh; j += T::LANES) {
    const int h = h0 + j;
    // q, k, v of head h for the warpgroup's 64 rows: panel x the slot's 96 rows
    if (kTurns) turn_wait<T>(ln_);
    float acc[48];
#pragma unroll
    for (int ks = 0; ks < T::KS; ++ks) {
      const int i = j * T::KS + ks;
      wait_full(i);
      const uint64_t da = hg::sw128_desc(panel + ks * R * S + r0 * S);
      const uint64_t db = hg::sw128_desc(slot_of(i));
      hg::wgmma_fence();
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (ks * S + 16 * t < C) hg::Wgmma<96>::mma(acc, da + 2 * t, db + 2 * t, ks + t > 0);
      hg::wgmma_commit();
      hg::wgmma_wait<1>();
      hg::fence_regs(acc);
      if (ks > 0) release(i - 1);
    }
    hg::wgmma_wait<0>();
    hg::fence_regs(acc);
    release(j * T::KS + T::KS - 1);
    if (kTurns) turn_pass<T>(1 - ln_);

    // + bqkv, bf16, into the lane's stage ([q | k | v][token][d]); padded
    // tokens zero (V's rows past L meet probability 0)
    lane_sync<T>(ln_);  // every warp of the lane is done with its last head's q, k, v
#pragma unroll
    for (int jj = 0; jj < 12; ++jj) {
      const int which = jj / 4, d = 8 * (jj % 4) + ec;
      const float2 bq =
          __ldg(reinterpret_cast<const float2*>(a.bqkv + which * C + h * kHD + d));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + er + 8 * i;
        if (r < 64 * mt) continue;  // R = 112: rows 48..63 are m-tile 0's
        const uint32_t v =
            r < L ? pack_bf16(acc[4 * jj + 2 * i] + bq.x, acc[4 * jj + 2 * i + 1] + bq.y) : 0u;
        *reinterpret_cast<uint32_t*>(stage + (which * LP + r) * kLdQ + d) = v;
      }
    }
    lane_sync<T>(ln_);

    // the window core: warp lw of the lane takes 16 query rows
    float2 bias[G::NN][2];
    if constexpr (NB > 0) {
      const int b = j % NBUF;
      hg::mbar_wait(&bias_full[b], (j / NBUF) & 1);
      if (attends) {
        const float* Bs = biasb + b * T::kBiasBytes / 4;
        window_bias<G>(bias, [&](int r, int c) {
          return r < L ? *reinterpret_cast<const float2*>(Bs + r * G::LdB + c)
                       : make_float2(0.f, 0.f);
        }, row0, lane);
      }
      __syncwarp();
      if (lane == 0) hg::mbar_arrive(&bias_empty[b]);  // the buffer's reads are in registers
    }
    if (attends) {
      const bf16* Qs = stage;
      const bf16* Ks = Qs + LP * kLdQ;
      const bf16* Vs = Ks + LP * kLdQ;
      float s[G::NN][4], sum[2];
      window_scores<G>(s, Qs, Ks, row0, lane);
      if constexpr (NB == 0)
        window_bias<G>(bias, TableBias<L>{a.rel + (size_t)h * L * L, maskc}, row0, lane);
      window_softmax<G>(s, sum, bias, lane, a.scale);
      // O = bf16(P) V: P's accumulator tiles 2c, 2c+1 are the A fragment of
      // k step c; tile NN (past the last) is zero
      float o[kHD / 8][4] = {};
#pragma unroll
      for (int c = 0; c < G::KC; ++c) {
        uint32_t pa[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = 2 * c + half;
          if (n < G::NN) {
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
      // bf16(O) into the O panel at the head's 32 columns
      const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
      for (int n = 0; n < kHD / 8; ++n) {
        const int col = kHD * j + 8 * n + 2 * t4;
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<uint32_t*>(
              hg::swizzled(opanel, R, row0 + g + 8 * half, col & ~7) + (col & 7)) =
              pack_bf16(o[n][2 * half], o[n][2 * half + 1]);
      }
    }
  }

  // proj: the O panel x the group's Wproj columns, NP output columns a tile,
  // tile t unit nh + t
  hg::fence_proxy_async();
  hg::consumer_sync(T::kConsumers);  // every head's O is in the panel; the stages are free
  const bool whole = nh == a.heads;
  float* et = reinterpret_cast<float*>(stage) + lw * 16 * T::kEpiLd;
  const int mr = r0 + (warp & 3) * 16;  // the warp's first row
  constexpr int kTiles = C / T::NP;
  for (int t = (ln_ + T::LANES - nh % T::LANES) % T::LANES; t < kTiles; t += T::LANES) {
    const int i0 = nh * T::KS + t * ko;  // the tile's first ring slot
    if (kTurns) turn_wait<T>(ln_);
    float acc[T::NP / 2];
    for (int ks = 0; ks < ko; ++ks) {
      wait_full(i0 + ks);
      const uint64_t da = hg::sw128_desc(opanel + ks * R * S + r0 * S);
      const uint64_t db = hg::sw128_desc(slot_of(i0 + ks));
      hg::fence_regs(acc);
      hg::wgmma_fence();
#pragma unroll
      for (int q = 0; q < 4; ++q)
        hg::Wgmma<T::NP>::mma(acc, da + 2 * q, db + 2 * q, ks + q > 0);
      hg::wgmma_commit();
      hg::wgmma_wait<1>();
      hg::fence_regs(acc);
      if (ks > 0) release(i0 + ks - 1);
    }
    hg::wgmma_wait<0>();
    hg::fence_regs(acc);
    release(i0 + ko - 1);
    if (kTurns) turn_pass<T>(1 - ln_);
    // the residual a of this lane's epilogue rows (kept in y's rows by the
    // prologue), all loads at once: row mr + (lane / 4) + 8 hh, columns t NP
    // + 32 c + 8 (lane % 4)
    uint4 ap[T::NP / 32][2];
#pragma unroll
    for (int c = 0; c < T::NP / 32; ++c)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int g = rows[mr + (lane >> 2) + 8 * hh];
        ap[c][hh] = whole && g >= 0
                        ? ld_cg16(a.out + (size_t)g * C + t * T::NP + 32 * c + 8 * (lane & 3))
                        : make_uint4(0u, 0u, 0u, 0u);
      }

    // per 32 columns: the warp's 16 x 32 accumulators into its tile, then
    // each lane takes two (row, 8 columns) pieces of it: y = a + (acc +
    // bproj) (the whole sum), or the group's fp32 partial
#pragma unroll
    for (int c = 0; c < T::NP / 32; ++c) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int q = 4 * c + jj;
          *reinterpret_cast<float2*>(et + ((lane >> 2) + 8 * i) * T::kEpiLd + 8 * jj + ec) =
              make_float2(acc[4 * q + 2 * i], acc[4 * q + 2 * i + 1]);
        }
      __syncwarp();
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = (lane >> 2) + 8 * hh, br = mr + r, g = rows[br];
        if (br >= 64 * mt && g >= 0) {
          const int n = t * T::NP + 32 * c + 8 * (lane & 3);
          const float4 lo = *reinterpret_cast<const float4*>(et + r * T::kEpiLd + 8 * (lane & 3));
          const float4 hi =
              *reinterpret_cast<const float4*>(et + r * T::kEpiLd + 8 * (lane & 3) + 4);
          float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
          if (whole) {
            float av[8];
            unpack8(ap[c][hh], av);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              v[e] += bproj[n + e];
              v[e] = av[e] + v[e];
            }
            store8(a.out + (size_t)g * C + n, v);
          } else {
            float4* p = reinterpret_cast<float4*>(a.part + ((size_t)blockIdx.y * a.M + g) * C + n);
            p[0] = make_float4(v[0], v[1], v[2], v[3]);
            p[1] = make_float4(v[4], v[5], v[6], v[7]);
          }
        }
      }
      __syncwarp();
    }
  }
  if (kTurns && ln_ == (nh + kTiles) % T::LANES) turn_wait<T>(ln_);  // the last unit's pass
}

// ------------------------------------------------------ the closing pass

// y = bf16(a + (sum of the groups' partials + bproj)), the partials added in
// group order; a is what the main kernel's prologue left in y.  Eight
// columns a thread.
__global__ void __launch_bounds__(256)
window_attn_kernel_close(const float* __restrict__ part, const float* __restrict__ bproj,
                         bf16* __restrict__ out, int M, int C, int groups) {
  const size_t total = (size_t)M * C;
  for (size_t e = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 8; e < total;
       e += (size_t)gridDim.x * blockDim.x * 8) {
    float v[8] = {};
    for (int g = 0; g < groups; ++g) {
      const float4* p = reinterpret_cast<const float4*>(part + g * total + e);
      const float4 lo = p[0], hi = p[1];
      v[0] += lo.x, v[1] += lo.y, v[2] += lo.z, v[3] += lo.w;
      v[4] += hi.x, v[5] += hi.y, v[6] += hi.z, v[7] += hi.w;
    }
    hg::add_bias8(bproj, static_cast<int>(e % C), v);
    float av[8];
    load8(out + e, av);
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = av[t] + v[t];
    store8(out + e, v);
  }
}

// ------------------------------------------------------------------- host

template <int MAXV, int ROWS, int LPR>
using RowsLn = hg::LnPanel<WindowRows, MAXV, ROWS, LPR>;

// The tile of each (C, L); f gets a value of its type; -1 for another.
// L = 64: a window's 64 rows a block, two or three blocks an SM up to C192;
// L = 100: a window in 112 rows, two consumer warpgroups.  C384 at L = 100
// and C768 hold half their heads a block.
template <class F>
int with_attn_tile(int C, int L, F f) {
  // (C, L, lanes, heads a block, ring slots, bias buffers, blocks an SM, LN1's
  // vectors of 8 a lane, rows a pass, lanes a row: every lane busy)
  if (L == 64) {
    switch (C) {
      case 64: return f(AttnTile<64, 64, 1, 2, 2, 1, 2, RowsLn<2, 2, 4>>{});
      case 96: return f(AttnTile<96, 64, 1, 3, 2, 1, 2, RowsLn<3, 2, 4>>{});
      case 192: return f(AttnTile<192, 64, 2, 6, 4, 2, 1, RowsLn<3, 2, 8>>{});
      case 384: return f(AttnTile<384, 64, 2, 12, 4, 2, 1, RowsLn<3, 2, 16>>{});
      case 768: return f(AttnTile<768, 64, 2, 12, 3, 0, 1, RowsLn<3, 2, 32>>{});
      default: return -1;
    }
  }
  if (L == 100) {
    switch (C) {
      case 64: return f(AttnTile<64, 100, 1, 2, 2, 1, 1, RowsLn<2, 2, 4>>{});
      case 96: return f(AttnTile<96, 100, 1, 3, 3, 2, 1, RowsLn<3, 2, 4>>{});
      case 192: return f(AttnTile<192, 100, 1, 6, 3, 1, 1, RowsLn<3, 2, 8>>{});
      case 384: return f(AttnTile<384, 100, 1, 6, 2, 1, 1, RowsLn<3, 2, 16>>{});
      default: return -1;
    }
  }
  return -1;
}

// Opt the kernel into its dynamic shared memory (once on each device).
template <class T>
cudaError_t attn_opt_in() {
  static PerDevice ready;
  return ready.once([](int&) {
    return cudaFuncSetAttribute(window_attn_kernel_fused<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  });
}

template <class T>
cudaError_t launch_attn(const AttnArgs& a, const bf16* wqkv, const bf16* wproj, int n_windows,
                        int groups, cudaStream_t s) {
  const cudaError_t opt = attn_opt_in<T>();
  if (opt != cudaSuccess) return opt;
  if (a.gh <= 0 || a.gh > T::GMAX || groups != (a.heads + a.gh - 1) / a.gh || groups > 65535 ||
      (groups > 1 && !a.part) || n_windows % a.classes)
    return cudaErrorInvalidValue;
  AttnMaps maps;
  if (!hg::make_map(&maps.wqkv, wqkv, T::C, 3 * T::C, kHD) ||
      !hg::make_map(&maps.wproj, wproj, T::C, T::C, T::NP))
    return cudaErrorInvalidValue;
  window_attn_kernel_fused<T><<<dim3(n_windows, groups), T::kThreads, T::kSmemBytes, s>>>(maps, a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return err;
  const long long vecs = (long long)a.M * T::C / 8;
  const int blocks = static_cast<int>(vecs / 256 + 1 < 132 * 16 ? vecs / 256 + 1 : 132 * 16);
  window_attn_kernel_close<<<blocks, 256, 0, s>>>(a.part, a.bproj, a.out, a.M, T::C, groups);
  return cudaGetLastError();
}

}  // namespace

// The attention half over x [B, H, W, C] (unrolled) into out, the heads in
// `groups` groups of ceil(num_heads / groups) (swin_block_v3.attn_plan);
// part: [groups, B H W, C] fp32 where groups > 1.
extern "C" int dsg_swin_attn(const void* x, const void* ss, const void* ln_g, const void* ln_b,
                             const void* wqkv, const void* bqkv, const void* wproj,
                             const void* bproj, const void* rel_bias, const void* mask,
                             void* part, void* out, int B, int H, int W, int C, int num_heads,
                             int window, int shift, int groups, void* stream) {
  if (!window_length_supported(window * window) || C != num_heads * kHD || H % window ||
      W % window || groups <= 0 || B <= 0)
    return -1;
  const int nw = (H / window) * (W / window);
  const AttnArgs a{static_cast<const bf16*>(x),       static_cast<const bf16*>(ss),
                   static_cast<const float*>(ln_g),   static_cast<const float*>(ln_b),
                   static_cast<const float*>(bqkv),   static_cast<const float*>(bproj),
                   static_cast<const float*>(rel_bias), static_cast<const float*>(mask),
                   static_cast<float*>(part),         static_cast<bf16*>(out),
                   B * H * W, H, W, window, shift, mask ? nw : 1, num_heads,
                   (num_heads + groups - 1) / groups, 1.f / sqrtf((float)kHD)};
  const bf16* wq = static_cast<const bf16*>(wqkv);
  const bf16* wp = static_cast<const bf16*>(wproj);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_attn_tile(C, window * window, [&](auto tile) -> int {
    return launch_attn<decltype(tile)>(a, wq, wp, B * nw, groups, s);
  });
}

// The kernel's tile at width C and window length L, for the wrapper's plan:
// geom = {rows, windows a block, blocks an SM holds (the card's occupancy),
// heads a block holds}; -1 for a (C, L) no tile covers.
extern "C" int dsg_swin_attn_tile(int C, int L, int* geom) {
  return with_attn_tile(C, L, [&](auto tile) -> int {
    using T = decltype(tile);
    int per_sm = 0;
    if (attn_opt_in<T>() != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, window_attn_kernel_fused<T>,
                                                      T::kThreads, T::kSmemBytes) != cudaSuccess ||
        per_sm <= 0)
      return -2;
    geom[0] = T::R, geom[1] = 1, geom[2] = per_sm, geom[3] = T::GMAX;
    return 0;
  });
}
