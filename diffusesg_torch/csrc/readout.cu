// readout: the denoiser's two-layer output heads on Hopper.
//
// Replaces diffusesg_tpu/ops/readout_kernel.py::_kernel (entry
// fused_readout_mlp):
//
//   out = gelu_erf(x @ W1^T + b1) @ W2^T + b2     x [M, C], W1 [96, C], W2 [n_out, 96]
//
// One persistent launch in which the [M, 96] hidden never leaves the SM.  A
// block stages W1 (C <= 128) and W2, zero-padded to 16 rows, in shared memory
// once, in the 128-byte swizzle wgmma reads (hopper_gemm.cuh).  Each of its
// two warpgroups walks its own 64-row tiles of x (worker w of W takes tiles
// w, w + W, ...), the next tile's rows loading by cp.async into the other
// slot of a two-slot ring while this one computes:
//   fc1  wgmma m64n96k16, both operands from shared memory, fp32
//        accumulators in registers;
//   then + b1 and the exact erf-GELU in registers, rounded to bf16 as
//        readout_mlp_plain rounds the hidden (the TPU kernel's tanh form is
//        a Mosaic limitation and is not copied);
//   fc2  wgmma m64n16k16 with A from registers (hg::wgmma_rs_n16): the fc1
//        accumulator layout is the A-fragment layout, so the bf16 hidden is
//        packed in place, as FlashAttention-3 feeds P to P V;
//   out  + b2, fp32, only the n_out real columns stored.
// fc2 runs on the tensor cores rather than as per-row FFMA dot products
// reduced over quads of lanes: its cost is then six k16 steps whatever n_out
// is (1 for the adjacency head, 5 for the node head, 16 at most), with no W2
// in registers and no shuffles.  No tensor map is encoded: the x tiles come
// by cp.async, so the host's work per call is the launch alone.
//
// Bound on the H100 at the model's shapes: bytes.  2 * 96 * (96 + n_out)
// FLOP per token against 2 C + 4 n_out bytes (x in, out) is about 100
// FLOP/byte at C = 96, far below the card's ~295 FLOP/byte ridge: the time
// is x's traffic, which is read once (192 B a token in, 4 B out for the
// adjacency head); W1 and W2 come from L2 once per block.  The grid is one
// wave of resident blocks, or fewer where the tiles are few
// (ops/readout_kernel.py::readout_plan, from what dsg_readout_tile reports).
//
// readout_kernel_head widens it into the denoiser's whole exit at patch size
// 1, over the U-Net's [B N N, 96] rows (ops/readout_kernel.py::output_head;
// no TPU kernel: the JAX package leaves the final LayerNorm, ReadOut and the
// pooling to XLA around _kernel):
//
//   s    = bf16(LN(x))                            fp32, two passes
//   s    = bf16(s W_k^T + b_k), k = 0, 1, 2       ReadOut: ConvTranspose 1x1, two 1x1 convs
//   out  = bf16(gelu_erf(s @ W1^T + b1) @ W2^T + b2)   the adjacency head, as above
//   part = masked sums over j of s[b, i, j], two fixed-order partials a (b, i)
//
// The [B N N, 96] `shared` rows never reach device memory.  Each warpgroup
// ldmatrix-es its 64-row x tile (cp.async ring, as above) into A fragments,
// normalizes them in registers (a row's sums over the four lanes of a quad),
// and chains five wgmmas with A from registers: each accumulator, + its bias
// and packed to bf16, is the next product's A operand.  The pooling reads
// `shared`'s fragments: for one (b, i) of the tile at a time (a 64-row tile is
// one at N = 64, parts of two or three at N = 40), each lane adds its two
// rows where they belong to it and their pair is valid, shuffles sum a warp's
// 16 rows, and the four warps' sums are added in shared memory; a group's
// rows reach at most two tiles, whose sums land in its two slots, added in
// that order by the wrapper (no atomics).  Bound: operations, about 77 kFLOP
// a row to 196 bytes; but at three warpgroups an SM (209 KB of shared
// memory) the chain's CUDA-core work (LayerNorm, biases, the erf GELU, the
// pooling) and its waits set the time.
#include "hopper_gemm.cuh"

using namespace dsg;

namespace {

constexpr int kRows = 64;              // rows of a tile: one m64 wgmma
constexpr int kHidden = 96;            // fc1's N: one m64n96 wgmma
constexpr int kOutPad = 16;            // fc2's N: n_out <= 16, W2 zero-padded
constexpr int kMaxC = 2 * hg::kSlice;  // x and W1 rows in two swizzled K slices
constexpr int kGroups = 2;             // consumer warpgroups a block
constexpr int kBlockThreads = 128 * kGroups;
constexpr int kTileElems = kRows * kMaxC;
constexpr int kW1Elems = kHidden * kMaxC;
constexpr int kW2Elems = kOutPad * kMaxC;
constexpr size_t kSmemBytes =
    1024 + (size_t)(kW1Elems + kW2Elems + kGroups * 2 * kTileElems) * 2;

// rows [r0, r0 + R) of a row-major bf16 [rows, C] matrix into a swizzled
// operand of R rows, by `threads` threads from `tid`, cp.async (not waited
// for); rows past `rows` are zero
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int R, int r0, int rows,
                                           int C, int tid, int threads) {
  const int vecs = C / 8;
  for (int i = tid; i < R * vecs; i += threads) {
    const int r = i / vecs, k = (i - r * vecs) * 8;
    const bool ok = r0 + r < rows;
    cp_async16(hg::swizzled(dst, R, r, k), ok ? src + (size_t)(r0 + r) * C + k : src, ok);
  }
}

// the 128 threads of warpgroup g (barriers 1 to 3; 0 is __syncthreads); the
// ids are immediates, so a kernel reserves as many barriers as it has
// warpgroups, plus one, not all 16
__device__ __forceinline__ void group_sync(int g) {
  if (g == 0) asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else if (g == 1) asm volatile("bar.sync 2, 128;\n" ::: "memory");
  else asm volatile("bar.sync 3, 128;\n" ::: "memory");
}

__global__ void __launch_bounds__(kBlockThreads, 2)
readout_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const float* __restrict__ b1, const bf16* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ out, int M, int C, int n_out) {
  extern __shared__ unsigned char smem_raw[];
  bf16* w1s =
      reinterpret_cast<bf16*>(smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u));
  bf16* w2s = w1s + kW1Elems;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, quad = lane & 3;
  bf16* ring = w2s + kW2Elems + wg * 2 * kTileElems;  // this warpgroup's two slots
  const int tiles = (M + kRows - 1) / kRows, workers = gridDim.x * kGroups;
  int t = blockIdx.x * kGroups + wg;

  stage_rows(w1s, w1, kHidden, 0, kHidden, C, threadIdx.x, kBlockThreads);
  stage_rows(w2s, w2, kOutPad, 0, n_out, kHidden, threadIdx.x, kBlockThreads);
  if (t < tiles) stage_rows(ring, x, kRows, t * kRows, M, C, tid, 128);
  cp_async_commit();
  // accumulator element (row, col): rows 16 warp + lane / 4 + 8 i, cols
  // 8 j + 2 quad + e -> acc[4 j + 2 i + e]; a lane's biases by (j, e)
  float bias1[kHidden / 4], bias2[4];
#pragma unroll
  for (int j = 0; j < kHidden / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias1[2 * j + e] = ld_ro(b1 + 8 * j + 2 * quad + e);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * quad + e;
      bias2[2 * j + e] = col < n_out ? ld_ro(b2 + col) : 0.f;
    }
  cp_async_wait<0>();
  hg::fence_proxy_async();
  __syncthreads();  // W1, W2 and both warpgroups' first tiles have landed

  for (int i = 0; t < tiles; ++i, t += workers) {
    if (i > 0) {  // tile t has landed; every warp is done with the other slot
      cp_async_wait<0>();
      hg::fence_proxy_async();
      group_sync(wg);
    }
    const bf16* xs = ring + (i & 1) * kTileElems;
    if (t + workers < tiles)
      stage_rows(ring + ((i + 1) & 1) * kTileElems, x, kRows, (t + workers) * kRows, M, C, tid,
                 128);
    cp_async_commit();

    float acc[kHidden / 2];
#pragma unroll
    for (int j = 0; j < kHidden / 2; ++j) acc[j] = 0.f;
    hg::fence_regs(acc);
    hg::wgmma_fence();
    for (int ks = 0; ks * hg::kSlice < C; ++ks) {
      const uint64_t da = hg::sw128_desc(xs + ks * kRows * hg::kSlice);
      const uint64_t db = hg::sw128_desc(w1s + ks * kHidden * hg::kSlice);
      const int steps = min(hg::kSlice, C - ks * hg::kSlice) / 16;
      for (int j = 0; j < steps; ++j) hg::Wgmma<kHidden>::mma(acc, da + 2 * j, db + 2 * j);
    }
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_regs(acc);

    // the hidden: bias, GELU, bf16, packed as fc2's A fragments
    uint32_t hid[kHidden / 16][4];
#pragma unroll
    for (int kk = 0; kk < kHidden / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int a = 8 * kk + 2 * q, j = a >> 2;
        hid[kk][q] = pack_bf16(gelu_erf(acc[a] + bias1[2 * j]),
                               gelu_erf(acc[a + 1] + bias1[2 * j + 1]));
      }
    float acc2[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc2[j] = 0.f;
    hg::fence_regs(acc2);
    hg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHidden / 16; ++kk)
      hg::wgmma_rs_n16(acc2, hid[kk],
                       hg::sw128_desc(w2s + (kk >> 2) * kOutPad * hg::kSlice) + 2 * (kk & 3));
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_regs(acc2);

    const int row = t * kRows + warp * 16 + (lane >> 2);
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int m = row + 8 * ii;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * quad + e;
          if (col < n_out)
            out[(size_t)m * n_out + col] = acc2[4 * j + 2 * ii + e] + bias2[2 * j + e];
        }
    }
  }
}

// ------------------------------------------------------------ the output head

constexpr int kHeadGroups = 3;  // consumer warpgroups a block: one block an SM
constexpr int kHeadThreads = 128 * kHeadGroups;
constexpr int kHeadParams = 6 * kHidden + kOutPad;  // floats: LN, three biases, fc1's, fc2's
constexpr size_t kHeadSmemBytes =
    1024 + (size_t)(4 * kW1Elems + kW2Elems + kHeadGroups * 2 * kTileElems) * 2 +
    (kHeadParams + kHeadGroups * 4 * kHidden) * 4;

struct HeadArgs {
  const bf16* x;  // [M, 96]: the U-Net's output rows
  const float* ln_w;
  const float* ln_b;
  const bf16* w0;  // ReadOut's three products [96, 96] and their biases (bf16, as
  const bf16* b0;  // ReadOut adds them)
  const bf16* w1;
  const bf16* b1;
  const bf16* w2;
  const bf16* b2;
  const bf16* fc1_w;  // the adjacency head [96, 96], [n_out, 96]
  const float* fc1_b;
  const bf16* fc2_w;
  const float* fc2_b;
  const unsigned char* flags;  // [B N]
  float* out;   // [M, n_out]
  float* part;  // [B N, 2, 96]: the pooling's partial sums
  int M, N, n_out;
};

// Element a = 8 kk + 2 q + e of a 64 x 96 accumulator lies in row
// 16 warp + lane / 4 + 8 ((a >> 1) & 1), column acc_col(a); it is also
// element e of A-fragment register q of k16 block kk, so an accumulator
// packed pairwise to bf16 is the next product's A operand.
__device__ __forceinline__ int acc_col(int a, int quad) {
  return 8 * (a >> 2) + 2 * quad + (a & 1);
}

__device__ __forceinline__ void pack_frags(uint32_t (&f)[kHidden / 16][4],
                                           const float (&v)[kHidden / 2]) {
#pragma unroll
  for (int kk = 0; kk < kHidden / 16; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) f[kk][q] = pack_bf16(v[8 * kk + 2 * q], v[8 * kk + 2 * q + 1]);
}

// acc = A W^T, K = 96: A from registers, W [96, 96] swizzled in two K slices
__device__ __forceinline__ void product96(float (&acc)[kHidden / 2],
                                          const uint32_t (&f)[kHidden / 16][4], const bf16* ws) {
  hg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kHidden / 16; ++kk)
    hg::WgmmaRs<kHidden>::mma(acc, f[kk],
                              hg::sw128_desc(ws + (kk >> 2) * kHidden * hg::kSlice) + 2 * (kk & 3),
                              kk > 0);
  hg::wgmma_commit();
  hg::wgmma_wait<0>();
  hg::fence_regs(acc);
}

// column c's masked sum over a tile's rows of group g (one (b, i)) into its
// slot: 0 from the first tile the group's rows reach, 1 from the second (a
// group of N <= 64 rows spans at most two); a group wholly in its first tile
// zeroes slot 1
__device__ __forceinline__ void put_partial(const HeadArgs& p, int g, int t, int c, float s) {
  const int first = g * p.N / kRows;
  const int slot = first == t ? 0 : 1;
  p.part[((size_t)g * 2 + slot) * kHidden + c] = s;
  if (slot == 0 && (g * p.N + p.N - 1) / kRows == t) p.part[((size_t)g * 2 + 1) * kHidden + c] = 0.f;
}

__global__ void __launch_bounds__(kHeadThreads, 1) readout_kernel_head(HeadArgs p) {
  extern __shared__ unsigned char smem_raw[];
  bf16* wsq =
      reinterpret_cast<bf16*>(smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u));
  bf16* w2s = wsq + 4 * kW1Elems;  // fc2's W, zero-padded to 16 rows
  bf16* rings = w2s + kW2Elems;
  float* prm = reinterpret_cast<float*>(rings + kHeadGroups * 2 * kTileElems);
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, quad = lane & 3;
  bf16* ring = rings + wg * 2 * kTileElems;
  float* red = prm + kHeadParams + wg * 4 * kHidden;  // the pooling's sums of each warp
  const int tiles = (p.M + kRows - 1) / kRows, workers = gridDim.x * kHeadGroups;
  int t = blockIdx.x * kHeadGroups + wg;

  const bf16* wsrc[4] = {p.w0, p.w1, p.w2, p.fc1_w};
#pragma unroll
  for (int s = 0; s < 4; ++s)
    stage_rows(wsq + s * kW1Elems, wsrc[s], kHidden, 0, kHidden, kHidden, threadIdx.x,
               kHeadThreads);
  stage_rows(w2s, p.fc2_w, kOutPad, 0, p.n_out, kHidden, threadIdx.x, kHeadThreads);
  if (t < tiles) stage_rows(ring, p.x, kRows, t * kRows, p.M, kHidden, tid, 128);
  cp_async_commit();
  for (int i = threadIdx.x; i < kHidden; i += kHeadThreads) {
    prm[i] = p.ln_w[i];
    prm[kHidden + i] = p.ln_b[i];
    prm[2 * kHidden + i] = __bfloat162float(p.b0[i]);
    prm[3 * kHidden + i] = __bfloat162float(p.b1[i]);
    prm[4 * kHidden + i] = __bfloat162float(p.b2[i]);
    prm[5 * kHidden + i] = p.fc1_b[i];
  }
  if (threadIdx.x < kOutPad)
    prm[6 * kHidden + threadIdx.x] = (int)threadIdx.x < p.n_out ? p.fc2_b[threadIdx.x] : 0.f;
  cp_async_wait<0>();
  hg::fence_proxy_async();
  __syncthreads();  // the weights, the parameters and every warpgroup's first tile

  for (int i = 0; t < tiles; ++i, t += workers) {
    if (i > 0) {  // tile t has landed; every warp is done with the other slot
      cp_async_wait<0>();
      group_sync(wg);
    }
    bf16* xs = ring + (i & 1) * kTileElems;
    if (t + workers < tiles)
      stage_rows(ring + ((i + 1) & 1) * kTileElems, p.x, kRows, (t + workers) * kRows, p.M,
                 kHidden, tid, 128);
    cp_async_commit();

    // x's rows as A fragments, then the final LayerNorm in fp32 over each
    // row's 96 columns (four lanes of a quad hold a row's two halves' pairs)
    uint32_t f[kHidden / 16][4];
#pragma unroll
    for (int kk = 0; kk < kHidden / 16; ++kk)
      ldsm_x4(f[kk], hg::swizzled(xs, kRows, warp * 16 + (lane & 15), 16 * kk + (lane >> 4) * 8));
    float v[kHidden / 2];
#pragma unroll
    for (int kk = 0; kk < kHidden / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&f[kk][q]));
        v[8 * kk + 2 * q] = h.x, v[8 * kk + 2 * q + 1] = h.y;
      }
    float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
    for (int a = 0; a < kHidden / 2; ++a) sum[(a >> 1) & 1] += v[a];
    warp_sum_n<4>(sum);
#pragma unroll
    for (int a = 0; a < kHidden / 2; ++a) {
      const float d = v[a] - sum[(a >> 1) & 1] * (1.f / kHidden);
      sq[(a >> 1) & 1] += d * d;
    }
    warp_sum_n<4>(sq);
#pragma unroll
    for (int a = 0; a < kHidden / 2; ++a) {
      const int r = (a >> 1) & 1, col = acc_col(a, quad);
      v[a] = (v[a] - sum[r] * (1.f / kHidden)) * rsqrtf(sq[r] * (1.f / kHidden) + kLnEps) *
                 prm[col] + prm[kHidden + col];
    }
    pack_frags(f, v);
    // ReadOut: three products, each + its bias and rounded to bf16
#pragma unroll 1
    for (int s = 0; s < 3; ++s) {
      product96(v, f, wsq + s * kW1Elems);
#pragma unroll
      for (int a = 0; a < kHidden / 2; ++a) v[a] += prm[(2 + s) * kHidden + acc_col(a, quad)];
      pack_frags(f, v);
    }
    // the pooling, from shared's fragments: one group (b, i) of the tile at a
    // time, each lane's two rows where they are the group's and their pair
    // (i, j) is valid, summed over a warp's rows by shuffles (lanes of one
    // quad column), then over the four warps in shared memory, in a fixed
    // order (no atomics)
    int rg[2];
    bool rok[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = t * kRows + warp * 16 + (lane >> 2) + 8 * i;
      rg[i] = m < p.M ? m / p.N : -1;
      rok[i] = m < p.M && p.flags[rg[i]] && p.flags[(rg[i] / p.N) * p.N + (m - rg[i] * p.N)];
    }
    const int g_last = (min(p.M, (t + 1) * kRows) - 1) / p.N;
    for (int gs = t * kRows / p.N; gs <= g_last; ++gs) {
      float s[kHidden / 4];  // column 8 j + 2 quad + e at 2 j + e
#pragma unroll
      for (int j = 0; j < kHidden / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float2 h = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&f[j >> 1][2 * (j & 1) + i]));
            if (rg[i] == gs && rok[i]) acc += e ? h.y : h.x;
          }
          s[2 * j + e] = acc;
        }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
#pragma unroll
        for (int k = 0; k < kHidden / 4; ++k) s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
      if (lane < 4)
#pragma unroll
        for (int j = 0; j < kHidden / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) red[warp * kHidden + 8 * j + 2 * quad + e] = s[2 * j + e];
      group_sync(wg);
      if (tid < kHidden)
        put_partial(p, gs, t, tid,
                    ((red[tid] + red[kHidden + tid]) + red[2 * kHidden + tid]) +
                        red[3 * kHidden + tid]);
      group_sync(wg);  // the sums are read; the next group may write them
    }

    // the adjacency head: fc1, + b1, erf-GELU, bf16, fc2 (A from registers)
    product96(v, f, wsq + 3 * kW1Elems);
#pragma unroll
    for (int kk = 0; kk < kHidden / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int a = 8 * kk + 2 * q;
        f[kk][q] = pack_bf16(gelu_erf(v[a] + prm[5 * kHidden + acc_col(a, quad)]),
                             gelu_erf(v[a + 1] + prm[5 * kHidden + acc_col(a + 1, quad)]));
      }
    float acc2[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc2[j] = 0.f;
    hg::fence_regs(acc2);
    hg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHidden / 16; ++kk)
      hg::wgmma_rs_n16(acc2, f[kk],
                       hg::sw128_desc(w2s + (kk >> 2) * kOutPad * hg::kSlice) + 2 * (kk & 3));
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_regs(acc2);
    const int row = t * kRows + warp * 16 + (lane >> 2);
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int m = row + 8 * ii;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * quad + e;
          if (col < p.n_out)  // rounded to bf16, as the head's module rounds its output
            p.out[(size_t)m * p.n_out + col] =
                round_bf16(acc2[4 * j + 2 * ii + e] + prm[6 * kHidden + col]);
        }
    }
  }
}

cudaError_t readout_ready() {
  static PerDevice ready;
  return ready.once([](int&) {
    return cudaFuncSetAttribute(readout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kSmemBytes);
  });
}

cudaError_t readout_head_ready() {
  static PerDevice ready;
  return ready.once([](int&) {
    return cudaFuncSetAttribute(readout_kernel_head, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kHeadSmemBytes);
  });
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" int dsg_readout(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, void* out, int M, int C, int hidden, int n_out,
                           int blocks, void* stream) {
  if (M <= 0 || C <= 0 || C % 16 || C > kMaxC || hidden != kHidden || n_out < 1 ||
      n_out > kOutPad || blocks <= 0 || !aligned16(x) || !aligned16(w1) || !aligned16(w2))
    return -1;
  cudaError_t err = readout_ready();
  if (err != cudaSuccess) return err;
  readout_kernel<<<blocks, kBlockThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<float*>(out), M, C,
      n_out);
  return cudaGetLastError();
}

// The tile of readout for the wrapper's plan: geom = {rows a tile, tiles a
// block works on at once (its warpgroups), blocks an SM holds (the card's
// occupancy), 0}; 0 or a CUDA error.
extern "C" int dsg_readout_tile(int* geom) {
  cudaError_t err = readout_ready();
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, readout_kernel, kBlockThreads,
                                                        kSmemBytes);
  if (err != cudaSuccess) return err;
  geom[0] = kRows, geom[1] = kGroups, geom[2] = per_sm, geom[3] = 0;
  return 0;
}

// The output head: the final LayerNorm, ReadOut's three products, the
// adjacency head into out [M, n_out] (fp32 of bf16 values) and the node
// pooling's partial sums into part [B N, 2, 96], over the rows of a
// B x N x N grid (N <= 64); 0, -1 for shapes it does not cover, or a CUDA
// error.
extern "C" int dsg_readout_head(const void* x, const void* ln_w, const void* ln_b, const void* w0,
                                const void* b0, const void* w1, const void* b1, const void* w2,
                                const void* b2, const void* fc1_w, const void* fc1_b,
                                const void* fc2_w, const void* fc2_b, const void* flags,
                                void* out, void* part, int M, int N, int n_out, int blocks,
                                void* stream) {
  if (M <= 0 || N <= 0 || N > kRows || M % (N * N) || n_out < 1 || n_out > kOutPad ||
      blocks <= 0 || !aligned16(x) || !aligned16(w0) || !aligned16(w1) || !aligned16(w2) ||
      !aligned16(fc1_w) || !aligned16(fc2_w))
    return -1;
  cudaError_t err = readout_head_ready();
  if (err != cudaSuccess) return err;
  HeadArgs p{static_cast<const bf16*>(x),     static_cast<const float*>(ln_w),
             static_cast<const float*>(ln_b), static_cast<const bf16*>(w0),
             static_cast<const bf16*>(b0),    static_cast<const bf16*>(w1),
             static_cast<const bf16*>(b1),    static_cast<const bf16*>(w2),
             static_cast<const bf16*>(b2),    static_cast<const bf16*>(fc1_w),
             static_cast<const float*>(fc1_b), static_cast<const bf16*>(fc2_w),
             static_cast<const float*>(fc2_b), static_cast<const unsigned char*>(flags),
             static_cast<float*>(out),        static_cast<float*>(part),
             M, N, n_out};
  readout_kernel_head<<<blocks, kHeadThreads, kHeadSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// The output head's tile, as dsg_readout_tile's.
extern "C" int dsg_readout_head_tile(int* geom) {
  cudaError_t err = readout_head_ready();
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, readout_kernel_head,
                                                        kHeadThreads, kHeadSmemBytes);
  if (err != cudaSuccess) return err;
  geom[0] = kRows, geom[1] = kHeadGroups, geom[2] = per_sm, geom[3] = 0;
  return 0;
}
