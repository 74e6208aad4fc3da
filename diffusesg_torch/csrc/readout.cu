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

// the 128 threads of warpgroup g (barriers 1 and 2; 0 is __syncthreads); the
// ids are immediates, so the kernel reserves three barriers, not all 16
__device__ __forceinline__ void group_sync(int g) {
  if (g == 0) asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else asm volatile("bar.sync 2, 128;\n" ::: "memory");
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

cudaError_t readout_ready() {
  static PerDevice ready;
  return ready.once([](int&) {
    return cudaFuncSetAttribute(readout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kSmemBytes);
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
