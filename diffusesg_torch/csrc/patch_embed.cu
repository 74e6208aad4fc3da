// patch_embed: the denoiser's full-resolution entry on Hopper, at patch size 1.
//
// Replaces no TPU kernel: the JAX package leaves the grid input's assembly,
// PatchEmbed's Dense, its LayerNorm and NoiseAffine to XLA
// (diffusesg_tpu/models/diffusesg.py, layers.py::PatchEmbed).  In PyTorch that
// composition took 7-9 passes over [B N N, 96] rows an evaluation (the
// concatenations, a cuBLAS product, an fp32 copy, LayerNorm, a cast and three
// elementwise passes of the affine), the largest of them the fp32 LayerNorm.
// One launch here does it all (ops/patch_embed.py::patch_embed_plain is the
// same function in PyTorch, rounded at the same points):
//
//   in[b, i, j] = [sc_a | a](b, i, j) ++ m_ij [sc_x | x](b, i) ++ m_ij [sc_x | x](b, j)
//   h   = bf16(bf16(in) @ W^T + bias)                  W [96, Cin], Cin <= 32
//   y   = bf16(LayerNorm(h))                           fp32, two passes
//   out = bf16(silu(bf16(shift + bf16(y * bf16(scale + 1)))))   scale | shift = ss[b]
//
// m_ij = flag[b, i] & flag[b, j] (mask_adjs' zeros on the node channels); the
// self-conditioning channels are zeros where their pointers are null, and
// absent (Cin = Ca + 2 Cx) for a model without self-conditioning.
//
// Bound on the H100: bytes.  A row reads 4 (2 Ca + 4 Cx) bytes of fp32 input,
// mostly node rows that L1 and L2 hold, and writes 192 bytes of bf16; its
// 2 x 32 x 96 FLOP are nothing to the tensor cores.  So the write is the time:
// 50 MB at VG's batch of 64, about 15 us at 3.35 TB/s.
//
// Design: a persistent grid of two-warpgroup blocks; each warpgroup walks its
// own 64-row tiles (worker w of W takes tiles w, w + W, ...).  A lane builds
// its rows' A fragments of the m64n96k16 wgmma straight from the inputs (the
// gather is the fragment load: no input tile in shared memory), W sits in
// shared memory zero-padded to K = 32, and the fp32 accumulator is the
// epilogue's working set: bias, the LayerNorm's row sums over the four lanes
// of a quad, the affine with the row's image's scale and shift (read per
// column pair, L1-resident), SiLU.  The bf16 rows go out through a small tile
// of the warpgroup's own in shared memory, as 16-byte row-contiguous stores.
// The grid is one wave of resident blocks, or fewer where the tiles are few
// (ops/readout_kernel.py::readout_plan, from what dsg_patch_embed_tile
// reports).
#include "hopper_gemm.cuh"

using namespace dsg;

namespace {

constexpr int kRows = 64;    // rows of a tile: one m64 wgmma
constexpr int kD = 96;       // embedding width: one m64n96 wgmma
constexpr int kK = 32;       // input channels, zero-padded: two k16 steps
constexpr int kGroups = 2;   // warpgroups a block
constexpr int kBlockThreads = 128 * kGroups;
constexpr int kOutLd = kD + 8;  // bf16 a row of the output tile: pair stores hit 32 banks
constexpr int kWElems = kD * hg::kSlice;  // W in one swizzled 64-wide K slice
constexpr int kOutElems = kRows * kOutLd;
constexpr size_t kSmemBytes = 1024 + (size_t)kWElems * 2 + 3 * kD * 4 +
                              (size_t)kGroups * kOutElems * 2 + kK * 4;

struct EmbedIn {
  const float* adj;     // [M, Ca]
  const float* sc_adj;  // [M, Ca] or null (zeros)
  const float* node;    // [B N, Cx]
  const float* sc_node; // [B N, Cx] or null (zeros)
  const unsigned char* flags;  // [B N]
  const bf16* ss;       // [B, 192]: scale | shift
  int M, N, Ca, Cx;
};

// Where input channel k comes from: source 0..3 (adj, sc_adj, node,
// sc_node) or -1 (zero), the row it is read at (0: the pair's, 1: node i's,
// 2: node j's) and the channel in that source.  Packed in one int.
__device__ __forceinline__ int channel_code(int k, int Ca, int Cx, bool sc, bool has_sa,
                                            bool has_sx) {
  int src = -1, side = 0, ch = 0;
  if (sc) {
    if (k < Ca) src = has_sa ? 1 : -1, ch = k;
    else if (k < 2 * Ca) src = 0, ch = k - Ca;
    else if (k < 2 * Ca + 4 * Cx) {
      const int r = k - 2 * Ca, half = r / (2 * Cx), c = r - half * 2 * Cx;
      side = 1 + half;
      if (c < Cx) src = has_sx ? 3 : -1, ch = c;
      else src = 2, ch = c - Cx;
    }
  } else {
    if (k < Ca) src = 0, ch = k;
    else if (k < Ca + 2 * Cx) {
      const int r = k - Ca, half = r / Cx;
      side = 1 + half, src = 2, ch = r - half * Cx;
    }
  }
  return (src + 1) | (side << 3) | (ch << 5);
}

// channel `code` of the row (pair m; nodes gi and gj), without a branch that
// splits the warp: the lanes of a quad read different channels
__device__ __forceinline__ float channel_value(const EmbedIn& in, int code, int m, int gi, int gj,
                                               bool pair_ok) {
  const int src = (code & 7) - 1, side = (code >> 3) & 3, ch = code >> 5;
  const float* base = src == 0 ? in.adj : src == 1 ? in.sc_adj : src == 2 ? in.node : in.sc_node;
  const int row = side == 0 ? m : side == 1 ? gi : gj;
  const bool use = src >= 0 && (side == 0 || pair_ok);
  return use ? ld_ro(base + (size_t)row * (side == 0 ? in.Ca : in.Cx) + ch) : 0.f;
}

// SiLU with the fast exponential and division (2 ulp each in fp32): its
// result is rounded to bf16 at once, which hides them but where it lies
// within 2^-14 of a rounding boundary; the exact form's division took a
// fifth of the kernel's time
__device__ __forceinline__ float silu_approx(float v) { return __fdividef(v, 1.f + __expf(-v)); }

__device__ __forceinline__ void group_sync(int g) {
  if (g == 0) asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

__global__ void __launch_bounds__(kBlockThreads, 2)
patch_embed_kernel(EmbedIn in, const bf16* __restrict__ w, const bf16* __restrict__ bias,
                   const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                   bf16* __restrict__ out, int Cin, int sc) {
  extern __shared__ unsigned char smem_raw[];
  bf16* ws =
      reinterpret_cast<bf16*>(smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u));
  float* bias_s = reinterpret_cast<float*>(ws + kWElems);
  float* gamma_s = bias_s + kD;
  float* beta_s = gamma_s + kD;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, quad = lane & 3;
  bf16* ot = reinterpret_cast<bf16*>(beta_s + kD) + wg * kOutElems;
  int* code_s = reinterpret_cast<int*>(reinterpret_cast<bf16*>(beta_s + kD) + kGroups * kOutElems);
  const int tiles = (in.M + kRows - 1) / kRows, workers = gridDim.x * kGroups;

  // W [96, Cin] -> the swizzled slice, K zero-padded to 32; the row params
  for (int i = threadIdx.x; i < kD * kK; i += kBlockThreads) {
    const int r = i / kK, k = i - r * kK;
    hg::swizzled(ws, kD, r, k & ~7)[k & 7] = k < Cin ? w[r * Cin + k] : __float2bfloat16(0.f);
  }
  for (int i = threadIdx.x; i < kD; i += kBlockThreads) {
    bias_s[i] = __bfloat162float(bias[i]);
    gamma_s[i] = ln_w[i];
    beta_s[i] = ln_b[i];
  }
  if (threadIdx.x < kK)
    code_s[threadIdx.x] = channel_code(threadIdx.x, in.Ca, in.Cx, sc != 0, in.sc_adj != nullptr,
                                       in.sc_node != nullptr);
  hg::fence_proxy_async();
  __syncthreads();

  for (int t = blockIdx.x * kGroups + wg; t < tiles; t += workers) {
    // this lane's two rows: 16 warp + lane / 4 (+ 8)
    int b[2];
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = t * kRows + warp * 16 + (lane >> 2) + 8 * i;
      const bool ok = m < in.M;
      const int mm = ok ? m : 0;
      const int gi = mm / in.N, j = mm - gi * in.N;
      b[i] = gi / in.N;
      const int gj = b[i] * in.N + j;
      const bool pair_ok = in.flags[gi] && in.flags[gj];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // the lane's channels 16 kk + 8 h + 2 quad + e of the A fragments
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = ok ? channel_value(in, code_s[16 * kk + 8 * h + 2 * quad + e], mm, gi, gj,
                                      pair_ok)
                      : 0.f;
          a[kk][2 * h + i] = pack_bf16(v[0], v[1]);
        }
    }
    float acc[kD / 2];
    hg::wgmma_fence();
    hg::WgmmaRs<kD>::mma(acc, a[0], hg::sw128_desc(ws), 0);
    hg::WgmmaRs<kD>::mma(acc, a[1], hg::sw128_desc(ws) + 2);
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_regs(acc);

    // acc[4 j + 2 i + e]: row i of the lane's two, column 8 j + 2 quad + e
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int a_ = 0; a_ < kD / 2; ++a_) {
      const int col = 8 * (a_ >> 2) + 2 * quad + (a_ & 1);
      acc[a_] = round_bf16(acc[a_] + bias_s[col]);
      sum[(a_ >> 1) & 1] += acc[a_];
    }
    warp_sum_n<4>(sum);
    const float mean[2] = {sum[0] * (1.f / kD), sum[1] * (1.f / kD)};
    float sq[2] = {0.f, 0.f};
#pragma unroll
    for (int a_ = 0; a_ < kD / 2; ++a_) {
      const float d = acc[a_] - mean[(a_ >> 1) & 1];
      sq[(a_ >> 1) & 1] += d * d;
    }
    warp_sum_n<4>(sq);
    const float rstd[2] = {rsqrtf(sq[0] * (1.f / kD) + kLnEps),
                           rsqrtf(sq[1] * (1.f / kD) + kLnEps)};
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = 8 * j + 2 * quad;
        const float2 s =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(in.ss + b[i] * 2 * kD + col));
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(in.ss + b[i] * 2 * kD + kD + col));
        const float sc1[2] = {s.x, s.y}, sh[2] = {f.x, f.y};
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int a_ = 4 * j + 2 * i + e;
          const float y = round_bf16((acc[a_] - mean[i]) * rstd[i] * gamma_s[col + e] +
                                     beta_s[col + e]);
          const float p = round_bf16(y * round_bf16(sc1[e] + 1.f));
          o[e] = silu_approx(round_bf16(sh[e] + p));
        }
        const int r = warp * 16 + (lane >> 2) + 8 * i;
        *reinterpret_cast<uint32_t*>(ot + r * kOutLd + col) = pack_bf16(o[0], o[1]);
      }
    group_sync(wg);
    // the tile's rows out, 16 bytes a store along rows
    for (int c = tid; c < kRows * kD / 8; c += 128) {
      const int r = c / (kD / 8), k = (c - r * (kD / 8)) * 8;
      const int m = t * kRows + r;
      if (m < in.M)
        *reinterpret_cast<uint4*>(out + (size_t)m * kD + k) =
            *reinterpret_cast<const uint4*>(ot + r * kOutLd + k);
    }
    group_sync(wg);  // the output tile is free again
  }
}

cudaError_t patch_embed_ready() {
  static PerDevice ready;
  return ready.once([](int&) {
    return cudaFuncSetAttribute(patch_embed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kSmemBytes);
  });
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" int dsg_patch_embed(const void* adj, const void* sc_adj, const void* node,
                               const void* sc_node, const void* flags, const void* ss,
                               const void* w, const void* bias, const void* ln_w,
                               const void* ln_b, void* out, int M, int N, int Ca, int Cx, int Cin,
                               int sc, int blocks, void* stream) {
  const int want = sc ? 2 * Ca + 4 * Cx : Ca + 2 * Cx;
  if (M <= 0 || N <= 0 || M % (N * N) || Ca <= 0 || Cx <= 0 || Cin != want || Cin > kK ||
      blocks <= 0 || !aligned16(out))
    return -1;
  cudaError_t err = patch_embed_ready();
  if (err != cudaSuccess) return err;
  EmbedIn in{static_cast<const float*>(adj),  static_cast<const float*>(sc_adj),
             static_cast<const float*>(node), static_cast<const float*>(sc_node),
             static_cast<const unsigned char*>(flags), static_cast<const bf16*>(ss),
             M, N, Ca, Cx};
  patch_embed_kernel<<<blocks, kBlockThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      static_cast<const float*>(ln_w), static_cast<const float*>(ln_b), static_cast<bf16*>(out),
      Cin, sc);
  return cudaGetLastError();
}

// The tile of patch_embed for the wrapper's plan: geom = {rows a tile, tiles
// a block works on at once (its warpgroups), blocks an SM holds, 0}.
extern "C" int dsg_patch_embed_tile(int* geom) {
  cudaError_t err = patch_embed_ready();
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, patch_embed_kernel,
                                                        kBlockThreads, kSmemBytes);
  if (err != cudaSuccess) return err;
  geom[0] = kRows, geom[1] = kGroups, geom[2] = per_sm, geom[3] = 0;
  return 0;
}
