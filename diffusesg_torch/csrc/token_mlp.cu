// token_mlp: the MLP half of a Swin block on Hopper, over flattened tokens.
//
// Replaces the MLP half of diffusesg_tpu/ops/swin_block_v3.py::_kernel and
// the whole of diffusesg_tpu/ops/mlp_block_kernel.py::_kernel (entry
// fused_mlp_block, which v3 calls for the C=768 blocks whose MLP does not
// fuse on the TPU):
//
//   out = x + bf16(fc2(bf16(gelu_erf(fc1(bf16(LN2(x)))))))
//
// Bound on the H100 at the VG and COCO shapes: operations (16 C^2 FLOP per
// token against 4 C bytes of activations in and out, C >= 96).  One fused
// kernel in which the [M, 4C] hidden never reaches device memory, as the TPU
// kernel keeps it in VMEM:
//   - a block owns BM token rows; its prologue takes LN2 of them (fp32, two
//     passes, the row pass's `ln_row`) into a bf16 tile in shared memory;
//   - it walks the hidden dimension in chunks of BH columns: fc1 of the chunk
//     on the tensor cores (mma.sync m16n8k16, fragments by ldmatrix), + b1,
//     exact erf-GELU, rounded to bf16 (the plain version's rounding point)
//     into a small shared tile, and that tile times the W2 chunk accumulated
//     into the block's fc2 result [BM, C] in fp32 registers;
//   - W1 and W2 chunks, the only operands read more than once (from L2),
//     stream alternately through a two-slot cp.async ring, so the next
//     chunk loads while this one multiplies (one barrier a chunk; a deeper
//     ring measured no faster: loads are not what bounds it);
//   - epilogue: + b2, rounded to bf16, + x, stored in 16-byte vectors.
// Where the row tiles are too few to fill the SMs (C384, C768, COCO's
// smaller grids), grid.y splits the hidden chunks: each split writes an fp32
// partial [M, C] and a closing pass adds them in a fixed order, then b2, the
// rounding and x, so the result is bit-equal from run to run (no atomics).
// The wrapper plans the split (mlp_block_kernel.mlp_fwd_plan) and allocates
// the partials.
//
// What bounds it in practice is shared-memory traffic per MMA (ldmatrix of
// the fragments, and the weight chunks written once per BM rows), so warp
// tiles are 32 rows where the registers allow: a B fragment then feeds two
// MMAs.  Register budget per C (8 warps; the fc2 accumulator is BM C / 256
// floats a thread, fc1's BM BH / 256):
//   C  64, 96: BM 128, BH 64; fc1 warps 4x2 (32x32), fc2 4x2 (32x32 / 32x48):
//              fc2 32 / 48 floats, fc1 32;
//   C 192:     BM  64, BH 64; fc1 4x2 (16x32), fc2 2x4 (32x48): 48 and 16;
//   C 384:     BM  64, BH 64; fc1 4x2 (16x32), fc2 2x4 (32x96): 96 and 16;
//   C 768:     BM  32, BH 32; fc1 2x4 (16x8, one n-tile, so four independent
//              accumulator chains over K), fc2 1x8 (32x96): 96 and 4 x 4.
// Shared memory: the LN2 tile BM (C + 8), a W1 slot BH (C + 8) and a W2
// slot C (BH + 8), and the hidden tile BM (BH + 8), in bf16: 54, 71, 86,
// 161 and 160 KB; two blocks an SM up to C 192, one above.
#include "common.cuh"

using namespace dsg;

namespace {

// The tile of one C: BM token rows a block, BH hidden columns a chunk, the
// 8 warps as W1M x (8 / W1M) over the fc1 tile [BM, BH] and W2M x (8 / W2M)
// over the fc2 tile [BM, C], PER_SM blocks an SM holds.  A warp tile of 32
// rows lets each B fragment from shared memory feed two MMAs.  (16 warps a
// block measured slower at every C: occupancy is not what bounds it.)
template <int C_, int BM_, int BH_, int W1M_, int W2M_, int PER_SM_>
struct MlpTile {
  static constexpr int C = C_, BM = BM_, BH = BH_, kBlocksPerSm = PER_SM_;
  static constexpr int kThreads = 256, kWarps = 8;
  static constexpr int W1M = W1M_, W1N = kWarps / W1M, W2M = W2M_, W2N = kWarps / W2M;
  static constexpr int MT1 = BM / W1M / 16, NT1 = BH / W1N / 8;  // fc1 m- and n-tiles a warp
  static constexpr int MT2 = BM / W2M / 16, NT2 = C / W2N / 8;   // fc2 m- and n-tiles a warp
  static constexpr int KS1 = MT1 * NT1 >= 4 ? 1 : 4 / (MT1 * NT1);  // fc1 accumulator chains
  static constexpr int LdH = C + 8;   // LN2 tile and W1 chunk rows
  static constexpr int LdM = BH + 8;  // hidden tile and W2 chunk rows
  static constexpr int kW1 = BH * LdH, kW2 = C * LdM;  // ring slots, bf16 elements
  static constexpr int kSmemBytes = (BM * LdH + kW1 + kW2 + BM * LdM) * 2;
  static constexpr int MAXV = (C + 255) / 256;
  static_assert(MT1 >= 1 && NT1 >= 1 && MT2 >= 1 && NT2 % 2 == 0 && C % 16 == 0, "tile");
};

// The tile each C runs (PER_SM is the register budget of __launch_bounds__;
// the wrapper reads BM, BH and the card's occupancy through dsg_token_mlp_tile).
template <int C> struct MlpConfig;
template <> struct MlpConfig<64> { using T = MlpTile<64, 128, 64, 4, 4, 2>; };
template <> struct MlpConfig<96> { using T = MlpTile<96, 128, 64, 4, 4, 2>; };
template <> struct MlpConfig<192> { using T = MlpTile<192, 64, 64, 4, 2, 2>; };
template <> struct MlpConfig<384> { using T = MlpTile<384, 64, 64, 4, 2, 1>; };
template <> struct MlpConfig<768> { using T = MlpTile<768, 32, 32, 2, 1, 1>; };

// grid (row tiles, splits), 256 threads, MlpTile::kSmemBytes of dynamic
// shared memory.  Split y covers hidden chunks [y cps, min((y + 1) cps,
// hidden / BH)); with one split the block writes `out`, else its fp32
// partial part[y] [M, C] without b2.
template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kBlocksPerSm)
token_mlp_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_g,
                 const float* __restrict__ ln_b, const bf16* __restrict__ w1,
                 const float* __restrict__ b1, const bf16* __restrict__ w2,
                 const float* __restrict__ b2, float* __restrict__ part,
                 bf16* __restrict__ out, int M, int hidden, int cps) {
  constexpr int C = T::C, BM = T::BM, BH = T::BH, LdH = T::LdH, LdM = T::LdM;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Hs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = Hs + BM * LdH;  // the W1 slot, then the W2 slot
  bf16* Ms = ring + T::kW1 + T::kW2;

  const int m0 = blockIdx.x * BM;
  const int c_beg = blockIdx.y * cps;
  const int c_end = min(c_beg + cps, hidden / BH);
  const int n_tiles = 2 * (c_end - c_beg);  // W1 chunk, W2 chunk, alternately
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // the warp's first row and column in the fc1 and the fc2 tile
  const int r1 = (warp % T::W1M) * T::MT1 * 16, c1 = (warp / T::W1M) * T::NT1 * 8;
  const int r2 = (warp % T::W2M) * T::MT2 * 16, c2 = (warp / T::W2M) * T::NT2 * 8;

  // ring tile i into slot i & 1: W1 rows [h0, h0 + BH) x C, or W2's C rows x
  // hidden columns [h0, h0 + BH)
  auto load = [&](int i) {
    if (i >= n_tiles) return;
    bf16* slot = ring + (i & 1) * T::kW1;
    const int h0 = (c_beg + i / 2) * BH;
    if ((i & 1) == 0) {
      for (int v = tid; v < BH * (C / 8); v += T::kThreads) {
        const int r = v / (C / 8), k = (v % (C / 8)) * 8;
        cp_async16(slot + r * LdH + k, w1 + (size_t)(h0 + r) * C + k, true);
      }
    } else {
      for (int v = tid; v < C * (BH / 8); v += T::kThreads) {
        const int r = v / (BH / 8), k = (v % (BH / 8)) * 8;
        cp_async16(slot + r * LdM + k, w2 + (size_t)r * hidden + h0 + k, true);
      }
    }
    cp_async_commit();
  };
  load(0);

  // LN2 of the block's rows into Hs; rows past M are zero
  const RowSrc src{x, C};
  for (int r = warp; r < BM; r += T::kWarps) {
    if (m0 + r < M) {
      ln_row<RowSrc, T::MAXV>(src, m0 + r, C, lane, ln_g, ln_b, Hs + r * LdH);
    } else {
      for (int k = lane * 8; k < C; k += 256)
        *reinterpret_cast<uint4*>(Hs + r * LdH + k) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  float acc2[T::MT2][T::NT2][4] = {};
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<0>();  // tile i has landed ...
    __syncthreads();  // ... for every thread (at i = 0, Hs too), and every warp is
                      // done with tile i - 1, whose slot tile i + 1 takes
    load(i + 1);
    const bf16* slot = ring + (i & 1) * T::kW1;
    if ((i & 1) == 0) {
      // fc1: the warp's MT1 x 16 rows x NT1 x 8 hidden columns, K = C
      float acc1[T::KS1][T::MT1][T::NT1][4] = {};
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
        float(&acc)[T::MT1][T::NT1][4] = acc1[kk % T::KS1];
        uint32_t a[T::MT1][4];
#pragma unroll
        for (int mt = 0; mt < T::MT1; ++mt) load_a16(a[mt], Hs, LdH, r1 + mt * 16, kk * 16, lane);
        if constexpr (T::NT1 % 2 == 0) {
#pragma unroll
          for (int n = 0; n < T::NT1; n += 2) {
            uint32_t b[4];
            load_b16x2(b, slot, LdH, c1 + n * 8, kk * 16, lane);
#pragma unroll
            for (int mt = 0; mt < T::MT1; ++mt) {
              mma16816(acc[mt][n], a[mt], b[0], b[1]);
              mma16816(acc[mt][n + 1], a[mt], b[2], b[3]);
            }
          }
        } else {
#pragma unroll
          for (int n = 0; n < T::NT1; ++n) {
            uint32_t b[2];
            load_b16(b, slot, LdH, c1 + n * 8, kk * 16, lane);
#pragma unroll
            for (int mt = 0; mt < T::MT1; ++mt) mma16816(acc[mt][n], a[mt], b[0], b[1]);
          }
        }
      }
      // + b1, erf-GELU, bf16 into the hidden tile
      const int h0 = (c_beg + i / 2) * BH;
#pragma unroll
      for (int n = 0; n < T::NT1; ++n) {
        const int col = c1 + n * 8 + 2 * t4;
        const float2 bias = *reinterpret_cast<const float2*>(b1 + h0 + col);
#pragma unroll
        for (int mt = 0; mt < T::MT1; ++mt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float v0 = acc1[0][mt][n][2 * half], v1 = acc1[0][mt][n][2 * half + 1];
#pragma unroll
            for (int ks = 1; ks < T::KS1; ++ks) {
              v0 += acc1[ks][mt][n][2 * half];
              v1 += acc1[ks][mt][n][2 * half + 1];
            }
            *reinterpret_cast<uint32_t*>(Ms + (r1 + mt * 16 + g + 8 * half) * LdM + col) =
                pack_bf16(gelu_erf(v0 + bias.x), gelu_erf(v1 + bias.y));
          }
        }
      }
    } else {
      // fc2: the warp's MT2 x 16 rows x NT2 x 8 output columns += the hidden
      // tile x the W2 chunk^T
#pragma unroll
      for (int kk = 0; kk < BH / 16; ++kk) {
        uint32_t a[T::MT2][4];
#pragma unroll
        for (int mt = 0; mt < T::MT2; ++mt) load_a16(a[mt], Ms, LdM, r2 + mt * 16, kk * 16, lane);
#pragma unroll
        for (int n = 0; n < T::NT2; n += 2) {
          uint32_t b[4];
          load_b16x2(b, slot, LdM, c2 + n * 8, kk * 16, lane);
#pragma unroll
          for (int mt = 0; mt < T::MT2; ++mt) {
            mma16816(acc2[mt][n], a[mt], b[0], b[1]);
            mma16816(acc2[mt][n + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }
  }

  if (gridDim.y > 1) {  // an fp32 partial, b2 and the residual in the closing pass
    float* p = part + (size_t)blockIdx.y * M * C;
#pragma unroll
    for (int mt = 0; mt < T::MT2; ++mt)
#pragma unroll
      for (int n = 0; n < T::NT2; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = m0 + r2 + mt * 16 + g + 8 * half, col = c2 + n * 8 + 2 * t4;
          if (m < M)
            *reinterpret_cast<float2*>(p + (size_t)m * C + col) =
                make_float2(acc2[mt][n][2 * half], acc2[mt][n][2 * half + 1]);
        }
    return;
  }
  // bf16(y + b2) into Hs (no warp reads it after the last fc1, which every
  // warp finished before the last barrier), then out = x + it in 16-byte
  // vectors
#pragma unroll
  for (int n = 0; n < T::NT2; ++n) {
    const int col = c2 + n * 8 + 2 * t4;
    const float2 bias = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
    for (int mt = 0; mt < T::MT2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<uint32_t*>(Hs + (r2 + mt * 16 + g + 8 * half) * LdH + col) =
            pack_bf16(acc2[mt][n][2 * half] + bias.x, acc2[mt][n][2 * half + 1] + bias.y);
  }
  __syncthreads();
  for (int v = tid; v < BM * (C / 8); v += T::kThreads) {
    const int r = v / (C / 8), k = (v % (C / 8)) * 8;
    if (m0 + r >= M) continue;
    float xv[8], yv[8];
    load8(x + (size_t)(m0 + r) * C + k, xv);
    load8(Hs + r * LdH + k, yv);
#pragma unroll
    for (int q = 0; q < 8; ++q) xv[q] += yv[q];
    store8(out + (size_t)(m0 + r) * C + k, xv);
  }
}

// out = x + bf16(sum_s part[s] + b2), the partials added in order s = 0, 1, ..
__global__ void __launch_bounds__(256)
mlp_close_kernel(const float* __restrict__ part, int splits, const float* __restrict__ b2,
                 const bf16* __restrict__ x, bf16* __restrict__ out, int M, int C) {
  const size_t e = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (e >= (size_t)M * C) return;
  const int col = e % C;
  float y[8];
  {
    const float4 lo = *reinterpret_cast<const float4*>(part + e);
    const float4 hi = *reinterpret_cast<const float4*>(part + e + 4);
    y[0] = lo.x, y[1] = lo.y, y[2] = lo.z, y[3] = lo.w;
    y[4] = hi.x, y[5] = hi.y, y[6] = hi.z, y[7] = hi.w;
  }
  for (int s = 1; s < splits; ++s) {
    const float* p = part + (size_t)s * M * C + e;
    const float4 lo = *reinterpret_cast<const float4*>(p);
    const float4 hi = *reinterpret_cast<const float4*>(p + 4);
    y[0] += lo.x, y[1] += lo.y, y[2] += lo.z, y[3] += lo.w;
    y[4] += hi.x, y[5] += hi.y, y[6] += hi.z, y[7] += hi.w;
  }
  float xv[8];
  load8(x + e, xv);
#pragma unroll
  for (int q = 0; q < 8; ++q) xv[q] += round_bf16(y[q] + b2[col + q]);
  store8(out + e, xv);
}

// Opt the kernel into its dynamic shared memory (once; the result is kept).
template <class T>
cudaError_t token_mlp_opt_in() {
  static const cudaError_t err = cudaFuncSetAttribute(
      token_mlp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  return err;
}

// geom = {BM, BH, blocks an SM holds as the card reports it for the kernel's
// registers and shared memory}: what the wrapper's grid plan needs.
template <class T>
int token_mlp_tile(int* geom) {
  int per_sm = 0;
  if (token_mlp_opt_in<T>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, token_mlp_kernel<T>, T::kThreads,
                                                    T::kSmemBytes) != cudaSuccess ||
      per_sm <= 0)
    return -2;
  geom[0] = T::BM, geom[1] = T::BH, geom[2] = per_sm;
  return 0;
}

template <class T>
cudaError_t launch_token_mlp(const bf16* x, const float* ln_g, const float* ln_b, const bf16* w1,
                             const float* b1, const bf16* w2, const float* b2, float* part,
                             bf16* out, int M, int hidden, int splits, int cps,
                             cudaStream_t s) {
  const cudaError_t opt = token_mlp_opt_in<T>();
  if (opt != cudaSuccess) return opt;
  const int nch = hidden / T::BH;
  if (hidden % T::BH || splits <= 0 || splits > 65535 || cps <= 0 || splits * cps < nch ||
      (splits - 1) * cps >= nch || (splits > 1 && !part))
    return cudaErrorInvalidValue;
  const dim3 grid((M + T::BM - 1) / T::BM, splits);
  token_mlp_kernel<T><<<grid, T::kThreads, T::kSmemBytes, s>>>(x, ln_g, ln_b, w1, b1, w2, b2,
                                                               part, out, M, hidden, cps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t vecs = (size_t)M * T::C / 8;
  mlp_close_kernel<<<(unsigned)((vecs + 255) / 256), 256, 0, s>>>(part, splits, b2, x, out, M,
                                                                  T::C);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dsg_token_mlp(const void* x, const void* ln_g, const void* ln_b, const void* w1,
                             const void* b1, const void* w2, const void* b2, void* part,
                             void* out, int M, int C, int hidden, int splits, int cps,
                             void* stream) {
  if (M <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto launch) {
    return launch(static_cast<const bf16*>(x), static_cast<const float*>(ln_g),
                  static_cast<const float*>(ln_b), static_cast<const bf16*>(w1),
                  static_cast<const float*>(b1), static_cast<const bf16*>(w2),
                  static_cast<const float*>(b2), static_cast<float*>(part),
                  static_cast<bf16*>(out), M, hidden, splits, cps, s);
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
