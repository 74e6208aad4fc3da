// Shared pieces of the Hopper kernels: small device helpers (erf-GELU,
// SiLU, bf16 rounding, warp sums, read-only loads, cp.async), the mma.sync
// pieces of the kernels that keep tiles in registers (the window cores, the
// fused MLP), one LayerNorm row by one warp (`ln_row`, the fused MLP's
// prologue; the wgmma GEMM's LayerNorm prologue hg::LnPanel repeats its
// arithmetic on shared memory), and the two-source A operand of the wgmma
// GEMM (GemmA).  Every GEMM of the port, forward and backward, runs on that
// GEMM (hopper_gemm.cuh) or in a kernel of its own built from its pieces.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>


namespace dsg {

using bf16 = __nv_bfloat16;

constexpr float kLnEps = 1e-6f;  // every LayerNorm of the model (flax default)

// A set-up step kept once per device.  A kernel's opt-in to more than 48 KB
// of dynamic shared memory (cudaFuncSetAttribute) and an occupancy query
// hold for the calling thread's current device only, so a process that
// drives several cards runs each once on each card.  `once(f)` runs
// f(value) the first time it is called on a device and returns its result
// (and the int it left in `value`) every time after.
struct PerDevice {
  static constexpr int kMaxDevices = 64;
  std::mutex mu;
  bool done[kMaxDevices] = {};
  cudaError_t err[kMaxDevices] = {};
  int value[kMaxDevices] = {};

  template <class F>
  cudaError_t once(F&& f, int* out = nullptr) {
    int dev = 0;
    const cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mu);
    if (!done[dev]) {
      err[dev] = f(value[dev]);
      done[dev] = true;
    }
    if (out) *out = value[dev];
    return err[dev];
  }
};

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the same for N independent values at once (their shuffles interleave),
// each summed over aligned groups of LANES lanes
template <int LANES = 32, int N>
__device__ __forceinline__ void warp_sum_n(float (&v)[N]) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], o);
}

// Loads of data that no kernel writes while it runs (weights, biases,
// LayerNorm parameters, a launch's inputs): plain asm without `volatile` or a
// memory clobber, so the compiler may move them ahead of stores it cannot
// prove apart, and an epilogue's loads overlap instead of queueing behind
// each store.
__device__ __forceinline__ float ld_ro(const float* p) {
  float v;
  asm("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float4 ld_ro4(const float* p) {  // 16-byte aligned
  float4 v;
  asm("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}
__device__ __forceinline__ void ld_ro8(const bf16* p, float v[8]) {  // 16-byte aligned
  uint4 u;
  asm("ld.global.nc.v4.b32 {%0, %1, %2, %3}, [%4];"
      : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
      : "l"(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

// eight consecutive bf16 (16-byte aligned) -> float
__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// ------------------------------------------------ register-level MMA pieces
//
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) with fragments loaded by
// ldmatrix, for the kernels that keep intermediate tiles in registers (the
// forward window core, the fused MLP).  Lane l holds, with g = l / 4 and
// t = l % 4: of the 16x16 A tile a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..),
// a[2] = (g, 2t+8..), a[3] = (g+8, 2t+8..); of the 16x8 B tile (k x n)
// b[0] = (k 2t..2t+1, n g), b[1] = (k 2t+8.., n g); of the 16x8 fp32
// accumulator c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..2t+1).

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, each matrix transposed (a B operand stored k-major)
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// two 8x8 matrices; lanes 0..15 give the row addresses
__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a b for one 16x8x16 tile
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// A fragment of a 16x16 tile of a row-major bf16 tile in shared memory
// (row stride ld elements), rows r0.., columns k0..
__device__ __forceinline__ void load_a16(uint32_t a[4], const bf16* tile, int ld, int r0, int k0,
                                         int lane) {
  ldsm_x4(a, tile + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// B fragments of two n-tiles (n0.., n0+8..) x k16 from an [n][k] row-major
// tile (a Linear weight, or K of attention): {b0, b1} of n0, then of n0 + 8
__device__ __forceinline__ void load_b16x2(uint32_t b[4], const bf16* tile, int ld, int n0,
                                           int k0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// B fragment of one n-tile x k16 from an [n][k] row-major tile
__device__ __forceinline__ void load_b16(uint32_t b[2], const bf16* tile, int ld, int n0, int k0,
                                         int lane) {
  ldsm_x2(b, tile + (n0 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// ------------------------------------------------------- a LayerNorm row

// A plain row-major bf16 [M, K] source.
struct RowSrc {
  const bf16* x;
  int K;
  __device__ void raw8(int m, int k, float v[8]) const { load8(x + (size_t)m * K + k, v); }
};

// LayerNorm of source row `row` by one warp, written in bf16 to `out` (the
// row's first element, device or shared memory); the row is held in
// registers (MAXV vectors of 8 per lane: K <= 256 * MAXV).
template <class Src, int MAXV>
__device__ __forceinline__ void ln_row(const Src& src, int row, int K, int lane,
                                       const float* __restrict__ gamma,
                                       const float* __restrict__ beta, bf16* out) {
  float v[MAXV][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int k = (i * 32 + lane) * 8;
    if (k < K) {
      src.raw8(row, k, v[i]);
#pragma unroll
      for (int t = 0; t < 8; ++t) s += v[i][t];
    }
  }
  const float mean = warp_sum(s) / K;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int k = (i * 32 + lane) * 8;
    if (k < K) {
#pragma unroll
      for (int t = 0; t < 8; ++t) q += (v[i][t] - mean) * (v[i][t] - mean);
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / K + kLnEps);
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int k = (i * 32 + lane) * 8;
    if (k < K) {
      float o[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) o[t] = (v[i][t] - mean) * rstd * gamma[k + t] + beta[k + t];
      store8(out + k, o);
    }
  }
}

// ------------------------------------------------------- the GEMM operand

// A = [a1 | a2] along K, both row-major bf16 (a2 may be null with K2 = 0).
struct GemmA {
  const bf16* a1;
  const bf16* a2;
  int K1, K2;
};

inline GemmA rows(const void* a, int K) {
  return GemmA{static_cast<const bf16*>(a), nullptr, K, 0};
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace dsg
