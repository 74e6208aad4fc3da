// mm_accumulate: the int8-versus-bf16 matrix-product micro-benchmark on Hopper.
//
// Replaces scripts/microbench_int8.py::mm_kernel: one program accumulates
// `repeats` products A[m, k] B[k, n] into two independent accumulator sets
// (repeats / 2 each) and writes their sum, so the output is repeats * (A B),
// for bf16 -> fp32 and for int8 -> int32.
//
// On the TPU a grid program holds all of A, B and the output in VMEM.  A
// Hopper block has 227 KB of shared memory and its accumulators live in
// registers, so here a block owns one 64 x 64 output tile (four warps, a
// 32 x 32 quadrant each, two accumulator sets of 2 x 2 WMMA m16n16k16
// fragments) and streams the tile's operands through shared memory in steps
// of 32 along k, once per product; A and B stay in L2 between the repeats.
// The whole output is computed `copies` times (grid = tiles x copies, chosen
// by the wrapper as a multiple of the card's SM count), as the TPU grid of 16
// programs computes it 16 times; every copy stores the same bits to `out`.
//
// Bound on the H100: operations (2 m k n repeats copies against m k + k n +
// 4 m n bytes).  This kernel measures what plain WMMA with single-buffered
// staging reaches; wgmma and TMA are what the card's peak needs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace dsg {

constexpr int kTile = 64;  // output tile of a block, both ways
constexpr int kStep = 32;  // elements along k per staging step

// Shared-memory tiles are kept as 16-wide slabs ([slab][row][ld]) so that
// every WMMA fragment starts 32-byte aligned for 1-byte elements too.
template <class T>
struct Slab {
  static constexpr int kVec = 16 / sizeof(T);  // elements of a 16-byte vector
  static constexpr int kLd = 16 + kVec;        // row of a slab, padded
};

template <class T, class AccT>
__global__ void __launch_bounds__(128)
mm_accumulate_kernel(const T* __restrict__ A, const T* __restrict__ B, AccT* __restrict__ out,
                     int M, int N, int K, int tiles_n, int tiles, int repeats) {
  using namespace nvcuda;
  using S = Slab<T>;
  __shared__ __align__(128) T As[(kStep / 16) * kTile * S::kLd];  // [k slab][row][ld]
  __shared__ __align__(128) T Bs[(kTile / 16) * kStep * S::kLd];  // [n slab][k row][ld]

  const int tile = blockIdx.x % tiles;
  const int m0 = (tile / tiles_n) * kTile, n0 = (tile % tiles_n) * kTile;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, AccT> acc[2][2][2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[s][i][j], AccT(0));

  for (int rep = 0; rep < repeats / 2; ++rep) {
    for (int k0 = 0; k0 < K; k0 += kStep) {
      __syncthreads();  // the previous step's readers are done with the tiles
      for (int i = tid; i < kTile * kStep / S::kVec; i += 128) {
        const int r = i / (kStep / S::kVec), kv = (i % (kStep / S::kVec)) * S::kVec;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < M) u = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + kv);
        *reinterpret_cast<uint4*>(As + ((kv / 16) * kTile + r) * S::kLd + kv % 16) = u;
      }
      for (int i = tid; i < kStep * kTile / S::kVec; i += 128) {
        const int r = i / (kTile / S::kVec), nv = (i % (kTile / S::kVec)) * S::kVec;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (n0 + nv < N) u = *reinterpret_cast<const uint4*>(B + (size_t)(k0 + r) * N + n0 + nv);
        *reinterpret_cast<uint4*>(Bs + ((nv / 16) * kStep + r) * S::kLd + nv % 16) = u;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kStep; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + ((kk / 16) * kTile + wm + i * 16) * S::kLd, S::kLd);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs + (((wn / 16) + j) * kStep + kk) * S::kLd, S::kLd);
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              wmma::mma_sync(acc[s][i][j], fa[i], fb[j], acc[s][i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = m0 + wm + i * 16, n = n0 + wn + j * 16;
      if (m >= M || n >= N) continue;
#pragma unroll
      for (int e = 0; e < acc[0][i][j].num_elements; ++e) acc[0][i][j].x[e] += acc[1][i][j].x[e];
      wmma::store_matrix_sync(out + (size_t)m * N + n, acc[0][i][j], N, wmma::mem_row_major);
    }
}

template <class T, class AccT>
cudaError_t launch_mm_accumulate(const void* a, const void* b, void* out, int M, int N, int K,
                                 int copies, int repeats, cudaStream_t s) {
  if (M <= 0 || M % 16 || N % 16 || K % kStep || copies < 1 || repeats < 2 || repeats % 2)
    return cudaErrorInvalidValue;
  const int tiles_n = (N + kTile - 1) / kTile, tiles = ((M + kTile - 1) / kTile) * tiles_n;
  mm_accumulate_kernel<T, AccT><<<tiles * copies, 128, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<AccT*>(out), M, N, K,
      tiles_n, tiles, repeats);
  return cudaGetLastError();
}

}  // namespace dsg

// a [M, K], b [K, N] row-major; out [M, N] fp32 (is_int8 = 0, bf16 operands)
// or int32 (is_int8 = 1, int8 operands).
extern "C" int dsg_mm_accumulate(const void* a, const void* b, void* out, int M, int N, int K,
                                 int copies, int repeats, int is_int8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int8)
    return dsg::launch_mm_accumulate<signed char, int>(a, b, out, M, N, K, copies, repeats, s);
  return dsg::launch_mm_accumulate<__nv_bfloat16, float>(a, b, out, M, N, K, copies, repeats, s);
}
