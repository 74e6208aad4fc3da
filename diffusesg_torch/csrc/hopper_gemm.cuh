// A bf16 x bf16 -> fp32 GEMM on Hopper's warpgroup MMA (wgmma), with a fused
// prologue and epilogue: C[m, n] = epi(m, n, sum_k A[m, k] * W[n, k]), W the
// PyTorch Linear weight [N, K] (K-major, the B operand wgmma reads as it is).
// It is the port's one GEMM.
//
// Call sites: patch_merge's product and patch_breakup's two products
// (patch_resample.cu), and every product of the backward kernels
// (swin_attn_bwd.cu, token_mlp_bwd.cu, backward.cuh), which need two more
// operand layouts, both read MN-major through wgmma's transpose modes for
// 16-bit types:
//   * W stored [K, N] (Tile::kBMn): a Linear weight taken untransposed
//     (dout W2, dy Wproj, du W1, dqkv Wqkv), TMA boxes of 64 N x 64 K;
//   * the token-axis contraction dW[i, j] = sum_t a[t, i] b[t, j]
//     (Tile::kAMn with kBMn): both operands [T, .] row-major, 64 tokens a
//     box, K = tokens split over the grid's z into fp32 partials
//     (PartialEpi) that reduce_partials (backward.cuh) adds in a fixed order.
// The Swin attention half's forward (swin_attn.cu), readout (readout.cu),
// the fused MLP forward (token_mlp.cu) and backward (token_mlp_bwd.cu) and
// the int8 / bf16 micro-benchmark (mm_microbench.cu) are kernels of their
// own built from the PTX pieces below (and the LN1 prologue, LnPanel).
//
// A block is one or two consumer warpgroups and one producer warp.  The
// producer's lane 0 streams 64-wide K slices of W by TMA (cp.async.bulk.tensor,
// 128-byte swizzle, tensor map encoded on the host through
// cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled"), so the build
// needs no -lcuda) into a ring of STAGES slots guarded by mbarriers: `full`
// (the slot's bytes have landed) and `empty` (every consumer warp is done with
// it).  Each consumer warpgroup owns a 64 x NW tile of the block's BM x BN
// output and issues m64nNWk16 wgmmas with both operands read from shared
// memory through descriptors in the 128-byte-swizzled K-major layout; one
// group stays in flight while the next slot is waited for.  The accumulators
// stay in registers through the epilogue.  Two ways for A:
//   (a) resident panel (Tile::kPanel): the block's BM x K rows are built once
//       by a prologue functor (`fill`: LayerNorm'd, affine'd, gathered or
//       copied rows), already swizzled, and the block walks its N tiles of W;
//   (b) streamed: A = [a1 | a2] (a second source so a concatenated skip is
//       never materialized) arrives by TMA beside W in every slot.
// The grid is (row tiles, column splits): block (x, y) walks N tiles
// [y * per, (y + 1) * per).  Where the row tiles are too few to fill the card
// the wrapper splits N (each split redoes its rows' prologue); the plan is
// Python's (ops/cuda_build.py::gemm_plan), the tile and the occupancy it
// reads are the library's (the sites' *_tile queries).
//
// Epilogues get eight consecutive columns of a row at a time (`put8`): each
// warp passes its 16 x 32 slices of accumulators through a small tile of its
// own in shared memory, so loads of the epilogue's operands and stores of
// the output are 16-byte vectors along rows (in the accumulator layout a
// warp's 4-byte accesses touch 8 cache lines for 128 bytes).  With
// kWholeRows an epilogue gets the block's whole BM x BN fp32 tile instead,
// staged over the ring, which is free by then (`rows`): LayerNorms over a
// whole output row (patch_breakup's LN1) need every column.  Loads of
// read-only operands (ld_ro, common.cuh) may move ahead of stores, so a
// thread's loads overlap.
//
// Swizzle: a 64-element (128-byte) K slice of R rows is stored as R rows of
// 128 bytes; 16-byte chunk j of row r lies at chunk j ^ (r % 8).  Every slice
// is 1024-byte aligned, so the pattern is the one TMA writes and wgmma reads
// (descriptor layout type 1, SBO = 8 rows = 1024 bytes; a k16 step inside the
// slice adds 32 bytes to the start address).  An MN-major box is the same
// pattern with K as its rows: 128 bytes of 64 M (or N) elements a row, SBO
// 1024 bytes between 8-row K groups, LBO the distance between 64-element
// M/N boxes, a k16 step 16 rows (2048 bytes).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace dsg {

// Call sites of the Hopper GEMM: an empty tag type per site, so each launch
// has a kernel name of its own in a profile.
struct MergeProj {};
struct BreakupIn {};
struct BreakupOut {};

namespace hg {

constexpr int kSlice = 64;  // bf16 elements of one 128-byte swizzled K slice

constexpr int kMaxDynSmem = 227 * 1024 - 1024;  // leaves room for the static barriers

// ------------------------------------------------------------ PTX pieces

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// a box {64, rows} of a 2-D bf16 tensor map at (k, row) into shared memory
__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst, uint64_t* bar, int k,
                                         int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(k), "r"(row)
      : "memory");
}

// generic-proxy writes to shared memory, visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the block's `threads` consumer threads only (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across a wgmma wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// descriptor of a K-major, 128-byte-swizzled operand starting at p (1024-byte
// aligned slice; +2 per k16 step)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// descriptor of an MN-major, 128-byte-swizzled operand starting at p: rows
// are K (128 bytes, 64 M or N elements each), 8-row groups 1024 bytes apart
// (SBO), successive 64-element MN blocks `mn_bytes` apart (LBO); +128 per
// k16 step (16 rows)
__device__ __forceinline__ uint64_t mn128_desc(const void* p, unsigned mn_bytes) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(mn_bytes >> 4) << 16) |
         (64ull << 32) | (1ull << 62);
}

// a box of shared memory back to a 2-D bf16 tensor map at (inner, outer),
// as one bulk group of this thread (rows or columns outside the tensor are
// not written); bulk_wait_read<0> before the box is written again
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// element (r, k) of a swizzled panel of R rows: slice k / 64, row r, chunk
// (k / 8) ^ (r % 8); k a multiple of 8 (one 16-byte chunk)
__device__ __forceinline__ bf16* swizzled(bf16* panel, int R, int r, int k) {
  return panel + (k >> 6) * R * kSlice + r * kSlice + ((((k >> 3) & 7) ^ (r & 7)) << 3);
}

// D (64 x N, fp32, the accumulator layout) += A (64 x 16) B (16 x N), both
// from shared memory; TA / TB = 1 reads A / B MN-major (the transpose modes
// of 16-bit types: M or N contiguous in shared memory).  scale_d = 0: D = A B,
// D's old values unread (a first product needs no zeroed accumulator, which
// ptxas would take for a write between in-flight wgmmas and serialize them)
template <int N, int TA = 0, int TB = 0>
struct Wgmma;

template <int TA, int TB>
struct Wgmma<16, TA, TB> {
  __device__ static void mma(float (&d)[8], uint64_t da, uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, "
        "%8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<32, TA, TB> {
  __device__ static void mma(float (&d)[16], uint64_t da, uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, "
        "%16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<64, TA, TB> {
  __device__ static void mma(float (&d)[32], uint64_t da, uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<96, TA, TB> {
  __device__ static void mma(float (&d)[48], uint64_t da, uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "%48, %49, p, 1, 1, %51, %52;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<192, TA, TB> {
  __device__ static void mma(float (&d)[96], uint64_t da, uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
        "%96, %97, p, 1, 1, %99, %100;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<128, TA, TB> {
  __device__ static void mma(float (&d)[64], uint64_t da, uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<256, TA, TB> {
  __device__ static void mma(float (&d)[128], uint64_t da, uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, "
        "%128, %129, p, 1, 1, %131, %132;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

// D (64 x 16, fp32, the accumulator layout) += A (64 x 16) B (16 x 16), A
// from registers (the RS form): each warp holds its 16 rows as an mma.sync
// m16n8k16 A fragment (common.cuh), which is how a 64 x N accumulator's
// columns 16 k .. 16 k + 15 lie once packed to bf16 pairs: acc[8 k + 2 q],
// acc[8 k + 2 q + 1] -> a[q]
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the same at N columns (D 64 x N += A 64 x 16 from registers, B 16 x N
// from shared memory, K-major): a[0..3] as above
template <int N>
struct WgmmaRs;

template <>
struct WgmmaRs<64> {
  __device__ static void mma(float (&d)[32], const uint32_t* a, uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaRs<96> {
  __device__ static void mma(float (&d)[48], const uint32_t* a, uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaRs<192> {
  __device__ static void mma(float (&d)[96], const uint32_t* a, uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
        "{%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};


// -------------------------------------------------------------- the tiles

// BM x BN output per block; WGN consumer warpgroups side by side along N
// (2: each 64 x BN/2) or one column of them along M (1: each 64 x BN; BM =
// 64, one warpgroup, or 128, two).  kPanel: mode (a), A resident; else mode
// (b), A streamed.  MINB: blocks an SM is meant to hold (the register budget
// of __launch_bounds__).  The backward's layouts: AMN, A stored [K, M] (the
// token-axis contraction: K = tokens; streamed in boxes of 64 M x 64 K,
// read MN-major); BMN, W stored [K, N] (a Linear weight taken untransposed,
// or the token-axis contraction's second operand; boxes of 64 N x 64 K,
// read MN-major).
template <int BM_, int BN_, int WGN_, int STAGES_, bool PANEL_, int MINB_, bool AMN_ = false,
          bool BMN_ = false>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WGN = WGN_, STAGES = STAGES_, MINB = MINB_;
  static constexpr bool kPanel = PANEL_, kAMn = AMN_, kBMn = BMN_;
  static constexpr int NW = BN / WGN;  // columns of one consumer warpgroup
  static constexpr int kGroups = BM / 64 * WGN;  // consumer warpgroups
  static constexpr int kConsumers = 128 * kGroups, kThreads = kConsumers + 32;
  static constexpr int kWBoxes = (BN + kSlice - 1) / kSlice;  // MN-major W: 64-column boxes
  static constexpr int kAStage = kPanel ? 0 : BM * kSlice;  // bf16 elements of a slot
  static constexpr int kWStage = (kBMn ? kWBoxes * kSlice : BN) * kSlice;
  static constexpr int kStageBytes = (kAStage + kWStage) * 2;
  static constexpr int kEpiLd = 36;  // floats a row of a warp's epilogue tile (16 x 32)
  static constexpr int kEpiBytes = kConsumers / 32 * 16 * kEpiLd * 4;
  static_assert((BM == 64 || (BM == 128 && WGN == 1)) && kGroups <= 2 && NW % 32 == 0 &&
                    NW <= 256,
                "tile");
  static_assert(!kAMn || (!kPanel && WGN == 1), "an MN-major A is streamed, 64 rows a group");
  static_assert(!kBMn || WGN == 1 || NW % kSlice == 0, "MN-major W: whole boxes a group");
  __host__ __device__ static size_t panel_bytes(int K) {
    return kPanel ? (size_t)BM * ((K + kSlice - 1) / kSlice * kSlice) * 2 : 0;
  }
  __host__ __device__ static size_t ring_bytes() { return (size_t)STAGES * kStageBytes; }
  __host__ __device__ static size_t smem_bytes(int K) {
    return 1024 + panel_bytes(K) + ring_bytes() + kEpiBytes;
  }
};

// the tiles the sites run
using PanelRows = Tile<128, 96, 1, 3, true, 2>;   // mode (a), two blocks an SM up to K = 192
using PanelTall = Tile<128, 96, 1, 4, true, 1>;   // mode (a), K <= 384, registers for the prologue
using PanelWide = Tile<64, 192, 2, 4, true, 1>;   // mode (a), K <= 768
// mode (a), K <= 1536: a 64 x 1536 panel is 192 KB, so one warpgroup and a
// two-slot ring of W (12 KB a slot) fill the shared memory exactly
using PanelDeep = Tile<64, 96, 1, 2, true, 1>;
using StreamRows = Tile<128, 96, 1, 3, false, 2>; // mode (b), any K
using StreamLine = Tile<64, 384, 2, 3, false, 1>; // mode (b), whole rows of N <= 384
// the backward's: A streamed, W [K, N] MN-major (dy Wproj and dqkv Wqkv
// below C192), and the token-axis contraction dW = a^T b (both MN-major,
// 96 or 192 columns a tile, K split over the grid's z)
using StreamRowsT = Tile<128, 96, 1, 3, false, 2, false, true>;
// the wide products' (the resampling backwards; the attention chain's dy
// Wproj and dqkv Wqkv from C192; the MLP chain's dout W2 and du W1): 128 x
// 192, two consumer warpgroups along M, a four-slot ring, one block an SM,
// W K-major or (T) MN-major
using StreamWide = Tile<128, 192, 1, 4, false, 1>;
using StreamWideT = Tile<128, 192, 1, 4, false, 1, false, true>;
using TokensN96 = Tile<128, 96, 1, 4, false, 1, true, true>;
using TokensN192 = Tile<128, 192, 1, 4, false, 1, true, true>;

// An epilogue that takes the accumulators eight columns of a row at a time.
struct RowEpi {
  static constexpr bool kWholeRows = false;
};

// bias[n..n+7] (16-byte aligned) into v
__device__ __forceinline__ void add_bias8(const float* bias, int n, float v[8]) {
  const float4 lo = ld_ro4(bias + n), hi = ld_ro4(bias + n + 4);
  v[0] += lo.x, v[1] += lo.y, v[2] += lo.z, v[3] += lo.w;
  v[4] += hi.x, v[5] += hi.y, v[6] += hi.z, v[7] += hi.w;
}

// out[m, n] = bf16(acc + bias[n]) (bias may be null)
struct Bf16Epi : RowEpi {
  bf16* out;
  const float* bias;
  int N;
  __device__ void put8(int m, int n, float v[8]) const {
    if (bias) add_bias8(bias, n, v);
    store8(out + (size_t)m * N + n, v);
  }
};

// out[m, n] = acc, fp32
struct F32Epi : RowEpi {
  float* out;
  int N;
  __device__ void put8(int m, int n, float v[8]) const {
    float4* p = reinterpret_cast<float4*>(out + (size_t)m * N + n);
    p[0] = make_float4(v[0], v[1], v[2], v[3]);
    p[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

// The fp32 partial of K split z (the grid's z) at out + z * ld: [M, N]
// row-major; a fixed-order reduction (reduce_partials, backward.cuh) adds the
// splits, so the sum is the same bit for bit from run to run.
struct PartialEpi : RowEpi {
  float* out;
  int N;
  size_t ld;
  __device__ void put8(int m, int n, float v[8]) const {
    float4* p = reinterpret_cast<float4*>(out + blockIdx.z * ld + (size_t)m * N + n);
    p[0] = make_float4(v[0], v[1], v[2], v[3]);
    p[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

// Rows of a plain row-major bf16 [M, K] matrix, as a panel's source.  A row
// source's row m is kPieces contiguous pieces of K / kPieces elements
// (`piece(m, q)`).
struct PlainRows {
  static constexpr int kPieces = 1;
  const bf16* a;
  int K;
  __device__ const bf16* piece(int m, int) const { return a + (size_t)m * K; }
  __device__ void pre8(int, int, float*) const {}  // LnPanel's input is the row itself
};

// Rows [m0, m0 + R) of a row source into the swizzled panel by the block's
// `warps` consumer warps, every 16-byte load in flight at once (cp.async);
// rows >= M are left as they are (their outputs are never stored).  A row of
// one piece is cut into 16-byte chunks across all threads; a row of several
// pieces (a gather) is taken by one warp, which finds the pieces' addresses
// once and spreads their chunks over its lanes.
template <class Src>
__device__ __forceinline__ void load_rows(bf16* panel, const Src& src, int R, int m0, int M, int K,
                                          int warps, int warp, int lane) {
  if constexpr (Src::kPieces == 1) {
    const int vecs = K / 8;
    for (int i = warp * 32 + lane; i < R * vecs; i += warps * 32) {
      const int r = i / vecs, k = (i - r * vecs) * 8;
      if (m0 + r < M) cp_async16(swizzled(panel, R, r, k), src.piece(m0 + r, 0) + k, true);
    }
  } else {
    constexpr int P = Src::kPieces;
    const int len = K / P, per = len / 8;  // elements and 16-byte chunks of a piece
    for (int r = warp; r < R && m0 + r < M; r += warps) {
      const bf16* p[P];
#pragma unroll
      for (int q = 0; q < P; ++q) p[q] = src.piece(m0 + r, q);
      for (int i = lane; i < P * per; i += 32) {
        int q = 0;
#pragma unroll
        for (int t = 1; t < P; ++t) q += i >= t * per;
        const bf16* from = p[0];
#pragma unroll
        for (int t = 1; t < P; ++t) from = q == t ? p[t] : from;
        const int c = (i - q * per) * 8;
        cp_async16(swizzled(panel, R, r, q * len + c), from + c, true);
      }
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
}

// Prologue of mode (a): the panel holds rows [m0, m0 + R) of a plain
// row-major bf16 [M, K] matrix.
struct CopyPanel {
  const bf16* a;
  __device__ void fill(bf16* panel, int R, int m0, int M, int K, int warps, int warp,
                       int lane) const {
    load_rows(panel, PlainRows{a, K}, R, m0, M, K, warps, warp, lane);
  }
};

// sum of eight values, and of their squared deviations from `mean`, as
// pairwise trees (short dependency chains; fp32 throughout)
__device__ __forceinline__ float sum8(const float v[8]) {
  return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
}
__device__ __forceinline__ float sq_dev8(const float v[8], float mean) {
  float d[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) d[t] = (v[t] - mean) * (v[t] - mean);
  return sum8(d);
}

// Prologue of mode (a): panel row r = bf16(LayerNorm(pre(source row m0 + r)))
// over K.  The raw rows come in first (load_rows: all loads in flight; a row
// may be a gather of pieces), then each group of LPR lanes takes ROWS
// rows at once in place, their loads and reductions interleaved (LPR = 16
// puts two rows in a warp instruction where a row has at most 16 MAXV
// vectors of 8): the source's `pre8` (the noise affine of swin_attn's qkv,
// nothing for patch_merge's gather), then the model's LayerNorm: fp32
// statistics in two passes, mean then mean of squared deviations (each
// vector of 8 summed as a pairwise tree), and one rounding to bf16.  gamma
// and beta of a lane's columns
// are loaded once.  K <= 8 LPR MAXV.
template <class Src, int MAXV, int ROWS, int LPR>
struct LnPanel {
  Src src;
  const float* gamma;
  const float* beta;

  __device__ void fill(bf16* panel, int R, int m0, int M, int K, int warps, int warp,
                       int lane) const {
    constexpr int kGroups = 32 / LPR;  // rows a warp instruction covers
    load_rows(panel, src, R, m0, M, K, warps, warp, lane);
    consumer_sync(warps * 32);
    const int sub = lane / LPR, ln = lane % LPR;
    float g[MAXV][8], bt[MAXV][8];
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int k = (i * LPR + ln) * 8;
#pragma unroll
      for (int t = 0; t < 8; ++t)
        g[i][t] = k < K ? ld_ro(gamma + k + t) : 0.f, bt[i][t] = k < K ? ld_ro(beta + k + t) : 0.f;
    }
    for (int r0 = warp; r0 < R; r0 += warps * ROWS * kGroups) {
      float v[ROWS][MAXV][8], s[ROWS], q[ROWS];
      int row[ROWS];
      bool live[ROWS];
      // every load first, all independent: an address outside the rows or
      // columns is moved into the panel and its values are not used
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        row[j] = r0 + warps * (j * kGroups + sub);
        live[j] = row[j] < R && m0 + row[j] < M;
#pragma unroll
        for (int i = 0; i < MAXV; ++i) {
          const int k = (i * LPR + ln) * 8;
          load8(swizzled(panel, R, live[j] ? row[j] : 0, k < K ? k : 0), v[j][i]);
        }
      }
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        s[j] = 0.f;
#pragma unroll
        for (int i = 0; i < MAXV; ++i) {
          const int k = (i * LPR + ln) * 8;
          if (k < K && live[j]) {
            src.pre8(m0 + row[j], k, v[j][i]);
            s[j] += sum8(v[j][i]);
          }
        }
      }
      warp_sum_n<LPR>(s);
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        s[j] /= K;
        q[j] = 0.f;
#pragma unroll
        for (int i = 0; i < MAXV; ++i)
          if ((i * LPR + ln) * 8 < K && live[j]) q[j] += sq_dev8(v[j][i], s[j]);
      }
      warp_sum_n<LPR>(q);
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const float rstd = rsqrtf(q[j] / K + kLnEps);
#pragma unroll
        for (int i = 0; i < MAXV; ++i) {
          const int k = (i * LPR + ln) * 8;
          if (k < K && live[j]) {
            float o[8];
#pragma unroll
            for (int t = 0; t < 8; ++t) o[t] = (v[j][i][t] - s[j]) * rstd * g[i][t] + bt[i][t];
            store8(swizzled(panel, R, row[j], k), o);
          }
        }
      }
    }
  }
};

// A prologue that also writes the panel's rows [m0, m0 + R) to `out` (the
// [M, K] bf16 operand a weight gradient reads again), in the blocks of
// column split 0 only: the backward's recompute of hn.
template <class Pro>
struct StoreRows {
  Pro pro;
  bf16* out;
  __device__ void fill(bf16* panel, int R, int m0, int M, int K, int warps, int warp,
                       int lane) const {
    pro.fill(panel, R, m0, M, K, warps, warp, lane);
    if (blockIdx.y != 0) return;
    consumer_sync(warps * 32);  // every row of the panel is written
    const int vecs = K / 8;
    for (int i = warp * 32 + lane; i < R * vecs; i += warps * 32) {
      const int r = i / vecs, k = (i - r * vecs) * 8;
      if (m0 + r < M)
        *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * K + k) =
            *reinterpret_cast<const uint4*>(swizzled(panel, R, r, k));
    }
  }
};

// Mode (b) has no prologue.
struct NoPanel {
  __device__ void fill(bf16*, int, int, int, int, int, int, int) const {}
};

struct Maps {
  CUtensorMap w, a1, a2;  // W [N, K]; A's two sources [M, K1] and [M, K2] (mode b)
};

struct Shape {
  int M, N, K, K1, per;  // per: N tiles a block walks
  int kchunk;            // K elements of a split: block z covers [z kchunk, (z + 1) kchunk)
};

// ------------------------------------------------------------- the kernel

template <class T, class Site, class Pro, class Epi>
__global__ void __launch_bounds__(T::kThreads, T::MINB)
hgemm_kernel(const __grid_constant__ Maps maps, const Pro pro, const Epi epi, const Shape sh) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[T::STAGES], empty[T::STAGES];
  // aligned by an offset on smem_raw (not through an integer), so the
  // compiler keeps the panel and the epilogue tiles in the shared space
  unsigned char* base = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  bf16* panel = reinterpret_cast<bf16*>(base);
  unsigned char* ring = base + T::panel_bytes(sh.K);
  float* epi_tile = reinterpret_cast<float*>(ring + T::ring_bytes());

  const int m0 = blockIdx.x * T::BM;
  const int n_tiles = (sh.N + T::BN - 1) / T::BN;
  const int t_begin = blockIdx.y * sh.per;
  const int t_end = t_begin + sh.per < n_tiles ? t_begin + sh.per : n_tiles;
  const int kbeg = blockIdx.z * sh.kchunk;
  const int kend = kbeg + sh.kchunk < sh.K ? kbeg + sh.kchunk : sh.K;
  const int kslices = (kend - kbeg + kSlice - 1) / kSlice;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T::kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == T::kConsumers / 32) {  // the producer warp
    if (lane == 0) {
      int it = 0;
      for (int t = t_begin; t < t_end; ++t)
        for (int ks = 0; ks < kslices; ++ks, ++it) {
          const int s = it % T::STAGES;
          mbar_wait(&empty[s], ((it / T::STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], T::kStageBytes);
          unsigned char* slot = ring + s * T::kStageBytes;
          const int k = kbeg + ks * kSlice;
          if constexpr (T::kAMn) {
#pragma unroll
            for (int b = 0; b < T::BM / kSlice; ++b)
              tma_load(&maps.a1, slot + b * kSlice * kSlice * 2, &full[s], m0 + b * kSlice, k);
          } else if constexpr (!T::kPanel) {
            if (k < sh.K1) tma_load(&maps.a1, slot, &full[s], k, m0);
            else tma_load(&maps.a2, slot, &full[s], k - sh.K1, m0);
          }
          bf16* ws = reinterpret_cast<bf16*>(slot) + T::kAStage;
          if constexpr (T::kBMn) {
#pragma unroll
            for (int b = 0; b < T::kWBoxes; ++b)
              tma_load(&maps.w, ws + b * kSlice * kSlice, &full[s], t * T::BN + b * kSlice, k);
          } else {
#pragma unroll
            for (int i = 0; i < T::WGN; ++i)
              tma_load(&maps.w, ws + i * T::NW * kSlice, &full[s], k, t * T::BN + i * T::NW);
          }
        }
    }
    return;
  }

  if constexpr (T::kPanel) {
    pro.fill(panel, T::BM, m0, sh.M, sh.K, T::kConsumers / 32, warp, lane);
    fence_proxy_async();
  }
  consumer_sync(T::kConsumers);  // the panel is complete; the consumers run converged from here
  const int wg = warp >> 2;
  const int row0 = T::WGN == 1 ? wg * 64 : 0, col0 = T::WGN == 2 ? wg * T::NW : 0;
  float acc[T::NW / 2];
  int it = 0;
  for (int t = t_begin; t < t_end; ++t) {
#pragma unroll
    for (int i = 0; i < T::NW / 2; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int ks = 0; ks < kslices; ++ks, ++it) {
      const int s = it % T::STAGES;
      mbar_wait(&full[s], (it / T::STAGES) & 1);
      const bf16* slot = reinterpret_cast<const bf16*>(ring + s * T::kStageBytes);
      const bf16* a = T::kPanel ? panel + ks * T::BM * kSlice + row0 * kSlice : slot + row0 * kSlice;
      // K-major operands step 32 bytes a k16, MN-major ones 16 rows of 128
      constexpr int kStepA = T::kAMn ? 128 : 2, kStepB = T::kBMn ? 128 : 2;
      const uint64_t da = T::kAMn ? mn128_desc(a, kSlice * kSlice * 2) : sw128_desc(a);
      const uint64_t db = T::kBMn ? mn128_desc(slot + T::kAStage + col0 * kSlice, kSlice * kSlice * 2)
                                  : sw128_desc(slot + T::kAStage + col0 * kSlice);
      // an MN-major A's K rows past the tensor read as zeros, and a split's
      // chunk is whole 64-row slices: every step of the slice runs
      const int steps = T::kAMn ? kSlice / 16 : min(kSlice, kend - kbeg - ks * kSlice) / 16;
      fence_regs(acc);
      wgmma_fence();
      for (int j = 0; j < steps; ++j)
        Wgmma<T::NW, T::kAMn, T::kBMn>::mma(acc, da + kStepA * j, db + kStepB * j);
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's group is done: free its slot
      fence_regs(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);

    // accumulator element (row, col): rows 16 (warp % 4) + lane / 4 + 8 i,
    // cols 8 j + 2 (lane % 4) + {0, 1} -> acc[4 j + 2 i + {0, 1}]
    if constexpr (Epi::kWholeRows) {
      constexpr int ld = T::BN + 4;
      static_assert(T::BM * ld * 4 <= T::STAGES * T::kStageBytes, "staging tile");
      float* stage = reinterpret_cast<float*>(ring);
      consumer_sync(T::kConsumers);  // every warpgroup is done reading the ring
      const int wr = row0 + (warp & 3) * 16 + (lane >> 2), wc = col0 + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < T::NW / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(stage + (wr + 8 * i) * ld + wc + 8 * j) =
              make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      consumer_sync(T::kConsumers);
      epi.rows(stage, ld, m0, min(T::BM, sh.M - m0), warp, lane);
      consumer_sync(T::kConsumers);
    } else {
      // per 32 columns: the warp's 16 x 32 accumulators into its tile, then
      // each lane takes two (row, 8 columns) pieces of it
      float* et = epi_tile + warp * 16 * T::kEpiLd;
      const int mr = m0 + row0 + (warp & 3) * 16, nc = t * T::BN + col0;
#pragma unroll
      for (int c0 = 0; c0 < T::NW; c0 += 32) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int j = c0 / 8 + jj;
            *reinterpret_cast<float2*>(et + ((lane >> 2) + 8 * i) * T::kEpiLd + 8 * jj +
                                       2 * (lane & 3)) =
                make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
          }
        __syncwarp();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (lane >> 2) + 8 * h, ch = lane & 3;
          const int m = mr + r, n = nc + c0 + 8 * ch;
          if (m < sh.M && n < sh.N) {
            const float4 lo = *reinterpret_cast<const float4*>(et + r * T::kEpiLd + 8 * ch);
            const float4 hi = *reinterpret_cast<const float4*>(et + r * T::kEpiLd + 8 * ch + 4);
            float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
            epi.put8(m, n, v);
          }
        }
        __syncwarp();
      }
    }
  }
}

// ------------------------------------------------------------------- host

// cuTensorMapEncodeTiled through the runtime (no -lcuda); null if missing
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// a row-major bf16 [rows, inner] matrix, read in boxes {64, box_rows} with
// the 128-byte swizzle (out-of-range elements read as zero)
inline bool make_map(CUtensorMap* map, const void* p, int inner, int rows, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (!encode || reinterpret_cast<uintptr_t>(p) % 16) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kSlice, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the kernel of one site, its shared memory allowed up to kMaxDynSmem once
// on each device
template <class T, class Site, class Pro, class Epi>
cudaError_t kernel_ready() {
  static PerDevice ready;
  return ready.once([](int&) {
    return cudaFuncSetAttribute(hgemm_kernel<T, Site, Pro, Epi>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
  });
}

// The tile of a site for the wrapper's plan: {BM, BN, blocks an SM holds at
// this K (the card's occupancy), whole rows}; 0 or a CUDA error.
template <class T, class Site, class Pro, class Epi>
int tile_query(int K, int* geom) {
  if (T::smem_bytes(K) > (size_t)kMaxDynSmem) return -1;
  cudaError_t err = kernel_ready<T, Site, Pro, Epi>();
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hgemm_kernel<T, Site, Pro, Epi>,
                                                        T::kThreads, T::smem_bytes(K));
  if (err != cudaSuccess) return err;
  geom[0] = T::BM, geom[1] = T::BN, geom[2] = per_sm, geom[3] = Epi::kWholeRows;
  return 0;
}

// C = epi(A W^T): A = [a1 | a2] ([M, K1] and [M, K2]; mode (a) reads A
// through `pro` instead and takes K = K1), W [N, K] (or [K, N] where
// T::kBMn); each block walks `per` N tiles of its rows.  Where T::kAMn, A
// is a1 stored [K, M] (K = K1 tokens), and K is cut into `splits` chunks of
// `kchunk` (a multiple of 64), one per grid z, each its own partial.
template <class T, class Site, class Pro, class Epi>
cudaError_t launch(const GemmA& A, const Pro& pro, const Epi& epi, const bf16* W, int M, int N,
                   int per, cudaStream_t stream, int splits = 1, int kchunk = 0) {
  const int K = A.K1 + A.K2;
  const int n_tiles = (N + T::BN - 1) / T::BN;
  if (splits == 1 && kchunk == 0) kchunk = K;
  if (M <= 0 || N <= 0 || N % 8 || K <= 0 || per <= 0 || splits <= 0 || splits > 65535 ||
      T::smem_bytes(K) > (size_t)kMaxDynSmem || (Epi::kWholeRows && n_tiles != 1) ||
      (!T::kPanel && A.K2 > 0 && A.K1 % kSlice) || (long long)kchunk * splits < K ||
      (long long)kchunk * (splits - 1) >= K || (splits > 1 && kchunk % kSlice))
    return cudaErrorInvalidValue;
  if (T::kAMn ? (M % 8 || A.K2 > 0) : K % 16) return cudaErrorInvalidValue;
  Maps maps;
  if (!(T::kBMn ? make_map(&maps.w, W, N, K, kSlice) : make_map(&maps.w, W, K, N, T::NW)))
    return cudaErrorInvalidValue;
  if constexpr (T::kAMn) {
    if (!make_map(&maps.a1, A.a1, M, K, kSlice)) return cudaErrorInvalidValue;
    maps.a2 = maps.a1;
  } else if constexpr (!T::kPanel) {
    if (!make_map(&maps.a1, A.a1, A.K1, M, T::BM)) return cudaErrorInvalidValue;
    maps.a2 = maps.a1;
    if (A.K2 > 0 && !make_map(&maps.a2, A.a2, A.K2, M, T::BM)) return cudaErrorInvalidValue;
  }
  cudaError_t err = kernel_ready<T, Site, Pro, Epi>();
  if (err != cudaSuccess) return err;
  const dim3 grid((M + T::BM - 1) / T::BM, (n_tiles + per - 1) / per, splits);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  hgemm_kernel<T, Site, Pro, Epi><<<grid, T::kThreads, T::smem_bytes(K), stream>>>(
      maps, pro, epi, Shape{M, N, K, A.K1, per, kchunk});
  return cudaGetLastError();
}

}  // namespace hg
}  // namespace dsg
