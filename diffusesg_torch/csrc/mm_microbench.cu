// mm_accumulate: the int8-versus-bf16 matrix-product micro-benchmark on Hopper.
//
// Replaces scripts/microbench_int8.py::mm_kernel: out = repeats * (A[m, k]
// B[k, n]), the sum of `repeats` identical products, fp32 from bf16 operands
// and int32 (exact) from int8 ones.  The TPU grid of 16 programs computes the
// whole output 16 times; here it is computed `copies` times (the wrapper's
// count: the 64 x 64 plan of ops/mm_microbench.py::grid_plan), every copy
// running all of its products and storing the same bits.
//
// Bound on the H100: operations, at each of the four shapes of the
// micro-benchmark ((512, 768, 768), (1024, 96, 96), (1024, 96, 288),
// (2048, 128, 128)) and for both types.  2 m k n repeats copies operations
// against m k + k n (operand bytes, once) + 4 m n (the output, once) bytes
// is thousands of operations a byte, far above the card's ridge (~295 for
// bf16, ~590 for int8), so the time is the tensor cores' at 989 TFLOP/s
// (bf16) or 1,979 TOP/s (int8).  Measured on an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.py phase 2): bf16 at 80-92 % of that bound, int8 at
// 68-94 %, int8 1.7-2.0x as fast as bf16; the WMMA kernel this replaced
// reached 16-21 % (bf16) and 6-8 % (int8).  What the design does about it:
//   * wgmma with both operands from shared memory, two consumer warpgroups a
//     block (128 rows, 64 each): bf16 m64nBNk16 into fp32, int8 m64nBNk32
//     into s32, so an int8 instruction does twice the work of a bf16 one in
//     the same time (the WMMA kernel this replaced was k16 for both).
//   * Operands loaded into shared memory once per work item, not once per
//     product.  The sum is taken slice by slice along K (the order is the
//     design's choice: int8 is exact, bf16 sums in fp32): a 128-byte K slice
//     of the block's A rows and B columns lands once and stays resident while
//     all `repeats` products of that slice run on it, then its slot is
//     refilled.  So the whole of an item's A and B is read once, however
//     large K is, and no panel has to fit whole: bf16 at K = 768 (A 192 KB +
//     B 384 KB for a 128 x 256 tile) needs no option of its own.  At K = 96
//     and 128 an item is one or two slices, held for all its products.
//   * A producer warpgroup fills a four-slot ring guarded by mbarriers
//     (`full`, `empty`) from the next work items while the consumers
//     compute; blocks are persistent (one an SM; the grid is min(items,
//     SMs x blocks an SM)) and walk items (tile, copy) x, x + grid, ...
//   * A arrives by TMA in the 128-byte swizzle (K-major for both types).  B
//     arrives [k, n] row-major, which is MN-major: bf16 reads it so through
//     wgmma's transpose mode (TMA boxes of 64 n x 64 k, as hopper_gemm.cuh's
//     Tile::kBMn); s8 has no transpose mode, so the producer's threads
//     transpose each B slice into the swizzled K-major layout (4 x 4 byte
//     transposes with __byte_perm), once per slice of an item.
//   * Tiles divide N (BN the widest of 256, 128, 96, 64, 32 and 16 that
//     divides it), so no column is computed on padding.  K = 96 is 1.5 bf16 slices and 0.75 of
//     an int8 one: TMA fills the missing K with zeros in shared memory, and
//     no product runs on them (the last slice issues only the k16 / k32
//     steps that K covers: the kernel's TAIL).
#include <algorithm>
#include <climits>
#include <initializer_list>
#include <type_traits>

#include "hopper_gemm.cuh"

namespace dsg {
namespace mm {

// D (64 x N, s32, the accumulator layout) += A (64 x 32) B (32 x N), s8,
// both K-major in shared memory
template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<16> {
  __device__ static void mma(int (&d)[8], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, "
        "%8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaS8<32> {
  __device__ static void mma(int (&d)[16], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, "
        "%16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaS8<64> {
  __device__ static void mma(int (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, "
        "%32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaS8<96> {
  __device__ static void mma(int (&d)[48], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, "
        "%48, %49, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaS8<128> {
  __device__ static void mma(int (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaS8<256> {
  __device__ static void mma(int (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
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
        "%128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
  hg::fence_regs(d);
}
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t ld_ro_u32(const void* p) {
  uint32_t v;
  asm("ld.global.nc.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// The tile of one element type: 128 rows (two consumer warpgroups of 64),
// BN columns, a four-slot ring of 128-byte K slices of A and B; TAIL: the
// wgmma steps of a last, partial slice (K % kSliceK / kStepK; 0: none).
// Every slice's steps are a compile-time count: with a run-time count of
// steps inside the loop over the products, ptxas serializes the wgmmas
// (C7520, a wait after each).
template <class T, int BN_, int TAIL_>
struct Cfg {
  static constexpr bool kInt8 = sizeof(T) == 1;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  static constexpr int BM = 128, BN = BN_, STAGES = 4, TAIL = TAIL_;
  static constexpr int kSliceK = 128 / sizeof(T);  // K elements of a 128-byte slice
  static constexpr int kStepK = 32 / sizeof(T);    // K of one wgmma
  static constexpr int kSteps = kSliceK / kStepK;  // wgmmas a whole slice (4)
  static constexpr int kABytes = BM * 128;         // A: 128 rows of one slice
  // B: bf16 as TMA writes it, 64-column MN-major boxes of 64 K rows; int8
  // transposed, BN rows of one K-major slice
  static constexpr int kBBytes = kInt8 ? BN * 128 : (BN + 63) / 64 * 64 * 128;
  static constexpr int kSlotBytes = kABytes + kBBytes;
  static constexpr int kProducers = 128, kThreads = 256 + kProducers;
  static constexpr int kAcc = BN / 2;  // accumulators a thread
  static_assert(BN % 16 == 0 && BN <= 256 && kSlotBytes % 1024 == 0 && TAIL < kSteps, "tile");
  static constexpr size_t smem_bytes() { return 1024 + (size_t)STAGES * kSlotBytes; }
};

struct Maps {
  CUtensorMap a, b;  // A [M, K]; B [K, N] (bf16 only: int8's B is read by threads)
};

template <class C>
__device__ __forceinline__ void mma(typename C::Acc (&acc)[C::kAcc], uint64_t da, uint64_t db) {
  if constexpr (C::kInt8) WgmmaS8<C::BN>::mma(acc, da, db);
  else hg::Wgmma<C::BN, 0, 1>::mma(acc, da, db);
}

// One slice of the ring for all `repeats` products: S wgmmas a product,
// every descriptor fixed across the products.  Waits for the slot, and frees
// the slot of the slice before (`prev`) once its products are done.
template <class C, int S>
__device__ __forceinline__ void consume_slice(typename C::Acc (&acc)[C::kAcc],
                                              const unsigned char* ring, uint64_t* full,
                                              uint64_t* empty, int& it, int& prev, int row0,
                                              int lane, int repeats) {
  // K-major operands step 32 bytes a wgmma; bf16's MN-major B 16 K rows of 128
  constexpr int kStepB = C::kInt8 ? 2 : 128;
  const int s = it % C::STAGES;
  hg::mbar_wait(&full[s], (it / C::STAGES) & 1);
  const unsigned char* slot = ring + s * C::kSlotBytes;
  const uint64_t da = hg::sw128_desc(slot + row0 * 128);
  const uint64_t db = C::kInt8 ? hg::sw128_desc(slot + C::kABytes)
                               : hg::mn128_desc(slot + C::kABytes, 8192);
  fence_acc(acc);
  hg::wgmma_fence();
#pragma unroll 1
  for (int r = 0; r < repeats; ++r) {
#pragma unroll
    for (int j = 0; j < S; ++j) mma<C>(acc, da + 2 * j, db + kStepB * j);
  }
  hg::wgmma_commit();
  hg::wgmma_wait<1>();  // the previous slice's products are done: free its slot
  fence_acc(acc);
  if (prev >= 0 && lane == 0) hg::mbar_arrive(&empty[prev]);
  prev = s;
  ++it;
}

// Rows [k0, k0 + 128) of int8 B [K, N], columns [n0, n0 + BN), into the
// slot's K-major swizzled B: column n is a 128-byte row, 16-byte chunk c (k
// 16c .. 16c + 15) at chunk c ^ (n % 8).  A task is 16 k rows x 4 columns:
// sixteen 4-byte loads along a row (neighbouring threads on neighbouring
// columns), four 4 x 4 byte transposes, four 16-byte stores.
template <int BN>
__device__ __forceinline__ void transpose_b(unsigned char* bs, const int8_t* B, int N, int K,
                                            int k0, int n0, int tid) {
  constexpr int kCols = BN / 4;
  const int groups = min(8, (K - k0) / 16);  // 16-row groups K covers (K % 32 == 0)
  for (int i = tid; i < kCols * groups; i += 128) {
    const int ng = i % kCols, kg = i / kCols;
    const int8_t* src = B + (size_t)(k0 + 16 * kg) * N + n0 + 4 * ng;
    uint32_t w[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) w[r] = ld_ro_u32(src + (size_t)r * N);
    uint32_t t[4][4];  // t[q][c]: column c, k rows 4q .. 4q + 3
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t x0 = __byte_perm(w[4 * q], w[4 * q + 1], 0x5140);
      const uint32_t x1 = __byte_perm(w[4 * q], w[4 * q + 1], 0x7362);
      const uint32_t y0 = __byte_perm(w[4 * q + 2], w[4 * q + 3], 0x5140);
      const uint32_t y1 = __byte_perm(w[4 * q + 2], w[4 * q + 3], 0x7362);
      t[q][0] = __byte_perm(x0, y0, 0x5410), t[q][1] = __byte_perm(x0, y0, 0x7632);
      t[q][2] = __byte_perm(x1, y1, 0x5410), t[q][3] = __byte_perm(x1, y1, 0x7632);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = 4 * ng + c;
      *reinterpret_cast<uint4*>(bs + n * 128 + ((kg ^ (n & 7)) << 4)) =
          make_uint4(t[0][c], t[1][c], t[2][c], t[3][c]);
    }
  }
}

// Work item x (x = blockIdx.x, x + gridDim.x, ...) is output tile x % tiles
// of copy x / tiles; tile t covers rows [(t / tiles_n) BM, + BM) and columns
// [(t % tiles_n) BN, + BN).  Warpgroups 0 and 1 consume (rows 0-63, 64-127
// of the tile), warpgroup 2 produces.
template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
mm_accumulate_wgmma(const __grid_constant__ Maps maps, const int8_t* __restrict__ b8,
                    typename C::Acc* __restrict__ out, int M, int N, int K, int tiles_n,
                    int tiles, int items, int repeats) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[C::STAGES], empty[C::STAGES];
  unsigned char* ring = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const int whole = K / C::kSliceK, slices = whole + (C::TAIL > 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      // int8: the TMA thread's expect_tx and every producer's transpose
      hg::mbar_init(&full[s], C::kInt8 ? 1 + C::kProducers : 1);
      hg::mbar_init(&empty[s], 8);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup
    const int tid = threadIdx.x - 256;
    if (!C::kInt8 && tid != 0) return;
    int it = 0;
    for (int x = blockIdx.x; x < items; x += gridDim.x) {
      const int t = x % tiles, m0 = t / tiles_n * C::BM, n0 = t % tiles_n * C::BN;
      for (int ks = 0; ks < slices; ++ks, ++it) {
        const int s = it % C::STAGES, k0 = ks * C::kSliceK;
        hg::mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
        unsigned char* slot = ring + s * C::kSlotBytes;
        if (tid == 0) {
          hg::mbar_expect_tx(&full[s], C::kInt8 ? C::kABytes : C::kSlotBytes);
          hg::tma_load(&maps.a, slot, &full[s], k0, m0);
          if constexpr (!C::kInt8) {
#pragma unroll
            for (int bx = 0; bx < C::kBBytes / 8192; ++bx)
              hg::tma_load(&maps.b, slot + C::kABytes + bx * 8192, &full[s], n0 + 64 * bx, k0);
          }
        }
        if constexpr (C::kInt8) {
          transpose_b<C::BN>(slot + C::kABytes, b8, N, K, k0, n0, tid);
          hg::fence_proxy_async();  // the generic-proxy stores, visible to wgmma
          hg::mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  const int row0 = (warp >> 2) * 64;
  typename C::Acc acc[C::kAcc];
  int it = 0;
  for (int x = blockIdx.x; x < items; x += gridDim.x) {
    const int t = x % tiles, m0 = t / tiles_n * C::BM, n0 = t % tiles_n * C::BN;
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i) acc[i] = 0;
    int prev = -1;
    for (int ks = 0; ks < whole; ++ks)
      consume_slice<C, C::kSteps>(acc, ring, full, empty, it, prev, row0, lane, repeats);
    if constexpr (C::TAIL > 0)
      consume_slice<C, C::TAIL>(acc, ring, full, empty, it, prev, row0, lane, repeats);
    hg::wgmma_wait<0>();
    fence_acc(acc);
    if (prev >= 0 && lane == 0) hg::mbar_arrive(&empty[prev]);

    // accumulator element (row, col): rows 16 (warp % 4) + lane / 4 + 8 i,
    // cols 8 j + 2 (lane % 4) + {0, 1} -> acc[4 j + 2 i + {0, 1}]
    const int r = m0 + row0 + (warp & 3) * 16 + (lane >> 2), c = n0 + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (r + 8 * i >= M) continue;
      typename C::Acc* o = out + (size_t)(r + 8 * i) * N + c;
#pragma unroll
      for (int j = 0; j < C::BN / 8; ++j) {
        if constexpr (C::kInt8)
          *reinterpret_cast<int2*>(o + 8 * j) = make_int2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        else
          *reinterpret_cast<float2*>(o + 8 * j) =
              make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------- host

// the widest tile that divides N, 0 if none
inline int tile_n(int N) {
  for (int bn : {256, 128, 96, 64, 32, 16})
    if (N % bn == 0) return bn;
  return 0;
}

// a row-major int8 [rows, inner] matrix, read in boxes {128, box_rows} with
// the 128-byte swizzle (out-of-range elements read as zero)
inline bool make_map_s8(CUtensorMap* map, const void* p, int inner, int rows, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = hg::encode_tiled();
  if (!encode || reinterpret_cast<uintptr_t>(p) % 16) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)inner};
  const cuuint32_t box[2] = {128, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// the kernel of one tile, its shared memory allowed once on each device, and
// the blocks an SM of that device holds
template <class C>
cudaError_t occupancy(int* per_sm) {
  static PerDevice ready;
  return ready.once([](int& n) {
    cudaError_t e = cudaFuncSetAttribute(mm_accumulate_wgmma<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::smem_bytes());
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, mm_accumulate_wgmma<C>, C::kThreads,
                                                        C::smem_bytes());
    return e;
  }, per_sm);
}

template <class C>
int tile_query(int* geom) {
  int per_sm = 0;
  const cudaError_t err = occupancy<C>(&per_sm);
  if (err != cudaSuccess) return err;
  geom[0] = C::BM, geom[1] = C::BN, geom[2] = per_sm, geom[3] = (int)C::smem_bytes();
  return 0;
}

template <class C>
cudaError_t launch(const void* a, const void* b, void* out, int M, int N, int K, int copies,
                   int repeats, cudaStream_t stream) {
  Maps maps{};
  const bool mapped = C::kInt8 ? make_map_s8(&maps.a, a, K, M, C::BM)
                               : hg::make_map(&maps.a, a, K, M, C::BM) &&
                                     hg::make_map(&maps.b, b, N, K, hg::kSlice);
  if (!mapped || reinterpret_cast<uintptr_t>(b) % 16) return cudaErrorInvalidValue;
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = occupancy<C>(&per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  const int tiles_n = N / C::BN, tiles = (M + C::BM - 1) / C::BM * tiles_n;
  const long long items = (long long)tiles * copies;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  const int grid = (int)std::min<long long>(items, (long long)sms * per_sm);
  mm_accumulate_wgmma<C><<<grid, C::kThreads, C::smem_bytes(), stream>>>(
      maps, static_cast<const int8_t*>(b), static_cast<typename C::Acc*>(out), M, N, K, tiles_n,
      tiles, (int)items, repeats);
  return cudaGetLastError();
}

// f.template operator()<Cfg<T, BN, TAIL>>() at the tile of N and the tail of K
template <class T, int BN, class F>
int with_tail(int K, const F& f) {
  switch (K % (128 / sizeof(T)) / (32 / sizeof(T))) {
    case 0: return f.template operator()<Cfg<T, BN, 0>>();
    case 1: if constexpr (sizeof(T) == 1) return f.template operator()<Cfg<T, BN, 1>>(); break;
    case 2: return f.template operator()<Cfg<T, BN, 2>>();
    case 3: if constexpr (sizeof(T) == 1) return f.template operator()<Cfg<T, BN, 3>>(); break;
  }
  return -1;
}
template <class T, class F>
int with_tile(int N, int K, const F& f) {
  switch (tile_n(N)) {
    case 256: return with_tail<T, 256>(K, f);
    case 128: return with_tail<T, 128>(K, f);
    case 96: return with_tail<T, 96>(K, f);
    case 64: return with_tail<T, 64>(K, f);
    case 32: return with_tail<T, 32>(K, f);
    case 16: return with_tail<T, 16>(K, f);
  }
  return -1;
}

struct Run {
  const void *a, *b;
  void* out;
  int M, N, K, copies, repeats;
  cudaStream_t stream;
  template <class C>
  int operator()() const {
    return launch<C>(a, b, out, M, N, K, copies, repeats, stream);
  }
};

struct Query {
  int* geom;
  template <class C>
  int operator()() const {
    return tile_query<C>(geom);
  }
};

}  // namespace mm
}  // namespace dsg

// a [M, K], b [K, N] row-major; out [M, N] fp32 (is_int8 = 0, bf16 operands)
// or int32 (is_int8 = 1, int8 operands); K a multiple of 32 and N of a tile
// (a multiple of 16).
extern "C" int dsg_mm_accumulate(const void* a, const void* b, void* out, int M, int N, int K,
                                 int copies, int repeats, int is_int8, void* stream) {
  using namespace dsg::mm;
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 || copies < 1 || repeats < 1 || !tile_n(N))
    return cudaErrorInvalidValue;
  const Run run{a, b, out, M, N, K, copies, repeats, static_cast<cudaStream_t>(stream)};
  return is_int8 ? with_tile<int8_t>(N, K, run) : with_tile<dsg::bf16>(N, K, run);
}

// The tile of the wrapper's plan at N (and K, a multiple of 32): geom =
// {rows, columns, blocks an SM holds (the card's occupancy), dynamic shared
// memory bytes a block}; -1 where no tile divides N, else 0 or a CUDA error.
extern "C" int dsg_mm_accumulate_tile(int N, int K, int is_int8, int* geom) {
  using namespace dsg::mm;
  if (N <= 0 || K <= 0 || K % 32 || !tile_n(N)) return -1;
  const Query query{geom};
  return is_int8 ? with_tile<int8_t>(N, K, query) : with_tile<dsg::bf16>(N, K, query);
}
