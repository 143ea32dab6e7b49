// The Hopper trailing GEMM of kernels 6 and 13, and kernel 12's update pass
// (bf16 C, K = r <= 128): C = TC(fp32(C) - A @ B) in
// place, A (M x K) and B (K x N) row-major bf16, the products summed in fp32
// and rounded once on the store (the TPU epilogue
// `(a.astype(f32) - acc).astype(out.dtype)`); TC is fp32 (MPF_BF16) or bf16
// (ALL_BF16).  No row mask.
//
// What bounds it on the H100: at the factorization's trailing shapes (K =
// 1024, M = N up to 64512) the bf16 products are tensor-core bound (2 M N K
// flops at 989 TFLOP/s) and the read-modify-write of C is bytes bound (8 or
// 4 bytes an entry at 3.35 TB/s).  Over a whole factorization C's bytes
// take about half the products' time, so they cost nothing only where they
// move while the tensor cores work: a tile's C read and written between
// two tiles' products stalls the tensor cores for it (64 + 64 KB a bf16
// tile, ~5 us at an SM's share of the bandwidth against a ~11 us main
// loop), and every SM reaches that point at about the same time.
//
// Design (one routine, run by kernel 6's launch, which kernel 12's update
// pass shares, and inside kernel 13's cooperative launch):
// - TMA tile loads: 2-D tensor maps with 128-byte swizzle, encoded on the
//   host with the logical sizes as dims, so TMA zero-fills the ragged edges
//   of M, N and K and never reads a column past K of an A that is a view.
// - A ring of kSt stages in dynamic shared memory (128 x 64 of A and
//   64 x 256 of B a stage), one `full` and one `empty` mbarrier a stage.
// - Warp specialisation: warpgroup 0 is the producer (one thread issues
//   the A/B loads; the warpgroup gives registers up with setmaxnreg.dec);
//   warpgroups 1 and 2 are consumers, each running wgmma.mma_async
//   m64n256k16 (bf16 in, fp32 accumulators) on 64 rows of the 128 x 256
//   tile, A K-major and B N-major (wgmma's transpose bit) from
//   shared-memory descriptors.
// - Persistent tiles: one block per SM walks the tiles in a grouped raster
//   order (kGroupM tile rows at a time, so neighbouring blocks share their
//   B panels in L2); the producer runs into the next tile while the
//   consumers run the epilogue.
// - Two epilogue placements, chosen at compile time (run's kCH):
//   * C through shared memory (kCH > 0 half-tile slots; bf16 C at a
//     16-byte base with a row stride and a width that are multiples of 16
//     bytes, which TMA reads and writes in place): a C thread of the
//     producer warpgroup loads each consumer warpgroup's 64 x 256 half of
//     the tile by TMA (boxes of 64 x 64, 128-byte swizzle) into a slot,
//     stores it back by TMA once that warpgroup has subtracted there
//     (ldmatrix / stmatrix on the swizzled rows, conflict-free; __fsub_rn,
//     one rounding), and loads the half that takes the slot next as soon
//     as the store has read it.  So C's loads and stores run beside the
//     products, and the tensor cores wait for the subtract and for what
//     of C's traffic the slots cannot hide.  The ring layout is per
//     instance: kernel 6 (K = 1024) four A/B stages and one 32 KB slot that
//     the two consumer warpgroups' halves take in turn (the first half
//     lands during the main loop, the second while the first warpgroup
//     runs ahead into the next tile): the ring's depth sets the pace at K =
//     1024, and three stages with a 64 KB slot, measured beside it, were
//     slower (PERF.md section 6 row 6; two stages with two slots starved);
//     kernel 12's update pass (K = r <= 128, bound by C's bytes) two stages
//     and two 64 KB slots, one tile's C streaming in while another's
//     streams out.
//   * C in registers (kCH = 0; fp32 C, other bf16 C, kernel 13): the lanes
//     of each quad trade accumulators with shuffles (one step for fp32 C,
//     two for bf16 C) so that each lane holds adjacent entries of one row,
//     then subtract with __fsub_rn and store with 16-byte accesses where
//     the address allows (single entries otherwise, so any ldc and any base
//     alignment work): each warp instruction moves 16 rows of 32 bytes, and
//     a batch's loads are issued together.  Four A/B stages.
// - No split-K: one block sums every output entry over all of K in one
//   fixed order (ascending 64-deep steps, each four k16 products), and both
//   placements subtract the same fp32 sum with one rounding, so the two
//   are bitwise equal, kernel 13 is bitwise kernel 6, and a taller or
//   shifted C gives the same entries.
//
// The store instance (kStore; kernel 17, u12.cu): C = bf16(A @ B) with A
// lower triangular, C written and never read.  The same ring, warpgroups
// and sum order; three differences.  Tile row i stops its K loop at
// min(K, 128 (i + 1)): the entries of A right of its diagonal tile are
// zeros and are not read.  The walk (walk_tile, tri_origin) takes the
// tiles in windows of 2 x grid, each a run of whole tile columns ordered
// deepest tile row first, and block b takes tiles b and 2 grid - 1 - b of
// each window, so the depths of every block's two tiles sum to about the
// same and the window's B columns stay in L2 while its tile rows read them.
// The epilogue is the shared-memory placement without the load: each
// warpgroup rounds its fp32 sums once to bf16 into the slot (the C thread
// frees the slot where it would load C), and TMA stores it.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (libcuda is reached through the runtime)
#include <string.h>

#include "common.cuh"

namespace gemm {
namespace sm90 {

constexpr int kBM = 128, kBN = 256, kBK = 64;
constexpr int kConsumers = 2;                        // warpgroups, 64 tile rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kGroupM = 8;                           // tile rows of one raster group
constexpr int kBatch = 8;                            // epilogue: 16-byte loads a batch
constexpr uint32_t kABytes = kBM * kBK * 2;          // 16 KB of A a stage
constexpr uint32_t kBoxBytes = kBK * 64 * 2;         // one 64-column box of B: 8 KB
constexpr uint32_t kBBytes = (kBN / 64) * kBoxBytes; // 32 KB of B a stage
constexpr uint32_t kCBox = 64 * 64 * 2;              // one 64 x 64 bf16 box of C: 8 KB
constexpr uint32_t kCHalf = (kBN / 64) * kCBox;      // a consumer's 64 x 256 half: 32 KB
// C barriers of a layout with `halves` half-tile slots: one full and one
// ready barrier a slot, and at least one of each a consumer warpgroup
__host__ __device__ constexpr int c_bars(int halves) {
  return halves < kConsumers ? kConsumers : halves;
}
// dynamic shared memory of a ring of `stages` A/B stages and `halves` C
// half-tile slots: 1024 bytes of alignment slack (the swizzle atom), the
// ring, the slots, the A/B full and empty barriers, the C full and ready
// barriers
__host__ __device__ constexpr int smem_bytes(int stages, int halves) {
  return 1024 + stages * (int)(kABytes + kBBytes) + halves * (int)kCHalf +
         (2 * stages + (halves > 0 ? 2 * c_bars(halves) : 0)) * 8;
}
// C in registers: four stages
constexpr int kStages = 4;
constexpr int kSmem = smem_bytes(kStages, 0);
// kernel 6's bf16-C instance, C through shared memory: four stages and one
// 32 KB slot that the two consumer warpgroups' halves take in turn
constexpr int kStages6 = 4, kHalves6 = 1;
// kernel 12's update pass: two stages (K = 128 is two steps) and two 64 KB
// slots
constexpr int kStages12 = 2, kHalves12 = 4;
static_assert(smem_bytes(kStages6, kHalves6) <= 232448 &&
                  smem_bytes(kStages12, kHalves12) <= 232448,
              "each C-through-shared-memory layout must fit in one SM");
// registers a thread: the producer's, the consumers', and the count both
// return to where the threads meet again after the tiles (kernel 13)
constexpr int kProducerRegs = 40, kConsumerRegs = 232, kRejoinRegs = 160;

// ---- device pieces ----------------------------------------------------------

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

// one 2-D TMA load of a box at (c0 = column, c1 = row), counted off `bar`
__device__ __forceinline__ void load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(tma::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(tma::smem_addr(bar))
      : "memory");
}

// one 2-D TMA store of a box from shared memory at (c0 = column, c1 = row);
// the tensor map's logical sizes clip it
__device__ __forceinline__ void store_2d(const CUtensorMap* map, int c0, int c1, const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(tma::smem_addr(src))
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// the committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// the committed stores are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(tma::smem_addr(bar)) : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; lbo / sbo in bytes
__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator accesses across a fence or wait
__device__ __forceinline__ void fence_operands(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, fp32) += A (64 x 16, K-major) @ B (16 x 256, N-major)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// fp32 C, 4 adjacent entries C[col .. col + 3]: one 16-byte access where
// the address allows and all 4 lie before N, single entries otherwise (0
// past N on a load)
__device__ __forceinline__ float4 load4(const float* p, int col, int N) {
  if (col + 3 < N && (reinterpret_cast<uintptr_t>(p) & 15) == 0)
    return *reinterpret_cast<const float4*>(p);
  return make_float4(col < N ? p[0] : 0.0f, col + 1 < N ? p[1] : 0.0f,
                     col + 2 < N ? p[2] : 0.0f, col + 3 < N ? p[3] : 0.0f);
}
__device__ __forceinline__ void store4(float* p, int col, int N, float4 v) {
  if (col + 3 < N && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  if (col < N) p[0] = v.x;
  if (col + 1 < N) p[1] = v.y;
  if (col + 2 < N) p[2] = v.z;
  if (col + 3 < N) p[3] = v.w;
}

// bf16 C, 8 adjacent entries C[col .. col + 7] as raw bits: one 16-byte
// access where the address allows and all 8 lie before N, single entries
// otherwise (0 past N on a load)
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, int col, int N) {
  if (col + 7 < N && (reinterpret_cast<uintptr_t>(p) & 15) == 0)
    return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t lo = col + 2 * k < N ? __bfloat16_as_ushort(p[2 * k]) : 0u;
    const uint32_t hi = col + 2 * k + 1 < N ? __bfloat16_as_ushort(p[2 * k + 1]) : 0u;
    w[k] = lo | hi << 16;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, int col, int N, const float (&v)[8]) {
  __nv_bfloat16 b[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) b[k] = from_f32<__nv_bfloat16>(v[k]);
  if (col + 7 < N && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (uint32_t)__bfloat16_as_ushort(b[2 * k]) |
             (uint32_t)__bfloat16_as_ushort(b[2 * k + 1]) << 16;
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (col + k < N) p[k] = b[k];
}
// the fp32 value of bf16 number k (0..7) of a raw 16-byte row
__device__ __forceinline__ float bf16_at(const uint4& u, int k) {
  const uint32_t w = k < 2 ? u.x : k < 4 ? u.y : k < 6 ? u.z : u.w;
  return __uint_as_float(k & 1 ? w & 0xffff0000u : w << 16);
}

__device__ __forceinline__ float2 shfl_xor2(float2 v, int k) {
  return make_float2(__shfl_xor_sync(0xffffffffu, v.x, k), __shfl_xor_sync(0xffffffffu, v.y, k));
}

// tile t of the grouped raster order -> its origin (m0, n0)
__device__ __forceinline__ void tile_origin(int t, int tiles_m, int tiles_n, int& m0,
                                            int& n0) {
  const int per_group = kGroupM * tiles_n;
  const int g = t / per_group, first = g * kGroupM;
  const int rows = min(tiles_m - first, kGroupM);
  const int r = t - g * per_group;
  m0 = (first + r % rows) * kBM;
  n0 = (r / rows) * kBN;
}

// tile t of the store instance's order -> its origin: chunks of `cols` =
// ceil(2 grid / tiles_m) whole tile columns (the last chunk may be
// narrower), each ordered deepest tile row first, then by column
__device__ __forceinline__ void tri_origin(int t, int tiles_m, int tiles_n, int& m0, int& n0) {
  const int cols = (2 * (int)gridDim.x + tiles_m - 1) / tiles_m;
  const int chunk = t / (cols * tiles_m), q = t - chunk * cols * tiles_m;
  const int w = min(cols, tiles_n - chunk * cols);
  m0 = (tiles_m - 1 - q / w) * kBM;
  n0 = (chunk * cols + q % w) * kBN;
}

// this block's j-th tile: the grid stride, or (kTri) tiles b and 2 grid -
// 1 - b of each window of 2 grid tiles, b the block
template <bool kTri>
__device__ __forceinline__ int walk_tile(int j) {
  const int b = (int)blockIdx.x, p = (int)gridDim.x;
  if constexpr (kTri) {
    return (j >> 1) * 2 * p + ((j & 1) ? 2 * p - 1 - b : b);
  } else {
    return b + j * p;
  }
}

// how many of the `tiles` tiles this block's walk takes (the grid is at
// most the tile count, so at least one)
template <bool kTri>
__device__ __forceinline__ int walk_count(int tiles) {
  const int b = (int)blockIdx.x, p = (int)gridDim.x;
  if constexpr (kTri) {
    const int rem = tiles % (2 * p);
    return 2 * (tiles / (2 * p)) + (b < rem) + (2 * p - 1 - b < rem);
  } else {
    return (tiles - 1 - b) / p + 1;
  }
}

template <bool kTri>
__device__ __forceinline__ void walk_origin(int t, int tiles_m, int tiles_n, int& m0, int& n0) {
  if constexpr (kTri) {
    tri_origin(t, tiles_m, tiles_n, m0, n0);
  } else {
    tile_origin(t, tiles_m, tiles_n, m0, n0);
  }
}

// The whole routine, run by every thread of a kThreads-thread block with
// smem_bytes(kSt, kCH) bytes of dynamic shared memory; blocks stride over
// the tiles.  kRejoin: every thread leaves with kRejoinRegs registers, so
// code after it (kernel 13's exchange) runs on all warps.  kSt: the A/B
// ring's stages.  kCH: C's half-tile slots (bf16 C; 0 keeps C in
// registers).  With kCH > 0, half u = 2 lt + h of this block's tiles (h
// the consumer warpgroup, lt the tile) lies in slot u % kCH and is counted
// on full and ready barriers u % c_bars(kCH); the C thread (thread 32)
// loads the first kCH halves, then for each group of halves stores them
// (tmC: boxes of 64 x 64, 128-byte swizzle) once their warpgroups are done,
// waits until the stores have read the slots, and loads into each slot the
// half that takes it next: with one 64 KB slot the next tile's C is on its
// way as its main loop starts, with one 32 KB slot the first half's is.
// kStore: the store instance (C = bf16(A @ B), A lower triangular; the C
// thread arrives on a slot's full barrier where it would load C).
template <typename TC, bool kRejoin, int kSt = kStages, int kCH = 0, bool kStore = false>
__device__ __forceinline__ void run(const CUtensorMap* tmA, const CUtensorMap* tmB,
                                    const CUtensorMap* tmC, int M, int N, int K,
                                    TC* __restrict__ C, i64 ldc) {
  constexpr bool kStagedC = kCH > 0;
  static_assert(!kStagedC || sizeof(TC) == 2, "C through shared memory is bf16 C only");
  static_assert(!kStore || (kStagedC && !kRejoin), "the store instance is C through shared memory");
  constexpr int kSlots = kStagedC ? kCH : 1, kCBars = c_bars(kCH);
  // halves stored between two waits for the stores' reads: a tile's two
  // where two slots hold them, else one (its slot takes the next half)
  constexpr int kGroup = kCH < kConsumers ? 1 : kConsumers;
  extern __shared__ uint8_t sm90_smem[];
  uint8_t* smem = sm90_smem + ((1024 - (tma::smem_addr(sm90_smem) & 1023)) & 1023);
  uint8_t* sA = smem;                                  // kSt x 128 x 64
  uint8_t* sB = smem + kSt * kABytes;                  // kSt x 4 boxes of 64 x 64
  uint8_t* sC = sB + kSt * kBBytes;                    // kCH x 4 boxes of 64 x 64
  uint64_t* full = reinterpret_cast<uint64_t*>(sC + kCH * kCHalf);
  uint64_t* empty = full + kSt;
  uint64_t* cfull = empty + kSt;       // kStagedC: a half of C has landed
  uint64_t* cready = cfull + kCBars;   // its new values are in shared memory
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSt; ++s) {
      tma::mbar_init(&full[s], 1);               // the producer's arrive (+ the bytes)
      tma::mbar_init(&empty[s], kConsumers * 4);  // lane 0 of every consumer warp
    }
    if constexpr (kStagedC) {
      for (int s = 0; s < kCBars; ++s) {
        tma::mbar_init(&cfull[s], 1);   // the C thread's arrive (+ the bytes)
        tma::mbar_init(&cready[s], 4);  // lane 0 of each warp of one consumer warpgroup
      }
    }
    tma::fence_barrier_init();
  }
  __syncthreads();

  const int tiles_m = (M + kBM - 1) / kBM, tiles_n = (N + kBN - 1) / kBN;
  const int tiles = (M > 0 && N > 0 && K > 0) ? tiles_m * tiles_n : 0;
  const int kblocks = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0 && tiles > 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(tmA)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(tmB)) : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int jt = 0, t = walk_tile<kStore>(0); t < tiles; t = walk_tile<kStore>(++jt)) {
        int m0, n0;
        walk_origin<kStore>(t, tiles_m, tiles_n, m0, n0);
        const int kbt = kStore ? min(kblocks, (m0 + kBM) / kBK) : kblocks;
        for (int kb = 0; kb < kbt; ++kb) {
          tma::mbar_wait(&empty[stage], phase ^ 1);  // the first round passes
          tma::mbar_arrive_expect_tx(&full[stage], kABytes + kBBytes);
          load_2d(sA + stage * kABytes, tmA, kb * kBK, m0, &full[stage]);
#pragma unroll
          for (int j = 0; j < kBN / 64; ++j)
            load_2d(sB + stage * kBBytes + j * kBoxBytes, tmB, n0 + 64 * j, kb * kBK,
                    &full[stage]);
          if (++stage == kSt) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    if constexpr (kStagedC) {
      if (threadIdx.x == 32 && tiles > 0) {
        // the C thread: this block's halves in order (its grid is at most
        // the tile count, so it has at least one tile)
        asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(tmC)) : "memory");
        const int units = 2 * walk_count<kStore>(tiles);
        auto origin = [&](int u, int& m0, int& n0) {
          walk_origin<kStore>(walk_tile<kStore>(u >> 1), tiles_m, tiles_n, m0, n0);
          m0 += 64 * (u & 1);
        };
        auto load_half = [&](int u) {
          uint64_t* bar = &cfull[u % kCBars];
          if constexpr (kStore) {
            mbar_arrive(bar);  // nothing to load: the slot is free
          } else {
            int m0, n0;
            origin(u, m0, n0);
            tma::mbar_arrive_expect_tx(bar, kCHalf);
#pragma unroll
            for (int j = 0; j < kBN / 64; ++j)
              load_2d(sC + (u % kSlots) * kCHalf + j * kCBox, tmC, n0 + 64 * j, m0, bar);
          }
        };
        for (int u = 0; u < kSlots && u < units; ++u) load_half(u);
        for (int u0 = 0; u0 < units; u0 += kGroup) {
#pragma unroll
          for (int u = u0; u < u0 + kGroup; ++u) {
            int m0, n0;
            origin(u, m0, n0);
            tma::mbar_wait(&cready[u % kCBars], (u / kCBars) & 1);
#pragma unroll
            for (int j = 0; j < kBN / 64; ++j)
              store_2d(tmC, n0 + 64 * j, m0, sC + (u % kSlots) * kCHalf + j * kCBox);
          }
          bulk_commit();
          bulk_wait_read();
#pragma unroll
          for (int u = u0; u < u0 + kGroup; ++u)
            if (u + kSlots < units) load_half(u + kSlots);
        }
        bulk_wait();
      }
    }
    __syncwarp();
    if constexpr (kRejoin) setmaxnreg_inc<kRejoinRegs>();
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;  // this warpgroup's 64 rows of the tile
    const int warp = (threadIdx.x & 127) >> 5, lane = threadIdx.x & 31;
    float d[128];
    int stage = 0;
    uint32_t phase = 0;
    int lt = 0;
    for (int t = walk_tile<kStore>(0); t < tiles; t = walk_tile<kStore>(++lt)) {
      int m0, n0;
      walk_origin<kStore>(t, tiles_m, tiles_n, m0, n0);
      const int kbt = kStore ? min(kblocks, (m0 + kBM) / kBK) : kblocks;
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0.0f;
      int prev = -1;
      for (int kb = 0; kb < kbt; ++kb) {
        tma::mbar_wait(&full[stage], phase);
        __syncwarp();  // wgmma is warp-aligned
        const uint32_t a0 = tma::smem_addr(sA + stage * kABytes + cw * 64 * 128);
        const uint32_t b0 = tma::smem_addr(sB + stage * kBBytes);
        fence_operands(d);
        wgmma_fence();
        // A: rows of 128 bytes, 8-row groups 1024 bytes apart, k16 = +32 bytes;
        // B: 64-column boxes kBoxBytes apart, 8-row k groups 1024 bytes apart,
        // k16 = +16 rows
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_m64n256k16(d, desc(a0 + kk * 32, 16, 1024),
                           desc(b0 + kk * 16 * 128, kBoxBytes, 1024));
        wgmma_commit();
        fence_operands(d);
        wgmma_wait<1>();  // the previous step's products are done: free its stage
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kSt) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_operands(d);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);

      if constexpr (kStagedC) {
        // C in shared memory: this warpgroup's half u of the tile.  Per pair
        // of column chunks (j, j + 1) one ldmatrix.x4 brings the lane the
        // four words of bf16 pairs that its fragment holds (rows lane / 4
        // and + 8, columns 8j + 2 (lane % 4) and 8 (j + 1) + ...): lane l
        // gives the address of row l % 8 of 8 x 8 matrix l / 8 (row half
        // (l / 8) % 2, chunk j + l / 16), 16 bytes at chunk c ^ (row % 8)
        // of its 128-byte swizzled row, so the 8 rows of a matrix hit 8
        // different chunks, no bank conflict; stmatrix.x4 writes the four
        // words back the same way.  Rows and columns past M and N hold TMA's
        // zeros and are clipped by the store.
        const int u = 2 * lt + cw;
        tma::mbar_wait(&cfull[u % kCBars], (u / kCBars) & 1);
        const uint32_t cs = tma::smem_addr(sC + (u % kSlots) * kCHalf);
        const int r8 = lane & 7, q = lane >> 3;
        const uint32_t row = cs + (warp * 16 + 8 * (q & 1) + r8) * 128;
#pragma unroll
        for (int j = 0; j < kBN / 8; j += 2) {
          const int jj = j + (q >> 1);
          const uint32_t addr = row + (jj >> 3) * kCBox + (((jj & 7) ^ r8) << 4);
          uint32_t w[4];
          if constexpr (!kStore) {
            asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                         : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                         : "r"(addr));
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            // word k: chunk j + k / 2, row half k % 2: d[4 (j + k / 2) + 2 (k % 2) + c]
            const int di = 4 * (j + (k >> 1)) + 2 * (k & 1);
            float lo = d[di], hi = d[di + 1];
            if constexpr (!kStore) {
              lo = __fsub_rn(__uint_as_float(w[k] << 16), lo);
              hi = __fsub_rn(__uint_as_float(w[k] & 0xffff0000u), hi);
            }
            asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(w[k]) : "f"(hi), "f"(lo));
          }
          asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};"
                       ::"r"(addr), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                       : "memory");
        }
        tma::fence_proxy_async();  // the writes, before the async-proxy store reads them
        __syncwarp();
        if (lane == 0) mbar_arrive(&cready[u % kCBars]);
        continue;  // the register epilogue below is the other instance's
      }

      // accumulator fragment: d[4j + 2i + c] is row 16 warp + lane/4 + 8i,
      // column 8j + 2 (lane % 4) + c of this warpgroup's 64 x 256
      const int row0 = m0 + cw * 64 + warp * 16 + (lane >> 2);
      if constexpr (sizeof(TC) == 4) {
        // fp32 C: per column chunk j the lanes of a quad hold pairs of
        // entries (lane s: columns 2s, 2s + 1 of both row halves); one
        // shuffle step (xor 1 trades the row half) leaves lane s with 4
        // adjacent entries of row half s % 2: one 16-byte load and store a
        // lane, 16 rows of 32 bytes a warp instruction.  The loads of a
        // batch are issued together (its stores cannot move above them).
        const int b0 = lane & 1;
        const int row = row0 + 8 * b0, col0 = n0 + 4 * ((lane & 3) >> 1);
#pragma unroll
        for (int j0 = 0; j0 < kBN / 8; j0 += kBatch) {
          float4 c[kBatch];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const int col = col0 + 8 * (j0 + j);
            c[j] = row < M ? load4(C + (i64)row * ldc + col, col, N)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const int q = 4 * (j0 + j), col = col0 + 8 * (j0 + j);
            const float2 r0 = make_float2(d[q], d[q + 1]), r8 = make_float2(d[q + 2], d[q + 3]);
            const float2 keep = b0 ? r8 : r0, got = shfl_xor2(b0 ? r0 : r8, 1);
            const float2 lo = b0 ? got : keep, hi = b0 ? keep : got;
            if (row < M)
              store4(C + (i64)row * ldc + col, col, N,
                     make_float4(__fsub_rn(c[j].x, lo.x), __fsub_rn(c[j].y, lo.y),
                                 __fsub_rn(c[j].z, hi.x), __fsub_rn(c[j].w, hi.y)));
          }
        }
      } else {
        // bf16 C: per pair of column chunks (2p, 2p + 1) the quad's lanes
        // hold 4 x 4 pairs of entries (lane s: row half i, chunk jj, columns
        // 2s, 2s + 1); two butterfly steps of shuffles (xor 2 trades the row
        // half, xor 1 the chunk) transpose them, so lane t = 2i + jj holds
        // 8 adjacent entries of one row: one 16-byte load and store a lane,
        // 16 rows of 32 bytes a warp instruction.
        const int l = lane & 3, b1 = l >> 1, b0 = l & 1;
        const int row = row0 + 8 * b1;
#pragma unroll
        for (int p0 = 0; p0 < kBN / 16; p0 += kBatch) {
          uint4 cv[kBatch];
#pragma unroll
          for (int q = 0; q < kBatch; ++q) {
            const int col = n0 + 8 * (2 * (p0 + q) + b0);
            cv[q] = row < M ? load8(C + (i64)row * ldc + col, col, N) : make_uint4(0, 0, 0, 0);
          }
#pragma unroll
          for (int q = 0; q < kBatch; ++q) {
            const int p = p0 + q;
            float2 m[4];  // m[2i + jj]: chunk 2p + jj, row half i
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int jj = 0; jj < 2; ++jj)
                m[2 * i + jj] = make_float2(d[4 * (2 * p + jj) + 2 * i], d[4 * (2 * p + jj) + 2 * i + 1]);
            float2 a[2][2];  // a[b][jj]: from the lane whose row-half bit is b
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const float2 keep = b1 ? m[2 + jj] : m[jj], give = b1 ? m[jj] : m[2 + jj];
              const float2 got = shfl_xor2(give, 2);
              a[0][jj] = b1 ? got : keep;
              a[1][jj] = b1 ? keep : got;
            }
            float v[8];  // columns 0..7 of chunk 2p + b0, row half b1
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              const float2 keep = b0 ? a[b][1] : a[b][0], give = b0 ? a[b][0] : a[b][1];
              const float2 got = shfl_xor2(give, 1);
              const float2 lo = b0 ? got : keep, hi = b0 ? keep : got;  // lanes 2b, 2b + 1
              v[4 * b + 0] = lo.x;
              v[4 * b + 1] = lo.y;
              v[4 * b + 2] = hi.x;
              v[4 * b + 3] = hi.y;
            }
            const int col = n0 + 8 * (2 * p + b0);
#pragma unroll
            for (int k = 0; k < 8; ++k) v[k] = __fsub_rn(bf16_at(cv[q], k), v[k]);
            if (row < M) store8(C + (i64)row * ldc + col, col, N, v);
          }
        }
      }
    }
    if constexpr (kRejoin) setmaxnreg_dec<kRejoinRegs>();
  }
}

// ---- host pieces ------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's entry-point
// query (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// map of the row-major bf16 (rows x cols) matrix at `base`, row stride ld
// elements: dims are the logical sizes (TMA zero-fills past them), boxes
// of box_rows x 64 with 128-byte swizzle.  0 or a cudaError_t code.
inline int encode(CUtensorMap* map, const void* base, int rows, int cols, i64 ld,
                  uint32_t box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  cuuint32_t box[2] = {64, box_rows};
  cuuint32_t estr[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                  strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// both operand maps (A: dims (K, M), stride lda; B: dims (N, K), stride
// ldb); nothing is encoded, and 0 tiles run, when M, N or K is 0
inline int encode_operands(CUtensorMap* ta, CUtensorMap* tb, int M, int N, int K,
                           const void* A, i64 lda, const void* B, i64 ldb) {
  memset(ta, 0, sizeof(*ta));
  memset(tb, 0, sizeof(*tb));
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  int err = encode(ta, A, M, K, lda, kBM);
  return err ? err : encode(tb, B, K, N, ldb, kBK);
}

// C (M x N) at a 16-byte base with a row stride and a width N that are
// multiples of 16 bytes: TMA reads and writes it in place (a store writes
// whole 16-byte pieces of a row, so on the card it wrote the entries past a
// ragged N up to the next 16 bytes)
inline bool c_tma_ok(const void* C, int N, i64 ldc, size_t es) {
  return (reinterpret_cast<uintptr_t>(C) & 15) == 0 && (ldc * (i64)es) % 16 == 0 &&
         ((i64)N * (i64)es) % 16 == 0;
}

inline long long tile_count(int M, int N, int K) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  return (long long)((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
}

// Kernel 12's update pass, C = bf16(fp32(C) - A @ B) on the routine (defined
// in gemm_sub.cu, the one translation unit that instantiates its kernels,
// as trailing_kernel<bf16, true>): smem_c takes its layout with C through
// shared memory where C's base, row stride and width are multiples of 16
// bytes (else the register epilogue, which reads C in place at any
// alignment).
// Returns cudaGetLastError() or the encode error.
int launch_update(int M, int N, int K, const void* A, i64 lda, const void* B, i64 ldb,
                  __nv_bfloat16* C, i64 ldc, bool smem_c, cudaStream_t st);

}  // namespace sm90
}  // namespace gemm
