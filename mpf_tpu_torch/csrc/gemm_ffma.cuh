// The IEEE-fp32 trailing GEMM of kernels 6 and 13, and kernel 3's fp32
// update: C = C - A @ B in place, A (M x K), B (K x N) and C row-major
// fp32, each product an fp32 FFMA (never TF32: PURE_FP32, MPF_REF and
// MPF_FP16 need true fp32 products).  Rows whose pos[row] < thr are left
// untouched (pos == nullptr: no mask).
//
// What bounds it on the H100: operations, 2 M N K flops over the 67
// TFLOP/s fp32 FFMA rate (7.2 ms at 15360^2 x 1024, against 0.56 ms for
// C's read-modify-write at 3.35 TB/s).  An FFMA GEMM reaches that rate only
// when nothing but FFMAs and their shared loads sits in the FFMA warps'
// instruction stream: the SM issues 4 warp instructions a clock and
// retires 4 warp FFMAs a clock, so every other instruction takes an FFMA's
// slot.  (Measured on the card, PERF.md section 6: with every thread
// issuing its own cp.async copies a step, the copies cost about a sixth of
// the time.)
//
// Design:
// - A 128 x 128 tile a block of 256 threads (8 warps), 8 x 8 outputs a
//   thread: each thread holds 64 accumulators and reads 8 A values and 8 B
//   values a k.  Warp w covers rows 32 (w / 2) and columns 64 (w % 2) of
//   the tile; lane l = 8 tr + tc takes rows tr + 4 i (i < 8) and columns
//   4 tc + j and 32 + 4 tc + j (j < 4).  8 vector loads of A (4 floats
//   along k) and 8 of B a 4-deep k step, against 256 FFMAs.
// - A kept row-major in shared memory in 20-float (80-byte) rows, of which
//   the products read 16: the 4 rows one A load touches sit in 4 different
//   16-byte bank groups, so no load conflicts and no transposing store.  B
//   row-major, 128 floats a row.
// - A ring of kStages = 6 16-deep K steps in dynamic shared memory (18 KB
//   a stage; 6 ran 1-2% faster than 3 or 4 on the card), two blocks an SM.
//   Operands at 16-byte bases with row strides of 4 floats (every operand
//   on the factorization's paths) take the Tensor Memory Accelerator: one
//   thread arms a stage's `full` mbarrier and issues two 2-D tensor loads,
//   A as a 20 x 128 box (the 4 columns past the step land in the padding,
//   which nobody reads) and B as 128 x 16, zero-filled past M, N and K;
//   every warp waits on `full` and, once its reads of the stage are done,
//   arrives on the stage's `empty` mbarrier, which the loading thread waits
//   on before it refills the stage kStages - 1 steps later.  The FFMA warps
//   issue no copies and meet at no block barrier.  Any other operand takes
//   an instance in which every thread copies 4-byte elements with cp.async
//   (LDGSTS, zero-filled past the edges) into the same layout, one
//   __syncthreads() a step.
// - Sum order: each output entry has one accumulator that starts at 0 and
//   takes acc = fmaf(a[k], b[k], acc) for k = 0, 1, ..., K - 1, then C =
//   __fsub_rn(C, acc).  The zero-filled tail adds fmaf(0, 0, acc) = acc
//   (acc is never -0).  So every entry is the same whatever the tiling, the
//   grid, the copy instance or the caller (kernel 13 is bitwise kernel 6, a
//   quadrant of C updated alone is bitwise the whole update), and kernel
//   10's fp32 update (panel_update_full.cu) is bitwise kernel 3's.  No
//   split-K.
// - Epilogue from registers: C -= acc with 16-byte accesses where 4
//   columns of a row are in C and 16-byte aligned (4 rows of 128 bytes a
//   warp instruction), single entries otherwise, so any ldc and base work.
//   It does not overlap the products of its own block; the other resident
//   block's products hide it.
// - Tiles in a grouped raster order (kGroupM tile rows at a time) so that
//   neighbouring blocks share their A and B panels in L2: one block a tile
//   for kernel 6, blocks striding over the tiles in kernel 13 (the ring and
//   its barrier phases run on from one tile to the next).
#pragma once

#include "gemm_sm90.cuh"

namespace gemm {
namespace ffma {

constexpr int kBM = 128, kBN = 128, kBK = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;                       // resident blocks an SM
constexpr int kStages = 6;
constexpr int kLdA = kBK + 4;                       // A's shared row: 16 floats + 16 bytes
constexpr int kStageFloats = kBM * kLdA + kBK * kBN;
constexpr uint32_t kStageBytes = kStageFloats * 4;  // 18 KB: A 128 x 20, B 16 x 128
// 1024 bytes of alignment slack, the ring, the full and empty barriers
constexpr int kSmem = 1024 + kStages * (int)kStageBytes + 2 * kStages * 8;
constexpr int kGroupM = 8;

struct Args {
  int M, N, K;
  const float* A;
  i64 lda;
  const float* B;
  i64 ldb;
  float* C;
  i64 ldc;
  const int* pos;
  int thr;
};

// TMA reads an operand in place at a 16-byte base with a row stride of 4
// floats (no shorter than its row); else the 4-byte-copy instance runs
inline bool tma_ok(const Args& g) {
  return ((reinterpret_cast<uintptr_t>(g.A) | reinterpret_cast<uintptr_t>(g.B)) & 15) == 0 &&
         g.lda % 4 == 0 && g.ldb % 4 == 0 && g.lda >= g.K && g.ldb >= g.N;
}

__host__ __device__ inline long long tile_count(int M, int N) {
  return (M > 0 && N > 0) ? (long long)((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN) : 0;
}

// map of the row-major fp32 (rows x cols) matrix at `base`, row stride ld
// elements, boxes of box_cols x box_rows, no swizzle: dims are the logical
// sizes, so TMA zero-fills past them.  0 or a cudaError_t code.
inline int encode(CUtensorMap* map, const void* base, int rows, int cols, i64 ld,
                  uint32_t box_cols, uint32_t box_rows) {
  sm90::EncodeTiled fn = sm90::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  cuuint32_t box[2] = {box_cols, box_rows};
  cuuint32_t estr[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
                  strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the launch's choice of instance (tma: the operands allow TMA) and both
// operand maps for it (A: 20 x 128 boxes, B: 128 x 16); nothing is encoded
// for the 4-byte instance or when M, N or K is 0 (no step runs).  0 or a
// cudaError_t code.
inline int operand_maps(const Args& g, CUtensorMap* ta, CUtensorMap* tb, bool& tma) {
  memset(ta, 0, sizeof(*ta));
  memset(tb, 0, sizeof(*tb));
  tma = tma_ok(g);
  if (!tma || g.M <= 0 || g.N <= 0 || g.K <= 0) return 0;
  int err = encode(ta, g.A, g.M, g.K, g.lda, kLdA, kBM);
  return err ? err : encode(tb, g.B, g.K, g.N, g.ldb, kBN, kBK);
}

// ---- cp.async (LDGSTS): `bytes` of the copy read, the rest zero-filled ----
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
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

// The 4-byte-copy instance: every thread copies its elements of K step
// [k0, k0 + 16) of the tile at (m0, n0) into the stage at shared address sA
// (A 128 x kLdA, then B 16 x 128).
__device__ __forceinline__ void copy_step(const Args& g, int m0, int n0, int k0, uint32_t sA) {
  const int tid = threadIdx.x;
  const uint32_t sB = sA + kBM * kLdA * 4;
#pragma unroll
  for (int q = 0; q < 8; ++q) {  // A: 128 rows x 16 floats
    const int e = tid + q * kThreads, row = e >> 4, kc = e & 15;
    const int gr = m0 + row, gk = k0 + kc;
    const bool in = gr < g.M && gk < g.K;
    cp4(sA + (row * kLdA + kc) * 4, in ? g.A + (i64)gr * g.lda + gk : g.A, in ? 4 : 0);
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {  // B: 16 rows x 128 floats
    const int e = tid + q * kThreads, row = e >> 7, nc = e & 127;
    const int gk = k0 + row, gn = n0 + nc;
    const bool in = gk < g.K && gn < g.N;
    cp4(sB + (row * kBN + nc) * 4, in ? g.B + (i64)gk * g.ldb + gn : g.B, in ? 4 : 0);
  }
}

// acc += the 16-deep step in As / Bs, k ascending for every entry; ar is
// the thread's first tile row (rows ar + 4 i), bc its first column
// (columns bc + j, bc + 32 + j)
__device__ __forceinline__ void step_products(const float* As, const float* Bs, int ar, int bc,
                                              float (&acc)[8][8]) {
#pragma unroll
  for (int kq = 0; kq < kBK; kq += 4) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float4*>(As + (ar + 4 * i) * kLdA + kq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + (kq + kk) * kBN + bc);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + (kq + kk) * kBN + bc + 32);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ai = reinterpret_cast<const float*>(&a[i])[kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ai, b[j], acc[i][j]);
      }
    }
  }
}

// The ring in dynamic shared memory: kStages stages, then the full and
// empty barriers.  Set up once a block, before its first tile.
struct Ring {
  float* stages;
  uint64_t* full;
  uint64_t* empty;
};

__device__ __forceinline__ Ring ring_init(uint8_t* raw) {
  uint8_t* base = raw + ((1024 - (tma::smem_addr(raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + kStages * kStageBytes);
  Ring ring{reinterpret_cast<float*>(base), bars, bars + kStages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tma::mbar_init(&ring.full[s], 1);       // the loading thread's arrive (+ the bytes)
      tma::mbar_init(&ring.empty[s], kWarps);  // lane 0 of every warp
    }
    tma::fence_barrier_init();
  }
  __syncthreads();
  return ring;
}

// the loading thread: step `it` of the ring (stage it % kStages, its use
// it / kStages) gets K step [k0, k0 + 16) of the tile at (m0, n0), once
// every warp has released the stage's previous use (the first use passes)
__device__ __forceinline__ void tma_step(const Ring& ring, const CUtensorMap* tmA,
                                         const CUtensorMap* tmB, uint32_t it, int m0, int n0,
                                         int k0) {
  const uint32_t s = it % kStages, use = it / kStages;
  tma::mbar_wait(&ring.empty[s], (use & 1) ^ 1);
  float* sa = ring.stages + s * kStageFloats;
  tma::mbar_arrive_expect_tx(&ring.full[s], kStageBytes);
  sm90::load_2d(sa, tmA, k0, m0, &ring.full[s]);
  sm90::load_2d(sa + kBM * kLdA, tmB, n0, k0, &ring.full[s]);
}

// C[m0 : m0 + 128, n0 : n0 + 128] -= A @ B over all of K, by every thread of
// a kThreads-thread block.  kTma: the operands come by TMA (tmA, tmB)
// through `ring`, whose running step count `it` carries over from one tile
// to the next; else by 4-byte copies through ring.stages.  A block may run
// several tiles one after another.
template <bool kTma>
__device__ __forceinline__ void run_tile(const Args& g, const CUtensorMap* tmA,
                                         const CUtensorMap* tmB, const Ring& ring,
                                         uint32_t& it, int m0, int n0) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ar = (warp >> 1) * 32 + (lane >> 3);
  const int bc = (warp & 1) * 64 + (lane & 7) * 4;
  const int nk = (g.K + kBK - 1) / kBK;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  if constexpr (kTma) {
    const uint32_t it0 = it;
    if (tid == 0)
      for (int s = 0; s < kStages - 1 && s < nk; ++s)
        tma_step(ring, tmA, tmB, it0 + s, m0, n0, s * kBK);
    for (int kb = 0; kb < nk; ++kb) {
      const uint32_t cur = it0 + kb;
      // step kb + kStages - 1 refills the stage that step kb - 1 read
      if (tid == 0 && kb + kStages - 1 < nk)
        tma_step(ring, tmA, tmB, cur + kStages - 1, m0, n0, (kb + kStages - 1) * kBK);
      const uint32_t s = cur % kStages;
      tma::mbar_wait(&ring.full[s], (cur / kStages) & 1);
      const float* As = ring.stages + s * kStageFloats;
      step_products(As, As + kBM * kLdA, ar, bc, acc);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&ring.empty[s]);
    }
    it = it0 + nk;
  } else {
    const uint32_t s0 = tma::smem_addr(ring.stages);
    __syncthreads();  // every thread is past its reads of the previous tile's ring
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) copy_step(g, m0, n0, s * kBK, s0 + s * kStageBytes);
      cp_commit();
    }
    int rd = 0, wr = kStages - 1;  // the stage read this step, the stage refilled
    for (int kb = 0; kb < nk; ++kb) {
      cp_wait<kStages - 2>();  // this thread's copies of step kb have landed
      __syncthreads();         // everyone's have, and step kb - 1's stage is read
      if (kb + kStages - 1 < nk)
        copy_step(g, m0, n0, (kb + kStages - 1) * kBK, s0 + wr * kStageBytes);
      cp_commit();
      const float* As = ring.stages + rd * kStageFloats;
      step_products(As, As + kBM * kLdA, ar, bc, acc);
      rd = rd == kStages - 1 ? 0 : rd + 1;
      wr = wr == kStages - 1 ? 0 : wr + 1;
    }
    cp_wait<0>();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = m0 + ar + 4 * i;
    if (gr >= g.M || (g.pos != nullptr && g.pos[gr] < g.thr)) continue;
    float* crow = g.C + (i64)gr * g.ldc;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gc = n0 + bc + 32 * h;
      float* p = crow + gc;
      if (gc + 3 < g.N && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
        float4 c = *reinterpret_cast<float4*>(p);
        c.x = __fsub_rn(c.x, acc[i][4 * h]);
        c.y = __fsub_rn(c.y, acc[i][4 * h + 1]);
        c.z = __fsub_rn(c.z, acc[i][4 * h + 2]);
        c.w = __fsub_rn(c.w, acc[i][4 * h + 3]);
        *reinterpret_cast<float4*>(p) = c;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gc + j < g.N) p[j] = __fsub_rn(p[j], acc[i][4 * h + j]);
      }
    }
  }
}

}  // namespace ffma
}  // namespace gemm
