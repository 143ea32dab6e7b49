// Kernel 13: trailing GEMM with the next block column's row exchange in the
// same launch (the lookahead driver's wide update).
//
// Replaces: mpf_tpu/ops/gemmx.py:_gemmx_kernel (via gemm_trailing):
//   a[r0:r0+M, c0:c0+N] -= L21 @ U12        (fp32 accumulation, in place)
// then, when nr > 0, the combined row exchange of the band [k, k + nr) on
// the UPDATED matrix, over the full width w of every row:
//   pivrows[j] = a[glist[j], :]                      (every read first)
//   a[dests[i], :] = a[k + i, :]   for every dests[i] outside [k, k + nr)
// The caller then writes pivrows over the band.  Gathered rows carry the
// GEMM's results in columns [c0, w) and untouched values in [0, c0);
// glist may name band rows.
//
// Three instances, as kernel 6: bf16 operands on the tensor cores with fp32
// C (MPF_BF16); fp32 operands on FFMA, never TF32 (PURE_FP32, MPF_REF); bf16
// operands with bf16 C, rounded once after the fp32 subtract (ALL_BF16).
//
// What bounds it on the H100: the GEMM, as for kernel 6 (the O(n^3) part:
// with bf16 operands tensor-core bound and C's read-modify-write bytes
// bound, of the same order at K = 1024); the exchange adds
// 2 * (nr + moved rows) * w * (4 or 2) bytes, after a grid barrier, so it
// does not overlap the GEMM.
//
// Design: one cooperative launch of as many blocks as can be resident
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor with the dynamic shared
// memory the routine takes; a grid that cannot be co-resident is refused,
// never run).  The bf16-operand instances run kernel 6's Hopper routine
// (gemm_sm90.cuh: TMA ring, producer and wgmma consumer warpgroups,
// persistent tiles, one block an SM), the FFMA instance kernel 6's FFMA
// routine (gemm_ffma.cuh: 128 x 128 tiles, a TMA ring on mbarriers in
// dynamic shared memory, two blocks an SM) striding over the tiles in the
// same grouped raster order; each output entry is summed in the same order
// as kernel 6's, so every entry is bitwise equal to kernel 6's.
// The producer warpgroup does not leave early: every thread meets the
// others again with the same register count and reaches both grid
// barriers.  Then a grid barrier, the gather, a grid barrier, the scatter.
// The barriers order every GEMM write before any exchange read and every
// gather read before any scatter write; the scatter reads only band rows,
// which it never writes.  The exchange reads through L2 (__ldcg), never
// the read-only path, because the rows it reads were written earlier in
// this launch.  The TPU kernel's schedule machinery (granule windows,
// window rings, strip-completion gates, the pair-major strip order) has no
// counterpart: rows are contiguous and the barriers take its place.
#include <cooperative_groups.h>

#include "gemm_ffma.cuh"

namespace cg = cooperative_groups;

namespace {

// dst[0:w] = src[0:w] with loads through L2: 16-byte vectors when both rows
// are 16-byte aligned, elements otherwise (raw bits, no arithmetic)
template <typename E>
__device__ __forceinline__ void copy_row_l2(E* dst, const E* src, int w) {
  constexpr int kPer = 16 / sizeof(E);
  bool vec = ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0;
  int nv = vec ? w / kPer : 0;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) d4[i] = __ldcg(s4 + i);
  for (int i = nv * kPer + threadIdx.x; i < w; i += blockDim.x) dst[i] = __ldcg(src + i);
}

// The exchange after the GEMM, kept out of line: inlined into the tile loop,
// its live values pushed the FFMA instance to more registers and a spill,
// and it ran about 40% slower than kernel 6 on the same shapes.
template <typename E>
__device__ __noinline__ void exchange(E* a, i64 ld, int w, int nr, int k,
                                      const int* __restrict__ glist,
                                      const int* __restrict__ dests, E* __restrict__ pivrows) {
  cg::grid_group grid = cg::this_grid();
  grid.sync();  // every GEMM write lands before any exchange read
  for (int j = blockIdx.x; j < nr; j += gridDim.x)
    copy_row_l2(pivrows + (i64)j * w, a + (i64)glist[j] * ld, w);
  grid.sync();  // every gather read is done before any scatter write
  for (int i = blockIdx.x; i < nr; i += gridDim.x) {
    const int d = dests[i];
    if (d >= k && d < k + nr) continue;  // in-band: the caller's band write
    copy_row_l2(a + (i64)d * ld, a + (i64)(k + i) * ld, w);
  }
}

// the FFMA instance: kernel 6's FFMA routine striding over the tiles
template <bool kTma>
__global__ void __launch_bounds__(gemm::ffma::kThreads, gemm::ffma::kMinBlocks)
    gemmx_ffma_kernel(const __grid_constant__ CUtensorMap tmA,
                      const __grid_constant__ CUtensorMap tmB,
                      const __grid_constant__ gemm::ffma::Args g, uint32_t* a, int w, int nr,
                      int k, const int* __restrict__ glist, const int* __restrict__ dests,
                      uint32_t* __restrict__ pivrows) {
  using namespace gemm::ffma;
  extern __shared__ uint8_t gemmx_ffma_smem[];
  const Ring ring = ring_init(gemmx_ffma_smem);
  const int tiles_m = (g.M + kBM - 1) / kBM, tiles_n = (g.N + kBN - 1) / kBN;
  const int tiles = (int)tile_count(g.M, g.N);
  uint32_t it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int m0, n0;
    tile_origin(t, tiles_m, tiles_n, m0, n0);
    run_tile<kTma>(g, &tmA, &tmB, ring, it, m0, n0);
  }
  // nr is the same for every block, so no barrier is left waiting
  if (nr > 0) exchange(a, g.ldc, w, nr, k, glist, dests, pivrows);
}

// the bf16-operand instances: kernel 6's Hopper routine on the tiles
template <typename TC, typename E>
__global__ void __launch_bounds__(gemm::sm90::kThreads, 1)
    gemmx_sm90_kernel(const __grid_constant__ CUtensorMap tmA,
                      const __grid_constant__ CUtensorMap tmB, int M, int N, int K, TC* C,
                      i64 ld, E* a, int w, int nr, int k, const int* __restrict__ glist,
                      const int* __restrict__ dests, E* __restrict__ pivrows) {
  gemm::sm90::run<TC, true>(&tmA, &tmB, nullptr, M, N, K, C, ld);
  if (nr > 0) exchange(a, ld, w, nr, k, glist, dests, pivrows);
}

// one cooperative launch of `kern` (threads, smem), as many blocks as the
// work has tiles or band rows, at most as many as can be resident
int launch_coop(const void* kern, int threads, int smem, long long tiles, int nr, void** args,
                cudaStream_t st) {
  const int nsm = sm_count();
  int occ = 0;
  if (smem > 0) {
    cudaError_t err = dyn_smem(kern, smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long want = tiles > nr ? tiles : nr;
  const int G = (int)(want < (long long)occ * nsm ? want : (long long)occ * nsm);
  if (G < 1) return (int)cudaGetLastError();  // nothing to do
  err = cudaLaunchCooperativeKernel(kern, dim3(G), dim3(threads), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TC, typename E>
int launch_sm90(int M, int N, int K, const void* A, i64 lda, const void* B, i64 ldb,
                void* a_, i64 ld, int r0, int c0, int w, int nr, int k, const int* glist,
                const int* dests, void* piv_, cudaStream_t st) {
  namespace s9 = gemm::sm90;
  CUtensorMap ta, tb;
  int err = s9::encode_operands(&ta, &tb, M, N, K, A, lda, B, ldb);
  if (err) return err;
  E* a = (E*)a_;
  TC* C = (TC*)a_ + (i64)r0 * ld + c0;
  E* pivrows = (E*)piv_;
  void* args[] = {&ta, &tb, &M, &N, &K, &C, &ld, &a, &w, &nr, &k, &glist, &dests, &pivrows};
  return launch_coop((const void*)gemmx_sm90_kernel<TC, E>, s9::kThreads, s9::kSmem,
                     s9::tile_count(M, N, K), nr, args, st);
}

int launch_ffma(int M, int N, int K, const void* A, i64 lda, const void* B, i64 ldb,
                void* a_, i64 ld, int r0, int c0, int w, int nr, int k, const int* glist,
                const int* dests, void* piv_, cudaStream_t st) {
  namespace ff = gemm::ffma;
  ff::Args g{M, N, K, (const float*)A, lda, (const float*)B, ldb,
             (float*)a_ + (i64)r0 * ld + c0, ld, nullptr, 0};
  CUtensorMap ta, tb;
  bool tma;
  int err = ff::operand_maps(g, &ta, &tb, tma);
  if (err) return err;
  uint32_t* a = (uint32_t*)a_;
  uint32_t* pivrows = (uint32_t*)piv_;
  void* args[] = {&ta, &tb, &g, &a, &w, &nr, &k, &glist, &dests, &pivrows};
  const void* kern = tma ? (const void*)gemmx_ffma_kernel<true>
                         : (const void*)gemmx_ffma_kernel<false>;
  return launch_coop(kern, ff::kThreads, ff::kSmem, ff::tile_count(M, N), nr, args, st);
}

}  // namespace

// mode 0: bf16 operands on the tensor cores (A and B as mpf_trailing_sub's
// mode 0 takes them); 2: fp32 operands on FFMA.  The matrix a is fp32, or bf16 when c_bf16 (mode 0 only); row stride ld, row
// width w (the exchange copies w elements a row).  nr = 0: no exchange
// (glist, dests and pivrows unused).
MPF_API int mpf_gemmx(int mode, int M, int N, int K, const void* A, i64 lda, const void* B,
                      i64 ldb, void* a, int c_bf16, i64 ld, int r0, int c0, int w, int nr,
                      int k, const int* glist, const int* dests, void* pivrows,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  typedef __nv_bfloat16 bf;
  if (c_bf16) {
    if (mode != 0) return (int)cudaErrorInvalidValue;
    return launch_sm90<bf, uint16_t>(M, N, K, A, lda, B, ldb, a, ld, r0, c0, w, nr, k, glist,
                                     dests, pivrows, st);
  }
  if (mode == 0)
    return launch_sm90<float, uint32_t>(M, N, K, A, lda, B, ldb, a, ld, r0, c0, w, nr, k,
                                        glist, dests, pivrows, st);
  if (mode == 2)
    return launch_ffma(M, N, K, A, lda, B, ldb, a, ld, r0, c0, w, nr, k, glist, dests, pivrows,
                       st);
  return (int)cudaErrorInvalidValue;
}
