// Kernel 2 (A2): pivot-row gather, no-pivot refactor of the diagonal block
// with fused inverses, and the finished row block.
//
// Replaces: mpf_tpu/ops/panel_fused.py:_rowblock_kernel (via
// rowblock_assemble), whose diagonal math is _npv_inv_values:
//   staged = slab[glist, :]                              (r x bc)
//   LU, L^{-1}, U^{-1}, info = no-pivot LU of staged[:, jj0:jj0+r]  (fp32)
//   rowblock = [staged[:, :jj0] | LU | L^{-1} staged[:, jj0+r:]]
// info is the 1-based column of the first exactly-zero pivot, 0 if none.
// Storage type T is the slab's: fp32, or bf16 under ALL_BF16.  For bf16 the
// rounding points are the TPU kernel's (panel_fused.py:148-174): the
// diagonal LU and both inverses run in fp32 on the gathered bf16 values; LU
// and U^{-1} are stored rounded to bf16; L^{-1} is rounded to bf16 BEFORE
// the U12 product (fp32 accumulation), and U12 is rounded to bf16.
//
// What bounds it on the H100: the r-step elimination chain of one r x r
// block (r = 128) and the back substitution's chain — latency — plus an
// r x r x bc product for U12, which is small.
//
// Design: two launches behind one entry point.
// (1) diag_kernel, the elimination: npv_tile::eliminate (csrc/npv_tile.cuh,
// shared with kernels 8 and 8b) on the gathered rows, one block of 1024
// threads, the block in registers, one block barrier a step; LU goes to the
// row block, L^{-1} and U (fp32) to a scratch buffer.
// (2) tail_kernel, two kinds of blocks side by side: ceil(r / 32) blocks of
// the back substitution (npv_tile::bs_stage, then one warp's
// npv_tile::bs_chain) and, beside them, one block per 32-row, 64-column
// tile of the row block, which copies the gathered L part left of the panel
// and computes U12 = L^{-1} staged right of it with fp32 FFMA, four
// independent chains a thread.  A back-substitution block runs one warp's
// chain (a warp a block, because the chain — r(r - 1)/2 dependent fused
// multiply-adds and r divides for the last column — is latency).  Column c could start once U's
// leading (c + 1) x (c + 1) block is final, after step c, but the last
// column needs the last pivot, so starting earlier shortens nothing.
#include <algorithm>

#include "npv_tile.cuh"

namespace {

using npv_tile::kN;
using npv_tile::kP;
constexpr int kDiagThreads = npv_tile::kThreads;
constexpr int kTileCols = 64;       // tail_kernel: a U12 block's tile
constexpr int kTileRows = 32;
constexpr int kTailThreads = 256;
constexpr int kBsCols = 32;         // tail_kernel: a back-substitution block's columns

// row i, column c of the gathered diagonal block, in fp32
template <typename T>
struct GatheredRows {
  const T* slab;
  i64 ld;
  const int* glist;
  int jj0;
  __device__ __forceinline__ float at(int i, int c) const {
    return to_f32(slab[(i64)glist[i] * ld + jj0 + c]);
  }
};

template <typename T>
__global__ void __launch_bounds__(kDiagThreads, 1)
    diag_kernel(int r, const T* __restrict__ slab, i64 ld,
                const int* __restrict__ glist, int jj0, int bc,
                T* __restrict__ rowblock, float* __restrict__ linv,
                float* __restrict__ ubuf, int* __restrict__ info_out) {
  extern __shared__ __align__(16) float dsm[];
  float* sl = dsm;             // kN x kP: the block, then L (left) and U (right)
  float* sw = dsm + kN * kP;   // kN x kP: W at the end
  __shared__ __align__(16) float mcol[2][kN];
  __shared__ int info;
  const int tid = threadIdx.x;
  float W[4][4];
  npv_tile::eliminate(r, GatheredRows<T>{slab, ld, glist, jj0}, W, sl, mcol, &info);
  // W to shared memory, U beside L; then everything out, coalesced
  npv_tile::tile_to_shared(W, sl, sw);
  __syncthreads();
  if (tid == 0) *info_out = info;
  for (int e = tid; e < r * r; e += kDiagThreads) {
    const int i = e / r, c = e - i * r;
    rowblock[(i64)i * bc + jj0 + c] = from_f32<T>(sl[i * kP + c]);
    const float x = sw[i * kP + c];
    linv[e] = c < i ? x : (c == i ? 1.0f : 0.0f);
    ubuf[e] = x;
  }
}

// rows [i0, i0 + 32) of the 64-column tile at c0: the gathered values left
// of the panel, U12 right of it.  Each U12 entry is one fused multiply-add
// chain in ascending k from 0; a thread runs four of them side by side.
template <typename T>
__device__ void u12_tile(int r, const T* __restrict__ slab, i64 ld,
                         const int* __restrict__ glist, int jj0, int bc, int c0, int i0,
                         const float* __restrict__ linv, T* __restrict__ rowblock,
                         float* sm) {
  const int nc = min(kTileCols, bc - c0), nr = min(kTileRows, r - i0);
  if (c0 >= jj0 && c0 + nc <= jj0 + r) return;  // tile inside the panel
  float* ls = sm;                      // kTileRows x r: rows of L^{-1}, rounded to T
  float* st = sm + kTileRows * r;      // r x kTileCols: the gathered rows
  const int tid = threadIdx.x;
#pragma unroll 4
  for (int e = tid; e < nr * r; e += kTailThreads) ls[e] = round_to<T>(linv[(i64)i0 * r + e]);
#pragma unroll 4
  for (int e = tid; e < r * nc; e += kTailThreads) {
    const int i = e / nc, c = e - i * nc;
    st[i * kTileCols + c] = to_f32(slab[(i64)glist[i] * ld + c0 + c]);
  }
  __syncthreads();
  constexpr int kPer = kTileRows * kTileCols / kTailThreads;
#pragma unroll
  for (int q0 = 0; q0 < kPer; q0 += 4) {
    int il[4], cl[4];
    float acc[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int e = tid + (q0 + t) * kTailThreads;
      il[t] = e / kTileCols;
      cl[t] = e % kTileCols;
      acc[t] = 0.0f;
    }
    for (int k = 0; k < r; ++k) {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        acc[t] = fmaf(ls[il[t] * r + k], st[k * kTileCols + cl[t]], acc[t]);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int i = i0 + il[t], gc = c0 + cl[t];
      if (il[t] >= nr || cl[t] >= nc) continue;
      if (gc < jj0)
        rowblock[(i64)i * bc + gc] = from_f32<T>(st[i * kTileCols + cl[t]]);
      else if (gc >= jj0 + r)
        rowblock[(i64)i * bc + gc] = from_f32<T>(acc[t]);
    }
  }
}

// columns [c0, c0 + 32) of U^{-1} from the U in ubuf: the block stages
// the operands, one warp runs the chain (npv_tile.cuh)
template <typename T>
__device__ void back_substitution(int r, int c0, const float* __restrict__ ubuf,
                                  T* __restrict__ uinv, float* sm) {
  float* us = sm;              // kN x kN: U right of the diagonal, zero elsewhere
  float* ud = us + kN * kN;    // kN: U's diagonal
  float* ys = ud + kN;         // kBsCols x kYs: U^{-1}, a lane's column a row
  const int tid = threadIdx.x;
  npv_tile::bs_stage(r, npv_tile::RowMajor{ubuf, r}, us, ud, ys, kBsCols, tid,
                     kTailThreads);
  __syncthreads();
  if (tid < 32) npv_tile::bs_chain<T>(r, c0, us, ud, ys, uinv, tid);
}

// blocks [0, nbs): the back substitution's column groups; the rest: U12 tiles
template <typename T>
__global__ void __launch_bounds__(kTailThreads)
    tail_kernel(int r, const T* __restrict__ slab, i64 ld,
                const int* __restrict__ glist, int jj0, int bc, int nbs, int ntx,
                const float* __restrict__ linv, const float* __restrict__ ubuf,
                T* __restrict__ rowblock, T* __restrict__ uinv) {
  extern __shared__ __align__(16) float tsm[];
  const int bid = blockIdx.x;
  if (bid < nbs) {
    back_substitution<T>(r, bid * kBsCols, ubuf, uinv, tsm);
  } else {
    const int t = bid - nbs;
    u12_tile<T>(r, slab, ld, glist, jj0, bc, (t % ntx) * kTileCols, (t / ntx) * kTileRows,
                linv, rowblock, tsm);
  }
}

template <typename T>
int launch(int r, int bc, const T* slab, i64 ld, const int* glist, int jj0, T* rowblock,
           T* uinv, float* scratch, int* info, cudaStream_t st) {
  float* linv = scratch;           // r x r
  float* ubuf = scratch + r * r;   // r x r
  const size_t smem1 = (size_t)2 * kN * kP * sizeof(float);
  cudaError_t err = dyn_smem((const void*)diag_kernel<T>, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  diag_kernel<T><<<1, kDiagThreads, smem1, st>>>(r, slab, ld, glist, jj0, bc, rowblock, linv,
                                                 ubuf, info);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nbs = (r + kBsCols - 1) / kBsCols;
  const int ntx = (bc + kTileCols - 1) / kTileCols, nty = (r + kTileRows - 1) / kTileRows;
  const size_t smem2 = std::max((size_t)(kTileRows * r + r * kTileCols),
                                (size_t)(kN * kN + kN + kBsCols * npv_tile::kYs)) * sizeof(float);
  err = dyn_smem((const void*)tail_kernel<T>, (int)smem2);
  if (err != cudaSuccess) return (int)err;
  tail_kernel<T><<<nbs + ntx * nty, kTailThreads, smem2, st>>>(
      r, slab, ld, glist, jj0, bc, nbs, ntx, linv, ubuf, rowblock, uinv);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 != 0: slab, rowblock and uinv are bf16 (ALL_BF16), else fp32;
// scratch is an fp32 buffer of 2 r^2 values (L^{-1}, then U) in both.
MPF_API int mpf_rowblock(int r, int bc, const void* slab, i64 ld, const int* glist,
                         int jj0, void* rowblock, void* uinv, float* scratch, int* info,
                         int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (r > 128) return (int)cudaErrorInvalidValue;
  typedef __nv_bfloat16 bf;
  if (bf16)
    return launch<bf>(r, bc, (const bf*)slab, ld, glist, jj0, (bf*)rowblock, (bf*)uinv,
                      scratch, info, st);
  return launch<float>(r, bc, (const float*)slab, ld, glist, jj0, (float*)rowblock,
                       (float*)uinv, scratch, info, st);
}
