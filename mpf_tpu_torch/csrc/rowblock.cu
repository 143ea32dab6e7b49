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
// (1) diag_kernel, the elimination: one block of 1024 threads, the block in
// registers.  Warp w owns columns w, w + 32, w + 64, w + 96 and lane t rows
// t, t + 32, t + 64, t + 96; each thread holds its 4 x 4 entries of one
// working tile W, which carries U in and right of the diagonal and L^{-1}
// left of it: at step j, row i > j updates its columns right of j (U) and
// its L^{-1} columns up to j — together every column — against row j, which
// holds U right of j and L^{-1} up to j (1 at j).  Row j of a warp's columns
// lies in the warp's own lane j mod 32, so every warp reads the pivot row by
// shuffles, with no barrier.  Column j + 1 lies in one warp, which updates
// it first, takes the pivot from its own lane, divides the column (4 true
// divides a lane) and publishes the multipliers in a double-buffered shared
// column (one 16-byte word a lane) before updating its other columns: one
// block barrier a step, the divides beside the other warps' updates.  A
// step is then one shared load, 4 shuffles and one fused multiply-add per
// entry, with no index arithmetic; row groups above the pivot are skipped
// whole.  The element operations and their order are those of
// _npv_inv_values, so LU and L^{-1} are bitwise the plain version's.  LU
// goes to the row block, L^{-1} and U (fp32) to a scratch buffer.
// (2) tail_kernel, two kinds of blocks side by side: ceil(r / 32) blocks of
// the back substitution and, beside them, one block per 32-row, 64-column
// tile of the row block, which copies the gathered L part left of the panel
// and computes U12 = L^{-1} staged right of it with fp32 FFMA, four
// independent chains a thread.  A back-substitution block is one warp, one
// column of U^{-1} a lane, rows from the bottom, each entry's chain in
// ascending k over every k > i, the order of a row-by-row substitution, so
// its bits are that substitution's, inf and NaN included (the terms with
// k > c multiply a zero); a warp a block, because the chain — r(r - 1)/2
// dependent fused multiply-adds and r divides for the last column — is
// latency.  Column c could start once U's leading (c + 1) x (c + 1) block
// is final, after step c, but the last column needs the last pivot, so
// starting earlier shortens nothing.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kN = 128;             // the largest r; the register tile covers kN x kN
constexpr int kP = kN + 1;          // padded row of the shared staging tiles
constexpr int kDiagThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileCols = 64;       // tail_kernel: a U12 block's tile
constexpr int kTileRows = 32;
constexpr int kTailThreads = 256;
constexpr int kBsCols = 32;         // tail_kernel: a back-substitution block's columns

// the multipliers of step p (column p, owned by the calling warp, register
// kb of the tile: p >> 5), into `mc` (row lane + 32 a at lane * 4 + a), and
// L's column p into `sl`; the pivot is row p's entry, in lane p & 31,
// register p >> 5
template <int kb>
__device__ __forceinline__ void multipliers(const float (&W)[4][4], int p, int r, int lane,
                                            float* mc, float* sl, int* info) {
  const float pv = __shfl_sync(kFull, W[kb][kb], p & 31);
  const float safe = pv == 0.0f ? 1.0f : pv;
  if (lane == 0 && pv == 0.0f && *info == 0) *info = p + 1;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = lane + 32 * a;
    const float m = i > p && i < r ? div_rn(W[a][kb], safe) : 0.0f;
    mc[lane * 4 + a] = m;
    if (i > p && i < r) sl[i * kP + p] = m;
  }
}

// step j's update of column register b: rows below j of row group kb (the
// group holding row j), every row of the later groups; the groups before
// kb are done.  Column j itself (register kb of warp j & 31, `own`):
// L^{-1}[i][j] starts from 0 (and u[kb] is L^{-1}[j][j] = 1)
template <int kb, int b>
__device__ __forceinline__ void update_column(float (&W)[4][4], const float (&m)[4], float ub,
                                              int lane, int j, bool own) {
  const bool act = lane + 32 * kb > j;
  const float nv = fmaf(-m[kb], ub, b == kb && own ? 0.0f : W[kb][b]);
  W[kb][b] = act ? nv : W[kb][b];
#pragma unroll
  for (int a = kb + 1; a < 4; ++a) W[a][b] = fmaf(-m[a], ub, b == kb && own ? 0.0f : W[a][b]);
}

template <int kb, int skip>
__device__ __forceinline__ void update_columns(float (&W)[4][4], const float (&m)[4],
                                               const float (&u)[4], int lane, int j, bool own) {
  if (skip != 0) update_column<kb, 0>(W, m, u[0], lane, j, own);
  if (skip != 1) update_column<kb, 1>(W, m, u[1], lane, j, own);
  if (skip != 2) update_column<kb, 2>(W, m, u[2], lane, j, own);
  if (skip != 3) update_column<kb, 3>(W, m, u[3], lane, j, own);
}

// steps j in [32 kb, 32 kb + 32): row and column j lie in register kb of
// lane / warp j & 31; one block barrier a step.  The warp owning column
// j + 1 updates it first, then divides and publishes the next multipliers,
// then updates its other columns: the divides overlap the other warps'
// updates
template <int kb>
__device__ __forceinline__ void elim_steps(float (&W)[4][4], int r, int lane, int w,
                                           float (*mcol)[kN], float* sl, int* info) {
  constexpr int kn = kb < 3 ? kb + 1 : 3;
  const int jend = min(r, 32 * kb + 32);
  for (int j = 32 * kb; j < jend; ++j) {
    const int jl = j & 31;
    const float* mc = mcol[j & 1];
    float m[4], u[4];
    const float4 m4 = reinterpret_cast<const float4*>(mc)[lane];
    m[0] = m4.x, m[1] = m4.y, m[2] = m4.z, m[3] = m4.w;
#pragma unroll
    for (int b = 0; b < 4; ++b) u[b] = __shfl_sync(kFull, W[kb][b], jl);
    const bool own = w == jl;
    if (own) u[kb] = 1.0f;
    const int p = j + 1;
    if (p < r && w == (p & 31)) {
      if (kb < 3 && p == 32 * kb + 32) {  // column p lies in register kb + 1
        update_column<kb, kn>(W, m, u[kn], lane, j, own);
        multipliers<kn>(W, p, r, lane, mcol[p & 1], sl, info);
        update_columns<kb, kn>(W, m, u, lane, j, own);
      } else {
        update_column<kb, kb>(W, m, u[kb], lane, j, own);
        multipliers<kb>(W, p, r, lane, mcol[p & 1], sl, info);
        update_columns<kb, kb>(W, m, u, lane, j, own);
      }
    } else {
      update_columns<kb, -1>(W, m, u, lane, j, own);
    }
    __syncthreads();
  }
}

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
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  for (int e = tid; e < kN * kN; e += kDiagThreads) {
    const int i = e >> 7, c = e & (kN - 1);
    sl[i * kP + c] = i < r && c < r ? to_f32(slab[(i64)glist[i] * ld + jj0 + c]) : 0.0f;
  }
  if (tid == 0) info = 0;
  __syncthreads();
  float W[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) W[a][b] = sl[(lane + 32 * a) * kP + w + 32 * b];
  __syncthreads();  // sl now takes L
  if (w == 0) multipliers<0>(W, 0, r, lane, mcol[0], sl, &info);
  __syncthreads();
  elim_steps<0>(W, r, lane, w, mcol, sl, &info);
  elim_steps<1>(W, r, lane, w, mcol, sl, &info);
  elim_steps<2>(W, r, lane, w, mcol, sl, &info);
  elim_steps<3>(W, r, lane, w, mcol, sl, &info);
  // W to shared memory, U beside L; then everything out, coalesced
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = lane + 32 * a, c = w + 32 * b;
      sw[i * kP + c] = W[a][b];
      if (c >= i) sl[i * kP + c] = W[a][b];
    }
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

// fmaf chain over four terms, in order
__device__ __forceinline__ float fma4(float acc, float4 u, float4 y) {
  acc = fmaf(u.x, y.x, acc);
  acc = fmaf(u.y, y.y, acc);
  acc = fmaf(u.z, y.z, acc);
  return fmaf(u.w, y.w, acc);
}

// columns [c0, c0 + 32) of U^{-1}, lane c - c0 a column, rows from the
// bottom.  Row i's chain runs over whole 16-byte groups of k from the one
// holding k = i + 1: U (broadcast) is zero left of and on the diagonal and
// past r, and the lane's own column (a 132-float row: 4 wavefronts a word)
// is zero where not yet computed, so the terms k <= i are fmaf(0, 0, acc):
// the chain over k = i + 1 .. r - 1 in ascending order, unchanged.  Each
// group is loaded one ahead of its fused multiply-adds; the next row's
// first group is loaded before this row's divide, and y[i] goes into it
// from a register.
template <typename T>
__device__ void back_substitution(int r, int c0, const float* __restrict__ ubuf,
                                  T* __restrict__ uinv, float* sm) {
  constexpr int kYs = kN + 4;
  float* us = sm;              // kN x kN: U right of the diagonal, zero elsewhere
  float* ud = us + kN * kN;    // kN: U's diagonal
  float* ys = ud + kN;         // kBsCols x kYs: U^{-1}, a lane's column a row
  const int tid = threadIdx.x;
#pragma unroll 4
  for (int e = tid; e < kN * kN; e += kTailThreads) {
    const int i = e >> 7, k = e & (kN - 1);
    us[e] = i < r && k < r && k > i ? ubuf[i * r + k] : 0.0f;
  }
  for (int i = tid; i < r; i += kTailThreads) ud[i] = ubuf[i * r + i];
  for (int e = tid; e < kBsCols * kYs; e += kTailThreads) ys[e] = 0.0f;
  __syncthreads();
  if (tid >= 32) return;
  const int cl = tid, c = c0 + cl;
  float* yc = ys + cl * kYs;
  const float4* y4 = reinterpret_cast<const float4*>(yc);
  const int ng = (r + 3) >> 2;  // groups of k
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float ynew = 0.0f;            // y[i + 1][c], just computed
  int g0 = r >> 2;              // the group holding k = i + 1
  float4 pu = g0 < ng ? reinterpret_cast<const float4*>(us + (r - 1) * kN)[g0] : zero;
  float4 py = g0 < ng ? y4[g0] : zero;
  for (int i = r - 1; i >= 0; --i) {
    const float4* u4 = reinterpret_cast<const float4*>(us + i * kN);
    float acc = 0.0f;
    if (g0 < ng) {
      const int s = (i + 1) & 3;
      float4 ua = pu, ya = py;
      ya.x = s == 0 ? ynew : ya.x;
      ya.y = s == 1 ? ynew : ya.y;
      ya.z = s == 2 ? ynew : ya.z;
      ya.w = s == 3 ? ynew : ya.w;
#pragma unroll 2
      for (int g = g0 + 1; g < ng; ++g) {
        const float4 un = u4[g], yn = y4[g];
        acc = fma4(acc, ua, ya);
        ua = un, ya = yn;
      }
      acc = fma4(acc, ua, ya);
    }
    // row i - 1's first group, before the divide
    g0 = i >> 2;
    if (i > 0) {
      pu = reinterpret_cast<const float4*>(us + (i - 1) * kN)[g0];
      py = y4[g0];
    }
    const float uii = ud[i];
    ynew = div_rn(__fsub_rn(c == i ? 1.0f : 0.0f, acc), uii == 0.0f ? 1.0f : uii);
    yc[i] = ynew;
  }
  __syncwarp();
  if (c < r)
    for (int i = 0; i < r; ++i) uinv[(i64)i * r + c] = from_f32<T>(yc[i]);
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
                                (size_t)(kN * kN + kN + kBsCols * (kN + 4))) * sizeof(float);
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
