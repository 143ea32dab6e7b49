// The no-pivot LU of an r x r block (r <= 128) in registers, and U^{-1} by
// back substitution: kernel 2's diagonal routines (csrc/rowblock.cu), shared
// with kernels 8 and 8b (csrc/npv.cu), which compute the same function on r
// contiguous rows of the diagonal block.
//
// Function (mpf_tpu/ops/panel_fused.py:_npv_inv_values, and
// panel_pallas.py:_npv_inv_kernel), in fp32:
//   for j < r: info = first j + 1 with pivot b[j, j] == 0;
//              mult_i = b[i, j] / pivot (i > j, true divide; 1 for a zero
//              pivot);
//              b[i, c] -= mult_i b[j, c] (c > j, one fused multiply-add);
//              b[i, j] = mult_i;
//              L^{-1}[i, :] -= mult_i L^{-1}[j, :] (Gauss-Jordan);
//   U^{-1} by back substitution, rows from the bottom:
//       Y[i, c] = (delta_ic - sum_{k>i} U[i, k] Y[k, c]) / U[i, i],
//       each sum one chain in ascending k.
//
// What bounds it on the H100: the r-step dependent chain of the
// elimination (one block barrier a step) and the back substitution's chain
// (r(r - 1)/2 dependent fused multiply-adds for the last column): latency,
// not flops (4 r^3 / 3) or bytes (4 r^2 floats).
//
// The elimination: one block of 1024 threads, the block in registers.  Warp
// w owns columns w, w + 32, w + 64, w + 96 and lane t rows t, t + 32, t + 64,
// t + 96; each thread holds its 4 x 4 entries of one working tile W, which
// carries U in and right of the diagonal and L^{-1} left of it: at step j,
// row i > j updates its columns right of j (U) and its L^{-1} columns up to
// j — together every column — against row j, which holds U right of j and
// L^{-1} up to j (1 at j).  Row j of a warp's columns lies in the warp's own
// lane j mod 32, so every warp reads the pivot row by shuffles, with no
// barrier.  Column j + 1 lies in one warp, which updates it first, takes
// the pivot from its own lane, divides the column (4 true divides a lane)
// and publishes the multipliers in a double-buffered shared column (one
// 16-byte word a lane) before updating its other columns: one block barrier
// a step, the divides beside the other warps' updates.  A step is then one
// shared load, 4 shuffles and one fused multiply-add per entry, with no
// index arithmetic; row groups above the pivot are skipped whole.  The
// element operations and their order are those of _npv_inv_values, so LU
// and L^{-1} are bitwise the plain versions'.
//
// The back substitution: one warp, one column of U^{-1} a lane, rows from
// the bottom, each entry's chain in ascending k over every k > i, the order
// of a row-by-row substitution, so its bits are that substitution's, inf
// and NaN included (the terms with k > c multiply a zero).
#pragma once

#include "common.cuh"

namespace npv_tile {
namespace {

constexpr int kN = 128;             // the largest r; the register tile covers kN x kN
constexpr int kP = kN + 1;          // padded row of the shared staging tiles
constexpr int kThreads = 1024;      // the elimination's block
constexpr int kYs = kN + 4;         // a back-substitution lane's column, padded
constexpr unsigned kFull = 0xffffffffu;

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

// The elimination of the r x r block whose row i, column c is
// rows.at(i, c) (fp32), by the kThreads threads of the block: on return W
// holds the thread's entries of the final tile (row lane + 32 a, column
// warp + 32 b: U in and right of the diagonal, L^{-1} left of it), sl
// (kN x kP) holds L's multipliers strictly below the diagonal and *info the
// first zero pivot (1-based, 0 if none); mcol is the double-buffered
// multiplier column.  The block's threads are synchronised on return.
template <class Rows>
__device__ __forceinline__ void eliminate(int r, const Rows& rows, float (&W)[4][4], float* sl,
                                          float (*mcol)[kN], int* info) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  for (int e = tid; e < kN * kN; e += kThreads) {
    const int i = e >> 7, c = e & (kN - 1);
    sl[i * kP + c] = i < r && c < r ? rows.at(i, c) : 0.0f;
  }
  if (tid == 0) *info = 0;
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) W[a][b] = sl[(lane + 32 * a) * kP + w + 32 * b];
  __syncthreads();  // sl now takes L
  if (w == 0) multipliers<0>(W, 0, r, lane, mcol[0], sl, info);
  __syncthreads();
  elim_steps<0>(W, r, lane, w, mcol, sl, info);
  elim_steps<1>(W, r, lane, w, mcol, sl, info);
  elim_steps<2>(W, r, lane, w, mcol, sl, info);
  elim_steps<3>(W, r, lane, w, mcol, sl, info);
}

// W to shared memory: all of it into sw (kN x kP), and U beside L in sl,
// which then holds the packed LU; the caller synchronises before reading
__device__ __forceinline__ void tile_to_shared(const float (&W)[4][4], float* sl, float* sw) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = lane + 32 * a, c = w + 32 * b;
      sw[i * kP + c] = W[a][b];
      if (c >= i) sl[i * kP + c] = W[a][b];
    }
}

// fmaf chain over four terms, in order
__device__ __forceinline__ float fma4(float acc, float4 u, float4 y) {
  acc = fmaf(u.x, y.x, acc);
  acc = fmaf(u.y, y.y, acc);
  acc = fmaf(u.z, y.z, acc);
  return fmaf(u.w, y.w, acc);
}

// U's entry (i, k) of an r x r row-major fp32 buffer (a bs_stage source)
struct RowMajor {
  const float* p;
  int r;
  __device__ __forceinline__ float operator()(int i, int k) const { return p[i * r + k]; }
};

// The back substitution's operands, by `nthr` threads from thread `t0`:
// us (kN x kN) U strictly right of the diagonal, zero elsewhere and past
// r; ud (kN) U's diagonal; `nys` lanes' columns of ys (kYs each) zeroed.
// u(i, k) is U's entry (read only for k >= i, i, k < r).  The caller
// synchronises before the chains read them.
template <class U>
__device__ __forceinline__ void bs_stage(int r, const U& u, float* us, float* ud, float* ys,
                                         int nys, int t0, int nthr) {
#pragma unroll 4
  for (int e = t0; e < kN * kN; e += nthr) {
    const int i = e >> 7, k = e & (kN - 1);
    us[e] = i < r && k < r && k > i ? u(i, k) : 0.0f;
  }
  for (int i = t0; i < r; i += nthr) ud[i] = u(i, i);
  for (int e = t0; e < nys * kYs; e += nthr) ys[e] = 0.0f;
}

// columns [c0, c0 + 32) of U^{-1}, lane c - c0 a column, rows from the
// bottom, by one warp on bs_stage's operands (yc: this warp's 32 columns of
// ys), written to uinv (r x r, row-major) in T.  Row i's chain runs over
// whole 16-byte groups of k from the one holding k = i + 1: U (broadcast)
// is zero left of and on the diagonal and past r, and the lane's own
// column (a 132-float row: 4 wavefronts a word) is zero where not yet
// computed, so the terms k <= i are fmaf(0, 0, acc): the chain over
// k = i + 1 .. r - 1 in ascending order, unchanged.  Each group is loaded
// one ahead of its fused multiply-adds; the next row's first group is
// loaded before this row's divide, and y[i] goes into it from a register.
template <typename T>
__device__ __forceinline__ void bs_chain(int r, int c0, const float* us, const float* ud,
                                         float* ys, T* __restrict__ uinv, int lane) {
  const int c = c0 + lane;
  float* yc = ys + lane * kYs;
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

}  // namespace
}  // namespace npv_tile
