// Kernel 7: round-1 pre-pivoting panel LU (pivots only), the masked path's
// panel search.
//
// Replaces: mpf_tpu/ops/panel_pallas.py:_hgetf2t_kernel (via hgetf2_panel /
// hgetf2_panel_swaps).  For the full-height (m, r) panel whose diagonal sits
// at row `off`, in the panel dtype T (fp32, bf16 or fp16):
//   for j < r, d = off + j:
//     search: largest fp32 |value| of column j among rows at position >= d,
//             ties to the lowest position;
//     swap:   the winner takes position d, the row at d takes the winner's;
//     mult:   value / pivot in fp32, rounded to T (rows below d);
//     update: p - mult * u over the later columns, rounded to T with the
//             round points of ops/getf2.py:rank1_sub (bf16: product rounded
//             first; fp16: exact fp32 product, one fp32 subtract; fp32: one
//             fused multiply-add).
// Rows never move: each row carries its position.  The factors are
// discarded; out come piv (positions), the panel row map perm (position ->
// row), the composed map prev_perm[perm] and the 2r LASWP sources
// srcs = [perm[off + j], perm[piv[j]]].
//
// What bounds it on the H100: r sequential grid-wide pivot searches, not
// flops (~m r^2) or bytes (the panel is read once).  The m x r panel is far
// beyond one block's shared memory and every column's search needs every row.
//
// Design (that of strip_pivots.cu, without strips): one cooperative launch,
// at most one block per SM.  Each block keeps its row slice of the panel in
// T and its rows' positions in shared memory for the whole panel (16384 /
// 132 = 125 rows x 128 x 2 B = 32 KB for fp16), or in a global scratch slice
// when the slice does not fit.  Per column: a block max of a 64-bit key
// (|value| bits << 32 | inverted position), one record per block (key, row,
// the row's later-column values) in one of two alternating slots, ONE grid
// barrier, then every block reduces the records itself and updates its own
// rows.  A block overwrites a slot two columns later, after the barrier that
// every reader of the slot has passed.  One more barrier at the end makes
// the final row map visible for the LASWP sources.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
typedef unsigned long long u64;

__device__ __forceinline__ u64 umax64(u64 a, u64 b) { return a > b ? a : b; }

__device__ u64 block_max(u64 v, u64* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = umax64(v, __shfl_down_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? red[lane] : 0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = umax64(v, __shfl_down_sync(0xffffffffu, v, o));
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  v = red[32];
  __syncthreads();
  return v;
}

// p - m * u rounded to T (see the file comment)
template <typename T> __device__ __forceinline__ T rank1(float p, float m, float u);
template <> __device__ __forceinline__ float rank1<float>(float p, float m, float u) {
  return fmaf(-m, u, p);
}
template <> __device__ __forceinline__ __nv_bfloat16 rank1<__nv_bfloat16>(float p, float m,
                                                                          float u) {
  return from_f32<__nv_bfloat16>(__fsub_rn(p, round_to<__nv_bfloat16>(__fmul_rn(m, u))));
}
template <> __device__ __forceinline__ __half rank1<__half>(float p, float m, float u) {
  return from_f32<__half>(__fsub_rn(p, __fmul_rn(m, u)));
}

struct Work {  // per-launch scratch, carved out of one buffer by the host
  u64* keys;    // 2 slots x G
  int* rows;    // 2 slots x G
  float* vals;  // 2 slots x G x r
  void* panel;  // m x r of T when the row slices do not fit in shared memory
};

template <typename T, typename Tin>
__global__ void __launch_bounds__(kThreads)
    hgetf2_kernel(int m, int r, const Tin* __restrict__ in, i64 ld, int off,
                  const int* __restrict__ prev, int* __restrict__ piv,
                  int* __restrict__ perm, int* __restrict__ cperm,
                  int* __restrict__ srcs, Work w, int rpb) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ u64 red[33];
  __shared__ int s_win, s_loc;
  const int tid = threadIdx.x;
  const int b = blockIdx.x, G = gridDim.x;
  const int r0 = b * rpb;
  const int nrows = max(0, min(rpb, m - r0));
  const size_t rows4 = ((size_t)rpb * 4 + 15) & ~(size_t)15;
  int* poss = reinterpret_cast<int*>(dyn);                      // rpb positions
  float* ms = reinterpret_cast<float*>(dyn + rows4);            // rpb multipliers
  float* us = reinterpret_cast<float*>(dyn + 2 * rows4);        // r: the pivot row
  T* P = w.panel ? reinterpret_cast<T*>(w.panel) + (i64)r0 * r
                 : reinterpret_cast<T*>(dyn + 2 * rows4 + (((size_t)r * 4 + 15) & ~(size_t)15));

  for (int e = tid; e < nrows * r; e += kThreads) {
    int l = e / r, c = e % r;
    P[e] = from_f32<T>(to_f32(in[(i64)(r0 + l) * ld + c]));
  }
  for (int l = tid; l < nrows; l += kThreads) poss[l] = r0 + l;
  __syncthreads();

  for (int j = 0; j < r; ++j) {
    const int d = off + j;
    const int slot = (j & 1) * G;
    // ---- local candidate
    u64 best = 0;
    for (int l = tid; l < nrows; l += kThreads) {
      int p = poss[l];
      if (p >= d) {
        unsigned bits = __float_as_uint(fabsf(to_f32(P[l * r + j])));
        best = umax64(best, ((u64)bits << 32) | (u64)(0xFFFFFFFFu - (unsigned)p));
      }
    }
    best = block_max(best, red);
    if (tid == 0) w.keys[slot + b] = best;
    if (best != 0) {
      const int wpos = (int)(0xFFFFFFFFu - (unsigned)(best & 0xFFFFFFFFull));
      for (int l = tid; l < nrows; l += kThreads)
        if (poss[l] == wpos) s_loc = l;
      __syncthreads();
      const int l = s_loc;
      if (tid == 0) w.rows[slot + b] = r0 + l;
      for (int c = j + tid; c < r; c += kThreads)
        w.vals[(i64)(slot + b) * r + c] = to_f32(P[l * r + c]);
    }
    grid.sync();
    // ---- global winner: every block reduces the records itself
    u64 g = 0;
    for (int t = tid; t < G; t += kThreads) g = umax64(g, __ldcg(&w.keys[slot + t]));
    // g != 0: off + r <= m, so some row is at position d or below
    g = block_max(g, red);
    for (int t = tid; t < G; t += kThreads)
      if (__ldcg(&w.keys[slot + t]) == g) s_win = t;
    __syncthreads();
    const int o = __ldcg(&w.rows[slot + s_win]);
    const int cp = (int)(0xFFFFFFFFu - (unsigned)(g & 0xFFFFFFFFull));
    for (int c = j + tid; c < r; c += kThreads) us[c] = __ldcg(&w.vals[(i64)(slot + s_win) * r + c]);
    if (b == 0 && tid == 0) {
      piv[j] = cp;
      srcs[j] = o;
    }
    __syncthreads();
    // ---- swap positions, multipliers (fp32 divide rounded to T)
    const float pv = us[j];
    const float safe = pv == 0.0f ? 1.0f : pv;
    for (int l = tid; l < nrows; l += kThreads) {
      int p = poss[l];
      if (r0 + l == o)
        p = d;
      else if (p == d)
        p = cp;
      poss[l] = p;
      if (p > d) ms[l] = round_to<T>(__fdiv_rn(to_f32(P[l * r + j]), safe));
    }
    __syncthreads();
    // ---- rank-1 update of the later columns of the rows below d
    const int nc = r - j - 1;
    for (int e = tid; e < nrows * nc; e += kThreads) {
      int l = e / nc, c = j + 1 + e % nc;
      if (poss[l] > d) P[l * r + c] = rank1<T>(to_f32(P[l * r + c]), ms[l], us[c]);
    }
    __syncthreads();
  }
  // ---- row maps: perm[pos[row]] = row, composed[pos[row]] = prev[row]
  for (int l = tid; l < nrows; l += kThreads) {
    perm[poss[l]] = r0 + l;
    cperm[poss[l]] = prev[r0 + l];
  }
  grid.sync();
  if (b == 0)
    for (int j = tid; j < r; j += kThreads) srcs[r + j] = __ldcg(&perm[piv[j]]);
}

size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

struct Plan {
  int G, rpb;
  size_t smem, rec_bytes, panel_bytes;
};

Plan plan(int m, int r, int tbytes, int gmax, int nsm, int optin) {
  Plan p;
  p.G = min(nsm, gmax);
  p.rpb = (m + p.G - 1) / p.G;
  p.G = (m + p.rpb - 1) / p.rpb;
  size_t base = 2 * align16((size_t)p.rpb * 4) + align16((size_t)r * 4);
  size_t slice = (size_t)p.rpb * r * tbytes;
  p.rec_bytes = align16((size_t)2 * gmax * 8) + align16((size_t)2 * gmax * 4) +
                align16((size_t)2 * gmax * r * 4);
  // 1 KB of the opt-in limit is left for the kernel's static shared memory
  if (base + slice + 1024 <= (size_t)optin) {
    p.smem = base + slice;
    p.panel_bytes = 0;
  } else {
    p.smem = base;
    p.panel_bytes = align16((size_t)m * r * tbytes);
  }
  return p;
}

Plan device_plan(int m, int r, int tbytes, int gmax) {
  return plan(m, r, tbytes, gmax, sm_count(),
              device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin));
}

template <typename T, typename Tin>
int launch(int m, int r, const void* in, i64 ld, int off, const int* prev, int* piv,
           int* perm, int* cperm, int* srcs, void* work, int gmax, cudaStream_t stream) {
  Plan p = device_plan(m, r, (int)sizeof(T), gmax);
  auto kern = hgetf2_kernel<T, Tin>;
  cudaError_t err = dyn_smem((const void*)kern, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  int occ = 0;
  const int nsm = sm_count();
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kThreads, p.smem);
  if (err != cudaSuccess) return (int)err;
  if (occ * nsm < p.G) return (int)cudaErrorCooperativeLaunchTooLarge;
  unsigned char* base = (unsigned char*)work;
  Work w;
  w.keys = (u64*)base;
  w.rows = (int*)(base + align16((size_t)2 * gmax * 8));
  w.vals = (float*)((unsigned char*)w.rows + align16((size_t)2 * gmax * 4));
  w.panel = p.panel_bytes ? (void*)((unsigned char*)w.vals + align16((size_t)2 * gmax * r * 4))
                          : nullptr;
  const Tin* inp = (const Tin*)in;
  int rpb = p.rpb;
  void* args[] = {&m, &r, &inp, &ld, &off, &prev, &piv, &perm, &cperm, &srcs, &w, &rpb};
  err = cudaLaunchCooperativeKernel((void*)kern, dim3(p.G), dim3(kThreads), args, p.smem,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int tbytes_of(int kind) { return kind == 0 ? 4 : 2; }

}  // namespace

// Bytes of the scratch buffer mpf_hgetf2 needs (records, and the panel when
// its row slices do not fit in shared memory).  panel_kind: 0 fp32, 1 bf16,
// 2 fp16.
MPF_API long long mpf_hgetf2_work_bytes(int m, int r, int panel_kind, int gmax) {
  Plan p = device_plan(m, r, tbytes_of(panel_kind), gmax);
  return (long long)(p.rec_bytes + p.panel_bytes);
}

// in_same: 0 -> the input is the fp32 working panel (cast in-kernel, round
// to nearest even); 1 -> the input is already in the panel dtype.
MPF_API int mpf_hgetf2(int m, int r, const void* in, i64 ld, int in_same, int panel_kind,
                       int off, const int* prev, int* piv, int* perm, int* cperm, int* srcs,
                       void* work, int gmax, void* stream) {
  if (m <= 0 || r <= 0 || off < 0 || off + r > m) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (panel_kind == 0)
    return launch<float, float>(m, r, in, ld, off, prev, piv, perm, cperm, srcs, work, gmax,
                                st);
  if (panel_kind == 1)
    return in_same ? launch<__nv_bfloat16, __nv_bfloat16>(m, r, in, ld, off, prev, piv, perm,
                                                          cperm, srcs, work, gmax, st)
                   : launch<__nv_bfloat16, float>(m, r, in, ld, off, prev, piv, perm, cperm,
                                                  srcs, work, gmax, st);
  if (panel_kind == 2)
    return in_same ? launch<__half, __half>(m, r, in, ld, off, prev, piv, perm, cperm, srcs,
                                            work, gmax, st)
                   : launch<__half, float>(m, r, in, ld, off, prev, piv, perm, cperm, srcs,
                                           work, gmax, st);
  return (int)cudaErrorInvalidValue;
}
