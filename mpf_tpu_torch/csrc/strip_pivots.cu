// Kernel 1 (A1): strip-blocked virtual-pivoting panel LU (pivots only).
//
// Replaces: mpf_tpu/ops/panel_strip.py:_strip_pivot_kernel_gm (and the flat
// _strip_pivot_kernel, the same function), via strip_panel_pivots.  For the
// r-wide panel at column jj0 of the (m, bc) slab it chooses r partial pivots
// without moving rows: pos[row] is the row's current position, rows with
// pos < off are frozen, and 2^31-1 marks a dead row that never takes part.
// The slab is fp32 (converted to the panel dtype as it is loaded) or, under
// ALL_BF16, bf16 with a bf16 panel taken as stored: the same values give the
// same pivots either way.  Per 8-column strip, in fp32 over panel-dtype
// storage:
//   * search column j: largest |value| among rows with pos >= off + j — the
//     quant16 key (top 15 bits of |value|, bf16 panels) or the full |value|
//     (exact search); ties go to the lowest position;
//   * swap positions, multipliers = value / pivot (true divide; quant16
//     divides by the truncated pivot), rank-1 update of the strip's later
//     columns (one fused multiply-add, rounded once);
//   * the strip is stored back rounded to the panel dtype, and the later
//     strips get the deferred rank-8 update T -= (T S)(I+N)^{-1} M with the
//     multipliers M and (T S)(I+N)^{-1} rounded to the panel dtype.
// The factors are discarded; piv (positions), pos and glist (the original
// row landing on each diagonal position) escape.
//
// What bounds it on the H100: not flops (m r^2 per panel) and not bytes (the
// panel is read once): r sequential grid-wide pivot searches.  The m x r
// panel (4 MiB in bf16 at m = 16384) is far beyond one block's shared
// memory, and every column's search needs every row.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel, at most one
// block per SM, every block resident).  Each block keeps its row slice of
// the panel in shared memory in the panel dtype for the whole panel (125
// rows x 128 x 2 B = 32 KB at m = 16384 on 132 SMs), together with the
// active strip and its multipliers in fp32.  Per column: a block-level max
// of a 64-bit key (|value| bits << 32 | inverted position), one record per
// block (key, row, the row's strip values) written to a per-column slot,
// ONE grid barrier, then every block reduces the records itself and applies
// the swap and the strip update to its own rows.  The block owning the pivot
// row publishes that row's later-strip values and multipliers; one more
// grid barrier per strip makes them visible for the deferred update.  So a
// panel costs r + r/8 grid barriers.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kW = 8;
constexpr int kThreads = 256;
constexpr int kMaxR = 128;
constexpr int kSent = 0x7FFFFFFF;
typedef unsigned long long u64;

struct Rec {
  u64 key;
  int row;
  int pad;
  float vals[kW];
};

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

template <typename S, typename T>
__global__ void __launch_bounds__(kThreads)
    strip_kernel(int m, int r, const S* __restrict__ slab, i64 ld, int jj0,
                 int off, int* __restrict__ pos_io, int* __restrict__ piv,
                 int* __restrict__ glist, int quant16, Rec* rec,
                 float* pinfo, int rpb) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char dyn[];
  T* Ts = reinterpret_cast<T*>(dyn);                                // rpb x r
  float* sts = reinterpret_cast<float*>(dyn + (size_t)rpb * r * sizeof(T));  // rpb x 8
  float* mbs = sts + rpb * kW;                                      // rpb x 8
  int* poss = reinterpret_cast<int*>(mbs + rpb * kW);               // rpb

  __shared__ u64 red[33];
  __shared__ float prow[kW][kMaxR];   // pivot rows' later-strip values
  __shared__ float Us[kMaxR * kW];    // rounded (T S)(I+N)^{-1}
  __shared__ float mqp[kW][kW];       // rounded multipliers of the pivot rows
  __shared__ float nm[kW][kW], vinv[kW][kW], pw[kW][kW], pw2[kW][kW];
  __shared__ float ucol[kW];
  __shared__ int s_win;

  const int tid = threadIdx.x;
  const int b = blockIdx.x, G = gridDim.x;
  const int r0 = b * rpb;
  const int nrows = max(0, min(rpb, m - r0));
  const int stride = r + kW;  // pinfo floats per column
  const int nstrips = r / kW;

  for (int e = tid; e < nrows * r; e += kThreads) {
    int l = e / r, c = e % r;
    Ts[e] = from_f32<T>(to_f32(slab[(i64)(r0 + l) * ld + jj0 + c]));
  }
  for (int l = tid; l < nrows; l += kThreads) poss[l] = pos_io[r0 + l];
  __syncthreads();

  for (int s = 0; s < nstrips; ++s) {
    for (int e = tid; e < nrows * kW; e += kThreads) {
      int l = e / kW, c = e % kW;
      sts[e] = to_f32(Ts[l * r + s * kW + c]);
      mbs[e] = 0.0f;
    }
    __syncthreads();
    for (int jc = 0; jc < kW; ++jc) {
      const int j = s * kW + jc;
      const int d = off + j;
      // ---- local candidate: max key over this block's active rows
      u64 best = 0;
      for (int l = tid; l < nrows; l += kThreads) {
        int p = poss[l];
        if (p != kSent && p >= d) {
          unsigned bits = __float_as_uint(sts[l * kW + jc]) & 0x7FFFFFFFu;
          if (quant16) bits &= 0x7FFF0000u;
          best = umax64(best, ((u64)bits << 32) | (u64)(0xFFFFFFFFu - (unsigned)p));
        }
      }
      best = block_max(best, red);
      Rec* mine = rec + (i64)j * G + b;
      if (tid == 0) mine->key = best;
      if (best != 0) {
        int pw_pos = (int)(0xFFFFFFFFu - (unsigned)(best & 0xFFFFFFFFull));
        for (int l = tid; l < nrows; l += kThreads) {
          if (poss[l] == pw_pos) {
            mine->row = r0 + l;
#pragma unroll
            for (int c = 0; c < kW; ++c) mine->vals[c] = sts[l * kW + c];
          }
        }
      }
      grid.sync();
      // ---- global winner: every block reduces the records itself
      u64 g = 0;
      for (int t = tid; t < G; t += kThreads)
        g = umax64(g, __ldcg(&rec[(i64)j * G + t].key));
      g = block_max(g, red);
      for (int t = tid; t < G; t += kThreads)
        if (g != 0 && __ldcg(&rec[(i64)j * G + t].key) == g) s_win = t;
      __syncthreads();
      int o = -1;
      unsigned cp = (unsigned)d;
      float safe = 1.0f;
      if (g != 0) {
        const Rec* w = rec + (i64)j * G + s_win;
        o = __ldcg(&w->row);
        if (tid < kW) ucol[tid] = __ldcg(&w->vals[tid]);
        cp = 0xFFFFFFFFu - (unsigned)(g & 0xFFFFFFFFull);
      }
      __syncthreads();
      if (g != 0) {
        unsigned kbits = (unsigned)(g >> 32);
        float vj = ucol[jc];
        float pv = quant16 ? (signbit(vj) ? -__uint_as_float(kbits) : __uint_as_float(kbits))
                           : vj;
        safe = kbits == 0 ? 1.0f : pv;
      }
      // ---- swap positions, multipliers, in-strip rank-1 update
      for (int l = tid; l < nrows; l += kThreads) {
        int p = poss[l];
        if (r0 + l == o)
          p = d;
        else if (p == d)
          p = (int)cp;
        poss[l] = p;
        bool below = p != kSent && p > d;
        float mult = below ? __fdiv_rn(sts[l * kW + jc], safe) : 0.0f;
        mbs[l * kW + jc] = mult;
        for (int c = jc + 1; c < kW; ++c)
          sts[l * kW + c] = fmaf(-ucol[c], mult, sts[l * kW + c]);
        if (r0 + l == o) {  // publish the pivot row for the deferred update
          float* pi = pinfo + (i64)j * stride;
          for (int k = 0; k < r; ++k) pi[k] = to_f32(Ts[l * r + k]);
          for (int c = 0; c < kW; ++c) pi[r + c] = mbs[l * kW + c];
        }
      }
      if (b == 0 && tid == 0) {
        piv[j] = (int)cp;
        glist[j] = o;
      }
      __syncthreads();
    }
    // ---- strip finished: store it rounded to the panel dtype
    for (int e = tid; e < nrows * kW; e += kThreads) {
      int l = e / kW, c = e % kW;
      Ts[l * r + s * kW + c] = from_f32<T>(sts[e]);
    }
    if (s + 1 == nstrips) break;
    grid.sync();  // this strip's published pivot rows are visible
    // ---- deferred rank-8 update of the later strips
    const int f0 = (s + 1) * kW, nf = r - f0;
    for (int e = tid; e < kW * nf; e += kThreads) {
      int i = e / nf, k = e % nf;
      prow[i][k] = __ldcg(&pinfo[(i64)(s * kW + i) * stride + f0 + k]);
    }
    if (tid < kW * kW) {
      int i = tid / kW, c = tid % kW;
      mqp[i][c] = round_to<T>(__ldcg(&pinfo[(i64)(s * kW + i) * stride + r + c]));
    }
    __syncthreads();
    // N[a][b] = M[a, o_b]; Vinv = (I+N)^{-1} by the Neumann series
    // I - N + N^2 - ... (N is strictly upper, nilpotent)
    if (tid < kW * kW) {
      int a = tid / kW, c = tid % kW;
      nm[a][c] = mqp[c][a];
    }
    __syncthreads();
    if (tid < kW * kW) {
      int a = tid / kW, c = tid % kW;
      vinv[a][c] = __fsub_rn(a == c ? 1.0f : 0.0f, nm[a][c]);
      pw[a][c] = -nm[a][c];
    }
    __syncthreads();
    for (int it = 0; it < kW - 2; ++it) {
      if (tid < kW * kW) {
        int a = tid / kW, c = tid % kW;
        float acc = 0.0f;
        for (int q = 0; q < kW; ++q) acc = fmaf(-nm[a][q], pw[q][c], acc);
        pw2[a][c] = acc;
      }
      __syncthreads();
      if (tid < kW * kW) {
        int a = tid / kW, c = tid % kW;
        pw[a][c] = pw2[a][c];
        vinv[a][c] = __fadd_rn(vinv[a][c], pw2[a][c]);
      }
      __syncthreads();
    }
    for (int e = tid; e < nf * kW; e += kThreads) {
      int k = e / kW, c = e % kW;
      float acc = 0.0f;
      for (int i = 0; i < kW; ++i) acc = fmaf(prow[i][k], vinv[i][c], acc);
      Us[k * kW + c] = round_to<T>(acc);
    }
    __syncthreads();
    for (int e = tid; e < nrows * nf; e += kThreads) {
      int l = e / nf, k = e % nf;
      float upd = 0.0f;
#pragma unroll
      for (int c = 0; c < kW; ++c)
        upd = fmaf(Us[k * kW + c], round_to<T>(mbs[l * kW + c]), upd);
      T* t = &Ts[l * r + f0 + k];
      *t = from_f32<T>(__fsub_rn(to_f32(*t), upd));
    }
    __syncthreads();
  }
  for (int l = tid; l < nrows; l += kThreads) pos_io[r0 + l] = poss[l];
}

template <typename S, typename T>
int launch(int m, int r, const S* slab, i64 ld, int jj0, int off, int* pos,
           int* piv, int* glist, int quant16, void* rec, float* pinfo, int gmax,
           cudaStream_t stream) {
  const int nsm = sm_count(), optin = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  int G = min(nsm, gmax);
  int rpb = (m + G - 1) / G;
  G = (m + rpb - 1) / rpb;
  size_t smem = (size_t)rpb * r * sizeof(T) + (size_t)rpb * (2 * kW * sizeof(float) + sizeof(int));
  smem = (smem + 15) & ~(size_t)15;
  if ((int)smem > optin) return (int)cudaErrorInvalidValue;
  cudaError_t err = dyn_smem((const void*)strip_kernel<S, T>, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, strip_kernel<S, T>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (occ * nsm < G) return (int)cudaErrorCooperativeLaunchTooLarge;
  Rec* recp = (Rec*)rec;
  void* args[] = {&m, &r, &slab, &ld, &jj0, &off, &pos, &piv, &glist, &quant16,
                  &recp, &pinfo, &rpb};
  err = cudaLaunchCooperativeKernel((void*)strip_kernel<S, T>, dim3(G), dim3(kThreads), args,
                                    smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of one per-block record (the wrapper sizes the record buffer as
// r * gmax records).
MPF_API int mpf_strip_record_bytes() { return (int)sizeof(Rec); }

// slab_bf16: the slab is stored in bf16 (ALL_BF16; the panel is then bf16
// too and is taken as stored), else fp32 (converted to the panel dtype).
MPF_API int mpf_strip_pivots(int m, int r, const void* slab, i64 ld, int jj0, int off,
                             int* pos, int* piv, int* glist, int slab_bf16,
                             int panel_bf16, int quant16, void* rec, float* pinfo,
                             int gmax, void* stream) {
  if (r % kW != 0 || r > kMaxR || m <= 0) return (int)cudaErrorInvalidValue;
  if (slab_bf16 && !panel_bf16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  typedef __nv_bfloat16 bf;
  if (slab_bf16)
    return launch<bf, bf>(m, r, (const bf*)slab, ld, jj0, off, pos, piv, glist, quant16,
                          rec, pinfo, gmax, st);
  if (panel_bf16)
    return launch<float, bf>(m, r, (const float*)slab, ld, jj0, off, pos, piv, glist,
                             quant16, rec, pinfo, gmax, st);
  return launch<float, float>(m, r, (const float*)slab, ld, jj0, off, pos, piv, glist,
                              quant16, rec, pinfo, gmax, st);
}
