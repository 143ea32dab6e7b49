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
// panel is read once): r sequential grid-wide pivot searches, each a grid
// barrier and the round trips through L2 behind it.  The m x r panel (4 MiB
// in bf16 at m = 16384) is far beyond one block's shared memory, and every
// column's search needs every row.
//
// Design: one cooperative launch (at most one block per SM, every block
// resident).  Each block keeps its row slice of the panel in shared memory
// in the panel dtype for the whole panel (125 rows x 128 x 2 B = 32 KB at
// m = 16384 on 132 SMs; rows padded by 16 bytes, so that a thread's strip
// is one or two conflict-free 16-byte words); each thread holds the active
// strip of its rows in registers (up to 3 rows: 768 a block).  A block of
// more rows (a small r, or m above about 101k) keeps the running strip of
// the rest in shared memory in fp32 (in place in the panel for fp32
// panels), so shared memory alone bounds the rows a block takes, as it
// always has: at most rpb (r sizeof(T) + 68) bytes.  Per column:
//   1. each thread's best 64-bit key (|value| bits << 32 | inverted
//      position), the warp's by shuffles, then ONE block barrier and the
//      block's best from the 8 warp maxima;
//   2. the lane holding the block's candidate writes its key and record —
//      slab row, strip values, its multipliers of the strip so far — and
//      its warp the row's later-strip values: all a winning pivot row gives
//      the deferred update; one lane arrives at the grid barrier
//      (gridbar:: in common.cuh: a release add on an arrival counter);
//   3. thread 0 waits for all G arrivals; its warp reads the G keys (one L2
//      round trip, every load in flight at once), takes the largest and its
//      block by shuffles, reads the winner's row and strip values (the
//      second round trip) into shared memory and starts async copies
//      (cp.async) of the rest of the winning record; the second block
//      barrier;
//   4. every thread swaps positions, divides and updates its rows' strip.
// At a strip's end the inverse (I+N)^{-1} is one warp's work on the 8
// copied records (so no grid barrier publishes the pivot rows: a panel
// costs r grid barriers, not r + r/8), and the deferred update
// skips the rows that can no longer pivot (frozen, dead, or pivots of this
// strip: their values are never read again).  Three block barriers a
// strip.  The key and record slots are per column and block, kept per
// device and stream by the wrapper (r x G x 568 B, about 9.6 MB at r = 128, G = 132).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kW = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 128;
constexpr int kMaxRpt = 3;  // rows a thread holds in registers; more in shared memory
constexpr int kMaxG = 256;  // blocks (one an SM)
constexpr int kSent = 0x7FFFFFFF;
constexpr unsigned kFull = 0xffffffffu;
typedef unsigned long long u64;

// A block's candidate for one column (its key is kept apart, in a dense
// array, for the one-pass reduction).  `tail` is what the deferred update
// needs of a pivot row, copied as 16-byte chunks: its multipliers of the
// strip so far (0 from the candidate's own column on), then its values in
// the later strips (columns f0.. of the panel).
constexpr int kExtra = kMaxR;  // kW multipliers + at most kMaxR - kW later values
struct Rec {
  int row;
  int pad[3];
  float vals[kW];        // strip values
  float tail[kExtra];
};

// the scratch: the grid barrier's counters, then r x G keys, then r x G records
constexpr size_t kCtrBytes = 256;

__device__ __forceinline__ u64 umax64(u64 a, u64 b) { return a > b ? a : b; }

__device__ __forceinline__ u64 warp_max(u64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = umax64(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// four consecutive elements, 4 x sizeof(S)-aligned, as fp32
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  v[0] = __low2float(lo), v[1] = __high2float(lo), v[2] = __low2float(hi), v[3] = __high2float(hi);
}
// four fp32 values rounded to the panel dtype, to a 4 x sizeof(T)-aligned address
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 lo, hi;
  lo.x = __float2bfloat16_rn(v[0]), lo.y = __float2bfloat16_rn(v[1]);
  hi.x = __float2bfloat16_rn(v[2]), hi.y = __float2bfloat16_rn(v[3]);
  uint2 x;
  x.x = *reinterpret_cast<unsigned*>(&lo), x.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = x;
}

// a row's strip: eight panel-dtype values, 16-byte aligned
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 x = reinterpret_cast<const float4*>(p)[0], y = reinterpret_cast<const float4*>(p)[1];
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w, v[4] = y.x, v[5] = y.y, v[6] = y.z, v[7] = y.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    v[2 * i] = __low2float(h), v[2 * i + 1] = __high2float(h);
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    h.x = __float2bfloat16_rn(v[2 * i]), h.y = __float2bfloat16_rn(v[2 * i + 1]);
    w[i] = *reinterpret_cast<unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

// a row at position p can still pivot at position lim or later
__device__ __forceinline__ bool can_pivot(int p, int lim) { return p != kSent && p >= lim; }

// T[l][f0 + k] -= sum_c Us[c][k] M[l][c] (ascending c from 0, one rounding
// to T) for the rows that can still pivot; kNk groups of 32 later columns,
// all of a row pair's loads ahead of its 2 kNk independent chains
template <typename T, int kNk>
__device__ __forceinline__ void deferred_update(T* Ts, int rs, const T* mq, const int* ps,
                                                int lim, const float (*Us)[kMaxR], int nrows,
                                                int f0, int nf, int warp, int lane) {
  float uk[kNk][kW];
#pragma unroll
  for (int kk = 0; kk < kNk; ++kk)
#pragma unroll
    for (int c = 0; c < kW; ++c) uk[kk][c] = lane + 32 * kk < nf ? Us[c][lane + 32 * kk] : 0.0f;
  for (int l0 = warp; l0 < nrows; l0 += 2 * kWarps) {
    const int l1 = l0 + kWarps;
    const bool a0 = can_pivot(ps[l0], lim), a1 = l1 < nrows && can_pivot(ps[l1], lim);
    if (!a0 && !a1) continue;
    T* row0 = Ts + l0 * rs + f0;
    T* row1 = Ts + (a1 ? l1 : l0) * rs + f0;
    float m0[kW], m1[kW], t0[kNk], t1[kNk], u0[kNk], u1[kNk];
    load8(mq + l0 * kW, m0);
    load8(mq + (a1 ? l1 : l0) * kW, m1);
#pragma unroll
    for (int kk = 0; kk < kNk; ++kk) {
      const int k = lane + 32 * kk;
      t0[kk] = k < nf ? to_f32(row0[k]) : 0.0f;
      t1[kk] = k < nf ? to_f32(row1[k]) : 0.0f;
      u0[kk] = u1[kk] = 0.0f;
    }
#pragma unroll
    for (int c = 0; c < kW; ++c)
#pragma unroll
      for (int kk = 0; kk < kNk; ++kk) {
        u0[kk] = fmaf(uk[kk][c], m0[c], u0[kk]);
        u1[kk] = fmaf(uk[kk][c], m1[c], u1[kk]);
      }
#pragma unroll
    for (int kk = 0; kk < kNk; ++kk) {
      const int k = lane + 32 * kk;
      if (k < nf) {
        if (a0) row0[k] = from_f32<T>(__fsub_rn(t0[kk], u0[kk]));
        if (a1) row1[k] = from_f32<T>(__fsub_rn(t1[kk], u1[kk]));
      }
    }
  }
}

// an overflow row l's running strip s in fp32: in place in the panel for
// fp32 panels, else row l - l0 of `so`
template <typename T>
__device__ __forceinline__ float* ostrip(T* Ts, float* so, int rs, int l, int s, int l0) {
  if constexpr (sizeof(T) == 4)
    return reinterpret_cast<float*>(Ts + l * rs + s * kW);
  else
    return so + (l - l0) * kW;
}

// kOver: rows past kRpt a thread (kRpt == kMaxRpt) keep their running strip
// in shared memory (`ostrip`) and their positions in `ps` throughout
template <typename S, typename T, int kRpt, bool kOver>
__global__ void __launch_bounds__(kThreads, 1)
    strip_kernel(int m, int r, const S* __restrict__ slab, i64 ld, int jj0, int off,
                 int* __restrict__ pos_io, int* __restrict__ piv, int* __restrict__ glist,
                 int quant16, unsigned* ctr, u64* keys, Rec* recs, int rpb) {
  // rows padded by 16 bytes: a thread's strip is one or two 16-byte words,
  // and 32 threads' words fall in distinct banks four at a time
  const int rs = r + 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char dyn[];
  // the panel slice; the strip's multipliers rounded to the panel dtype;
  // for bf16 panels, the overflow rows' running strips in fp32; positions
  // (register rows' as of the last strip end)
  const int kReg = kRpt * kThreads, nover = kOver ? max(0, rpb - kReg) : 0;
  T* Ts = reinterpret_cast<T*>(dyn);                                   // rpb x rs
  T* mq = Ts + (size_t)rpb * rs;                                       // rpb x 8
  float* so = reinterpret_cast<float*>(mq + (size_t)rpb * kW);         // nover x 8
  int* ps = reinterpret_cast<int*>(so + (sizeof(T) == 4 ? 0 : nover * kW));  // rpb
  __shared__ u64 red[kWarps];
  __shared__ u64 win_key;
  __shared__ int win_row;
  __shared__ __align__(16) float win_vals[kW];
  __shared__ __align__(16) float ex[kW][kExtra];  // the strip's winning records' tails
  __shared__ float vinv[kW][kW];
  __shared__ float pws[2][kW][kW];                 // powers of -N, one column a lane
  __shared__ float Us[kW][kMaxR];                  // rounded (T S)(I+N)^{-1}, transposed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, G = gridDim.x;
  const int r0 = b * rpb;
  const int nrows = max(0, min(rpb, m - r0));
  const int nstrips = r / kW;

  // the panel slice, a warp per row: 4-element chunks where every row's
  // chunks are aligned, else elements
  const S* base = slab + (i64)r0 * ld + jj0;
  if (((reinterpret_cast<uintptr_t>(base) | (uintptr_t)(ld * sizeof(S))) & (4 * sizeof(S) - 1)) == 0) {
    const int c = 4 * lane;
#pragma unroll 4
    for (int l = warp; l < nrows; l += kWarps) {
      if (c < r) {
        float v[4];
        load4(base + (i64)l * ld + c, v);
        store4(Ts + l * rs + c, v);
      }
    }
  } else {
    for (int l = warp; l < nrows; l += kWarps)
      for (int c = lane; c < r; c += 32) Ts[l * rs + c] = from_f32<T>(to_f32(base[(i64)l * ld + c]));
  }
  int p[kRpt];
#pragma unroll
  for (int q = 0; q < kRpt; ++q) {
    const int l = tid + q * kThreads;
    p[q] = l < nrows ? pos_io[r0 + l] : kSent;
  }
  if constexpr (kOver) {
    for (int l = kReg + tid; l < nrows; l += kThreads) ps[l] = pos_io[r0 + l];
  }
  __syncthreads();

  float st[kRpt][kW], mb[kRpt][kW];
  for (int s = 0; s < nstrips; ++s) {
    const int f0 = (s + 1) * kW, nf = r - f0;
    const bool last = s + 1 == nstrips;
#pragma unroll
    for (int q = 0; q < kRpt; ++q) {
      const int l = tid + q * kThreads;
      if (l < nrows)
        load8(Ts + l * rs + s * kW, st[q]);
      else
#pragma unroll
        for (int c = 0; c < kW; ++c) st[q][c] = 0.0f;
#pragma unroll
      for (int c = 0; c < kW; ++c) mb[q][c] = 0.0f;
    }
    if constexpr (kOver) {
      for (int l = kReg + tid; l < nrows; l += kThreads) {
        float* o = ostrip(Ts, so, rs, l, s, kReg);
        if constexpr (sizeof(T) != 4) {
          float v[kW];
          load8(Ts + l * rs + s * kW, v);
#pragma unroll
          for (int c = 0; c < kW; ++c) o[c] = v[c];
        }
#pragma unroll
        for (int c = 0; c < kW; ++c) mq[l * kW + c] = from_f32<T>(0.0f);
      }
    }
#pragma unroll
    for (int jc = 0; jc < kW; ++jc) {
      const int j = s * kW + jc;
      const int d = off + j;
      // ---- 1. candidates: thread, warp, block
      u64 key[kRpt];
      u64 best = 0;
#pragma unroll
      for (int q = 0; q < kRpt; ++q) {
        key[q] = 0;
        if (p[q] != kSent && p[q] >= d) {
          unsigned bits = __float_as_uint(st[q][jc]) & 0x7FFFFFFFu;
          if (quant16) bits &= 0x7FFF0000u;
          key[q] = ((u64)bits << 32) | (u64)(0xFFFFFFFFu - (unsigned)p[q]);
        }
        best = umax64(best, key[q]);
      }
      u64 okey = 0;  // the overflow rows' best, and its row
      int orow = -1;
      if constexpr (kOver) {
        for (int l = kReg + tid; l < nrows; l += kThreads) {
          const int pl = ps[l];
          if (pl != kSent && pl >= d) {
            unsigned bits = __float_as_uint(ostrip(Ts, so, rs, l, s, kReg)[jc]) & 0x7FFFFFFFu;
            if (quant16) bits &= 0x7FFF0000u;
            const u64 k = ((u64)bits << 32) | (u64)(0xFFFFFFFFu - (unsigned)pl);
            if (k > okey) okey = k, orow = l;
          }
        }
        best = umax64(best, okey);
      }
      best = warp_max(best);
      if (lane == 0) red[warp] = best;
      __syncthreads();
      u64 bb = red[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) bb = umax64(bb, red[w]);
      // ---- 2. the owning warp writes the key and the record, and arrives
      int mine = -1;
#pragma unroll
      for (int q = 0; q < kRpt; ++q)
        if (bb != 0 && key[q] == bb) mine = q;
      if (kOver && bb != 0 && okey == bb) mine = kRpt;
      const unsigned own = __ballot_sync(kFull, mine >= 0);
      Rec* rc = recs + (i64)j * G + b;
      u64* kslot = keys + (i64)j * G + b;
      if (own) {
        const int src = __ffs(own) - 1;
        const int lw = __shfl_sync(kFull, mine == kRpt ? orow : tid + max(mine, 0) * kThreads, src);
#pragma unroll
        for (int q = 0; q < kRpt; ++q) {
          if (lane == src && mine == q) {
            *kslot = bb;
            rc->row = r0 + lw;
            float4* v4 = reinterpret_cast<float4*>(rc->vals);
            v4[0] = make_float4(st[q][0], st[q][1], st[q][2], st[q][3]);
            v4[1] = make_float4(st[q][4], st[q][5], st[q][6], st[q][7]);
            float4* t4 = reinterpret_cast<float4*>(rc->tail);
            t4[0] = make_float4(mb[q][0], mb[q][1], mb[q][2], mb[q][3]);
            t4[1] = make_float4(mb[q][4], mb[q][5], mb[q][6], mb[q][7]);
          }
        }
        if (kOver && lane == src && mine == kRpt) {  // an overflow row
          *kslot = bb;
          rc->row = r0 + lw;
          const float* o = ostrip(Ts, so, rs, lw, s, kReg);
#pragma unroll
          for (int c = 0; c < kW; ++c) rc->vals[c] = o[c], rc->tail[c] = to_f32(mq[lw * kW + c]);
        }
        if (!last) {
          float lv[4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            lv[kk] = lane + 32 * kk < nf ? to_f32(Ts[lw * rs + f0 + lane + 32 * kk]) : 0.0f;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (lane + 32 * kk < nf) rc->tail[kW + lane + 32 * kk] = lv[kk];
        }
        __syncwarp();
        if (lane == 0) gridbar::arrive(ctr);
      } else if (bb == 0 && tid == 0) {
        *kslot = 0;
        gridbar::arrive(ctr);
      }
      // ---- 3. the winner: warp 0 reduces the G keys and reads its record's
      // row and strip values
      if (warp == 0) {
        if (lane == 0) gridbar::wait(ctr, (unsigned)(G * (j + 1)));
        __syncwarp();
        u64 kv[kMaxG / 32];
#pragma unroll
        for (int i = 0; i < kMaxG / 32; ++i) {  // all in flight at once
          const int t = lane + 32 * i;
          kv[i] = t < G ? __ldcg(keys + (i64)j * G + t) : 0ull;
        }
        u64 g = 0;
        int gb = 0;
#pragma unroll
        for (int i = 0; i < kMaxG / 32; ++i) {
          if (kv[i] > g) {
            g = kv[i];
            gb = lane + 32 * i;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const u64 go = __shfl_xor_sync(kFull, g, o);
          const int bo = __shfl_xor_sync(kFull, gb, o);
          if (go > g) {
            g = go;
            gb = bo;
          }
        }
        const Rec* w = recs + (i64)j * G + gb;
        if (g != 0) {
          if (lane < kW) win_vals[lane] = __ldcg(&w->vals[lane]);
          if (lane == kW) win_row = __ldcg(&w->row);
          if (!last && lane < (kW + nf) / 4) cp_async16(&ex[jc][4 * lane], &w->tail[4 * lane]);
        } else {
          if (lane < kW) win_vals[lane] = 0.0f;
          if (lane == kW) win_row = -1;
          if (!last)
            for (int k = lane; k < kExtra; k += 32) ex[jc][k] = 0.0f;
        }
        if (lane == 0) win_key = g;
        asm volatile("cp.async.commit_group;" ::: "memory");
      }
      __syncthreads();
      // ---- 4. swap positions, multipliers, in-strip rank-1 update
      const u64 g = win_key;
      const int o = win_row;
      unsigned cp = (unsigned)d;
      float safe = 1.0f;
      if (g != 0) {
        cp = 0xFFFFFFFFu - (unsigned)(g & 0xFFFFFFFFull);
        const unsigned kbits = (unsigned)(g >> 32);
        const float vj = win_vals[jc];
        const float pv = quant16 ? (signbit(vj) ? -__uint_as_float(kbits) : __uint_as_float(kbits))
                                 : vj;
        safe = kbits == 0 ? 1.0f : pv;
      }
#pragma unroll
      for (int q = 0; q < kRpt; ++q) {
        const int l = tid + q * kThreads;
        if (l < nrows) {
          int pq = p[q];
          if (r0 + l == o)
            pq = d;
          else if (pq == d)
            pq = (int)cp;
          p[q] = pq;
          const bool below = pq != kSent && pq > d;
          const float mult = below ? div_rn(st[q][jc], safe) : 0.0f;
          mb[q][jc] = mult;
#pragma unroll
          for (int c = jc + 1; c < kW; ++c) st[q][c] = fmaf(-win_vals[c], mult, st[q][c]);
        }
      }
      if constexpr (kOver) {
        for (int l = kReg + tid; l < nrows; l += kThreads) {
          int pq = ps[l];
          if (r0 + l == o)
            pq = d;
          else if (pq == d)
            pq = (int)cp;
          ps[l] = pq;
          float* ol = ostrip(Ts, so, rs, l, s, kReg);
          const float mult = pq != kSent && pq > d ? div_rn(ol[jc], safe) : 0.0f;
          mq[l * kW + jc] = from_f32<T>(mult);
#pragma unroll
          for (int c = jc + 1; c < kW; ++c) ol[c] = fmaf(-win_vals[c], mult, ol[c]);
        }
      }
      if (b == 0 && tid == 0) {
        piv[j] = (int)cp;
        glist[j] = o;
      }
    }
    if (last) break;
    // ---- strip finished: store it and the multipliers rounded to the
    // panel dtype, and the positions (the deferred update skips the rows
    // that can no longer pivot: their values are never read again)
#pragma unroll
    for (int q = 0; q < kRpt; ++q) {
      const int l = tid + q * kThreads;
      if (l < nrows) {
        store8(Ts + l * rs + s * kW, st[q]);
        store8(mq + l * kW, mb[q]);
        ps[l] = p[q];
      }
    }
    if constexpr (kOver && sizeof(T) != 4) {
      for (int l = kReg + tid; l < nrows; l += kThreads) {
        float v[kW];
        const float* o = ostrip(Ts, so, rs, l, s, kReg);
#pragma unroll
        for (int c = 0; c < kW; ++c) v[c] = o[c];
        store8(Ts + l * rs + s * kW, v);
      }
    }
    // N[a][c] = M[a, o_c] = the c-th pivot row's multiplier of column a,
    // rounded; Vinv = (I+N)^{-1} by the Neumann series I - N + N^2 - ...
    // (N is strictly upper, nilpotent), from the records warp 0's own async
    // copies brought.  Lane (a0, c) holds rows a0 and a0 + 4 of column c;
    // each step's power goes round through shared memory.
    if (warp == 0) {
      asm volatile("cp.async.wait_all;" ::: "memory");
      __syncwarp();
      const int c = lane & (kW - 1), a0 = lane >> 3;
      float na[2][kW], vc[2], pc[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a = a0 + 4 * h;
#pragma unroll
        for (int q = 0; q < kW; ++q) na[h][q] = round_to<T>(ex[q][a]);
        const float nac = round_to<T>(ex[c][a]);
        vc[h] = __fsub_rn(a == c ? 1.0f : 0.0f, nac);
        pc[h] = -nac;
      }
#pragma unroll
      for (int it = 0; it < kW - 2; ++it) {
        float (*pw)[kW] = pws[it & 1];
        pw[a0][c] = pc[0];
        pw[a0 + 4][c] = pc[1];
        __syncwarp();
        float col[kW];
#pragma unroll
        for (int q = 0; q < kW; ++q) col[q] = pw[q][c];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float acc = 0.0f;
#pragma unroll
          for (int q = 0; q < kW; ++q) acc = fmaf(-na[h][q], col[q], acc);
          pc[h] = acc;
          vc[h] = __fadd_rn(vc[h], acc);
        }
      }
      vinv[a0][c] = vc[0];
      vinv[a0 + 4][c] = vc[1];
    }
    __syncthreads();
    for (int e = tid; e < nf * kW; e += kThreads) {
      const int k = e >> 3, c = e & (kW - 1);
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < kW; ++i) acc = fmaf(ex[i][kW + k], vinv[i][c], acc);
      Us[c][k] = round_to<T>(acc);
    }
    __syncthreads();
    // ---- deferred rank-8 update of the later strips: a warp two rows at a
    // time, a lane a column of each group of 32 (their Us in registers)
    switch ((nf + 31) >> 5) {
      case 4: deferred_update<T, 4>(Ts, rs, mq, ps, off + f0, Us, nrows, f0, nf, warp, lane); break;
      case 3: deferred_update<T, 3>(Ts, rs, mq, ps, off + f0, Us, nrows, f0, nf, warp, lane); break;
      case 2: deferred_update<T, 2>(Ts, rs, mq, ps, off + f0, Us, nrows, f0, nf, warp, lane); break;
      default: deferred_update<T, 1>(Ts, rs, mq, ps, off + f0, Us, nrows, f0, nf, warp, lane); break;
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kRpt; ++q) {
    const int l = tid + q * kThreads;
    if (l < nrows) pos_io[r0 + l] = p[q];
  }
  if constexpr (kOver) {
    for (int l = kReg + tid; l < nrows; l += kThreads) pos_io[r0 + l] = ps[l];
  }
  if (tid == 0) gridbar::depart(ctr);
}

// Grid barrier probe (no pivot search): `iters` barriers of the G blocks of
// one cooperative launch of 256 threads.  kind 0: cooperative groups'
// grid.sync(); kind 1: kernel 1's arrival counter, block barriers around it;
// kind 2: kind 1 with kernel 1's first round trip behind it (each block
// writes a key before arriving, warp 0 reads the G keys after).
__global__ void __launch_bounds__(kThreads, 1)
    barrier_probe_kernel(int kind, int iters, unsigned* ctr, u64* keys) {
  __shared__ u64 seen;
  const int tid = threadIdx.x, G = gridDim.x;
  for (int it = 0; it < iters; ++it) {
    if (kind == 0) {
      cg::this_grid().sync();
      continue;
    }
    __syncthreads();
    if (tid == 0) {
      if (kind == 2) keys[(i64)(it & 127) * G + blockIdx.x] = (u64)it * G + blockIdx.x + 1;
      gridbar::arrive(ctr);
    }
    if (tid < 32) {
      if (tid == 0) gridbar::wait(ctr, (unsigned)(G * (it + 1)));
      __syncwarp();
      if (kind == 2) {
        u64 g = 0;
        for (int t = tid; t < G; t += 32) g = umax64(g, __ldcg(keys + (i64)(it & 127) * G + t));
        g = warp_max(g);
        if (tid == 0) seen = g;
      }
    }
    __syncthreads();
  }
  if (kind != 0 && tid == 0) gridbar::depart(ctr);
}

template <typename S, typename T, int kRpt, bool kOver = false>
cudaError_t launch_rpt(int G, size_t smem, void** args, cudaStream_t stream) {
  const void* fn = (const void*)strip_kernel<S, T, kRpt, kOver>;
  cudaError_t err = dyn_smem(fn, (int)smem);
  if (err != cudaSuccess) return err;
  if (occupancy(fn, kThreads, smem) * sm_count() < G) return cudaErrorCooperativeLaunchTooLarge;
  return cudaLaunchCooperativeKernel(fn, dim3(G), dim3(kThreads), args, smem, stream);
}

template <typename S, typename T>
int launch(int m, int r, const S* slab, i64 ld, int jj0, int off, int* pos, int* piv,
           int* glist, int quant16, unsigned char* scratch, int gmax, cudaStream_t stream) {
  int G = min(min(sm_count(), gmax), kMaxG);
  int rpb = (m + G - 1) / G;
  G = (m + rpb - 1) / rpb;
  // the panel slice with padded rows, the multipliers, the positions, and
  // (bf16 panels) the overflow rows' running strips: as strip_kernel lays it out
  const int nover = max(0, rpb - kMaxRpt * kThreads);
  size_t smem = (size_t)rpb * ((r + 16 / sizeof(T) + kW) * sizeof(T) + sizeof(int)) +
                (sizeof(T) == 4 ? 0 : (size_t)nover * kW * sizeof(float));
  if ((int)smem > device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin))
    return (int)cudaErrorInvalidValue;
  unsigned* ctr = reinterpret_cast<unsigned*>(scratch);
  u64* keys = reinterpret_cast<u64*>(scratch + kCtrBytes);
  Rec* recs = reinterpret_cast<Rec*>(scratch + kCtrBytes + (size_t)kMaxR * gmax * sizeof(u64));
  void* args[] = {&m, &r, &slab, &ld, &jj0, &off, &pos, &piv, &glist, &quant16,
                  &ctr, &keys, &recs, &rpb};
  const int rpt = (rpb + kThreads - 1) / kThreads;
  cudaError_t err = rpt == 1   ? launch_rpt<S, T, 1>(G, smem, args, stream)
                    : rpt == 2 ? launch_rpt<S, T, 2>(G, smem, args, stream)
                    : rpt == 3 ? launch_rpt<S, T, 3>(G, smem, args, stream)
                               : launch_rpt<S, T, kMaxRpt, true>(G, smem, args, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of the scratch buffer for grids of up to gmax blocks (the wrapper
// allocates it zeroed, once per device and stream; the kernel leaves its counters at 0).
MPF_API long long mpf_strip_scratch_bytes(int gmax) {
  return (long long)(kCtrBytes + (size_t)kMaxR * gmax * (sizeof(u64) + sizeof(Rec)));
}

// slab_bf16: the slab is stored in bf16 (ALL_BF16; the panel is then bf16
// too and is taken as stored), else fp32 (converted to the panel dtype).
MPF_API int mpf_strip_pivots(int m, int r, const void* slab, i64 ld, int jj0, int off,
                             int* pos, int* piv, int* glist, int slab_bf16,
                             int panel_bf16, int quant16, void* scratch, int gmax,
                             void* stream) {
  if (r % kW != 0 || r > kMaxR || m <= 0) return (int)cudaErrorInvalidValue;
  if (slab_bf16 && !panel_bf16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned char* sc = (unsigned char*)scratch;
  typedef __nv_bfloat16 bf;
  if (slab_bf16)
    return launch<bf, bf>(m, r, (const bf*)slab, ld, jj0, off, pos, piv, glist, quant16, sc,
                          gmax, st);
  if (panel_bf16)
    return launch<float, bf>(m, r, (const float*)slab, ld, jj0, off, pos, piv, glist,
                             quant16, sc, gmax, st);
  return launch<float, float>(m, r, (const float*)slab, ld, jj0, off, pos, piv, glist,
                              quant16, sc, gmax, st);
}

// The grid barrier probe: `iters` barriers of `kind` (see
// barrier_probe_kernel) across min(SM count, gmax) blocks, on kernel 1's
// scratch.
MPF_API int mpf_strip_barrier_probe(int kind, int iters, void* scratch, int gmax,
                                    void* stream) {
  if (kind < 0 || kind > 2 || iters <= 0) return (int)cudaErrorInvalidValue;
  const int G = min(sm_count(), gmax);
  unsigned* ctr = reinterpret_cast<unsigned*>(scratch);
  u64* keys = reinterpret_cast<u64*>((unsigned char*)scratch + kCtrBytes);
  const void* fn = (const void*)barrier_probe_kernel;
  if (occupancy(fn, kThreads, 0) * sm_count() < G)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&kind, &iters, &ctr, &keys};
  cudaError_t err = cudaLaunchCooperativeKernel(fn, dim3(G), dim3(kThreads), args, 0,
                                                (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
