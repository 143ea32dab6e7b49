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
//             round points of ops/_lib.py:sub_mul (bf16: product rounded
//             first; fp16: the exact result rounded once; fp32: one fused
//             multiply-add).
// Rows never move: each row carries its position.  The factors are
// discarded; out come piv (positions), the panel row map perm (position ->
// row), the composed map prev_perm[perm] and the 2r LASWP sources
// srcs = [perm[off + j], perm[piv[j]]].
//
// What bounds it on the H100: r sequential grid-wide pivot searches, not
// flops (~m r^2) or bytes (the panel is read once).  The m x r panel is far
// beyond one block's shared memory and every column's search needs every
// row: a column costs one grid barrier and two round trips through L2 at
// least.
//
// Design (kernel 1's, csrc/strip_pivots.cu, without strips): one
// cooperative launch, at most one block per SM, every block resident, r
// grid barriers a panel on an arrival counter (gridbar:: in common.cuh).
// Each block keeps its row slice of the panel in T in shared memory for
// the whole panel (125 rows x 272 B = 33 KB for fp16 at m = 16384, r = 128
// on 132 SMs), or in a global scratch slice when it does not fit; rows
// are padded to an odd number of 16-byte words, so that 32 threads' words
// of 32 rows fall in distinct banks four at a time.  Thread t owns rows t
// and t + 256 of its block, their positions and the fp32 value of the
// column being searched in registers; rows past 512 a block (m above
// 67584 on 132 SMs) keep their positions in shared memory (the kOver
// instance).  Per column:
//   1. each thread's best 64-bit key (|value| bits << 32 | inverted
//      position), the warp's by shuffles, then ONE block barrier and the
//      block's best from the 8 warp maxima;
//   2. the warp holding the block's candidate writes its key and its
//      record (slab row, the row's 16-byte words from the one holding
//      column j on); one lane arrives at the grid barrier (a release add);
//   3. thread 0 waits for all G arrivals; its warp reads the G keys (one L2
//      round trip, every load in flight at once), takes the largest and its
//      block by shuffles, and reads the winner's row and words (the second
//      round trip) into shared memory in fp32; the second block barrier;
//   4. every thread swaps its rows' positions and divides and updates each
//      of its rows below the diagonal, 16 bytes at a time from the word
//      holding column j + 1 (the columns left of j + 1 in that word take
//      the update too: they are never read again), keeping the new value
//      of column j + 1 in a register for the next search.
// Key and record slots alternate between two per block: a block overwrites
// a slot two columns later, after the barrier that every reader of the
// slot has passed.  Every block knows every pivot, so no barrier ends the
// panel: each block writes perm and the composed map for its own rows and
// srcs[r + j] for its row whose final position is piv[j].
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRpt = 2;      // rows a thread holds in registers; more in shared memory
constexpr int kMaxG = 256;   // blocks (one an SM)
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kCtrBytes = 256;  // the grid barrier's counters
typedef unsigned long long u64;

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// 16-byte words of a row of r values of tsize bytes, and the padded row
// stride in words (odd)
__host__ __device__ constexpr int words(int r, int tsize) { return (r * tsize + 15) / 16; }
__host__ __device__ constexpr int stride_words(int r, int tsize) { return words(r, tsize) | 1; }

// Dynamic shared memory: the pivot row in fp32 (one word of T a
// 16 / tsize floats), the pivots (r), the positions of the rows past the
// registers (rpb), then the panel slice when it lives here
struct Layout {
  size_t us, spiv, ps, panel;
  __host__ __device__ Layout(int r, int rpb, int tsize) {
    us = 0;
    spiv = us + align16((size_t)words(r, tsize) * 16 / tsize * 4);
    ps = spiv + align16((size_t)r * 4);
    panel = ps + align16((size_t)rpb * 4);
  }
};

// a record slot: the candidate's slab row, then its row's 16-byte words
__host__ __device__ constexpr size_t rec_bytes(int r, int tsize) {
  return 16 + (size_t)words(r, tsize) * 16;
}

__device__ __forceinline__ u64 umax64(u64 a, u64 b) { return a > b ? a : b; }

__device__ __forceinline__ u64 warp_max(u64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = umax64(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ u64 key_of(float v, int p) {
  return ((u64)__float_as_uint(fabsf(v)) << 32) | (u64)(0xFFFFFFFFu - (unsigned)p);
}

// p - m * u before its rounding to T, at the round points of the function
// (see the file comment); the word's pack rounds it
template <typename T> __device__ __forceinline__ float rank1(float p, float m, float u);
template <> __device__ __forceinline__ float rank1<float>(float p, float m, float u) {
  return fmaf(-m, u, p);
}
template <> __device__ __forceinline__ float rank1<__nv_bfloat16>(float p, float m, float u) {
  return __fsub_rn(p, round_to<__nv_bfloat16>(__fmul_rn(m, u)));
}
// fp16: the exact p - m * u rounded once: the product of two fp16 values is
// exact in fp32, the difference is rounded to odd in fp32 (truncated, the
// last bit set when inexact), and the pack's round to nearest at fp16 then
// gives the exact result's rounding (fp32 keeps two bits more than fp16
// needs); rounding the difference to nearest in fp32 first could land on an
// fp16 midpoint
template <> __device__ __forceinline__ float rank1<__half>(float p, float m, float u) {
  const float w = __fmul_rn(m, u);
  const float z = __fsub_rz(p, w);
  return __fsub_rd(p, w) == __fsub_ru(p, w) ? z : __int_as_float(__float_as_int(z) | 1);
}

// a 16-byte word of T as 16 / sizeof(T) fp32 values, and back (round to
// nearest even, as from_f32)
template <typename T>
__device__ __forceinline__ void unpack(uint4 x, float (&v)[16 / sizeof(T)]) {
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(w[i]);
  } else if constexpr (std::is_same<T, __half>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float (&v)[16 / sizeof(T)]) {
  unsigned w[4];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(v[i]);
  } else if constexpr (std::is_same<T, __half>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __half2 h = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the words k0.. of a row below the diagonal take p - mult * u (us: the
// pivot row in fp32); returns the new value of element e1 of word k0
template <typename T>
__device__ __forceinline__ float update_row(T* row, int k0, int nw, float mult,
                                            const float* us, int e1) {
  constexpr int kV = 16 / sizeof(T);
  uint4* r4 = reinterpret_cast<uint4*>(row);
  const float4* u4 = reinterpret_cast<const float4*>(us);
  float first = 0.0f;
  for (int k = k0; k < nw; ++k) {
    float v[kV];
    unpack<T>(r4[k], v);
#pragma unroll
    for (int q = 0; q < kV / 4; ++q) {
      const float4 u = u4[k * (kV / 4) + q];
      v[4 * q] = rank1<T>(v[4 * q], mult, u.x);
      v[4 * q + 1] = rank1<T>(v[4 * q + 1], mult, u.y);
      v[4 * q + 2] = rank1<T>(v[4 * q + 2], mult, u.z);
      v[4 * q + 3] = rank1<T>(v[4 * q + 3], mult, u.w);
    }
    r4[k] = pack<T>(v);
    if (k == k0) {
#pragma unroll
      for (int e = 0; e < kV; ++e) first = e == e1 ? round_to<T>(v[e]) : first;
    }
  }
  return first;
}

// A row's position p takes the column's swap: the winner (slab row o)
// goes to d, the row at d to the winner's position cp
__device__ __forceinline__ int swapped(int p, int row, int o, int d, int cp) {
  return row == o ? d : (p == d ? cp : p);
}

// kOver: rows past kRpt a thread keep their positions in `ps` throughout
template <typename T, typename Tin, bool kOver>
__global__ void __launch_bounds__(kThreads, 1)
    hgetf2_kernel(int m, int r, const Tin* __restrict__ in, i64 ld, int off,
                  const int* __restrict__ prev, int* __restrict__ piv,
                  int* __restrict__ perm, int* __restrict__ cperm, int* __restrict__ srcs,
                  unsigned* ctr, u64* keys, unsigned char* recs, T* gpanel, int rpb) {
  constexpr int kTs = (int)sizeof(T), kV = 16 / kTs;
  const int nw = words(r, kTs), rs = stride_words(r, kTs) * kV;  // row stride in T
  const size_t rb = rec_bytes(r, kTs);
  const Layout lay(r, rpb, kTs);
  extern __shared__ __align__(16) unsigned char dyn[];
  float* us = reinterpret_cast<float*>(dyn + lay.us);     // the pivot row, fp32
  int* spiv = reinterpret_cast<int*>(dyn + lay.spiv);     // every pivot so far
  int* ps = reinterpret_cast<int*>(dyn + lay.ps);         // positions past the registers
  __shared__ u64 red[kWarps];
  __shared__ u64 win_key;
  __shared__ int win_row;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, G = gridDim.x;
  const int r0 = b * rpb;
  const int nrows = max(0, min(rpb, m - r0));
  constexpr int kReg = kRpt * kThreads;
  T* P = gpanel ? gpanel + (i64)r0 * rs : reinterpret_cast<T*>(dyn + lay.panel);

  // the row slice in T, a warp per row, zero past column r
  for (int l = warp; l < nrows; l += kWarps) {
    const Tin* src = in + (i64)(r0 + l) * ld;
    for (int c = lane; c < rs; c += 32)
      P[(i64)l * rs + c] = from_f32<T>(c < r ? to_f32(src[c]) : 0.0f);
  }
  for (int c = tid; c < nw * kV; c += kThreads) us[c] = 0.0f;
  if constexpr (kOver) {
    for (int l = kReg + tid; l < nrows; l += kThreads) ps[l] = r0 + l;
  }
  __syncthreads();
  int p[kRpt];     // positions (-1: no row)
  float a[kRpt];   // the value in the column being searched
#pragma unroll
  for (int q = 0; q < kRpt; ++q) {
    const int l = tid + q * kThreads;
    p[q] = l < nrows ? r0 + l : -1;
    a[q] = l < nrows ? to_f32(P[(i64)l * rs]) : 0.0f;
  }

  for (int j = 0; j < r; ++j) {
    const int d = off + j;
    const int slot = (j & 1) * G;
    // ---- 1. candidates: thread, warp, block
    u64 key[kRpt];
    u64 best = 0;
#pragma unroll
    for (int q = 0; q < kRpt; ++q) {
      key[q] = p[q] >= d ? key_of(a[q], p[q]) : 0ull;
      best = umax64(best, key[q]);
    }
    u64 okey = 0;  // the overflow rows' best, and its row
    int orow = -1;
    if constexpr (kOver) {
      for (int l = kReg + tid; l < nrows; l += kThreads) {
        const int pl = ps[l];
        if (pl >= d) {
          const u64 k = key_of(to_f32(P[(i64)l * rs + j]), pl);
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
    unsigned char* rc = recs + (size_t)(slot + b) * rb;
    if (own) {
      const int src = __ffs(own) - 1;
      const int lw = __shfl_sync(kFull, mine == kRpt ? orow : tid + max(mine, 0) * kThreads, src);
      if (lane == src) {
        keys[slot + b] = bb;
        *reinterpret_cast<int*>(rc) = r0 + lw;
      }
      const uint4* row4 = reinterpret_cast<const uint4*>(P + (i64)lw * rs);
      uint4* rec4 = reinterpret_cast<uint4*>(rc + 16);
      for (int k = j / kV + lane; k < nw; k += 32) rec4[k] = row4[k];
      __syncwarp();
      if (lane == 0) gridbar::arrive(ctr);
    } else if (bb == 0 && tid == 0) {
      keys[slot + b] = 0;
      gridbar::arrive(ctr);
    }
    // ---- 3. the winner: warp 0 reduces the G keys and reads its record
    if (warp == 0) {
      if (lane == 0) gridbar::wait(ctr, (unsigned)(G * (j + 1)));
      __syncwarp();
      u64 kv[kMaxG / 32];
#pragma unroll
      for (int i = 0; i < kMaxG / 32; ++i) {  // all in flight at once
        const int t = lane + 32 * i;
        kv[i] = t < G ? __ldcg(keys + slot + t) : 0ull;
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
      // g != 0: off + r <= m, so some row is at position d or below
      const unsigned char* wr = recs + (size_t)(slot + gb) * rb;
      const uint4* w4 = reinterpret_cast<const uint4*>(wr + 16);
      if (lane == 0) {
        win_row = __ldcg(reinterpret_cast<const int*>(wr));
        win_key = g;
        spiv[j] = (int)(0xFFFFFFFFu - (unsigned)(g & 0xFFFFFFFFull));
      }
      for (int k = j / kV + lane; k < nw; k += 32) {
        float v[kV];
        unpack<T>(__ldcg(w4 + k), v);
        float4* u4 = reinterpret_cast<float4*>(us + k * kV);
#pragma unroll
        for (int q = 0; q < kV / 4; ++q)
          u4[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      }
    }
    __syncthreads();
    // ---- 4. swap positions, multipliers (fp32 divide rounded to T), update
    const int o = win_row;
    const int cp = (int)(0xFFFFFFFFu - (unsigned)(win_key & 0xFFFFFFFFull));
    const float pv = us[j];
    const float safe = pv == 0.0f ? 1.0f : pv;
    const bool more = j + 1 < r;
    const int k0 = (j + 1) / kV, e1 = j + 1 - k0 * kV;
#pragma unroll
    for (int q = 0; q < kRpt; ++q) {
      const int l = tid + q * kThreads;
      if (l < nrows) {
        p[q] = swapped(p[q], r0 + l, o, d, cp);
        if (more && p[q] > d) {
          const float mult = round_to<T>(div_rn(a[q], safe));
          a[q] = update_row<T>(P + (i64)l * rs, k0, nw, mult, us, e1);
        }
      }
    }
    if constexpr (kOver) {
      for (int l = kReg + tid; l < nrows; l += kThreads) {
        const int pl = swapped(ps[l], r0 + l, o, d, cp);
        ps[l] = pl;
        if (more && pl > d) {
          const float mult = round_to<T>(div_rn(to_f32(P[(i64)l * rs + j]), safe));
          update_row<T>(P + (i64)l * rs, k0, nw, mult, us, e1);
        }
      }
    }
    if (b == 0 && tid == 0) {
      piv[j] = cp;
      srcs[j] = o;
    }
  }
  // ---- row maps: perm[pos[row]] = row, composed[pos[row]] = prev[row], and
  // srcs[r + j] = perm[piv[j]] for the rows of this block (spiv was written
  // before the last column's second block barrier)
#pragma unroll
  for (int q = 0; q < kRpt; ++q) {
    const int l = tid + q * kThreads;
    if (l < nrows) {
      const int pq = p[q];
      perm[pq] = r0 + l;
      cperm[pq] = prev[r0 + l];
      if (pq >= off)
        for (int jj = 0; jj < r; ++jj)
          if (spiv[jj] == pq) srcs[r + jj] = r0 + l;
    }
  }
  if constexpr (kOver) {
    for (int l = kReg + tid; l < nrows; l += kThreads) {
      const int pl = ps[l];
      perm[pl] = r0 + l;
      cperm[pl] = prev[r0 + l];
      if (pl >= off)
        for (int jj = 0; jj < r; ++jj)
          if (spiv[jj] == pl) srcs[r + jj] = r0 + l;
    }
  }
  if (tid == 0) gridbar::depart(ctr);
}

struct Plan {
  int G, rpb;
  size_t smem, panel_bytes;
};

Plan plan(int m, int r, int tsize, int gmax) {
  Plan p;
  p.G = min(min(sm_count(), gmax), kMaxG);
  p.rpb = (m + p.G - 1) / p.G;
  p.G = (m + p.rpb - 1) / p.rpb;
  const Layout lay(r, p.rpb, tsize);
  const size_t slice = (size_t)p.rpb * stride_words(r, tsize) * 16;
  // 1 KB of the opt-in limit is left for the kernel's static shared memory
  if (lay.panel + slice + 1024 <= (size_t)device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin)) {
    p.smem = lay.panel + slice;
    p.panel_bytes = 0;
  } else {
    p.smem = lay.panel;
    p.panel_bytes = (size_t)p.G * slice;
  }
  return p;
}

template <typename T, typename Tin, bool kOver>
cudaError_t launch_over(const Plan& p, void** args, cudaStream_t stream) {
  const void* fn = (const void*)hgetf2_kernel<T, Tin, kOver>;
  cudaError_t err = dyn_smem(fn, (int)p.smem);
  if (err != cudaSuccess) return err;
  if (occupancy(fn, kThreads, p.smem) * sm_count() < p.G)
    return cudaErrorCooperativeLaunchTooLarge;
  return cudaLaunchCooperativeKernel(fn, dim3(p.G), dim3(kThreads), args, p.smem, stream);
}

template <typename T, typename Tin>
int launch(int m, int r, const void* in, i64 ld, int off, const int* prev, int* piv,
           int* perm, int* cperm, int* srcs, void* scratch, void* panel, int gmax,
           cudaStream_t stream) {
  const Plan p = plan(m, r, (int)sizeof(T), gmax);
  if (p.panel_bytes && panel == nullptr) return (int)cudaErrorInvalidValue;
  unsigned* ctr = reinterpret_cast<unsigned*>(scratch);
  u64* keys = reinterpret_cast<u64*>((unsigned char*)scratch + kCtrBytes);
  unsigned char* recs = (unsigned char*)scratch + kCtrBytes + align16((size_t)2 * gmax * 8);
  const Tin* inp = (const Tin*)in;
  T* gpanel = p.panel_bytes ? (T*)panel : nullptr;
  int mm = m, rr = r, oo = off, rpb = p.rpb;
  void* args[] = {&mm, &rr, &inp, &ld, &oo, &prev, &piv, &perm, &cperm, &srcs,
                  &ctr, &keys, &recs, &gpanel, &rpb};
  cudaError_t err = p.rpb > kRpt * kThreads ? launch_over<T, Tin, true>(p, args, stream)
                                            : launch_over<T, Tin, false>(p, args, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int tsize_of(int kind) { return kind == 0 ? 4 : 2; }

}  // namespace

// Bytes of the scratch for launches of up to r columns on grids of up to
// gmax blocks: the grid barrier's counters, two key slots and two record
// slots a block (the wrapper allocates it zeroed, once per device and
// stream, and grows it for a wider r; each launch leaves the counters at 0).
MPF_API long long mpf_hgetf2_scratch_bytes(int r, int gmax) {
  return (long long)(kCtrBytes + align16((size_t)2 * gmax * 8) + 2 * (size_t)gmax * rec_bytes(r, 4));
}

// Bytes of the global panel a launch needs when its row slices do not fit
// in shared memory (0 when they do).  panel_kind: 0 fp32, 1 bf16, 2 fp16.
MPF_API long long mpf_hgetf2_panel_bytes(int m, int r, int panel_kind, int gmax) {
  return (long long)plan(m, r, tsize_of(panel_kind), gmax).panel_bytes;
}

// in_same: 0 -> the input is the fp32 working panel (cast in-kernel, round
// to nearest even); 1 -> the input is already in the panel dtype.
MPF_API int mpf_hgetf2(int m, int r, const void* in, i64 ld, int in_same, int panel_kind,
                       int off, const int* prev, int* piv, int* perm, int* cperm, int* srcs,
                       void* scratch, void* panel, int gmax, void* stream) {
  if (m <= 0 || r <= 0 || off < 0 || off + r > m) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  typedef __nv_bfloat16 bf;
  if (panel_kind == 0)
    return launch<float, float>(m, r, in, ld, off, prev, piv, perm, cperm, srcs, scratch,
                                panel, gmax, st);
  if (panel_kind == 1)
    return in_same ? launch<bf, bf>(m, r, in, ld, off, prev, piv, perm, cperm, srcs, scratch,
                                    panel, gmax, st)
                   : launch<bf, float>(m, r, in, ld, off, prev, piv, perm, cperm, srcs,
                                       scratch, panel, gmax, st);
  if (panel_kind == 2)
    return in_same ? launch<__half, __half>(m, r, in, ld, off, prev, piv, perm, cperm, srcs,
                                            scratch, panel, gmax, st)
                   : launch<__half, float>(m, r, in, ld, off, prev, piv, perm, cperm, srcs,
                                           scratch, panel, gmax, st);
  return (int)cudaErrorInvalidValue;
}
