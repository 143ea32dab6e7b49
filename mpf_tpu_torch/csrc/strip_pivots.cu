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
// panel is read once): r sequential grid-wide pivot searches, each an
// exchange of the G blocks' candidates through L2.  The m x r panel (4 MiB
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
//   2. the lane holding the block's candidate writes the block's slot for
//      the column — its key, the value's sign, its strip values past the
//      column — as flagged 8-byte words (payload beside the launch's flag,
//      as NCCL's LL protocol does) with plain relaxed stores: no fence, no
//      counter; its warp writes the candidate's tail (its multipliers of
//      the strip so far and its later-strip values, all a winning pivot row
//      gives the deferred update) the same way;
//   3. warp 0 reads the G slots' keys with every load in flight until all
//      carry the launch's flag, reduces them (lane t takes blocks t, t + 32,
//      ..., then a butterfly; the key's |value| bits and the sign are the
//      pivot value), then reads the rest of the winner's slot, its strip
//      values: two L2 round trips once every candidate is there, where the
//      arrival counter took a release, the counter's round trip and the
//      same two reads; the second block barrier;
//   4. every thread swaps positions (the winning block knows its row),
//      divides and updates its rows' strip.
// The keys are unique (each carries its row's position), so the winner
// does not depend on how they travel.  At a strip's end warp 0 polls the 8
// winners' tails (written up to 7 columns before) and forms (I+N)^{-1}, so
// no grid-wide step publishes the pivot rows, and the deferred update
// skips the rows that can no longer pivot (frozen, dead, or pivots of this
// strip: their values are never read again).  Three block barriers a
// strip.  The flag is the launch count kept in the scratch, plus 1 (past
// 0, the zeroed scratch's): every block reads it at its start and stores
// it back at its end, so a slot left by an earlier launch (another r,
// another G) never reads as current, and a CUDA graph of the loop stays
// correct (a flag comes round again only after 2^32 - 1 launches).  The
// slots and tails are per column and block, kept per device and stream by
// the wrapper (r x G x 1104 B, about 18.7 MB at r = 128, G = 132).
//
// Measured on the H100 (PERF.md §6): a load under a branch ends its
// basic block and waits for the load before it, so the polls' loads are
// unconditional or predicated; every 16-byte chunk all G slots carry costs
// each block a read of G chunks from lines every block reads, about 0.2 us
// a column each, more than the winner's chunks read after the keys; and
// the tails read at the strip's end beat async copies issued each column.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kW = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 128;
constexpr int kMaxRpt = 3;  // rows a thread holds in registers; more in shared memory
constexpr int kMaxG = 160;  // blocks (one an SM): warp 0 polls five slots a lane
constexpr int kSent = 0x7FFFFFFF;
constexpr unsigned kFull = 0xffffffffu;
typedef unsigned long long u64;

// A candidate's tail is what the deferred update needs of a pivot row: its
// multipliers of the strip so far (0 from the candidate's own column on),
// then its values in the later strips (columns f0.. of the panel), as
// flagged words (below), kExtra a column and block.
constexpr int kExtra = kMaxR;  // kW multipliers + at most kMaxR - kW later values

// the scratch: a header of counters, then r x G slots, then r x G tails
constexpr size_t kCtrBytes = 256;

// ---- the candidate exchange: flagged slots ---------------------------------
// A slot word is 4 bytes of payload beside the launch's 4-byte flag, stored
// and loaded as one aligned 8-byte access, which PTX makes single-copy
// atomic (a 16-byte vector access is two of them): a word that carries the
// launch's flag holds that launch's payload, in whatever order the words
// arrive.  The slot of block b for column j (jc = j mod 8) holds the
// candidate's key — its high half (|value| bits, top bit 0) with the
// value's sign in the top bit, so the pivot value comes back exactly — in
// chunk 0 (16 bytes), and its strip values past column jc in the next:
// 9 - jc words, chunk c at ((j kSlotChunks + c) G + b), so the G keys of a
// column are contiguous.  The flag is the launch count kept in the
// scratch's header, plus 1, never 0.
constexpr int kSlotWords = 2 + kW - 1;             // key high and sign, key low, later values
constexpr int kSlotChunks = (kSlotWords + 1) / 2;  // 16-byte chunks
constexpr int kEpochWord = 2;                      // header words: launches so far
constexpr int kPollWord = 3;                       // block 0's poll rounds (exchange_polls)

// the k-th flag after `last` (k >= 1): the launch count wraps past 0, the
// zeroed scratch's flag, so a word never written never reads as current
__device__ __forceinline__ unsigned flag_after(unsigned last, unsigned k) {
  const unsigned f = last + k;
  return f < last ? f + 1u : f;
}

__device__ __forceinline__ u64 ll(unsigned payload, unsigned flag) {
  return (u64)flag << 32 | payload;
}
__device__ __forceinline__ bool current(u64 a, u64 b, unsigned flag) {
  return (unsigned)(a >> 32) == flag && (unsigned)(b >> 32) == flag;
}
__device__ __forceinline__ void st_ll(u64* p, u64 a) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(a) : "memory");
}
__device__ __forceinline__ void st_ll2(u64* p, u64 a, u64 b) {
  asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(a), "l"(b)
               : "memory");
}
__device__ __forceinline__ void ld_ll2(const u64* p, u64& a, u64& b) {
  asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];" : "=l"(a), "=l"(b) : "l"(p)
               : "memory");
}
// ld_ll2 if `take`, as a predicated load: a branch around a load would end
// its basic block, and the loads after it would wait for it
__device__ __forceinline__ void ld_ll2_if(const u64* p, u64& a, u64& b, unsigned take) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.u32 q, %3, 0;\n"
      " @q ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];\n}"
      : "+l"(a), "+l"(b)
      : "l"(p), "r"(take)
      : "memory");
}

// one lane writes block b's slot for column j: the key, the sign of v[jc]
// and the strip values v[jc + 1..kW)
__device__ __forceinline__ void put_slot(u64* slots, int j, int jc, int G, int b, unsigned flag,
                                         u64 key, const float (&v)[kW]) {
  unsigned w[2 * kSlotChunks];
  w[0] = (unsigned)(key >> 32) | (__float_as_uint(v[jc]) & 0x80000000u);
  w[1] = (unsigned)key;
#pragma unroll
  for (int i = 2; i < 2 * kSlotChunks; ++i)
    w[i] = i - 1 + jc < kW ? __float_as_uint(v[i - 1 + jc]) : 0u;
  u64* p = slots + 2 * ((size_t)j * kSlotChunks * G + b);
#pragma unroll
  for (int c = 0; c < kSlotChunks; ++c)
    if (2 * c < kSlotWords - jc)
      st_ll2(p + 2 * (size_t)c * G, ll(w[2 * c], flag), ll(w[2 * c + 1], flag));
}

// Warp 0: the keys (chunk 0) of the G slots of column j, polled until
// every word read carries `flag` (each round reads them all, a lane's
// blocks past G clamped to block G - 1: read, never used; loads under no
// branch are all in flight at once, where a branch around each would wait
// for the one before), reduced as lane t taking blocks t, t + 32, ... (only
// a strictly larger key replaces), then a butterfly; then lane k reads
// chunk k + 1 of the winner's slot.  Writes the pivot value (the key's
// |value| bits and the sign) and the values past it to win_vals[jc..kW)
// (zeros if no row can pivot).  Returns the keys' poll rounds; g is the
// winning key (0: none), gb its block.
__device__ __forceinline__ int poll_slots(const u64* slots, int j, int jc, int G, unsigned flag,
                                          int lane, u64& g, int& gb, float* win_vals) {
  constexpr int kLaneSlots = kMaxG / 32;
  const u64* p = slots + 2 * (size_t)j * kSlotChunks * G;
  u64 x[kLaneSlots][2];
  int rounds = 0;
  bool stale;
  do {
#pragma unroll
    for (int i = 0; i < kLaneSlots; ++i) ld_ll2(p + 2 * min(lane + 32 * i, G - 1), x[i][0], x[i][1]);
    stale = false;
#pragma unroll
    for (int i = 0; i < kLaneSlots; ++i) stale |= !current(x[i][0], x[i][1], flag);
    ++rounds;
  } while (__any_sync(kFull, stale));
  g = 0;
  int gi = 0;
#pragma unroll
  for (int i = 0; i < kLaneSlots; ++i) {
    const u64 k = (x[i][0] & 0x7FFFFFFFull) << 32 | (unsigned)x[i][1];
    if (lane + 32 * i < G && k > g) g = k, gi = i;
  }
  unsigned hi = 0;  // the key's high word with the sign
#pragma unroll
  for (int i = 0; i < kLaneSlots; ++i)
    if (i == gi) hi = (unsigned)x[i][0];
  gb = lane + 32 * gi;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const u64 go = __shfl_xor_sync(kFull, g, o);
    const int bo = __shfl_xor_sync(kFull, gb, o);
    if (go > g) g = go, gb = bo;
  }
  const int nc = (kSlotWords - jc + 1) / 2;
  u64 y0 = 0, y1 = 0;
  unsigned need = g != 0 && lane + 1 < nc;
  while (__any_sync(kFull, need)) {
    ld_ll2_if(p + 2 * ((size_t)(lane + 1) * G + gb), y0, y1, need);
    need &= !current(y0, y1, flag);
  }
  if (g == 0) {
    if (lane < kW) win_vals[lane] = 0.0f;
  } else {
    if (lane == (gb & 31)) win_vals[jc] = __uint_as_float(hi);
    const int c = jc + 1 + 2 * lane;
    if (lane + 1 < nc) win_vals[c] = __uint_as_float((unsigned)y0);
    if (lane + 1 < nc && c + 1 < kW) win_vals[c + 1] = __uint_as_float((unsigned)y1);
  }
  return rounds;
}

// the tail of block b's candidate for column j
__device__ __forceinline__ u64* tail_of(u64* tails, int j, int G, int b) {
  return tails + ((size_t)j * G + b) * kExtra;
}

// Warp 0 at a strip's end: the tails of the strip's winners (blk[q], the
// block that won column j0 + q; -1 for none), nw words each, polled as the
// slots are (every load under no branch), into ex (zeros past nw and for
// no winner).  Lane t reads words 4t .. 4t + 3 of each.
__device__ __forceinline__ void poll_tails(u64* tails, int j0, int G, unsigned flag,
                                           const int* blk, int nw, int lane,
                                           float (*ex)[kExtra]) {
  u64 y[kW][4];
  bool stale;
  do {
#pragma unroll
    for (int q = 0; q < kW; ++q) {
      const u64* t = tail_of(tails, j0 + q, G, max(blk[q], 0)) + 4 * lane;
      ld_ll2(t, y[q][0], y[q][1]);
      ld_ll2(t + 2, y[q][2], y[q][3]);
    }
    stale = false;
#pragma unroll
    for (int q = 0; q < kW; ++q)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        stale |= blk[q] >= 0 && 4 * lane < nw && (unsigned)(y[q][k] >> 32) != flag;
  } while (__any_sync(kFull, stale));
#pragma unroll
  for (int q = 0; q < kW; ++q) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (blk[q] >= 0 && 4 * lane < nw)
      v = make_float4(__uint_as_float((unsigned)y[q][0]), __uint_as_float((unsigned)y[q][1]),
                      __uint_as_float((unsigned)y[q][2]), __uint_as_float((unsigned)y[q][3]));
    reinterpret_cast<float4*>(ex[q])[lane] = v;
  }
}

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
                 int quant16, unsigned* ctr, u64* slots, u64* tails, int rpb) {
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
  __shared__ int cand;  // the block's candidate row (of its slice) for the column
  __shared__ __align__(16) float win_vals[kW];
  __shared__ __align__(16) float ex[kW][kExtra];  // the strip's winning records' tails
  __shared__ float vinv[kW][kW];
  __shared__ float pws[2][kW][kW];                 // powers of -N, one column a lane
  __shared__ float Us[kW][kMaxR];                  // rounded (T S)(I+N)^{-1}, transposed
  __shared__ int win_blk[kW];                      // the strip's winning blocks

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, G = gridDim.x;
  const int r0 = b * rpb;
  const int nrows = max(0, min(rpb, m - r0));
  const int nstrips = r / kW;
  const unsigned flag = flag_after(__ldcg(ctr + kEpochWord), 1u);  // this launch's
  unsigned polls = 0;                                              // warp 0's poll rounds

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
      // ---- 2. the owning lane writes the block's slot (plain stores, no
      // fence), its warp the candidate's tail (unless this is the last strip)
      int mine = -1;
#pragma unroll
      for (int q = 0; q < kRpt; ++q)
        if (bb != 0 && key[q] == bb) mine = q;
      if (kOver && bb != 0 && okey == bb) mine = kRpt;
      const unsigned own = __ballot_sync(kFull, mine >= 0);
      if (own) {
        const int src = __ffs(own) - 1;
        const int lw = __shfl_sync(kFull, mine == kRpt ? orow : tid + max(mine, 0) * kThreads, src);
        if (lane == src) cand = lw;
        u64* tl = tail_of(tails, j, G, b);
#pragma unroll
        for (int q = 0; q < kRpt; ++q) {
          if (lane == src && mine == q) {
            put_slot(slots, j, jc, G, b, flag, bb, st[q]);
            if (!last) {
#pragma unroll
              for (int c = 0; c < kW; c += 2)
                st_ll2(tl + c, ll(__float_as_uint(mb[q][c]), flag),
                       ll(__float_as_uint(mb[q][c + 1]), flag));
            }
          }
        }
        if (kOver && lane == src && mine == kRpt) {  // an overflow row
          const float* o = ostrip(Ts, so, rs, lw, s, kReg);
          float v[kW];
#pragma unroll
          for (int c = 0; c < kW; ++c) v[c] = o[c];
          put_slot(slots, j, jc, G, b, flag, bb, v);
          if (!last) {
#pragma unroll
            for (int c = 0; c < kW; ++c)
              st_ll(tl + c, ll(__float_as_uint(to_f32(mq[lw * kW + c])), flag));
          }
        }
        if (!last) {
          float lv[4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            lv[kk] = lane + 32 * kk < nf ? to_f32(Ts[lw * rs + f0 + lane + 32 * kk]) : 0.0f;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (lane + 32 * kk < nf)
              st_ll(tl + kW + lane + 32 * kk, ll(__float_as_uint(lv[kk]), flag));
        }
      } else if (bb == 0 && tid == 0) {
        const float zero[kW] = {};
        put_slot(slots, j, jc, G, b, flag, 0, zero);
      }
      // ---- 3. the winner: warp 0 polls the G keys, reduces them and reads
      // the winner's values
      if (warp == 0) {
        u64 g;
        int gb;
        polls += poll_slots(slots, j, jc, G, flag, lane, g, gb, win_vals);
        if (lane == 0) {
          win_key = g;
          win_blk[jc] = g != 0 ? gb : -1;
        }
      }
      __syncthreads();
      // ---- 4. swap positions, multipliers, in-strip rank-1 update
      // the winner's row is this block's candidate, `cand`, if it won; the
      // pivot value is the key's |value| bits (quant16: truncated) with the sign
      const u64 g = win_key;
      const bool won = win_blk[jc] == b;
      unsigned cp = (unsigned)d;
      float safe = 1.0f;
      if (g != 0) {
        cp = 0xFFFFFFFFu - (unsigned)(g & 0xFFFFFFFFull);
        safe = (unsigned)(g >> 32) == 0 ? 1.0f : win_vals[jc];
      }
#pragma unroll
      for (int q = 0; q < kRpt; ++q) {
        const int l = tid + q * kThreads;
        if (l < nrows) {
          int pq = p[q];
          if (won && l == cand)
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
          if (won && l == cand)
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
      if (tid == 0) {
        if (b == 0) piv[j] = (int)cp;
        if (won || (g == 0 && b == 0)) glist[j] = won ? r0 + cand : -1;
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
      poll_tails(tails, s * kW, G, flag, win_blk, kW + nf, lane, ex);
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
  // the next launch's flag: no block gets here before every block has read
  // this one's (none passes column 0 before all have written their slot)
  if (tid == 0) {
    if (b == 0) atomicAdd(ctr + kPollWord, polls);
    ctr[kEpochWord] = flag;
  }
}

// Grid barrier probe (no pivot search): `iters` barriers of the G blocks of
// one cooperative launch of 256 threads.  kind 0: cooperative groups'
// grid.sync(); kind 1: an arrival counter (gridbar::, kernel 7's and kernel
// 1's before its slots), block barriers around it; kind 2: kind 1 with a
// read of the G keys behind it (each block writes a key before arriving,
// warp 0 reads the G keys after); kind 3:
// kernel 1's exchange alone, block barriers around it (thread 0 writes the
// block's slot, warp 0 polls the G keys, reduces them and reads the
// winner's values; columns jc = 0..7 in turn, so `iters` is a multiple of
// 8); kind 4: kind 3 with a released record (warp 0 writes 128 flagged
// words, then a release fence before the slot, and an acquire fence after
// the poll).
__global__ void __launch_bounds__(kThreads, 1)
    barrier_probe_kernel(int kind, int iters, unsigned* ctr, u64* keys, u64* tails) {
  __shared__ u64 seen;
  __shared__ float vals[kW];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, G = gridDim.x;
  if (kind >= 3) {
    const unsigned last = __ldcg(ctr + kEpochWord);
    for (int it = 0; it < iters; it += kW) {
#pragma unroll
      for (int jc = 0; jc < kW; ++jc) {
        const int j = (it + jc) & (kMaxR - 1);
        const unsigned f = flag_after(last, (unsigned)(it + jc + 1));
        __syncthreads();
        if (kind == 4 && warp == 0) {
          u64* tl = tail_of(tails, j, G, b);
#pragma unroll
          for (int k = 0; k < kExtra / 32; ++k) st_ll(tl + lane + 32 * k, ll(lane + k, f));
          __syncwarp();
          if (lane == 0) asm volatile("fence.acq_rel.gpu;" ::: "memory");
          __syncwarp();
        }
        if (tid == 0) {
          float v[kW];
#pragma unroll
          for (int c = 0; c < kW; ++c) v[c] = (float)(b + c);
          put_slot(keys, j, jc, G, b, f, (u64)(it + jc + 1) << 32 | (unsigned)b, v);
        }
        if (warp == 0) {
          u64 g;
          int gb;
          poll_slots(keys, j, jc, G, f, lane, g, gb, vals);
          if (kind == 4 && lane == 0) asm volatile("fence.acq_rel.gpu;" ::: "memory");
          if (lane == (gb & 31)) seen = g;
        }
        __syncthreads();
      }
    }
    if (tid == 0) ctr[kEpochWord] = flag_after(last, (unsigned)iters);
    return;
  }
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
  u64* slots = reinterpret_cast<u64*>(scratch + kCtrBytes);
  u64* tails = slots + (size_t)kMaxR * gmax * 2 * kSlotChunks;
  void* args[] = {&m, &r, &slab, &ld, &jj0, &off, &pos, &piv, &glist, &quant16,
                  &ctr, &slots, &tails, &rpb};
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
// allocates it zeroed, once per device and stream; the launch count in its
// header carries from one launch to the next, the probe's counters return
// to 0).
MPF_API long long mpf_strip_scratch_bytes(int gmax) {
  return (long long)(kCtrBytes + (size_t)kMaxR * gmax * (kSlotChunks * 16 + kExtra * sizeof(u64)));
}

// slab_bf16: the slab is stored in bf16 (ALL_BF16; the panel is then bf16
// too and is taken as stored), else fp32 (converted to the panel dtype).
MPF_API int mpf_strip_pivots(int m, int r, const void* slab, i64 ld, int jj0, int off,
                             int* pos, int* piv, int* glist, int slab_bf16,
                             int panel_bf16, int quant16, void* scratch, int gmax,
                             void* stream) {
  if (r % kW != 0 || r <= 0 || r > kMaxR || m <= 0) return (int)cudaErrorInvalidValue;
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
  if (kind < 0 || kind > 4 || iters <= 0 || (kind >= 3 && iters % kW != 0))
    return (int)cudaErrorInvalidValue;
  const int G = min(min(sm_count(), gmax), kMaxG);
  unsigned* ctr = reinterpret_cast<unsigned*>(scratch);
  u64* keys = reinterpret_cast<u64*>((unsigned char*)scratch + kCtrBytes);
  u64* tails = keys + (size_t)kMaxR * gmax * 2 * kSlotChunks;
  const void* fn = (const void*)barrier_probe_kernel;
  if (occupancy(fn, kThreads, 0) * sm_count() < G)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&kind, &iters, &ctr, &keys, &tails};
  cudaError_t err = cudaLaunchCooperativeKernel(fn, dim3(G), dim3(kThreads), args, 0,
                                                (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
