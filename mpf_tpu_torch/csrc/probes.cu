// Kernels 16a-16c, 16e-16g, 16i and 16j: the design probes of tools/ on the
// card (the GEMM probes, 16d and 16k, are in probes_gemm.cu).
//
// Replaces (each a pl.pallas_call of a TPU tool; the function it computes):
//   16a tools/tpu_probe_r4.py:probe_smem kern (:48)
//       out = x + f32(s[0] + s[ns/2] + s[ns-1]) for an int32 schedule s
//       -> mpf_probe_sched_read
//   16b tools/tpu_probe_r4.py:probe_hbm2smem kern (:83)
//       s[off : off+count] copied into on-chip memory, waited on, then
//       out = x + f32(ssc[0] + ssc[count-1])          -> mpf_probe_bulk_copy
//   16c tools/tpu_probe_r4.py:probe_rowdma kern (:142)
//       nrows reads of row (i * stride) mod n of an (n, w) fp32 array through
//       a ring of `depth` buffers; out = the last row read into slot 0, the
//       row of the largest i < nrows with i mod depth == 0 -> mpf_probe_row_ring
//   16e tools/tpu_granule_r5.py:_rmw_kernel (via build_rmw, :122) and
//   16j tools/tpu_refview_r5.py:_kernel (via build, :79)
//       in place on (nwin, g, w): a[ids[i]] = T(f32(a[ids[i]]) + 1) for E
//       distinct window ids                          -> mpf_probe_window_rmw
//   16f tools/tpu_granule_r5.py:_gath_kernel (via build_gath, :149)
//       out (1, w) fp32 = sum over i < E, in order of i, of
//       f32(a[ids[i], i mod g, :])                   -> mpf_probe_window_gather
//   16g tools/tpu_3d_micro.py:_copy_reshape_kernel tchunk mode (via :65)
//       (c, 2, w) -> (w, 2c), the transpose          -> mpf_probe_transpose
//       (its collapse and split modes are views on the card: kernel 15a's
//       mpf_block_copy in pair3d.cu copies them)
//   16i tools/tpu_xsel_micro.py:_kernel / _kernel_dma (via build, :120)
//       E dynamic row indices into a (g, xw) bf16 window held on chip:
//       extract (masked, roll, dot) out = sum_e f32(win[ids[e]]);
//       overlay (store) win[ids[e]] = bf16(e), out = f32(win[0]);
//       copy-out (dma) row[e mod 4] = win[ids[e]], out = f32(win[0]) + f32(row[0]);
//       copy-in (dstore) win[ids[e]] = row[e mod 4] (zeros), out as copy-out
//                                                    -> mpf_probe_xsel
//
// What bounds each on the H100, and what the design does about it:
//   16a, 16b: launch latency (a few KB).  16b is the port's first TMA code:
//     one thread arms an mbarrier with the bytes it expects and issues a 1-D
//     cp.async.bulk into shared memory; every thread waits on the barrier's
//     phase (tma:: helpers in common.cuh, meant for later GEMM rings).
//   16c: bytes, nrows * w * 4 read.  The rows are strided, so each is its
//     own stream of 32 KB; one warp a block on every SM keeps `depth` 4 KB
//     row chunks in flight with cp.async.bulk, one mbarrier a slot; the
//     (row, chunk) items go round-robin over the blocks, so depth * 4 KB *
//     SMs bytes are in flight.  The block that lands a chunk of the named row
//     writes it to out.
//   16e, 16j: bytes, 2 * E * g * w * elem.  One block a window slice, each
//     thread `depth` 16-byte loads in flight before its adds and stores; the
//     card's granule is a 32-byte sector, not a 16-row window.
//   16f: bytes, E * w * elem: only the row each visit names is read.  One
//     thread a column sums its E values in order of i in fp32 (so the sum
//     is the TPU's bit for bit), with `depth` loads in flight.
//   16g: bytes, 2 * 2c * w * elem; 32 x 32 shared-memory tiles, one padding
//     column, so both the read and the write are coalesced.
//   16i: on-chip latency, E dependent shared-memory accesses a column.  The
//     1 MB window exceeds a block's 227 KB, so each block holds a (g, 256)
//     slice of it in shared memory, one thread a column, and walks all E
//     entries in order; blocks never exchange data.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// int32 sums wrap as the TPU's do
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// ---- 16a ----------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    sched_read_kernel(int ns, const int* __restrict__ sched, const float* __restrict__ x,
                      float* __restrict__ out, int nx) {
  const float a = (float)wrap_add(wrap_add(sched[0], sched[ns / 2]), sched[ns - 1]);
  for (int i = threadIdx.x; i < nx; i += kThreads) out[i] = __fadd_rn(x[i], a);
}

// ---- 16b ----------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    bulk_copy_kernel(const int* __restrict__ sched, int off, int count,
                     const float* __restrict__ x, float* __restrict__ out, int nx) {
  extern __shared__ __align__(128) int ssc[];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x == 0) {
    tma::mbar_init(&bar, 1);
    tma::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) tma::load_async(ssc, sched + off, (uint32_t)count * 4, &bar);
  tma::mbar_wait(&bar, 0);
  const float a = (float)wrap_add(ssc[0], ssc[count - 1]);
  for (int i = threadIdx.x; i < nx; i += kThreads) out[i] = __fadd_rn(x[i], a);
}

// ---- 16c ----------------------------------------------------------------
constexpr int kRingChunk = 1024;   // fp32 elements a slot: 4 KB
constexpr int kRingMaxDepth = 48;  // 48 slots + their barriers fit 227 KB
constexpr int kRingBarBytes = kRingMaxDepth * 8;

// the block's items (read i, row chunk c), stepping by the grid: 32-bit
// counters, no division in the loop
struct RingCursor {
  int i, c;
  __device__ __forceinline__ void step(int di, int dc, int nchunks) {
    i += di;
    c += dc;
    if (c >= nchunks) {
      c -= nchunks;
      ++i;
    }
  }
};

__global__ void __launch_bounds__(32)
    row_ring_kernel(int n, int w, const float* __restrict__ src, i64 lds, int nrows,
                    int stride, int depth, int target, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring_smem);
  float* ring = reinterpret_cast<float*>(ring_smem + kRingBarBytes);
  const int lane = threadIdx.x;
  const int nchunks = (w + kRingChunk - 1) / kRingChunk;
  const int di = gridDim.x / nchunks, dc = gridDim.x % nchunks;
  const RingCursor start = {(int)(blockIdx.x / nchunks), (int)(blockIdx.x % nchunks)};
  RingCursor put = start;  // the next item to issue (lane 0)
  int issued = 0;
  auto issue = [&]() {
    const int row = (int)((unsigned)put.i * (unsigned)stride % (unsigned)n);
    const int len = min(kRingChunk, w - put.c * kRingChunk);
    const int s = issued % depth;
    tma::load_async(ring + (i64)s * kRingChunk, src + row * lds + (i64)put.c * kRingChunk,
                    (uint32_t)len * 4, &bars[s]);
    put.step(di, dc, nchunks);
    ++issued;
  };
  if (lane == 0) {
    for (int s = 0; s < depth; ++s) tma::mbar_init(&bars[s], 1);
    tma::fence_barrier_init();
    while (issued < depth && put.i < nrows) issue();
  }
  __syncwarp();
  int k = 0;
  for (RingCursor get = start; get.i < nrows; get.step(di, dc, nchunks), ++k) {
    const int s = k % depth;
    tma::mbar_wait(&bars[s], (uint32_t)(k / depth) & 1);
    const bool named = get.i == target;
    if (named) {
      const int len = min(kRingChunk, w - get.c * kRingChunk);
      for (int e = lane; e < len; e += 32)
        out[(i64)get.c * kRingChunk + e] = ring[(i64)s * kRingChunk + e];
    }
    __syncwarp();  // every lane is past its wait and its reads of slot s
    if (lane == 0 && put.i < nrows) {
      if (named) tma::fence_proxy_async();
      issue();
    }
  }
}

// ---- 16e, 16j -----------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    window_rmw_kernel(int nwin, i64 win, T* __restrict__ a, const int* __restrict__ ids) {
  constexpr int V = 16 / sizeof(T);
  const int id = ids[blockIdx.x];
  if (id < 0 || id >= nwin) return;  // not a window: nothing to visit
  T* base = a + (i64)id * win;
  const i64 span = (i64)kThreads * D * V;  // elements of one blockIdx.y slice
  const i64 e0 = (i64)blockIdx.y * span;
  const bool vec = win % V == 0 && (reinterpret_cast<uintptr_t>(base) & 15) == 0;
  if (vec) {
    uint4 v[D];
#pragma unroll
    for (int q = 0; q < D; ++q) {
      const i64 e = e0 + ((i64)q * kThreads + threadIdx.x) * V;
      if (e < win) v[q] = *reinterpret_cast<const uint4*>(base + e);
    }
#pragma unroll
    for (int q = 0; q < D; ++q) {
      const i64 e = e0 + ((i64)q * kThreads + threadIdx.x) * V;
      if (e < win) {
        T* t = reinterpret_cast<T*>(&v[q]);
#pragma unroll
        for (int u = 0; u < V; ++u) t[u] = from_f32<T>(__fadd_rn(to_f32(t[u]), 1.0f));
        *reinterpret_cast<uint4*>(base + e) = v[q];
      }
    }
  } else {
    const i64 e1 = min(e0 + span, win);
    for (i64 e = e0 + threadIdx.x; e < e1; e += kThreads)
      base[e] = from_f32<T>(__fadd_rn(to_f32(base[e]), 1.0f));
  }
}

template <typename T>
int launch_rmw(int nids, int nwin, i64 win, T* a, const int* ids, int depth,
               cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  auto grid = [&](int d) { return dim3(nids, (unsigned)((win + (i64)kThreads * d * V - 1) /
                                                       ((i64)kThreads * d * V))); };
  switch (depth) {
    case 1: window_rmw_kernel<T, 1><<<grid(1), kThreads, 0, st>>>(nwin, win, a, ids); break;
    case 4: window_rmw_kernel<T, 4><<<grid(4), kThreads, 0, st>>>(nwin, win, a, ids); break;
    case 8: window_rmw_kernel<T, 8><<<grid(8), kThreads, 0, st>>>(nwin, win, a, ids); break;
    case 16: window_rmw_kernel<T, 16><<<grid(16), kThreads, 0, st>>>(nwin, win, a, ids); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---- 16f ----------------------------------------------------------------
constexpr int kGatherThreads = 128;

template <typename T, int D>
__global__ void __launch_bounds__(kGatherThreads)
    window_gather_kernel(int nvis, int nwin, int g, int w, const T* __restrict__ a,
                         const int* __restrict__ ids, float* __restrict__ out) {
  const int col = blockIdx.x * kGatherThreads + threadIdx.x;
  if (col >= w) return;
  const i64 win = (i64)g * w;
  // visit i's value; an id that names no window adds an exact zero.  The
  // load itself is unconditional (window 0 stands in for such an id): a
  // conditional load read about twice as slow on the card.
  auto val = [&](int i) {
    const int id = ids[i];
    const bool in = (unsigned)id < (unsigned)nwin;
    const float v = to_f32(a[(in ? id : 0) * win + (i64)(i % g) * w + col]);
    return in ? v : 0.0f;
  };
  float acc = 0.0f;
  int i = 0;
  for (; i + D <= nvis; i += D) {
    float v[D];
#pragma unroll
    for (int q = 0; q < D; ++q) v[q] = val(i + q);
#pragma unroll
    for (int q = 0; q < D; ++q) acc = __fadd_rn(acc, v[q]);
  }
  for (; i < nvis; ++i) acc = __fadd_rn(acc, val(i));
  out[col] = acc;
}

template <typename T>
int launch_gather(int nvis, int nwin, int g, int w, const T* a, const int* ids, int depth,
                  float* out, cudaStream_t st) {
  const int grid = (w + kGatherThreads - 1) / kGatherThreads;
#define GATHER_ARGS nvis, nwin, g, w, a, ids, out
  switch (depth) {
    case 1: window_gather_kernel<T, 1><<<grid, kGatherThreads, 0, st>>>(GATHER_ARGS); break;
    case 4: window_gather_kernel<T, 4><<<grid, kGatherThreads, 0, st>>>(GATHER_ARGS); break;
    case 8: window_gather_kernel<T, 8><<<grid, kGatherThreads, 0, st>>>(GATHER_ARGS); break;
    case 16: window_gather_kernel<T, 16><<<grid, kGatherThreads, 0, st>>>(GATHER_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef GATHER_ARGS
  return (int)cudaGetLastError();
}

// ---- 16g ----------------------------------------------------------------
template <typename E>
__global__ void __launch_bounds__(256)
    transpose_kernel(int rows, int cols, const E* __restrict__ src, i64 lds,
                     E* __restrict__ dst, i64 ldd) {
  __shared__ E tile[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int r = r0 + j, c = c0 + threadIdx.x;
    if (r < rows && c < cols) tile[j][threadIdx.x] = src[(i64)r * lds + c];
  }
  __syncthreads();
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int r = c0 + j, c = r0 + threadIdx.x;  // dst row r = src column
    if (r < cols && c < rows) dst[(i64)r * ldd + c] = tile[threadIdx.x][j];
  }
}

// ---- 16i ----------------------------------------------------------------
constexpr int kXCols = 256;  // window columns a block, one thread each
constexpr int kXRows = 4;    // the copy modes' row buffers (the TPU's e mod 4)

__global__ void __launch_bounds__(kXCols)
    xsel_kernel(int mode, int g, int xw, int nent, const __nv_bfloat16* __restrict__ x,
                const int* __restrict__ ids, float* __restrict__ out) {
  typedef __nv_bfloat16 bf;
  extern __shared__ __align__(16) unsigned char xs_smem[];
  int* sid = reinterpret_cast<int*>(xs_smem);
  bf* win = reinterpret_cast<bf*>(xs_smem + ((size_t)nent * 4 + 15) / 16 * 16);
  bf* row = win + (size_t)g * kXCols;
  const int tid = threadIdx.x, col = blockIdx.x * kXCols + tid;
  // an id that names no window row is skipped (-1)
  for (int e = tid; e < nent; e += kXCols)
    sid[e] = (unsigned)ids[e] < (unsigned)g ? ids[e] : -1;
  for (int r = 0; r < g; ++r)
    win[r * kXCols + tid] = col < xw ? x[(i64)r * xw + col] : __float2bfloat16_rn(0.0f);
  for (int q = 0; q < kXRows; ++q) row[q * kXCols + tid] = __float2bfloat16_rn(0.0f);
  __syncthreads();
  if (col >= xw) return;
  // each thread touches only its own column of win and row from here on
  float res;
  if (mode == 0) {  // extract
    float acc = 0.0f;
    for (int e = 0; e < nent; ++e)
      if (sid[e] >= 0) acc = __fadd_rn(acc, to_f32(win[sid[e] * kXCols + tid]));
    res = acc;
  } else {
    if (mode == 1) {  // overlay
      for (int e = 0; e < nent; ++e)
        if (sid[e] >= 0)
          win[sid[e] * kXCols + tid] = __float2bfloat16_rn(__fadd_rn(0.0f, (float)e));
    } else if (mode == 2) {  // copy-out
      for (int e = 0; e < nent; ++e)
        if (sid[e] >= 0) row[(e % kXRows) * kXCols + tid] = win[sid[e] * kXCols + tid];
    } else {  // copy-in
      for (int e = 0; e < nent; ++e)
        if (sid[e] >= 0) win[sid[e] * kXCols + tid] = row[(e % kXRows) * kXCols + tid];
    }
    res = to_f32(win[tid]);
    if (mode != 1) res = __fadd_rn(res, to_f32(row[tid]));
  }
  out[col] = res;
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)dyn_smem(fn, (int)bytes);
}

}  // namespace

// out[0:nx] = x[0:nx] + f32(s[0] + s[ns/2] + s[ns-1]) (int32 s, fp32 x)
MPF_API int mpf_probe_sched_read(int ns, const void* sched, const void* x, void* out, int nx,
                                 void* stream) {
  sched_read_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      ns, (const int*)sched, (const float*)x, (float*)out, nx);
  return (int)cudaGetLastError();
}

// s[off : off+count] into shared memory by a TMA bulk copy waited on an
// mbarrier; out[0:nx] = x[0:nx] + f32(ssc[0] + ssc[count-1]).  The wrapper
// checks count * 4 and the source address are multiples of 16 bytes.
MPF_API int mpf_probe_bulk_copy(const void* sched, int off, int count, const void* x,
                                void* out, int nx, void* stream) {
  const size_t smem = (size_t)count * 4;
  int err = set_smem((const void*)bulk_copy_kernel, smem);
  if (err) return err;
  bulk_copy_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)sched, off, count, (const float*)x, (float*)out, nx);
  return (int)cudaGetLastError();
}

// nrows reads of row (i * stride) mod n of the (n, w) fp32 matrix src (row
// stride lds), `depth` <= 48 4 KB chunks in flight a block, one block a
// multiprocessor; out[0:w] = row (target * stride) mod n.  w % 4 == 0, src
// 16-byte aligned and nrows * stride < 2^32 (the wrapper checks).
MPF_API int mpf_probe_row_ring(int n, int w, const void* src, i64 lds, int nrows, int stride,
                               int depth, int target, void* out, void* stream) {
  if (depth < 1 || depth > kRingMaxDepth) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  const size_t smem = kRingBarBytes + (size_t)depth * kRingChunk * 4;
  int err = set_smem((const void*)row_ring_kernel, smem);
  if (err) return err;
  row_ring_kernel<<<sms, 32, smem, (cudaStream_t)stream>>>(
      n, w, (const float*)src, lds, nrows, stride, depth, target, (float*)out);
  return (int)cudaGetLastError();
}

// In place: window ids[i] (win contiguous elements at a + ids[i] * win) +=
// 1 in fp32, rounded to the element type (elem 4: fp32, 2: bf16), for
// i < nids; ids distinct, and an id outside [0, nwin) skipped.  depth in
// {1, 4, 8, 16}: 16-byte loads in flight a thread.
MPF_API int mpf_probe_window_rmw(int nids, int nwin, i64 win, void* a, const void* ids,
                                 int elem, int depth, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nids <= 0 || win <= 0) return (int)cudaGetLastError();
  if (elem == 4)
    return launch_rmw<float>(nids, nwin, win, (float*)a, (const int*)ids, depth, st);
  if (elem == 2)
    return launch_rmw<__nv_bfloat16>(nids, nwin, win, (__nv_bfloat16*)a, (const int*)ids,
                                     depth, st);
  return (int)cudaErrorInvalidValue;
}

// out[0:w] = sum over i < nvis, in order, of f32(a[ids[i], i mod g, 0:w]) for
// the contiguous (nwin, g, w) array a (bf16 when bf16, else fp32), an id
// outside [0, nwin) adding nothing; depth in {1, 4, 8, 16}: loads in
// flight a thread.
MPF_API int mpf_probe_window_gather(int nvis, int nwin, int g, int w, const void* a,
                                    const void* ids, int bf16, int depth, void* out,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (w <= 0) return (int)cudaGetLastError();
  if (bf16)
    return launch_gather<__nv_bfloat16>(nvis, nwin, g, w, (const __nv_bfloat16*)a,
                                        (const int*)ids, depth, (float*)out, st);
  return launch_gather<float>(nvis, nwin, g, w, (const float*)a, (const int*)ids, depth,
                              (float*)out, st);
}

// dst[c, r] = src[r, c] for the (rows, cols) row-major src (row stride lds)
// into the (cols, rows) dst (row stride ldd); elem: 4 or 2 bytes, copied raw.
MPF_API int mpf_probe_transpose(int rows, int cols, const void* src, i64 lds, void* dst,
                                i64 ldd, int elem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows <= 0 || cols <= 0) return (int)cudaGetLastError();
  dim3 grid((cols + 31) / 32, (rows + 31) / 32), block(32, 8);
  if (elem == 4)
    transpose_kernel<uint32_t><<<grid, block, 0, st>>>(rows, cols, (const uint32_t*)src, lds,
                                                       (uint32_t*)dst, ldd);
  else if (elem == 2)
    transpose_kernel<uint16_t><<<grid, block, 0, st>>>(rows, cols, (const uint16_t*)src, lds,
                                                       (uint16_t*)dst, ldd);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The (g, xw) bf16 window x, nent row ids in [0, g) (others skipped); mode 0
// extract, 1 overlay, 2 copy-out, 3 copy-in; out[0:xw] fp32 as the header
// says.
MPF_API int mpf_probe_xsel(int mode, int g, int xw, int nent, const void* x, const void* ids,
                           void* out, void* stream) {
  if (mode < 0 || mode > 3) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)nent * 4 + 15) / 16 * 16 + (size_t)(g + kXRows) * kXCols * 2;
  int err = set_smem((const void*)xsel_kernel, smem);
  if (err) return err;
  xsel_kernel<<<(xw + kXCols - 1) / kXCols, kXCols, smem, (cudaStream_t)stream>>>(
      mode, g, xw, nent, (const __nv_bfloat16*)x, (const int*)ids, (float*)out);
  return (int)cudaGetLastError();
}
