// Kernel 4: bounded row exchange (LASWP composed into one row map), once per
// block column.
//
// Replaces: mpf_tpu/ops/exchange.py:_rows_exchange_kernel (via
// rows_exchange):
//   pivrows[j] = a[glist[j], :]                       (values before any write)
//   a[dests[i], :] = a[k + i, :]   for every dests[i] outside [k, k + nr)
// The caller then writes pivrows over the band a[k:k+nr, :].
//
// What bounds it on the H100: pure row movement, 2 * (nr + moved rows) * w *
// 4 bytes of device-memory traffic — bandwidth and, for few moved rows,
// launch latency.
//
// Design: rows are contiguous in a row-major tensor, so the TPU kernel's
// granule windows, sorted schedules and staging rings have no counterpart.
// Launch 1 gathers the pivot rows into the pivrows buffer (one block per
// row, 16-byte vector copies when aligned).  Launch 2 scatters the displaced
// band rows to their out-of-band destinations.  Stream order puts every
// read of launch 1 before any write of launch 2; launch 2 reads only band
// rows, which it never writes, so a position that is both a source and a
// destination is read before it is overwritten.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void copy_row(float* __restrict__ dst,
                                         const float* __restrict__ src, int w) {
  bool vec = ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0;
  int nv = vec ? w / 4 : 0;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < nv; i += kThreads) d4[i] = s4[i];
  for (int i = nv * 4 + threadIdx.x; i < w; i += kThreads) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads)
    gather_kernel(int w, const float* __restrict__ a, i64 lda,
                  const int* __restrict__ rows, float* __restrict__ out) {
  int j = blockIdx.x;
  copy_row(out + (i64)j * w, a + (i64)rows[j] * lda, w);
}

__global__ void __launch_bounds__(kThreads)
    scatter_band_kernel(int nr, int w, float* a, i64 lda, int k,
                        const int* __restrict__ dests) {
  int i = blockIdx.x;
  int d = dests[i];
  if (d >= k && d < k + nr) return;  // in-band: covered by the band write
  copy_row(a + (i64)d * lda, a + (i64)(k + i) * lda, w);
}

}  // namespace

MPF_API int mpf_rows_exchange(int nr, int w, float* a, i64 lda, int k,
                              const int* glist, const int* dests, float* pivrows,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nr <= 0) return (int)cudaGetLastError();
  gather_kernel<<<nr, kThreads, 0, st>>>(w, a, lda, glist, pivrows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_band_kernel<<<nr, kThreads, 0, st>>>(nr, w, a, lda, k, dests);
  return (int)cudaGetLastError();
}
