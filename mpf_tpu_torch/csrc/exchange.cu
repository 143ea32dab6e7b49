// Kernel 4: bounded row exchange (LASWP composed into one row map), once per
// block column.
//
// Replaces: mpf_tpu/ops/exchange.py:_rows_exchange_kernel (via
// rows_exchange):
//   pivrows[j] = a[glist[j], :]                       (values before any write)
//   a[dests[i], :] = a[k + i, :]   for every dests[i] outside [k, k + nr)
// The caller then writes pivrows over the band a[k:k+nr, :].
//
// Rows are fp32, or bf16 under ALL_BF16: copied as they are, 2-byte
// elements, where the TPU kernel staged bf16 rows through fp32 (an exact
// round trip, so the function is the same).
//
// What bounds it on the H100: pure row movement, 2 * (nr + moved rows) * w *
// (4 or 2) bytes of device-memory traffic — bandwidth and, for few moved rows,
// launch latency.
//
// Design: rows are contiguous in a row-major tensor, so the TPU kernel's
// granule windows, sorted schedules and staging rings have no counterpart.
// Launch 1 gathers the pivot rows into the pivrows buffer (one block per
// row, 16-byte vector copies when aligned; `rows::` in common.cuh, shared
// with kernels 9 and 11).  Launch 2 scatters the displaced
// band rows to their out-of-band destinations.  Stream order puts every
// read of launch 1 before any write of launch 2; launch 2 reads only band
// rows, which it never writes, so a position that is both a source and a
// destination is read before it is overwritten.
#include "common.cuh"

namespace {

using rows::kThreads;

template <typename E>
__global__ void __launch_bounds__(kThreads)
    scatter_band_kernel(int nr, int w, E* a, i64 lda, int k,
                        const int* __restrict__ dests) {
  rows::scatter_band_row(blockIdx.x, nr, w, a, lda, k, dests);
}

template <typename E>
int launch(int nr, int w, E* a, i64 lda, int k, const int* glist, const int* dests,
           E* pivrows, cudaStream_t st) {
  rows::gather_kernel<E><<<nr, kThreads, 0, st>>>(w, a, lda, glist, pivrows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_band_kernel<E><<<nr, kThreads, 0, st>>>(nr, w, a, lda, k, dests);
  return (int)cudaGetLastError();
}

}  // namespace

// elem: bytes per element, 4 (fp32) or 2 (bf16); rows are copied raw.
MPF_API int mpf_rows_exchange(int nr, int w, void* a, i64 lda, int k, const int* glist,
                              const int* dests, void* pivrows, int elem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nr <= 0) return (int)cudaGetLastError();
  if (elem == 4)
    return launch<uint32_t>(nr, w, (uint32_t*)a, lda, k, glist, dests, (uint32_t*)pivrows,
                            st);
  if (elem == 2)
    return launch<uint16_t>(nr, w, (uint16_t*)a, lda, k, glist, dests, (uint16_t*)pivrows,
                            st);
  return (int)cudaErrorInvalidValue;
}
