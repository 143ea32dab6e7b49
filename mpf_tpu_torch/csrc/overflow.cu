// Kernel 14: the deferred-overflow exchange's two row movers.
//
// Replaces: mpf_tpu/ops/exchange.py:_copy_rows_kernel (via copy_rows_block)
// and the overflow mode of _rows_exchange_kernel (via flush_overflow):
//   copy_rows:       a[dst + i, :] = a[src + i, :]          i < nrows
//   flush_overflow:  a[dests[i], :] = a[novstart + i, :]    for live slots,
//                    dests[i] < novstart; dead slots carry 2^31 - 1 and are
//                    dropped
// copy_rows appends a block column's band to its overflow slots (the two
// ranges do not overlap); the flush moves every live overflow row home once
// per group of block columns.  Live destinations are pairwise distinct and
// lie above novstart, the sources at or below it, so no block reads a row
// another block writes.
//
// Rows are fp32 or bf16 and copied raw (4- or 2-byte elements), as kernel 4
// copies them.  The TPU ran the flush through the combined exchange kernel
// with no pivot sources so that each 16-row granule window was visited once
// per group (`build_exchange_schedules(sources=False)`, window rings): rows
// are contiguous in a row-major tensor here, so none of that machinery has
// a counterpart, and the copy is one block per row.
//
// What bounds it on the H100: bytes, 2 * rows * w * (4 or 2) read and
// written (the flush: live rows only), and launch latency for few rows.
//
// Design: one block per row, 16-byte vector copies when both rows are
// aligned (`rows::copy_row` in common.cuh, shared with kernels 4, 9 and 11).
// The flush's liveness test is `d < novstart`, not the band test of
// `rows::scatter_band_row`: that one would take the sentinel for an
// out-of-band destination and write past the matrix.
#include "common.cuh"

namespace {

using rows::kThreads;

template <typename E>
__global__ void __launch_bounds__(kThreads)
    copy_rows_kernel(int w, E* a, i64 lda, int src, int dst) {
  const int i = blockIdx.x;
  rows::copy_row(a + (i64)(dst + i) * lda, a + (i64)(src + i) * lda, w);
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
    flush_kernel(int w, E* a, i64 lda, int novstart, const int* __restrict__ dests) {
  const int i = blockIdx.x;
  const int d = dests[i];
  if (d < 0 || d >= novstart) return;  // dead slot
  rows::copy_row(a + (i64)d * lda, a + (i64)(novstart + i) * lda, w);
}

}  // namespace

// a[dst:dst+nrows, 0:w] = a[src:src+nrows, 0:w]; elem: bytes per element, 4
// (fp32) or 2 (bf16).
MPF_API int mpf_copy_rows(int nrows, int w, void* a, i64 lda, int src, int dst, int elem,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nrows <= 0) return (int)cudaGetLastError();
  if (elem == 4)
    copy_rows_kernel<uint32_t><<<nrows, kThreads, 0, st>>>(w, (uint32_t*)a, lda, src, dst);
  else if (elem == 2)
    copy_rows_kernel<uint16_t><<<nrows, kThreads, 0, st>>>(w, (uint16_t*)a, lda, src, dst);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// a[dests[i], 0:w] = a[novstart + i, 0:w] for each of the nov slots whose
// dests[i] < novstart.
MPF_API int mpf_flush_overflow(int nov, int w, void* a, i64 lda, int novstart,
                               const int* dests, int elem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nov <= 0) return (int)cudaGetLastError();
  if (elem == 4)
    flush_kernel<uint32_t><<<nov, kThreads, 0, st>>>(w, (uint32_t*)a, lda, novstart, dests);
  else if (elem == 2)
    flush_kernel<uint16_t><<<nov, kThreads, 0, st>>>(w, (uint16_t*)a, lda, novstart, dests);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
