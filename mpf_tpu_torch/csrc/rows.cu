// Kernel 11: gather of arbitrary rows, and an in-place row scatter (from a
// values buffer or from the band).
//
// Replaces: mpf_tpu/ops/panel_fused.py:_rows_gather_kernel (via rows_gather)
// and _rows_scatter_kernel (via rows_scatter_inplace and
// rows_scatter_from_band):
//   gather:        out[j, :] = a[rows[j], :]
//   scatter:       a[dests[i], :] = vals[i, :]   for active, non-self rows
//   from the band: a[dests[i], :] = a[k + i, :]  for dests outside [k, k + nr)
// Duplicate destinations are allowed only with bitwise-identical values:
// both blocks then write the same bytes.
//
// Rows are fp32 or bf16 and copied raw (4- or 2-byte elements).  The TPU
// kernels batch rows by eight, read and rewrite whole granule windows and
// ping-pong their window buffers; rows are contiguous in a row-major tensor,
// so none of that has a counterpart: one block per row, 16-byte vector
// copies when aligned (`rows::copy_row` and `rows::gather_kernel` in
// common.cuh, shared with kernels 4 and 9; the band scatter is kernel 4's
// `rows::scatter_band_row`).
//
// What bounds it on the H100: bytes, 2 * nr * w * (4 or 2) read and written,
// and launch latency for few rows.  A scatter from the band reads only band
// rows and writes only rows outside it, so no block reads a row another
// block writes.
#include "common.cuh"

namespace {

using rows::kThreads;

template <typename E>
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(int nr, int w, E* a, i64 lda, const int* __restrict__ dests,
                   const E* __restrict__ vals, i64 ldv, const int* __restrict__ self_src,
                   const int* __restrict__ active, int band_k) {
  const int i = blockIdx.x;
  if (band_k >= 0) {  // kernel 4's band scatter, under this kernel's own name
    rows::scatter_band_row(i, nr, w, a, lda, band_k, dests);
    return;
  }
  if (active != nullptr && active[i] == 0) return;
  const int d = dests[i];
  if (self_src != nullptr && d == self_src[i]) return;  // self-move
  rows::copy_row(a + (i64)d * lda, vals + (i64)i * ldv, w);
}

template <typename E>
int gather(int nr, int w, const void* a, i64 lda, const int* src, void* out,
           cudaStream_t st) {
  rows::gather_kernel<E><<<nr, kThreads, 0, st>>>(w, (const E*)a, lda, src, (E*)out);
  return (int)cudaGetLastError();
}

template <typename E>
int scatter(int nr, int w, void* a, i64 lda, const int* dests, const void* vals, i64 ldv,
            const int* self_src, const int* active, int band_k, cudaStream_t st) {
  scatter_kernel<E><<<nr, kThreads, 0, st>>>(nr, w, (E*)a, lda, dests, (const E*)vals, ldv,
                                             self_src, active, band_k);
  return (int)cudaGetLastError();
}

}  // namespace

// out[j, 0:w] = a[rows[j], 0:w]; out is (nr, w) contiguous.  elem: bytes per
// element, 4 (fp32) or 2 (bf16).
MPF_API int mpf_rows_gather(int nr, int w, const void* a, i64 lda, const int* rows, void* out,
                            int elem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nr <= 0) return (int)cudaGetLastError();
  if (elem == 4) return gather<uint32_t>(nr, w, a, lda, rows, out, st);
  if (elem == 2) return gather<uint16_t>(nr, w, a, lda, rows, out, st);
  return (int)cudaErrorInvalidValue;
}

// band_k >= 0: values from the band rows a[band_k + i] (vals, self_src and
// active unused); band_k < 0: values from vals (row stride ldv), self_src and
// active optional (nullptr).
MPF_API int mpf_rows_scatter(int nr, int w, void* a, i64 lda, const int* dests,
                             const void* vals, i64 ldv, const int* self_src,
                             const int* active, int band_k, int elem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nr <= 0) return (int)cudaGetLastError();
  if (elem == 4)
    return scatter<uint32_t>(nr, w, a, lda, dests, vals, ldv, self_src, active, band_k, st);
  if (elem == 2)
    return scatter<uint16_t>(nr, w, a, lda, dests, vals, ldv, self_src, active, band_k, st);
  return (int)cudaErrorInvalidValue;
}
