// Kernel 9: bounded row exchange (LASWP composed into one row map) of the
// masked path, per panel on the block-column slab and per block column on
// the columns outside it.
//
// Replaces: mpf_tpu/ops/panel_pallas.py:_laswp_kernel / _laswp_kernel_v (via
// laswp_apply):  slab[cand[i], :] = slab_old[src[i], :]  for i < nswap,
// every gather before any scatter.  Duplicate cand entries carry identical
// sources, so their writes agree.
//
// What bounds it on the H100: bytes, 2 * nswap * w * element size of row
// traffic (nswap = 2r per panel, 2 * bc per block column), and for the
// per-panel slab exchange (256 rows of 4 KB) launch latency.
//
// Design: the TPU kernel's rolling window of row DMAs and semaphores has no
// counterpart; rows of a row-major tensor are contiguous (the slab is a
// strided view: a row stride and a width).  Launch 1 copies the nswap
// source rows into a staging buffer the wrapper allocates, one block per
// row with 16-byte vector copies where aligned (`rows::` in common.cuh,
// shared with kernel 4); launch 2, on the same
// stream, copies the staged rows to their destinations.  Stream order puts
// every read before any write.  Element type fp32 or bf16 (raw 4- or 2-byte
// copies: no arithmetic).
#include "common.cuh"

namespace {

using rows::kThreads;

template <typename E>
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(int w, E* __restrict__ a, i64 lda, const int* __restrict__ cand,
                   const E* __restrict__ stage) {
  const int i = blockIdx.x;
  rows::copy_row(a + (i64)cand[i] * lda, stage + (i64)i * w, w);
}

template <typename E>
int launch(int nswap, int w, void* a, i64 lda, const int* cand, const int* src, void* stage,
           cudaStream_t st) {
  rows::gather_kernel<E><<<nswap, kThreads, 0, st>>>(w, (const E*)a, lda, src, (E*)stage);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_kernel<E><<<nswap, kThreads, 0, st>>>(w, (E*)a, lda, cand, (const E*)stage);
  return (int)cudaGetLastError();
}

}  // namespace

// a[cand[i], 0:w] = a_old[src[i], 0:w] for i < nswap; elem_bytes 4 (fp32)
// or 2 (bf16); stage holds nswap * w elements.
MPF_API int mpf_laswp(int nswap, int w, void* a, i64 lda, const int* cand, const int* src,
                      void* stage, int elem_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nswap <= 0 || w <= 0) return (int)cudaGetLastError();
  if (elem_bytes == 4) return launch<unsigned int>(nswap, w, a, lda, cand, src, stage, st);
  if (elem_bytes == 2) return launch<unsigned short>(nswap, w, a, lda, cand, src, stage, st);
  return (int)cudaErrorInvalidValue;
}
