// Kernel 3 (B): streaming masked L21 + in-block-column update, in place.
//
// Replaces: mpf_tpu/ops/panel_fused.py:_apply_update_trim_kernel (fp32
// slabs; _l21_trim_kernel + _upd_wide_kernel compute the same function for
// bf16 slabs), via panel_apply_update_trim.  For every slab row at virtual
// position >= thr (= j0 + r):
//   L21 = A[row, jj0:jj0+r] @ U11^{-1}            (fp32 products)
//   A[row, jj0:jj0+r] = L21
//   A[row, jj0+r:bc] -= L21 @ U12                  (bf16 operands if gemm_bf16)
// Frozen rows (position < thr) are left untouched.
//
// What bounds it on the H100: per panel it reads and writes the slab columns
// right of the panel once (m x (bc - jj0) fp32) and does 2 m r (bc - jj0)
// flops — memory traffic and launch latency at the slice's shapes, not the
// tensor cores.
//
// Design: two launches behind one entry point.  (1) l21_kernel: one block
// per 64-row tile holds U11^{-1} and the tile's panel columns in shared
// memory and computes L21 with fp32 FFMA (the product in the kernel's body,
// not a library call); it writes L21 into the panel and a row-masked copy
// (zeros on frozen rows) into a side buffer.  (2) the shared tiled
// C -= A B routine (common.cuh) with the same row mask applies the update.
// The TPU's per-grid-step scratch carry of L21 becomes the side buffer,
// since Hopper blocks run in no order.
#include "common.cuh"

namespace {

constexpr int kRows = 64;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    l21_kernel(int m, int r, float* __restrict__ slab, i64 ld, int jj0,
               const int* __restrict__ pos, int thr, const float* __restrict__ uinv,
               float* __restrict__ l21buf) {
  extern __shared__ float smem[];
  float* us = smem;              // r x r
  float* ps = smem + r * r;      // kRows x r
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, m - row0);
  for (int e = threadIdx.x; e < r * r; e += kThreads) us[e] = uinv[e];
  for (int e = threadIdx.x; e < nrows * r; e += kThreads) {
    int l = e / r, c = e % r;
    ps[e] = slab[(i64)(row0 + l) * ld + jj0 + c];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nrows * r; e += kThreads) {
    int l = e / r, c = e % r;
    float acc = 0.0f;
    for (int k = 0; k < r; ++k) acc = fmaf(ps[l * r + k], us[k * r + c], acc);
    bool below = pos[row0 + l] >= thr;
    if (below) slab[(i64)(row0 + l) * ld + jj0 + c] = acc;
    l21buf[(i64)(row0 + l) * r + c] = below ? acc : 0.0f;
  }
}

}  // namespace

MPF_API int mpf_panel_update(int m, int bc, int r, float* slab, i64 ld, int jj0,
                             const int* pos, int thr, const float* rowblock,
                             const float* uinv, float* l21buf, int gemm_bf16,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  size_t smem = (size_t)(r * r + kRows * r) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      l21_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  l21_kernel<<<(m + kRows - 1) / kRows, kThreads, smem, st>>>(
      m, r, slab, ld, jj0, pos, thr, uinv, l21buf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int w = bc - jj0 - r;
  if (w <= 0) return (int)cudaGetLastError();
  return gemm::launch_gemm_sub(gemm_bf16 ? 1 : 2, m, w, r, l21buf, r,
                               rowblock + jj0 + r, bc, slab + jj0 + r, ld, pos, thr,
                               st);
}
