// Kernel 2 (A2): pivot-row gather, no-pivot refactor of the diagonal block
// with fused inverses, and the finished row block.
//
// Replaces: mpf_tpu/ops/panel_fused.py:_rowblock_kernel (via
// rowblock_assemble), whose diagonal math is _npv_inv_values:
//   staged = slab[glist, :]                              (r x bc)
//   LU, L^{-1}, U^{-1}, info = no-pivot LU of staged[:, jj0:jj0+r]  (fp32)
//   rowblock = [staged[:, :jj0] | LU | L^{-1} staged[:, jj0+r:]]
// info is the 1-based column of the first exactly-zero pivot, 0 if none.
//
// What bounds it on the H100: the r-step elimination chain of one r x r
// block (r = 128) — latency, with a few hundred block-wide barriers — plus
// an r x r x bc product for U12, which is small.
//
// Design: two launches behind one entry point.  (1) diag_kernel: one block
// of 1024 threads keeps the block, L^{-1} and U^{-1} in shared memory
// (3 x 64 KB at r = 128, under the 227 KB a block may use) and runs the
// elimination and the back substitution; it writes LU into the row block
// and L^{-1} into a scratch buffer.  (2) u12_kernel: one block per 64-column
// tile of the row block copies the gathered L part left of the panel and
// computes U12 = L^{-1} staged right of it with fp32 FFMA.  The elimination
// updates are single-rounding fused multiply-adds, like the plain version;
// the divides are true IEEE divides.
#include "common.cuh"

namespace {

constexpr int kDiagThreads = 1024;
constexpr int kTileCols = 64;
constexpr int kU12Threads = 256;

__global__ void __launch_bounds__(kDiagThreads)
    diag_kernel(int r, const float* __restrict__ slab, i64 ld,
                const int* __restrict__ glist, int jj0, int bc,
                float* __restrict__ rowblock, float* __restrict__ uinv,
                float* __restrict__ linv, int* __restrict__ info_out) {
  extern __shared__ float sm[];
  float* b = sm;              // r x r: the block, then its packed LU
  float* li = b + r * r;      // r x r: L^{-1}
  float* y = li + r * r;      // r x r: U^{-1}
  float* mult = y + r * r;    // r
  __shared__ int info;
  const int tid = threadIdx.x;
  for (int e = tid; e < r * r; e += kDiagThreads) {
    int i = e / r, c = e % r;
    b[e] = slab[(i64)glist[i] * ld + jj0 + c];
    li[e] = (i == c) ? 1.0f : 0.0f;
    y[e] = 0.0f;
  }
  if (tid == 0) info = 0;
  __syncthreads();
  for (int j = 0; j < r; ++j) {
    float pv = b[j * r + j];
    float safe = pv == 0.0f ? 1.0f : pv;
    if (tid == 0 && pv == 0.0f && info == 0) info = j + 1;
    for (int i = tid; i < r; i += kDiagThreads)
      mult[i] = i > j ? __fdiv_rn(b[i * r + j], safe) : 0.0f;
    __syncthreads();
    const int nb = r - j - 1;
    for (int e = tid; e < nb * r; e += kDiagThreads) {
      int i = j + 1 + e / r, c = e % r;
      float mi = mult[i];
      if (c == j)
        b[i * r + c] = mi;
      else if (c > j)
        b[i * r + c] = fmaf(-mi, b[j * r + c], b[i * r + c]);
      if (c <= j) li[i * r + c] = fmaf(-mi, li[j * r + c], li[i * r + c]);
    }
    __syncthreads();
  }
  // back substitution for U^{-1}, row by row from the bottom
  for (int i = r - 1; i >= 0; --i) {
    for (int c = tid; c < r; c += kDiagThreads) {
      float uii = b[i * r + i];
      float safe = uii == 0.0f ? 1.0f : uii;
      float acc = 0.0f;
      for (int k = i + 1; k < r; ++k) acc = fmaf(b[i * r + k], y[k * r + c], acc);
      y[i * r + c] = __fdiv_rn(__fsub_rn(c == i ? 1.0f : 0.0f, acc), safe);
    }
    __syncthreads();
  }
  for (int e = tid; e < r * r; e += kDiagThreads) {
    int i = e / r, c = e % r;
    rowblock[(i64)i * bc + jj0 + c] = b[e];
    linv[e] = li[e];
    uinv[e] = y[e];
  }
  if (tid == 0) *info_out = info;
}

__global__ void __launch_bounds__(kU12Threads)
    u12_kernel(int r, const float* __restrict__ slab, i64 ld,
               const int* __restrict__ glist, int jj0, int bc,
               const float* __restrict__ linv, float* __restrict__ rowblock) {
  extern __shared__ float sm[];
  const int c0 = blockIdx.x * kTileCols;
  const int nc = min(kTileCols, bc - c0);
  if (c0 >= jj0 && c0 + nc <= jj0 + r) return;  // tile inside the panel
  float* ls = sm;                // r x r
  float* st = sm + r * r;        // r x kTileCols
  const int tid = threadIdx.x;
  for (int e = tid; e < r * r; e += kU12Threads) ls[e] = linv[e];
  for (int e = tid; e < r * nc; e += kU12Threads) {
    int i = e / nc, c = e % nc;
    st[i * kTileCols + c] = slab[(i64)glist[i] * ld + c0 + c];
  }
  __syncthreads();
  for (int e = tid; e < r * nc; e += kU12Threads) {
    int i = e / nc, c = e % nc;
    int gc = c0 + c;
    if (gc < jj0) {
      rowblock[(i64)i * bc + gc] = st[i * kTileCols + c];
    } else if (gc >= jj0 + r) {
      float acc = 0.0f;
      for (int k = 0; k < r; ++k) acc = fmaf(ls[i * r + k], st[k * kTileCols + c], acc);
      rowblock[(i64)i * bc + gc] = acc;
    }
  }
}

}  // namespace

MPF_API int mpf_rowblock(int r, int bc, const float* slab, i64 ld, const int* glist,
                         int jj0, float* rowblock, float* uinv, float* linv,
                         int* info, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (r > 128) return (int)cudaErrorInvalidValue;
  size_t smem1 = (size_t)(3 * r * r + r) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      diag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  diag_kernel<<<1, kDiagThreads, smem1, st>>>(r, slab, ld, glist, jj0, bc, rowblock,
                                              uinv, linv, info);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  size_t smem2 = (size_t)(r * r + r * kTileCols) * sizeof(float);
  err = cudaFuncSetAttribute(u12_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  u12_kernel<<<(bc + kTileCols - 1) / kTileCols, kU12Threads, smem2, st>>>(
      r, slab, ld, glist, jj0, bc, linv, rowblock);
  return (int)cudaGetLastError();
}
