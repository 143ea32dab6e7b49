// Kernel 2 (A2): pivot-row gather, no-pivot refactor of the diagonal block
// with fused inverses, and the finished row block.
//
// Replaces: mpf_tpu/ops/panel_fused.py:_rowblock_kernel (via
// rowblock_assemble), whose diagonal math is _npv_inv_values:
//   staged = slab[glist, :]                              (r x bc)
//   LU, L^{-1}, U^{-1}, info = no-pivot LU of staged[:, jj0:jj0+r]  (fp32)
//   rowblock = [staged[:, :jj0] | LU | L^{-1} staged[:, jj0+r:]]
// info is the 1-based column of the first exactly-zero pivot, 0 if none.
// Storage type T is the slab's: fp32, or bf16 under ALL_BF16.  For bf16 the
// rounding points are the TPU kernel's (panel_fused.py:148-174): the
// diagonal LU and both inverses run in fp32 on the gathered bf16 values; LU
// and U^{-1} are stored rounded to bf16; L^{-1} is rounded to bf16 BEFORE
// the U12 product (fp32 accumulation), and U12 is rounded to bf16.
//
// What bounds it on the H100: the r-step elimination chain of one r x r
// block (r = 128) — latency, with a few hundred block-wide barriers — plus
// an r x r x bc product for U12, which is small.
//
// Design: two launches behind one entry point.  (1) diag_kernel: one block
// of 1024 threads keeps the block, L^{-1} and U^{-1} in shared memory
// (3 x 64 KB at r = 128, under the 227 KB a block may use) and runs the
// elimination and the back substitution; it writes LU into the row block
// and L^{-1} (fp32) into a scratch buffer.  (2) u12_kernel: one block per
// 64-column tile of the row block copies the gathered L part left of the
// panel and computes U12 = L^{-1} staged right of it with fp32 FFMA.  The
// elimination updates are single-rounding fused multiply-adds, like the
// plain version; the divides are true IEEE divides.
#include "common.cuh"

namespace {

constexpr int kDiagThreads = 1024;
constexpr int kTileCols = 64;
constexpr int kU12Threads = 256;

template <typename T>
__global__ void __launch_bounds__(kDiagThreads)
    diag_kernel(int r, const T* __restrict__ slab, i64 ld,
                const int* __restrict__ glist, int jj0, int bc,
                T* __restrict__ rowblock, T* __restrict__ uinv,
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
    b[e] = to_f32(slab[(i64)glist[i] * ld + jj0 + c]);
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
    rowblock[(i64)i * bc + jj0 + c] = from_f32<T>(b[e]);
    linv[e] = li[e];
    uinv[e] = from_f32<T>(y[e]);
  }
  if (tid == 0) *info_out = info;
}

template <typename T>
__global__ void __launch_bounds__(kU12Threads)
    u12_kernel(int r, const T* __restrict__ slab, i64 ld,
               const int* __restrict__ glist, int jj0, int bc,
               const float* __restrict__ linv, T* __restrict__ rowblock) {
  extern __shared__ float sm[];
  const int c0 = blockIdx.x * kTileCols;
  const int nc = min(kTileCols, bc - c0);
  if (c0 >= jj0 && c0 + nc <= jj0 + r) return;  // tile inside the panel
  float* ls = sm;                // r x r: L^{-1} rounded to T
  float* st = sm + r * r;        // r x kTileCols
  const int tid = threadIdx.x;
  for (int e = tid; e < r * r; e += kU12Threads) ls[e] = round_to<T>(linv[e]);
  for (int e = tid; e < r * nc; e += kU12Threads) {
    int i = e / nc, c = e % nc;
    st[i * kTileCols + c] = to_f32(slab[(i64)glist[i] * ld + c0 + c]);
  }
  __syncthreads();
  for (int e = tid; e < r * nc; e += kU12Threads) {
    int i = e / nc, c = e % nc;
    int gc = c0 + c;
    if (gc < jj0) {
      rowblock[(i64)i * bc + gc] = from_f32<T>(st[i * kTileCols + c]);
    } else if (gc >= jj0 + r) {
      float acc = 0.0f;
      for (int k = 0; k < r; ++k) acc = fmaf(ls[i * r + k], st[k * kTileCols + c], acc);
      rowblock[(i64)i * bc + gc] = from_f32<T>(acc);
    }
  }
}

template <typename T>
int launch(int r, int bc, const T* slab, i64 ld, const int* glist, int jj0, T* rowblock,
           T* uinv, float* linv, int* info, cudaStream_t st) {
  size_t smem1 = (size_t)(3 * r * r + r) * sizeof(float);
  cudaError_t err = dyn_smem((const void*)diag_kernel<T>, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  diag_kernel<T><<<1, kDiagThreads, smem1, st>>>(r, slab, ld, glist, jj0, bc, rowblock,
                                                 uinv, linv, info);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  size_t smem2 = (size_t)(r * r + r * kTileCols) * sizeof(float);
  err = dyn_smem((const void*)u12_kernel<T>, (int)smem2);
  if (err != cudaSuccess) return (int)err;
  u12_kernel<T><<<(bc + kTileCols - 1) / kTileCols, kU12Threads, smem2, st>>>(
      r, slab, ld, glist, jj0, bc, linv, rowblock);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 != 0: slab, rowblock and uinv are bf16 (ALL_BF16), else fp32; linv
// is an fp32 (r, r) scratch buffer in both.
MPF_API int mpf_rowblock(int r, int bc, const void* slab, i64 ld, const int* glist,
                         int jj0, void* rowblock, void* uinv, float* linv, int* info,
                         int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (r > 128) return (int)cudaErrorInvalidValue;
  typedef __nv_bfloat16 bf;
  if (bf16)
    return launch<bf>(r, bc, (const bf*)slab, ld, glist, jj0, (bf*)rowblock, (bf*)uinv,
                      linv, info, st);
  return launch<float>(r, bc, (const float*)slab, ld, glist, jj0, (float*)rowblock,
                       (float*)uinv, linv, info, st);
}
