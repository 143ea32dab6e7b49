// Kernel 10: the untrimmed streaming update (B over the full slab width),
// one launch.
//
// Replaces: mpf_tpu/ops/panel_fused.py:_apply_update_kernel (via
// panel_apply_update).  On the (m, bc) slab, panel at column jj0, for every
// row at virtual position >= thr (= j0 + r):
//   L21 = T(A[row, jj0:jj0+r] @ U11^{-1})        (fp32 FMA, one rounding to T)
//   A[row, jj0:jj0+r] = L21
//   A[row, jj0+r:bc]  = T(fp32(A) - L21 @ U12)    U12 = rowblock[:, jj0+r:]
// Columns left of the panel and the rows at positions < thr are left as they
// are.  T is fp32 (update operands fp32, or rounded to bf16 when gemm_bf16)
// or bf16 (bf16 operands).  Kernels 3 and 12 compute the same function for
// the driver; this one is the JAX package's round-2 form, which no driver
// path calls.
//
// What bounds it on the H100: bytes at the slab's shapes (the rows below
// read and written once, m x (bc - jj0) elements; 2 m r (bc - jj0) flops,
// below the fp32 ridge for r = 128), and here the FFMA issue rate of a
// simple first version.
//
// Design: one block per 64-row tile.  The block stages U11^{-1} and the
// tile's panel columns in shared memory as fp32, computes L21 with fp32 FFMA
// in the order of the L21 pass of kernels 3 and 12 (l21.cuh), so
// L21 is bitwise theirs, writes it into the panel and keeps the update
// operand (zero on frozen rows) in shared memory, transposed.  Then it walks
// the columns right of the panel in 64-wide chunks: each chunk of U12 is
// staged in the space U11^{-1} held, each thread accumulates a 4 x 4 block
// of the product with fp32 FMA over k in order (kernel 3's FFMA tile order)
// and subtracts it from the slab in place.  The TPU kernel carried a (rb,
// bc) block through VMEM per grid step; here a tile's L21 never leaves
// shared memory, and tiles run in any order.  The bf16 forms accumulate
// exact bf16 products on FFMA, not on the tensor cores: right first, fast
// later.
#include "common.cuh"

namespace {

constexpr int kRows = 64;    // row tile
constexpr int kCols = 64;    // update column chunk
constexpr int kThreads = 256;
constexpr int kMaxR = 128;
constexpr int kPer = kRows * kMaxR / kThreads;  // L21 entries per thread

typedef __nv_bfloat16 bf;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    full_kernel(int m, int bc, int r, T* __restrict__ slab, i64 ld, int jj0,
                const int* __restrict__ pos, int thr, const T* __restrict__ rowblock,
                const T* __restrict__ uinv, int bf16_ops) {
  extern __shared__ float full_smem[];
  float* us = full_smem;                                   // U11^-1 (r x r), then U12 chunks
  float* lt = full_smem + max(r * r, r * kCols);           // panel, then L21: [k][row]
  __shared__ int below_s[kRows];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, m - row0);

  for (int e = tid; e < r * r; e += kThreads) us[e] = to_f32(uinv[e]);
  for (int e = tid; e < kRows * r; e += kThreads) {
    int l = e / r, c = e % r;
    lt[c * kRows + l] = l < nrows ? to_f32(slab[(i64)(row0 + l) * ld + jj0 + c]) : 0.0f;
  }
  for (int l = tid; l < kRows; l += kThreads)
    below_s[l] = l < nrows && pos[row0 + l] >= thr;
  __syncthreads();

  // ---- L21 = P U11^{-1}, in registers until every thread has read P
  float acc[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    int e = tid + q * kThreads;
    float s = 0.0f;
    if (e < nrows * r) {
      int l = e / r, c = e % r;
      for (int k = 0; k < r; ++k) s = fmaf(lt[k * kRows + l], us[k * r + c], s);
    }
    acc[q] = s;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    int e = tid + q * kThreads;
    if (e < kRows * r) {
      int l = e / r, c = e % r;
      T v = from_f32<T>(acc[q]);
      bool below = below_s[l] != 0;
      if (below) slab[(i64)(row0 + l) * ld + jj0 + c] = v;
      float op = bf16_ops ? round_to<bf>(to_f32(v)) : to_f32(v);
      lt[c * kRows + l] = below ? op : 0.0f;
    }
  }

  // ---- A[:, jj0+r:] -= L21 U12, 64 columns at a time
  const int tr = (tid / 16) * 4, tc = (tid % 16) * 4;
  for (int c0 = jj0 + r; c0 < bc; c0 += kCols) {
    __syncthreads();  // L21 stored; the previous chunk's reads of us done
    for (int e = tid; e < r * kCols; e += kThreads) {
      int k = e / kCols, cc = e % kCols;
      float u = c0 + cc < bc ? to_f32(rowblock[(i64)k * bc + c0 + cc]) : 0.0f;
      us[e] = bf16_ops ? round_to<bf>(u) : u;
    }
    __syncthreads();
    float s[4][4] = {};
    for (int k = 0; k < r; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = lt[k * kRows + tr + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = us[k * kCols + tc + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!below_s[tr + i]) continue;  // also rows past the slab (never below)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int gc = c0 + tc + j;
        if (gc < bc) {
          T* p = &slab[(i64)(row0 + tr + i) * ld + gc];
          *p = from_f32<T>(__fsub_rn(to_f32(*p), s[i][j]));
        }
      }
    }
  }
}

template <typename T>
int launch(int m, int bc, int r, T* slab, i64 ld, int jj0, const int* pos, int thr,
           const T* rowblock, const T* uinv, int bf16_ops, cudaStream_t st) {
  size_t smem = (size_t)(max(r * r, r * kCols) + r * kRows) * sizeof(float);
  cudaError_t err = dyn_smem((const void*)full_kernel<T>, (int)smem);
  if (err != cudaSuccess) return (int)err;
  full_kernel<T><<<(m + kRows - 1) / kRows, kThreads, smem, st>>>(
      m, bc, r, slab, ld, jj0, pos, thr, rowblock, uinv, bf16_ops);
  return (int)cudaGetLastError();
}

}  // namespace

// slab (m, bc) at row stride ld, fp32 or bf16 (slab_bf16); rowblock (r, bc)
// and uinv (r, r) contiguous, of the slab's dtype; gemm_bf16: an fp32 slab's
// update takes operands rounded to bf16.
MPF_API int mpf_panel_update_full(int m, int bc, int r, void* slab, i64 ld, int jj0,
                                  const int* pos, int thr, const void* rowblock,
                                  const void* uinv, int slab_bf16, int gemm_bf16,
                                  void* stream) {
  if (r <= 0 || r > kMaxR || jj0 + r > bc) return (int)cudaErrorInvalidValue;
  if (m <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (slab_bf16)
    return launch<bf>(m, bc, r, (bf*)slab, ld, jj0, pos, thr, (const bf*)rowblock,
                      (const bf*)uinv, 1, st);
  return launch<float>(m, bc, r, (float*)slab, ld, jj0, pos, thr, (const float*)rowblock,
                       (const float*)uinv, gemm_bf16, st);
}
