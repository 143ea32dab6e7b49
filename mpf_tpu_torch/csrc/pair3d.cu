// Kernels 15a-15d: the pair-layout driver's slab extract and writeback, band
// write and in-place U12.
//
// Replaces: mpf_tpu/ops/pair3d.py
//   _extract_kernel   (pallas_call :90, via slab_extract)    slab = A[k0:k0+m, k:k+bc]
//   _writeback_kernel (pallas_call :113, via slab_writeback) A[k0:k0+m, k:k+bc] = slab
//   _band_write_kernel (pallas_call :205, via band_write_rows) A[k:k+nr, :] = pivrows
//   _u12_kernel       (pallas_call :281, via u12_transform)
//                     A[ks:ks+kw, e:e+w] = linv @ A[ks:ks+kw, e:e+w], in place
// where A is the (n, n) matrix whose row i lies at a3[i // 2, i % 2] of the
// (n/2, 2, n) working tensor.  A contiguous (n/2, 2, n) tensor holds the same
// bytes as the row-major (n, n) matrix, so every kernel here takes row-major
// rows with a row stride.  The TPU kernels reshaped (c, 2, w) VMEM blocks to
// (2c, w) and streamed the band through 2-row DMA windows; both exist for the
// TPU's 16-row DMA granule, which the card does not have.
//
// mpf_block_copy (15a, 15b, 15c): dst[i, 0:w] = src[i, 0:w] for `rows` rows
// of two row-major views.  Raw copies of 4- or 2-byte elements (fp32 or
// bf16), as kernel 4 copies rows; the band write takes kernel 4's pivot
// rows, which are already in the working dtype (the TPU staged them in fp32
// and cast, an exact round trip).  Bound by bytes: 2 * rows * w * (4 or 2).
// Design: one block per row, 16-byte vector copies when both rows are
// aligned (`rows::copy_row` in common.cuh, shared with kernels 4, 9, 11, 14).
//
// mpf_u12_inplace (15d): U12 := linv @ A12 with linv (kw x kw) unit lower
// triangular and A12 the kw x w block at A's rows [ks, ks+kw), columns
// [e, e+w), overwritten in place.  IEEE fp32 accumulation on FFMA (never
// TF32): fp32 operands under MPF_BF16, bf16 linv and A12 under ALL_BF16,
// whose products are exact in fp32; each result is rounded once to the
// working dtype.  Only the terms j <= i of output row i are summed, in
// ascending j: linv's upper triangle is zero, and adding exact zeros does not
// change an fp32 sum, so this is the dense product's function at half the
// work.  Bound by operations: kw^2 * w flops (kw^2 w / 2 FMAs) over the fp32
// rate; 2 kw w + kw^2 elements of traffic.
//
// The in-place hazard: output row i reads input rows 0..i of the same
// columns.  Design: one block owns a 64-column strip of all kw rows and walks
// its 64-row tiles from the bottom up.  Tile t reads input rows [0, 64 t +
// 64) through shared memory (a 64 x 64 FFMA tile, 4 x 4 outputs a thread,
// each summed in ascending k on fmaf, the order of the trailing GEMM's
// FFMA routine, gemm_ffma.cuh) and writes its own rows only after the
// barrier that ends its last K step, when every read of them is done; the
// tiles above read only rows < 64 t.  No other block touches the strip.
// Each K step's global loads are issued into registers before the
// previous step's FMAs (one block a strip leaves few warps an SM to hide
// their latency); the tensor cores (bf16 operands under ALL_BF16) are later
// work.
#include "common.cuh"

namespace {

template <typename E>
__global__ void __launch_bounds__(rows::kThreads)
    block_copy_kernel(int w, E* __restrict__ dst, i64 ldd, const E* __restrict__ src,
                      i64 lds) {
  const i64 i = blockIdx.x;
  rows::copy_row(dst + i * ldd, src + i * lds, w);
}

namespace u12 {

constexpr int kTM = 64, kTN = 64, kTK = 16;
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    u12_kernel(int kw, int w, T* __restrict__ a, i64 lda, const T* __restrict__ linv,
               i64 ldl) {
  __shared__ float Ls[kTK][kTM + 1];  // linv tile, transposed: Ls[j][row]
  __shared__ float Xs[kTK][kTN];      // A12 rows j, the strip's columns
  constexpr int kPer = kTM * kTK / kThreads;  // staged elements a thread, each tile
  static_assert(kTM == kTN && kPer * kThreads == kTM * kTK, "one count for both tiles");
  const int tid = threadIdx.x;
  const int tr = (tid / 16) * 4;  // 4 x 4 outputs a thread
  const int tc = (tid % 16) * 4;
  const int n0 = blockIdx.x * kTN;
  float lreg[kPer], xreg[kPer];
  // the next K step's tiles go to registers while this one is computed
  auto fetch = [&](int m0, int k0, int kend) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      int e = tid + p * kThreads;
      int gr = m0 + e / kTK, gc = k0 + e % kTK;
      lreg[p] = (gr < kw && gc <= gr) ? to_f32(linv[(i64)gr * ldl + gc]) : 0.0f;
      gr = k0 + e / kTN;
      gc = n0 + e % kTN;
      xreg[p] = (gr < kend && gc < w) ? to_f32(a[(i64)gr * lda + gc]) : 0.0f;
    }
  };
  for (int m0 = (kw - 1) / kTM * kTM; m0 >= 0; m0 -= kTM) {
    const int kend = min(kw, m0 + kTM);  // row tile [m0, kend) reads rows [0, kend)
    float acc[4][4] = {};
    fetch(m0, 0, kend);
    for (int k0 = 0; k0 < kend; k0 += kTK) {
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        int e = tid + p * kThreads;
        Ls[e % kTK][e / kTK] = lreg[p];
        Xs[e / kTN][e % kTN] = xreg[p];
      }
      __syncthreads();
      if (k0 + kTK < kend) fetch(m0, k0 + kTK, kend);
#pragma unroll
      for (int kk = 0; kk < kTK; ++kk) {
        float l[4], x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) l[i] = Ls[kk][tr + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = Xs[kk][tc + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(l[i], x[j], acc[i][j]);
      }
      __syncthreads();
    }
    // every read of rows [0, kend) is behind the barrier above
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int gr = m0 + tr + i;
      if (gr >= kw) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int gc = n0 + tc + j;
        if (gc < w) a[(i64)gr * lda + gc] = from_f32<T>(acc[i][j]);
      }
    }
  }
}

}  // namespace u12

}  // namespace

// dst[i, 0:w] = src[i, 0:w] for i < rows (row strides ldd, lds; the two views
// do not overlap); elem: bytes per element, 4 (fp32) or 2 (bf16).
MPF_API int mpf_block_copy(int rows, int w, void* dst, i64 ldd, const void* src, i64 lds,
                           int elem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows <= 0 || w <= 0) return (int)cudaGetLastError();
  if (elem == 4)
    block_copy_kernel<uint32_t><<<rows, rows::kThreads, 0, st>>>(
        w, (uint32_t*)dst, ldd, (const uint32_t*)src, lds);
  else if (elem == 2)
    block_copy_kernel<uint16_t><<<rows, rows::kThreads, 0, st>>>(
        w, (uint16_t*)dst, ldd, (const uint16_t*)src, lds);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// a[0:kw, 0:w] = linv[0:kw, 0:kw] @ a[0:kw, 0:w] in place (linv unit lower
// triangular, its upper triangle not read); a and linv are both fp32, or
// both bf16 when bf16 != 0.
MPF_API int mpf_u12_inplace(int kw, int w, void* a, i64 lda, const void* linv, i64 ldl,
                            int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (kw <= 0 || w <= 0) return (int)cudaGetLastError();
  const int grid = (w + u12::kTN - 1) / u12::kTN;
  if (bf16)
    u12::u12_kernel<__nv_bfloat16><<<grid, u12::kThreads, 0, st>>>(
        kw, w, (__nv_bfloat16*)a, lda, (const __nv_bfloat16*)linv, ldl);
  else
    u12::u12_kernel<float><<<grid, u12::kThreads, 0, st>>>(kw, w, (float*)a, lda,
                                                           (const float*)linv, ldl);
  return (int)cudaGetLastError();
}
