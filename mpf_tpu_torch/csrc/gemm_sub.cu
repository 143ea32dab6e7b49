// Kernel 6: trailing GEMM with the subtract fused into the epilogue.
//
// Replaces: mpf_tpu/ops/panel_fused.py:_trailing_sub_kernel (via
// trailing_gemm_sub) — A[e:, e:e+w] -= L21 @ U12 in place, fp32
// accumulation, L21/U12 in the policy's gemm_in dtype.  A is fp32, or bf16
// under ALL_BF16: then each entry is read as bf16, the fp32 sum subtracted
// in fp32 and the result rounded to bf16 once on the store (the TPU
// epilogue `(a.astype(f32) - acc).astype(out.dtype)`).
//
// What bounds it on the H100: this is the O(n^3) part of the factorization
// (2 (n-e)^2 * bc flops per block column).  With bf16 operands the tensor
// cores could run it at hundreds of TFLOP/s; this first version stages
// 128x128x32 tiles through shared memory synchronously and issues warp-level
// mma.sync, so it is bound by shared-memory staging and latency, not by the
// tensor cores.  The fp32-operand form (PURE_FP32, MPF_REF) is FFMA bound.
//
// Design: the tile routine in common.cuh, one 128x128 output tile per
// block, C read and written once per tile in the epilogue (the TPU kernel's
// point: no separate product array and subtract pass).  The same routine,
// with a row mask, is the update half of the streaming panel update
// (panel_update.cu), and without one the update pass of kernel 12
// (l21_trim.cu).
#include "common.cuh"

namespace gemm {

template <typename TA, typename TB, bool kMma, typename TC>
__global__ void __launch_bounds__(kThreads)
    gemm_sub_kernel(int M, int N, int K, const TA* __restrict__ A, i64 lda,
                    const TB* __restrict__ B, i64 ldb, TC* __restrict__ C,
                    i64 ldc, const int* __restrict__ pos, int thr) {
  if constexpr (kMma)
    tile_mma<TA, TB, TC>(M, N, K, A, lda, B, ldb, C, ldc, pos, thr, blockIdx.y * kBM,
                         blockIdx.x * kBN);
  else
    tile_ffma<TA, TB>(M, N, K, A, lda, B, ldb, C, ldc, pos, thr, blockIdx.y * kFM,
                      blockIdx.x * kFN);
}

int launch_gemm_sub(int mode, int M, int N, int K, const void* A, i64 lda,
                    const void* B, i64 ldb, void* C, int c_bf16, i64 ldc,
                    const int* pos, int thr, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  typedef __nv_bfloat16 bf;
  dim3 grid_mma((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (c_bf16) {
    if (mode != 0) return (int)cudaErrorInvalidValue;
    gemm_sub_kernel<bf, bf, true, bf><<<grid_mma, kThreads, 0, stream>>>(
        M, N, K, (const bf*)A, lda, (const bf*)B, ldb, (bf*)C, ldc, pos, thr);
  } else if (mode == 2) {
    dim3 grid((N + kFN - 1) / kFN, (M + kFM - 1) / kFM);
    gemm_sub_kernel<float, float, false, float><<<grid, kThreads, 0, stream>>>(
        M, N, K, (const float*)A, lda, (const float*)B, ldb, (float*)C, ldc, pos, thr);
  } else if (mode == 0) {
    gemm_sub_kernel<bf, bf, true, float><<<grid_mma, kThreads, 0, stream>>>(
        M, N, K, (const bf*)A, lda, (const bf*)B, ldb, (float*)C, ldc, pos, thr);
  } else if (mode == 1) {
    gemm_sub_kernel<float, float, true, float><<<grid_mma, kThreads, 0, stream>>>(
        M, N, K, (const float*)A, lda, (const float*)B, ldb, (float*)C, ldc, pos, thr);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace gemm

// C[0:M, 0:N] -= A[0:M, 0:K] @ B[0:K, 0:N]; mode as in launch_gemm_sub
// (0: bf16 operands on the tensor cores, 2: fp32 operands on FFMA); C is
// bf16 when c_bf16 (bf16 operands only), else fp32.
MPF_API int mpf_trailing_sub(int mode, int M, int N, int K, const void* A, i64 lda,
                             const void* B, i64 ldb, void* C, int c_bf16, i64 ldc,
                             void* stream) {
  return gemm::launch_gemm_sub(mode, M, N, K, A, lda, B, ldb, C, c_bf16, ldc, nullptr, 0,
                               (cudaStream_t)stream);
}

MPF_API const char* mpf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
