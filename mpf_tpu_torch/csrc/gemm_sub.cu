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
// (2 (n-e)^2 * bc flops per block column).  With bf16 operands the products
// are tensor-core bound and C's read-modify-write bytes bound, of the same
// order at K = 1024 (gemm_sm90.cuh says how its design treats both); the
// fp32-operand form (PURE_FP32, MPF_REF, MPF_FP16) is FFMA bound
// (gemm_ffma.cuh).
//
// Design: the bf16-operand instances (fp32 C, bf16 C) run the Hopper
// routine of gemm_sm90.cuh as trailing_kernel<C, false> (kernel 12's update
// pass runs it as trailing_kernel<bf16, true>, launch_update): TMA tile
// loads into an mbarrier ring, a producer warpgroup and two wgmma consumer
// warpgroups, one persistent block per SM, C read and written once per tile
// in the epilogue (the TPU kernel's point: no separate product array and
// subtract pass).  bf16 C that TMA can read and write in place goes through
// shared memory (loaded by TMA beside the products, stored by TMA), any
// other C stays in registers; the caller chooses by C's dtype and
// alignment.  The fp32-operand instance runs the FFMA routine of
// gemm_ffma.cuh (128 x 128 tiles, 8 x 8 outputs a thread, a TMA ring on
// mbarriers), one block a tile in the grouped raster order, two blocks an
// SM.  launch_gemm_sub also
// serves the streaming panel update's masked update (panel_update.cu:
// tile_mma with a row mask for bf16 operands, the FFMA routine with the row
// mask for fp32).
#include "gemm_ffma.cuh"

namespace gemm {

template <typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(kThreads)
    gemm_sub_kernel(int M, int N, int K, const TA* __restrict__ A, i64 lda,
                    const TB* __restrict__ B, i64 ldb, TC* __restrict__ C,
                    i64 ldc, const int* __restrict__ pos, int thr) {
  tile_mma<TA, TB, TC>(M, N, K, A, lda, B, ldb, C, ldc, pos, thr, blockIdx.y * kBM,
                       blockIdx.x * kBN);
}

namespace ffma {

template <bool kTma>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ffma_sub_kernel(const __grid_constant__ CUtensorMap tmA,
                    const __grid_constant__ CUtensorMap tmB, const __grid_constant__ Args g) {
  extern __shared__ uint8_t ffma_smem[];
  const Ring ring = ring_init(ffma_smem);
  const int tiles_m = (g.M + kBM - 1) / kBM, tiles_n = (g.N + kBN - 1) / kBN;
  int m0, n0;
  tile_origin(blockIdx.x, tiles_m, tiles_n, m0, n0);
  uint32_t it = 0;
  run_tile<kTma>(g, &tmA, &tmB, ring, it, m0, n0);
}

int launch(const Args& g, cudaStream_t st) {
  CUtensorMap ta, tb;
  bool tma;
  int err = operand_maps(g, &ta, &tb, tma);
  if (err) return err;
  const void* kern =
      tma ? (const void*)ffma_sub_kernel<true> : (const void*)ffma_sub_kernel<false>;
  cudaError_t e = dyn_smem(kern, kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)tile_count(g.M, g.N));
  if (tma)
    ffma_sub_kernel<true><<<grid, kThreads, kSmem, st>>>(ta, tb, g);
  else
    ffma_sub_kernel<false><<<grid, kThreads, kSmem, st>>>(ta, tb, g);
  return (int)cudaGetLastError();
}

}  // namespace ffma

int launch_gemm_sub(int mode, int M, int N, int K, const void* A, i64 lda,
                    const void* B, i64 ldb, float* C, i64 ldc, const int* pos, int thr,
                    cudaStream_t stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (mode == 2) {
    const ffma::Args g{M, N, K, (const float*)A, lda, (const float*)B, ldb, C, ldc, pos, thr};
    return ffma::launch(g, stream);
  } else if (mode == 1) {
    dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    gemm_sub_kernel<float, float, float><<<grid, kThreads, 0, stream>>>(
        M, N, K, (const float*)A, lda, (const float*)B, ldb, C, ldc, pos, thr);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

namespace sm90 {

// where a launch keeps C during its epilogue (mpf_trailing_sub's c_mode
// less one for bf16 C): in registers, or through shared memory in the
// launch's layout (kernel 6: kStages6 / kHalves6; kernel 12's update pass:
// kStages12 / kHalves12)
enum Epi : int { kEpiRegs = 0, kEpiStaged = 1 };

// kUpdate: kernel 12's update pass (so the profiler tells it from kernel 6
// by name); the epilogue placement is the launch's argument, each a
// compile-time instance of run<> behind a uniform branch
template <typename TC, bool kUpdate>
__global__ void __launch_bounds__(kThreads, 1)
    trailing_kernel(const __grid_constant__ CUtensorMap tmA,
                    const __grid_constant__ CUtensorMap tmB,
                    const __grid_constant__ CUtensorMap tmC, int M, int N, int K,
                    TC* __restrict__ C, i64 ldc, int epi) {
  if constexpr (sizeof(TC) == 2) {
    if constexpr (kUpdate) {
      if (epi == kEpiStaged) {
        run<TC, false, kStages12, kHalves12>(&tmA, &tmB, &tmC, M, N, K, C, ldc);
        return;
      }
    } else {
      if (epi == kEpiStaged) {
        run<TC, false, kStages6, kHalves6>(&tmA, &tmB, &tmC, M, N, K, C, ldc);
        return;
      }
    }
  }
  run<TC, false>(&tmA, &tmB, &tmC, M, N, K, C, ldc);
}

// one launch of trailing_kernel<TC, kUpdate> with the epilogue epi; C
// through shared memory takes bf16 C that c_tma_ok passes, else the call
// returns cudaErrorInvalidValue
template <typename TC, bool kUpdate>
int launch(int M, int N, int K, const void* A, i64 lda, const void* B, i64 ldb, TC* C,
           i64 ldc, Epi epi, cudaStream_t st) {
  const long long tiles = tile_count(M, N, K);
  if (tiles == 0) return (int)cudaGetLastError();
  CUtensorMap ta, tb, tc;
  int err = encode_operands(&ta, &tb, M, N, K, A, lda, B, ldb);
  if (err) return err;
  memset(&tc, 0, sizeof(tc));
  int smem = kSmem;
  if (epi != kEpiRegs) {
    if (sizeof(TC) != 2 || !c_tma_ok(C, N, ldc, sizeof(TC))) return (int)cudaErrorInvalidValue;
    // C's own map: boxes of 64 rows x 64 columns, both for the loads and
    // for the stores
    err = encode(&tc, C, M, N, ldc, 64);
    if (err) return err;
    smem = kUpdate ? smem_bytes(kStages12, kHalves12) : smem_bytes(kStages6, kHalves6);
  }
  cudaError_t e = dyn_smem((const void*)trailing_kernel<TC, kUpdate>, smem);
  if (e != cudaSuccess) return (int)e;
  const int nsm = sm_count();
  const int grid = (int)(tiles < nsm ? tiles : nsm);
  trailing_kernel<TC, kUpdate><<<grid, kThreads, smem, st>>>(ta, tb, tc, M, N, K, C, ldc,
                                                             (int)epi);
  return (int)cudaGetLastError();
}

int launch_update(int M, int N, int K, const void* A, i64 lda, const void* B, i64 ldb,
                  __nv_bfloat16* C, i64 ldc, bool smem_c, cudaStream_t st) {
  const Epi epi = smem_c && c_tma_ok(C, N, ldc, sizeof(*C)) ? kEpiStaged : kEpiRegs;
  return launch<__nv_bfloat16, true>(M, N, K, A, lda, B, ldb, C, ldc, epi, st);
}

}  // namespace sm90

}  // namespace gemm

// C[0:M, 0:N] -= A[0:M, 0:K] @ B[0:K, 0:N] with fp32 sums.  mode 0: bf16
// operands on the tensor cores (the Hopper routine; A and B at 16-byte
// aligned bases with row strides that are multiples of 8 elements, else the
// tensor maps fail to encode and the call returns an error); mode 2: fp32
// operands on FFMA, fp32 C.  c_mode: 0 fp32 C (C in registers), 1 bf16 C in
// registers, 2 bf16 C through shared memory (needs a 16-byte base, row stride
// and width, else the call returns cudaErrorInvalidValue: the caller decides
// with the same test).
MPF_API int mpf_trailing_sub(int mode, int M, int N, int K, const void* A, i64 lda,
                             const void* B, i64 ldb, void* C, int c_mode, i64 ldc,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0 && c_mode == 0)
    return gemm::sm90::launch<float, false>(M, N, K, A, lda, B, ldb, (float*)C, ldc,
                                            gemm::sm90::kEpiRegs, st);
  if (mode == 0 && c_mode >= 1 && c_mode <= 2)
    return gemm::sm90::launch<__nv_bfloat16, false>(M, N, K, A, lda, B, ldb,
                                                    (__nv_bfloat16*)C, ldc,
                                                    (gemm::sm90::Epi)(c_mode - 1), st);
  if (mode != 2 || c_mode != 0) return (int)cudaErrorInvalidValue;
  return gemm::launch_gemm_sub(mode, M, N, K, A, lda, B, ldb, (float*)C, ldc, nullptr, 0, st);
}

MPF_API const char* mpf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
