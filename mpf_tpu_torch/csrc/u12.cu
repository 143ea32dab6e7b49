// Kernel 17: U12 = L11^-1 A12 under bf16 storage, on the tensor cores.
//
// Replaces: no Pallas kernel.  It is the JAX package's outer U12 product,
// `jnp.dot(linv, a12, preferred_element_type=policy.accum).astype(a.dtype)`
// (mpf_tpu/models/mpf.py:545), on bf16 operands: C (kw x w) = bf16(L @ B),
// L = L11^-1 (kw x kw, bf16, unit lower triangular), B = A12 (kw x w, a
// strided bf16 view of the matrix), C a new row-major bf16 buffer.  Every
// product of two bf16 numbers is exact in fp32, so fp32 sums on the tensor
// cores compute the function that an IEEE fp32 product of the upcast
// operands computes, up to the order of the sum.
//
// What bounds it on the H100: at kw = 1024, w = 64512 (block column 0 at n
// = 65536) the products L needs (tile row i of 128 rows reads K < 128 (i +
// 1): 2 w 128^2 * 36 = 7.6e10 flops) take 0.077 ms at 989 TFLOP/s, and the
// bytes (B read once and C written once, 2 kw w bytes each, and L) 0.079
// ms at 3.35 TB/s: the two are about even.  Over a factorization at n =
// 65536 (63 launches): 2.44e12 flops and 8.46 GB, about 2.5 ms.
//
// Design: the store instance of kernel 6's Hopper routine (gemm_sm90.cuh,
// run<..., kStore = true>): the TMA ring, the producer warpgroup, two
// consumer warpgroups on wgmma m64n256k16 and one persistent block an SM.
// Tile row i stops its K loop at min(kw, 128 (i + 1)); the persistent walk
// pairs each block's deep and shallow tiles in windows of whole tile
// columns that stay in L2 while the window's tile rows read B.  The
// epilogue rounds the fp32 sums once to bf16 into kernel 6's 32 KB
// shared-memory slot, and TMA stores the slot while the next tile's
// products run (0.130 ms at w = 64512, against 0.149 with the register
// epilogue's stores, which the consumers issue themselves: PERF.md section
// 6 row 17).  TMA stores whole 16-byte pieces of a row, so C's rows are
// padded to a multiple of 8 entries; the padding receives the products of
// B's zero-filled columns past w, zeros.
#include "gemm_sm90.cuh"

namespace gemm {
namespace sm90 {
namespace {

// kernel 6's ring of four stages and one 32 KB slot that the consumer
// warpgroups' halves take in turn
constexpr int kStages17 = kStages6, kHalves17 = kHalves6;

typedef __nv_bfloat16 bf;

__global__ void __launch_bounds__(kThreads, 1)
    u12_product_kernel(const __grid_constant__ CUtensorMap tmA,
                       const __grid_constant__ CUtensorMap tmB,
                       const __grid_constant__ CUtensorMap tmC, int M, int N) {
  run<bf, false, kStages17, kHalves17, true>(&tmA, &tmB, &tmC, M, N, M, nullptr, 0);
}

}  // namespace
}  // namespace sm90
}  // namespace gemm

// C[0:M, 0:N8] = bf16(L[0:M, 0:M] @ B[0:M, 0:N]) with fp32 sums, N8 = N
// rounded up to a multiple of 8 (the columns past N are zeros); L lower
// triangular (read only at and left of each 128-row tile's diagonal
// block).  L and B bf16 at 16-byte aligned bases with row strides that
// are multiples of 8 elements, else the tensor maps fail to encode and the
// call returns an error; C bf16 at a 16-byte base with such a row stride,
// else cudaErrorInvalidValue.
MPF_API int mpf_u12_product(int M, int N, const void* L, i64 ldl, const void* B, i64 ldb,
                            void* C, i64 ldc, void* stream) {
  using namespace gemm::sm90;
  const long long tiles = tile_count(M, N, M);
  if (tiles == 0) return (int)cudaGetLastError();
  const int n8 = (N + 7) / 8 * 8;
  if (!c_tma_ok(C, n8, ldc, sizeof(bf))) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb, tc;
  int err = encode_operands(&ta, &tb, M, N, M, L, ldl, B, ldb);
  if (!err) err = encode(&tc, C, M, n8, ldc, 64);
  if (err) return err;
  const int smem = smem_bytes(kStages17, kHalves17);
  cudaError_t e = dyn_smem((const void*)u12_product_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int nsm = sm_count();
  const int grid = (int)(tiles < nsm ? tiles : nsm);
  u12_product_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(ta, tb, tc, M, N);
  return (int)cudaGetLastError();
}
