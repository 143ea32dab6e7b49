// Kernel 12 (B for bf16 slabs): the L21 pass and the wide-column update
// pass, two launches behind two entry points, as the TPU ran two
// pallas_calls.
//
// Replaces: mpf_tpu/ops/panel_fused.py:_l21_trim_kernel and
// _upd_wide_kernel (via panel_apply_update_trim, which routes bf16 slabs
// here and fp32 slabs to kernel 3).  On the (m, bc) bf16 slab, panel at
// column jj0, thr = j0 + r:
//   L21 pass:    L21 = bf16(A[:, jj0:jj0+r] @ U11^{-1})   (fp32 accumulation)
//                rows at position >= thr: A[row, jj0:jj0+r] = L21
//                side buffer (m, r) bf16: L21, zeros on rows at position < thr
//   update pass: A[:, jj0+r:bc] = bf16(fp32(A) - L21buf @ U12), U12 = the row
//                block's columns jj0+r.. (bf16 operands, fp32 accumulation)
// The update pass has no row mask: frozen rows carry L21 = 0, and
// bf16(fp32(b) - 0) is b.  The TPU's cw-wide column blocks straddle the
// panel edge and pass lanes < glo through; here the update starts at column
// jj0 + r.  Columns left of the panel are never touched.
//
// What bounds it on the H100: bytes.  Per panel the L21 pass reads m x r
// and writes 2 m x r bf16 (2 m r^2 flops: small); the update pass reads and
// writes m x (bc - jj0 - r) bf16 and does 2 m r (bc - jj0 - r) flops, far
// below the bf16 tensor-core ridge.
//
// Design: (1) the L21 tile kernel of common.cuh (l21::, shared with kernel
// 3): one block per 64-row tile, U11^{-1} and the tile's panel columns in
// shared memory as fp32, fp32 FMA over exact bf16 products, one rounding to
// bf16.  (2) upd_wide_kernel: the shared mma.sync tile routine
// (gemm::tile_mma) with the bf16-C epilogue and no row mask, one 128 x 128
// output tile per block.
#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf;

__global__ void __launch_bounds__(gemm::kThreads)
    upd_wide_kernel(int m, int w, int r, const bf* __restrict__ l21buf,
                    const bf* __restrict__ u12, i64 ldu, bf* __restrict__ c, i64 ldc) {
  gemm::tile_mma<bf, bf, bf>(m, w, r, l21buf, r, u12, ldu, c, ldc, nullptr, 0,
                             blockIdx.y * gemm::kBM, blockIdx.x * gemm::kBN);
}

}  // namespace

// L21 pass on the bf16 slab (row stride ld), panel at column jj0; l21buf is
// (m, r) bf16.
MPF_API int mpf_l21_trim(int m, int r, void* slab, i64 ld, int jj0, const int* pos,
                         int thr, const void* uinv, void* l21buf, void* stream) {
  if (m <= 0) return (int)cudaGetLastError();
  return l21::launch<bf>(m, r, (bf*)slab, ld, jj0, pos, thr, (const bf*)uinv,
                         (bf*)l21buf, (cudaStream_t)stream);
}

// Update pass: c[0:m, 0:w] = bf16(c - l21buf @ u12) with u12 (r, w) at row
// stride ldu and c at row stride ldc (both views of the row block and the
// slab at column jj0 + r).
MPF_API int mpf_upd_wide(int m, int w, int r, const void* l21buf, const void* u12, i64 ldu,
                         void* c, i64 ldc, void* stream) {
  if (m <= 0 || w <= 0) return (int)cudaGetLastError();
  dim3 grid((w + gemm::kBN - 1) / gemm::kBN, (m + gemm::kBM - 1) / gemm::kBM);
  upd_wide_kernel<<<grid, gemm::kThreads, 0, (cudaStream_t)stream>>>(
      m, w, r, (const bf*)l21buf, (const bf*)u12, ldu, (bf*)c, ldc);
  return (int)cudaGetLastError();
}
