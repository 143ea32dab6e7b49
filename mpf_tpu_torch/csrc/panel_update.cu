// Kernel 3 (B): streaming masked L21 + in-block-column update, fp32 slabs.
//
// Replaces: mpf_tpu/ops/panel_fused.py:_apply_update_trim_kernel, via
// panel_apply_update_trim, which routes fp32 slabs here (the JAX default
// for fp32 working storage).  bf16 slabs take kernel 12 (l21_trim.cu, the
// TPU's _l21_trim_kernel + _upd_wide_kernel).  For every slab row at
// virtual position >= thr (= j0 + r):
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
// Design: two launches behind one entry point.  (1) the L21 pass of l21.cuh
// (shared with kernel 12): an FFMA GEMM of 128-row tiles, 8 x 8 outputs a
// thread, fed by TMA; it writes L21 into the panel and a row-masked copy
// (zeros on frozen rows) into a side buffer.  (2) the masked C -= A B
// update with the same row mask: tile_mma (common.cuh) for bf16 operands,
// the FFMA routine (gemm_ffma.cuh) for fp32 operands.  The TPU's
// per-grid-step scratch carry of L21 becomes the side buffer, since Hopper
// blocks run in no order.
#include "l21.cuh"

MPF_API int mpf_panel_update(int m, int bc, int r, float* slab, i64 ld, int jj0,
                             const int* pos, int thr, const float* rowblock,
                             const float* uinv, float* l21buf, int gemm_bf16,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err = l21::launch<float>(m, r, slab, ld, jj0, pos, thr, uinv, l21buf, r, st);
  if (err != 0) return err;
  int w = bc - jj0 - r;
  if (w <= 0) return (int)cudaGetLastError();
  return gemm::launch_gemm_sub(gemm_bf16 ? 1 : 2, m, w, r, l21buf, r, rowblock + jj0 + r, bc,
                               slab + jj0 + r, ld, pos, thr, st);
}
