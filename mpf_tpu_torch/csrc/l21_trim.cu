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
// What bounds it on the H100: the L21 pass, operations (2 m r^2 fp32 FMA:
// 8.0 us at m = 16384, r = 128); the update pass, bytes (it reads and
// writes m x (bc - jj0 - r) bf16: 18.8 us at block column offset 0, against
// 2 m r (bc - jj0 - r) flops, far below the bf16 tensor-core ridge).
//
// Design: (1) the L21 pass of l21.cuh (shared with kernel 3): an FFMA GEMM,
// 8 x 8 outputs a thread, TMA-fed stages, bf16 widened as it is read, each
// entry one fmaf chain in ascending k, rounded once to bf16.
// (2) the update pass runs kernel 6's Hopper routine at K = r
// (gemm_sm90.cuh: TMA loads, wgmma, persistent tiles) as its own launch,
// trailing_kernel<bf16, true>, by default with its own layout that carries
// C through shared memory by TMA (two A/B stages, two C slots), so that C's
// read-modify-write overlaps the neighbouring tiles' products.  The side
// buffer's rows are padded to a multiple of 8 elements so that TMA reads it
// in place.
#include "l21.cuh"

typedef __nv_bfloat16 bf;

// L21 pass on the bf16 slab (row stride ld), panel at column jj0; l21buf is
// (m, r) bf16 at row stride ldl.
MPF_API int mpf_l21_trim(int m, int r, void* slab, i64 ld, int jj0, const int* pos,
                         int thr, const void* uinv, void* l21buf, i64 ldl, void* stream) {
  return l21::launch<bf>(m, r, (bf*)slab, ld, jj0, pos, thr, (const bf*)uinv, (bf*)l21buf,
                         ldl, (cudaStream_t)stream);
}

// Update pass: c[0:m, 0:w] = bf16(c - l21buf @ u12), l21buf (m, r) at row
// stride ldl, u12 (r, w) at row stride ldu, c at row stride ldc (views of the
// row block and the slab at column jj0 + r).  l21buf and u12 at 16-byte
// bases with row strides that are multiples of 8 elements (TMA); smem_c: C
// through shared memory where its base and stride allow.
MPF_API int mpf_upd_wide(int m, int w, int r, const void* l21buf, i64 ldl, const void* u12,
                         i64 ldu, void* c, i64 ldc, int smem_c, void* stream) {
  if (m <= 0 || w <= 0) return (int)cudaGetLastError();
  return gemm::sm90::launch_update(m, w, r, l21buf, ldl, u12, ldu, (bf*)c, ldc, smem_c != 0,
                                   (cudaStream_t)stream);
}
