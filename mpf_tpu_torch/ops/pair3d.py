"""Pair-layout (natively 3D) working-matrix ops (port of
`mpf_tpu/ops/pair3d.py`).

The pair layout keeps the n x n working matrix as an (n/2, 2, n) tensor,
row i at ``a3[i // 2, i % 2]``.  On the TPU it cut the row exchange's DMA
granule from 16 rows to 2; the card has no such granule, and a contiguous
(n/2, 2, n) tensor is the same bytes as the row-major (n, n) matrix
(:func:`as_matrix`).  So the ops here compute the TPU kernels' functions on
that view, and the 2-row windows, rings and VMEM reshapes of the TPU
kernels have no counterpart:

* :func:`slab_extract` / :func:`slab_writeback` (kernels 15a, 15b) — the
  (m, bc) block-column slab copied out of the matrix and back, so the panel
  kernels (1, 2, 3 or 12) run on a contiguous slab, as `_factorize_3d` runs
  them (the card's panel kernels take any row stride, so the copy is kept
  for the function, not for the card);
* :func:`band_write_rows` (15c) — the exchange's pivot rows over the band;
* :func:`u12_transform` (15d) — U12 := L11^{-1} A12 in place;
* :func:`trailing_sub3` — the trailing GEMM: kernel 6 on the view, counted
  as ``trailing_sub``.

Kernels 15a-15d live in ``csrc/pair3d.cu``.  CPU tensors take the plain
versions beside them; CUDA tensors launch the kernels.
"""

from __future__ import annotations

import torch

from mpf_tpu_torch.ops import _lib
from mpf_tpu_torch.ops.blas3 import matmul_in
from mpf_tpu_torch.ops.panel_fused import trailing_gemm_sub


def as_matrix(a3: torch.Tensor) -> torch.Tensor:
    """The (n, n) matrix view of the contiguous fp32 or bf16 (n/2, 2, n)
    tensor ``a3``: row i is ``a3[i // 2, i % 2]``."""
    _lib.check(a3.dim() == 3 and a3.shape[1] == 2 and 2 * a3.shape[0] == a3.shape[2]
               and a3.is_contiguous() and a3.dtype in (torch.float32, torch.bfloat16),
               f"expected a contiguous fp32 or bf16 (n/2, 2, n) tensor, got "
               f"{tuple(a3.shape)} {a3.dtype}")
    n = a3.shape[2]
    return a3.view(n, n)


def _block_copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst[:] = src`` for two non-overlapping row-major views of one
    shape and dtype, on the card (kernel ``mpf_block_copy``)."""
    _lib.check(dst.shape == src.shape and dst.dtype == src.dtype and dst.dim() == 2
               and dst.stride(1) == 1 and src.stride(1) == 1,
               "block copy: two row-major views of one shape and dtype")
    _lib.call("mpf_block_copy", dst.shape[0], dst.shape[1], dst.data_ptr(), dst.stride(0),
              src.data_ptr(), src.stride(0), dst.element_size())


def slab_extract_plain(a3, k0: int, k: int, m: int, bc: int) -> torch.Tensor:
    """Plain version of :func:`slab_extract`."""
    _lib.counted_plain("slab_extract")
    return as_matrix(a3)[k0:k0 + m, k:k + bc].clone()


def slab_extract(a3, k0: int, k: int, m: int, bc: int) -> torch.Tensor:
    """A contiguous copy of rows [k0, k0+m), columns [k, k+bc) of the pair
    matrix: the (m, bc) 2D slab.  CPU tensors take the plain version; CUDA
    tensors launch kernel 15a."""
    a = as_matrix(a3)
    _lib.check(0 <= k0 and k0 + m <= a.shape[0] and 0 <= k and k + bc <= a.shape[1],
               "slab_extract: slab outside the matrix")
    if not _lib.on_cuda(a3):
        return slab_extract_plain(a3, k0, k, m, bc)
    out = torch.empty((m, bc), dtype=a.dtype, device=a.device)
    _block_copy(out, a[k0:k0 + m, k:k + bc])
    _lib.counted_launch("slab_extract")
    return out


def slab_writeback_plain(a3, sub, k0: int, k: int):
    """Plain version of :func:`slab_writeback`."""
    _lib.counted_plain("slab_writeback")
    m, bc = sub.shape
    as_matrix(a3)[k0:k0 + m, k:k + bc] = sub
    return a3


def slab_writeback(a3, sub, k0: int, k: int):
    """IN PLACE: rows [k0, k0+m), columns [k, k+bc) of the pair matrix :=
    the (m, bc) slab ``sub`` (of the matrix's dtype).  Returns ``a3``.  CPU
    tensors take the plain version; CUDA tensors launch kernel 15b."""
    a = as_matrix(a3)
    m, bc = sub.shape
    _lib.check(0 <= k0 and k0 + m <= a.shape[0] and 0 <= k and k + bc <= a.shape[1],
               "slab_writeback: slab outside the matrix")
    if not _lib.on_cuda(a3, sub):
        return slab_writeback_plain(a3, sub, k0, k)
    _block_copy(a[k0:k0 + m, k:k + bc], sub)
    _lib.counted_launch("slab_writeback")
    return a3


def band_write_rows_plain(a3, pivrows, k: int):
    """Plain version of :func:`band_write_rows`."""
    _lib.counted_plain("band_write")
    as_matrix(a3)[k:k + pivrows.shape[0]] = pivrows
    return a3


def band_write_rows(a3, pivrows, k: int):
    """IN PLACE: rows [k, k+nr) of the pair matrix := ``pivrows`` (nr, n),
    the pivot rows :func:`rows_exchange3` returned, in the matrix's dtype.
    The caller overlays the block column's finished (nr, nr) row block
    afterwards, as the JAX driver does (`mpf.py:641-642`).  Returns ``a3``.
    CPU tensors take the plain version; CUDA tensors launch kernel 15c."""
    a = as_matrix(a3)
    nr = pivrows.shape[0]
    _lib.check(0 <= k and k + nr <= a.shape[0] and pivrows.shape[1:] == a.shape[1:],
               "band_write_rows: pivrows must be (nr, n) rows inside the matrix")
    if not _lib.on_cuda(a3, pivrows):
        return band_write_rows_plain(a3, pivrows, k)
    _block_copy(a[k:k + nr], pivrows)
    _lib.counted_launch("band_write")
    return a3


def u12_transform_plain(a3, linv, ks: int, e: int, w: int):
    """Plain version of :func:`u12_transform`: the 2D loop's U12
    (`models/mpf.py:_trailing_update`), an IEEE-fp32 product of operands in
    the working dtype, rounded once."""
    _lib.counted_plain("u12_inplace")
    a = as_matrix(a3)
    kw = linv.shape[0]
    a[ks:ks + kw, e:e + w] = matmul_in(linv, a[ks:ks + kw, e:e + w], a.dtype).to(a.dtype)
    return a3


def u12_transform(a3, linv, ks: int, e: int, w: int):
    """IN PLACE: rows [ks, ks+kw), columns [e, e+w) of the pair matrix :=
    ``linv @`` those rows (the reference's U12 TRSM, `MPF.cu:215-225`),
    with ``linv`` (kw, kw) the unit-lower inverse of the diagonal block in
    the working dtype.  Sums are IEEE fp32, rounded once to the working
    dtype.  The JAX function's ``prec`` has no counterpart: the port's U12
    is IEEE fp32 always.  Returns ``a3``.  CPU tensors take the plain
    version; CUDA tensors launch kernel 15d, which reads only linv's lower
    triangle and diagonal (its upper triangle is zero)."""
    a = as_matrix(a3)
    kw = linv.shape[0]
    _lib.check(linv.dim() == 2 and linv.shape[1] == kw and 0 <= ks and ks + kw <= a.shape[0]
               and 0 <= e and e + w <= a.shape[1],
               "u12_transform: linv must be square and the block inside the matrix")
    if not _lib.on_cuda(a3, linv):
        return u12_transform_plain(a3, linv, ks, e, w)
    _lib.check(linv.dtype == a.dtype and linv.stride(1) == 1,
               "u12_transform: linv must be row-major, in the matrix's dtype")
    blk = a[ks:ks + kw, e:e + w]
    _lib.call("mpf_u12_inplace", kw, w, blk.data_ptr(), a.stride(0), linv.data_ptr(),
              linv.stride(0), int(a.dtype == torch.bfloat16))
    _lib.counted_launch("u12_inplace")
    return a3


def trailing_sub3(a3, l21, u12, ko: int, ncols: int | None = None):
    """IN PLACE: rows [ko, ko+m), columns [ko, ko+ncols) of the pair matrix
    -= ``l21 @ u12`` (`pair3d.trailing_sub3`'s function): kernel 6
    (:func:`trailing_gemm_sub`) on :func:`as_matrix`, whose operands and
    rounding it takes.  The TPU kernel's (x/2, 2, y) tiles existed for its
    DMA granule.  Returns ``a3``."""
    trailing_gemm_sub(as_matrix(a3), l21, u12, ko, ncols=ncols)
    return a3
