"""Fused panel-step kernels (port of `mpf_tpu/ops/panel_fused.py`).

* :func:`rowblock_assemble` (A2, kernel 2, ``csrc/rowblock.cu``) — gathers
  the r pivot rows, refactors the r x r diagonal block without pivoting in
  fp32 with fused L^{-1} and U^{-1}, and builds the finished row block.
* :func:`panel_apply_update_trim` (B, kernel 3, ``csrc/panel_update.cu``)
  — L21 = A[:, panel] U^{-1} and the rank-r update of the columns right of
  the panel, on the rows at virtual position >= j0 + r, in place.
* :func:`trailing_gemm_sub` (kernel 6, ``csrc/gemm_sub.cu``) — the trailing
  update A[e:, e:e+w] -= L21 U12 in place, fp32 accumulation.

Slabs are views into the working matrix (row stride = the matrix width);
the kernels update them in place where the TPU kernels aliased their
output to their input.  The TPU tiling helpers (`_trailing_segments`, the
``rb``/``cw`` choices, ``MPF_SPLITB``) have no counterpart here.
"""

from __future__ import annotations

import torch

from mpf_tpu_torch.ops import _lib
from mpf_tpu_torch.ops.blas3 import ieee_fp32


def _row_major(t: torch.Tensor, name: str) -> None:
    _lib.check(t.dim() == 2 and t.stride(1) == 1 and t.dtype == torch.float32,
               f"{name} must be a row-major fp32 matrix view")


# --------------------------------------------------------------------------
# A2: gather pivot rows, refactor the diagonal, build the row block
# --------------------------------------------------------------------------

def rowblock_assemble_plain(slab, glist, jj0):
    """Plain version of :func:`rowblock_assemble` — the operations of
    `panel_fused._npv_inv_values` in the same order."""
    _lib.counted_plain("rowblock")
    dev = slab.device
    r = glist.shape[0]
    bc = slab.shape[1]
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    one = torch.ones((), dtype=f32, device=dev)
    staged = slab[glist.long()].to(f32)                       # (r, bc)
    b = staged[:, jj0:jj0 + r].clone()
    rows = torch.arange(r, device=dev)[:, None]
    cols = torch.arange(r, device=dev)[None, :]
    li = torch.eye(r, dtype=f32, device=dev)
    info = torch.zeros((), dtype=torch.int32, device=dev)
    for j in range(r):
        colv = b[:, j:j + 1]
        pivval = b[j, j]
        info = torch.where((pivval == 0) & (info == 0),
                           torch.tensor(j + 1, dtype=torch.int32, device=dev), info)
        safe = torch.where(pivval == 0, one, pivval)
        mult = torch.where(rows > j, colv / safe, zero)            # (r, 1)
        urow_m = torch.where(cols > j, b[j:j + 1, :], zero)        # (1, r)
        b = torch.where((cols == j) & (rows > j), mult, _lib.fms(b, mult, urow_m))
        li = _lib.fms(li, mult, li[j:j + 1, :])
    lu = b
    y = torch.zeros((r, r), dtype=f32, device=dev)
    with ieee_fp32():
        for t in range(r):
            i = r - 1 - t
            urow_m = torch.where(cols > i, lu[i:i + 1, :], zero)
            uii = lu[i, i]
            safe = torch.where(uii == 0, one, uii)
            acc = urow_m @ y
            ei = (cols == i).to(f32)
            y[i:i + 1, :] = (ei - acc) / safe
        u12 = li @ staged
    lanes = torch.arange(bc, device=dev)[None, :]
    placed = torch.zeros((r, bc), dtype=f32, device=dev)
    placed[:, jj0:jj0 + r] = lu
    in_panel = (lanes >= jj0) & (lanes < jj0 + r)
    rowblock = torch.where(in_panel, placed, torch.where(lanes < jj0, staged, u12))
    return rowblock, y, info


def rowblock_assemble(slab, glist, jj0: int):
    """Gather the r pivot rows ``glist`` of the fp32 ``slab`` (m, bc),
    refactor the (r, r) diagonal block at column ``jj0`` without pivoting,
    and return ``(rowblock, uinv, info)``:

    * ``rowblock`` (r, bc) — columns < jj0 carry the gathered L values, the
      panel columns the diagonal LU, columns >= jj0 + r
      U12 = L11^{-1} A12;
    * ``uinv`` (r, r) — U11^{-1};
    * ``info`` — int32 scalar tensor, 1-based first zero pivot, 0 if clean.

    CPU tensors take the plain version; CUDA tensors launch kernel 2."""
    if not _lib.on_cuda(slab, glist):
        return rowblock_assemble_plain(slab, glist, jj0)
    _row_major(slab, "rowblock_assemble: slab")
    r, bc = glist.shape[0], slab.shape[1]
    _lib.check(r <= 128, "rowblock_assemble: r must be <= 128")
    glist = glist.to(torch.int32).contiguous()
    dev = slab.device
    rowblock = torch.empty((r, bc), dtype=torch.float32, device=dev)
    uinv = torch.empty((r, r), dtype=torch.float32, device=dev)
    linv = torch.empty((r, r), dtype=torch.float32, device=dev)
    info = torch.empty((), dtype=torch.int32, device=dev)
    _lib.call("mpf_rowblock", r, bc, slab.data_ptr(), slab.stride(0),
              glist.data_ptr(), int(jj0), rowblock.data_ptr(), uinv.data_ptr(),
              linv.data_ptr(), info.data_ptr())
    _lib.counted_launch("rowblock")
    return rowblock, uinv, info


# --------------------------------------------------------------------------
# B: streaming masked L21 + in-block-column update (in place)
# --------------------------------------------------------------------------

def panel_apply_update_trim_plain(slab, pos, rowblock, uinv, j0, jj0,
                                  gemm_bf16=False):
    """Plain version of :func:`panel_apply_update_trim`."""
    _lib.counted_plain("panel_update")
    r = rowblock.shape[0]
    bc = slab.shape[1]
    below = (pos >= j0 + r)[:, None]
    p = slab[:, jj0:jj0 + r]
    with ieee_fp32():
        l21 = torch.where(below, p @ uinv, torch.zeros((), dtype=p.dtype,
                                                        device=p.device))
        slab[:, jj0:jj0 + r] = torch.where(below, l21, p)
        if jj0 + r < bc:
            u12 = rowblock[:, jj0 + r:]
            if gemm_bf16:
                upd = (l21.to(torch.bfloat16).float()
                       @ u12.to(torch.bfloat16).float())
            else:
                upd = l21 @ u12
            right = slab[:, jj0 + r:]
            slab[:, jj0 + r:] = torch.where(below, right - upd, right)
    return slab


def panel_apply_update_trim(slab, pos, rowblock, uinv, j0: int, jj0: int,
                            gemm_bf16: bool = False):
    """IN PLACE on the fp32 ``slab`` (m, bc): for every row at virtual
    position ``pos >= j0 + r`` compute L21 = A[:, jj0:jj0+r] U11^{-1}, write
    it into the panel columns, and subtract L21 @ U12 (``rowblock``'s
    columns right of the panel; bf16 operands when ``gemm_bf16``) from the
    columns right of the panel.  Other rows and the columns left of the
    panel are untouched.  Returns ``slab``.

    CPU tensors take the plain version; CUDA tensors launch kernel 3."""
    if not _lib.on_cuda(slab, pos, rowblock, uinv):
        return panel_apply_update_trim_plain(slab, pos, rowblock, uinv, j0, jj0,
                                             gemm_bf16)
    _row_major(slab, "panel_apply_update_trim: slab")
    m, bc = slab.shape
    r = rowblock.shape[0]
    pos = pos.to(torch.int32).contiguous()
    rowblock = rowblock.contiguous()
    uinv = uinv.contiguous()
    l21 = torch.empty((m, r), dtype=torch.float32, device=slab.device)
    _lib.call("mpf_panel_update", m, bc, r, slab.data_ptr(), slab.stride(0),
              int(jj0), pos.data_ptr(), int(j0 + r), rowblock.data_ptr(),
              uinv.data_ptr(), l21.data_ptr(), int(bool(gemm_bf16)))
    _lib.counted_launch("panel_update")
    return slab


# --------------------------------------------------------------------------
# Trailing GEMM with the subtract in the epilogue (in place)
# --------------------------------------------------------------------------

def trailing_gemm_sub_plain(a, l21, u12, ko, ncols=None):
    """Plain version of :func:`trailing_gemm_sub`."""
    _lib.counted_plain("trailing_sub")
    m = l21.shape[0]
    ncols = m if ncols is None else ncols
    with ieee_fp32():
        prod = l21.float() @ u12.float()
    reg = a[ko:ko + m, ko:ko + ncols]
    a[ko:ko + m, ko:ko + ncols] = (reg.float() - prod).to(a.dtype)
    return a


def trailing_gemm_sub(a, l21, u12, ko: int, ncols: int | None = None):
    """IN PLACE on the fp32 matrix ``a``: a[ko:ko+m, ko:ko+ncols] -=
    l21 @ u12 with fp32 accumulation (m = l21 rows; ``ncols`` defaults to
    m).  ``l21``/``u12`` are both bf16 (tensor cores) or both fp32 (IEEE
    FFMA).  Returns ``a``.

    CPU tensors take the plain version; CUDA tensors launch kernel 6."""
    if not _lib.on_cuda(a, l21, u12):
        return trailing_gemm_sub_plain(a, l21, u12, ko, ncols)
    _row_major(a, "trailing_gemm_sub: a")
    m, kk = l21.shape
    ncols = m if ncols is None else ncols
    _lib.check(u12.shape == (kk, ncols), f"u12 shape {tuple(u12.shape)} != ({kk}, {ncols})")
    _lib.check(l21.dtype == u12.dtype and l21.dtype in (torch.bfloat16, torch.float32),
               "trailing_gemm_sub: l21/u12 must both be bf16 or both fp32")
    _lib.check(l21.stride(1) == 1 and u12.stride(1) == 1,
               "trailing_gemm_sub: l21/u12 must be row-major")
    _lib.check(ko + m <= a.shape[0] and ko + ncols <= a.shape[1],
               "trailing_gemm_sub: update region outside a")
    mode = 0 if l21.dtype == torch.bfloat16 else 2
    c = a[ko:ko + m, ko:ko + ncols]
    _lib.call("mpf_trailing_sub", mode, m, ncols, kk, l21.data_ptr(), l21.stride(0),
              u12.data_ptr(), u12.stride(0), c.data_ptr(), a.stride(0))
    _lib.counted_launch("trailing_sub")
    return a
