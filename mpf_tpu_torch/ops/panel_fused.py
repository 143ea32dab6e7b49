"""Fused panel-step kernels (port of `mpf_tpu/ops/panel_fused.py`).

* :func:`rowblock_assemble` (A2, kernel 2, ``csrc/rowblock.cu``) — gathers
  the r pivot rows, refactors the r x r diagonal block without pivoting in
  fp32 with fused L^{-1} and U^{-1}, and builds the finished row block.
* :func:`panel_apply_update_trim` (B) — L21 = A[:, panel] U^{-1} and the
  rank-r update of the columns right of the panel, on the rows at virtual
  position >= j0 + r, in place: fp32 slabs through kernel 3
  (``csrc/panel_update.cu``), bf16 slabs through kernel 12's two passes,
  :func:`l21_trim` and :func:`upd_wide` (``csrc/l21_trim.cu``), as the JAX
  package routes them by working dtype.
* :func:`panel_apply_update` (kernel 10, ``csrc/panel_update_full.cu``) —
  the same function in one pass over the full slab width, for fp32 and
  bf16 slabs (the JAX package's untrimmed form; tests only).
* :func:`trailing_gemm_sub` (kernel 6, ``csrc/gemm_sub.cu``) — the trailing
  update A[e:, e:e+w] -= L21 U12 in place, fp32 accumulation; bf16 C that
  TMA can read and write in place (:func:`trailing_staged`) goes through
  shared memory.
* :func:`rows_gather`, :func:`rows_scatter_inplace`,
  :func:`rows_scatter_from_band` (kernel 11, ``csrc/rows.cu``) — a gather of
  arbitrary rows and an in-place row scatter, on no driver path: tests
  hold them against the JAX kernels and kernel 4, and they wait for the
  fused distributed path.

Every kernel takes fp32 or bf16 working storage (ALL_BF16) with the TPU
kernels' round points: products of bf16 operands accumulate in fp32 and
each stored result is rounded to bf16 once.

Slabs are views into the working matrix (row stride = the matrix width);
the kernels update them in place where the TPU kernels aliased their
output to their input.  The TPU tiling helpers (`_trailing_segments`, the
``rb``/``cw`` choices, ``MPF_SPLITB``) have no counterpart here.
"""

from __future__ import annotations

import functools

import torch

from mpf_tpu_torch.ops import _lib
from mpf_tpu_torch.ops.blas3 import ieee_fp32
from mpf_tpu_torch.ops.exchange import scatter_band


def _row_major(t: torch.Tensor, name: str,
               dtypes=(torch.float32, torch.bfloat16)) -> None:
    _lib.check(t.dim() == 2 and t.stride(1) == 1 and t.dtype in dtypes,
               f"{name} must be a row-major matrix view of {dtypes}, got {t.dtype}")


# --------------------------------------------------------------------------
# A2: gather pivot rows, refactor the diagonal, build the row block
# --------------------------------------------------------------------------

def rowblock_assemble_plain(slab, glist, jj0):
    """Plain version of :func:`rowblock_assemble` — the operations of
    `panel_fused._npv_inv_values` in the same order, and the TPU kernel's
    rounding to the slab's dtype (L^{-1} before the U12 product, then LU,
    U12 and U^{-1})."""
    _lib.counted_plain("rowblock")
    w = slab.dtype
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
        u12 = li.to(w).float() @ staged
    lanes = torch.arange(bc, device=dev)[None, :]
    placed = torch.zeros((r, bc), dtype=f32, device=dev)
    placed[:, jj0:jj0 + r] = lu
    in_panel = (lanes >= jj0) & (lanes < jj0 + r)
    rowblock = torch.where(in_panel, placed, torch.where(lanes < jj0, staged, u12))
    return rowblock.to(w), y.to(w), info


def _scratch(device: torch.device) -> torch.Tensor:
    """Kernel 2's fp32 buffer on ``device`` for L^{-1} and U (r <= 128)
    for launches from the current stream, made once for each stream: its
    elimination launch writes them, its second launch reads them, in
    stream order, and launches on two streams never share it."""
    return _stream_scratch(device, torch.cuda.current_stream().cuda_stream)


@functools.lru_cache(maxsize=16)
def _stream_scratch(device: torch.device, stream: int) -> torch.Tensor:
    return torch.empty(2 * 128 * 128, dtype=torch.float32, device=device)


def rowblock_assemble(slab, glist, jj0: int):
    """Gather the r pivot rows ``glist`` of the fp32 or bf16 ``slab``
    (m, bc), refactor the (r, r) diagonal block at column ``jj0`` without
    pivoting (in fp32), and return ``(rowblock, uinv, info)`` in the slab's
    dtype:

    * ``rowblock`` (r, bc) — columns < jj0 carry the gathered L values, the
      panel columns the diagonal LU, columns >= jj0 + r
      U12 = L11^{-1} A12;
    * ``uinv`` (r, r) — U11^{-1};
    * ``info`` — int32 scalar tensor, 1-based first zero pivot, 0 if clean.

    CPU tensors take the plain version; CUDA tensors launch kernel 2 (two
    launches on the current stream, with that stream's scratch,
    :func:`_scratch`)."""
    if not _lib.on_cuda(slab, glist):
        return rowblock_assemble_plain(slab, glist, jj0)
    _row_major(slab, "rowblock_assemble: slab")
    r, bc = glist.shape[0], slab.shape[1]
    _lib.check(r <= 128, "rowblock_assemble: r must be <= 128")
    glist = glist.to(torch.int32).contiguous()
    dev = slab.device
    rowblock = torch.empty((r, bc), dtype=slab.dtype, device=dev)
    uinv = torch.empty((r, r), dtype=slab.dtype, device=dev)
    info = torch.empty((), dtype=torch.int32, device=dev)
    _lib.call("mpf_rowblock", r, bc, slab.data_ptr(), slab.stride(0),
              glist.data_ptr(), int(jj0), rowblock.data_ptr(), uinv.data_ptr(),
              _scratch(dev).data_ptr(), info.data_ptr(), int(slab.dtype == torch.bfloat16))
    _lib.counted_launch("rowblock")
    return rowblock, uinv, info


# --------------------------------------------------------------------------
# B: streaming masked L21 + in-block-column update (in place)
# --------------------------------------------------------------------------

def panel_apply_update_trim_plain(slab, pos, rowblock, uinv, j0, jj0,
                                  gemm_bf16=False):
    """Plain version of kernel 3 (:func:`panel_apply_update_trim` on an
    fp32 slab)."""
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
    """IN PLACE on the ``slab`` (m, bc): for every row at virtual position
    ``pos >= j0 + r`` compute L21 = A[:, jj0:jj0+r] U11^{-1}, write it into
    the panel columns, and subtract L21 @ U12 (``rowblock``'s columns right
    of the panel) from the columns right of the panel.  Other rows and the
    columns left of the panel are untouched.  Returns ``slab``.

    A bf16 slab (ALL_BF16) takes kernel 12's two passes, :func:`l21_trim`
    then :func:`upd_wide` (the update only where columns lie right of the
    panel), with bf16 operands, fp32 accumulation and one rounding to bf16
    per stored value.  An fp32 slab takes kernel 3 (bf16 update operands
    when ``gemm_bf16``); CPU tensors take its plain version."""
    if slab.dtype == torch.bfloat16:
        r = rowblock.shape[0]
        l21 = l21_trim(slab, pos, uinv, j0, jj0)
        if jj0 + r < slab.shape[1]:
            upd_wide(slab, l21, rowblock, jj0)
        return slab
    if not _lib.on_cuda(slab, pos, rowblock, uinv):
        return panel_apply_update_trim_plain(slab, pos, rowblock, uinv, j0, jj0,
                                             gemm_bf16)
    _row_major(slab, "panel_apply_update_trim: slab", (torch.float32,))
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
# Kernel 10: B over the full slab width, one streaming pass (in place)
# --------------------------------------------------------------------------

def panel_apply_update_plain(slab, pos, rowblock, uinv, j0, jj0, gemm_bf16=False):
    """Plain version of :func:`panel_apply_update` (the operations of
    `panel_fused._apply_update_kernel`: L21 rounded to the slab's dtype,
    the update's operands in bf16 for a bf16 slab or ``gemm_bf16``, fp32
    accumulation, one rounding after the subtract)."""
    _lib.counted_plain("panel_update_full")
    r = rowblock.shape[0]
    w = slab.dtype
    below = (pos >= j0 + r)[:, None]
    p = slab[:, jj0:jj0 + r]
    c0 = jj0 + r
    zero = torch.zeros((), dtype=w, device=slab.device)
    with ieee_fp32():
        l21 = torch.where(below, (p.float() @ uinv.float()).to(w), zero)
        if c0 < slab.shape[1]:
            bf16_ops = gemm_bf16 or w == torch.bfloat16
            op = (lambda t: t.to(torch.bfloat16).float()) if bf16_ops else (lambda t: t.float())
            upd = op(l21) @ op(rowblock[:, c0:])
            right = slab[:, c0:]
            slab[:, c0:] = torch.where(below, (right.float() - upd).to(w), right)
    slab[:, jj0:c0] = torch.where(below, l21, p)
    return slab


def panel_apply_update(slab, pos, rowblock, uinv, j0: int, jj0: int, gemm_bf16: bool = False):
    """IN PLACE on the fp32 or bf16 ``slab`` (m, bc), one streaming pass
    (`mpf_tpu/ops/panel_fused.py:panel_apply_update`): for every row at
    virtual position ``pos >= j0 + r`` compute L21 = A[:, jj0:jj0+r]
    U11^{-1} (fp32 sums, rounded to the slab's dtype), write it into the
    panel columns, and subtract L21 @ U12 (``rowblock``'s columns right of
    the panel) from the columns right of the panel, rounded once.  Columns
    left of the panel pass through exactly; other rows are untouched.  A
    bf16 slab takes bf16 operands (``uinv``, ``rowblock`` bf16), an fp32
    slab fp32 operands or, with ``gemm_bf16``, bf16 ones for the update.
    Kernels 3 and 12 compute the same function for the driver; this is the
    JAX package's untrimmed form, which no driver path calls.  Returns
    ``slab``.

    CPU tensors take the plain version; CUDA tensors launch kernel 10 (one
    launch)."""
    if not _lib.on_cuda(slab, pos, rowblock, uinv):
        return panel_apply_update_plain(slab, pos, rowblock, uinv, j0, jj0, gemm_bf16)
    _row_major(slab, "panel_apply_update: slab")
    m, bc = slab.shape
    r = rowblock.shape[0]
    _lib.check(rowblock.dtype == uinv.dtype == slab.dtype and rowblock.shape == (r, bc)
               and uinv.shape == (r, r) and r <= 128 and jj0 + r <= bc,
               "panel_apply_update: rowblock (r, bc) and uinv (r, r) of the slab's dtype, "
               "r <= 128, the panel inside the slab")
    pos = pos.to(torch.int32).contiguous()
    rowblock = rowblock.contiguous()
    uinv = uinv.contiguous()
    _lib.call("mpf_panel_update_full", m, bc, r, slab.data_ptr(), slab.stride(0), int(jj0),
              pos.data_ptr(), int(j0 + r), rowblock.data_ptr(), uinv.data_ptr(),
              int(slab.dtype == torch.bfloat16), int(bool(gemm_bf16)))
    _lib.counted_launch("panel_update_full")
    return slab


# --------------------------------------------------------------------------
# Kernel 12: B for bf16 slabs, an L21 pass and an update pass (in place)
# --------------------------------------------------------------------------

def l21_trim_plain(slab, pos, uinv, j0, jj0):
    """Plain version of :func:`l21_trim`."""
    _lib.counted_plain("l21_trim")
    r = uinv.shape[0]
    below = (pos >= j0 + r)[:, None]
    p = slab[:, jj0:jj0 + r]
    with ieee_fp32():
        l21 = (p.float() @ uinv.float()).to(slab.dtype)
    l21 = torch.where(below, l21, torch.zeros((), dtype=slab.dtype, device=slab.device))
    slab[:, jj0:jj0 + r] = torch.where(below, l21, p)
    return l21


def l21_trim(slab, pos, uinv, j0: int, jj0: int):
    """The L21 pass of kernel 12, IN PLACE on the bf16 ``slab`` (m, bc):
    L21 = bf16(A[:, jj0:jj0+r] @ ``uinv``) with fp32 accumulation, written
    into the panel columns of the rows at position ``pos >= j0 + r`` (other
    rows keep their values).  Returns the row-masked L21, (m, r) bf16 with
    zeros on the other rows, for :func:`upd_wide`.

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    the returned L21 is then a view whose rows are padded to a multiple of 8
    elements, so that the update pass's TMA loads read it in place."""
    if not _lib.on_cuda(slab, pos, uinv):
        return l21_trim_plain(slab, pos, uinv, j0, jj0)
    _row_major(slab, "l21_trim: slab", (torch.bfloat16,))
    m, r = slab.shape[0], uinv.shape[0]
    _lib.check(uinv.dtype == torch.bfloat16 and uinv.shape == (r, r) and r <= 128,
               "l21_trim: uinv must be (r, r) bf16, r <= 128")
    _lib.check(jj0 + r <= slab.shape[1], "l21_trim: panel outside the slab")
    pos = pos.to(torch.int32).contiguous()
    uinv = uinv.contiguous()
    buf = torch.empty((m, -(-r // 8) * 8), dtype=torch.bfloat16, device=slab.device)
    _lib.call("mpf_l21_trim", m, r, slab.data_ptr(), slab.stride(0), int(jj0),
              pos.data_ptr(), int(j0 + r), uinv.data_ptr(), buf.data_ptr(), buf.stride(0))
    _lib.counted_launch("l21_trim")
    return buf[:, :r]


def upd_wide_plain(slab, l21, rowblock, jj0):
    """Plain version of :func:`upd_wide`."""
    _lib.counted_plain("upd_wide")
    c0 = jj0 + l21.shape[1]
    with ieee_fp32():
        upd = l21.float() @ rowblock[:, c0:].float()
    slab[:, c0:] = (slab[:, c0:].float() - upd).to(slab.dtype)
    return slab


def upd_wide(slab, l21, rowblock, jj0: int, smem_c: bool = True):
    """The update pass of kernel 12, IN PLACE on the bf16 ``slab`` (m, bc):
    A[:, c0:] = bf16(fp32(A[:, c0:]) - l21 @ rowblock[:, c0:]) with
    c0 = jj0 + r, bf16 operands and fp32 accumulation.  No row mask: the
    rows :func:`l21_trim` left alone carry L21 = 0 and are stored back
    unchanged.  Returns ``slab``.

    CPU tensors take the plain version; CUDA tensors launch kernel 6's
    Hopper routine as its own kernel (``trailing_kernel<bf16, true>``), with
    C through shared memory when ``smem_c`` (and C's base and row stride
    allow it), else with the register epilogue.  An operand that TMA cannot
    read in place is copied first (:func:`_lib.gemm_operand`, counted)."""
    if not _lib.on_cuda(slab, l21, rowblock):
        return upd_wide_plain(slab, l21, rowblock, jj0)
    _row_major(slab, "upd_wide: slab", (torch.bfloat16,))
    m, bc = slab.shape
    r = l21.shape[1]
    c0 = jj0 + r
    _lib.check(l21.dtype == rowblock.dtype == torch.bfloat16 and l21.stride(1) == 1
               and l21.shape[0] == m and rowblock.shape == (r, bc)
               and rowblock.stride(1) == 1, "upd_wide: l21 (m, r) / rowblock (r, bc) bf16")
    l21, u12 = _lib.gemm_operand(l21), _lib.gemm_operand(rowblock[:, c0:])
    c = slab[:, c0:]
    _lib.call("mpf_upd_wide", m, bc - c0, r, l21.data_ptr(), l21.stride(0), u12.data_ptr(),
              u12.stride(0), c.data_ptr(), slab.stride(0), int(bool(smem_c)))
    _lib.counted_launch("upd_wide")
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


def trailing_staged(c) -> bool:
    """Whether kernel 6 carries C = ``c`` (a view of a row-major matrix)
    through shared memory: bf16 C at a 16-byte base with a row stride and a
    width that are multiples of 16 bytes (:func:`_lib.tma_ready` and the
    width; the C side's ``c_tma_ok``), which TMA reads and writes in place
    (its stores write whole 16-byte pieces of a row).  Every ALL_BF16
    trailing block at n a multiple of 8 qualifies.  Any other C keeps the
    register epilogue: other bf16 C, and fp32 C, whose 128 x 256 tile (128
    KB) fits beside no ring."""
    return c.dtype == torch.bfloat16 and _lib.tma_ready(c) and c.shape[1] % 8 == 0


def _trailing_launch(c, l21, u12, inst: str) -> None:
    """One launch of kernel 6 on the view ``c`` (m, w) of a row-major matrix:
    ``inst`` is ``ffma`` (fp32 operands and C), ``registers`` (bf16
    operands, C in registers) or ``staged`` (bf16 operands, bf16 C through
    shared memory, which needs :func:`trailing_staged`).  Counted in ``_lib.launches["trailing_sub"]``
    and, by instance, in ``_lib.trailing_instances``."""
    m, kk = l21.shape
    mode = 2 if inst == "ffma" else 0
    # mpf_trailing_sub's c_mode: 0 fp32 C, 1 bf16 C in registers, 2 staged
    c_mode = 0 if c.dtype == torch.float32 else 2 if inst == "staged" else 1
    l21, u12 = _lib.gemm_operand(l21), _lib.gemm_operand(u12)
    _lib.call("mpf_trailing_sub", mode, m, c.shape[1], kk, l21.data_ptr(), l21.stride(0),
              u12.data_ptr(), u12.stride(0), c.data_ptr(), c_mode, c.stride(0))
    _lib.counted_launch("trailing_sub")
    _lib.trailing_instances[inst] += 1


def trailing_gemm_sub(a, l21, u12, ko: int, ncols: int | None = None):
    """IN PLACE on the matrix ``a``: a[ko:ko+m, ko:ko+ncols] -= l21 @ u12
    with fp32 accumulation (m = l21 rows; ``ncols`` defaults to m).  For an
    fp32 ``a``, ``l21``/``u12`` are both bf16 (tensor cores) or both fp32
    (IEEE FFMA); a bf16 ``a`` (ALL_BF16) takes bf16 operands and each entry
    is rounded to bf16 once after the fp32 subtract.  Returns ``a``.

    CPU tensors take the plain version; CUDA tensors launch kernel 6 (bf16
    operands that TMA cannot read in place are copied first,
    :func:`_lib.gemm_operand`): fp32 operands on the FFMA routine, bf16
    operands on the Hopper routine, with C through shared memory where
    :func:`trailing_staged` says so and in registers otherwise (the two
    bitwise equal)."""
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
    _lib.check(a.dtype != torch.bfloat16 or l21.dtype == torch.bfloat16,
               "trailing_gemm_sub: a bf16 matrix takes bf16 l21/u12")
    c = a[ko:ko + m, ko:ko + ncols]
    if l21.dtype == torch.float32:
        inst = "ffma"
    else:
        inst = "staged" if trailing_staged(c) else "registers"
    _trailing_launch(c, l21, u12, inst)
    return a


# --------------------------------------------------------------------------
# Kernel 11: row gather and in-place row scatter
# --------------------------------------------------------------------------

def _rows_matrix(a, name: str) -> None:
    _lib.check(a.dim() == 2 and a.stride(1) == 1 and a.dtype in (torch.float32, torch.bfloat16),
               f"{name}: a must be a row-major fp32 or bf16 matrix, got {a.dtype}")


def rows_gather_plain(a, rows):
    """Plain version of :func:`rows_gather`."""
    _lib.counted_plain("rows_gather")
    return a[rows.long()]


def rows_gather(a, rows):
    """Copy of the rows ``rows`` (any order, repeats allowed) of the fp32
    or bf16 matrix ``a``: (len(rows), w).  The TPU kernel's multiple-of-8
    row count is not needed.  CPU tensors take the plain version; CUDA
    tensors launch kernel 11's gather."""
    if not _lib.on_cuda(a, rows):
        return rows_gather_plain(a, rows)
    _rows_matrix(a, "rows_gather")
    rows = rows.to(torch.int32).contiguous()
    nr, w = rows.shape[0], a.shape[1]
    out = torch.empty((nr, w), dtype=a.dtype, device=a.device)
    _lib.call("mpf_rows_gather", nr, w, a.data_ptr(), a.stride(0), rows.data_ptr(),
              out.data_ptr(), a.element_size())
    _lib.counted_launch("rows_gather")
    return out


def rows_scatter_inplace_plain(a, dests, vals, self_src=None, active=None):
    """Plain version of :func:`rows_scatter_inplace`."""
    _lib.counted_plain("rows_scatter")
    keep = torch.ones(dests.shape, dtype=torch.bool, device=dests.device)
    if active is not None:
        keep &= active.bool()
    if self_src is not None:
        keep &= dests.long() != self_src.long()
    a[dests.long()[keep]] = vals[keep]
    return a


def rows_scatter_inplace(a, dests, vals, self_src=None, active=None):
    """IN PLACE: ``a[dests[i], :] = vals[i, :]`` for every row i that is
    active (``active[i]`` true; all rows when ``active`` is None) and not a
    self-move (``dests[i] == self_src[i]``, where ``self_src`` gives each
    value's current row; such rows already hold their value).  Among the
    rows written, ``dests`` must be unique or repeat only with bitwise
    identical ``vals``; ``vals`` must not overlap the rows written.
    Returns ``a``.  CPU tensors take the plain version; CUDA tensors launch
    kernel 11's scatter."""
    opt = tuple(t for t in (self_src, active) if t is not None)
    if not _lib.on_cuda(a, dests, vals, *opt):
        return rows_scatter_inplace_plain(a, dests, vals, self_src, active)
    _rows_matrix(a, "rows_scatter_inplace")
    nr, w = dests.shape[0], a.shape[1]
    _lib.check(vals.dtype == a.dtype and vals.dim() == 2 and vals.shape == (nr, w)
               and vals.stride(1) == 1, "rows_scatter_inplace: vals must be (nr, w) row-major, "
               "of a's dtype")
    dests = dests.to(torch.int32).contiguous()
    ss = None if self_src is None else self_src.to(torch.int32).contiguous()
    act = None if active is None else active.to(torch.int32).contiguous()
    _lib.call("mpf_rows_scatter", nr, w, a.data_ptr(), a.stride(0), dests.data_ptr(),
              vals.data_ptr(), vals.stride(0), None if ss is None else ss.data_ptr(),
              None if act is None else act.data_ptr(), -1, a.element_size())
    _lib.counted_launch("rows_scatter")
    return a


def rows_scatter_from_band_plain(a, k, dests):
    """Plain version of :func:`rows_scatter_from_band`."""
    _lib.counted_plain("rows_scatter")
    scatter_band(a, k, dests)
    return a


def rows_scatter_from_band(a, k: int, dests):
    """IN PLACE: ``a[dests[i], :] = a[k + i, :]`` for every ``dests[i]``
    outside the band ``[k, k + nr)``.  In-band destinations (self-moves
    among them) are left to the caller's band write, as in the exchange
    contract of :func:`mpf_tpu_torch.ops.exchange.rows_exchange`.  Returns
    ``a``.  CPU tensors take the plain version; CUDA tensors launch kernel
    11's scatter reading the band rows in place."""
    if not _lib.on_cuda(a, dests):
        return rows_scatter_from_band_plain(a, k, dests)
    _rows_matrix(a, "rows_scatter_from_band")
    nr, w = dests.shape[0], a.shape[1]
    _lib.check(0 <= k and k + nr <= a.shape[0], "rows_scatter_from_band: band outside a")
    dests = dests.to(torch.int32).contiguous()
    _lib.call("mpf_rows_scatter", nr, w, a.data_ptr(), a.stride(0), dests.data_ptr(),
              None, 0, None, None, int(k), a.element_size())
    _lib.counted_launch("rows_scatter")
    return a
