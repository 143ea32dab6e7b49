"""Trailing GEMM with the next block column's row exchange in one launch
(port of `mpf_tpu/ops/gemmx.py:gemm_trailing`; kernel 13,
``csrc/gemmx.cu``).

:func:`gemm_trailing` computes, in place on the working matrix,
``a[r0:r0+m, c0:c0+w] -= l21 @ u12`` with fp32 accumulation, and, given
``xargs = (k, glist, dests)``, then the combined row exchange
(:func:`mpf_tpu_torch.ops.exchange.rows_exchange`) on the updated matrix.
The lookahead driver runs the next block column's exchange this way, inside
the wide trailing update of the current one.

The TPU kernel threads the exchange's window DMAs between its GEMM tiles,
each gated on the completion of the row strip it touches; its schedules
(`build_exchange_schedules`, window rings, the pair-major strip order, the
gate margin) have no counterpart here.  The CUDA kernel runs the GEMM tiles
with kernel 6's device routine (the Hopper TMA + wgmma routine for bf16
operands, FFMA tiles for fp32), then, after grid barriers, the gather and
the scatter.
"""

from __future__ import annotations

import torch

from mpf_tpu_torch.ops import _lib
from mpf_tpu_torch.ops.blas3 import ieee_fp32
from mpf_tpu_torch.ops.exchange import scatter_band


def gemm_trailing_plain(a, l21, u12, r0: int, c0: int, xargs=None):
    """Plain version of :func:`gemm_trailing` (same in-place contract)."""
    _lib.counted_plain("gemmx")
    m, w = l21.shape[0], u12.shape[1]
    with ieee_fp32():
        prod = l21.float() @ u12.float()
    reg = a[r0:r0 + m, c0:c0 + w]
    a[r0:r0 + m, c0:c0 + w] = (reg.float() - prod).to(a.dtype)
    if xargs is None:
        return a
    k, glist, dests = xargs
    pivrows = a[glist.long()]                 # gathered copy (all reads first)
    scatter_band(a, k, dests)
    return a, pivrows


def gemm_trailing(a, l21, u12, r0: int, c0: int, xargs=None):
    """IN PLACE on the contiguous fp32 or bf16 matrix ``a`` (n rows of
    width w_a): ``a[r0:r0+m, c0:c0+w] -= l21 @ u12`` (m = l21 rows, w =
    u12 columns) with fp32 accumulation.  Operands as for kernel 6: for an
    fp32 ``a`` both bf16 (tensor cores) or both fp32 (IEEE FFMA); a bf16
    ``a`` takes bf16 operands, each entry rounded to bf16 once after the
    fp32 subtract.

    Without ``xargs`` returns ``a``.  With ``xargs = (k, glist, dests)``
    returns ``(a, pivrows)``: ``pivrows[j]`` is row ``glist[j]`` of the
    UPDATED matrix over its full width, and every band row ``a[k + i]``
    has been copied to ``dests[i]`` where that lies outside the band
    ``[k, k + nr)``; the caller writes ``pivrows`` over the band.

    CPU tensors take the plain version; CUDA tensors launch kernel 13 (one
    cooperative launch; bf16 operands that TMA cannot read in place are
    copied first, :func:`_lib.gemm_operand`)."""
    idx = () if xargs is None else tuple(xargs[1:])
    if not _lib.on_cuda(a, l21, u12, *idx):
        return gemm_trailing_plain(a, l21, u12, r0, c0, xargs)
    _lib.check(a.dtype in (torch.float32, torch.bfloat16) and a.dim() == 2
               and a.is_contiguous(), "gemm_trailing: a must be a contiguous fp32 or bf16 matrix")
    m, kk = l21.shape
    _lib.check(u12.dim() == 2 and u12.shape[0] == kk,
               f"gemm_trailing: u12 shape {tuple(u12.shape)} does not match l21 {(m, kk)}")
    w = u12.shape[1]
    _lib.check(l21.dtype == u12.dtype and l21.dtype in (torch.bfloat16, torch.float32),
               "gemm_trailing: l21/u12 must both be bf16 or both fp32")
    _lib.check(l21.stride(1) == 1 and u12.stride(1) == 1,
               "gemm_trailing: l21/u12 must be row-major")
    _lib.check(0 <= r0 and r0 + m <= a.shape[0] and 0 <= c0 and c0 + w <= a.shape[1],
               "gemm_trailing: update region outside a")
    c_bf16 = a.dtype == torch.bfloat16
    _lib.check(not c_bf16 or l21.dtype == torch.bfloat16,
               "gemm_trailing: a bf16 matrix takes bf16 l21/u12")
    mode = 0 if l21.dtype == torch.bfloat16 else 2
    l21, u12 = _lib.gemm_operand(l21), _lib.gemm_operand(u12)
    if xargs is None:
        nr, k, gp, dp, pp, pivrows = 0, 0, None, None, None, None
    else:
        k, glist, dests = xargs
        glist = glist.to(torch.int32).contiguous()
        dests = dests.to(torch.int32).contiguous()
        nr = glist.shape[0]
        _lib.check(dests.shape[0] == nr and 0 <= k and k + nr <= a.shape[0],
                   "gemm_trailing: glist/dests must both name nr rows of a band inside a")
        pivrows = torch.empty((nr, a.shape[1]), dtype=a.dtype, device=a.device)
        gp, dp, pp = glist.data_ptr(), dests.data_ptr(), pivrows.data_ptr()
    _lib.call("mpf_gemmx", mode, m, w, kk, l21.data_ptr(), l21.stride(0), u12.data_ptr(),
              u12.stride(0), a.data_ptr(), int(c_bf16), a.stride(0), int(r0), int(c0),
              a.shape[1], nr, int(k), gp, dp, pp)
    _lib.counted_launch("gemmx")
    return a if xargs is None else (a, pivrows)
