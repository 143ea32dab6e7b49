"""MPF: blocked right-looking mixed-precision pre-pivoting LU, single device.

Port of the classic block-column loop of `mpf_tpu/models/mpf.py`
(`mpf_factorize_traced`).  Each block column of width ``block`` takes one
of two paths, chosen as the JAX package chooses (`mpf.py:1115`):

* **fused** — when ``pivot`` is set, no ``panel_kernel`` is given, the
  policy's panel cast does not saturate and :func:`_fused_ok` holds.  Per
  r-wide panel, on a window of rows that can still pivot:
  A1 :func:`strip_panel_pivots` (pivots, rows never move),
  A2 :func:`rowblock_assemble` (pivot rows, diagonal LU, U12 in the block
  column), B :func:`panel_apply_update_trim` (L21 and the update of the
  block column's later columns: kernel 3 on fp32 slabs, kernel 12 on bf16
  ones); then one physical row exchange (:func:`rows_exchange`) for the
  whole block column.
* **masked** (`_factor_block_column` / `_inner_panel_step`): the
  reference's own algorithm (`MPF.cu:100-240`).  Per panel: the
  low-precision pre-pivoting LU of the full-height panel, factors discarded
  (:func:`hgetf2_panel_swaps`, or the caller's ``panel_kernel``); one
  bounded row exchange of the slab (:func:`laswp_apply`); the no-pivot LU
  of the diagonal block with its inverses (:func:`getf2_npv_inv_block` for
  fp32 storage; for bf16 storage :func:`getf2_npv`, :func:`unit_lower_inv`
  and :func:`upper_inv` as PyTorch ops, as the JAX package takes XLA ops
  there, `mpf.py:75-90`); L21 = A21 U11^{-1}, U12 = L11^{-1} A12 and the
  update inside the block column as IEEE-fp32 ``torch.matmul`` products of
  upcast operands on the active sub-blocks, each result rounded once to the
  working dtype (the JAX package's full-height masked XLA dots compute the
  same function).  Then the rows outside the block column are exchanged
  with the block column's composed row map (:func:`laswp_apply`).

The fused path's row exchange is kernel 4 (:func:`rows_exchange`),
followed by the band write.

Both paths end in the trailing update (`_trailing_update`): U12 =
L11^{-1} A12 through :func:`unit_lower_inv_blocked` and an IEEE-fp32
``torch.matmul`` of upcast operands, rounded once to the working dtype,
then :func:`trailing_gemm_sub` with the policy's ``gemm_in`` operands.

The driver reads no environment: the loop above runs unless an explicit
argument or the input's shape asks for one of three variants of it, as
in the JAX package.  No benchmark cell runs them and none has beaten the
loop above on the card; they stay until each has replacement tests of
its own:

* **lookahead** (``lookahead=True``, `_lookahead_factorize`): each
  trailing update is split at the next block column's right edge; the
  next panel is factored after the narrow part, and its row exchange runs
  inside the wide part's GEMM (kernel 13, :func:`gemm_trailing`).  The
  same arithmetic in another order, on one stream.  Its gate is the JAX
  package's (`mpf.py:1059-1081`: pivoting, n >= 2 block, every block
  column fused) without the TPU tile alignment (n and block multiples of
  1024), which kernel 13 does not need.

* **deferred exchange** (``defer=S``, `_deferred_factorize`): block
  columns run in groups of S; a displaced band row whose destination lies
  beyond the group goes to an overflow strip of S block rows below the
  matrix (kernel 14's band copy, :func:`copy_rows_block`) and home once per
  group (kernel 14's flush, :func:`flush_overflow`).  Kernel 1 sees each
  overflow row at its destination and the stale copies as dead rows, so
  pivots, row map and factors are the classic loop's.  Gate and entry:
  :func:`_resolve_defer`; a pre-extended ``(n + S·block, n)`` input is
  factored in place.

* **pair layout** (an ``(n/2, 2, n)`` input, row i at ``a[i // 2, i %
  2]``, `_factorize_3d`): the classic fused loop on the 3D tensor, which
  the JAX package keeps natively 3D for the TPU's DMA granule.  Per block
  column the slab is copied out (kernel 15a) and back (15b) around the
  panel kernels, kernel 4 exchanges rows on the (n, n) view and kernel 15c
  writes the pivot rows over the band; U12 is computed in place by kernel
  15d, not by cuBLAS, and kernel 6 runs the trailing GEMM on the view.
  Its gate is the JAX package's (`mpf.py:984-1014`, :func:`_pairs_ok`).

Working storage is fp32, or bf16 under ``ALL_BF16``: every stored value is
then rounded to bf16 where the JAX package rounds it, and no product goes
to a bf16 cuBLAS call.

Everything stays on the input's device and no step reads a value back to
the host.  The matrix is factored in place (in a working copy for
:func:`mpf_factorize`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from mpf_tpu_torch.precision import PrecisionPolicy, MPF_BF16, cast_to_panel
from mpf_tpu_torch.ops import _lib
from mpf_tpu_torch.ops.blas3 import (
    matmul_in,
    unit_lower_inv,
    unit_lower_inv_blocked,
    upper_inv,
)
from mpf_tpu_torch.ops.exchange import (
    copy_rows_block,
    flush_overflow,
    rows_exchange,
    rows_exchange3,
)
from mpf_tpu_torch.ops.gemmx import gemm_trailing
from mpf_tpu_torch.ops.getf2 import getf2_npv
from mpf_tpu_torch.ops.panel_fused import (
    panel_apply_update_trim,
    rowblock_assemble,
    trailing_gemm_sub,
)
from mpf_tpu_torch.ops.panel_pallas import (
    getf2_npv_inv_block,
    hgetf2_panel_swaps,
    laswp_apply,
)
from mpf_tpu_torch.ops.pair3d import (
    band_write_rows,
    slab_extract,
    slab_writeback,
    trailing_sub3,
    u12_transform,
)
from mpf_tpu_torch.ops.panel_strip import SENT, strip_panel_pivots


#: The deferred exchange's group size for ``defer=True``: the JAX
#: package's default.
DEFER_S = 8


def _options(lookahead, defer, pivot: bool, super_block="auto") -> tuple[bool, int]:
    """The variant arguments, resolved once: whether lookahead is asked
    for, and the deferred exchange's requested group size S before its
    shape checks (0: off).  ``lookahead``: None or False is off.
    ``defer``: None, False or 0 is off, True is :data:`DEFER_S`, an int is
    S; ``pivot=False`` is off.  The port has no superblock driver:
    ``super_block`` takes the JAX package's default ``"auto"`` or None,
    and a width is refused."""
    if super_block not in ("auto", None):
        raise ValueError(f"super_block={super_block!r}: superblocks are not supported; "
                         "pass 'auto' or None")
    if not defer or not pivot:
        s = 0
    elif defer is True:
        s = DEFER_S
    else:
        s = int(defer)
    return bool(lookahead), max(s, 0)


class MPFResult(NamedTuple):
    """Factorization result (LAPACK getrf conventions).

    ``lu``   — (n, n) packed factors in working precision: strictly-lower =
               L (unit diagonal implicit), upper = U; (n/2, 2, n) with row
               i at ``lu[i // 2, i % 2]`` for a pair-layout input
    ``ipiv`` — (n,) int32, 1-based global pivot rows
    ``info`` — int32 scalar tensor, 1-based column of the first zero
               pivot, 0 if clean
    ``perm`` — (n,) int32 composed row map: ``lu`` factors ``a[perm]``
    """

    lu: torch.Tensor
    ipiv: torch.Tensor
    info: torch.Tensor
    perm: torch.Tensor | None = None


#: Row window quantum.  Rows above the current block column are frozen by
#: position, so the window height does not change the result (a CPU test
#: holds two quanta bit-identical); the TPU driver rounded windows up to
#: 4096 rows only to bound its compiled-kernel count, which the CUDA kernels
#: do not have.  1 = the tightest window (rows k..n).
_WINDOW_QUANTUM = 1


def _check_policy(policy: PrecisionPolicy) -> None:
    """The kernels take fp32 or bf16 working storage, which covers every
    policy of ``precision.POLICIES``."""
    if policy.working not in (torch.float32, torch.bfloat16):
        raise ValueError(f"policy {policy.name}: working storage must be fp32 or bf16, "
                         f"got {policy.working}")


def _fused_ok(bc: int, r: int) -> bool:
    """The fused path needs whole 8-column strips (kernel 1) and whole
    panels per block column; r is also capped by the one-block diagonal
    refactor (kernel 2 keeps three r x r fp32 blocks in shared memory)."""
    return r >= 8 and r % 8 == 0 and r <= 128 and bc % r == 0


def _takes_fused(bc: int, r: int, policy, pivot: bool, panel_kernel) -> bool:
    """Routing of one block column (`mpf.py:1115`): the fused path needs
    pivoting, the default panel kernel and a non-saturating panel cast
    (the saturating fp16 cast runs before kernel 7, as the JAX package
    keeps it outside its fused kernels); everything else is masked."""
    return (pivot and panel_kernel is None and not policy.saturate_panel
            and _fused_ok(bc, r))


def _auto_block(n: int, r: int, policy, block: int | None) -> int:
    """Block-column width: 1024, or 2048 for fp32 working storage at
    n >= 32768 — the JAX package's rule, kept until the card's own block
    sweep replaces it."""
    if block is None:
        wide = n >= 32768 and policy.working == torch.float32
        block = max(r, min(n, 2048 if wide else 1024))
    return max(block, r)


def _pad_target(n: int, r: int, block: int = 0, policy=MPF_BF16, pivot: bool = True,
                panel_kernel=None) -> int:
    """Identity-extension size that keeps a non-aligned n on the fused
    path, or 0: the next multiple of r, when every block column of the
    padded matrix takes the fused path (the masked path handles any n
    itself).  Pad rows are zero in the first n columns, so they are never
    chosen as pivots (except in an exactly-zero column, where ``info``
    fires anyway), and pad columns have U12 = 0."""
    if n % r == 0:
        return 0
    n_pad = -(-n // r) * r
    block = block or n_pad
    if not all(_takes_fused(min(block, n_pad - k), r, policy, pivot, panel_kernel)
               for k in range(0, n_pad, block)):
        return 0
    return n_pad


def _window(n: int, k: int) -> int:
    """Height m of the row window [n - m, n) for block column k."""
    q = _WINDOW_QUANTUM
    return min(n, -((k - n) // q) * q)


def _factor_block_column_fused(slab, diag0: int, r: int, policy, pos0=None,
                               pos_bound: int | None = None):
    """Virtual-pivoting factorization of the (m, bc) slab view in place
    (rows are a tail window of the matrix; ``diag0`` = slab row of the block
    column's first diagonal).  Returns ``(pos, olog, piv, u_all, info)``:
    final positions (m,), the slab row landing at each diagonal position
    (bc,), local pivot positions (bc,), the finished (bc, bc) pivot-row
    values, and the block-local 1-based first zero pivot.

    ``pos0`` (deferred exchange) replaces the identity position map: live
    rows carry their slab-local virtual positions (an overflow row its
    destination's), dead rows ``SENT``; ``pos_bound`` is the exclusive
    bound of the live positions, which gates kernel 1's quant16 search."""
    m, bc = slab.shape
    dev = slab.device
    gemm_bf16 = policy.gemm_in == torch.bfloat16 and policy.working != torch.bfloat16
    pos = torch.arange(m, dtype=torch.int32, device=dev) if pos0 is None else pos0
    info = torch.zeros((), dtype=torch.int32, device=dev)
    pivs, ologs, rowblocks = [], [], []
    for t in range(bc // r):
        _lib.panels["fused"] += 1
        jj0 = t * r
        j0 = diag0 + jj0
        piv, pos, glist = strip_panel_pivots(slab, j0, pos, panel_dtype=policy.panel,
                                             jj0=jj0, r=r, pos_bound=pos_bound)
        rowblock, uinv, info_k = rowblock_assemble(slab, glist, jj0)
        info = torch.where((info == 0) & (info_k > 0), info_k + jj0, info)
        with _lib.span("mpf.update"):
            panel_apply_update_trim(slab, pos, rowblock, uinv, j0, jj0, gemm_bf16=gemm_bf16)
        pivs.append(piv)
        ologs.append(glist)
        rowblocks.append(rowblock)
    return pos, torch.cat(ologs), torch.cat(pivs), torch.cat(rowblocks), info


def _fused_panel_stage(a, k: int, bc: int, r: int, policy, ipiv, info, ov: int = 0,
                       posg=None, pairs: bool = False):
    """Panel work (A1 + A2 + B) for block column ``k`` on its row window,
    in place on ``a``, as the ``mpf.panel`` stage; updates ``ipiv``/``info``
    in place and returns ``(info, stage)`` with ``stage = (k0, band_idx,
    glist, dests, u_all)``.  Deferred exchange: ``a`` is the (n + ov, n)
    extended matrix, the slab runs down through the overflow strip (height
    m + ov) and ``posg`` is the matrix's row-to-position map, from which
    the slab-local one is taken.  ``pairs``: ``a`` is the (n, n) view of
    the pair-layout matrix, and the slab is copied out (kernel 15a) and
    back (15b) around the panel work, as `_factorize_3d` does
    (`mpf.py:624-629`)."""
    _lib.block_columns["fused"] += 1
    with _lib.span("mpf.panel"):
        n = a.shape[1]
        m = _window(n, k)
        k0 = n - m  # rows above k0 can neither pivot nor update
        pos0 = None
        if posg is not None:
            posl = posg[k0:n + ov]
            pos0 = torch.where(posl == SENT, posl, posl - k0)
        a3 = a.view(n // 2, 2, n) if pairs else None
        sub = slab_extract(a3, k0, k, m, bc) if pairs else a[k0:, k:k + bc]
        pos_l, olog_l, piv_l, u_all, info_b = _factor_block_column_fused(
            sub, k - k0, r, policy, pos0=pos0, pos_bound=m if ov else None)
        if pairs:
            slab_writeback(a3, sub, k0, k)
        ipiv[k:k + bc] = k0 + piv_l + 1
        info = torch.where((info == 0) & (info_b > 0), info_b + k, info)
        band_idx = (k - k0) + torch.arange(bc, device=a.device)
        dests = k0 + pos_l[band_idx]       # band rows' new positions
        glist = k0 + olog_l                # pivot-row sources
    return info, (k0, band_idx, glist, dests, u_all)


def _compose_perm(perm_total, k: int, bc: int, stage, vglist=None):
    """Compose one block column's row map into the running total — only
    the band and the displaced destinations change.  ``vglist`` (deferred
    exchange): the pivot rows' virtual positions, since ``glist`` is
    physical and may point into the overflow strip while ``perm_total`` is
    indexed by position."""
    k0, band_idx, glist, dests = stage[:4]
    pt_old = perm_total.clone()
    perm_total[k:k + bc] = pt_old[(glist if vglist is None else vglist).long()]
    perm_total[dests.long()] = pt_old[(k0 + band_idx).long()]
    return perm_total


def _inner_panel_step(slab, perm, piv_all, info, kk: int, jj0: int, rp: int, policy,
                      pivot: bool, panel_kernel):
    """One rp-wide panel of the masked path, IN PLACE on the full-height
    (n, bc) block-column ``slab`` (a view of the matrix; the panel's
    diagonal is at slab row / column ``kk + jj0`` / ``jj0``).  Returns
    ``(perm, info)``: the block column's composed row map and the first
    zero pivot (global, 1-based); ``piv_all`` gets the panel's global
    0-based pivots in place.  Four stages: ``mpf.prepivot`` (the panel
    cast and kernel 7), ``mpf.swap`` (the slab's LASWP), ``mpf.npv`` (the
    diagonal block's no-pivot LU) and ``mpf.update`` (L21, the U12 inside
    the block column and their update)."""
    _lib.panels["masked"] += 1
    n, bc = slab.shape
    dev = slab.device
    j0 = kk + jj0
    if pivot:
        with _lib.span("mpf.prepivot"):
            panel = slab[:, jj0:jj0 + rp]
            if panel_kernel is None:
                if policy.saturate_panel:
                    panel = cast_to_panel(panel, policy).contiguous()
                piv, _, perm, src = hgetf2_panel_swaps(panel, j0, perm,
                                                       panel_dtype=policy.panel)
            else:
                piv, pperm, perm = panel_kernel(cast_to_panel(panel, policy), row_offset=j0,
                                                prev_perm=perm)
                src = None
            # LASWP over the slab: the <= 2 rp rows that can move
            cand = torch.cat([j0 + torch.arange(rp, dtype=torch.int32, device=dev),
                              piv.to(torch.int32)])
            if src is None:
                src = pperm[cand.long()]
        with _lib.span("mpf.swap"):
            laswp_apply(slab, cand, src)
            piv_all[jj0:jj0 + rp] = piv
    # no-pivot LU of the diagonal block, with its inverses: kernel 8 for
    # fp32 storage, PyTorch ops for bf16 (the JAX package's XLA ops)
    with _lib.span("mpf.npv"):
        diag = slab[j0:j0 + rp, jj0:jj0 + rp]
        if slab.dtype == torch.float32:
            lu, linv, uinv, info_k = getf2_npv_inv_block(diag)
        else:
            lu, info_k = getf2_npv(diag)
            linv, uinv = unit_lower_inv(lu), upper_inv(lu)
        info = torch.where((info == 0) & (info_k > 0), info_k + j0, info)
        slab[j0:j0 + rp, jj0:jj0 + rp] = lu
    e, ce = j0 + rp, jj0 + rp
    w = slab.dtype
    with _lib.span("mpf.update"):
        l21 = matmul_in(slab[e:, jj0:ce], uinv, w).to(w)        # L21 = A21 U11^{-1}
        slab[e:, jj0:ce] = l21
        if ce < bc:
            u12 = matmul_in(linv, slab[j0:e, ce:], w).to(w)     # U12 = L11^{-1} A12
            slab[j0:e, ce:] = u12
            # in place, computed in fp32 and rounded once to the working dtype
            slab[e:, ce:] -= matmul_in(l21, u12, policy.gemm_in)
    return perm, info


def _factor_block_column(slab, kk: int, r: int, policy, pivot: bool, panel_kernel):
    """Masked factorization of the (n, bc) block-column view ``slab``
    (diagonal at global row ``kk``), in place.  Returns ``(perm, piv,
    info)``: the composed row map (n,), the global 0-based pivot rows (bc,)
    and the global first zero pivot."""
    n, bc = slab.shape
    dev = slab.device
    perm = torch.arange(n, dtype=torch.int32, device=dev)
    piv_all = kk + torch.arange(bc, dtype=torch.int32, device=dev)
    info = torch.zeros((), dtype=torch.int32, device=dev)
    nfull, tail = divmod(bc, r)
    for t in range(nfull):
        perm, info = _inner_panel_step(slab, perm, piv_all, info, kk, t * r, r, policy,
                                       pivot, panel_kernel)
    # a 1 x 1 tail panel needs no work (`MPF.cu:104`): its pivot stays
    if tail and n - (kk + nfull * r) > 1:
        perm, info = _inner_panel_step(slab, perm, piv_all, info, kk, nfull * r, tail,
                                       policy, pivot, panel_kernel)
    return perm, piv_all, info


def _masked_block_column(a, k: int, bc: int, r: int, policy, pivot: bool, panel_kernel,
                         ipiv, info, perm_total):
    """The masked path for block column ``k``, in place on ``a``: the
    ``mpf.panel`` stage, then, when pivoting, the ``mpf.exchange`` stage;
    updates ``ipiv`` in place and returns ``(info, perm_total)``."""
    _lib.block_columns["masked"] += 1
    n = a.shape[0]
    with _lib.span("mpf.panel"):
        slab = a[:, k:k + bc]
        perm, piv_b, info_b = _factor_block_column(slab, k, r, policy, pivot, panel_kernel)
        ipiv[k:k + bc] = piv_b + 1
        info = torch.where((info == 0) & (info_b > 0), info_b, info)
    if pivot:
        with _lib.span("mpf.exchange"):
            perm_total = perm_total[perm.long()]
            # LASWP of the columns outside the block column (its own rows were
            # exchanged panel by panel): the <= 2 bc rows that can move
            cand = torch.cat([k + torch.arange(bc, dtype=torch.int32, device=a.device),
                              piv_b])
            src = perm[cand.long()]
            if k > 0:
                laswp_apply(a[:, :k], cand, src)
            if k + bc < n:
                laswp_apply(a[:, k + bc:], cand, src)
    return info, perm_total


def _exchange(a, k: int, bc: int, stage, combined: bool) -> None:
    """The fused block column's physical row exchange (kernel 4), then the
    band write.  ``combined`` is ignored: it is kept only for the
    benchmark's fault stub, which takes the same parameters."""
    a[k:k + bc] = rows_exchange(a, k, stage[2], stage[3])


def _trailing_update(a, ks: int, kw: int, ce: int, policy, r: int, lu_diag=None):
    """From the ``kw``-wide packed diagonal block at ``ks``: U12 :=
    L11^{-1} A12 over the columns [ks + kw, ce) (the ``mpf.u12`` stage),
    then A[ks+kw:, ks+kw:ce] -= L21 @ U12 (kernel 6, the ``mpf.trailing``
    stage), in place (`mpf.py:486-577`).  ``ce = n`` is the classic
    full-width update; the lookahead driver passes the next block column's
    end.  ``lu_diag``: the diagonal block, when the caller holds it apart
    from ``a``.  Returns L11^{-1} (None when there is nothing to update),
    which the lookahead driver reuses for the wide part.

    U12 is IEEE fp32 products of operands in the working dtype, rounded
    once."""
    e = ks + kw
    w = ce - e
    if w <= 0:
        return None
    with _lib.span("mpf.u12"):
        linv = unit_lower_inv_blocked(a[ks:e, ks:e] if lu_diag is None else lu_diag,
                                      base=min(r, 128))
        u12 = matmul_in(linv, a[ks:e, e:ce], a.dtype).to(a.dtype)
        a[ks:e, e:ce] = u12
    with _lib.span("mpf.trailing"):
        l21 = a[e:, ks:e].to(policy.gemm_in)
        trailing_gemm_sub(a, l21, u12.to(policy.gemm_in), e, ncols=w)
    return linv


def _all_fused(n: int, block: int, r: int, policy, pivot: bool, panel_kernel) -> bool:
    """Every block column of an n x n matrix takes the fused path."""
    return all(_takes_fused(min(block, n - k), r, policy, pivot, panel_kernel)
               for k in range(0, n, block) if n - k > 1)


def _lookahead_ok(n: int, r: int, block: int, policy, pivot: bool, panel_kernel,
                  lookahead: bool) -> bool:
    """The lookahead gate (`mpf.py:1059-1081` without the TPU's 1024
    alignment of n and block)."""
    return (lookahead and pivot and n >= 2 * block
            and _all_fused(n, block, r, policy, pivot, panel_kernel))


def _lookahead_factorize(a, r: int, policy, block: int, ipiv, info, perm_total) -> MPFResult:
    """One-deep lookahead (`mpf.py:662-741`): block column k's trailing
    update is split at the next block column's right edge e2.  The narrow
    part (columns [e, e2)) runs first; then the next panel is factored;
    then the wide part (columns [e2, n)): its U12, and kernel 13 with the
    next block column's row exchange inside it, followed by the band write.
    Block column 0 (the prologue) and a block column with nothing wide
    after it exchange on their own (kernel 4).  Pivots and the row map are
    those of the classic loop: the narrow update computes the same entries
    of the next panel as the full-width one."""
    n = a.shape[0]
    nb = [(k, min(block, n - k)) for k in range(0, n, block) if n - k > 1]
    info, stage = _fused_panel_stage(a, nb[0][0], nb[0][1], r, policy, ipiv, info)
    eager = True               # this block column's exchange is still to do
    for i, (k, bc) in enumerate(nb):
        u_all = stage[4]
        with _lib.span("mpf.exchange"):
            if eager:
                _exchange(a, k, bc, stage, combined=True)
            a[k:k + bc, k:k + bc] = u_all
            perm_total = _compose_perm(perm_total, k, bc, stage)
        e = k + bc
        if i + 1 == len(nb):
            if e < n:
                _trailing_update(a, k, bc, n, policy, r, u_all)
            break
        kn, bc2 = nb[i + 1]
        e2 = kn + bc2
        linv = _trailing_update(a, k, bc, e2, policy, r, u_all)
        info, stage = _fused_panel_stage(a, kn, bc2, r, policy, ipiv, info)
        eager = e2 >= n
        if eager:
            continue           # nothing wide to run the exchange in
        with _lib.span("mpf.u12"):
            u12w = matmul_in(linv, a[k:e, e2:], a.dtype).to(a.dtype)
            a[k:e, e2:] = u12w
        with _lib.span("mpf.trailing"):
            l21 = a[e:, k:e].to(policy.gemm_in)
            _, pivrows = gemm_trailing(a, l21, u12w.to(policy.gemm_in), e, e2,
                                       xargs=(kn, stage[2], stage[3]))
            a[kn:kn + bc2] = pivrows
    return MPFResult(lu=a, ipiv=ipiv, info=info, perm=perm_total)


def _deferred_factorize(a, r: int, policy, block: int, S: int, ipiv, info,
                        perm_total) -> MPFResult:
    """Deferred-overflow exchange (`mpf.py:744-856`): block columns run in
    groups of ``S``.  A displaced band row whose destination lies beyond
    the group's last column (``gend``) is not scattered home: the block
    column's band is copied to its own ``block`` overflow slots below the
    matrix (kernel 14, :func:`copy_rows_block`) before the exchange, whose
    deferred destinations are masked to in-band (kernel 4 skips them).
    Once per group :func:`flush_overflow` (kernel 14) moves every live
    overflow row home.

    ``posg`` maps each physical row of the (n + S·block, n) matrix to its
    virtual position: the identity for rows at home, the destination for a
    live overflow row, ``SENT`` for a stale copy and an unused slot (plus
    one dump slot at n + S·block that takes the masked scatters, so no
    step syncs with the host).  Kernel 1 searches by position, so an
    overflow row is a candidate exactly where the classic loop would have
    put it and dead rows take no part; the kernels after it (2, 3 or 12,
    4, 6) take any physical row, and dead rows receive updates whose values
    do not matter, since the flush overwrites them.  ``perm_total`` stays
    indexed by position (``vglist = posg[glist]``).  The trailing update
    covers the overflow strip: its rows are real trailing rows.

    ``a`` is the (n + S·block, n) matrix when pre-extended (its bottom
    rows' values do not matter), else (n, n), which is copied into a new
    extended buffer.  The caller checked the gate (:func:`_resolve_defer`)."""
    n = a.shape[1]
    ov = S * block
    dev = a.device
    if a.shape[0] == n + ov:
        a_ext = a
    else:
        a_ext = torch.empty((n + ov, n), dtype=a.dtype, device=dev)
        a_ext[:n] = a
    lu = a_ext[:n]
    drop = n + ov
    posg = torch.cat([torch.arange(n, dtype=torch.int32, device=dev),
                      torch.full((ov + 1,), SENT, dtype=torch.int32, device=dev)])
    nb = [k for k in range(0, n, block) if n - k > 1]
    for g in range(0, len(nb), S):
        group = nb[g:g + S]
        gend = min(group[-1] + block, n)        # defer only dests >= gend
        for si, k in enumerate(group):
            bc = min(block, n - k)
            info, stage = _fused_panel_stage(a_ext, k, bc, r, policy, ipiv, info, ov=ov,
                                             posg=posg)
            glist, dests, u_all = stage[2], stage[3], stage[4]
            with _lib.span("mpf.exchange"):
                gl = glist.long()
                perm_total = _compose_perm(perm_total, k, bc, stage, vglist=posg[gl])
                defer = dests >= gend
                sbase = n + si * block              # this column's overflow slots
                band = torch.arange(k, k + bc, dtype=torch.int32, device=dev)
                copy_rows_block(a_ext, k, sbase, bc)
                a_ext[k:k + bc] = rows_exchange(a_ext, k, glist,
                                                torch.where(defer, band, dests))
                a_ext[k:k + bc, k:k + bc] = u_all
                # consumed overflow rows die; deferred rows live in their slots
                # at their destinations, whose stale copies die
                posg[torch.where(gl >= n, gl, drop)] = SENT
                slots = band.long() + (sbase - k)
                posg[torch.where(defer, slots, drop)] = dests.to(torch.int32)
                posg[torch.where(defer, dests.long(), drop)] = SENT
            if k + bc < n:
                _trailing_update(a_ext, k, bc, n, policy, r, u_all)
        with _lib.span("mpf.exchange"):
            dov = posg[n:n + ov].clone()
            flush_overflow(a_ext, n, dov)
            live = dov < n
            posg[torch.where(live, dov.long(), drop)] = dov
            posg[n:] = SENT
    return MPFResult(lu=lu, ipiv=ipiv, info=info, perm=perm_total)


def _pairs_ok(n: int, block: int, r: int, policy, pivot: bool, panel_kernel,
              lookahead: bool, defer: int) -> bool:
    """The pair-layout gate (`mpf.py:984-1014`): pivoting, no
    ``panel_kernel``, neither lookahead nor a deferred exchange that
    :func:`_resolve_defer` keeps, n % block == 0, an even block and every
    block column on the fused path.  The one difference: the JAX gate also
    requires ``kernels_on()``; the port runs its plain versions on the
    CPU, as :func:`_lookahead_ok` and :func:`_resolve_defer` do."""
    return (pivot and panel_kernel is None and not lookahead
            and not _resolve_defer(n, block, r, policy, pivot, panel_kernel, defer)
            and n % block == 0 and block % 2 == 0
            and _all_fused(n, block, r, policy, pivot, panel_kernel))


def _factorize_3d(a3, r: int, policy, block: int) -> MPFResult:
    """The pair-layout fused loop (`mpf.py:580-659`), in place on the
    (n/2, 2, n) ``a3``; the caller checked :func:`_pairs_ok`.  Per block
    column, as the JAX loop runs it: the slab copied out, factored by the
    panel kernels and copied back (:func:`_fused_panel_stage` with
    ``pairs``); the row exchange on the matrix (:func:`rows_exchange3`,
    kernel 4) and the pivot rows written over the band
    (:func:`band_write_rows`, 15c); the finished row block overlaid; the
    row map composed; then L11^{-1} (:func:`unit_lower_inv_blocked`), U12
    in place (:func:`u12_transform`, 15d) and the trailing GEMM on L21
    and U12 in ``gemm_in`` (:func:`trailing_sub3`, kernel 6).
    The JAX package splits this loop into parts only because its TPU
    compile helper ran out of memory on one 64-column executable
    (`mpf.py:597-604`, `make_mpf`'s `_pair3d_parts`); eager PyTorch has no
    compile step, so the port runs it whole.

    On the CPU the result is bitwise the classic 2D loop's (the plain U12
    is that loop's product).  On the card it is not required to be:
    kernel 15d sums each U12 entry in ascending order with FMA, and cuBLAS
    need not (at the smoke's shapes it does, and the factors agree)."""
    n = a3.shape[2]
    a = a3.view(n, n)
    dev = a3.device
    ipiv = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    info = torch.zeros((), dtype=torch.int32, device=dev)
    perm_total = torch.arange(n, dtype=torch.int32, device=dev)
    for k in range(0, n, block):
        bc = min(block, n - k)
        if n - k <= 1:
            break
        info, stage = _fused_panel_stage(a, k, bc, r, policy, ipiv, info, pairs=True)
        u_all = stage[4]
        with _lib.span("mpf.exchange"):
            band_write_rows(a3, rows_exchange3(a3, k, stage[2], stage[3]), k)
            a[k:k + bc, k:k + bc] = u_all
            perm_total = _compose_perm(perm_total, k, bc, stage)
        e = k + bc
        if e < n:
            with _lib.span("mpf.u12"):
                linv = unit_lower_inv_blocked(u_all, base=min(r, 128))
                u12_transform(a3, linv, k, e, n - e)
            with _lib.span("mpf.trailing"):
                trailing_sub3(a3, a[e:, k:e].to(policy.gemm_in),
                              a[k:e, e:].to(policy.gemm_in), e)
    return MPFResult(lu=a3, ipiv=ipiv, info=info, perm=perm_total)


def _resolve_defer(n: int, block: int, r: int, policy, pivot: bool, panel_kernel,
                   defer: int) -> int:
    """The deferred exchange's group size S, or 0 (off): `mpf.py:859-922`
    on the requested S (:func:`_options`).  It needs n % block == 0, n >=
    2 block and every block column on the fused path (so ``MPF_FP16``,
    ``pivot=False`` and a ``panel_kernel`` resolve to 0).  The one
    difference from the JAX gate: it also requires ``kernels_on()`` and so
    ignores ``defer`` on its CPU default, where the port's plain versions
    stand in for the kernels and ``defer`` runs (as the lookahead gate,
    :func:`_lookahead_ok`)."""
    if defer <= 0 or n % block or n < 2 * block:
        return 0
    return defer if _all_fused(n, block, r, policy, pivot, panel_kernel) else 0


def defer_extension(n: int, r: int = 128, policy: PrecisionPolicy = MPF_BF16,
                    block: int | None = None, defer=None, pivot: bool = True) -> int:
    """Overflow rows the deferred exchange appends for this configuration
    (0: deferral off), `mpf.py:937-946`.  A caller at the edge of device
    memory passes a pre-extended ``(n + ov, n)`` input (bottom rows' values
    do not matter), which is factored in place instead of being copied
    into a new extended buffer."""
    block = _auto_block(n, r, policy, block)
    return _resolve_defer(n, block, r, policy, pivot, None,
                          _options(None, defer, pivot)[1]) * block


def _factorize_inplace(a, r: int, policy, block: int, pivot: bool, panel_kernel,
                       lookahead: bool, defer: int) -> MPFResult:
    """The routing of `mpf.py:1023-1109`: lookahead first (square input
    only), then the deferred exchange (pivoting), whose resolved S·block
    must equal the rows a rectangular input carries below its n x n
    matrix, else the classic loop."""
    n = a.shape[1]
    ov_in = a.shape[0] - n
    dev = a.device
    ipiv = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    info = torch.zeros((), dtype=torch.int32, device=dev)
    perm_total = torch.arange(n, dtype=torch.int32, device=dev)
    if not ov_in and _lookahead_ok(n, r, block, policy, pivot, panel_kernel, lookahead):
        return _lookahead_factorize(a, r, policy, block, ipiv, info, perm_total)
    if pivot:
        sd = _resolve_defer(n, block, r, policy, pivot, panel_kernel, defer)
        if ov_in and sd * block != ov_in:
            raise ValueError(
                f"row-extended input carries ov={ov_in} overflow rows but the deferred "
                f"exchange resolved S={sd} (block={block}, ov must equal S*block; pass "
                f"defer={ov_in // block})")
        if sd:
            return _deferred_factorize(a, r, policy, block, sd, ipiv, info, perm_total)
    if ov_in:
        raise ValueError(
            "row-extended (pre-allocated overflow) input requires the deferred-exchange "
            f"path; it did not resolve (shape {tuple(a.shape)}, block={block})")
    for k in range(0, n, block):
        bc = min(block, n - k)
        if n - k <= 1:
            break
        if _takes_fused(bc, r, policy, pivot, panel_kernel):
            info, stage = _fused_panel_stage(a, k, bc, r, policy, ipiv, info)
            with _lib.span("mpf.exchange"):
                _exchange(a, k, bc, stage, combined=True)
                a[k:k + bc, k:k + bc] = stage[4]
                perm_total = _compose_perm(perm_total, k, bc, stage)
        else:
            info, perm_total = _masked_block_column(a, k, bc, r, policy, pivot,
                                                    panel_kernel, ipiv, info, perm_total)
        if k + bc < n:
            _trailing_update(a, k, bc, n, policy, r)
    return MPFResult(lu=a, ipiv=ipiv, info=info, perm=perm_total)


def _check_args(a) -> None:
    """A square (n, n) or row-extended (n + ov, n) matrix, or the (n/2, 2,
    n) pair layout (the JAX package's shape check, `mpf.py:983-985`)."""
    if a.dim() == 3:
        n = a.shape[2]
        if tuple(a.shape[:2]) != (n // 2, 2):
            raise ValueError(f"expected (n/2, 2, n) pair layout, got {tuple(a.shape)}")
        return
    if a.dim() != 2 or a.shape[0] < a.shape[1]:
        raise ValueError(f"expected square or row-extended matrix, got {tuple(a.shape)}")


def _as_tensor(a, device) -> torch.Tensor:
    """A numpy array goes to ``device`` (default ``cuda:0``, as the JAX
    entry points put it on the chip); a tensor stays on its device unless
    ``device`` is given.  Asking for CUDA with no card raises."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
        device = "cuda:0" if device is None else device
    if device is None:
        return a
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but torch.cuda.is_available() is "
                           "False; pass device='cpu' to factor on the CPU")
    return a.to(device)


def _factorize_entry(a: torch.Tensor, r: int, policy: PrecisionPolicy, block,
                     pivot: bool, panel_kernel, lookahead: bool, defer: int) -> MPFResult:
    """In-place factorization of the contiguous working-dtype ``a`` (square,
    row-extended for the deferred exchange, or the pair layout) with the
    variant arguments already resolved (:func:`_options`); a square n that
    is not a multiple of r and would otherwise leave the fused path
    factors its identity extension (the pair layout is never padded, as in
    the JAX package)."""
    _check_policy(policy)
    n = a.shape[-1]
    if a.dtype != policy.working or not a.is_contiguous():
        raise ValueError(f"in-place factorization needs a contiguous "
                         f"{policy.working} matrix, got {a.dtype}")
    if a.dim() == 3:
        block = _auto_block(n, r, policy, block)
        if not _pairs_ok(n, block, r, policy, pivot, panel_kernel, lookahead, defer):
            raise ValueError(
                "pair-layout (3D) input requires the fused kernel path: pivot=True, "
                "default panel kernel, no lookahead/defer, "
                f"n % block == 0, an even block and every block column fused-eligible "
                f"(n={n}, block={block}, r={r}, policy={policy.name})")
        return _factorize_3d(a, r, policy, block)
    block_pad = _auto_block(-(-n // r) * r, r, policy, block)  # for the padded size
    block = _auto_block(n, r, policy, block)
    n_pad = 0 if a.shape[0] > n else _pad_target(n, r, block_pad, policy, pivot,
                                                  panel_kernel)
    if n_pad:
        apad = torch.zeros((n_pad, n_pad), dtype=a.dtype, device=a.device)
        apad[:n, :n] = a
        tail = torch.arange(n, n_pad, device=a.device)
        apad[tail, tail] = 1.0
        res = _factorize_inplace(apad, r, policy, block_pad, True, None, lookahead, defer)
        return MPFResult(
            lu=res.lu[:n, :n],
            ipiv=res.ipiv[:n],
            # pad columns have unit diagonals; clamp defensively anyway
            info=torch.where(res.info > n, torch.zeros_like(res.info), res.info),
            perm=res.perm[:n],
        )
    return _factorize_inplace(a, r, policy, block, pivot, panel_kernel, lookahead, defer)


def mpf_factorize_inplace(a: torch.Tensor, r: int = 128,
                          policy: PrecisionPolicy = MPF_BF16,
                          block: int | None = None, pivot: bool = True,
                          panel_kernel=None, super_block="auto",
                          lookahead: bool | None = None, defer=None) -> MPFResult:
    """Factor the contiguous working-dtype matrix ``a`` IN PLACE: square
    (``result.lu`` is ``a``, or a padded copy for an n that is not a
    multiple of r and that would otherwise leave the fused path, or an
    extended copy under ``defer``), row-extended ``(n + S·block, n)`` for
    the deferred exchange (``result.lu`` is ``a[:n]``), or the ``(n/2, 2,
    n)`` pair layout (``result.lu`` is ``a``).  The variant arguments are
    :func:`mpf_factorize`'s."""
    _check_args(a)
    return _factorize_entry(a, r, policy, block, pivot, panel_kernel,
                            *_options(lookahead, defer, pivot, super_block))


def mpf_factorize(
    a,
    r: int = 128,
    policy: PrecisionPolicy = MPF_BF16,
    pivot: bool = True,
    block: int | None = None,
    super_block="auto",
    lookahead: bool | None = None,
    defer=None,
    device=None,
) -> MPFResult:
    """Blocked MPF factorization of the square matrix ``a``, of the
    row-extended ``(n + S·block, n)`` one for the deferred exchange, or of
    the ``(n/2, 2, n)`` pair layout, row i at ``a[i // 2, i % 2]``, whose
    factors come back in that shape (the library entry point, reference
    `MPF.h:3`).  ``a`` is not modified: it is copied
    to ``policy.working``.  A numpy array is placed on ``device`` (default
    ``cuda:0``; ``device="cpu"`` factors on the CPU); a tensor stays on its
    own device unless ``device`` is given.  Runs the kernels for a CUDA
    tensor and their plain versions for a CPU tensor.

    ``lookahead=True`` runs the one-deep lookahead driver; ``defer`` the
    deferred exchange's group size S (an int, True for :data:`DEFER_S`;
    None, False or 0: off; see :func:`_resolve_defer`).  ``super_block``
    takes ``"auto"`` or None only, and raises ValueError for a width.  No
    environment variable is read."""
    opts = _options(lookahead, defer, pivot, super_block)
    a = _as_tensor(a, device)
    _check_args(a)
    _check_policy(policy)
    work = a.to(dtype=policy.working, copy=True).contiguous()
    return _factorize_entry(work, r, policy, block, pivot, None, *opts)


def make_mpf(
    n: int,
    r: int = 128,
    policy: PrecisionPolicy = MPF_BF16,
    pivot: bool = True,
    block: int | None = None,
    panel_kernel=None,
    donate: bool = True,
    super_block="auto",
    lookahead: bool | None = None,
    defer=None,
    device=None,
):
    """A factorizer for a fixed problem size.  ``donate=True`` factors a
    contiguous working-dtype tensor in place (the reference's overwrite of
    A, `MPF.h:3`); otherwise, and for a numpy array (placed on ``device``
    as :func:`mpf_factorize` places it), the input is copied first.  The
    factorizer takes (n, n), the pair layout (n/2, 2, n), or, for the
    deferred exchange, the row-extended (n + S·block, n) input
    (:func:`defer_extension`).
    ``panel_kernel(panel, row_offset=, prev_perm=) -> (piv, perm,
    composed)`` replaces kernel 7 in the masked path, which every block
    column then takes.  ``super_block``, ``lookahead`` and ``defer`` are
    :func:`mpf_factorize`'s.  Factorizers are cached by their arguments,
    the variant arguments as resolved."""
    _check_policy(policy)
    return _make_mpf(n, r, policy, pivot, block, panel_kernel, donate,
                     *_options(lookahead, defer, pivot, super_block), device)


@functools.lru_cache(maxsize=32)
def _make_mpf(n: int, r: int, policy: PrecisionPolicy, pivot: bool, block, panel_kernel,
              donate: bool, lookahead: bool, defer: int, device):
    def fac(a) -> MPFResult:
        if not ((a.ndim == 2 and a.shape[1] == n and a.shape[0] >= n)
                or tuple(a.shape) == (n // 2, 2, n)):
            raise ValueError(f"expected ({n}, {n}), ({n} + ov, {n}) or the pair layout "
                             f"({n // 2}, 2, {n}), got {tuple(a.shape)}")
        t = _as_tensor(a, device)
        if not (t is a and donate and t.dtype == policy.working and t.is_contiguous()):
            t = t.to(dtype=policy.working, copy=True).contiguous()
        return _factorize_entry(t, r, policy, block, pivot, panel_kernel, lookahead, defer)

    return fac
