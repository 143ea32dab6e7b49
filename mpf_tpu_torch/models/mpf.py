"""MPF: blocked right-looking mixed-precision pre-pivoting LU, single device.

Port of the classic fused loop of `mpf_tpu/models/mpf.py`
(`mpf_factorize_traced`, fused branch).  Per block column of width ``block``:

  1. panel stage (`_fused_panel_stage`): for each r-wide panel of the
     block column, on a window of rows that can still pivot —
     A1 :func:`strip_panel_pivots` (pivots, rows never move),
     A2 :func:`rowblock_assemble` (pivot rows, diagonal LU, U12 in the
     block column), B :func:`panel_apply_update_trim` (L21 and the update of
     the block column's later columns);
  2. one physical row exchange (:func:`rows_exchange`) for the whole block
     column, then the finished pivot rows are written into the band;
  3. the trailing update (`_trailing_update`): U12 = L11^{-1} A12 through
     :func:`unit_lower_inv_blocked` and an IEEE-fp32 ``torch.matmul``, then
     :func:`trailing_gemm_sub` with the policy's ``gemm_in`` operands.

Everything stays on the input's device and no step reads a value back to
the host.  The matrix is factored in place (in a working copy for
:func:`mpf_factorize`).

Outside this slice, and raising ``NotImplementedError`` (see ROADMAP.md):
``pivot=False``, superblocking, lookahead, the deferred exchange, the
pair-layout 3D input, a custom ``panel_kernel``, shapes that would need the
masked fallback path (``r % 8 != 0`` or ``block % r != 0``), and the
policies ``ALL_BF16`` (bf16 working storage) and ``MPF_FP16`` (saturating
fp16 panel).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from mpf_tpu_torch.precision import PrecisionPolicy, MPF_BF16
from mpf_tpu_torch.ops.blas3 import ieee_fp32, unit_lower_inv_blocked
from mpf_tpu_torch.ops.exchange import rows_exchange
from mpf_tpu_torch.ops.panel_fused import (
    panel_apply_update_trim,
    rowblock_assemble,
    trailing_gemm_sub,
)
from mpf_tpu_torch.ops.panel_strip import strip_panel_pivots


class MPFResult(NamedTuple):
    """Factorization result (LAPACK getrf conventions).

    ``lu``   — (n, n) packed factors in working precision: strictly-lower =
               L (unit diagonal implicit), upper = U
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

_SUPPORTED = ("mpf_bf16", "mpf_ref", "pure_fp32")


def _unsupported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to mpf_tpu_torch yet (ROADMAP.md: {item})")


def _check_policy(policy: PrecisionPolicy) -> None:
    if policy.name not in _SUPPORTED:
        raise _unsupported(f"policy {policy.name}",
                           "Queue 1, ALL_BF16 / MPF_FP16 policies")


def _fused_ok(bc: int, r: int) -> bool:
    """The fused path needs whole 8-column strips (kernel 1) and whole
    panels per block column; r is also capped by the one-block diagonal
    refactor (kernel 2 keeps three r x r fp32 blocks in shared memory)."""
    return r >= 8 and r % 8 == 0 and r <= 128 and bc % r == 0


def _auto_block(n: int, r: int, policy, block: int | None) -> int:
    """Block-column width: 1024, or 2048 for fp32 working storage at
    n >= 32768 — the JAX package's rule, kept until the card's own block
    sweep replaces it."""
    if block is None:
        wide = n >= 32768 and policy.working == torch.float32
        block = max(r, min(n, 2048 if wide else 1024))
    return max(block, r)


def _pad_target(n: int, r: int) -> int:
    """Identity-extension size that keeps a non-aligned n on the fused
    path, or 0: the next multiple of r.  Pad rows are zero in the first n
    columns, so they are never chosen as pivots (except in an exactly-zero
    column, where ``info`` fires anyway), and pad columns have U12 = 0."""
    if n % r == 0:
        return 0
    return -(-n // r) * r


def _window(n: int, k: int) -> int:
    """Height m of the row window [n - m, n) for block column k."""
    q = _WINDOW_QUANTUM
    return min(n, -((k - n) // q) * q)


def _factor_block_column_fused(slab, diag0: int, r: int, policy):
    """Virtual-pivoting factorization of the (m, bc) slab view in place
    (rows are a tail window of the matrix; ``diag0`` = slab row of the block
    column's first diagonal).  Returns ``(pos, olog, piv, u_all, info)``:
    final positions (m,), the slab row landing at each diagonal position
    (bc,), local pivot positions (bc,), the finished (bc, bc) pivot-row
    values, and the block-local 1-based first zero pivot."""
    m, bc = slab.shape
    dev = slab.device
    gemm_bf16 = policy.gemm_in == torch.bfloat16 and policy.working != torch.bfloat16
    pos = torch.arange(m, dtype=torch.int32, device=dev)
    info = torch.zeros((), dtype=torch.int32, device=dev)
    pivs, ologs, rowblocks = [], [], []
    for t in range(bc // r):
        jj0 = t * r
        j0 = diag0 + jj0
        piv, pos, glist = strip_panel_pivots(slab, j0, pos, panel_dtype=policy.panel,
                                             jj0=jj0, r=r)
        rowblock, uinv, info_k = rowblock_assemble(slab, glist, jj0)
        info = torch.where((info == 0) & (info_k > 0), info_k + jj0, info)
        panel_apply_update_trim(slab, pos, rowblock, uinv, j0, jj0, gemm_bf16=gemm_bf16)
        pivs.append(piv)
        ologs.append(glist)
        rowblocks.append(rowblock)
    return pos, torch.cat(ologs), torch.cat(pivs), torch.cat(rowblocks), info


def _fused_panel_stage(a, k: int, bc: int, r: int, policy, ipiv, info):
    """Panel work (A1 + A2 + B) for block column ``k`` on its row window,
    in place on ``a``; updates ``ipiv``/``info`` in place and returns
    ``(info, stage)`` with ``stage = (k0, band_idx, glist, dests, u_all)``."""
    n = a.shape[0]
    m = _window(n, k)
    k0 = n - m  # rows above k0 can neither pivot nor update
    sub = a[k0:, k:k + bc]
    pos_l, olog_l, piv_l, u_all, info_b = _factor_block_column_fused(
        sub, k - k0, r, policy)
    ipiv[k:k + bc] = k0 + piv_l + 1
    info = torch.where((info == 0) & (info_b > 0), info_b + k, info)
    band_idx = (k - k0) + torch.arange(bc, device=a.device)
    dests = k0 + pos_l[band_idx]       # band rows' new positions
    glist = k0 + olog_l                # pivot-row sources
    return info, (k0, band_idx, glist, dests, u_all)


def _compose_perm(perm_total, k: int, bc: int, stage):
    """Compose one block column's row map into the running total — only
    the band and the displaced destinations change."""
    k0, band_idx, glist, dests = stage[:4]
    pt_old = perm_total.clone()
    perm_total[k:k + bc] = pt_old[glist.long()]
    perm_total[dests.long()] = pt_old[(k0 + band_idx).long()]
    return perm_total


def _trailing_update(a, ks: int, kw: int, policy, lu_diag, r: int):
    """U12 := L11^{-1} A12 over the columns right of the ``kw``-wide block
    column at ``ks``, then the trailing A -= L21 @ U12, in place."""
    e = ks + kw
    linv = unit_lower_inv_blocked(lu_diag, base=min(r, 128))
    with ieee_fp32():
        u12 = linv @ a[ks:e, e:]
    a[ks:e, e:] = u12
    l21 = a[e:, ks:e].to(policy.gemm_in)
    trailing_gemm_sub(a, l21, u12.to(policy.gemm_in), e)
    return a


def _factorize_inplace(a, r: int, policy, block: int) -> MPFResult:
    n = a.shape[0]
    dev = a.device
    ipiv = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    info = torch.zeros((), dtype=torch.int32, device=dev)
    perm_total = torch.arange(n, dtype=torch.int32, device=dev)
    for k in range(0, n, block):
        bc = min(block, n - k)
        if n - k <= 1:
            break
        if not _fused_ok(bc, r):
            raise _unsupported(f"block column k={k} (bc={bc}, r={r}) off the fused path",
                               "Queue 1, masked fallback")
        info, stage = _fused_panel_stage(a, k, bc, r, policy, ipiv, info)
        glist_b, dests_b, u_all = stage[2], stage[3], stage[4]
        pivrows = rows_exchange(a, k, glist_b, dests_b)
        a[k:k + bc] = pivrows
        a[k:k + bc, k:k + bc] = u_all
        perm_total = _compose_perm(perm_total, k, bc, stage)
        if k + bc < n:
            _trailing_update(a, k, bc, policy, u_all, r)
    return MPFResult(lu=a, ipiv=ipiv, info=info, perm=perm_total)


def _check_args(a, pivot, super_block, lookahead, defer, panel_kernel=None):
    if a.dim() == 3:
        raise _unsupported("pair-layout (3D) input", "Queue 2, pair3d kernels")
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise _unsupported(f"non-square input {tuple(a.shape)}",
                           "Queue 1, deferred-exchange driver")
    if not pivot:
        raise _unsupported("pivot=False", "Queue 1, masked fallback")
    if super_block not in ("auto", None):
        raise _unsupported("super_block", "Queue 1, env-gated drivers")
    if lookahead:
        raise _unsupported("lookahead", "Queue 1, env-gated drivers")
    if defer:
        raise _unsupported("defer", "Queue 1, env-gated drivers")
    if panel_kernel is not None:
        raise _unsupported("panel_kernel", "Queue 1, masked fallback")


def mpf_factorize_inplace(a: torch.Tensor, r: int = 128,
                          policy: PrecisionPolicy = MPF_BF16,
                          block: int | None = None) -> MPFResult:
    """Factor the contiguous working-dtype square matrix ``a`` IN PLACE
    (``result.lu`` is ``a``, or a padded copy for an n that is not a
    multiple of r)."""
    _check_policy(policy)
    n = a.shape[0]
    if a.dtype != policy.working or not a.is_contiguous():
        raise ValueError(f"in-place factorization needs a contiguous "
                         f"{policy.working} matrix, got {a.dtype}")
    block = _auto_block(n, r, policy, block)
    n_pad = _pad_target(n, r)
    if n_pad:
        apad = torch.zeros((n_pad, n_pad), dtype=a.dtype, device=a.device)
        apad[:n, :n] = a
        tail = torch.arange(n, n_pad, device=a.device)
        apad[tail, tail] = 1.0
        res = _factorize_inplace(apad, r, policy, _auto_block(n_pad, r, policy, block))
        return MPFResult(
            lu=res.lu[:n, :n],
            ipiv=res.ipiv[:n],
            # pad columns have unit diagonals; clamp defensively anyway
            info=torch.where(res.info > n, torch.zeros_like(res.info), res.info),
            perm=res.perm[:n],
        )
    return _factorize_inplace(a, r, policy, block)


def mpf_factorize(
    a: torch.Tensor,
    r: int = 128,
    policy: PrecisionPolicy = MPF_BF16,
    pivot: bool = True,
    block: int | None = None,
    super_block="auto",
    lookahead: bool | None = None,
    defer=None,
) -> MPFResult:
    """Blocked MPF factorization of the square matrix ``a`` (the library
    entry point, reference `MPF.h:3`).  ``a`` is not modified: it is copied
    to ``policy.working`` on its own device.  Runs the kernels for a CUDA
    tensor and their plain versions for a CPU tensor."""
    _check_args(a, pivot, super_block, lookahead, defer)
    _check_policy(policy)
    work = a.to(dtype=policy.working, copy=True).contiguous()
    return mpf_factorize_inplace(work, r=r, policy=policy, block=block)


@functools.lru_cache(maxsize=32)
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
):
    """A factorizer for a fixed problem size.  ``donate=True`` factors a
    contiguous working-dtype input in place (the reference's overwrite of A,
    `MPF.h:3`); otherwise the input is copied first."""
    _check_args(torch.empty(n, n, device="meta"), pivot, super_block, lookahead,
                defer, panel_kernel)
    _check_policy(policy)

    def fac(a: torch.Tensor) -> MPFResult:
        if tuple(a.shape) != (n, n):
            raise ValueError(f"expected ({n}, {n}), got {tuple(a.shape)}")
        if donate and a.dtype == policy.working and a.is_contiguous():
            return mpf_factorize_inplace(a, r=r, policy=policy, block=block)
        return mpf_factorize(a, r=r, policy=policy, block=block)

    return fac
