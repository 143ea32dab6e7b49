"""The plain reference of the MPF algorithm, the configuration ``mpf_fp16_n16384``.

MPF ("mixed-precision pre-pivoting factorization", github.com/Keyteer/
Mixed-precision_LU_Factorization, ``MPF.cu:100-240``) chooses each r-wide
panel's pivots by a partial-pivoted LU of the panel in fp16 whose factors
it throws away, applies those row swaps, and factors the swapped panel
again in the working precision without pivoting.  :func:`mpf_plain` is
that algorithm in plain ``torch`` operations, independent of the program
(it imports neither JAX, the JAX package nor the port):

* per r-panel, on its active rows (from the panel's diagonal down):

  - the panel cast to the panel dtype; with ``saturate``, clamped to the
    dtype's largest finite value and flushed to zero below its smallest
    normal, then rounded to nearest even (``fp16_utils.h:15-23``);
  - a partial-pivoted LU of the cast panel in the panel dtype (the
    source's ``hgetf2_kernel.cu``): per column the first row of largest
    magnitude (a tie goes to the lowest row, as ``jnp.argmax`` in the JAX
    package's plain version, ``mpf_tpu/ops/getf2.py:59-62``, and the
    lowest current position in its kernel 7, ``mpf_tpu/ops/panel_pallas.py:
    87-91``); multipliers an fp32 divide rounded to the panel dtype; each
    update ``p - m u`` computed exactly in fp64 and rounded once to the
    panel dtype (:func:`round_once`);
  - the factors thrown away, the swaps applied in order to whole rows;
  - an fp32 no-pivot LU of the r x r diagonal block (the source's
    ``dgetf2_native_npv``), with a LAPACK ``info`` for the first zero
    pivot (the source has none; a zero pivot divides by 1);
  - L21 = A21 U11^-1 and the U12 inside the block column by triangular
    solves, and their update, in IEEE fp32;

* per block column of ``block`` columns, U12 = L11^-1 A12 over the columns
  to its right by a triangular solve, then A22 -= L21 U12 in slices of
  ``cols`` columns (so the temporaries stay small at n = 16384).

Every product is IEEE fp32 with TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False); the GEMM operands of both
updates are rounded to ``gemm_in`` first.  The one departure from the
source: the working precision is fp32, where the source's is fp64 (the
port has no fp64 policy).  The source updates with K = r over the whole
trailing matrix; the blocking by ``block`` changes only the order of fp32
roundings.
"""

from __future__ import annotations

import contextlib
import math

import torch

from benchmark_torch.reference import DTYPES, Answer


@contextlib.contextmanager
def ieee_fp32():
    """fp32 products in IEEE fp32 on the card (no TF32), restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def round_once(z: torch.Tensor, dtype) -> torch.Tensor:
    """The fp64 ``z`` rounded once to the nearest ``dtype`` value, ties to
    even (a direct fp64 -> fp16 conversion in PyTorch goes through fp32
    and rounds twice).  The unit in the last place of ``dtype`` at z's
    binade (at the smallest normal's below it, for subnormals) divides z
    exactly; ``torch.round`` rounds the quotient half to even; a result
    past the largest finite value becomes infinite in the cast."""
    fi = torch.finfo(dtype)
    _, e = torch.frexp(z)
    emin = round(math.log2(fi.tiny))
    ulp = torch.ldexp(torch.full_like(z, fi.eps), torch.clamp(e - 1, min=emin))
    return (torch.round(z / ulp) * ulp).to(dtype)


def cast_panel(x: torch.Tensor, dtype, saturate: bool) -> torch.Tensor:
    """fp32 ``x`` in the panel dtype: clamped to +-max and flushed to zero
    below the smallest normal with ``saturate``, then rounded to nearest
    even once."""
    if saturate:
        fi = torch.finfo(dtype)
        x = torch.clamp(x, -fi.max, fi.max)
        x = torch.where(x.abs() < fi.tiny, torch.zeros_like(x), x)
    return x.to(dtype)


def prepivot(panel: torch.Tensor, dtype, saturate: bool) -> list:
    """The pivots of the partial-pivoted LU of the (m, rp) fp32 ``panel``
    in ``dtype``: 0-based rows of the panel, one a column (the factors
    are thrown away)."""
    h = cast_panel(panel, dtype, saturate)
    m, rp = h.shape
    piv = []
    for j in range(min(rp, m)):
        p = j + int(torch.argmax(h[j:, j].float().abs()))
        piv.append(p)
        if p != j:
            h[[j, p]] = h[[p, j]]
        pivot = h[j, j].float()
        safe = torch.where(pivot == 0, torch.ones_like(pivot), pivot)
        mult = (h[j + 1:, j].float() / safe).to(dtype)
        h[j + 1:, j + 1:] = round_once(
            h[j + 1:, j + 1:].double() - mult.double()[:, None] * h[j, j + 1:].double()[None, :],
            dtype)
        h[j + 1:, j] = mult
    return piv


def npv(block: torch.Tensor) -> tuple:
    """No-pivot LU of the square fp32 ``block`` in place: ``(block, first)``,
    ``first`` the 0-based column of the first zero pivot or None."""
    first = None
    for j in range(block.shape[0]):
        pivot = block[j, j]
        if first is None and float(pivot) == 0.0:
            first = j
        safe = torch.where(pivot == 0, torch.ones_like(pivot), pivot)
        block[j + 1:, j] /= safe
        block[j + 1:, j + 1:] -= block[j + 1:, j:j + 1] * block[j:j + 1, j + 1:]
    return block, first


def _swap_rows(w: torch.Tensor, perm: list, j0: int, piv: list) -> None:
    """The panel's swaps ``j0 + j <-> piv[j]`` (global rows), in order, on
    the whole rows of ``w`` and on ``perm``: one gather of the rows that
    move."""
    local = {}
    for j, p in enumerate(piv):
        d = j0 + j
        if p != d:
            local[d], local[p] = local.get(p, p), local.get(d, d)
    moved = [d for d, s in local.items() if d != s]
    if not moved:
        return
    dst = torch.tensor(moved, device=w.device)
    w[dst] = w[torch.tensor([local[d] for d in moved], device=w.device)]
    old = list(perm)
    for d in moved:
        perm[d] = old[local[d]]


def _sub_product(c: torch.Tensor, l: torch.Tensor, u: torch.Tensor, op, cols: int) -> None:
    """``c -= l @ u`` in fp32 with ``l`` and ``u`` rounded to ``op``,
    ``cols`` columns at a time."""
    l = l.to(op).float()
    for c0 in range(0, c.shape[1], cols):
        c1 = min(c.shape[1], c0 + cols)
        c[:, c0:c1].addmm_(l, u[:, c0:c1].to(op).float(), alpha=-1.0)


def mpf_plain(a: torch.Tensor, r: int, block: int, panel: str = "float16",
              saturate: bool = True, gemm_in: str = "float32", cols: int = 4096) -> Answer:
    """MPF of the square ``a`` with r-wide panels in block columns of
    ``block``: the answer ``(lu, ipiv, info, perm)`` of a LAPACK ``getrf``
    (packed unit-lower L and U in fp32, 1-based sequential swaps, the
    first zero pivot, the row map).  ``panel``: the pivot search's dtype;
    ``saturate``: its cast clamps and flushes; ``gemm_in``: the dtype the
    updates' operands are rounded to."""
    n = a.shape[0]
    pdt, op = DTYPES[panel], DTYPES[gemm_in]
    w = a.to(torch.float32, copy=True)
    dev = w.device
    ipiv = list(range(1, n + 1))
    perm = list(range(n))
    info = 0
    with ieee_fp32():
        for k in range(0, n, block):
            e = min(n, k + block)
            if n - k <= 1:
                break
            for j0 in range(k, e, r):
                rp = min(r, e - j0)
                if n - j0 <= 1:
                    break  # a 1 x 1 tail panel keeps its pivot (MPF.cu:104)
                piv = [j0 + p for p in prepivot(w[j0:, j0:j0 + rp], pdt, saturate)]
                _swap_rows(w, perm, j0, piv)
                ipiv[j0:j0 + rp] = [p + 1 for p in piv]
                _, first = npv(w[j0:j0 + rp, j0:j0 + rp])
                if info == 0 and first is not None:
                    info = j0 + first + 1
                d = j0 + rp
                if d < n:  # L21 = A21 U11^-1
                    w[d:, j0:d] = torch.linalg.solve_triangular(
                        torch.triu(w[j0:d, j0:d]), w[d:, j0:d], upper=True, left=False)
                if d < e:  # U12 = L11^-1 A12 inside the block column, and the update
                    w[j0:d, d:e] = torch.linalg.solve_triangular(
                        w[j0:d, j0:d], w[j0:d, d:e], upper=False, unitriangular=True)
                    _sub_product(w[d:, d:e], w[d:, j0:d], w[j0:d, d:e], op, cols)
            if e < n:  # U12 over the columns right of the block column, then A22
                for c0 in range(e, n, cols):
                    c1 = min(n, c0 + cols)
                    w[k:e, c0:c1] = torch.linalg.solve_triangular(
                        w[k:e, k:e], w[k:e, c0:c1], upper=False, unitriangular=True)
                _sub_product(w[e:, e:], w[e:, k:e], w[k:e, e:], op, cols)
    i32 = dict(dtype=torch.int32, device=dev)
    return Answer(lu=w, ipiv=torch.tensor(ipiv, **i32), info=torch.tensor(info, **i32),
                  perm=torch.tensor(perm, **i32))
