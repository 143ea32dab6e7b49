"""The plain reference: what an LU answer must satisfy, and a plain LU.

An answer ``(lu, ipiv, info, perm)`` (LAPACK ``getrf``: packed unit-lower L
and U, 1-based sequential row swaps, the first zero pivot, and the row map
they compose to) is held to its definition, ``L U = A[perm]``, rebuilt in
fp64 by :func:`residual` from the matrix the harness made itself.  The
chunked fp64 rebuild is a copy of
`mpf_tpu_torch/utils/oracle.py:check_factorization_device`, tiled by
columns as well so that its memory stays a few GiB at any n, and taking
only the nonzero parts of L and U (2n^3/3 fp64 operations).

:func:`lu_plain` is a right-looking blocked LU with partial pivoting in
plain PyTorch, whose stored values and GEMM operands can be rounded to a
lower precision: put in the program's place, it is the control that the
comparison has to refuse.  Nothing here imports the program.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float8_e4m3fn": torch.float8_e4m3fn,
          "float8_e5m2": torch.float8_e5m2}


@dataclasses.dataclass
class Answer:
    """A factorization's result, as the program's ``MPFResult`` holds it."""

    lu: torch.Tensor
    ipiv: torch.Tensor
    info: torch.Tensor
    perm: torch.Tensor


def perm_from_ipiv(ipiv: torch.Tensor) -> list:
    """Compose the sequential 1-based swaps ``ipiv`` into the row map
    ``perm``, ``(P A)[i] = A[perm[i]]`` (a host loop over n swaps); a swap
    out of range raises ``ValueError``."""
    piv = [int(p) - 1 for p in ipiv.tolist()]
    n = len(piv)
    perm = list(range(n))
    for i, p in enumerate(piv):
        if not i <= p < n:
            raise ValueError(f"ipiv[{i}] = {p + 1} outside [{i + 1}, {n}]")
        if p != i:
            perm[i], perm[p] = perm[p], perm[i]
    return perm


def residual(a: torch.Tensor, lu: torch.Tensor, perm: torch.Tensor,
             rows: int = 4096, cols: int | None = None) -> tuple:
    """``(nbe, max_err)`` of ``L U`` against ``A[perm]`` in fp64 on ``lu``'s
    device: nbe = ||L U - A[perm]||_F / (n ||A||_F) and max_err =
    max |L U - A[perm]| / max |A|.  Tiles of ``rows`` rows of L by ``cols``
    columns of U (by default as many as keep a tile of U within 2 GiB), each
    product over the K range where both factors can be nonzero."""
    n = lu.shape[0]
    dev = lu.device
    if cols is None:
        cols = max(rows, ((1 << 28) // n) // 256 * 256)
    perm = perm.to(device=a.device, dtype=torch.long)
    sq, mx = 0.0, 0.0
    for c0 in range(0, n, cols):
        c1 = min(n, c0 + cols)
        # U's columns c0..c1: rows below column j are zero
        u = torch.triu(lu[:c1, c0:c1].to(torch.float64), diagonal=-c0)
        for r0 in range(0, n, rows):
            r1 = min(n, r0 + rows)
            k = min(r1, c1)
            # L's rows r0..r1: strictly lower, then the unit diagonal
            l = torch.tril(lu[r0:r1, :k].to(torch.float64), diagonal=r0 - 1)
            diag = torch.arange(r0, max(r0, min(r1, k)), device=dev)
            l[diag - r0, diag] = 1.0
            d = l @ u[:k]
            del l
            d -= a[:, c0:c1].index_select(0, perm[r0:r1]).to(dev, torch.float64)
            sq += float(torch.linalg.vector_norm(d)) ** 2
            mx = max(mx, float(d.abs().max()))
            del d
        del u
    a_sq, a_max = 0.0, 0.0
    for r0 in range(0, n, rows):
        blk = a[r0:r0 + rows].to(torch.float64)
        a_sq += float(torch.linalg.vector_norm(blk)) ** 2
        a_max = max(a_max, float(blk.abs().max()))
    nbe = sq ** 0.5 / (n * a_sq ** 0.5)
    return nbe, mx / a_max


def _round_(x: torch.Tensor, dtype, rows: int = 4096) -> torch.Tensor:
    """Round ``x`` to ``dtype`` and back, in place, ``rows`` rows at a time
    (so the temporaries stay small).  An fp8 format is scaled per tensor
    so that ``x``'s largest magnitude lands on its largest finite value, as
    fp8 GEMM operands are; wider formats are rounded as they are."""
    scale = None
    if dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        amax = max((float(x[r:r + rows].abs().max()) for r in range(0, x.shape[0], rows)),
                   default=0.0)
        if amax == 0.0:
            return x
        scale = torch.finfo(dtype).max / amax
    for r in range(0, x.shape[0], rows):
        blk = x[r:r + rows]
        if scale is None:
            blk.copy_(blk.to(dtype))
        else:
            blk.copy_((blk * scale).to(dtype).to(blk.dtype) / scale)
    return x


@contextlib.contextmanager
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def lu_plain(a: torch.Tensor, block: int, store: str = "float64",
             operands: str | None = None, cols: int = 8192) -> Answer:
    """Right-looking blocked LU with partial pivoting of the square ``a``
    in plain PyTorch.  Arithmetic is fp64 for ``store="float64"`` and
    IEEE fp32 otherwise (TF32 off); every stored value is rounded to
    ``store`` where it is written, and the trailing update's operands L21
    and U12 to ``operands`` (default: as stored).  Per block column: the
    panel by ``torch.linalg.lu_factor_ex``, its row swaps applied to the
    other columns, U12 = L11^-1 A12 by a triangular solve, then A22 -= L21
    U12 in slices of ``cols`` columns (so the temporaries stay small)."""
    n = a.shape[0]
    st = DTYPES[store]
    op = DTYPES[operands] if operands else st
    w = _round_(a.to(torch.float64 if st == torch.float64 else torch.float32, copy=True), st)
    dev = w.device
    ipiv = torch.empty(n, dtype=torch.int32, device=dev)
    info = 0
    perm = list(range(n))
    with _no_tf32():
        for k in range(0, n, block):
            e = min(n, k + block)
            lu_p, piv, inf = torch.linalg.lu_factor_ex(w[k:, k:e])
            if info == 0 and int(inf) > 0:
                info = k + int(inf)
            ipiv[k:e] = piv.to(torch.int32) + k
            local = list(range(k, n))
            for i, p in enumerate((piv - 1).tolist()):
                local[i], local[p] = local[p], local[i]
            moved = [i for i, src in enumerate(local, start=k) if src != i]
            if moved:
                dst = torch.tensor(moved, device=dev)
                w[dst] = w[torch.tensor([local[i - k] for i in moved], device=dev)]
                srcs = [perm[local[i - k]] for i in moved]
                for i, s in zip(moved, srcs):
                    perm[i] = s
            w[k:, k:e] = _round_(lu_p, st)
            if e == n:
                break
            u12 = torch.linalg.solve_triangular(w[k:e, k:e], w[k:e, e:], upper=False,
                                                unitriangular=True)
            w[k:e, e:] = _round_(u12, st)
            l21 = _round_(w[e:, k:e].clone(), op)
            u12 = _round_(w[k:e, e:].clone(), op)
            for c0 in range(e, n, cols):
                c1 = min(n, c0 + cols)
                blk = w[e:, c0:c1]
                blk.addmm_(l21, u12[:, c0 - e:c1 - e], alpha=-1.0)
                _round_(blk, st)
    return Answer(lu=w, ipiv=ipiv, info=torch.tensor(info, dtype=torch.int32),
                  perm=torch.tensor(perm, dtype=torch.int32, device=dev))
