"""Correctness oracle: P*L*U reconstruction + normwise backward error.

Host functions are numpy copies of `mpf_tpu/utils/oracle.py` (the
reference's test methodology, `benchmark.cpp:59-144`).
:func:`check_factorization_device` rebuilds P*L*U in fp64 on the tensor's
own device: at n=16384 the host rebuild is ~9 TFLOP of fp64 CPU work, while
the card does it in seconds.  The oracle is a check, not part of the
factorization path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def split_lu(lu: np.ndarray):
    """Packed LU -> (unit-diagonal L, U).  (`benchmark.cpp:59-75`)"""
    lu = np.asarray(lu, dtype=np.float64)
    l = np.tril(lu, -1) + np.eye(lu.shape[0])
    u = np.triu(lu)
    return l, u


def apply_ipiv_inverse(m: np.ndarray, ipiv: np.ndarray) -> np.ndarray:
    """Re-apply the pivot swaps in reverse order (i = n-1 .. 0), turning
    L@U into P*L*U (`row_permute`, `benchmark.cpp:84-95`).  ``ipiv`` is
    1-based global, LAPACK convention."""
    m = np.array(m, dtype=np.float64, copy=True)
    n = m.shape[0]
    ipiv = np.asarray(ipiv)
    for i in range(n - 1, -1, -1):
        p = int(ipiv[i]) - 1
        if p != i:
            m[[i, p], :] = m[[p, i], :]
    return m


def reconstruct(lu: np.ndarray, ipiv: np.ndarray) -> np.ndarray:
    """P * L * U from a packed factorization — should equal the original A."""
    l, u = split_lu(lu)
    return apply_ipiv_inverse(l @ u, ipiv)


@dataclasses.dataclass
class OracleReport:
    n: int
    max_abs_err: float          # reference metric (`benchmark.cpp:97-104`)
    normwise_backward_err: float  # ||PLU - A||_F / (n ||A||_F)
    ok: bool

    def __str__(self) -> str:
        return (
            f"n={self.n} max|PLU-A|={self.max_abs_err:.3e} "
            f"nbe={self.normwise_backward_err:.3e} ok={self.ok}"
        )


def check_factorization(
    a: np.ndarray,
    lu: np.ndarray,
    ipiv: np.ndarray,
    nbe_tol: float = 1e-5,
) -> OracleReport:
    """Host fp64 oracle; ``nbe_tol`` gates the normwise backward error."""
    a = np.asarray(a, dtype=np.float64)
    n = a.shape[0]
    plu = reconstruct(lu, ipiv)
    diff = plu - a
    max_abs = float(np.max(np.abs(diff))) if n else 0.0
    a_norm = float(np.linalg.norm(a))
    nbe = float(np.linalg.norm(diff) / (n * a_norm)) if n and a_norm > 0 else 0.0
    return OracleReport(n=n, max_abs_err=max_abs, normwise_backward_err=nbe, ok=nbe <= nbe_tol)


def ipiv_to_perm(ipiv: torch.Tensor) -> torch.Tensor:
    """Compose the sequential 1-based ``ipiv`` swaps into the row map
    ``perm`` with ``(P A)[i] = A[perm[i]]`` (host loop over n swaps)."""
    piv = ipiv.detach().cpu().numpy().astype(np.int64) - 1
    perm = np.arange(piv.shape[0])
    for i, p in enumerate(piv):
        if p != i:
            perm[i], perm[p] = perm[p], perm[i]
    return torch.from_numpy(perm)


def check_factorization_device(
    a: torch.Tensor,
    lu: torch.Tensor,
    ipiv: torch.Tensor,
    nbe_tol: float = 1e-5,
    chunk: int = 4096,
) -> OracleReport:
    """Same oracle as :func:`check_factorization`, computed in fp64 on
    ``lu``'s device: P*L*U is rebuilt row-chunk by row-chunk (L rows times
    U in fp64), so peak extra memory is one fp64 U plus one chunk."""
    dev = lu.device
    n = lu.shape[0]
    perm = ipiv_to_perm(ipiv).to(dev)
    u = torch.triu(lu.to(torch.float64))
    sq_diff = 0.0
    max_abs = 0.0
    a_norm_sq = 0.0
    for r0 in range(0, n, chunk):
        r1 = min(n, r0 + chunk)
        # strictly-lower part of rows r0..r1, then the unit diagonal
        lrows = torch.tril(lu[r0:r1].to(torch.float64), diagonal=r0 - 1)
        idx = torch.arange(r0, r1, device=dev)
        lrows[idx - r0, idx] = 1.0
        lu_rows = lrows @ u
        arows = a[perm[r0:r1].to(a.device)].to(dev, torch.float64)
        d = lu_rows - arows
        sq_diff += float((d * d).sum())
        max_abs = max(max_abs, float(d.abs().max()))
        a_norm_sq += float((arows * arows).sum())
    nbe = (sq_diff ** 0.5) / (n * a_norm_sq ** 0.5) if n and a_norm_sq > 0 else 0.0
    return OracleReport(n=n, max_abs_err=max_abs, normwise_backward_err=nbe,
                        ok=nbe <= nbe_tol)
