"""LASWP-style row interchanges, plain PyTorch (port of
`mpf_tpu/ops/pivoting.py`).

The reference's `LASWP_kernel` applies a panel's swaps to full matrix rows
one after another; sequential swaps are not a plain permutation when pivot
targets collide.  Here the swaps are composed into a row map first, and the
rows that move are exchanged with one bounded gather and scatter.  The
blocked factorization's exchange is kernel 9 (:func:`ops.panel_pallas.laswp_apply`);
these functions serve small problems, tests and the solve path.
"""

from __future__ import annotations

import torch

from mpf_tpu_torch.utils.oracle import ipiv_to_perm as _host_ipiv_to_perm


def swaps_to_row_map(piv_global: torch.Tensor, k: int, ncols: int,
                     window: int) -> torch.Tensor:
    """Compose the sequential swaps (rows ``k + j`` <-> ``piv_global[j]``,
    0-based, j < ncols) into a map over the window [k, k + window):
    ``A_new[k + i] = A_old[rowmap[i]]`` (global source rows, int32)."""
    rowmap = torch.arange(k, k + window, dtype=torch.int64)
    piv = piv_global.to("cpu", torch.int64)
    for j in range(ncols):
        s = int(piv[j]) - k
        rowmap[[j, s]] = rowmap[[s, j]]
    return rowmap.to(piv_global.device, torch.int32)


def apply_row_swaps(a: torch.Tensor, piv_global: torch.Tensor, k: int,
                    ncols: int) -> torch.Tensor:
    """Apply a panel's swaps to all columns of ``a``, moving only the rows
    that can move (the ncols destinations and the ncols pivot rows).
    Returns a new matrix."""
    n = a.shape[0]
    window = n - k
    rowmap = swaps_to_row_map(piv_global, k, ncols, window).long()
    dev = a.device
    dsts = torch.arange(ncols, device=dev)
    srcs = (piv_global[:ncols].long() - k).clamp(0, window - 1)
    cand = torch.cat([dsts, srcs])
    out = a.clone()
    out[cand + k] = a[rowmap[cand]]
    return out


def ipiv_to_perm(ipiv: torch.Tensor) -> torch.Tensor:
    """Compose LAPACK's sequential 1-based ``ipiv`` swaps into one row map:
    applying the swaps to X equals ``X[perm]`` (int32, on ipiv's device)."""
    return _host_ipiv_to_perm(ipiv).to(ipiv.device, torch.int32)


def apply_row_swaps_vector(b: torch.Tensor, ipiv: torch.Tensor,
                           perm: torch.Tensor | None = None) -> torch.Tensor:
    """Apply the factorization's swaps to a right-hand side (rows of an
    (n,) or (n, nrhs) tensor) — the forward permutation of getrs.  With the
    composed map ``perm`` (``MPFResult.perm``) this is one gather."""
    if perm is None:
        perm = ipiv_to_perm(ipiv)
    return b[perm.long()]
