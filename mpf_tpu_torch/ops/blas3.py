"""Triangular inverses for the outer U12 (port of `mpf_tpu/ops/blas3.py`).

* :func:`unit_lower_inv` / :func:`upper_inv` — plain triangular inverses
  (the JAX package's ``triangular_solve`` forms).
* :func:`unit_lower_inv_blocked` — the log-depth recursive inverse
  ``inv([[A, 0], [B, C]]) = [[inv(A), 0], [-inv(C) B inv(A), inv(C)]]``.
  Its leaves (<= 128 x 128) are kernel 5 (``csrc/tri_inv.cu``), all leaves
  of one call in a single launch; the recursion's products stay
  ``torch.matmul``, as the JAX package leaves them to XLA, in IEEE fp32
  (TF32 off).
"""

from __future__ import annotations

import contextlib

import torch

from mpf_tpu_torch.ops import _lib


@contextlib.contextmanager
def ieee_fp32():
    """Run fp32 matmuls in full IEEE fp32 (no TF32) on the card, restoring
    the previous setting afterwards."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def unit_lower_inv(l11: torch.Tensor) -> torch.Tensor:
    """Inverse of the unit-lower-triangular block whose strictly-lower part
    is ``l11``'s (the diagonal of ``l11`` is ignored)."""
    r = l11.shape[0]
    eye = torch.eye(r, dtype=l11.dtype, device=l11.device)
    l = torch.tril(l11, -1) + eye
    return torch.linalg.solve_triangular(l, eye, upper=False, unitriangular=True)


def upper_inv(u11: torch.Tensor) -> torch.Tensor:
    """Inverse of the upper-triangular block."""
    r = u11.shape[0]
    eye = torch.eye(r, dtype=u11.dtype, device=u11.device)
    return torch.linalg.solve_triangular(torch.triu(u11), eye, upper=True)


def _leaves(n: int, base: int, o: int = 0) -> list[tuple[int, int]]:
    """Diagonal leaf blocks (offset, size) of the recursion, in order."""
    if n <= base:
        return [(o, n)]
    h = (n // 2 + base - 1) // base * base  # split at a multiple of base
    if h >= n:
        return [(o, n)]
    return _leaves(h, base, o) + _leaves(n - h, base, o + h)


def tri_inv_leaves_plain(l: torch.Tensor, leaves) -> torch.Tensor:
    """Plain version of kernel 5: Gauss-Jordan inverse of each unit-lower
    leaf of ``l`` (strictly-lower entries are the multipliers), written at
    the leaf's diagonal position of a zero matrix.  Same operations, in the
    same order, as `mpf_tpu/ops/panel_pallas.py:_tri_inv_kernel`."""
    _lib.counted_plain("tri_inv")
    out = torch.zeros_like(l)
    for o, s in leaves:
        blk = l[o:o + s, o:o + s]
        rows = torch.arange(s, device=l.device)
        li = torch.eye(s, dtype=l.dtype, device=l.device)
        for j in range(s):
            mult = torch.where(rows > j, blk[:, j], torch.zeros((), dtype=l.dtype,
                                                                  device=l.device))
            li = _lib.fms(li, mult[:, None], li[j][None, :])
        out[o:o + s, o:o + s] = li
    return out


def tri_inv_leaves(l: torch.Tensor, leaves) -> torch.Tensor:
    """Kernel 5 wrapper: the inverses of the unit-lower leaves ``leaves``
    ((offset, size), size <= 128) of the square fp32 ``l``, each at its
    diagonal position of the returned matrix (entries outside the leaves are
    undefined on the card, zero on the CPU).  CPU tensors take the plain
    version; CUDA tensors launch the kernel (one block per leaf)."""
    if not _lib.on_cuda(l):
        return tri_inv_leaves_plain(l, leaves)
    _lib.check(l.dtype == torch.float32 and l.dim() == 2 and l.stride(1) == 1,
               "tri_inv: l must be a row-major fp32 matrix")
    sizes = [s for _, s in leaves]
    _lib.check(max(sizes) <= 128, "tri_inv: leaves must be <= 128 wide")
    meta = torch.tensor([o for o, _ in leaves] + sizes, dtype=torch.int32).to(l.device)
    out = torch.empty(l.shape, dtype=l.dtype, device=l.device)
    nl = len(leaves)
    _lib.call("mpf_tri_inv", nl, max(sizes), l.data_ptr(), l.stride(0),
              meta.data_ptr(), meta[nl:].data_ptr(), out.data_ptr(), out.stride(0))
    _lib.counted_launch("tri_inv")
    return out


def unit_lower_inv_blocked(l11: torch.Tensor, base: int = 128) -> torch.Tensor:
    """Inverse of a unit-lower-triangular block by recursive 2x2 block
    partitioning; the <= ``base`` leaves come from one kernel-5 call."""
    n = l11.shape[0]
    leaves = _leaves(n, base)
    inv = tri_inv_leaves(l11, leaves)

    def rec(o: int, s: int) -> torch.Tensor:
        if s <= base:
            return inv[o:o + s, o:o + s]
        h = (s // 2 + base - 1) // base * base
        if h >= s:
            return inv[o:o + s, o:o + s]
        ai = rec(o, h)
        ci = rec(o + h, s - h)
        bmat = l11[o + h:o + s, o:o + h]
        with ieee_fp32():
            x = -(ci @ (bmat @ ai))
        out = torch.zeros((s, s), dtype=l11.dtype, device=l11.device)
        out[:h, :h] = ai
        out[h:, :h] = x
        out[h:, h:] = ci
        return out

    return rec(0, n)
