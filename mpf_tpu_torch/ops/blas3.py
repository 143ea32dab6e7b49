"""Triangular inverses, TRSMs and the trailing update (port of
`mpf_tpu/ops/blas3.py`).

* :func:`unit_lower_inv` / :func:`upper_inv` — plain triangular inverses
  (the JAX package's ``triangular_solve`` forms; on bf16 blocks the
  algorithm XLA expands its bf16 ``triangular_solve`` into, bit for bit on
  the CPU, since PyTorch's ``solve_triangular`` takes no bf16).
* :func:`trsm_u12` / :func:`trsm_l21` / :func:`trailing_update` — the
  reference's cuBLAS TRSM and GEMM calls (`MPF.cu:215-239`), each as an
  inverse GEMM (``use_inv=True``) or a ``solve_triangular``, fp32 products
  in IEEE fp32.
* :func:`unit_lower_inv_blocked` — the log-depth recursive inverse
  ``inv([[A, 0], [B, C]]) = [[inv(A), 0], [-inv(C) B inv(A), inv(C)]]``.
  Its leaves (<= 128 x 128) are kernel 5 (``csrc/tri_inv.cu``), all leaves
  of one call in a single launch; the recursion's products stay
  ``torch.matmul``, as the JAX package leaves them to XLA, in IEEE fp32
  (TF32 off) on operands upcast to fp32 — for bf16 blocks the inner
  product is kept in fp32 and the result rounded to bf16 once, as the JAX
  recursion does (`mpf_tpu/ops/blas3.py:79-85`), never a bf16 cuBLAS
  product.
* :func:`u12_product` — the trailing update's U12 = L11^{-1} A12 under
  bf16 storage: kernel 17 (``csrc/u12.cu``, the store instance of kernel
  6's Hopper routine) on the card, fp32 sums of the exact bf16 products
  rounded once to bf16.
"""

from __future__ import annotations

import contextlib
import functools

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


def _tri_inv_bf16(t: torch.Tensor, lower: bool) -> torch.Tensor:
    """Inverse of the triangular bf16 block ``t`` (already masked; unit
    diagonal for the lower case) the way XLA expands a bf16
    ``triangular_solve`` against the identity (`InvertDiagonalBlocks`):
    columns scaled by the diagonal and rounded to bf16; rows of the
    inverse one at a time from the first (lower) or last (upper), each an
    fp32 vector-matrix product rounded to bf16; rows then divided by the
    diagonal and rounded to bf16.  Plain PyTorch on the tensor's device."""
    r = t.shape[0]
    bf = torch.bfloat16
    f = t.float()
    d = torch.diagonal(f).clone()
    d = torch.where(d == 0, torch.ones_like(d), d)
    scaled = (f / d[None, :]).to(bf).float()
    out = -torch.eye(r, dtype=torch.float32, device=t.device)
    first = 0 if lower else r - 1
    out[first, first] = 1.0
    with ieee_fp32():
        for i in range(1, r):
            j = i if lower else r - 1 - i
            out[j:j + 1] = -((scaled[j:j + 1] @ out).to(bf).float())
    return (out / d[:, None]).to(bf)


def unit_lower_inv(l11: torch.Tensor) -> torch.Tensor:
    """Inverse of the unit-lower-triangular block whose strictly-lower part
    is ``l11``'s (the diagonal of ``l11`` is ignored)."""
    r = l11.shape[0]
    eye = torch.eye(r, dtype=l11.dtype, device=l11.device)
    l = torch.tril(l11, -1) + eye
    if l11.dtype == torch.bfloat16:
        return _tri_inv_bf16(l, lower=True)
    return torch.linalg.solve_triangular(l, eye, upper=False, unitriangular=True)


def upper_inv(u11: torch.Tensor) -> torch.Tensor:
    """Inverse of the upper-triangular block."""
    r = u11.shape[0]
    if u11.dtype == torch.bfloat16:
        return _tri_inv_bf16(torch.triu(u11), lower=False)
    eye = torch.eye(r, dtype=u11.dtype, device=u11.device)
    return torch.linalg.solve_triangular(torch.triu(u11), eye, upper=True)


def matmul_in(x: torch.Tensor, y: torch.Tensor, dtype) -> torch.Tensor:
    """``x @ y`` with operands rounded to ``dtype`` and fp32 accumulation
    (IEEE fp32 on the card, never TF32), returned in fp32."""
    with ieee_fp32():
        return x.to(dtype).float() @ y.to(dtype).float()


def u12_product_plain(linv: torch.Tensor, a12: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`u12_product`: the IEEE fp32 product of the
    operands rounded to bf16, rounded once to bf16."""
    _lib.counted_plain("u12_product")
    return matmul_in(linv, a12, torch.bfloat16).to(torch.bfloat16)


def u12_product(linv: torch.Tensor, a12: torch.Tensor) -> torch.Tensor:
    """U12 = ``linv`` @ ``a12`` as a new (kw, w) bf16 tensor: the products of
    the bf16 operands (each exact in fp32) summed in fp32 and rounded once.
    ``linv`` is the (kw, kw) unit-lower-triangular L11^{-1}, ``a12`` a (kw,
    w) view of a row-major bf16 matrix.

    CPU tensors take the plain version; CUDA tensors launch kernel 17, which
    reads ``linv`` only at and left of each 128-row tile's diagonal block
    (the rest is zero) and sums each entry in ascending 64-deep steps on
    the tensor cores.  Its result is stored by TMA, so its rows are padded
    to a multiple of 8 entries: for a ragged w the returned tensor is the
    (kw, w) view of a (kw, ceil8(w)) buffer, which TMA-fed kernels take
    as it is.  Operands that TMA cannot read in place are copied first
    (:func:`_lib.gemm_operand`)."""
    if not _lib.on_cuda(linv, a12):
        return u12_product_plain(linv, a12)
    kw, w = a12.shape
    _lib.check(linv.shape == (kw, kw), f"u12_product: linv shape {tuple(linv.shape)} "
               f"!= ({kw}, {kw})")
    _lib.check(linv.dtype == torch.bfloat16 and a12.dtype == torch.bfloat16,
               "u12_product: linv and a12 must be bf16")
    _lib.check(linv.stride(1) == 1 and a12.stride(1) == 1,
               "u12_product: linv and a12 must be row-major")
    out = torch.empty((kw, -(-w // 8) * 8), dtype=torch.bfloat16, device=a12.device)
    l, b = _lib.gemm_operand(linv), _lib.gemm_operand(a12)
    _lib.call("mpf_u12_product", kw, w, l.data_ptr(), l.stride(0), b.data_ptr(), b.stride(0),
              out.data_ptr(), out.stride(0))
    _lib.counted_launch("u12_product")
    return out[:, :w]


def trsm_u12(lu11: torch.Tensor, a12: torch.Tensor, policy=None,
             use_inv: bool = True) -> torch.Tensor:
    """U12 = L11^{-1} A12 with L11 the unit-lower part of the packed block
    (``policy`` is accepted for the JAX signature; the solve is fp32)."""
    if use_inv:
        return matmul_in(unit_lower_inv(lu11), a12, torch.float32).to(a12.dtype)
    r = lu11.shape[0]
    l = torch.tril(lu11, -1) + torch.eye(r, dtype=lu11.dtype, device=lu11.device)
    return torch.linalg.solve_triangular(l, a12, upper=False, unitriangular=True)


def trsm_l21(lu11: torch.Tensor, a21: torch.Tensor, policy=None,
             use_inv: bool = True) -> torch.Tensor:
    """L21 = A21 U11^{-1} with U11 the upper part of the packed block."""
    if use_inv:
        return matmul_in(a21, upper_inv(lu11), torch.float32).to(a21.dtype)
    return torch.linalg.solve_triangular(torch.triu(lu11), a21, upper=True, left=False)


def trailing_update(a22: torch.Tensor, l21: torch.Tensor, u12: torch.Tensor,
                    policy) -> torch.Tensor:
    """A22 - L21 @ U12 with the operands rounded to ``policy.gemm_in`` and
    fp32 accumulation (returns a new tensor)."""
    prod = matmul_in(l21, u12, policy.gemm_in)
    return (a22.float() - prod).to(a22.dtype)


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
    same order, as `mpf_tpu/ops/panel_pallas.py:_tri_inv_kernel`, with the
    round points of ``_lib.sub_mul`` (fp32 or bf16 leaves)."""
    _lib.counted_plain("tri_inv")
    out = torch.zeros_like(l)
    for o, s in leaves:
        blk = l[o:o + s, o:o + s]
        rows = torch.arange(s, device=l.device)
        li = torch.eye(s, dtype=l.dtype, device=l.device)
        for j in range(s):
            mult = torch.where(rows > j, blk[:, j], torch.zeros((), dtype=l.dtype,
                                                                  device=l.device))
            li = _lib.sub_mul(li, mult[:, None], li[j][None, :])
        out[o:o + s, o:o + s] = li
    return out


@functools.lru_cache(maxsize=64)
def _leaf_meta(leaves: tuple, device: torch.device) -> torch.Tensor:
    """Kernel 5's leaf table on ``device``: the offsets, then the sizes
    (int32).  Kept, so that a factorization copies it to the card once per
    leaf list, not once per block column."""
    return torch.tensor([o for o, _ in leaves] + [s for _, s in leaves],
                        dtype=torch.int32).to(device)


def tri_inv_leaves(l: torch.Tensor, leaves) -> torch.Tensor:
    """Kernel 5 wrapper: the inverses of the unit-lower leaves ``leaves``
    ((offset, size), size <= 128) of the square fp32 or bf16 ``l``, each at
    its diagonal position of the returned matrix (entries outside the
    leaves are undefined on the card, zero on the CPU).  CPU tensors take
    the plain version; CUDA tensors launch the kernel (one launch for all
    the leaves: each leaf's columns are independent forward substitutions,
    spread over blocks of 8 columns)."""
    if not _lib.on_cuda(l):
        return tri_inv_leaves_plain(l, leaves)
    _lib.check(l.dtype in (torch.float32, torch.bfloat16) and l.dim() == 2
               and l.stride(1) == 1, "tri_inv: l must be a row-major fp32 or bf16 matrix")
    leaves = tuple((int(o), int(s)) for o, s in leaves)
    widest = max(s for _, s in leaves)
    _lib.check(widest <= 128, "tri_inv: leaves must be <= 128 wide")
    meta = _leaf_meta(leaves, l.device)
    out = torch.empty(l.shape, dtype=l.dtype, device=l.device)
    nl = len(leaves)
    _lib.call("mpf_tri_inv", nl, widest, l.data_ptr(), l.stride(0),
              meta.data_ptr(), meta.data_ptr() + 4 * nl, out.data_ptr(), out.stride(0),
              int(l.dtype == torch.bfloat16))
    _lib.counted_launch("tri_inv")
    return out


def _inv_rec(l11: torch.Tensor, inv: torch.Tensor, base: int, o: int, s: int) -> torch.Tensor:
    """The recursion of :func:`unit_lower_inv_blocked` on the diagonal
    block (o, s).  A module function, not a closure: a closure that calls
    itself is a reference cycle, which would keep ``l11`` (a view of the
    whole working matrix) alive until Python's cyclic collector ran."""
    if s <= base:
        return inv[o:o + s, o:o + s]
    h = (s // 2 + base - 1) // base * base
    if h >= s:
        return inv[o:o + s, o:o + s]
    ai = _inv_rec(l11, inv, base, o, h)
    ci = _inv_rec(l11, inv, base, o + h, s - h)
    bmat = l11[o + h:o + s, o:o + h]
    with ieee_fp32():
        x = (-(ci.float() @ (bmat.float() @ ai.float()))).to(l11.dtype)
    out = torch.zeros((s, s), dtype=l11.dtype, device=l11.device)
    out[:h, :h] = ai
    out[h:, :h] = x
    out[h:, h:] = ci
    return out


def unit_lower_inv_blocked(l11: torch.Tensor, base: int = 128) -> torch.Tensor:
    """Inverse of a unit-lower-triangular block by recursive 2x2 block
    partitioning; the <= ``base`` leaves come from one kernel-5 call."""
    n = l11.shape[0]
    inv = tri_inv_leaves(l11, _leaves(n, base))
    return _inv_rec(l11, inv, base, 0, n)
