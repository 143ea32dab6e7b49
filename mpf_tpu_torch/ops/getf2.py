"""Unblocked panel LU, plain PyTorch (port of `mpf_tpu/ops/getf2.py`).

* :func:`panel_pivots` / :func:`panel_pivots_perm` — the low-precision
  pre-pivoting panel LU (the reference's `HGETF2_kernel`): partial-pivoted
  LU of an (m, r) panel in its own dtype whose factors are discarded; only
  the pivots (and the composed row map) escape.  :func:`panel_pivots_perm`
  is also the plain version of kernel 7 (``csrc/hgetf2.cu``).
* :func:`getf2_npv` — the working-precision no-pivot LU with a LAPACK-style
  zero-pivot ``info``; its fp32 elimination is the plain version of kernel
  8's (``csrc/npv.cu``); on a bf16 block (ALL_BF16's masked path, which
  the JAX package leaves to XLA ops) it is the port itself, on any device.
* :func:`getf2_pivoted` — partial-pivoted LU keeping the factors.

Round points, probed bitwise against the JAX package's jitted functions on
the CPU (they decide the pivots): multipliers are an fp32 divide rounded to
the panel dtype; the rank-1 update ``p - m * u`` (``_lib.sub_mul``; the
same for ``getf2_npv`` on a bf16 block) is

* bf16: the product rounded to bf16, then the difference rounded to bf16;
* fp16: the exact difference rounded once to fp16 (``_lib.f16_rn``);
* fp32: one fused multiply-add (XLA's CPU backend contracts it).

Pivot ties go to the lowest row (``torch.argmax`` returns the first
maximum, as ``jnp.argmax`` does).
"""

from __future__ import annotations

import torch

from mpf_tpu_torch.ops import _lib


def _pivot_loop(p: torch.Tensor, off: int, ncols: int, perm=None):
    """The column loop shared by :func:`panel_pivots` and
    :func:`panel_pivots_perm`: returns ``(piv, perm)`` (int64)."""
    m, r = p.shape
    dev = p.device
    p = p.clone()
    rows = torch.arange(m, device=dev)
    cols = torch.arange(r, device=dev)
    piv = torch.arange(r, device=dev) + off
    neg = torch.full((), -1.0, device=dev)
    one = torch.ones((), device=dev)
    zero = torch.zeros((), device=dev)
    for j in range(ncols):
        d = off + j
        colv = torch.where(rows >= d, p[:, j].float().abs(), neg)
        pj = int(torch.argmax(colv))
        piv[j] = pj
        if pj != d:
            p[[d, pj]] = p[[pj, d]]
            if perm is not None:
                perm[[d, pj]] = perm[[pj, d]]
        pivval = p[d, j].float()
        safe = torch.where(pivval == 0, one, pivval)
        mult = torch.where(rows > d, p[:, j].float() / safe, zero).to(p.dtype)
        urow = torch.where(cols > j, p[d], torch.zeros((), dtype=p.dtype, device=dev))
        p = _lib.sub_mul(p, mult[:, None], urow[None, :])
        p[:, j] = torch.where(rows > d, mult, p[:, j])
    return piv, perm


def panel_pivots(panel: torch.Tensor, ncols: int | None = None,
                 row_offset: int = 0) -> torch.Tensor:
    """Partial-pivoted LU of the (m, r) ``panel`` in its own dtype; returns
    only the 0-based pivot rows (r,) int32.  ``ncols`` limits the loop to
    the first columns (later entries stay the identity, ``row_offset + j``);
    ``row_offset`` places the diagonal at row ``row_offset`` (rows above it
    are frozen)."""
    ncols = panel.shape[1] if ncols is None else ncols
    piv, _ = _pivot_loop(panel, int(row_offset), ncols)
    return piv.to(torch.int32)


def panel_pivots_perm(panel: torch.Tensor, row_offset: int = 0,
                      ncols: int | None = None, prev_perm=None):
    """Like :func:`panel_pivots`, and also carries the row map: returns
    ``(piv, perm)`` with ``X_new[i] = X_old[perm[i]]`` for the panel's
    sequential swaps, and with ``prev_perm`` (m,) also the composed map
    ``prev_perm[perm]`` — ``(piv, perm, composed)``, all int32."""
    m, r = panel.shape
    ncols = r if ncols is None else ncols
    perm = torch.arange(m, device=panel.device)
    piv, perm = _pivot_loop(panel, int(row_offset), ncols, perm)
    piv, perm32 = piv.to(torch.int32), perm.to(torch.int32)
    if prev_perm is not None:
        return piv, perm32, prev_perm.to(torch.int32)[perm]
    return piv, perm32


def npv_step(b: torch.Tensor, j: int, info: torch.Tensor):
    """Column ``j`` of the no-pivot elimination of ``b``: multipliers below
    the diagonal (true divide, rounded to ``b``'s dtype; a zero pivot
    divides by 1 and sets ``info`` if unset), ``b - m u`` right of column j
    with the round points of ``_lib.sub_mul`` (fp32: rounded once), the
    multipliers stored in column j.  Returns ``(b, mult (m, 1), info)``."""
    m, r = b.shape
    dev = b.device
    rows = torch.arange(m, device=dev)[:, None]
    cols = torch.arange(r, device=dev)[None, :]
    zero = torch.zeros((), dtype=b.dtype, device=dev)
    pivval = b[j, j]
    info = torch.where((pivval == 0) & (info == 0), torch.full_like(info, j + 1), info)
    safe = torch.where(pivval == 0, torch.ones_like(pivval), pivval)
    mult = torch.where(rows > j, b[:, j:j + 1] / safe, zero)
    urow = torch.where(cols > j, b[j:j + 1, :], zero)
    b = torch.where((cols == j) & (rows > j), mult, _lib.sub_mul(b, mult, urow))
    return b, mult, info


def getf2_npv(block: torch.Tensor, ncols: int | None = None):
    """No-pivot unblocked LU of the (m, r) ``block`` in its dtype: returns
    ``(packed LU, info)``, ``info`` the 1-based column of the first exactly
    zero pivot (0 when clean) as an int32 scalar tensor."""
    ncols = block.shape[1] if ncols is None else ncols
    b = block.clone()
    info = torch.zeros((), dtype=torch.int32, device=block.device)
    for j in range(ncols):
        b, _, info = npv_step(b, j, info)
    return b, info


def getf2_pivoted(a: torch.Tensor, ncols: int | None = None):
    """Unblocked partial-pivoted LU keeping the factors (LAPACK getf2):
    returns ``(packed LU, local 0-based pivots int32, info)``."""
    m, r = a.shape
    ncols = r if ncols is None else ncols
    dev = a.device
    b = a.clone()
    rows = torch.arange(m, device=dev)
    piv = torch.arange(r, dtype=torch.int32, device=dev)
    info = torch.zeros((), dtype=torch.int32, device=dev)
    neg = torch.full((), -1.0, device=dev)
    for j in range(ncols):
        colv = torch.where(rows >= j, b[:, j].float().abs(), neg)
        pj = int(torch.argmax(colv))
        piv[j] = pj
        if pj != j:
            b[[j, pj]] = b[[pj, j]]
        b, _, info = npv_step(b, j, info)
    return b, piv, info
