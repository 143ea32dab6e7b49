"""Kernels 1 and 2's schedules on the CPU.

Kernel 2 (csrc/rowblock.cu) keeps the r x r block in registers: one
working tile W holds U in and right of the diagonal and L^{-1} left of it,
each step updates every column of the rows below the pivot against one
published pivot row (U right of j, L^{-1} up to j, 1 at j), and the
multipliers go to a second tile.  U^{-1} follows by back substitution, one
column per thread, rows from the bottom, each entry's chain in ascending k.
Plain mirrors of both schedules, with the kernels' single roundings
(``_lib.fms``), must give the bits of the earlier schedule (the block and
L^{-1} updated apart; U^{-1} row by row from the bottom, every column at
once) and of the plain versions the card holds the kernel to, and agree
with the JAX package's ``_npv_inv_values`` within 1e-5.

Kernel 1 (csrc/strip_pivots.cu) reduces 64-bit keys (|value| bits << 32 |
inverted position) over its rows in three levels (thread, warp, block) and
then over the G blocks' keys, one pass of one warp.  A plain mirror of that
reduction, over every split of m rows into G = 1..132 blocks, must pick
the plain version's pivot row, with ties in |value|, frozen and dead rows.
Inputs from numpy with fixed seeds."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpf_tpu.ops.panel_fused import _npv_inv_values  # noqa: E402

from mpf_tpu_torch.ops import _lib  # noqa: E402
from mpf_tpu_torch.ops.panel_fused import rowblock_assemble_plain  # noqa: E402
from mpf_tpu_torch.ops.panel_pallas import getf2_npv_inv_plain  # noqa: E402
from mpf_tpu_torch.ops.panel_strip import SENT  # noqa: E402
from mpf_tpu_torch.utils import matgen  # noqa: E402

SIZES = [1, 8, 48, 128]
CORPORA = ["hpl", "uniform"]
F32 = torch.float32


def _fma(acc, a, b):
    """fmaf(a, b, acc) on fp32 tensors, rounded once (``_lib.fms``)."""
    return _lib.fms(acc, -a, b)


def _block(corpus: str, r: int) -> torch.Tensor:
    """An (r, r) diagonal block: the leading block of an HPL-AI matrix
    (diagonally dominant) or of a uniform one (pivots of all sizes)."""
    n = max(r, 16)
    a = matgen.hpl_ai_matrix(n, seed=r) if corpus == "hpl" else matgen.random_dense(n, seed=r)
    return torch.from_numpy(np.ascontiguousarray(a[:r, :r])).to(F32)


# ------------------------------------------------------------------ kernel 2

def elim_tiles(blk: torch.Tensor):
    """Kernel 2's elimination: W (U right of and on the diagonal, L^{-1}
    left of it) and the multiplier tile, step by step against the
    published pivot row; returns (LU, L^{-1}, info)."""
    r = blk.shape[0]
    w = blk.clone()
    lm = torch.zeros_like(w)
    cols = torch.arange(r)
    info = 0
    for j in range(r):
        u = torch.where(cols == j, torch.ones(()), w[j])     # the published row
        pv = w[j, j]
        if pv == 0 and info == 0:
            info = j + 1
        safe = torch.ones(()) if pv == 0 else pv
        below = slice(j + 1, r)
        m = w[below, j] / safe                                 # true divides
        lm[below, j] = m
        start = w[below].clone()
        start[:, j] = 0.0                                      # L^{-1}[i][j] from its 0
        w[below] = _fma(start, -m[:, None], u[None, :])
    low = cols[None, :] < cols[:, None]
    lu = torch.where(low, lm, w)
    linv = torch.where(low, w, torch.eye(r))
    return lu, linv, info


def elim_apart(blk: torch.Tensor):
    """The earlier schedule: the block and L^{-1} updated apart (columns
    right of j of the block, columns up to j of L^{-1}), as the plain
    versions do."""
    r = blk.shape[0]
    b = blk.clone()
    li = torch.eye(r)
    cols = torch.arange(r)
    for j in range(r):
        pv = b[j, j]
        safe = torch.ones(()) if pv == 0 else pv
        below = slice(j + 1, r)
        m = b[below, j] / safe
        right = cols > j
        nb = _fma(b[below], -m[:, None], b[j][None, :])
        b[below] = torch.where(right[None, :], nb, b[below])
        b[below, j] = m
        nl = _fma(li[below], -m[:, None], li[j][None, :])
        li[below] = torch.where(~right[None, :], nl, li[below])
    return b, li


def uinv_rows(u: torch.Tensor) -> torch.Tensor:
    """The earlier U^{-1} schedule: row by row from the bottom, every
    column at once, each chain over every k > i in ascending order."""
    r = u.shape[0]
    y = torch.zeros((r, r))
    for i in range(r - 1, -1, -1):
        acc = torch.zeros(r)
        for k in range(i + 1, r):
            acc = _fma(acc, u[i, k], y[k])
        uii = u[i, i]
        safe = torch.ones(()) if uii == 0 else uii
        delta = (torch.arange(r) == i).to(F32)
        y[i] = (delta - acc) / safe
    return y


def uinv_columns(u: torch.Tensor, only_k_up_to_c: bool = False) -> torch.Tensor:
    """Kernel 2's U^{-1} schedule: thread c takes column c (32 of them a
    warp, in step), rows from the bottom, each chain in ascending k over
    every k > i — or, ``only_k_up_to_c``, over k <= c only (column c
    then reads only U's leading (c + 1) x (c + 1) block, final after step
    c; the dropped terms multiply a zero)."""
    r = u.shape[0]
    y = torch.zeros((r, r))
    for c0 in range(0, r, 32):
        cs = torch.arange(c0, min(c0 + 32, r))
        for i in range(r - 1, -1, -1):
            acc = torch.zeros(len(cs))
            for k in range(i + 1, r):
                nxt = _fma(acc, u[i, k], y[k, cs])
                acc = torch.where(cs >= k, nxt, acc) if only_k_up_to_c else nxt
            uii = u[i, i]
            safe = torch.ones(()) if uii == 0 else uii
            y[i, cs] = ((cs == i).to(F32) - acc) / safe
    return y


@pytest.mark.parametrize("corpus", CORPORA)
@pytest.mark.parametrize("r", SIZES)
def test_register_tile_elimination_is_bitwise_the_plain_versions(r, corpus):
    blk = _block(corpus, r)
    lu, linv, info = elim_tiles(blk)
    b, li = elim_apart(blk)
    assert torch.equal(lu, b) and torch.equal(linv, li)
    lu_p, li_p, _, info_p = getf2_npv_inv_plain(blk)
    assert torch.equal(lu, lu_p) and torch.equal(linv, li_p) and info == int(info_p) == 0
    # and the row block's plain version (kernel 2's yardstick on the card)
    glist = torch.arange(r, dtype=torch.int32)
    rb, _, info_r = rowblock_assemble_plain(blk, glist, 0)
    assert torch.equal(lu, rb) and int(info_r) == 0


@pytest.mark.parametrize("corpus", CORPORA)
@pytest.mark.parametrize("r", SIZES)
def test_column_schedule_is_bitwise_the_row_schedule(r, corpus):
    lu, _, _ = elim_tiles(_block(corpus, r))
    u = torch.triu(lu)
    want = uinv_rows(u)
    assert torch.equal(uinv_columns(u), want)
    # dropping the terms with k > c keeps every bit while U is finite
    assert torch.equal(uinv_columns(u, only_k_up_to_c=True), want)


@pytest.mark.parametrize("corpus", CORPORA)
@pytest.mark.parametrize("r", SIZES)
def test_schedules_match_jax_npv_inv_values(r, corpus):
    """Against `mpf_tpu/ops/panel_fused.py:_npv_inv_values` on the same
    block: LU and L^{-1} within 1e-5 of their largest entry (the same
    operations; XLA's CPU backend may contract them differently), U^{-1}
    within 1e-5 (its back substitution sums by a dot product)."""
    blk = _block(corpus, r)
    lu, linv, _ = elim_tiles(blk)
    y = uinv_columns(torch.triu(lu))
    fn = jax.jit(_npv_inv_values, static_argnums=1)
    jl, jli, jy, jinfo = (np.asarray(x) for x in fn(jnp.asarray(blk.numpy()), r))
    assert int(jinfo.ravel()[0]) == 0
    for got, want in ((lu, jl), (linv, jli), (y, jy)):
        scale = max(float(np.abs(want).max()), 1.0)
        assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale


def test_zero_pivot_info_and_finite_results():
    """An exactly-zero second pivot: info 2 in both schedules, which still
    agree bit for bit (the zero pivot divides by 1)."""
    blk = _block("uniform", 48)
    blk[1] = blk[0]
    lu, linv, info = elim_tiles(blk)
    b, li = elim_apart(blk)
    assert info == 2 and torch.equal(lu, b) and torch.equal(linv, li)
    u = torch.triu(lu)
    assert torch.equal(uinv_columns(u), uinv_rows(u))


# ------------------------------------------------------------------ kernel 1

def _keys(col: np.ndarray, pos: np.ndarray, d: int, quant16: bool) -> np.ndarray:
    """Kernel 1's 64-bit keys of one column (0 for rows that cannot pivot)."""
    bits = col.astype(np.float32).view(np.uint32) & np.uint32(0x7FFFFFFF)
    if quant16:
        bits &= np.uint32(0x7FFF0000)
    active = (pos != SENT) & (pos >= d)
    inv = (np.uint64(0xFFFFFFFF) - pos.astype(np.uint64)) & np.uint64(0xFFFFFFFF)
    keys = (bits.astype(np.uint64) << np.uint64(32)) | inv
    return np.where(active, keys, np.uint64(0))


def record_reduction(keys: np.ndarray, g_max: int):
    """Kernel 1's reduction of one column's keys with at most ``g_max``
    blocks: rows split as the launch splits them (rpb = ceil(m / g_max)
    rows a block, G = ceil(m / rpb) blocks), each block's key the largest
    of its rows' (its thread, warp and block maxima are maxima of maxima),
    then warp 0 over the G keys — lane t takes keys t, t + 32, ... (only a
    strictly larger key replaces), then a butterfly over the lanes.
    Returns (key, slab row), row -1 if no row can pivot."""
    m = keys.shape[0]
    rpb = -(-m // g_max)
    g = -(-m // rpb)
    padded = np.zeros(g * rpb, dtype=np.uint64)
    padded[:m] = keys
    blocks = padded.reshape(g, rpb)
    bkeys = blocks.max(axis=1)
    brow = np.arange(g) * rpb + blocks.argmax(axis=1)
    lane_key = [np.uint64(0)] * 32
    lane_blk = [0] * 32
    for t in range(32):
        for b in range(t, g, 32):
            if bkeys[b] > lane_key[t]:
                lane_key[t], lane_blk[t] = bkeys[b], b
    o = 16
    while o:
        nk, nb = list(lane_key), list(lane_blk)
        for t in range(32):
            if lane_key[t ^ o] > lane_key[t]:
                nk[t], nb[t] = lane_key[t ^ o], lane_blk[t ^ o]
        lane_key, lane_blk = nk, nb
        o >>= 1
    assert len(set(lane_key)) == 1
    key = lane_key[0]
    return key, (int(brow[lane_blk[0]]) if key else -1)


def _plain_pivot_row(col: np.ndarray, pos: np.ndarray, d: int, quant16: bool) -> int:
    """The plain version's choice (`ops/panel_strip.py`): argmax of the
    int64 key, -1 for rows that cannot pivot."""
    bits = torch.from_numpy(col.astype(np.float32)).view(torch.int32).to(torch.int64)
    bits &= 0x7FFF0000 if quant16 else 0x7FFFFFFF
    p64 = torch.from_numpy(pos.astype(np.int64))
    active = (p64 != SENT) & (p64 >= d)
    key = torch.where(active, bits * 2**32 + (2**32 - 1 - p64), torch.full_like(p64, -1))
    return int(torch.argmax(key))


@pytest.mark.parametrize("quant16", [True, False], ids=["quant16", "exact"])
@pytest.mark.parametrize("m", [1000, 4099])
def test_record_reduction_picks_the_plain_pivot(m, quant16):
    """Every G = 1..132: ties in |value| (values on a coarse grid, signs
    mixed), frozen rows (position below d) and dead rows."""
    rng = np.random.default_rng(m + quant16)
    col = (rng.integers(-6, 7, m) * 0.25).astype(np.float32)
    col[rng.random(m) < 0.3] *= 1.0 + 2.0 ** -12   # equal under quant16 only
    pos = rng.permutation(m).astype(np.int64)
    pos[rng.random(m) < 0.1] = SENT
    d = m // 3
    keys = _keys(col, pos, d, quant16)
    want = _plain_pivot_row(col, pos, d, quant16)
    for g_max in range(1, 133):
        key, row = record_reduction(keys, g_max)
        assert key == keys.max() and row == want, g_max


def test_record_reduction_with_no_candidate():
    """No row can pivot (all frozen or dead): the kernel's key is 0 and it
    names no row (piv = d, glist = -1)."""
    pos = np.array([0, 1, SENT, 2, SENT], dtype=np.int64)
    keys = _keys(np.ones(5, np.float32), pos, 3, False)
    for g_max in (1, 2, 5):
        assert record_reduction(keys, g_max) == (0, -1)
