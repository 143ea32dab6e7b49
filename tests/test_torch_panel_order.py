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
The blocks' candidates travel through flagged slots: 8-byte words of 4
bytes of payload beside the launch's 4-byte flag.  A plain mirror of that
encoding must give back every key and value bit (the pivot value from the
key and a sign bit), reject a word of an older launch, wrap the flag from
2^32 - 1 past 0, and, read from a scratch that an earlier launch with more
blocks left, still lead the reduction to the plain pivot.  Inputs from
numpy with fixed seeds."""

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
    bkeys, brow = block_candidates(keys, g_max)
    key, blk = warp_reduction(bkeys)
    return key, (int(brow[blk]) if key else -1)


def block_candidates(keys: np.ndarray, g_max: int):
    """Each block's key (the largest of its rows') and its slab row, rows
    split as the launch splits them (rpb = ceil(m / g_max) rows a block, G
    = ceil(m / rpb) blocks)."""
    m = keys.shape[0]
    rpb = -(-m // g_max)
    g = -(-m // rpb)
    padded = np.zeros(g * rpb, dtype=np.uint64)
    padded[:m] = keys
    blocks = padded.reshape(g, rpb)
    return blocks.max(axis=1), np.arange(g) * rpb + blocks.argmax(axis=1)


def warp_reduction(bkeys: np.ndarray):
    """Warp 0 over the G blocks' keys: lane t takes keys t, t + 32, ...
    (only a strictly larger key replaces), then a butterfly over the lanes.
    Returns (key, block)."""
    g = bkeys.shape[0]
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
    return lane_key[0], lane_blk[0]


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


# -------------------------------------------- kernel 1's flagged slots

W = 8
SLOT_WORDS = 2 + W - 1                # key high and sign, key low, later strip values
SLOT_CHUNKS = (SLOT_WORDS + 1) // 2   # 16-byte chunks
MASK32 = 0xFFFFFFFF


def next_flag(stored: int) -> int:
    """A launch's flag: the launch count kept in the scratch, plus 1 (32
    bits, wrapping past 0, the zeroed scratch's flag); the launch stores it
    back as it leaves."""
    return (stored + 1) & MASK32 or 1


def _bits(x) -> int:
    return int(np.float32(x).view(np.uint32))


def pack_slot(key: int, vals: np.ndarray, jc: int, flag: int) -> np.ndarray:
    """The words of a block's slot for column jc of its strip: the key's
    high half (top bit 0) with the sign of vals[jc] in its top bit, the
    low half, then vals[jc + 1:]; payload in the low 4 bytes of each word,
    the flag in the high 4; padded with a zero word to whole 16-byte
    chunks."""
    vals = np.asarray(vals, dtype=np.float32)
    payload = [(key >> 32) | (_bits(vals[jc]) & 0x80000000), key & MASK32]
    payload += [_bits(v) for v in vals[jc + 1:]]
    payload += [0] * (2 * ((len(payload) + 1) // 2) - len(payload))
    return np.array([(flag << 32) | p for p in payload], dtype=np.uint64)


def unpack_slot(words: np.ndarray, jc: int, flag: int):
    """(key, pivot value, vals[jc + 1:]) from a slot's words, or None while
    any word carries another flag (the kernel then reads the chunk again).
    The pivot value is the key's |value| bits with the sign."""
    if any(int(w) >> 32 != flag for w in words):
        return None
    low = [int(w) & MASK32 for w in words]
    key = ((low[0] & 0x7FFFFFFF) << 32) | low[1]
    pivot = np.array([low[0]], dtype=np.uint32).view(np.float32)[0]
    vals = np.array(low[2:SLOT_WORDS - jc], dtype=np.uint32).view(np.float32)
    return key, pivot, vals


def slot_words(j: int, jc: int, g: int, b: int) -> np.ndarray:
    """Word offsets of block b's slot for column j in the scratch's slot
    area (chunk c of slot (j, b) at chunk (j SLOT_CHUNKS + c) g + b)."""
    nc = (SLOT_WORDS - jc + 1) // 2
    chunks = (j * SLOT_CHUNKS + np.arange(nc)) * g + b
    return (2 * chunks[:, None] + np.arange(2)).reshape(-1)


def _random_candidate(rng, jc, quant16):
    vals = rng.standard_normal(W).astype(np.float32)
    vals[rng.integers(0, W)] = rng.choice([-0.0, np.inf, -np.inf, np.nan, 1e-45])
    hi = _bits(vals[jc]) & (0x7FFF0000 if quant16 else 0x7FFFFFFF)
    return (hi << 32) | int(rng.integers(2**31, 2**32)), vals


@pytest.mark.parametrize("quant16", [True, False], ids=["quant16", "exact"])
@pytest.mark.parametrize("jc", range(W))
def test_slot_words_round_trip(jc, quant16):
    """Every key bit and later value bit comes back (-0.0, infinities, NaN
    and subnormals included), and the pivot value is the key's |value|
    bits with vals[jc]'s sign: vals[jc] itself for the exact search, its
    top 15 bits under quant16; a column's slot takes ceil((9 - jc) / 2)
    chunks."""
    rng = np.random.default_rng(jc + 8 * quant16)
    for _ in range(50):
        key, vals = _random_candidate(rng, jc, quant16)
        flag = int(rng.integers(1, 2**32))
        words = pack_slot(key, vals, jc, flag)
        assert len(words) == 2 * ((SLOT_WORDS - jc + 1) // 2)
        got = unpack_slot(words, jc, flag)
        assert got is not None and got[0] == key
        want = _bits(vals[jc]) & (0xFFFF0000 if quant16 else MASK32)
        assert _bits(got[1]) == want
        assert np.array_equal(got[2].view(np.uint32), vals[jc + 1:].view(np.uint32))


def test_stale_slot_is_rejected():
    """A slot read under a later launch's flag, or with one word still
    holding an earlier launch's flag (8-byte words arrive in any order),
    does not count; once every word carries the flag it does."""
    rng = np.random.default_rng(5)
    for jc in range(W):
        key, vals = _random_candidate(rng, jc, False)
        words = pack_slot(key, vals, jc, 41)
        assert unpack_slot(words, jc, 42) is None
        for i in range(len(words)):
            mixed = words.copy()
            mixed[i] = pack_slot(key ^ 1, vals, jc, 40)[i]
            assert unpack_slot(mixed, jc, 41) is None
        assert unpack_slot(words, jc, 41)[0] == key


def test_flag_wraps_from_the_last_past_zero():
    """The launch count wraps from 2^32 - 1 past 0 to 1: a slot written
    under flag 2^32 - 1 is stale under the next flag (and the other way
    round), and the zeroed scratch (flag 0) never reads as current."""
    assert next_flag(MASK32 - 1) == MASK32
    assert next_flag(MASK32) == 1
    assert next_flag(0) == 1
    vals = np.arange(W, dtype=np.float32)
    key = _bits(vals[0]) << 32 | 3
    last = pack_slot(key, vals, 0, MASK32)
    first = pack_slot(key, vals, 0, next_flag(MASK32))
    assert unpack_slot(last, 0, next_flag(MASK32)) is None
    assert unpack_slot(first, 0, MASK32) is None
    assert unpack_slot(first, 0, next_flag(MASK32))[0] == key
    zeroed = np.zeros(2 * SLOT_CHUNKS, dtype=np.uint64)
    assert all(unpack_slot(zeroed, 0, next_flag(x)) is None for x in (0, MASK32 - 1, MASK32))


@pytest.mark.parametrize("quant16", [True, False], ids=["quant16", "exact"])
def test_record_reduction_through_slots(quant16):
    """Every G = 1..132: an earlier launch (G = 132, 16 columns) leaves its
    slots in the scratch; this launch writes each block's candidate for
    column j = 9 (jc = 1) under the next flag into the same area, laid out
    by its own G.  Read back through the mirror, every slot of this launch
    is current, the words the earlier launch left elsewhere are not, and
    the reduction of the keys picks the plain pivot row's block, whose
    slot gives the pivot value and later strip values (ties in |value|,
    frozen and dead rows)."""
    m, j, jc = 4099, 9, 1
    rng = np.random.default_rng(17 + quant16)
    strip = (rng.integers(-6, 7, (m, W)) * 0.25).astype(np.float32)
    strip[rng.random((m, W)) < 0.3] *= 1.0 + 2.0 ** -12   # equal under quant16 only
    pos = rng.permutation(m).astype(np.int64)
    pos[rng.random(m) < 0.1] = SENT
    d = m // 3
    keys = _keys(strip[:, jc], pos, d, quant16)
    want = _plain_pivot_row(strip[:, jc], pos, d, quant16)
    old_flag = MASK32                      # the earlier launch's, so this one's wraps
    flag = next_flag(old_flag)
    for g_max in range(1, 133):
        area = np.zeros(2 * 16 * SLOT_CHUNKS * 132, dtype=np.uint64)
        for jo in range(16):
            for b in range(132):
                area[slot_words(jo, jo % W, 132, b)] = pack_slot(
                    int(rng.integers(1, 2**62)), strip[b], jo % W, old_flag)
        bkeys, brow = block_candidates(keys, g_max)
        g = len(bkeys)
        written = np.zeros(area.shape, dtype=bool)
        for b in range(g):
            at = slot_words(j, jc, g, b)
            area[at] = pack_slot(int(bkeys[b]), strip[brow[b]], jc, flag)
            written[at] = True
        assert not any(int(w) >> 32 == flag for w in area[~written])
        got = [unpack_slot(area[slot_words(j, jc, g, b)], jc, flag) for b in range(g)]
        assert all(x is not None for x in got)
        key, blk = warp_reduction(np.array([x[0] for x in got], dtype=np.uint64))
        assert key == keys.max() and brow[blk] == want, g_max
        pivot = _bits(strip[want, jc]) & (0xFFFF0000 if quant16 else MASK32)
        assert _bits(got[blk][1]) == pivot, g_max
        assert np.array_equal(got[blk][2], strip[want, jc + 1:]), g_max
