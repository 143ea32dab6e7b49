"""Kernel 7's schedule on the CPU (csrc/hgetf2.cu).

Kernel 7 splits the m rows of the panel into G blocks of rpb = ceil(m /
g_max) rows (G = ceil(m / rpb), one block an SM), leaves every row where it
is and carries its position.  Per column j (d = off + j):

* each block's candidate is the largest 64-bit key of its rows (|value|
  bits << 32 | inverted position, 0 for rows above d): its threads', warps'
  and the block's maxima are maxima of maxima;
* warp 0 of every block reduces the G keys — lane t takes keys t, t + 32,
  ... (only a strictly larger key replaces), then a butterfly over the
  lanes — and reads the winning block's record (its candidate's slab row
  and the row's values from the 16-byte word holding column j on);
* every row swaps its position (the winner to d, the row at d to the
  winner's position), and each row below d divides and takes the rank-1
  update from the word holding column j + 1 on (the columns left of j + 1
  in that word take it too; they are never read again).

No grid barrier ends the panel: each block writes ``srcs[r + j] =
perm[piv[j]]`` for its own row whose final position is ``piv[j]`` (a
position may be the pivot of several columns).

A plain mirror of that schedule must pick, at every column and for every
G = 1..132, the winner of the plain version, and give the plain version's
(``hgetf2_panel_plain``) and the JAX package's (``hgetf2_panel_swaps`` in
Pallas interpret mode; its jnp reference where r % 8 != 0) piv, perm,
composed map and srcs bit for bit, for fp16, bf16 and fp32 panels and r in
{8, 12, 48, 128, 256}, with off > 0, a permuted prev_perm, on a uniform and
a tie-heavy dyadic panel.  Inputs from numpy with fixed seeds; tolerance:
bitwise."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from mpf_tpu.ops import panel_pallas as JP  # noqa: E402
from mpf_tpu.ops.getf2 import panel_pivots_perm as jax_panel_pivots_perm  # noqa: E402

from mpf_tpu_torch.ops import _lib  # noqa: E402
from mpf_tpu_torch.ops.panel_pallas import hgetf2_panel_plain  # noqa: E402

DTYPES = {"fp16": (torch.float16, jnp.float16), "bf16": (torch.bfloat16, jnp.bfloat16),
          "fp32": (torch.float32, jnp.float32)}
WIDTHS = [8, 12, 48, 128, 256]
G_MAX = 132
MASK32 = np.uint64(0xFFFFFFFF)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread for this file: its column loops issue thousands
    of small ops, and between them torch's idle OpenMP workers spin, which
    slows every other test process sharing the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _panel(kind: str, m: int, r: int, seed: int) -> np.ndarray:
    """A uniform panel, or a tie-heavy dyadic one (small integers times
    powers of two: many equal |values|, no zeros)."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return (rng.random((m, r)) * 2 - 1).astype(np.float32)
    a = (rng.integers(-4, 5, (m, r)) * 2.0 ** rng.integers(-2, 3, (m, r))).astype(np.float32)
    a[a == 0] = 1.0
    return a


def _keys(col: np.ndarray, pos: np.ndarray, d: int) -> np.ndarray:
    bits = np.abs(col.astype(np.float32)).view(np.uint32).astype(np.uint64)
    inv = (MASK32 - pos.astype(np.uint64)) & MASK32
    return np.where(pos >= d, (bits << np.uint64(32)) | inv, np.uint64(0))


class Splits:
    """Every split of m rows into blocks for g_max = 1..G_MAX, laid out so
    that one column's keys reduce for all of them at once."""

    def __init__(self, m: int):
        self.m = m
        starts, slot_idx, self.rpb, self.nblk = [], [], [], []
        base = 0
        for g_max in range(1, G_MAX + 1):
            rpb = -(-m // g_max)
            g = -(-m // rpb)
            starts += [base + b * rpb for b in range(g)]
            idx = np.full(256, -1)
            idx[:g] = np.arange(len(starts) - g, len(starts))
            slot_idx.append(idx)
            self.rpb.append(rpb)
            self.nblk.append(g)
            base += m
        self.starts = np.array(starts)
        self.slot_idx = np.stack(slot_idx)           # (G_MAX, 256): block t of each split

    def reduce(self, keys: np.ndarray):
        """The winning key and slab row of one column, for each split:
        block maxima, warp 0's lanes over the blocks, the butterfly, then
        the winning block's candidate."""
        bmax = np.maximum.reduceat(np.tile(keys, G_MAX), self.starts)
        slots = np.where(self.slot_idx >= 0, bmax[np.maximum(self.slot_idx, 0)], np.uint64(0))
        lanes = slots.reshape(G_MAX, 8, 32)
        lane_key = lanes.max(axis=1)                  # first maximum: strictly larger replaces
        lane_blk = lanes.argmax(axis=1) * 32 + np.arange(32)
        for o in (16, 8, 4, 2, 1):
            partner = np.arange(32) ^ o
            pk, pb = lane_key[:, partner], lane_blk[:, partner]
            take = pk > lane_key
            lane_key, lane_blk = np.where(take, pk, lane_key), np.where(take, pb, lane_blk)
        assert (lane_key == lane_key[:, :1]).all() and (lane_blk == lane_blk[:, :1]).all()
        g, gb = lane_key[:, 0], lane_blk[:, 0]
        rows = []
        for s in range(G_MAX):
            lo = gb[s] * self.rpb[s]
            hi = min(lo + self.rpb[s], self.m)
            rows.append(lo + int(np.argmax(keys[lo:hi])))
        return g, np.array(rows)


def hgetf2_mirror(a: np.ndarray, off: int, prev: np.ndarray, dtype: torch.dtype):
    """Kernel 7's schedule on the CPU (module docstring): returns (piv,
    perm, composed, srcs) as int32 numpy arrays; every split must choose
    the same winner at every column."""
    m, r = a.shape
    p = torch.from_numpy(a).to(dtype, copy=True)     # cast as the kernel loads
    vw = 16 // p.element_size()                      # values a 16-byte word
    pos = np.arange(m)
    splits = Splits(m)
    piv, lo = [], []
    for j in range(r):
        d = off + j
        g, rows = splits.reduce(_keys(p[:, j].float().numpy(), pos, d))
        assert (g == g[0]).all() and (rows == rows[0]).all(), j
        o = int(rows[0])
        cp = int(MASK32 - (g[0] & MASK32))
        assert pos[o] == cp
        pos = np.where(np.arange(m) == o, d, np.where(pos == d, cp, pos))
        piv.append(cp)
        lo.append(o)
        if j + 1 < r:
            u = p[o].clone()                         # the record: the winner's row
            pv = u[j].float()
            safe = torch.where(pv == 0, torch.ones(()), pv)
            below = torch.from_numpy(pos > d)
            mult = (p[below, j].float() / safe).to(dtype)
            c0 = (j + 1) // vw * vw                  # the word holding column j + 1
            p[below, c0:] = _lib.sub_mul(p[below, c0:], mult[:, None], u[None, c0:])
    perm = np.empty(m, np.int64)
    perm[pos] = np.arange(m)
    # srcs[r + jj]: block by block, each its own row at final position piv[jj]
    hi = np.full(r, -1)
    for s in (0, G_MAX - 1):
        rpb, g = splits.rpb[s], splits.nblk[s]
        hi_s = np.full(r, -1)
        for b in range(g):
            for row in range(b * rpb, min(b * rpb + rpb, m)):
                if pos[row] >= off:
                    for jj in range(r):
                        if piv[jj] == pos[row]:
                            assert hi_s[jj] == -1
                            hi_s[jj] = row
        assert (hi_s >= 0).all()
        hi = hi_s
    srcs = np.concatenate([lo, hi])
    i32 = np.int32
    return (np.array(piv, i32), perm.astype(i32), prev[perm].astype(i32), srcs.astype(i32))


def _shape(r: int):
    off = r // 4 + 5
    return r + off + 200, off


@pytest.mark.parametrize("kind", ["uniform", "dyadic"])
@pytest.mark.parametrize("r", WIDTHS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_schedule_is_bitwise_plain_and_jax(dt, r, kind):
    m, off = _shape(r)
    a = _panel(kind, m, r, seed=r + 7 * len(kind))
    prev = np.random.default_rng(r).permutation(m).astype(np.int32)
    tdt, jdt = DTYPES[dt]
    got = hgetf2_mirror(a, off, prev, tdt)
    plain = hgetf2_panel_plain(torch.from_numpy(a), off, torch.from_numpy(prev), tdt)
    if r % 8 == 0:
        with pltpu.force_tpu_interpret_mode():
            want = JP.hgetf2_panel_swaps(jnp.asarray(a), off, jnp.asarray(prev),
                                         panel_dtype=jdt)
    else:
        jpiv, jperm, jcomp = jax_panel_pivots_perm(jnp.asarray(a, jdt), off,
                                                   prev_perm=jnp.asarray(prev))
        cand = np.concatenate([off + np.arange(r), np.asarray(jpiv)])
        want = (jpiv, jperm, jcomp, np.asarray(jperm)[cand])
    for g, pl, w in zip(got, plain, want):
        np.testing.assert_array_equal(g, pl.numpy())
        np.testing.assert_array_equal(g, np.asarray(w))


def test_repeated_pivot_positions():
    """A position that is the pivot of two columns: column 0's winner (row
    5) sends row 0 to position 5, and row 0 wins column 1 there.  Both
    columns' second LASWP source is perm[5], the row finally at position
    5, written once for each column by that row's own block."""
    m, r, off = 8, 3, 0
    a = np.ones((m, r), np.float32) * 0.5
    a[5, 0] = 8.0
    a[0, 1] = 16.0
    prev = np.arange(m, dtype=np.int32)[::-1].copy()
    for tdt, _ in DTYPES.values():
        got = hgetf2_mirror(a, off, prev, tdt)
        piv = got[0]
        assert piv[0] == 5 and piv[1] == 5
        plain = hgetf2_panel_plain(torch.from_numpy(a), off, torch.from_numpy(prev), tdt)
        for g, pl in zip(got, plain):
            np.testing.assert_array_equal(g, pl.numpy())
        perm = got[1]
        assert got[3][r] == got[3][r + 1] == perm[5]


def test_repeats_occur_in_the_sweep():
    """The parametrised panels include columns whose pivot position
    repeats an earlier column's, so the block-local srcs derivation is
    exercised with repeats there too."""
    m, off = _shape(48)
    a = _panel("dyadic", m, 48, seed=48 + 7 * 6)
    piv = hgetf2_mirror(a, off, np.arange(m, dtype=np.int32), torch.float16)[0]
    assert len(set(piv.tolist())) < len(piv)


def test_fp16_rank1_rounds_once_as_jax():
    """The fp16 update ``p - m * u`` of kernel 7 and its plain version
    (``_lib.sub_mul``) against the JAX package's jitted ``p - m * u`` on
    the CPU, which rounds the exact result once to fp16: bitwise on 2**20
    random triples, where rounding the fp32 difference again to fp16
    differs a few times in a million (the fp32 rounding can land on an
    fp16 midpoint)."""
    rng = np.random.default_rng(16)
    n = 1 << 20
    p, m, u = ((rng.random(n) * 2 - 1).astype(np.float16) for _ in range(3))
    want = np.asarray(jax.jit(lambda p, m, u: p - m * u)(p, m, u))
    got = _lib.sub_mul(torch.from_numpy(p), torch.from_numpy(m), torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want.view(np.uint16))
