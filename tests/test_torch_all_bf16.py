"""Port parity for the ALL_BF16 policy (bf16 working storage).

Kernel by kernel, each plain PyTorch version the port runs on CPU tensors
(and holds its Hopper kernel against on the card) meets the JAX package's
function on the same bf16 inputs, made with numpy from fixed seeds: kernel
12 (the bf16-slab streaming update) and the bf16 instances of kernels 1, 2,
4, 5 and 6, with the Pallas kernels in interpret mode as the JAX package's
own tests run them.  Then the whole policy, through the fused route against
the JAX fused driver in interpret mode and through the masked route against
the JAX CPU driver.

Tolerances: pivots, ``info``, row moves, kernel 5 and the bf16 diagonal
(``getf2_npv``, the triangular inverses) exact; values that come out of an
fp32 sum of bf16 products taken in another order (kernels 2, 6 and 12)
within one bf16 ulp of the JAX value.  The factors of the whole policy are
held entry by entry: the fused route within one bf16 ulp of the JAX value
(bit-equal where measured); the masked route, whose in-block products XLA
and PyTorch sum in other orders, L and U each against its own largest
entry and most entries bit-equal (measured: 99.8% of L and 98.9% of U;
each rounding point dropped or added in ``_inner_panel_step`` takes L
below 98.2% or past 7e-3 of max|L|, and moves the uniform matrix's first
pivot divergence from 142 to 47 or earlier).  Both oracles at about twice
the backward error measured here (HPL-AI 3.9e-6 to 7.3e-6, uniform 4.6e-5
to 4.9e-5), far inside the JAX package's ALL_BF16 bound of 5e-2
(tests/test_panel_fused.py:441-443), which LU = 0 would meet (1/n).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import mpf_tpu  # noqa: E402
import mpf_tpu.config as cfg  # noqa: E402
import mpf_tpu.models.mpf as M  # noqa: E402
from mpf_tpu.ops import blas3 as JB  # noqa: E402
from mpf_tpu.ops.exchange import rows_exchange as j_rows_exchange  # noqa: E402
from mpf_tpu.ops.getf2 import getf2_npv as j_getf2_npv  # noqa: E402
from mpf_tpu.ops.panel_fused import (  # noqa: E402
    panel_apply_update_trim as j_update,
    rowblock_assemble as j_rowblock,
)
from mpf_tpu.ops.panel_pallas import unit_lower_inv_pallas  # noqa: E402
from mpf_tpu.ops.panel_strip import strip_panel_pivots as j_strip  # noqa: E402
from mpf_tpu.utils import matgen  # noqa: E402

import mpf_tpu_torch as T  # noqa: E402
import mpf_tpu_torch.models.mpf as TM  # noqa: E402
from mpf_tpu_torch.convert import result_to_numpy  # noqa: E402
from mpf_tpu_torch.ops import _lib  # noqa: E402
from mpf_tpu_torch.ops.blas3 import (  # noqa: E402
    _leaves, tri_inv_leaves, unit_lower_inv, unit_lower_inv_blocked, upper_inv)
from mpf_tpu_torch.ops.exchange import rows_exchange  # noqa: E402
from mpf_tpu_torch.ops.getf2 import getf2_npv  # noqa: E402
from mpf_tpu_torch.ops.panel_fused import (  # noqa: E402
    panel_apply_update_trim, rowblock_assemble, trailing_gemm_sub)
from mpf_tpu_torch.ops.panel_strip import strip_panel_pivots  # noqa: E402
from mpf_tpu_torch.utils import matgen as tmatgen  # noqa: E402
from mpf_tpu_torch.utils.oracle import (  # noqa: E402
    check_factorization, ipiv_to_perm, within_bf16_ulp)

BF = torch.bfloat16
JBF = jnp.bfloat16
NBE_HPL, NBE_UNIFORM = 1.5e-5, 1e-4


def _bf16(a):
    """A numpy fp32 array rounded to bf16, as (torch bf16, jax bf16)."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF)
    return t, jnp.asarray(t.float().numpy()).astype(JBF)


def _f32(x):
    """A torch or jax array as numpy fp32."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_within_bf16_ulp(got, ref, what=""):
    """|got - ref| <= one bf16 ulp of the larger magnitude, entry by entry
    (torch, jax or numpy arrays)."""
    rep = within_bf16_ulp(torch.tensor(_f32(got)), torch.tensor(_f32(ref)))
    assert rep, (what, rep)


# ---------------------------------------------------------------- kernel 12

@pytest.mark.parametrize("j0,jj0", [(0, 0), (24, 24), (40, 520)])
def test_kernel12_matches_jax(j0, jj0):
    """panel_apply_update_trim on a bf16 slab (kernel 12's plain L21 and
    update passes) vs the JAX split form (_l21_trim_kernel +
    _upd_wide_kernel, interpret) at m = 128, bc = 1024, r = 8: frozen rows
    and the columns left of the panel bit-exact, the rest within one bf16
    ulp; kernel 3's plain version is not called."""
    rng = np.random.default_rng(9 + jj0)
    m, bc, r = 128, 1024, 8
    slab_t, slab_j = _bf16(rng.standard_normal((m, bc)))
    pos = rng.permutation(m).astype(np.int32)
    rb_t, rb_j = _bf16(rng.standard_normal((r, bc)))
    ui_t, ui_j = _bf16(np.triu(rng.standard_normal((r, r))))
    jout = _f32(j_update(slab_j, jnp.asarray(pos), rb_j, ui_j, j0, jj0, rb=128,
                         interpret=True))
    _lib.reset_counts()
    t = slab_t.clone()
    panel_apply_update_trim(t, torch.from_numpy(pos), rb_t, ui_t, j0, jj0)
    assert _lib.plain_calls["l21_trim"] == 1 and _lib.plain_calls["upd_wide"] == 1
    assert _lib.plain_calls["panel_update"] == 0
    got, slab = _f32(t), _f32(slab_t)
    frozen = pos < j0 + r
    np.testing.assert_array_equal(got[frozen], slab[frozen])
    np.testing.assert_array_equal(got[:, :jj0], slab[:, :jj0])
    assert_within_bf16_ulp(got[:, jj0:], jout[:, jj0:], "kernel 12")
    assert not np.array_equal(got[~frozen][:, jj0 + r:], slab[~frozen][:, jj0 + r:])


# ---------------------------------------------------------------- kernel 1

@pytest.mark.parametrize("m", [128, 1024])
@pytest.mark.parametrize("q16", [True, False])
def test_strip_pivots_bf16_slab(m, q16):
    """Kernel 1's plain version on a bf16 slab: piv / pos / glist equal to
    the JAX kernel's (interpret) on the same bf16 slab, and to the port's
    own on an fp32 slab holding the same (bf16-representable) values."""
    rng = np.random.default_rng(m + q16)
    slab_t, slab_j = _bf16(rng.standard_normal((m, 32)))
    for off in (0, 8, 40):
        pos = rng.permutation(m).astype(np.int32) if off == 8 else np.arange(m, dtype=np.int32)
        jp = j_strip(slab_j, off, jnp.asarray(pos), panel_dtype=JBF, interpret=True,
                     jj0=16, r=16, _quant16=q16)
        tp = strip_panel_pivots(slab_t, off, torch.from_numpy(pos), BF, jj0=16, r=16,
                                quant16=q16)
        tf = strip_panel_pivots(slab_t.float(), off, torch.from_numpy(pos), BF, jj0=16,
                                r=16, quant16=q16)
        for name, a, b, c in zip(("piv", "pos", "glist"), jp, tp, tf):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f"{name} {off}")
            np.testing.assert_array_equal(c.numpy(), b.numpy(), err_msg=f"{name} {off}")


# ---------------------------------------------------------------- kernel 2

@pytest.mark.parametrize("zero_pivot", [False, True])
def test_rowblock_bf16_matches_jax(zero_pivot):
    """Kernel 2's bf16 instance (plain) vs rowblock_assemble(interpret) on
    a bf16 slab: the row block (LU, U12) and U^-1 in bf16 within one bf16
    ulp, the gathered L part left of the panel exact, info exact (2 when
    the second pivot is made exactly zero)."""
    rng = np.random.default_rng(31)
    m, bc, r, jj0 = 256, 128, 16, 16
    a = rng.standard_normal((m, bc)).astype(np.float32)
    glist = rng.permutation(m)[:r].astype(np.int32)
    if zero_pivot:
        a[glist[1], jj0:jj0 + r] = a[glist[0], jj0:jj0 + r]
    slab_t, slab_j = _bf16(a)
    jrb, jui, jinfo = j_rowblock(slab_j, jnp.asarray(glist), jj0, interpret=True)
    trb, tui, tinfo = rowblock_assemble(slab_t, torch.from_numpy(glist), jj0)
    assert trb.dtype == tui.dtype == BF
    assert int(tinfo) == int(jinfo) == (2 if zero_pivot else 0)
    if not zero_pivot:  # the refactor of a singular block is not comparable
        assert_within_bf16_ulp(trb, jrb, "rowblock")
        assert_within_bf16_ulp(tui, jui, "uinv")
    np.testing.assert_array_equal(_f32(trb)[:, :jj0], _f32(slab_t)[glist][:, :jj0])


# ---------------------------------------------------------------- kernel 4

def test_rows_exchange_bf16_bitexact():
    """Kernel 4 on a bf16 matrix (rows copied as they are) vs the JAX
    kernel (interpret), which stages bf16 rows through fp32: bit-exact."""
    rng = np.random.default_rng(41)
    n, w, k, nr = 256, 128, 64, 32
    a_t, a_j = _bf16(rng.standard_normal((n, w)))
    perm = np.arange(n)
    for j in range(nr):
        p = rng.integers(k + j, n) if rng.random() < 0.7 else k + j
        perm[[k + j, p]] = perm[[p, k + j]]
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    glist, dests = perm[k:k + nr].astype(np.int32), inv[k:k + nr].astype(np.int32)
    ja, jpiv = j_rows_exchange(a_j, k, jnp.asarray(glist), jnp.asarray(dests), interpret=True)
    ja = _f32(ja).copy()
    ja[k:k + nr] = _f32(jpiv)
    t = a_t.clone()
    tpiv = rows_exchange(t, k, torch.from_numpy(glist), torch.from_numpy(dests))
    assert tpiv.dtype == BF
    np.testing.assert_array_equal(_f32(tpiv), _f32(jpiv))
    t[k:k + nr] = tpiv
    np.testing.assert_array_equal(_f32(t), ja)


# ---------------------------------------------------------------- kernel 5

def test_tri_inv_bf16_leaf_exact():
    """Kernel 5's bf16 leaf (plain) equals the Pallas leaf in interpret
    mode bit for bit: the product rounded to bf16, then the difference."""
    rng = np.random.default_rng(51)
    s = 64
    l_t, l_j = _bf16(np.tril(rng.uniform(-0.5, 0.5, (s, s)), -1))
    t = tri_inv_leaves(l_t, [(0, s)])
    with pltpu.force_tpu_interpret_mode():
        jp = unit_lower_inv_pallas(l_j)
    assert t.dtype == BF
    np.testing.assert_array_equal(_f32(t), _f32(jp))


def test_unit_lower_inv_blocked_bf16(monkeypatch):
    """The bf16 recursion (leaves from kernel 5's plain version, the inner
    product kept in fp32, one rounding to bf16) vs the JAX package's with
    its Pallas leaves (interpret): within one bf16 ulp, leaves exact."""
    monkeypatch.setattr(cfg, "_USE_PALLAS", "1")
    rng = np.random.default_rng(52)
    n = 192
    l_t, l_j = _bf16(np.tril(rng.uniform(-0.5, 0.5, (n, n)) / 8, -1))
    t = unit_lower_inv_blocked(l_t, base=64)
    with pltpu.force_tpu_interpret_mode():
        j = JB.unit_lower_inv_blocked(l_j, base=64)
    assert t.dtype == BF
    assert_within_bf16_ulp(t, j, "blocked inverse")
    for o, s in _leaves(n, 64):
        np.testing.assert_array_equal(_f32(t)[o:o + s, o:o + s], _f32(j)[o:o + s, o:o + s])


@pytest.mark.parametrize("r", [16, 48])
def test_bf16_diagonal_matches_jax(r):
    """The masked route's bf16 diagonal, as the JAX driver computes it for
    non-fp32 blocks (mpf.py:75-90): getf2_npv, unit_lower_inv and
    upper_inv on bf16 equal the jitted JAX functions bit for bit; info
    exact, also with an exactly-zero second pivot."""
    rng = np.random.default_rng(r)
    blk_t, blk_j = _bf16(rng.standard_normal((r, r)) + (r / 4) * np.eye(r))
    jlu, jinfo = jax.jit(j_getf2_npv)(blk_j)
    lu, info = getf2_npv(blk_t)
    np.testing.assert_array_equal(_f32(lu), _f32(jlu))
    assert int(info) == int(jinfo) == 0
    np.testing.assert_array_equal(_f32(unit_lower_inv(lu)), _f32(jax.jit(JB.unit_lower_inv)(jlu)))
    np.testing.assert_array_equal(_f32(upper_inv(lu)), _f32(jax.jit(JB.upper_inv)(jlu)))
    z = blk_t.clone()
    z[1] = z[0]
    assert int(getf2_npv(z)[1]) == int(jax.jit(j_getf2_npv)(jnp.asarray(
        z.float().numpy()).astype(JBF))[1]) == 2


# ---------------------------------------------------------------- kernel 6

def test_trailing_gemm_sub_bf16_matches_jax():
    """Kernel 6's bf16-C instance (plain): a[ko:, ko:ko+ncols] =
    bf16(fp32(a) - l21 @ u12) vs the JAX package's bf16 trailing update:
    within one bf16 ulp; everything else untouched."""
    rng = np.random.default_rng(61)
    n, ko, kk, ncols = 384, 128, 64, 192
    a_t, a_j = _bf16(rng.standard_normal((n, n)))
    l_t, l_j = _bf16(rng.standard_normal((n - ko, kk)))
    u_t, u_j = _bf16(rng.standard_normal((kk, ncols)))
    exp = JB.trailing_update(a_j[ko:, ko:ko + ncols], l_j, u_j, mpf_tpu.ALL_BF16)
    t = a_t.clone()
    trailing_gemm_sub(t, l_t, u_t, ko, ncols=ncols)
    assert t.dtype == BF
    assert_within_bf16_ulp(t[ko:, ko:ko + ncols], exp, "trailing")
    out, a = _f32(t), _f32(a_t)
    out[ko:, ko:ko + ncols] = a[ko:, ko:ko + ncols]
    np.testing.assert_array_equal(out, a)


# ---------------------------------------------------------------- the slice

def _port(a, r, block, pivot=True):
    return result_to_numpy(T.mpf_factorize(torch.from_numpy(a), r=r, policy=T.ALL_BF16,
                                           block=block, pivot=pivot))


def _oracles(a, nbe_tol, *results):
    for res in results:
        rep = check_factorization(a, res.lu, res.ipiv, nbe_tol=nbe_tol)
        assert rep.ok, rep
        np.testing.assert_array_equal(np.sort(res.perm), np.arange(a.shape[0]))


def _assert_same_pivots(t, j):
    np.testing.assert_array_equal(t.ipiv, j.ipiv)
    np.testing.assert_array_equal(t.perm, j.perm)
    assert int(t.info) == int(j.info)
    np.testing.assert_array_equal(ipiv_to_perm(torch.from_numpy(t.ipiv)).numpy(), t.perm)


def _assert_factors_close(t, j, l_tol, u_tol, l_equal, u_equal):
    """L and U each against its own largest entry: every entry within
    ``*_tol`` of it, and at least the share ``*_equal`` of entries
    bit-equal to the JAX factor."""
    lower = np.tri(t.lu.shape[0], k=-1, dtype=bool)
    for name, mask, tol, share in (("L", lower, l_tol, l_equal), ("U", ~lower, u_tol, u_equal)):
        d = np.abs(t.lu[mask] - j.lu[mask])
        scale = np.abs(j.lu[mask]).max()
        assert d.max() <= tol * scale, (name, d.max() / scale)
        assert np.mean(d == 0) >= share, (name, np.mean(d == 0))


def _jax_fused(monkeypatch, a, r, block):
    """The JAX fused driver with its Pallas kernels in interpret mode, set
    up as tests/test_panel_fused.py:444-457 does."""
    monkeypatch.setattr(M, "_PAD_QUANTUM", 128)
    monkeypatch.setattr(M, "_FUSED_RB", 128)
    monkeypatch.setattr(cfg, "_USE_PALLAS", "1")
    with pltpu.force_tpu_interpret_mode():
        res = M.mpf_factorize_traced(jnp.asarray(a, dtype=JBF), r=r, policy=mpf_tpu.ALL_BF16,
                                     block=block)
        return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32))
                            if x.dtype == JBF else np.asarray(x), res)


def test_fused_hpl_matches_jax(monkeypatch):
    """The fused route (kernels 1, 2, 12, 4, 5, 6 plain) vs the JAX fused
    driver (interpret) at n = 384, r = 8, block = 128 on the HPL-AI
    matrix: ipiv, perm and info exact, every LU entry within one bf16 ulp
    (bit-equal where measured), both oracles; the counters show kernel 12
    and no kernel 3 or 8."""
    n, r, block = 384, 8, 128
    a = matgen.hpl_ai_matrix(n, seed=1).astype(np.float32)
    _lib.reset_counts()
    t = _port(a, r, block)
    assert _lib.plain_calls["l21_trim"] == n // r
    assert _lib.plain_calls["upd_wide"] == n // r - n // block
    assert _lib.plain_calls["panel_update"] == 0 and _lib.plain_calls["npv_inv"] == 0
    j = _jax_fused(monkeypatch, a, r, block)
    _assert_same_pivots(t, j)
    assert_within_bf16_ulp(t.lu, j.lu, "LU")
    _oracles(a, NBE_HPL, t, j)


def test_fused_uniform_vs_jax(monkeypatch):
    """The same on the pivot-heavy uniform matrix at n = 256, r = 8: the
    pivots are exact up to the first divergence, at pivot 211 in the
    second block column (the paths sum bf16 products in fp32 in other
    orders, and a last-bit difference in a bf16-stored value can pick the
    other of two near-equal pivots), and both oracles hold."""
    n, r, block, agree = 256, 8, 128, 211
    a = matgen.random_dense(n, seed=2).astype(np.float32)
    t = _port(a, r, block)
    j = _jax_fused(monkeypatch, a, r, block)
    np.testing.assert_array_equal(t.ipiv[:agree], j.ipiv[:agree])
    assert t.ipiv[agree] != j.ipiv[agree]
    _oracles(a, NBE_UNIFORM, t, j)


@pytest.fixture
def masked(monkeypatch):
    """Route every block column to the masked path, as the JAX package's
    factorization routes it on the CPU."""
    monkeypatch.setattr(TM, "_fused_ok", lambda bc, r: False)


def _jax_masked(a, r, block, pivot=True):
    """The JAX package's CPU driver (its jnp route), LU as fp32."""
    j = jax.tree.map(np.asarray, mpf_tpu.mpf_factorize(
        jnp.asarray(a), r=r, policy=mpf_tpu.ALL_BF16, block=block, pivot=pivot))
    return j._replace(lu=j.lu.astype(np.float32))


@pytest.mark.parametrize("pivot", [True, False])
def test_masked_hpl_matches_jax(pivot, masked):
    """The masked route (kernel 7 bf16, kernel 9 on the bf16 slab, the bf16
    diagonal as PyTorch ops, kernels 5 and 6 bf16) vs the JAX CPU driver's
    jnp path at n = 256, r = 16, block = 128, HPL-AI: ipiv, perm and info
    exact; L within 5e-3 of max|L| and U within 1e-4 of max|U| (measured
    3.5e-3 and 6.1e-5), at least 99% of L and 98% of U bit-equal (measured
    99.8% and 98.9%); both oracles; kernel 8 is not called."""
    n, r, block = 256, 16, 128
    a = matgen.hpl_ai_matrix(n, seed=3).astype(np.float32)
    _lib.reset_counts()
    t = _port(a, r, block, pivot)
    assert _lib.plain_calls["npv_inv"] == 0 and _lib.plain_calls["l21_trim"] == 0
    assert _lib.plain_calls["hgetf2"] == (n // r if pivot else 0)
    j = _jax_masked(a, r, block, pivot)
    _assert_same_pivots(t, j)
    _assert_factors_close(t, j, 5e-3, 1e-4, 0.99, 0.98)
    _oracles(a, NBE_HPL, t, j)
    if not pivot:
        np.testing.assert_array_equal(t.ipiv, np.arange(1, n + 1))


def test_masked_uniform_vs_jax(masked):
    """The masked route on the pivot-heavy uniform matrix at n = 256, r =
    16, block = 128: the pivots equal the JAX CPU driver's up to the first
    divergence, at pivot 142 in the second block column (the in-block
    products sum bf16 products in fp32 in other orders, and a last-bit
    difference in a bf16-stored value can pick the other of two near-equal
    pivots), and both oracles hold."""
    n, r, block, agree = 256, 16, 128, 142
    a = matgen.random_dense(n, seed=4).astype(np.float32)
    t = _port(a, r, block)
    j = _jax_masked(a, r, block)
    np.testing.assert_array_equal(t.ipiv[:agree], j.ipiv[:agree])
    assert t.ipiv[agree] != j.ipiv[agree]
    _oracles(a, NBE_UNIFORM, t, j)


# ---------------------------------------------------------------- generators

@pytest.mark.parametrize("chunk_rows", [None, 10])
@pytest.mark.parametrize("kind", ["hpl_ai", "uniform"])
def test_device_generators(kind, chunk_rows, monkeypatch):
    """hpl_ai_matrix_device / random_dense_device on the CPU device, in one
    chunk and in 10-row chunks: the class (range; the diagonal shift n/4),
    determinism per seed, and the bf16 output equal to the fp32 output cast
    once."""
    gen = {"hpl_ai": tmatgen.hpl_ai_matrix_device,
           "uniform": tmatgen.random_dense_device}[kind]
    n = 96
    if chunk_rows:
        monkeypatch.setattr(tmatgen, "_CHUNK_ELEMS", chunk_rows * n)
    a = gen(n, seed=5, device="cpu")
    assert a.dtype == torch.float32 and a.shape == (n, n)
    assert torch.equal(a, gen(n, seed=5, device="cpu"))
    assert not torch.equal(a, gen(n, seed=6, device="cpu"))
    assert torch.equal(gen(n, seed=5, dtype=BF, device="cpu"), a.to(BF))
    off = a[~torch.eye(n, dtype=torch.bool)]
    if kind == "hpl_ai":
        assert float(off.min()) >= -0.5 and float(off.max()) < 0.5
        d = torch.diagonal(a) - n / 4.0
        assert float(d.min()) >= -0.5 and float(d.max()) < 0.5
    else:
        assert float(a.min()) >= 0.0 and float(a.max()) <= 9.9
        assert 4.0 < float(a.mean()) < 6.0
