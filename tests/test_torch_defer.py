"""Port parity for the deferred-overflow exchange and kernel 10: kernel
14's plain versions (:func:`copy_rows_block_plain`,
:func:`flush_overflow_plain`) and kernel 1 on sentinel positions against
the JAX package's kernels in interpret mode, kernel 10's plain version
(:func:`panel_apply_update_plain`) against the JAX kernel and the port's
trimmed B, the deferred driver against the port's classic loop on the
cases of tests/test_defer.py, its routing, the ``MPF_DEFER`` knobs and the
device generators' ``ext_rows``.  Inputs come from numpy with fixed seeds;
each test states its tolerance.  No kernel launches on the CPU."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpf_tpu.ops.exchange import (  # noqa: E402
    copy_rows_block as j_copy_rows, flush_overflow as j_flush)
from mpf_tpu.ops.panel_fused import panel_apply_update as j_full  # noqa: E402
from mpf_tpu.ops.panel_strip import strip_panel_pivots as j_strip  # noqa: E402
from mpf_tpu.utils import matgen  # noqa: E402

import mpf_tpu_torch as T  # noqa: E402
from mpf_tpu_torch import config  # noqa: E402
from mpf_tpu_torch.models import mpf as TM  # noqa: E402
from mpf_tpu_torch.ops import _lib, panel_strip  # noqa: E402
from mpf_tpu_torch.ops.exchange import copy_rows_block, flush_overflow  # noqa: E402
from mpf_tpu_torch.ops.panel_fused import (  # noqa: E402
    panel_apply_update, panel_apply_update_trim)
from mpf_tpu_torch.ops.panel_strip import SENT, strip_panel_pivots  # noqa: E402
from mpf_tpu_torch.utils import matgen as tmatgen  # noqa: E402
from mpf_tpu_torch.utils.oracle import check_factorization  # noqa: E402

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _both(a_np, tdt):
    """The same values as a torch tensor of ``tdt`` and a jax array."""
    t = torch.from_numpy(a_np).to(tdt)
    return t, jnp.asarray(t.float().numpy()).astype(_JDT[tdt])


def _np32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------- kernel 14

@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_copy_rows_block_matches_jax(tdt):
    """Exact: a band of 48 rows (at row 32) into the overflow slots at row
    256, as the JAX kernel (interpret) copies it; the plain version counts
    its call and nothing launches."""
    rng = np.random.default_rng(1)
    t, j = _both(rng.standard_normal((320, 128)).astype(np.float32), tdt)
    _lib.reset_counts()
    copy_rows_block(t, 32, 256, 48)
    assert _lib.plain_calls["copy_rows"] == 1 and not any(_lib.launches.values())
    np.testing.assert_array_equal(t.float().numpy(), _np32(j_copy_rows(j, 32, 256, 48,
                                                                     interpret=True)))


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("live", ["mixed", "empty", "full"])
def test_flush_overflow_matches_jax(tdt, live):
    """Exact against the JAX flush (interpret), n = 256 and 64 overflow
    slots: 40 live slots among dead ones, no live slot (nothing moves), and
    every slot live."""
    n, ov = 256, 64
    rng = np.random.default_rng(2)
    t, j = _both(rng.standard_normal((n + ov, 128)).astype(np.float32), tdt)
    dests = np.full(ov, SENT, np.int32)
    nlive = {"mixed": 40, "empty": 0, "full": ov}[live]
    dests[rng.choice(ov, nlive, replace=False)] = rng.choice(n, nlive, replace=False)
    before = t.clone()
    _lib.reset_counts()
    flush_overflow(t, n, torch.from_numpy(dests))
    assert _lib.plain_calls["flush_overflow"] == 1 and not any(_lib.launches.values())
    ref = _np32(j_flush(j, n, jnp.asarray(dests), interpret=True))
    np.testing.assert_array_equal(t.float().numpy(), ref)
    assert torch.equal(t[n:], before[n:])
    if live == "empty":
        assert torch.equal(t, before)


# ---------------------------------------------------------------- kernel 1

@pytest.mark.parametrize("mode", ["exact_f32_dyadic", "quant16_bf16"])
def test_strip_pivots_on_sentinel_positions_match_jax(mode):
    """Kernel 1 on a deferred slab: 96 logical rows and 32 overflow rows
    below them; six overflow rows stand in for six dead (SENT) rows at
    those rows' positions, the other overflow slots are dead.  Exact piv /
    pos / glist against strip_panel_pivots(interpret=True, pos_bound=96)
    at off in {0, 8}; the search never picks a dead row."""
    m, ov = 96, 32
    rng = np.random.default_rng(11 + len(mode))
    if mode == "exact_f32_dyadic":
        # entries whose elimination stays exact in fp32 (test_panel_fused.py)
        slab = (rng.integers(-4, 5, (m + ov, 32))
                * 2.0 ** rng.integers(-2, 3, (m + ov, 32))).astype(np.float32)
        slab[slab == 0] = 1.0
        jdt, tdt = jnp.float32, torch.float32
    else:
        slab = rng.standard_normal((m + ov, 32)).astype(np.float32)
        jdt, tdt = jnp.bfloat16, torch.bfloat16
    for off in (0, 8):
        pos = np.full(m + ov, SENT, np.int32)
        pos[:m] = rng.permutation(m) if off else np.arange(m)
        stale = rng.choice(np.arange(off + 8, m), 6, replace=False)
        slots = m + rng.choice(ov, 6, replace=False)
        pos[slots] = pos[stale]
        pos[stale] = SENT
        slab[stale, 16] = 1e3        # a dead row with the largest value
        jp = j_strip(jnp.asarray(slab), off, jnp.asarray(pos), panel_dtype=jdt,
                     interpret=True, jj0=16, r=16, pos_bound=m)
        tp = strip_panel_pivots(torch.from_numpy(slab), off, torch.from_numpy(pos), tdt,
                                jj0=16, r=16, pos_bound=m)
        for name, a, b in zip(("piv", "pos", "glist"), jp, tp):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f"{name} off={off}")
        assert not np.isin(tp[2].numpy(), stale).any()
        assert (tp[1].numpy()[stale] == SENT).all()


def test_quant16_follows_pos_bound(monkeypatch):
    """quant16 is gated on the live position range, not the physical slab
    height (`panel_strip.py:822-826`): with the bound lowered to 64, a
    64-row logical slab with 32 overflow rows keeps quant16 under
    ``pos_bound=64`` (pivots equal to quant16 forced on) and takes the exact
    search without it (pivots equal to quant16 forced off); the two
    searches part on this panel."""
    monkeypatch.setattr(panel_strip, "_QUANT16_MAX_POS", 64)
    m, ov = 64, 32
    assert panel_strip._use_quant16(torch.bfloat16, m + ov, m)
    assert not panel_strip._use_quant16(torch.bfloat16, m + ov)
    assert not panel_strip._use_quant16(torch.float32, m + ov, m)
    rng = np.random.default_rng(8)
    a = rng.random((m + ov, 16)).astype(np.float32)
    pos = torch.cat([torch.arange(m, dtype=torch.int32),
                     torch.full((ov,), SENT, dtype=torch.int32)])
    t = torch.from_numpy(a)
    q16 = strip_panel_pivots(t, 0, pos, torch.bfloat16, r=16, quant16=True)
    exact = strip_panel_pivots(t, 0, pos, torch.bfloat16, r=16, quant16=False)
    assert not torch.equal(q16[0], exact[0])
    got = strip_panel_pivots(t, 0, pos, torch.bfloat16, r=16, pos_bound=m)
    assert all(torch.equal(x, y) for x, y in zip(got, q16))
    got = strip_panel_pivots(t, 0, pos, torch.bfloat16, r=16)
    assert all(torch.equal(x, y) for x, y in zip(got, exact))


# ---------------------------------------------------------------- kernel 10

def test_panel_apply_update_matches_jax_manual_case():
    """tests/test_panel_fused.py:200-220's case (m = 256, bc = 128, r = 8,
    j0 = jj0 = 16, fp32): the plain version within rtol/atol 2e-4 of the
    JAX kernel (interpret) and of the numpy formula there; frozen rows and
    the columns left of the panel exact."""
    rng = np.random.default_rng(4)
    m, bc, r, j0, jj0 = 256, 128, 8, 16, 16
    slab = rng.standard_normal((m, bc)).astype(np.float32)
    pos = rng.permutation(m).astype(np.int32)
    rowblock = rng.standard_normal((r, bc)).astype(np.float32)
    uinv = np.triu(rng.standard_normal((r, r))).astype(np.float32)
    ref = np.asarray(j_full(jnp.asarray(slab), jnp.asarray(pos), jnp.asarray(rowblock),
                            jnp.asarray(uinv), j0, jj0, rb=128, interpret=True))
    _lib.reset_counts()
    out = panel_apply_update(torch.from_numpy(slab.copy()), torch.from_numpy(pos),
                             torch.from_numpy(rowblock), torch.from_numpy(uinv), j0,
                             jj0).numpy()
    assert _lib.plain_calls["panel_update_full"] == 1 and not any(_lib.launches.values())
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
    below = pos >= j0 + r
    l21 = slab[:, jj0:jj0 + r] @ uinv
    u12m = rowblock.copy()
    u12m[:, :jj0 + r] = 0.0
    expect = slab - np.where(below[:, None], l21 @ u12m, 0.0)
    expect[:, jj0:jj0 + r] = np.where(below[:, None], l21, slab[:, jj0:jj0 + r])
    np.testing.assert_allclose(out, expect, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(out[~below], slab[~below])
    np.testing.assert_array_equal(out[:, :jj0], slab[:, :jj0])


@pytest.mark.parametrize("tdt,gemm_bf16", [(torch.float32, False), (torch.float32, True),
                                           (torch.bfloat16, False)])
def test_panel_apply_update_matches_jax_and_trim(tdt, gemm_bf16):
    """tests/test_panel_fused.py:406-438's cases (m = 128, bc = 1024, r =
    8, jj0 in {0, 24, 520}), each instance of kernel 10: the plain version
    against the JAX kernel (interpret) within that test's tolerance (1e-5
    fp32; 3e-2 for bf16 slabs and for bf16 update operands, where an fp32
    L21 one ulp apart can round to bf16 values one bf16 ulp apart); bitwise
    equal to the port's trimmed B (kernel 3's or kernel 12's plain
    versions: the same operations on the same shapes) on every column at
    and right of the panel; columns left of the panel and frozen rows
    exact."""
    rng = np.random.default_rng(9)
    m, bc, r = 128, 1024, 8
    tol = 1e-5 if tdt == torch.float32 and not gemm_bf16 else 3e-2
    for j0, jj0 in ((0, 0), (24, 24), (520, 520)):
        slab, jslab = _both(rng.standard_normal((m, bc)).astype(np.float32), tdt)
        pos = rng.permutation(m).astype(np.int32)
        rowblock, jrb = _both(rng.standard_normal((r, bc)).astype(np.float32), tdt)
        uinv, jui = _both(np.triu(rng.standard_normal((r, r))).astype(np.float32), tdt)
        ref = _np32(j_full(jslab, jnp.asarray(pos), jrb, jui, j0, jj0, rb=128,
                           gemm_bf16=gemm_bf16, interpret=True))
        tpos = torch.from_numpy(pos)
        full = panel_apply_update(slab.clone(), tpos, rowblock, uinv, j0, jj0, gemm_bf16)
        trim = panel_apply_update_trim(slab.clone(), tpos, rowblock, uinv, j0, jj0, gemm_bf16)
        out = full.float().numpy()
        np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)
        assert torch.equal(full[:, jj0:], trim[:, jj0:])
        assert torch.equal(full[:, :jj0], slab[:, :jj0])
        frozen = torch.from_numpy(pos < j0 + r)
        assert torch.equal(full[frozen], slab[frozen])


# ---------------------------------------------------------------- the driver

def _factor(a, monkeypatch, policy=T.MPF_BF16, defer=None, block=128, r=32):
    """The port's factorization of the numpy matrix ``a`` on the CPU; with
    ``defer``, also the live overflow rows each flush moved home."""
    moved = []
    if defer:
        real = TM.flush_overflow

        def counting(a_ext, novstart, dests):
            moved.append(int((dests < novstart).sum()))
            return real(a_ext, novstart, dests)
        monkeypatch.setattr(TM, "flush_overflow", counting)
    _lib.reset_counts()
    res = T.mpf_factorize(torch.from_numpy(a), r=r, policy=policy, block=block, defer=defer)
    assert not any(_lib.launches.values())
    if defer:
        monkeypatch.setattr(TM, "flush_overflow", real)
    return res, dict(_lib.plain_calls), moved


def _assert_same(d, e):
    assert torch.equal(d.ipiv, e.ipiv) and torch.equal(d.perm, e.perm)
    assert int(d.info) == int(e.info)
    assert torch.equal(d.lu, e.lu)


@pytest.mark.parametrize("case", ["uniform_mpf_bf16", "uniform_all_bf16", "diag_dominant",
                                  "group_covers_all", "pre_extended", "s1_all_bf16"])
def test_defer_bitwise_equals_classic(monkeypatch, case):
    """The five cases of tests/test_defer.py (the first in both policies)
    at r = 32, block 128: the deferred driver against the port's classic
    loop.  ipiv, perm and info exact, and the factors bitwise equal in
    every case, under ALL_BF16 too: torch's CPU GEMM gives each row the
    same sums whatever the height of the slab (the JAX test needs its
    relaxed bound there, `test_defer.py:39-49`; this port needs none).
    The flush counts state the deferral happened (or, where S covers every
    block column, that nothing deferred); the HPL-AI oracle at 1e-2 as
    tests/test_defer.py:72-74."""
    S = {"group_covers_all": 4, "s1_all_bf16": 1}.get(case, 2)
    n = 384 if case == "group_covers_all" else 512
    policy = T.ALL_BF16 if "all_bf16" in case else T.MPF_BF16
    if case == "diag_dominant":
        rng = np.random.default_rng(7)
        a = rng.standard_normal((n, n)).astype(np.float32) + np.eye(n, dtype=np.float32) * n
    else:
        seed = {"uniform_mpf_bf16": 3, "uniform_all_bf16": 3, "group_covers_all": 11,
                "pre_extended": 13, "s1_all_bf16": 5}[case]
        a = matgen.random_dense(n, seed=seed).astype(np.float32)
    e, _, _ = _factor(a, monkeypatch, policy)
    inp = a
    if case == "pre_extended":
        inp = np.concatenate([a, np.full((S * 128, n), 7.25, np.float32)])
    d, calls, moved = _factor(inp, monkeypatch, policy, defer=S)
    _assert_same(d, e)
    assert d.lu.shape == (n, n)
    ncols = n // 128
    groups = -(-ncols // S)
    assert calls["copy_rows"] == ncols and calls["flush_overflow"] == groups
    assert calls["rows_exchange"] == ncols
    if case == "group_covers_all":
        assert moved == [0]
    elif case != "diag_dominant":
        assert sum(moved) > 0
    assert check_factorization(a.astype(np.float64), d.lu.float().numpy(), d.ipiv.numpy(),
                               nbe_tol=1e-2).ok


def test_defer_pre_extended_in_place():
    """A pre-extended working-dtype input is factored in place through
    mpf_factorize_inplace and make_mpf (``lu`` is its first n rows); the
    square input through make_mpf gives the same result."""
    n, S = 512, 2
    a = matgen.hpl_ai_matrix(n, seed=6).astype(np.float32)
    ext = torch.cat([torch.from_numpy(a), torch.zeros(S * 128, n)])
    ref = T.mpf_factorize(torch.from_numpy(a), r=32, block=128)
    work = ext.clone()
    res = TM.mpf_factorize_inplace(work, r=32, block=128, defer=S)
    assert res.lu.data_ptr() == work.data_ptr() and torch.equal(res.lu, ref.lu)
    fac = T.make_mpf(n, r=32, block=128, defer=S)
    work = ext.clone()
    res = fac(work)
    assert res.lu.data_ptr() == work.data_ptr() and torch.equal(res.ipiv, ref.ipiv)
    assert torch.equal(fac(torch.from_numpy(a)).lu, ref.lu)


@pytest.mark.parametrize("variant", ["lookahead", "superblock", "split", "mpf_fp16",
                                     "no_pivot", "ragged_n"])
def test_defer_routing_resolves_off(monkeypatch, variant):
    """Where the JAX gate would not defer, ``defer=2`` runs without it
    (`mpf.py:1059-1109`): lookahead wins, a superblock, ``MPF_XCHG=split``,
    MPF_FP16 (masked), ``pivot=False`` and n % block != 0 resolve to 0, so
    no band copy or flush runs."""
    n = 448 if variant == "ragged_n" else 512
    a = torch.from_numpy(matgen.hpl_ai_matrix(n, seed=8).astype(np.float32))
    kw = dict(r=32, block=128, defer=2)
    if variant == "lookahead":
        kw["lookahead"] = True
    elif variant == "superblock":
        kw["super_block"] = 256
    elif variant == "split":
        monkeypatch.setenv("MPF_XCHG", "split")
    elif variant == "mpf_fp16":
        kw["policy"] = T.MPF_FP16
    elif variant == "no_pivot":
        kw["pivot"] = False
    _lib.reset_counts()
    res = T.mpf_factorize(a, **kw)
    assert _lib.plain_calls["copy_rows"] == _lib.plain_calls["flush_overflow"] == 0
    assert int(res.info) == 0 and not any(_lib.launches.values())
    if variant == "lookahead":
        assert _lib.plain_calls["gemmx"] > 0


def test_row_extended_input_that_does_not_resolve_raises():
    """A rectangular input is accepted only when the resolved S·block
    equals its extra rows (`mpf.py:1092-1109`), with the JAX messages."""
    a = torch.zeros(512 + 256, 512)
    with pytest.raises(ValueError, match="ov=256.*resolved S=1"):
        T.mpf_factorize(a, r=32, block=128, defer=1)
    with pytest.raises(ValueError, match="resolved S=0"):
        T.mpf_factorize(a, r=32, block=128, defer=False)
    with pytest.raises(ValueError, match="requires the deferred-exchange path"):
        T.mpf_factorize(a, r=32, block=128, defer=2, pivot=False)
    with pytest.raises(ValueError, match="square or row-extended"):
        T.mpf_factorize(torch.zeros(256, 512))
    with pytest.raises(ValueError, match="expected"):
        T.make_mpf(512, r=32, block=128, defer=2)(torch.zeros(512, 256))


def test_defer_extension_and_env(monkeypatch):
    """``defer_extension`` (`mpf.py:937-946`): S·block rows where the gate
    holds, 0 where it does not; ``MPF_DEFER=S``, ``defer=True`` with
    ``MPF_DEFER_S`` and ``auto`` with ``MPF_DEFER_AUTO_S`` (kept only for
    bf16 working storage at n >= 49152); make_mpf reads the knobs once."""
    ext = TM.defer_extension
    assert ext(16384, defer=8) == 8192 and ext(16384, defer=False) == 0
    assert ext(1024, defer=8) == 0                 # n < 2 block
    assert ext(16384, policy=T.MPF_FP16, defer=8) == 0
    assert ext(16384, block=1000, defer=8) == 0    # n % block
    assert ext(16384, defer=8, pivot=False) == 0
    monkeypatch.setenv("MPF_DEFER_S", "3")
    assert ext(16384, defer=True) == 3072
    monkeypatch.setenv("MPF_DEFER", "auto")
    assert ext(65536, policy=T.ALL_BF16) == 0      # MPF_DEFER_AUTO_S unset
    monkeypatch.setenv("MPF_DEFER_AUTO_S", "8")
    assert ext(65536, policy=T.ALL_BF16) == 8192
    assert ext(32768, policy=T.ALL_BF16) == 0 and ext(65536) == 0
    monkeypatch.setenv("MPF_DEFER", "0")
    assert config.resolve_defer() == 0 and ext(65536, policy=T.ALL_BF16) == 0
    monkeypatch.setenv("MPF_DEFER", "2")
    assert config.resolve_defer() == 2 and config.resolve_defer(False) == 0
    a = torch.from_numpy(matgen.hpl_ai_matrix(512, seed=9).astype(np.float32))
    _lib.reset_counts()
    T.mpf_factorize(a, r=32, block=128)
    assert _lib.plain_calls["flush_overflow"] == 2
    fac = T.make_mpf(512, r=32, block=128)
    monkeypatch.setenv("MPF_DEFER", "0")
    fac(a.clone())
    assert _lib.plain_calls["flush_overflow"] == 4


@pytest.mark.parametrize("which", ["hpl_ai", "uniform"])
def test_device_generators_ext_rows_prefix(monkeypatch, which):
    """``ext_rows`` appends rows and leaves the first n bit-identical to the
    ``ext_rows=0`` matrix, in fp32 and bf16, across several generation
    chunks (the chunk size lowered to 10 rows)."""
    monkeypatch.setattr(tmatgen, "_CHUNK_ELEMS", 64 * 10)
    gen = {"hpl_ai": tmatgen.hpl_ai_matrix_device, "uniform": tmatgen.random_dense_device}[which]
    for dt in (torch.float32, torch.bfloat16):
        base = gen(64, seed=3, dtype=dt, device="cpu")
        ext = gen(64, seed=3, dtype=dt, device="cpu", ext_rows=48)
        assert ext.shape == (112, 64) and ext.dtype == dt
        assert torch.equal(ext[:64], base) and not ext[64:].any()
