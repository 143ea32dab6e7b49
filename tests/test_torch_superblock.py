"""Port parity for the superblock (three-level) driver and the env knobs of
`mpf_tpu_torch/config.py`: superblocking against the JAX package's
``mpf_factorize(super_block=S)`` on the cases of tests/test_superblock.py,
``_resolve_super`` and ``MPF_SUPER`` as tests/test_superblock.py holds
them, the split row exchange (``MPF_XCHG=split``, kernel 11) against the
combined one, and ``MPF_DEFER``.  Inputs come from numpy with fixed seeds;
each test states its tolerance."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import mpf_tpu  # noqa: E402
from mpf_tpu.utils import matgen  # noqa: E402

import mpf_tpu_torch as T  # noqa: E402
from mpf_tpu_torch import config  # noqa: E402
from mpf_tpu_torch.convert import policy_from_jax, result_to_numpy  # noqa: E402
from mpf_tpu_torch.models.mpf import _resolve_super  # noqa: E402
from mpf_tpu_torch.ops import _lib  # noqa: E402
from mpf_tpu_torch.utils.oracle import check_factorization  # noqa: E402


@pytest.mark.parametrize("n,r,block,S,fp16_agree", [
    (512, 64, 64, 256, 163),    # full superblocks
    (640, 64, 128, 256, 167),   # partial last superblock
    (300, 32, 64, 128, 300),    # non-aligned n
])
def test_superblock_matches_jax(n, r, block, S, fp16_agree):
    """The uniform matrix of tests/test_superblock.py:24-43, factored by the
    port and by the JAX package (its CPU driver) with ``super_block=S``.
    PURE_FP32: ipiv and perm exact, both oracles at 1e-6.  MPF_FP16 (the
    masked path on both sides): pivots exact up to ``fp16_agree``, the
    first divergence, which the same comparison WITHOUT a superblock shows
    at the same pivot (fp16 rounding of the panel makes fp32 sums in
    another order visible), both oracles at 5e-4.  MPF_BF16: the port takes
    its fused path with the quant16 search, the JAX CPU driver the masked
    path with the exact search, so only both oracles, at 1e-3."""
    a = matgen.random_dense(n, seed=n)
    for pol, tol in ((mpf_tpu.PURE_FP32, 1e-6), (mpf_tpu.MPF_FP16, 5e-4),
                     (mpf_tpu.MPF_BF16, 1e-3)):
        j = jax.tree.map(np.asarray, mpf_tpu.mpf_factorize(
            jnp.asarray(a, jnp.float32), r=r, policy=pol, block=block, super_block=S))
        t = result_to_numpy(T.mpf_factorize(torch.from_numpy(a.astype(np.float32)), r=r,
                                            policy=policy_from_jax(pol), block=block,
                                            super_block=S))
        for res in (t, j):
            assert check_factorization(a, res.lu, res.ipiv, nbe_tol=tol).ok, pol.name
        if pol is mpf_tpu.PURE_FP32:
            np.testing.assert_array_equal(t.ipiv, j.ipiv)
            np.testing.assert_array_equal(t.perm, j.perm)
        elif pol is mpf_tpu.MPF_FP16:
            np.testing.assert_array_equal(t.ipiv[:fp16_agree], j.ipiv[:fp16_agree])
            t0 = result_to_numpy(T.mpf_factorize(torch.from_numpy(a.astype(np.float32)),
                                                 r=r, policy=T.MPF_FP16, block=block))
            j0 = jax.tree.map(np.asarray, mpf_tpu.mpf_factorize(
                jnp.asarray(a, jnp.float32), r=r, policy=pol, block=block, super_block=None))
            d0 = np.nonzero(t0.ipiv != j0.ipiv)[0]
            assert (d0[0] if d0.size else n) == fp16_agree


def test_superblock_launches_and_pivots():
    """n = 512, block 64, S = 256, MPF_BF16 on the fused path: 6 mid
    updates (a mid update with no columns left returns at once) and 1 far
    update, so kernel 6 runs 7 times and kernel 5 10 times (1 per mid
    update, 4 in the far update's per-block U12); PURE_FP32 pivots equal
    the classic loop's (the same update content, other fp32 groupings), LU
    within tests/test_superblock.py's rtol 1e-3, atol 5e-3."""
    a = torch.from_numpy(matgen.random_dense(512, seed=3).astype(np.float32))
    _lib.reset_counts()
    T.mpf_factorize(a, r=64, block=64, super_block=256)
    assert _lib.plain_calls["trailing_sub"] == 7 and _lib.plain_calls["tri_inv"] == 10
    assert not any(_lib.launches.values())
    s = T.mpf_factorize(a, r=64, policy=T.PURE_FP32, block=64, super_block=256)
    c = T.mpf_factorize(a, r=64, policy=T.PURE_FP32, block=64)
    assert torch.equal(s.ipiv, c.ipiv)
    torch.testing.assert_close(s.lu, c.lu, rtol=1e-3, atol=5e-3)


def test_resolve_super():
    """tests/test_superblock.py:90-102: ``auto`` is disabled; explicit
    widths that are no multiple of block, not wider than it, or wider than
    n / 2 disable it without error."""
    assert _resolve_super(32768, 1024, config.super_block("auto")) is None
    assert _resolve_super(8192, 1024, config.super_block("auto")) is None
    assert _resolve_super(2048, 1024, config.super_block("auto")) is None
    assert _resolve_super(32768, 1024, config.super_block(None)) is None
    assert _resolve_super(32768, 1024, config.super_block(8192)) == 8192
    assert _resolve_super(32768, 1024, config.super_block(1536)) is None
    assert _resolve_super(32768, 1024, config.super_block(1024)) is None
    assert _resolve_super(4096, 1024, config.super_block(4096)) is None


def test_resolve_super_env(monkeypatch):
    """tests/test_superblock.py:105-111, and the knob driving the
    factorization: MPF_SUPER=256 superblocks a default call (kernel 5 runs
    in the far update), an explicit ``super_block=None`` wins over it."""
    monkeypatch.setenv("MPF_SUPER", "0")
    assert _resolve_super(32768, 1024, config.super_block("auto")) is None
    monkeypatch.setenv("MPF_SUPER", "8192")
    assert _resolve_super(32768, 1024, config.super_block("auto")) == 8192
    monkeypatch.setenv("MPF_SUPER", "auto")
    assert _resolve_super(32768, 1024, config.super_block(None)) is None
    a = torch.from_numpy(matgen.hpl_ai_matrix(512, seed=4).astype(np.float32))
    monkeypatch.setenv("MPF_SUPER", "256")
    _lib.reset_counts()
    T.mpf_factorize(a, r=64, block=64)
    assert _lib.plain_calls["tri_inv"] == 10
    T.mpf_factorize(a, r=64, block=64, super_block=None)
    assert _lib.plain_calls["tri_inv"] == 17


@pytest.mark.parametrize("policy", [T.MPF_BF16, T.ALL_BF16, T.PURE_FP32])
@pytest.mark.parametrize("gen", [matgen.hpl_ai_matrix, matgen.random_dense])
def test_split_exchange_equals_combined(monkeypatch, policy, gen):
    """MPF_XCHG=split routes every fused block column's exchange through
    kernel 11 (a gather, then a scatter from the band; 4 each at n = 512,
    block 128) instead of kernel 4: factors, pivots and row map bitwise
    equal to the combined route.  Read at each mpf_factorize call, and by
    make_mpf when it builds."""
    a = torch.from_numpy(gen(512, seed=5).astype(np.float32))
    c = T.mpf_factorize(a, r=32, policy=policy, block=128)
    monkeypatch.setenv("MPF_XCHG", "split")
    _lib.reset_counts()
    s = T.mpf_factorize(a, r=32, policy=policy, block=128)
    assert _lib.plain_calls["rows_gather"] == _lib.plain_calls["rows_scatter"] == 4
    assert _lib.plain_calls["rows_exchange"] == 0 and not any(_lib.launches.values())
    assert torch.equal(s.lu, c.lu) and torch.equal(s.ipiv, c.ipiv)
    assert torch.equal(s.perm, c.perm)
    fac = T.make_mpf(512, r=32, policy=policy, block=128, donate=False)
    monkeypatch.delenv("MPF_XCHG")
    assert torch.equal(fac(a).lu, c.lu) and _lib.plain_calls["rows_gather"] == 8


def test_split_exchange_gates_lookahead(monkeypatch):
    """The lookahead gate needs the combined exchange (`mpf.py:1064`):
    under MPF_XCHG=split a lookahead request runs the classic loop."""
    a = torch.from_numpy(matgen.hpl_ai_matrix(512, seed=6).astype(np.float32))
    monkeypatch.setenv("MPF_XCHG", "split")
    _lib.reset_counts()
    T.mpf_factorize(a, r=32, block=128, lookahead=True)
    assert _lib.plain_calls["gemmx"] == 0 and _lib.plain_calls["rows_gather"] == 4


def test_defer_runs(monkeypatch):
    """The deferred exchange is ported: ``defer=S``, ``defer=True`` (with
    ``MPF_DEFER_S``) and ``MPF_DEFER=<int>`` (read by make_mpf when it
    builds) run it on the CPU through the plain versions (band copies and
    flushes counted, no launch), with the classic loop's pivots; ``auto``,
    ``0``, ``False`` and ``pivot=False`` resolve to 0 and factor."""
    a = torch.from_numpy(matgen.hpl_ai_matrix(512, seed=10).astype(np.float32))
    ref = T.mpf_factorize(a, r=32, block=128)
    monkeypatch.setenv("MPF_DEFER_S", "4")
    for kw, flushes in ((dict(defer=2), 2), (dict(defer=True), 1)):
        _lib.reset_counts()
        res = T.mpf_factorize(a, r=32, block=128, **kw)
        assert _lib.plain_calls["flush_overflow"] == flushes, kw
        assert _lib.plain_calls["copy_rows"] == 4 and not any(_lib.launches.values())
        assert torch.equal(res.ipiv, ref.ipiv) and torch.equal(res.lu, ref.lu)
    monkeypatch.setenv("MPF_DEFER", "1")
    fac = T.make_mpf(512, r=32, block=128)
    _lib.reset_counts()
    assert torch.equal(fac(a.clone()).perm, ref.perm)
    assert _lib.plain_calls["flush_overflow"] == 4
    assert config.resolve_defer(None, pivot=False) == 0
    assert config.resolve_defer(False) == 0
    for env in ("auto", "0"):
        monkeypatch.setenv("MPF_DEFER", env)
        assert config.resolve_defer() == 0
        _lib.reset_counts()
        assert int(T.mpf_factorize(a, r=32, block=128).info) == 0
        assert _lib.plain_calls["copy_rows"] == 0
