"""Port parity for the whole slice: mpf_tpu_torch.mpf_factorize (plain
kernels on CPU tensors) against the JAX package's mpf_factorize on the
CPU, on the same numpy-generated matrices."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import mpf_tpu  # noqa: E402
import mpf_tpu_torch as T  # noqa: E402
import mpf_tpu_torch.models.mpf as TM  # noqa: E402
from mpf_tpu.utils import matgen  # noqa: E402
from mpf_tpu_torch.convert import policy_from_jax, result_to_numpy  # noqa: E402
from mpf_tpu_torch.ops import _lib  # noqa: E402
from mpf_tpu_torch.utils.oracle import check_factorization, ipiv_to_perm  # noqa: E402


def _jax(a, r, policy, block):
    res = mpf_tpu.mpf_factorize(jnp.asarray(a), r=r, policy=policy, block=block)
    return jax.tree.map(np.asarray, res)


def _port(a, r, policy, block):
    return result_to_numpy(T.mpf_factorize(torch.from_numpy(a), r=r,
                                           policy=policy_from_jax(policy), block=block))


def _assert_same(t, j, n):
    np.testing.assert_array_equal(t.ipiv, j.ipiv)
    np.testing.assert_array_equal(t.perm, j.perm)
    assert int(t.info) == int(j.info)
    np.testing.assert_array_equal(np.sort(t.perm), np.arange(n))
    np.testing.assert_array_equal(ipiv_to_perm(torch.from_numpy(t.ipiv)).numpy(), t.perm)


@pytest.mark.parametrize("n", [256, 384])
@pytest.mark.parametrize("r", [8, 32])
def test_mpf_bf16_hpl_matches_jax(n, r):
    """MPF_BF16 on the HPL-AI matrix, block 128: ipiv and perm exact, LU
    within 1e-5 * max|LU| (the bar of test_panel_fused.py:465-485), and
    the oracle at the JAX tests' MPF_BF16 bound."""
    a = matgen.hpl_ai_matrix(n, seed=0).astype(np.float32)
    t = _port(a, r, mpf_tpu.MPF_BF16, 128)
    j = _jax(a, r, mpf_tpu.MPF_BF16, 128)
    _assert_same(t, j, n)
    d = np.abs(t.lu - j.lu).max()
    assert d <= 1e-5 * np.abs(j.lu).max(), d
    rep = check_factorization(a, t.lu, t.ipiv, nbe_tol=1e-3)
    assert rep.ok, rep


def test_pure_fp32_uniform_matches_jax():
    """PURE_FP32 on the pivot-heavy uniform matrix (exact search in both):
    exact ipiv and perm; oracle at 1e-5."""
    n = 256
    a = matgen.random_dense(n, seed=0).astype(np.float32)
    t = _port(a, 8, mpf_tpu.PURE_FP32, 128)
    j = _jax(a, 8, mpf_tpu.PURE_FP32, 128)
    _assert_same(t, j, n)
    assert check_factorization(a, t.lu, t.ipiv, nbe_tol=1e-5).ok


def test_mpf_ref_hpl_matches_jax():
    """MPF_REF (bf16 panel, fp32 GEMMs): exact ipiv and perm, oracle 1e-5."""
    n = 384
    a = matgen.hpl_ai_matrix(n, seed=2).astype(np.float32)
    t = _port(a, 32, mpf_tpu.MPF_REF, 128)
    j = _jax(a, 32, mpf_tpu.MPF_REF, 128)
    _assert_same(t, j, n)
    assert check_factorization(a, t.lu, t.ipiv, nbe_tol=1e-5).ok


def test_padded_nonaligned_n():
    """n = 250 with r = 8 factors the identity-extended 256 matrix and
    slices back: ipiv/perm inside [0, n) and equal to the JAX result."""
    n = 250
    a = matgen.hpl_ai_matrix(n, seed=3).astype(np.float32)
    assert TM._pad_target(n, 8) == 256
    t = _port(a, 8, mpf_tpu.MPF_BF16, 128)
    j = _jax(a, 8, mpf_tpu.MPF_BF16, 128)
    assert t.lu.shape == (n, n)
    assert np.all((t.ipiv >= 1) & (t.ipiv <= n))
    _assert_same(t, j, n)
    assert check_factorization(a, t.lu, t.ipiv, nbe_tol=1e-3).ok


def test_singular_info_matches_jax():
    """An exactly-zero column: the port's info equals JAX's (1-based column
    of the first zero pivot)."""
    n = 256
    a = matgen.hpl_ai_matrix(n, seed=4).astype(np.float32)
    a[:, 37] = 0.0
    t = _port(a, 8, mpf_tpu.MPF_BF16, 128)
    j = _jax(a, 8, mpf_tpu.MPF_BF16, 128)
    assert int(t.info) == int(j.info) == 38
    np.testing.assert_array_equal(t.ipiv, j.ipiv)


def test_window_height_does_not_change_result(monkeypatch):
    """Rows above the block column are frozen by position, so two window
    quanta give bit-identical factors, pivots and row maps."""
    n = 384
    a = torch.from_numpy(matgen.random_dense(n, seed=5).astype(np.float32))
    outs = []
    for q in (1, 128):
        monkeypatch.setattr(TM, "_WINDOW_QUANTUM", q)
        outs.append(result_to_numpy(T.mpf_factorize(a, r=16, block=128)))
    for x, y in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(x, y)
    assert TM._window(n, 128) == 256


def test_make_mpf_inplace_and_counters():
    """make_mpf factors a working-dtype input in place; on CPU tensors the
    main path runs the six plain versions and launches no kernel."""
    n = 256
    a = torch.from_numpy(matgen.hpl_ai_matrix(n, seed=6).astype(np.float32))
    ref = T.mpf_factorize(a, r=32, block=128)
    work = a.clone()
    _lib.reset_counts()
    res = T.make_mpf(n, r=32, block=128)(work)
    assert res.lu.data_ptr() == work.data_ptr()
    assert torch.equal(res.lu, ref.lu) and torch.equal(res.ipiv, ref.ipiv)
    assert all(v > 0 for v in _lib.plain_calls.values()), _lib.plain_calls
    assert not any(_lib.launches.values())
    kept = T.make_mpf(n, r=32, block=128, donate=False)(a.clone().double())
    assert torch.equal(kept.lu, ref.lu)


def test_auto_block():
    assert TM._auto_block(16384, 128, T.MPF_BF16, None) == 1024
    assert TM._auto_block(32768, 128, T.MPF_BF16, None) == 2048
    assert TM._auto_block(512, 128, T.MPF_BF16, None) == 512
    assert TM._auto_block(512, 128, T.MPF_BF16, 64) == 128


@pytest.mark.parametrize("kwargs,what", [
    (dict(pivot=False), "pivot=False"),
    (dict(policy=T.ALL_BF16), "all_bf16"),
    (dict(policy=T.MPF_FP16), "mpf_fp16"),
    (dict(lookahead=True), "lookahead"),
    (dict(defer=2), "defer"),
    (dict(super_block=256), "super_block"),
    (dict(r=12, block=48), "off the fused path"),
])
def test_outside_the_slice_raises(kwargs, what):
    a = torch.eye(96)
    with pytest.raises(NotImplementedError, match=what):
        T.mpf_factorize(a, **{"r": 8, **kwargs})


def test_3d_and_panel_kernel_raise():
    with pytest.raises(NotImplementedError, match="3D"):
        T.mpf_factorize(torch.zeros(4, 2, 8))
    with pytest.raises(NotImplementedError, match="panel_kernel"):
        T.make_mpf(64, panel_kernel=lambda *a: None)


def _vs_jax_fused_interpret(monkeypatch, n, r, seed, agree):
    """MPF_BF16 on the pivot-heavy uniform matrix against the JAX FUSED
    path (Pallas kernels in interpret mode through the driver, set up as
    test_force_kernels.py).

    Held exact: ipiv[:agree], the pivots up to the first documented
    divergence, so the test fails if the paths part earlier; from there on
    both factors pass the MPF_BF16 oracle.  Not held exact: later pivots.
    The two paths sum fp32 products in different orders (XLA's CPU dot vs
    torch.matmul), and rounding L21 to bf16 for the update turns some of
    those one-ulp differences into one-bf16-ulp ones; the quant16 search
    then picks another of two near-equal pivots.  (The JAX package's own
    jnp path is no reference here: it takes the masked fallback, whose
    round-1 panel search has other round points, and on these matrices it
    parts from the JAX fused path itself within the first panel.)"""
    import jax.experimental.pallas.tpu as pltpu
    import mpf_tpu.config as cfg
    import mpf_tpu.models.mpf as M

    monkeypatch.setattr(M, "_PAD_QUANTUM", 128)
    monkeypatch.setattr(M, "_FUSED_RB", 128)
    monkeypatch.setattr(cfg, "_USE_PALLAS", "1")
    monkeypatch.setenv("MPF_FORCE_KERNELS", "1")
    a = matgen.random_dense(n, seed=seed).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        j = jax.tree.map(np.asarray, M.mpf_factorize_traced(
            jnp.asarray(a), r=r, policy=mpf_tpu.MPF_BF16, block=128))
    t = _port(a, r, mpf_tpu.MPF_BF16, 128)
    np.testing.assert_array_equal(t.ipiv[:agree], j.ipiv[:agree])
    for res in (t, j):
        assert check_factorization(a, res.lu, res.ipiv, nbe_tol=1e-3).ok
        np.testing.assert_array_equal(np.sort(res.perm), np.arange(n))


def test_uniform_first_block_columns_vs_jax_fused_interpret(monkeypatch):
    """n = 256, r = 32: the paths first part at pivot 150, in the second
    block column; the whole first block column, its exchange and trailing
    update are held exact through their pivots."""
    _vs_jax_fused_interpret(monkeypatch, 256, 32, 0, agree=150)


@pytest.mark.slow
def test_uniform_vs_jax_fused_interpret(monkeypatch):
    """n = 384, r = 32: the paths first part at pivot 104."""
    _vs_jax_fused_interpret(monkeypatch, 384, 32, 9, agree=104)
