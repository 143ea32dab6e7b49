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
    fused main path runs the six plain versions of its kernels (1-6), none
    of the masked path's, and launches no kernel."""
    n = 256
    a = torch.from_numpy(matgen.hpl_ai_matrix(n, seed=6).astype(np.float32))
    ref = T.mpf_factorize(a, r=32, block=128)
    work = a.clone()
    _lib.reset_counts()
    res = T.make_mpf(n, r=32, block=128)(work)
    assert res.lu.data_ptr() == work.data_ptr()
    assert torch.equal(res.lu, ref.lu) and torch.equal(res.ipiv, ref.ipiv)
    fused = ("strip_pivots", "rowblock", "panel_update", "rows_exchange", "tri_inv",
             "trailing_sub")
    assert all(_lib.plain_calls[k] > 0 for k in fused), _lib.plain_calls
    assert not any(_lib.plain_calls[k] for k in _lib.KERNELS if k not in fused)
    assert not any(_lib.launches.values())
    kept = T.make_mpf(n, r=32, block=128, donate=False)(a.clone().double())
    assert torch.equal(kept.lu, ref.lu)


def test_auto_block():
    assert TM._auto_block(16384, 128, T.MPF_BF16, None) == 1024
    assert TM._auto_block(32768, 128, T.MPF_BF16, None) == 2048
    assert TM._auto_block(512, 128, T.MPF_BF16, None) == 512
    assert TM._auto_block(512, 128, T.MPF_BF16, 64) == 128


@pytest.mark.parametrize("kwargs,what", [
    (dict(defer=2), "deferred"),
])
def test_outside_the_slice_raises(kwargs, what):
    """``defer`` is ported; what lies outside it still raises: a
    row-extended input whose extra rows are not the resolved S·block (here
    ``defer=2`` at n = 96, r = 8, block 96 resolves to 0, n < 2 block),
    while the square input factors with the deferral resolved off."""
    with pytest.raises(ValueError, match=what):
        T.mpf_factorize(torch.zeros(96 + 192, 96), **{"r": 8, **kwargs})
    assert int(T.mpf_factorize(torch.eye(96), **{"r": 8, **kwargs}).info) == 0


@pytest.mark.parametrize("kwargs,kernel", [
    (dict(lookahead=True), "gemmx"),
    (dict(super_block=256), "tri_inv"),
])
def test_lookahead_and_superblock_run(kwargs, kernel):
    """``lookahead`` and ``super_block`` are ported: on the HPL-AI matrix
    (n = 512, r = 32, block 128) each factors with the classic loop's
    pivots, passes the oracle at 1e-3, and runs its own work (kernel 13;
    kernel 5 once for each of the two mid updates with columns left and
    once for each of the far update's two inner blocks: 4 against the
    classic loop's 3)."""
    n = 512
    a = matgen.hpl_ai_matrix(n, seed=15).astype(np.float32)
    ref = T.mpf_factorize(torch.from_numpy(a), r=32, block=128)
    _lib.reset_counts()
    res = T.mpf_factorize(torch.from_numpy(a), r=32, block=128, **kwargs)
    assert _lib.plain_calls[kernel] == {"gemmx": 2, "tri_inv": 4}[kernel]
    assert torch.equal(res.ipiv, ref.ipiv) and torch.equal(res.perm, ref.perm)
    assert check_factorization(a, res.lu.numpy(), res.ipiv.numpy(), nbe_tol=1e-3).ok


def test_policy_working_dtype_checked():
    """Every policy of precision.POLICIES is ported; a policy whose working
    storage the kernels do not take (fp16) is refused before any work."""
    import dataclasses

    assert set(T.precision.POLICIES) == {"mpf_bf16", "mpf_ref", "mpf_fp16", "pure_fp32",
                                         "all_bf16"}
    fp16 = dataclasses.replace(T.ALL_BF16, name="fp16_storage", working=torch.float16)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        T.mpf_factorize(torch.eye(16), r=8, policy=fp16)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        T.make_mpf(16, r=8, policy=fp16)


def test_all_bf16_runs():
    """ALL_BF16 is ported: it factors in bf16 storage (the fused path at
    r = 8, the masked path at r = 12) and passes the oracle."""
    n = 96
    a = matgen.hpl_ai_matrix(n, seed=14).astype(np.float32)
    for r in (8, 12):
        res = T.mpf_factorize(torch.from_numpy(a), r=r, policy=T.ALL_BF16)
        assert res.lu.dtype == torch.bfloat16 and int(res.info) == 0
        assert check_factorization(a, res.lu.float().numpy(), res.ipiv.numpy(),
                                   nbe_tol=5e-2).ok


def test_3d_and_panel_kernel_raise():
    """A 3D input off the pair layout's fused gate raises the gate's
    ValueError (here r = 128 > n = 8: n is no multiple of the block); a
    custom ``panel_kernel`` replaces kernel 7
    in the masked path, which every block column then takes: with the
    port's ``panel_pivots_perm`` it equals the JAX factorizer given the JAX
    package's ``panel_pivots_perm`` (MPF_BF16, uniform, n = 96)."""
    from mpf_tpu.ops.getf2 import panel_pivots_perm as jax_ppp
    from mpf_tpu_torch.ops.getf2 import panel_pivots_perm

    with pytest.raises(ValueError, match="pair-layout \\(3D\\) input requires the fused"):
        T.mpf_factorize(torch.zeros(4, 2, 8))
    n = 96
    a = matgen.random_dense(n, seed=12).astype(np.float32)
    calls = []

    def kern(panel, row_offset, prev_perm):
        calls.append(panel.dtype)
        return panel_pivots_perm(panel, row_offset=row_offset, prev_perm=prev_perm)

    _lib.reset_counts()
    t = result_to_numpy(T.make_mpf(n, r=16, block=32, panel_kernel=kern)(
        torch.from_numpy(a.copy())))
    assert calls == [torch.bfloat16] * 6
    assert _lib.plain_calls["strip_pivots"] == 0 and _lib.plain_calls["hgetf2"] == 0
    j = jax.tree.map(np.asarray, mpf_tpu.make_mpf(n, r=16, block=32, panel_kernel=jax_ppp,
                                                   donate=False)(jnp.asarray(a)))
    _assert_same(t, j, n)
    assert check_factorization(a, t.lu, t.ipiv, nbe_tol=1e-3).ok


def test_numpy_input_device():
    """A numpy matrix is factored where ``device`` says (the default is
    ``cuda:0``, which raises without a card instead of running on the
    CPU); a CPU tensor stays on the CPU; make_mpf never overwrites a numpy
    input."""
    n = 64
    a = matgen.hpl_ai_matrix(n, seed=13).astype(np.float32)
    keep = a.copy()
    res = T.mpf_factorize(a, r=16, device="cpu")
    assert res.lu.device.type == "cpu"
    ref = T.mpf_factorize(torch.from_numpy(a), r=16)
    assert torch.equal(res.lu, ref.lu) and torch.equal(res.ipiv, ref.ipiv)
    res2 = T.make_mpf(n, r=16, device="cpu")(a)
    assert torch.equal(res2.lu, ref.lu)
    np.testing.assert_array_equal(a, keep)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            T.mpf_factorize(a, r=16)
        with pytest.raises(RuntimeError, match="cuda"):
            T.make_mpf(n, r=16)(a)


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
