"""Port parity for the masked path: mpf_tpu_torch.mpf_factorize on CPU
tensors (the plain versions of kernels 5-9) against the JAX package's
mpf_factorize on the CPU, which takes its masked jnp path, on the same
numpy matrices.  Mirrors tests/test_mpf.py case by case, plus MPF_FP16 on
the HPL-AI and the uniform matrix at n = 256.

Held exact: ``ipiv``, ``perm`` and ``info``.  Factors: within 1e-5 of
max|LU| on the HPL-AI matrix and up to n = 128; within 1e-4 on the
uniform matrix at n = 256 (measured 1.6e-5 to 2.3e-5: the inverses and
products sum in another order than XLA's triangular_solve and dots, and
the elimination of a pivot-heavy matrix amplifies the last-bit differences;
the JAX package's own fp32 block-size test allows 1e-3).  Oracle: the JAX
test's own bound.  Under the bf16-panel policies (MPF_BF16, MPF_REF) on the
uniform matrix the two can part: a one-ulp fp32 sum-order difference in the
working matrix can round to another bf16 value in a later panel, and the
search then takes the other of two near-equal candidates.  There the pivots
are held exact up to the documented first divergence (and the divergence
itself is asserted, so a change that moves it fails), and both factors are
held to the oracle."""

import numpy as np
import pytest
import scipy.linalg
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


@pytest.fixture
def masked(monkeypatch):
    """Route every block column to the masked path, as the JAX package's
    factorization routes it on the CPU (its fused gate needs the Pallas
    kernels)."""
    monkeypatch.setattr(TM, "_fused_ok", lambda bc, r: False)


def jax_fac(a, r, policy, block=None, pivot=True):
    res = mpf_tpu.mpf_factorize(jnp.asarray(a, jnp.float32), r=r, policy=policy,
                                block=block, pivot=pivot)
    return jax.tree.map(np.asarray, res)


def port_fac(a, r, policy, block=None, pivot=True):
    return result_to_numpy(T.mpf_factorize(np.asarray(a, np.float32), r=r,
                                           policy=policy_from_jax(policy), block=block,
                                           pivot=pivot, device="cpu"))


def assert_prefix(t, j, agree):
    """Pivots exact before ``agree``, different at it."""
    np.testing.assert_array_equal(t.ipiv[:agree], j.ipiv[:agree])
    assert t.ipiv[agree] != j.ipiv[agree]


def assert_same(t, j, lu_tol=1e-5):
    n = t.lu.shape[0]
    np.testing.assert_array_equal(t.ipiv, j.ipiv)
    np.testing.assert_array_equal(t.perm, j.perm)
    assert int(t.info) == int(j.info)
    np.testing.assert_array_equal(np.sort(t.perm), np.arange(n))
    np.testing.assert_array_equal(ipiv_to_perm(torch.from_numpy(t.ipiv)).numpy(), t.perm)
    d = np.abs(t.lu - j.lu).max()
    assert d <= lu_tol * np.abs(j.lu).max(), d / np.abs(j.lu).max()


@pytest.mark.parametrize("n,r", [(8, 4), (32, 8), (64, 16), (96, 32), (50, 16)])
def test_oracle_fp32(n, r, masked):
    a = matgen.random_dense(n, seed=n + r)
    t, j = port_fac(a, r, mpf_tpu.PURE_FP32), jax_fac(a, r, mpf_tpu.PURE_FP32)
    assert_same(t, j)
    assert int(t.info) == 0
    assert check_factorization(a, t.lu, t.ipiv, nbe_tol=1e-6).ok


@pytest.mark.parametrize("n,r,agree", [(32, 8, None), (64, 16, None), (128, 32, 94)])
def test_oracle_mixed_bf16(n, r, agree, masked):
    a = matgen.random_dense(n, seed=n)
    t, j = port_fac(a, r, mpf_tpu.MPF_BF16), jax_fac(a, r, mpf_tpu.MPF_BF16)
    if agree is None:
        assert_same(t, j, lu_tol=1e-4)
    else:
        assert_prefix(t, j, agree)
    for res in (t, j):
        assert check_factorization(a, res.lu, res.ipiv, nbe_tol=5e-4).ok


def test_pivots_match_lapack_fp32(masked):
    n, r = 48, 16
    a = matgen.random_dense(n, seed=9)
    t = port_fac(a, r, mpf_tpu.PURE_FP32)
    _, piv = scipy.linalg.lu_factor(np.asarray(a, dtype=np.float64))
    np.testing.assert_array_equal(t.ipiv - 1, piv)
    assert_same(t, jax_fac(a, r, mpf_tpu.PURE_FP32))


def test_reference_corpus_end_to_end(masked):
    """The glibc-rand corpus, sizes 2..32, r = 8, MPF_BF16."""
    for a in matgen.generate_corpus(32):
        t, j = port_fac(a, 8, mpf_tpu.MPF_BF16), jax_fac(a, 8, mpf_tpu.MPF_BF16)
        np.testing.assert_array_equal(t.ipiv, j.ipiv)
        np.testing.assert_array_equal(t.perm, j.perm)
        assert check_factorization(a, t.lu, t.ipiv, nbe_tol=1e-3).ok, a.shape


@pytest.mark.parametrize("policy", ["PURE_FP32", "MPF_BF16", "MPF_FP16"])
def test_no_pivot_mode(policy):
    """pivot=False always takes the masked path: identity ipiv, no row
    exchange; equal to JAX's."""
    n = 64
    rng = np.random.default_rng(0)
    a = rng.random((n, n)).astype(np.float32) + n * np.eye(n, dtype=np.float32)
    p = getattr(mpf_tpu, policy)
    _lib.reset_counts()
    t, j = port_fac(a, 16, p, pivot=False), jax_fac(a, 16, p, pivot=False)
    assert _lib.plain_calls["hgetf2"] == 0 and _lib.plain_calls["laswp"] == 0
    assert _lib.plain_calls["npv_inv"] == 4
    np.testing.assert_array_equal(t.ipiv, np.arange(1, n + 1))
    assert_same(t, j)
    tol = 1e-6 if policy == "PURE_FP32" else 1e-3
    assert check_factorization(a, t.lu, t.ipiv, nbe_tol=tol).ok


def test_fp16_parity_policy():
    """MPF_FP16 (saturating fp16 panel) always takes the masked path."""
    a = matgen.random_dense(48, seed=3)
    _lib.reset_counts()
    t, j = port_fac(a, 16, mpf_tpu.MPF_FP16), jax_fac(a, 16, mpf_tpu.MPF_FP16)
    assert _lib.plain_calls["hgetf2"] == 3 and _lib.plain_calls["strip_pivots"] == 0
    assert_same(t, j)
    assert check_factorization(a, t.lu, t.ipiv, nbe_tol=5e-4).ok


def test_singular_matrix_info():
    a = np.zeros((8, 8), dtype=np.float32)
    t, j = port_fac(a, 4, mpf_tpu.MPF_BF16), jax_fac(a, 4, mpf_tpu.MPF_BF16)
    assert int(t.info) == int(j.info) > 0
    np.testing.assert_array_equal(t.ipiv, j.ipiv)


@pytest.mark.parametrize("policy", ["MPF_FP16", "PURE_FP32"])
def test_zero_column_info(policy):
    n = 64
    a = matgen.hpl_ai_matrix(n, seed=4)
    a[:, 37] = 0.0
    p = getattr(mpf_tpu, policy)
    t, j = port_fac(a, 16, p, block=32), jax_fac(a, 16, p, block=32)
    assert int(t.info) == int(j.info) == 38
    np.testing.assert_array_equal(t.ipiv, j.ipiv)


def test_ipiv_identity_tail():
    """n = 9, r = 4: the 1x1 tail panel is skipped (`MPF.cu:104`)."""
    n = 9
    a = matgen.random_dense(n, seed=5)
    t, j = port_fac(a, 4, mpf_tpu.PURE_FP32), jax_fac(a, 4, mpf_tpu.PURE_FP32)
    assert int(t.ipiv[-1]) == n
    assert_same(t, j)
    assert check_factorization(a, t.lu, t.ipiv, nbe_tol=1e-6).ok


@pytest.mark.parametrize("r", [16, 32])
@pytest.mark.parametrize("corpus", ["hpl_ai", "uniform"])
def test_mpf_fp16_n256(r, corpus):
    """The slice's policy at a test size: n = 256, block 128."""
    n = 256
    a = (matgen.hpl_ai_matrix if corpus == "hpl_ai" else matgen.random_dense)(n, seed=7)
    t = port_fac(a, r, mpf_tpu.MPF_FP16, block=128)
    j = jax_fac(a, r, mpf_tpu.MPF_FP16, block=128)
    assert_same(t, j, lu_tol=1e-5 if corpus == "hpl_ai" else 1e-4)
    assert int(t.info) == 0
    for res in (t, j):
        assert check_factorization(a, res.lu, res.ipiv, nbe_tol=5e-4).ok


@pytest.mark.parametrize("policy,seed,agree", [
    ("PURE_FP32", 8, None), ("MPF_REF", 1, None), ("MPF_REF", 8, 190)])
def test_fp32_gemm_policies_uniform_n256(policy, seed, agree, masked):
    """fp32 GEMMs (PURE_FP32, MPF_REF), uniform matrix, n = 256, r = 16;
    MPF_REF's bf16 panel parts from JAX at pivot 190 on seed 8 (the
    second block column's 63rd pivot)."""
    n = 256
    a = matgen.random_dense(n, seed=seed)
    p = getattr(mpf_tpu, policy)
    t, j = port_fac(a, 16, p, block=128), jax_fac(a, 16, p, block=128)
    if agree is None:
        assert_same(t, j, lu_tol=1e-4)
    else:
        assert_prefix(t, j, agree)
    for res in (t, j):
        assert check_factorization(a, res.lu, res.ipiv, nbe_tol=1e-5).ok


def test_mpf_bf16_uniform_first_divergence(masked):
    """MPF_BF16 on the uniform matrix, n = 256, r = 16: the port and JAX
    first choose different pivots at 142 (in the second block column); the
    pivots before are held exact, both factors pass the MPF_BF16 oracle."""
    n, agree = 256, 142
    a = matgen.random_dense(n, seed=1)
    t = port_fac(a, 16, mpf_tpu.MPF_BF16, block=128)
    j = jax_fac(a, 16, mpf_tpu.MPF_BF16, block=128)
    assert_prefix(t, j, agree)
    for res in (t, j):
        assert check_factorization(a, res.lu, res.ipiv, nbe_tol=1e-3).ok
