"""Port parity for `mpf_tpu_torch/ops/pivoting.py` and the TRSM / trailing
half of `ops/blas3.py` (modules 2 and 3 of the masked path), against the
JAX package's functions and the numpy sequential-swap reference of
tests/test_pivoting.py.

Tolerances: row exchanges bit-exact (they move values); TRSMs and the fp32
trailing update within 1e-5 of the JAX result relative to its largest entry
(IEEE fp32 products summed in another order); the bf16 trailing update
within one bf16-operand product's rounding, as tests/test_blas3.py bounds
it."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpf_tpu.ops import blas3 as JB  # noqa: E402
from mpf_tpu.ops import pivoting as JP  # noqa: E402
from mpf_tpu.precision import MPF_BF16 as J_BF16, PURE_FP32 as J_FP32  # noqa: E402
from mpf_tpu_torch import MPF_BF16, PURE_FP32  # noqa: E402
from mpf_tpu_torch.ops import blas3 as B  # noqa: E402
from mpf_tpu_torch.ops import pivoting as P  # noqa: E402


def _apply_swaps_numpy(a, piv_global, k):
    a = a.copy()
    for j, p in enumerate(piv_global):
        a[[k + j, p], :] = a[[p, k + j], :]
    return a


@pytest.mark.parametrize("seed", range(5))
def test_sequential_swap_equivalence(seed):
    rng = np.random.default_rng(seed)
    n, k, r = 24, 8, 4
    a = rng.random((n, n)).astype(np.float32)
    piv = np.array([k + j + rng.integers(0, n - k - j) for j in range(r)], dtype=np.int32)
    got = P.apply_row_swaps(torch.from_numpy(a), torch.from_numpy(piv), k, r).numpy()
    np.testing.assert_array_equal(got, _apply_swaps_numpy(a, piv, k))
    want_j = JP.apply_row_swaps(jnp.asarray(a), jnp.asarray(piv), k, r)
    np.testing.assert_array_equal(got, np.asarray(want_j))


def test_colliding_pivots():
    n = 6
    a = np.arange(n * n, dtype=np.float32).reshape(n, n)
    piv = np.array([3, 3, 3], dtype=np.int32)
    got = P.apply_row_swaps(torch.from_numpy(a), torch.from_numpy(piv), 0, 3).numpy()
    np.testing.assert_array_equal(got, _apply_swaps_numpy(a, piv, 0))


@pytest.mark.parametrize("k,ncols,window", [(5, 3, 10), (0, 6, 12), (2, 4, 9)])
def test_row_map_matches_jax(k, ncols, window):
    rng = np.random.default_rng(k + ncols)
    piv = np.array([k + j + rng.integers(0, window - j) for j in range(ncols)], np.int32)
    got = P.swaps_to_row_map(torch.from_numpy(piv), k, ncols, window)
    want = JP.swaps_to_row_map(jnp.asarray(piv), k, ncols, window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ident = P.swaps_to_row_map(torch.arange(5, 8, dtype=torch.int32), 5, 3, 10)
    np.testing.assert_array_equal(ident.numpy(), np.arange(5, 15))


def test_vector_swaps_and_ipiv_to_perm():
    rng = np.random.default_rng(0)
    n = 12
    b = rng.random((n, 2)).astype(np.float32)
    ipiv = np.array([rng.integers(i, n) + 1 for i in range(n)], dtype=np.int32)
    got = P.apply_row_swaps_vector(torch.from_numpy(b), torch.from_numpy(ipiv)).numpy()
    want = b.copy()
    for i in range(n):
        p = ipiv[i] - 1
        want[[i, p]] = want[[p, i]]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(P.ipiv_to_perm(torch.from_numpy(ipiv)).numpy(),
                                  np.asarray(JP.ipiv_to_perm(jnp.asarray(ipiv))))
    perm = P.ipiv_to_perm(torch.from_numpy(ipiv))
    np.testing.assert_array_equal(
        P.apply_row_swaps_vector(torch.from_numpy(b), None, perm).numpy(), want)


def _lu11(r, rng):
    return (np.tril(rng.random((r, r)).astype(np.float32) * 0.5, -1)
            + np.triu(rng.random((r, r)).astype(np.float32) + 2 * np.eye(r, dtype=np.float32)))


@pytest.mark.parametrize("use_inv", [True, False])
def test_trsms_match_jax(use_inv, rng):
    r, n = 32, 96
    lu11 = _lu11(r, rng)
    a12 = rng.random((r, n)).astype(np.float32)
    a21 = rng.random((n, r)).astype(np.float32)
    u12 = B.trsm_u12(torch.from_numpy(lu11), torch.from_numpy(a12), PURE_FP32, use_inv).numpy()
    l21 = B.trsm_l21(torch.from_numpy(lu11), torch.from_numpy(a21), PURE_FP32, use_inv).numpy()
    u12_j = np.asarray(JB.trsm_u12(jnp.asarray(lu11), jnp.asarray(a12), J_FP32, use_inv))
    l21_j = np.asarray(JB.trsm_l21(jnp.asarray(lu11), jnp.asarray(a21), J_FP32, use_inv))
    assert np.abs(u12 - u12_j).max() <= 1e-5 * np.abs(u12_j).max()
    assert np.abs(l21 - l21_j).max() <= 1e-5 * np.abs(l21_j).max()
    l = np.tril(lu11, -1) + np.eye(r)
    np.testing.assert_allclose(l @ u12, a12, atol=1e-4)
    np.testing.assert_allclose(l21 @ np.triu(lu11), a21, atol=1e-4)


def test_trailing_update_policies_match_jax(rng):
    n, r = 64, 16
    a22 = rng.random((n, n)).astype(np.float32)
    l21 = rng.random((n, r)).astype(np.float32)
    u12 = rng.random((r, n)).astype(np.float32)
    t = [torch.from_numpy(x) for x in (a22, l21, u12)]
    j = [jnp.asarray(x) for x in (a22, l21, u12)]
    got32 = B.trailing_update(*t, PURE_FP32).numpy()
    want32 = np.asarray(JB.trailing_update(*j, J_FP32))
    assert np.abs(got32 - want32).max() <= 1e-5 * np.abs(want32).max()
    gotbf = B.trailing_update(*t, MPF_BF16).numpy()
    wantbf = np.asarray(JB.trailing_update(*j, J_BF16))
    # the same bf16-rounded operands, exact products, fp32 sums in another order
    assert np.abs(gotbf - wantbf).max() <= 1e-5 * np.abs(wantbf).max()
    exact = a22 - l21.astype(np.float64) @ u12
    assert np.abs(gotbf - exact).max() > np.abs(got32 - exact).max()


@pytest.mark.parametrize("n", [4, 64, 128])
def test_triangular_inverses_match_jax(n, rng):
    l = np.tril(rng.random((n, n)).astype(np.float32) * 0.5, -1) + np.eye(n, dtype=np.float32)
    got = B.unit_lower_inv(torch.from_numpy(l)).numpy()
    want = np.asarray(JB.unit_lower_inv(jnp.asarray(l)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    u = np.triu(rng.random((n, n)).astype(np.float32)) + 2 * np.eye(n, dtype=np.float32)
    np.testing.assert_allclose(B.upper_inv(torch.from_numpy(u)).numpy() @ u, np.eye(n),
                               atol=1e-4)
