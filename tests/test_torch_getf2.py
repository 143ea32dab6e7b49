"""Port parity for `mpf_tpu_torch/ops/getf2.py` (module 1 of the masked
path): the plain panel LUs against the JAX package's jnp functions on the
CPU, on the same numpy panels, and against scipy/LAPACK (the cases of
tests/test_getf2.py).

Tolerances: pivots, row maps and ``info`` exact; ``getf2_npv`` /
``getf2_pivoted`` factors bit-exact against JAX (both round ``b - m * u``
once, as a fused multiply-add); against LAPACK as tests/test_getf2.py."""

import numpy as np
import pytest
import scipy.linalg
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpf_tpu.ops import getf2 as J  # noqa: E402
from mpf_tpu_torch.ops import getf2 as G  # noqa: E402
from mpf_tpu_torch.precision import MPF_FP16, cast_to_panel  # noqa: E402

_DT = {"bf16": (jnp.bfloat16, torch.bfloat16), "fp16": (jnp.float16, torch.float16),
       "fp32": (jnp.float32, torch.float32)}


def _panel(kind, m, r, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return (rng.random((m, r)) * 9.9).astype(np.float32)
    a = (rng.random((m, r)) - 0.5).astype(np.float32)
    a[np.arange(r), np.arange(r)] += m / 4.0
    return a


@pytest.mark.parametrize("dt", ["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("m,r,off", [(64, 8, 0), (96, 16, 5), (200, 12, 37), (256, 32, 100)])
@pytest.mark.parametrize("kind", ["uniform", "hpl"])
def test_panel_pivots_perm_matches_jax(dt, m, r, off, kind):
    """piv, perm and the composed map exact against jit(panel_pivots_perm)
    — the round points of the rank-1 update decide these pivots."""
    a = _panel(kind, m, r, m + r)
    prev = np.random.default_rng(off).permutation(m).astype(np.int32)
    jdt, tdt = _DT[dt]
    fn = jax.jit(lambda p, q: J.panel_pivots_perm(p, off, prev_perm=q))
    want = [np.asarray(x) for x in fn(jnp.asarray(a, jdt), jnp.asarray(prev))]
    got = G.panel_pivots_perm(torch.from_numpy(a).to(tdt), off,
                              prev_perm=torch.from_numpy(prev))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_saturated_fp16_panel_matches_jax():
    """MPF_FP16's saturating cast, then the fp16 search: values beyond the
    fp16 range clamp, tiny ones flush, pivots equal JAX's."""
    rng = np.random.default_rng(3)
    a = (rng.standard_normal((128, 16)) * 3e4).astype(np.float32)
    a[::7, 3] = 1e-9
    import mpf_tpu
    jp = mpf_tpu.cast_to_panel(jnp.asarray(a), mpf_tpu.MPF_FP16)
    tp = cast_to_panel(torch.from_numpy(a), MPF_FP16)
    np.testing.assert_array_equal(tp.float().numpy(), np.asarray(jp, np.float32))
    want = [np.asarray(x) for x in J.panel_pivots_perm(jp, 2)]
    got = G.panel_pivots_perm(tp, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("m,r", [(16, 4), (64, 16), (40, 8)])
def test_panel_pivots_fp32_matches_scipy(m, r, rng):
    a = rng.random((m, r)).astype(np.float32)
    piv = G.panel_pivots(torch.from_numpy(a))
    _, ref_piv = scipy.linalg.lu_factor(a.astype(np.float64))
    np.testing.assert_array_equal(piv.numpy(), ref_piv)


def test_panel_pivots_ragged_ncols_and_ties(rng):
    a = rng.random((16, 8)).astype(np.float32)
    piv = G.panel_pivots(torch.from_numpy(a), ncols=5)
    np.testing.assert_array_equal(piv[5:].numpy(), np.arange(5, 8))
    np.testing.assert_array_equal(
        piv.numpy(), np.asarray(J.panel_pivots(jnp.asarray(a), ncols=5)))
    ones = np.ones((24, 8), np.float32)
    np.testing.assert_array_equal(
        G.panel_pivots(torch.from_numpy(ones).bfloat16(), row_offset=3).numpy(),
        np.asarray(J.panel_pivots(jnp.asarray(ones, jnp.bfloat16), row_offset=3)))


@pytest.mark.parametrize("n", [4, 16, 32])
def test_getf2_npv_matches_jax(n, rng):
    a = rng.random((n, n)).astype(np.float32) + n * np.eye(n, dtype=np.float32)
    lu, info = G.getf2_npv(torch.from_numpy(a))
    lu_j, info_j = J.getf2_npv(jnp.asarray(a))
    np.testing.assert_array_equal(lu.numpy(), np.asarray(lu_j))
    assert int(info) == int(info_j) == 0
    l = np.tril(lu.numpy().astype(np.float64), -1) + np.eye(n)
    np.testing.assert_allclose(l @ np.triu(lu.numpy()), a, rtol=1e-4, atol=1e-4)


def test_getf2_npv_zero_pivot_info():
    a = torch.tensor([[1.0, 2.0], [3.0, 6.0]])
    assert int(G.getf2_npv(a)[1]) == 2


@pytest.mark.parametrize("n", [4, 16, 33])
def test_getf2_pivoted_matches_jax_and_scipy(n, rng):
    a = rng.random((n, n)).astype(np.float32) * 9.9
    lu, piv, info = G.getf2_pivoted(torch.from_numpy(a))
    lu_j, piv_j, _ = J.getf2_pivoted(jnp.asarray(a))
    np.testing.assert_array_equal(piv.numpy(), np.asarray(piv_j))
    np.testing.assert_array_equal(lu.numpy(), np.asarray(lu_j))
    assert int(info) == 0
    ref_lu, ref_piv = scipy.linalg.lu_factor(a.astype(np.float64))
    np.testing.assert_array_equal(piv.numpy(), ref_piv)
    np.testing.assert_allclose(lu.numpy(), ref_lu, rtol=2e-4, atol=2e-4)
