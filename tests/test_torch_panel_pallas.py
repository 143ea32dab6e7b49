"""Port parity for `mpf_tpu_torch/ops/panel_pallas.py`: the plain versions
of kernels 7 (hgetf2), 8 / 8b (npv_inv / npv) and 9 (laswp) — what the
wrappers run on CPU tensors — against the JAX package's jnp functions and
its Pallas kernels in interpret mode (as tests/test_panel_pallas.py,
test_npv_inv_pallas.py and test_laswp_pallas.py run them), on the same
numpy inputs.  The shapes of those files, plus fp16 panels and panel
widths that are not a multiple of 8 (jnp reference only: the Pallas kernel
reads 8-row slabs of its transposed panel).

Tolerances, per output:
* kernel 7: piv, perm, composed perm and the 2r LASWP sources exact;
* kernel 8 / 8b: the LU bit-exact against ``getf2_npv`` (one rounding of
  ``b - m * u`` on both sides) and within 1e-5 relative of the Pallas
  kernel's; L^{-1} and U^{-1} within 1e-5 of their largest entry against
  the Pallas kernel (same Gauss-Jordan and back-substitution, dot sums in
  another order) and 1e-4 against triangular_solve, as
  test_npv_inv_pallas.py holds the Pallas kernel; ``info`` exact;
* kernel 9: bit-exact (it moves values)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from mpf_tpu.ops import panel_pallas as JP  # noqa: E402
from mpf_tpu.ops.blas3 import unit_lower_inv, upper_inv  # noqa: E402
from mpf_tpu.ops.getf2 import getf2_npv, panel_pivots_perm  # noqa: E402
from mpf_tpu_torch.ops import _lib  # noqa: E402
from mpf_tpu_torch.ops import panel_pallas as P  # noqa: E402

_DT = {"bf16": (jnp.bfloat16, torch.bfloat16), "fp16": (jnp.float16, torch.float16),
       "fp32": (jnp.float32, torch.float32)}


def _srcs_jnp(perm, piv, off, r):
    cand = np.concatenate([off + np.arange(r), np.asarray(piv)])
    return np.asarray(perm)[cand]


def _assert_k7(got, piv, perm, comp, srcs):
    for g, w in zip(got, (piv, perm, comp, srcs)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("m,r,off", [(64, 8, 0), (64, 8, 7), (96, 16, 5)])
@pytest.mark.parametrize("dt", ["bf16", "fp16", "fp32"])
def test_hgetf2_matches_pallas_interpret(m, r, off, dt, rng):
    """Kernel 7's plain version against the Pallas kernel (interpret mode)
    and the jnp reference: the working fp32 panel goes in, the cast to the
    panel dtype happens inside, as in the blocked factorization."""
    a = (rng.random((m, r)) * 9.9).astype(np.float32)
    prev = rng.permutation(m).astype(np.int32)
    jdt, tdt = _DT[dt]
    with pltpu.force_tpu_interpret_mode():
        want = JP.hgetf2_panel_swaps(jnp.asarray(a), off, jnp.asarray(prev), panel_dtype=jdt)
    _lib.reset_counts()
    got = P.hgetf2_panel_swaps(torch.from_numpy(a), off, torch.from_numpy(prev),
                               panel_dtype=tdt)
    assert _lib.plain_calls["hgetf2"] == 1 and _lib.launches["hgetf2"] == 0
    _assert_k7(got, *want)
    piv_j, perm_j, comp_j = panel_pivots_perm(jnp.asarray(a, jdt), off,
                                              prev_perm=jnp.asarray(prev))
    _assert_k7(got, piv_j, perm_j, comp_j, _srcs_jnp(perm_j, piv_j, off, r))


def test_hgetf2_ties_and_no_prev_perm():
    """All-equal panel: ties resolve to the lowest current position."""
    pan = np.ones((64, 8), dtype=np.float32)
    with pltpu.force_tpu_interpret_mode():
        piv_p, perm_p = JP.hgetf2_panel(jnp.asarray(pan, jnp.bfloat16), 0)
    piv, perm = P.hgetf2_panel(torch.from_numpy(pan).bfloat16(), 0)
    np.testing.assert_array_equal(piv.numpy(), np.asarray(piv_p))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_p))


@pytest.mark.parametrize("m,r,off", [(50, 3, 0), (100, 12, 9), (130, 20, 77), (33, 1, 32)])
@pytest.mark.parametrize("dt", ["bf16", "fp16", "fp32"])
def test_hgetf2_ragged_widths_match_jnp(m, r, off, dt, rng):
    """Panel widths that are not a multiple of 8 and heights that are not a
    multiple of 128 (the TPU kernel's tiling limits do not apply)."""
    a = (rng.standard_normal((m, r)) * 5).astype(np.float32)
    prev = rng.permutation(m).astype(np.int32)
    jdt, tdt = _DT[dt]
    piv_j, perm_j, comp_j = jax.jit(
        lambda p, q: panel_pivots_perm(p, off, prev_perm=q))(jnp.asarray(a, jdt),
                                                             jnp.asarray(prev))
    got = P.hgetf2_panel_swaps(torch.from_numpy(a).to(tdt), off, torch.from_numpy(prev))
    _assert_k7(got, piv_j, perm_j, comp_j, _srcs_jnp(perm_j, piv_j, off, r))


def _rel(x, y):
    return float(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).max()
                 / np.abs(np.asarray(y, np.float64)).max())


@pytest.mark.parametrize("r", [8, 32])
def test_npv_inv_matches_pallas_interpret(r, rng):
    blk = (rng.random((r, r)) + r * np.eye(r)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        lu_p, linv_p, uinv_p, info_p = JP.getf2_npv_inv_block(jnp.asarray(blk))
    lu, linv, uinv, info = P.getf2_npv_inv_block(torch.from_numpy(blk))
    lu_j, info_j = getf2_npv(jnp.asarray(blk))
    np.testing.assert_array_equal(lu.numpy(), np.asarray(lu_j))
    assert _rel(lu, lu_p) <= 1e-5
    assert _rel(linv, linv_p) <= 1e-5 and _rel(uinv, uinv_p) <= 1e-5
    assert int(info) == int(info_p) == int(info_j) == 0
    np.testing.assert_allclose(linv.numpy(), np.asarray(unit_lower_inv(lu_j)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(uinv.numpy(), np.asarray(upper_inv(lu_j)), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("r", [8, 32])
def test_npv_matches_pallas_interpret(r, rng):
    blk = (rng.random((r, r)) + r * np.eye(r)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        lu_p, info_p = JP.getf2_npv_block(jnp.asarray(blk))
    _lib.reset_counts()
    lu, info = P.getf2_npv_block(torch.from_numpy(blk))
    assert _lib.plain_calls["npv"] == 1 and _lib.plain_calls["npv_inv"] == 0
    np.testing.assert_array_equal(lu.numpy(), np.asarray(getf2_npv(jnp.asarray(blk))[0]))
    assert _rel(lu, lu_p) <= 1e-5
    assert int(info) == int(info_p) == 0


@pytest.mark.parametrize("r", [5, 12, 130])
def test_npv_inv_ragged_and_wide(r, rng):
    """r not a multiple of 8, and r > 128 (the card's global-memory
    instance): LU exact against getf2_npv, inverses against
    triangular_solve."""
    blk = (rng.random((r, r)) + r * np.eye(r)).astype(np.float32)
    lu, linv, uinv, info = P.getf2_npv_inv_block(torch.from_numpy(blk))
    lu_j, _ = getf2_npv(jnp.asarray(blk))
    np.testing.assert_array_equal(lu.numpy(), np.asarray(lu_j))
    assert _rel(linv, unit_lower_inv(lu_j)) <= 1e-5
    assert _rel(uinv, upper_inv(lu_j)) <= 1e-5
    assert int(info) == 0


def test_npv_zero_pivot_info():
    a = np.array([[1.0, 2.0], [3.0, 6.0]], dtype=np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, info_p = JP.getf2_npv_block(jnp.asarray(a))
    assert int(P.getf2_npv_block(torch.from_numpy(a))[1]) == int(info_p) == 2
    assert int(P.getf2_npv_inv_block(torch.from_numpy(a))[3]) == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_laswp_matches_pallas_interpret(dtype, rng):
    n, w = 64, 256
    slab = rng.random((n, w)).astype(np.float32)
    cand = np.array([0, 1, 2, 3, 17, 33, 2, 5], dtype=np.int32)  # dup cand=2
    src = np.array([17, 33, 5, 3, 0, 1, 5, 2], dtype=np.int32)   # dup carries same src
    want = slab.copy()
    want[cand] = slab[src]
    if dtype == torch.float32:
        with pltpu.force_tpu_interpret_mode():
            got_p = np.asarray(JP.laswp_apply(jnp.asarray(slab), jnp.asarray(cand),
                                              jnp.asarray(src)))
        np.testing.assert_array_equal(got_p[cand], want[cand])
    t = torch.from_numpy(slab).to(dtype)
    out = P.laswp_apply(t, torch.from_numpy(cand), torch.from_numpy(src))
    assert out is t
    np.testing.assert_array_equal(t.float().numpy(),
                                  torch.from_numpy(want).to(dtype).float().numpy())


def test_laswp_strided_view(rng):
    """The slab is a column window of the matrix (a strided view): only its
    columns move."""
    a = rng.random((40, 30)).astype(np.float32)
    cand = np.array([3, 4, 5, 20, 9, 5], dtype=np.int32)
    src = np.array([20, 9, 4, 3, 5, 4], dtype=np.int32)
    t = torch.from_numpy(a.copy())
    P.laswp_apply(t[:, 7:19], torch.from_numpy(cand), torch.from_numpy(src))
    want = a.copy()
    want[cand, 7:19] = a[src, 7:19]
    np.testing.assert_array_equal(t.numpy(), want)
