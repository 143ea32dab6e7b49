"""Port parity for the masked path's blocking (mirrors
tests/test_driver_blocking.py): results independent of the outer block
size, ragged n / block / r combinations, and panel widths the fused path
refuses (r not a multiple of 8, r > 128), against the JAX package's
mpf_factorize on the CPU, on the same numpy matrices.

Held exact: ``ipiv``, ``perm`` and ``info``; factors within 1e-5 of
max|LU| (1e-4 on the uniform matrix, see test_torch_masked.py; 1e-2 under
MPF_BF16, whose trailing operands are rounded to bf16, so a one-ulp fp32
difference can move an operand by one bf16 ulp, 2^-8); the oracle at the
JAX test's own bound.  Under MPF_BF16 on the uniform matrix the pivots are
held up to the documented first divergence."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import mpf_tpu  # noqa: E402
import mpf_tpu_torch as T  # noqa: E402
import mpf_tpu_torch.models.mpf as TM  # noqa: E402
from mpf_tpu.utils import matgen  # noqa: E402
from mpf_tpu_torch.ops import _lib  # noqa: E402
from mpf_tpu_torch.utils.oracle import check_factorization  # noqa: E402
from test_torch_masked import assert_prefix, assert_same, jax_fac, port_fac  # noqa: E402


@pytest.mark.parametrize("block", [16, 32, 64, 128])
def test_block_size_invariance_fp32(block, monkeypatch):
    """fp32 pivots are block-size invariant, and equal JAX's at every block
    size (masked path throughout)."""
    monkeypatch.setattr(TM, "_fused_ok", lambda bc, r: False)
    n, r = 128, 16
    a = matgen.random_dense(n, seed=3)
    ref = port_fac(a, r, mpf_tpu.PURE_FP32, block=n)
    t = port_fac(a, r, mpf_tpu.PURE_FP32, block=block)
    np.testing.assert_array_equal(t.ipiv, ref.ipiv)
    np.testing.assert_allclose(t.lu, ref.lu, rtol=1e-3, atol=5e-3)
    assert_same(t, jax_fac(a, r, mpf_tpu.PURE_FP32, block=block), lu_tol=1e-4)


@pytest.mark.parametrize("n,r,block,agree", [(100, 16, 48, 74), (130, 32, 64, None),
                                             (96, 128, 2048, None)])
def test_ragged_blocking_oracle(n, r, block, agree, monkeypatch):
    """Non-divisible n / block / r under MPF_BF16.  The port's own routing
    pads these to a multiple of r and takes the fused path (oracle only);
    forced onto the masked path it handles the ragged shapes natively and
    is compared with JAX."""
    a = matgen.random_dense(n, seed=n)
    _lib.reset_counts()
    fused = port_fac(a, r, mpf_tpu.MPF_BF16, block=block)
    assert _lib.plain_calls["hgetf2"] == 0 and _lib.plain_calls["strip_pivots"] > 0
    monkeypatch.setattr(TM, "_fused_ok", lambda bc, r: False)
    _lib.reset_counts()
    t = port_fac(a, r, mpf_tpu.MPF_BF16, block=block)
    assert _lib.plain_calls["strip_pivots"] == 0 and _lib.plain_calls["hgetf2"] > 0
    assert check_factorization(a, fused.lu, fused.ipiv, nbe_tol=1e-3).ok
    j = jax_fac(a, r, mpf_tpu.MPF_BF16, block=block)
    if agree is None:
        assert_same(t, j, lu_tol=1e-2)
    else:
        assert_prefix(t, j, agree)
    for res in (t, j):
        assert check_factorization(a, res.lu, res.ipiv, nbe_tol=1e-3).ok


@pytest.mark.parametrize("policy", ["MPF_FP16", "PURE_FP32", "MPF_REF"])
@pytest.mark.parametrize("n,r,block", [(120, 12, 36), (200, 48, 100), (300, 160, 320)])
def test_off_gate_widths(policy, n, r, block):
    """r not a multiple of 8 and r > 128 take the masked path on the HPL-AI
    matrix: exact against JAX."""
    a = matgen.hpl_ai_matrix(n, seed=n + r)
    p = getattr(mpf_tpu, policy)
    t, j = port_fac(a, r, p, block=block), jax_fac(a, r, p, block=block)
    assert_same(t, j)
    tol = 5e-4 if policy == "MPF_FP16" else 1e-5
    assert check_factorization(a, t.lu, t.ipiv, nbe_tol=tol).ok


def test_mixed_routing_block_columns():
    """n = 128, r = 8, block 60 under PURE_FP32: the two 60-wide block
    columns are off the fused gate (60 % 8 != 0) and take the masked path
    (8 panels each: 7 of 8 columns and a 4-wide tail), the last one (8
    wide) takes the fused path; exact against JAX."""
    n = 128
    a = matgen.random_dense(n, seed=11)
    assert TM._pad_target(n, 8, 60, T.PURE_FP32) == 0
    _lib.reset_counts()
    t = port_fac(a, 8, mpf_tpu.PURE_FP32, block=60)
    assert _lib.plain_calls["strip_pivots"] == 1 and _lib.plain_calls["hgetf2"] == 16
    assert_same(t, jax_fac(a, 8, mpf_tpu.PURE_FP32, block=60), lu_tol=1e-4)
    assert check_factorization(a, t.lu, t.ipiv, nbe_tol=1e-5).ok
