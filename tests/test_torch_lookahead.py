"""Port parity for the one-deep lookahead driver
(`mpf_tpu_torch/models/mpf.py:_lookahead_factorize`, kernel 13 in its wide
updates): against the JAX package's ``mpf_factorize_traced(...,
lookahead=True)`` with its Pallas kernels in interpret mode, as
tests/test_lookahead.py runs it, and against the port's own classic loop.
Inputs come from numpy with fixed seeds; each test states its tolerance."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.experimental.pallas.tpu as pltpu  # noqa: E402

import mpf_tpu  # noqa: E402
import mpf_tpu.config as cfg  # noqa: E402
import mpf_tpu.models.mpf as M  # noqa: E402
from mpf_tpu.utils import matgen  # noqa: E402

import mpf_tpu_torch as T  # noqa: E402
import mpf_tpu_torch.models.mpf as TM  # noqa: E402
from mpf_tpu_torch.convert import policy_from_jax, result_to_numpy  # noqa: E402
from mpf_tpu_torch.ops import _lib  # noqa: E402
from mpf_tpu_torch.utils.oracle import check_factorization  # noqa: E402


def _jax_lookahead(monkeypatch, a, policy, r, block):
    """The JAX lookahead driver on its fused kernels in interpret mode (the
    setup of tests/test_lookahead.py)."""
    monkeypatch.setattr(M, "_PAD_QUANTUM", 128)
    monkeypatch.setattr(M, "_FUSED_RB", 128)
    monkeypatch.setattr(cfg, "_USE_PALLAS", "1")
    monkeypatch.setenv("MPF_FORCE_KERNELS", "1")
    with pltpu.force_tpu_interpret_mode():
        return jax.tree.map(np.asarray, M.mpf_factorize_traced(
            jnp.asarray(a, dtype=policy.working), r=r, policy=policy, block=block,
            lookahead=True))


def _port(a, r, policy, block, **kw):
    return result_to_numpy(T.mpf_factorize(torch.from_numpy(a), r=r,
                                           policy=policy_from_jax(policy), block=block, **kw))


def test_lookahead_hpl_matches_jax(monkeypatch):
    """HPL-AI, MPF_BF16, n = 384, r = 32, block 128 (kernel 13 runs once,
    in block column 0's wide update): ipiv and perm exact; LU within 1e-5
    * max|LU| (fp32 sums in another order, tests/test_torch_mpf.py's bar);
    the oracle at 1e-3.  ALL_BF16: tests/test_torch_lookahead_all_bf16.py."""
    n = 384
    a = matgen.hpl_ai_matrix(n, seed=0).astype(np.float32)
    j = _jax_lookahead(monkeypatch, a, mpf_tpu.MPF_BF16, 32, 128)
    _lib.reset_counts()
    t = _port(a, 32, mpf_tpu.MPF_BF16, 128, lookahead=True)
    assert _lib.plain_calls["gemmx"] == 1 and not any(_lib.launches.values())
    np.testing.assert_array_equal(t.ipiv, j.ipiv)
    np.testing.assert_array_equal(t.perm, j.perm)
    lu_j = np.asarray(j.lu, np.float32)
    assert np.abs(t.lu - lu_j).max() <= 1e-5 * np.abs(lu_j).max()
    assert check_factorization(a, t.lu, t.ipiv, nbe_tol=1e-3).ok


def test_lookahead_uniform_matches_jax_to_first_divergence(monkeypatch):
    """Uniform (pivot-heavy), MPF_BF16, n = 256, r = 32, block 128: the
    pivots are exact up to 150, the first divergence documented for the
    classic loop (tests/test_torch_mpf.py: fp32 sums in another order,
    made visible by bf16 rounding); both factorizations pass the oracle at
    1e-3 and both row maps are permutations."""
    n = 256
    a = matgen.random_dense(n, seed=0).astype(np.float32)
    j = _jax_lookahead(monkeypatch, a, mpf_tpu.MPF_BF16, 32, 128)
    t = _port(a, 32, mpf_tpu.MPF_BF16, 128, lookahead=True)
    np.testing.assert_array_equal(t.ipiv[:150], j.ipiv[:150])
    for res in (t, j):
        assert check_factorization(a, res.lu, res.ipiv, nbe_tol=1e-3).ok
        np.testing.assert_array_equal(np.sort(res.perm), np.arange(n))


@pytest.mark.parametrize("gen", [matgen.hpl_ai_matrix, matgen.random_dense])
@pytest.mark.parametrize("policy", [mpf_tpu.MPF_BF16, mpf_tpu.ALL_BF16, mpf_tpu.PURE_FP32,
                                    mpf_tpu.MPF_REF])
def test_lookahead_matches_classic(gen, policy):
    """n = 512, r = 32, block 128 (kernel 13 twice): the lookahead driver
    against the port's classic loop, ipiv, perm and info exact and LU
    within tests/test_lookahead.py's bound (1e-3 * max|LU|, 5e-2 for
    ALL_BF16).  On the CPU the two are bitwise equal, which is also held:
    the narrow update computes the same entries as the full-width one."""
    a = torch.from_numpy(gen(512, seed=4).astype(np.float32))
    p = policy_from_jax(policy)
    c = T.mpf_factorize(a, r=32, policy=p, block=128)
    _lib.reset_counts()
    la = T.mpf_factorize(a, r=32, policy=p, block=128, lookahead=True)
    assert _lib.plain_calls["gemmx"] == 2 and _lib.plain_calls["rows_exchange"] == 2
    assert _lib.plain_calls["trailing_sub"] == 3
    assert torch.equal(la.ipiv, c.ipiv) and torch.equal(la.perm, c.perm)
    assert int(la.info) == int(c.info)
    tol = 5e-2 if policy is mpf_tpu.ALL_BF16 else 1e-3
    scale = float(c.lu.float().abs().max())
    assert float((la.lu.float() - c.lu.float()).abs().max()) <= tol * scale
    assert torch.equal(la.lu, c.lu)


def test_lookahead_gate_needs_two_block_columns():
    """n < 2 block (n = 256, block 256): the gate keeps the classic loop,
    bit-identical factors and pivots, and kernel 13 does not run."""
    a = torch.from_numpy(matgen.random_dense(256, seed=5).astype(np.float32))
    _lib.reset_counts()
    la = T.mpf_factorize(a, r=32, block=256, lookahead=True)
    assert _lib.plain_calls["gemmx"] == 0
    c = T.mpf_factorize(a, r=32, block=256)
    assert torch.equal(la.lu, c.lu) and torch.equal(la.ipiv, c.ipiv)


def test_lookahead_gate_off_the_fused_path():
    """Every block column must be fused: MPF_FP16 (saturating panel, the
    masked path), ``pivot=False`` and a block that is no multiple of r keep
    the classic loop, bit for bit."""
    a = torch.from_numpy(matgen.hpl_ai_matrix(288, seed=6).astype(np.float32))
    for kw in (dict(policy=T.MPF_FP16), dict(pivot=False), dict(block=120)):
        args = {"r": 32, "block": 96, **kw}
        _lib.reset_counts()
        la = T.mpf_factorize(a, lookahead=True, **args)
        assert _lib.plain_calls["gemmx"] == 0, kw
        c = T.mpf_factorize(a, **args)
        assert torch.equal(la.lu, c.lu) and torch.equal(la.ipiv, c.ipiv), kw


def test_lookahead_with_pad_wrapper():
    """n = 330, r = 32, block 128: the identity extension to 352 runs the
    lookahead loop (kernel 13 once) and slices back; pivots equal the
    classic loop's on the same extension, oracle at 1e-3."""
    n = 330
    a = matgen.random_dense(n, seed=7).astype(np.float32)
    _lib.reset_counts()
    la = T.mpf_factorize(torch.from_numpy(a), r=32, block=128, lookahead=True)
    assert _lib.plain_calls["gemmx"] == 1
    assert la.lu.shape == (n, n) and TM._pad_target(n, 32, 128) == 352
    c = T.mpf_factorize(torch.from_numpy(a), r=32, block=128)
    assert torch.equal(la.ipiv, c.ipiv) and torch.equal(la.perm, c.perm)
    assert check_factorization(a, la.lu.numpy(), la.ipiv.numpy(), nbe_tol=1e-3).ok


def test_lookahead_env_knob_and_make_mpf(monkeypatch):
    """MPF_LOOKAHEAD=1 turns the driver on for mpf_factorize (read at each
    call) and for make_mpf (read once, when it builds: a factorizer built
    with the knob set keeps it after the knob is cleared); an explicit
    ``lookahead=False`` wins over the knob; no kernel is launched on CPU
    tensors."""
    a = torch.from_numpy(matgen.hpl_ai_matrix(384, seed=8).astype(np.float32))
    monkeypatch.setenv("MPF_LOOKAHEAD", "1")
    _lib.reset_counts()
    res = T.mpf_factorize(a, r=32, block=128)
    assert _lib.plain_calls["gemmx"] == 1
    T.mpf_factorize(a, r=32, block=128, lookahead=False)
    assert _lib.plain_calls["gemmx"] == 1
    fac = T.make_mpf(384, r=32, block=128, donate=False)
    monkeypatch.delenv("MPF_LOOKAHEAD")
    T.mpf_factorize(a, r=32, block=128)
    assert _lib.plain_calls["gemmx"] == 1
    kept = fac(a)
    assert _lib.plain_calls["gemmx"] == 2 and torch.equal(kept.lu, res.lu)
    T.make_mpf(384, r=32, block=128, donate=False)(a)
    assert _lib.plain_calls["gemmx"] == 2
    assert not any(_lib.launches.values())
