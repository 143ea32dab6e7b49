"""Port parity: host utilities (glibc rand, generators, oracle, timing),
the JAX-free import, and the state converters."""

import subprocess
import sys

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from mpf_tpu.utils import glibc_rand as JG, matgen as JM, oracle as JO, timing as JT  # noqa: E402
from mpf_tpu.ops.pivoting import ipiv_to_perm as j_ipiv_to_perm  # noqa: E402
from mpf_tpu_torch.utils import glibc_rand as TG, matgen as TM, oracle as TO, timing as TT  # noqa: E402
from mpf_tpu_torch import convert  # noqa: E402


@pytest.mark.parametrize("seed", [1, 7, 2**31 + 5])
def test_glibc_rand_identical(seed):
    a, b = JG.GlibcRand(seed), TG.GlibcRand(seed)
    assert [a.rand() for _ in range(500)] == [b.rand() for _ in range(500)]


def test_generate_corpus_identical():
    for x, y in zip(JM.generate_corpus(16, sparsity=0.3, seed=3),
                    TM.generate_corpus(16, sparsity=0.3, seed=3)):
        np.testing.assert_array_equal(x, y)
    assert TM.corpus_sizes(100, 10, "lin") == JM.corpus_sizes(100, 10, "lin")
    with pytest.raises(ValueError):
        TM.corpus_sizes(16, 1)


@pytest.mark.parametrize("gen", ["random_dense", "hpl_ai_matrix"])
def test_fast_generators_identical(gen):
    np.testing.assert_array_equal(getattr(JM, gen)(96, seed=5), getattr(TM, gen)(96, seed=5))


def test_random_conditioned_identical():
    np.testing.assert_array_equal(JM.random_conditioned(48, 1e4, seed=2),
                                  TM.random_conditioned(48, 1e4, seed=2))


def _lu_with_swaps(n, seed):
    import scipy.linalg as sla

    a = TM.random_dense(n, seed=seed).astype(np.float64)
    lu, piv = sla.lu_factor(a)
    return a, lu, piv + 1


def test_oracle_identical_and_device_variant():
    """Host oracle == JAX package's; the device (fp64 torch) variant agrees
    with it to fp64 roundoff (here on the CPU tensor's device)."""
    a, lu, ipiv = _lu_with_swaps(64, 1)
    rj = JO.check_factorization(a, lu, ipiv, nbe_tol=1e-12)
    rt = TO.check_factorization(a, lu, ipiv, nbe_tol=1e-12)
    assert (rj.normwise_backward_err, rj.max_abs_err, rj.ok) == (
        rt.normwise_backward_err, rt.max_abs_err, rt.ok)
    rd = TO.check_factorization_device(torch.from_numpy(a), torch.from_numpy(lu),
                                       torch.from_numpy(ipiv), nbe_tol=1e-12, chunk=16)
    assert rd.ok
    assert abs(rd.normwise_backward_err - rt.normwise_backward_err) < 1e-15
    assert rd.max_abs_err == pytest.approx(rt.max_abs_err, rel=1e-6, abs=1e-13)
    # a corrupted factor fails both
    lu[5, 3] += 1.0
    assert not TO.check_factorization_device(
        torch.from_numpy(a), torch.from_numpy(lu), torch.from_numpy(ipiv)).ok


def test_ipiv_to_perm_matches_jax():
    _, _, ipiv = _lu_with_swaps(50, 2)
    np.testing.assert_array_equal(
        TO.ipiv_to_perm(torch.from_numpy(ipiv)).numpy(),
        np.asarray(j_ipiv_to_perm(jnp.asarray(ipiv, jnp.int32))))


def test_timing_helpers():
    assert TT.lu_flops(1000) == JT.lu_flops(1000)
    assert TT.tflops(16384, 0.25) == JT.tflops(16384, 0.25)
    if not torch.cuda.is_available():
        from mpf_tpu_torch.utils.profiling import profile_factorization

        with pytest.raises(RuntimeError):
            TT.cuda_time(lambda: None)
        with pytest.raises(RuntimeError):
            profile_factorization(64)


def test_import_loads_no_jax():
    code = ("import sys, mpf_tpu_torch, mpf_tpu_torch.convert, mpf_tpu_torch.utils.oracle, "
            "mpf_tpu_torch.utils.matgen, mpf_tpu_torch.utils.timing; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'mpf_tpu.'))"
            " or m == 'mpf_tpu']; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def test_convert_roundtrip():
    import mpf_tpu
    import mpf_tpu_torch as T

    assert convert.policy_from_jax(mpf_tpu.MPF_BF16) is T.MPF_BF16
    assert convert.policy_from_jax(mpf_tpu.PURE_FP32) is T.PURE_FP32
    rng = np.random.default_rng(0)
    lu = rng.standard_normal((8, 8)).astype(np.float32)
    ipiv = np.arange(1, 9, dtype=np.int32)
    perm = rng.permutation(8).astype(np.int32)
    res = convert.result_from_numpy(lu, ipiv, np.int32(3), perm)
    assert res.lu.dtype == torch.float32 and int(res.info) == 3
    back = convert.result_to_numpy(res)
    np.testing.assert_array_equal(back.lu, lu)
    np.testing.assert_array_equal(back.ipiv, ipiv)
    np.testing.assert_array_equal(back.perm, perm)
    assert back.info == 3
