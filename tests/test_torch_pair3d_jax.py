"""The pair-layout slice against the JAX package as a whole: JAX's
``mpf_factorize_traced`` on the (n/2, 2, n) input with its Pallas kernels
in interpret mode (set up as tests/test_pair3d.py:28-43, and jitted, see
``jax_pairs``) beside the port's 3D run, n = 256, r = 32, block 128,
MPF_BF16 and ALL_BF16, on ``hpl_ai_matrix(256, seed=5)`` and
``random_dense(256, seed=5)``; and a JAX pair-layout result carried through
``mpf_tpu_torch.convert``.  In a file of its own so that xdist gives the
~50 s of interpret runs a worker to itself."""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import mpf_tpu  # noqa: E402
from mpf_tpu.utils import matgen  # noqa: E402

import mpf_tpu_torch as T  # noqa: E402
from mpf_tpu_torch.convert import result_from_numpy, result_to_numpy  # noqa: E402
from mpf_tpu_torch.ops import _lib  # noqa: E402
from mpf_tpu_torch.utils.oracle import check_factorization  # noqa: E402

N, R, BLOCK = 256, 32, 128

#: the first pivot at which the port's 3D run and JAX's (interpret) part on
#: random_dense(256, seed=5): the first pivot of block column 1 under
#: MPF_BF16, of block column 1's third panel under ALL_BF16
PAIR_AGREE = {"mpf_bf16": 128, "all_bf16": 192}


@pytest.fixture(scope="module")
def jax_pairs():
    """``run(a, policy)``: JAX's 3D driver on ``a`` as numpy arrays, one
    jitted computation per policy (traced once, with the interpret-mode
    setup of tests/test_pair3d.py).  Jitted because an interpret-mode
    kernel dispatches JAX ops from host callbacks, and an eager op of the
    driver dispatched meanwhile can queue ahead of them and deadlock (seen
    under load); inside one computation nothing else is dispatched."""
    import jax.experimental.pallas.tpu as pltpu
    import mpf_tpu.config as cfg
    import mpf_tpu.models.mpf as M

    fns = {}

    def run(a, policy):
        with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
            mp.setattr(M, "_PAD_QUANTUM", 128)
            mp.setattr(M, "_FUSED_RB", 128)
            mp.setattr(cfg, "_USE_PALLAS", "1")
            mp.setenv("MPF_FORCE_KERNELS", "1")
            fn = fns.setdefault(policy.name, jax.jit(functools.partial(
                M.mpf_factorize_traced, r=R, policy=policy, block=BLOCK)))
            return jax.tree.map(np.asarray, fn(jnp.asarray(a).reshape(N // 2, 2, N)))
    return run


@pytest.mark.parametrize("name", ["mpf_bf16", "all_bf16"])
@pytest.mark.parametrize("corpus", ["hpl", "uniform"])
def test_pair3d_vs_jax_pair_driver_interpret(name, corpus, jax_pairs):
    """HPL-AI: ipiv and perm exact.  Uniform: exact up to
    ``PAIR_AGREE``, where the two packages first part (fp32 sums in
    another order, then bf16 rounding, tip the quant16 search between two
    near-equal pivots, as the classic loops part:
    tests/test_torch_defer_jax.py:22-36).  Both factorizations pass the
    oracle at the JAX bounds (1e-3 MPF_BF16, 5e-2 ALL_BF16), both come
    back (n/2, 2, n) in the working dtype, the row maps are permutations,
    and the port launches nothing on the CPU."""
    gen = matgen.hpl_ai_matrix if corpus == "hpl" else matgen.random_dense
    a = gen(N, seed=5).astype(np.float32)
    j = jax_pairs(a, getattr(mpf_tpu, name.upper()))
    policy = T.precision.POLICIES[name]
    _lib.reset_counts()
    t = T.mpf_factorize(torch.from_numpy(a).view(N // 2, 2, N), r=R, block=BLOCK, policy=policy)
    assert not any(_lib.launches.values())
    assert t.lu.shape == j.lu.shape == (N // 2, 2, N) and t.lu.dtype == policy.working
    ti, tp = t.ipiv.numpy(), t.perm.numpy()
    if corpus == "hpl":
        np.testing.assert_array_equal(ti, j.ipiv)
        np.testing.assert_array_equal(tp, j.perm)
    else:
        d = PAIR_AGREE[name]
        np.testing.assert_array_equal(ti[:d], j.ipiv[:d])
        np.testing.assert_array_equal(tp[:d], j.perm[:d])
        assert ti[d] != j.ipiv[d]
    tol = 1e-3 if name == "mpf_bf16" else 5e-2
    for lu, ipiv, perm in ((t.lu.float().numpy(), ti, tp), (j.lu, j.ipiv, j.perm)):
        assert check_factorization(a, np.asarray(lu, np.float32).reshape(N, N), ipiv,
                                   nbe_tol=tol).ok
        np.testing.assert_array_equal(np.sort(perm), np.arange(N))


def test_convert_carries_a_pair_layout_result(jax_pairs):
    """A JAX pair-layout result crosses into the port and back unchanged:
    ``lu`` keeps its (n/2, 2, n) shape and (bf16 widened to fp32) values,
    and the port's 3D driver on the same matrix gives the same pivots
    (HPL-AI, ALL_BF16)."""
    a = matgen.hpl_ai_matrix(N, seed=5).astype(np.float32)
    j = jax_pairs(a, mpf_tpu.ALL_BF16)
    res = result_from_numpy(j.lu, j.ipiv, j.info, j.perm)
    assert res.lu.shape == (N // 2, 2, N) and res.lu.dtype == torch.float32
    back = result_to_numpy(res)
    np.testing.assert_array_equal(back.lu, np.asarray(j.lu, np.float32))
    np.testing.assert_array_equal(back.ipiv, j.ipiv)
    np.testing.assert_array_equal(back.perm, j.perm)
    assert int(back.info) == int(j.info) == 0
    t = result_to_numpy(T.mpf_factorize(torch.from_numpy(a).view(N // 2, 2, N), r=R,
                                        block=BLOCK, policy=T.ALL_BF16))
    assert t.lu.shape == back.lu.shape
    np.testing.assert_array_equal(t.ipiv, back.ipiv)
